"""The port's whole pipeline against the JAX pipeline on the tiny model.

The JAX `random_components(tiny=True, fp32, resolution=64)` model's params are
carried over by visualcloze_tpu_torch.convert; the JAX noise is replayed
outside jit (the key chain of prepare_query / finalize_query /
prepare_upsampling) and handed to the port as its noise inputs. A 1x2 query
row under one context row (a 2x2 grid), 4 steps, with SDEdit and without.

Bounds. Images: 2/255 per pixel. Final latents: at most 2% of the elements
differ, mean |Δ| <= 1e-4 and max |Δ| <= 1/64 (one bf16 ulp at |x| in [2, 4)).
The latents are stored in bf16 between Euler steps (as in JAX), so an
fp32-level difference in the velocity (~2e-4 here, most of it from the
timestep embedding at guidance 30, see test_torch_ops.test_timestep_embedding)
flips a few roundings by one ulp and the next steps carry the flip on:
measured, 7 and 15 of 2048 elements differ (seeds 7 and 11), mean |Δ| 2e-5
and 4e-5, max 1/128 and 1/64. A max |Δ| of 1e-3 on bf16 latents would
demand bit-identical arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from visualcloze_tpu.pipeline import random_components as jax_random_components
from visualcloze_tpu_torch import config as tconfig
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch.models.conditioner import FallbackTokenizer, TextEncoder
from visualcloze_tpu_torch.pipeline.visualcloze import VisualClozeModel

SEED, STEPS, UP_STEPS = 7, 4, 3
PROMPTS = ["A grid with 2 rows", "map each photo", "The content of the last image in the final row is: a cat"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(rope_layout):
    jm = jax_random_components(jax.random.PRNGKey(0), tiny=True, dtype=jnp.float32, resolution=64,
                               rope_layout=rope_layout)
    t5 = TextEncoder("t5", convert.t5_from_jax(_np(jm.t5.params), jm.t5.cfg, device="cpu"),
                     FallbackTokenizer(jm.t5.cfg.vocab_size), jm.t5.max_length)
    clip = TextEncoder("clip", convert.clip_from_jax(_np(jm.clip.params), jm.clip.cfg, device="cpu"),
                       FallbackTokenizer(jm.clip.cfg.vocab_size), jm.clip.max_length)
    pm = VisualClozeModel(
        convert.config_from(jm.cfg, tconfig.FluxConfig),
        convert.flux_from_jax(_np(jm.params), jm.cfg, device="cpu"),
        convert.vae_from_jax(_np(jm.ae.params), jm.ae.cfg, device="cpu"),
        t5, clip, resolution=64, device="cpu", rope_layout=rope_layout,
        permute_params=False,  # the JAX constructor has already permuted jm.params
    )
    for m in (jm, pm):
        m.set_grid_size(2, 2)
    return jm, pm


@pytest.fixture(scope="module")
def models():
    return _models("half")


def _grid():
    rng = np.random.default_rng(0)

    def img():
        return Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))

    return [[img(), img()], [img(), None]]


def _jax_noise(row_shape, up_shape):
    """The JAX pipeline's draws, in the port's order of use."""
    key = jax.random.PRNGKey(SEED)
    vae, latent = [], []
    for _ in range(2):  # per grid row: split(key, 3) -> posterior eps, row noise
        key, ek, nk = jax.random.split(key, 3)
        vae.append(np.asarray(jax.random.normal(ek, row_shape, jnp.float32)))
        latent.append(np.asarray(jax.random.normal(nk, row_shape, jnp.float32)))
    key, uk = jax.random.split(key)  # the one masked cell
    _, ek, bk, nk = jax.random.split(uk, 4)
    vae += [np.asarray(jax.random.normal(k, up_shape, jnp.float32)) for k in (ek, bk)]
    latent.append(np.asarray(jax.random.normal(nk, up_shape, jnp.float32)))
    return {"vae": vae, "latent": latent}


def _check_denoise(jm, pm):
    """The query's packed inputs exactly, then the denoised latents (bounds above)."""
    grid = _grid()
    noise = _jax_noise((1, 8, 16, 4), (1, 8, 8, 4))
    qj = jm.prepare_query(grid, PROMPTS, seed=SEED, steps=STEPS)
    qp = pm.prepare_query(grid, PROMPTS, seed=SEED, steps=STEPS, noise=noise)
    np.testing.assert_array_equal(qp["x"].float().numpy(), np.asarray(qj["x"], np.float32))
    sj = np.asarray(jm.denoise_query(qj), np.float32)
    got = pm.denoise_query(qp).float().numpy()
    assert np.isfinite(got).all() and got.shape == sj.shape
    diff = np.abs(got - sj)
    assert (diff > 0).mean() <= 0.02, (diff > 0).sum()
    assert diff.mean() <= 1e-4, diff.mean()
    assert diff.max() <= 1 / 64, diff.max()


def test_pipeline_interleaved_layout_matches_jax():
    """VisualClozeModel(rope_layout="interleaved"): the reference channel
    order, q and k rotated in PyTorch, kernel D (its plain version here)."""
    jm, pm = _models("interleaved")
    assert pm.rope_layout == "interleaved"
    _check_denoise(jm, pm)


@pytest.mark.parametrize("upsampling", [False, True])
def test_pipeline_matches_jax(models, upsampling):
    jm, pm = models
    grid = _grid()
    noise = _jax_noise((1, 8, 16, 4), (1, 8, 8, 4))
    qj = jm.prepare_query(grid, PROMPTS, seed=SEED, steps=STEPS)
    qp = pm.prepare_query(grid, PROMPTS, seed=SEED, steps=STEPS, noise=noise)
    np.testing.assert_array_equal(qp["x"].float().numpy(), np.asarray(qj["x"], np.float32))
    np.testing.assert_array_equal(qp["img_cond"].float().numpy(), np.asarray(qj["img_cond"], np.float32))

    sj = np.asarray(jm.denoise_query(qj), np.float32)
    sp = pm.denoise_query(qp)
    got = sp.float().numpy()
    assert np.isfinite(got).all() and got.shape == sj.shape
    diff = np.abs(got - sj)
    assert (diff > 0).mean() <= 0.02, (diff > 0).sum()
    assert diff.mean() <= 1e-4, diff.mean()
    assert diff.max() <= 1 / 64, diff.max()

    kw = dict(upsampling_steps=UP_STEPS, upsampling_noise=0.4, is_upsampling=upsampling)
    out_j = jm.finalize_query(qj, jnp.asarray(sj, jnp.bfloat16), **kw)
    out_p = pm.finalize_query(qp, sp, **kw)
    assert len(out_j) == len(out_p) == 1
    assert out_j[0].size == out_p[0].size == (64, 64)
    pix = np.abs(np.asarray(out_j[0], np.int32) - np.asarray(out_p[0], np.int32))
    assert pix.max() <= 2, pix.max()
