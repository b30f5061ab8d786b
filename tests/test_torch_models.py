"""The port's models (DiT, VAE, T5, CLIP, token packing) against the JAX
package's, on weights carried over by visualcloze_tpu_torch.convert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcloze_tpu.config import AutoEncoderConfig, CLIPTextConfig, FluxConfig, T5Config
from visualcloze_tpu.models.autoencoder import AutoEncoder as JaxAutoEncoder
from visualcloze_tpu.models.autoencoder import init_autoencoder
from visualcloze_tpu.models.clip import clip_encode as jax_clip_encode
from visualcloze_tpu.models.clip import init_clip
from visualcloze_tpu.models.conditioner import FallbackTokenizer as JaxFallbackTokenizer
from visualcloze_tpu.models.conditioner import TextEncoder as JaxTextEncoder
from visualcloze_tpu.models.flux import flux_apply as jax_flux_apply
from visualcloze_tpu.models.flux import init_flux
from visualcloze_tpu.models.sampling import prepare_modified as jax_prepare_modified
from visualcloze_tpu.models.t5 import init_t5
from visualcloze_tpu.models.t5 import t5_encode as jax_t5_encode
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch.models.conditioner import FallbackTokenizer, TextEncoder
from visualcloze_tpu_torch.models.sampling import prepare_modified


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flux_inputs(cfg, b, l_img, l_txt, seed, padded):
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(l_img))
    ids = np.zeros((b, l_img, 3), np.float32)
    ids[..., 0] = 1
    ids[..., 1] = (np.arange(l_img) // side)[None]
    ids[..., 2] = (np.arange(l_img) % side)[None]
    inp = dict(
        img=rng.standard_normal((b, l_img, cfg.in_channels)).astype(np.float32),
        img_ids=ids,
        txt=rng.standard_normal((b, l_txt, cfg.context_in_dim)).astype(np.float32),
        txt_ids=np.zeros((b, l_txt, 3), np.float32),
        timesteps=np.full((b,), 0.5, np.float32),
        y=rng.standard_normal((b, cfg.vec_in_dim)).astype(np.float32),
        # FLUX.1-dev's default guidance; at the pipeline's 30 the timestep
        # embedding alone differs by ~1e-3 (see test_torch_ops.test_timestep_embedding)
        guidance=np.full((b,), 3.5, np.float32),
    )
    if padded:
        img_mask = np.ones((b, l_img), np.int32)
        img_mask[:, l_img - l_img // 4:] = 0
        txt_mask = np.ones((b, l_txt), np.int32)
        txt_mask[-1, l_txt // 2:] = 0
        inp.update(img_mask=img_mask, txt_mask=txt_mask)
    return inp


def _check_flux(cfg, params, inp):
    want = np.asarray(jax_flux_apply(
        cfg, params, **{k: jnp.asarray(v) for k, v in inp.items()}, rope_layout="half", attn_impl="xla"
    ))
    model = convert.flux_from_jax(_np(params), cfg, device="cpu")
    got = model(**{k: _t(v) for k, v in inp.items()}).numpy()
    rms = float(np.sqrt(np.mean(want ** 2)))
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * rms, (err, rms)
    return got


@pytest.mark.parametrize("padded", [False, True])
def test_flux_tiny_matches_jax(padded):
    """flux_apply at FluxConfig().tiny(), with and without padding masks;
    max|Δ| <= 1e-4 of the output RMS."""
    cfg = FluxConfig().tiny()
    params = init_flux(jax.random.PRNGKey(1), cfg)
    got = _check_flux(cfg, params, _flux_inputs(cfg, 2, 64, 16, 0, padded))
    assert got.shape == (2, 64, cfg.out_channels)


def test_flux_flagship_width_matches_jax():
    """Hidden 3072, 24x128 heads, depth cut to 1 + 1, L_img 256 + L_txt 64."""
    cfg = dataclasses.replace(FluxConfig(), depth=1, depth_single_blocks=1)
    params = init_flux(jax.random.PRNGKey(7), cfg)
    _check_flux(cfg, params, _flux_inputs(cfg, 1, 256, 64, 7, padded=False))


def test_convert_rejects_a_missing_parameter():
    cfg = FluxConfig().tiny()
    params = _np(init_flux(jax.random.PRNGKey(1), cfg))
    del params["final_layer"]["adaLN"]
    with pytest.raises(ValueError, match="not in the JAX tree"):
        convert.flux_from_jax(params, cfg, device="cpu")


def test_vae_tiny_matches_jax():
    """encode_moments and decode at AutoEncoderConfig().tiny() (1e-4)."""
    cfg = AutoEncoderConfig().tiny()
    jae = JaxAutoEncoder(cfg, init_autoencoder(jax.random.PRNGKey(2), cfg))
    tae = convert.vae_from_jax(_np(jae.params), cfg, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (1, 64, 96, 3)).astype(np.float32)
    want = np.asarray(jae.encode_moments(jnp.asarray(x)))
    got = tae.encode_moments(_t(x)).numpy()
    assert got.shape == (1, 8, 12, 2 * cfg.z_channels)
    np.testing.assert_allclose(got, want, atol=1e-4)
    z = rng.standard_normal((1, 8, 12, cfg.z_channels)).astype(np.float32)
    want = np.asarray(jae.decode(jnp.asarray(z)))
    got = tae.decode(_t(z)).numpy()
    assert got.shape == (1, 64, 96, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


PROMPTS = ["A grid layout with 2 rows and 2 columns", "every row maps a photo to its edges"]


def _text_encoders():
    t5_cfg, clip_cfg = T5Config().tiny(), CLIPTextConfig().tiny()
    t5_params = init_t5(jax.random.PRNGKey(3), t5_cfg)
    clip_params = init_clip(jax.random.PRNGKey(4), clip_cfg)
    jt5 = JaxTextEncoder("t5", t5_cfg, t5_params, JaxFallbackTokenizer(t5_cfg.vocab_size))
    jclip = JaxTextEncoder("clip", clip_cfg, clip_params, JaxFallbackTokenizer(clip_cfg.vocab_size))
    tt5 = TextEncoder("t5", convert.t5_from_jax(_np(t5_params), t5_cfg, device="cpu"),
                      FallbackTokenizer(t5_cfg.vocab_size))
    tclip = TextEncoder("clip", convert.clip_from_jax(_np(clip_params), clip_cfg, device="cpu"),
                        FallbackTokenizer(clip_cfg.vocab_size))
    return (jt5, jclip), (tt5, tclip)


def test_text_encoders_match_jax():
    """t5_encode / clip_encode at tiny configs on the same FallbackTokenizer ids (1e-5)."""
    (jt5, jclip), (tt5, tclip) = _text_encoders()
    ids = jt5.tokenizer(PROMPTS, jt5.max_length)
    np.testing.assert_array_equal(ids, tt5.tokenizer(PROMPTS, tt5.max_length))
    want = np.asarray(jax_t5_encode(jt5.cfg, jt5.params, jnp.asarray(ids)))
    got = tt5.model(_t(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    ids = jclip.tokenizer(PROMPTS, jclip.max_length)
    want_h, want_p = jax_clip_encode(jclip.cfg, jclip.params, jnp.asarray(ids))
    got_h, got_p = tclip.model(_t(ids).long())
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)


def test_prepare_modified_matches_jax():
    """Eval-path packing: exact ids and masks, tokens <= 1e-6, text <= 1e-5."""
    (jt5, jclip), (tt5, tclip) = _text_encoders()
    rng = np.random.default_rng(6)
    rows = [rng.standard_normal((1, 8, 12, 4)).astype(np.float32) for _ in range(2)]
    want = jax_prepare_modified(
        jt5, jclip, [[jnp.asarray(r) for r in rows]], [" ".join(PROMPTS)],
        proportion_empty_prompts=0.0, bucket=128,
    )
    got = prepare_modified(tt5, tclip, [[_t(r) for r in rows]], [" ".join(PROMPTS)], bucket=128)
    for key in ("img_ids", "txt_ids", "img_mask", "txt_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["img"].numpy(), np.asarray(want["img"]), atol=1e-6)
    np.testing.assert_allclose(got["txt"].numpy(), np.asarray(want["txt"]), atol=1e-5)
    np.testing.assert_allclose(got["vec"].numpy(), np.asarray(want["vec"]), atol=1e-5)
    assert got["img"].shape == (1, 128, 16) and int(got["img_mask"].sum()) == 48
