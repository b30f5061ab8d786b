"""The port's ops (rope, schedule, packing, attention) against the JAX package's."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcloze_tpu.ops import packing as jpack
from visualcloze_tpu.ops import rope as jrope
from visualcloze_tpu.ops import schedule as jsched
from visualcloze_tpu_torch.ops import attention as tatt
from visualcloze_tpu_torch.ops import packing as tpack
from visualcloze_tpu_torch.ops import rope as trope
from visualcloze_tpu_torch.ops import schedule as tsched

# the JAX ops package re-exports a function named `attention` over its module
jatt = importlib.import_module("visualcloze_tpu.ops.attention")
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _ids(rng, b=2, L=40):
    return rng.integers(0, 64, (b, L, 3)).astype(np.float32)


def test_rope_table_and_embed_nd():
    rng = np.random.default_rng(0)
    ids = _ids(rng)
    for d in (16, 56):
        cj, sj = jrope.rope_table(jnp.asarray(ids[..., 1]), d, 10_000)
        ct, st = trope.rope_table(_t(ids[..., 1]), d, 10_000)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL)
    cj, sj = jrope.embed_nd(jnp.asarray(ids), (16, 56, 56), 10_000)
    ct, st = trope.embed_nd(_t(ids), (16, 56, 56), 10_000)
    assert ct.shape == (2, 40, 64) and ct.dtype == torch.float32
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL)


@pytest.mark.parametrize("layout", ["half", "interleaved"])
def test_apply_rope(layout):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 40, 32)).astype(np.float32)
    cos, sin = jrope.embed_nd(jnp.asarray(_ids(rng)), (8, 12, 12), 10_000)
    jfn, tfn = {
        "half": (jrope.apply_rope_half, trope.apply_rope_half),
        "interleaved": (jrope.apply_rope, trope.apply_rope),
    }[layout]
    want = jfn(jnp.asarray(x), cos[:, None], sin[:, None])
    got = tfn(_t(x), _t(cos)[:, None], _t(sin)[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_schedules_are_identical():
    for steps, seq in ((30, 3456), (10, 4096), (4, 32)):
        np.testing.assert_array_equal(
            tsched.get_schedule(steps, seq), jsched.get_schedule(steps, seq)
        )
        np.testing.assert_array_equal(
            tsched.ode_timesteps(steps, seq, do_shift=True, time_shifting_factor=1.0),
            jsched.ode_timesteps(steps, seq, do_shift=True, time_shifting_factor=1.0),
        )
        np.testing.assert_array_equal(
            tsched.ode_timesteps(steps, seq, do_shift=False, strength=0.4, time_shifting_factor=1.0),
            jsched.ode_timesteps(steps, seq, do_shift=False, strength=0.4, time_shifting_factor=1.0),
        )
    assert tsched.time_shift(1.0, 1.0, 0.3) == jsched.time_shift(1.0, 1.0, 0.3)


@pytest.mark.parametrize("t, tol", [((0.0, 0.25, 0.5, 0.75, 1.0), 5e-5), ((30.0,), 2e-3)])
def test_timestep_embedding(t, tol):
    """Bound from fp32 transcendental differences: XLA:CPU's exp and
    PyTorch's differ by 1 ulp on ~14 of the 128 frequencies, and the
    embedding multiplies them by 1000 t (30000 at the pipeline's guidance
    30) before the cos/sin, so the last bits of the frequency move the
    angle by up to ~2.6e-5 at t <= 1 and ~9e-4 at t = 30."""
    want = np.asarray(jsched.timestep_embedding(jnp.asarray(t, jnp.float32), 256))
    got = tsched.timestep_embedding(torch.tensor(t, dtype=torch.float32), 256)
    assert got.shape == (len(t), 256)
    np.testing.assert_allclose(got.numpy(), want, atol=tol)


def test_packing_roundtrip_and_parity():
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    tok = tpack.patchify(_t(lat))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jpack.patchify(jnp.asarray(lat))))
    np.testing.assert_array_equal(tpack.unpatchify(tok, 8, 12).numpy(), lat)
    mask = (rng.random((1, 32, 48)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        tpack.pack_mask(_t(mask)).numpy(), np.asarray(jpack.pack_mask(jnp.asarray(mask)))
    )
    np.testing.assert_array_equal(tpack.make_img_ids(4, 6, 2), jpack.make_img_ids(4, 6, 2))
    for n, bucket in ((3456, 128), (5184, 128), (1, 256), (300, 256)):
        assert tpack.bucket_length(n, bucket) == jpack.bucket_length(n, bucket)


def test_mask_to_bias():
    mask = np.array([[1, 1, 0], [0, 1, 1]], np.int32)
    np.testing.assert_array_equal(
        tatt.mask_to_bias(_t(mask)).numpy(), np.asarray(jatt.mask_to_bias(jnp.asarray(mask)))
    )
    assert tatt.mask_to_bias(None) is None


@pytest.mark.parametrize("case", ["nobias", "padded", "fully_masked"])
def test_mha_xla_oracle(case):
    """The fp32 oracle vs JAX mha_xla, with a padding bias and with a batch
    whose keys are all masked (2e-5, as tests/test_ops.py bounds its oracle)."""
    rng = np.random.default_rng(4)
    b, h, L, d = 2, 2, 64, 32
    q, k, v = (rng.standard_normal((b, h, L, d)).astype(np.float32) for _ in range(3))
    bias = None
    if case != "nobias":
        mask = np.ones((b, L), np.int32)
        mask[0, 50:] = 0
        if case == "fully_masked":
            mask[1] = 0
        bias = np.asarray(jatt.mask_to_bias(jnp.asarray(mask)))
    want = jatt.mha_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        None if bias is None else jnp.asarray(bias))
    got = tatt.mha_xla(_t(q), _t(k), _t(v), None if bias is None else _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_attention_matches_jax_and_zeroes_padded_rows():
    """attention() (kernel A's path) vs JAX attention(impl="xla", half layout)."""
    rng = np.random.default_rng(5)
    b, h, L, d = 2, 4, 48, 16
    q, k, v = (rng.standard_normal((b, h, L, d)).astype(np.float32) for _ in range(3))
    ids = _ids(rng, b, L)
    mask = np.ones((b, L), np.int32)
    mask[0, 40:] = 0
    pe_j = jrope.embed_nd(jnp.asarray(ids), (4, 6, 6), 10_000)
    want = jatt.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pe_j,
                          mask=jnp.asarray(mask), impl="xla", rope_layout="half")
    pe_t = trope.embed_nd(_t(ids), (4, 6, 6), 10_000)
    got = tatt.attention(_t(q), _t(k), _t(v), pe_t, mask=_t(mask))
    assert got.shape == (b, L, h * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    assert (got[0, 40:] == 0).all()
