"""Kernels D, E and F of the port and its two attention gradients against the
JAX package's Pallas kernels (run in interpret mode) and jax.vjp.

On the CPU each wrapper runs its kernel's plain PyTorch version; here that
version is held against the Pallas kernel in fp32 at 2e-5 (the JAX suite's
own bound for its kernels). Measured on this input: about 1e-6. The CUDA
kernels are held against these plain versions on the card in
tests/test_torch_gpu.py.
"""

import unittest.mock as um

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcloze_tpu.ops import flash_attention as jfa
from visualcloze_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from visualcloze_tpu.ops.rope import embed_nd as jax_embed_nd
from visualcloze_tpu_torch.ops import flash_attention as tfa
from visualcloze_tpu_torch.ops.attention import mha_xla
from visualcloze_tpu_torch.ops.rope import apply_rope_half

TOL = 2e-5


def _interpret(module):
    """Run every pallas_call of `module` in interpret mode (as tests/test_ops.py does)."""
    orig = module.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    return um.patch.object(module.pl, "pallas_call", interp_call)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _case(L, pad_from, seed, b=1, h=2, d=32):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, L, d)).astype(np.float32) for _ in range(4))
    bias = None
    if pad_from is not None:
        mask = np.ones((b, L), np.int32)
        mask[:, pad_from:] = 0
        bias = np.asarray(jax_mask_to_bias(jnp.asarray(mask)))
    return q, k, v, do, bias


CASES = [(256, None), (256, 200), (200, 150)]


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("L, pad_from", CASES)
def test_flash_attn_fwd_plain_matches_pallas(L, pad_from, pipelined):
    """Kernel D's plain version vs flash_mha's primal, on the pipelined
    (_flash_fwd_pipelined) and the blocked (_flash_fwd) Pallas forward."""
    q, k, v, _, bias = _case(L, pad_from, L + (pad_from or 0))
    with _interpret(jfa), um.patch.object(jfa, "_PIPELINE_ENABLED", pipelined):
        want = jfa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None if bias is None else jnp.asarray(bias))
    got = tfa.flash_attn_fwd(_t(q), _t(k), _t(v), None if bias is None else _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("L, pad_from", CASES)
def test_flash_attn_fwd_lse_plain_matches_pallas(L, pad_from):
    """Kernel E's plain version vs _flash_fwd_lse: the output and the row LSE
    (log2 units; JAX keeps it lane-broadcast over 128, the port compact)."""
    q, k, v, _, bias = _case(L, pad_from, 7 + L)
    with _interpret(jfa):
        o, lse, _ = jfa._flash_fwd_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       None if bias is None else jnp.asarray(bias))
    got_o, got_lse = tfa.flash_attn_fwd_lse(_t(q), _t(k), _t(v), None if bias is None else _t(bias))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o)[:, :, :L], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[:, :, :L, 0], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("L, pad_from", CASES)
def test_flash_attn_bwd_plain_matches_pallas(L, pad_from):
    """Kernel F's plain versions (dq; dk, dv) vs _pallas_bwd_padded, both fed
    the same padded operands (keys padded with a -1e30 bias, query rows with
    dO = 0) and the same lse and delta."""
    q, k, v, do, bias = _case(L, pad_from, 11 + L)
    if bias is None and L % 128:
        bias = np.zeros((1, L), np.float32)
    with _interpret(jfa):
        o, lse, (qp, kp, vp, biasp, lq_pad, lk_pad) = jfa._flash_fwd_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None if bias is None else jnp.asarray(bias))
        dop = jnp.pad(jnp.asarray(do), ((0, 0), (0, 0), (0, lq_pad), (0, 0)))
        delta = jnp.sum(dop * o, axis=-1, keepdims=True)
        delta = jnp.broadcast_to(delta, (*delta.shape[:3], 128))
        dq, dk, dv = jfa._pallas_bwd_padded(qp, kp, vp, biasp, dop, lse, delta)
    bias_p = None if bias is None else np.pad(bias, ((0, 0), (0, lk_pad)), constant_values=-1e30)
    args = (_t(qp), _t(kp), _t(vp), None if bias_p is None else _t(bias_p), _t(dop),
            _t(np.asarray(lse)[..., 0]), _t(np.asarray(delta)[..., 0]))
    got_dq = tfa.flash_attn_bwd_dq(*args)
    got_dk, got_dv = tfa.flash_attn_bwd_dkv(*args)
    for got, want in ((got_dq, dq), (got_dk, dk), (got_dv, dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _leaves(*arrays):
    return [_t(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("L, pad_from", [(256, 200), (200, None)])
def test_flash_mha_grads_match_jax_vjp(L, pad_from):
    """FlashMHA (E forward, F backward) vs jax.vjp of flash_mha with the
    Pallas kernels interpreted, for a random cotangent; and both against
    torch.autograd through the port's fp32 oracle mha_xla."""
    q, k, v, do, bias = _case(L, pad_from, 21 + L)
    jb = None if bias is None else jnp.asarray(bias)
    with _interpret(jfa):
        out, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_mha(q_, k_, v_, jb),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    tb = None if bias is None else _t(bias)
    leaves = _leaves(q, k, v)
    got = torch.autograd.grad(tfa.flash_mha(*leaves, tb), leaves, _t(do))
    ref_leaves = _leaves(q, k, v)
    ref = torch.autograd.grad(mha_xla(*ref_leaves, tb), ref_leaves, _t(do))
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=TOL, atol=TOL)


def test_flash_mha_rope_grads_match_jax_vjp():
    """Kernel A's gradient (q, k rotated in PyTorch, E, F, inverse rotation)
    vs jax.vjp of flash_mha_rope, and vs torch.autograd through the rotation
    and mha_xla."""
    L, d = 256, 32
    q, k, v, do, bias = _case(L, 200, 5, d=d)
    ids = np.stack([np.ones(L), np.arange(L) // 16, np.arange(L) % 16], axis=-1)[None].astype(np.float32)
    cos, sin = jax_embed_nd(jnp.asarray(ids), (8, 12, 12), 10_000)
    with _interpret(jfa):
        _, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_mha_rope(q_, k_, v_, jnp.asarray(bias), cos, sin),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    tc, ts = _t(cos), _t(sin)
    leaves = _leaves(q, k, v)
    got = torch.autograd.grad(tfa.flash_mha_rope(*leaves, _t(bias), tc, ts), leaves, _t(do))
    ql, kl, vl = _leaves(q, k, v)
    c, s = tc[:, None], ts[:, None]
    ref_out = mha_xla(apply_rope_half(ql, c, s), apply_rope_half(kl, c, s), vl, _t(bias))
    ref = torch.autograd.grad(ref_out, (ql, kl, vl), _t(do))
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=TOL, atol=TOL)


def test_flash_mha_without_grad_runs_kernel_d_path():
    """No gradient wanted: flash_mha is kernel D (its plain version here),
    flash_mha_rope kernel A; the same numbers as the autograd forwards."""
    q, k, v, _, bias = _case(64, 40, 3)
    tq, tk, tv, tb = _t(q), _t(k), _t(v), _t(bias)
    with torch.no_grad():
        np.testing.assert_array_equal(tfa.flash_mha(tq, tk, tv, tb).numpy(),
                                      tfa.flash_attn_fwd(tq, tk, tv, tb).numpy())
    leaves = _leaves(q, k, v)
    np.testing.assert_allclose(tfa.flash_mha(*leaves, tb).detach().numpy(),
                               tfa.flash_attn_fwd(tq, tk, tv, tb).numpy(), rtol=TOL, atol=TOL)
