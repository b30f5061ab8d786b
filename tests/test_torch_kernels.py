"""The port's kernel functions against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; here that
version is held against the Pallas kernel run in interpret mode, in fp32,
at 2e-5 (the JAX suite's own bound for its kernels vs the XLA oracle).
tests/test_torch_gpu.py holds the CUDA kernels against these plain versions
on the card.
"""

import unittest.mock as um

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcloze_tpu.models.autoencoder import group_norm_affine as jax_gn_affine
from visualcloze_tpu.ops import conv2d as jconv
from visualcloze_tpu.ops import flash_attention as jfa
from visualcloze_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from visualcloze_tpu.ops.rope import embed_nd as jax_embed_nd
from visualcloze_tpu_torch.ops import conv2d as tconv
from visualcloze_tpu_torch.ops import flash_attention as tfa
from visualcloze_tpu_torch.ops.attention import mask_to_bias

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


@pytest.mark.parametrize("L, pad_from", [(256, None), (256, 200), (200, 150)])
def test_flash_attn_rope_plain_matches_pallas(L, pad_from):
    """Kernel A's plain version vs flash_mha_rope (pipelined Pallas kernel),
    with and without a padding bias, at a length the kernel must pad."""
    rng = np.random.default_rng(L + (pad_from or 0))
    b, h, d = 1, 2, 32
    q, k, v = (rng.standard_normal((b, h, L, d)).astype(np.float32) for _ in range(3))
    ids = np.stack(
        [np.ones(L), np.arange(L) // 16, np.arange(L) % 16], axis=-1
    )[None].astype(np.float32)
    cos, sin = jax_embed_nd(jnp.asarray(ids), (8, 12, 12), 10_000)
    bias = None
    if pad_from is not None:
        mask = np.ones((b, L), np.int32)
        mask[:, pad_from:] = 0
        bias = jax_mask_to_bias(jnp.asarray(mask))
    with _interpret(jfa):
        want = jfa.flash_mha_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias, cos, sin)
    got = tfa.flash_attn_rope(
        _t(q), _t(k), _t(v), None if bias is None else _t(bias), _t(cos), _t(sin)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_flash_attn_rope_plain_fully_masked_row_is_zero():
    rng = np.random.default_rng(3)
    b, h, L, d = 2, 2, 64, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, L, d)).astype(np.float32)) for _ in range(3))
    cos = torch.ones((b, L, d // 2))
    sin = torch.zeros((b, L, d // 2))
    mask = torch.ones((b, L), dtype=torch.int32)
    mask[1] = 0
    got = tfa.flash_attn_rope(q, k, v, mask_to_bias(mask), cos, sin)
    assert torch.isfinite(got).all()
    assert (got[1] == 0).all()


def test_flash_attn_d512_plain_matches_pallas():
    """Kernel C's plain version vs _flash_fwd as the VAE calls it (D=512, no bias)."""
    rng = np.random.default_rng(5)
    b, L, d = 1, 256, 512
    q, k, v = (rng.standard_normal((b, 1, L, d)).astype(np.float32) * 0.2 for _ in range(3))
    with _interpret(jfa):
        want = jfa._flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, block_q=128, block_k=128
        )
    got = tfa.flash_attn_d512(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _conv_case(seed, B, H, W, C, Co):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Co)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((Co,)) * 0.1).astype(np.float32)
    gn = {
        "scale": jnp.asarray(rng.standard_normal((C,)) * 0.3 + 1, jnp.float32),
        "bias": jnp.asarray(rng.standard_normal((C,)) * 0.2, jnp.float32),
    }
    resid = rng.standard_normal((B, H, W, Co)).astype(np.float32)
    return x, w, b, gn, resid


@pytest.mark.parametrize("mode", ["gn_swish", "gn_swish_residual", "act_none"])
def test_conv3x3_plain_matches_pallas(mode):
    """Kernel B's plain version vs conv3x3_fused(interpret=True): the GN
    affine + swish with the border zeroed after the activation, the residual
    path, and the plain conv of the upsample (act='none')."""
    x, w, b, gn, resid = _conv_case(1, 2, 16, 20, 128, 128)
    pre = None
    if mode != "act_none":
        pre = jax_gn_affine(gn, jnp.asarray(x))
    want = jconv.conv3x3_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pre_affine=pre,
        act="none" if mode == "act_none" else "swish",
        residual=jnp.asarray(resid) if mode == "gn_swish_residual" else None,
        interpret=True,
    )
    got = tconv.conv3x3_gn_swish(
        _t(x), _t(w), _t(b), pre_affine=None if pre is None else (_t(pre[0]), _t(pre[1])),
        act="none" if mode == "act_none" else "swish",
    )
    if mode == "gn_swish_residual":
        got = got + _t(resid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_conv3x3_wrapper_rejects_act_without_affine():
    x = torch.zeros((1, 4, 4, 8))
    w = torch.zeros((3, 3, 8, 8))
    with pytest.raises(ValueError):
        tconv.conv3x3_gn_swish(x, w, torch.zeros(8), pre_affine=None, act="swish")
