"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips without a CUDA device. This file imports no JAX,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q -m gpu
"""

import math

import pytest
import torch

from visualcloze_tpu_torch.ops import conv2d as tconv
from visualcloze_tpu_torch.ops import flash_attention as tfa
from visualcloze_tpu_torch.ops.attention import mask_to_bias


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    return torch.device("cuda")


def _ulps_tol(want, ulps=4):
    """`ulps` bf16 ulps at the largest |want| (8 significant bits)."""
    top = want.abs().max().item()
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7)


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.gpu
def test_gpu_flash_attn_rope_matches_plain():
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, L, d = 2, 4, 1000, 128
    q, k, v = (torch.randn((b, h, L, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    ang = torch.rand((b, L, d // 2), generator=g, device=dev) * 6.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    mask = torch.ones((b, L), dtype=torch.int32, device=dev)
    mask[0, 900:] = 0
    mask[1] = 0
    bias = mask_to_bias(mask)
    got = tfa.flash_attn_rope(q, k, v, bias, cos, sin)
    torch.cuda.synchronize()
    want = tfa.flash_attention_plain(q, k, v, bias, cos, sin)
    tol = _ulps_tol(want)  # roundings of q, k, P and o to bf16: measured 1-2 ulps
    _close(got, want, tol)
    assert (got[1] == 0).all()
    # batch 0 against fp32 attention that never sees its 100 padded keys
    q32, k32 = (tfa._rot_half(t[:1].float(), cos[:1], sin[:1]) for t in (q, k))
    s = torch.matmul(q32, k32[..., :900, :].transpose(-1, -2)) * d ** -0.5
    _close(got[:1], torch.matmul(torch.softmax(s, dim=-1), v[:1, :, :900].float()), tol)


@pytest.mark.gpu
def test_gpu_flash_attn_d512_matches_plain():
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((1, 1, 1100, 512), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    got = tfa.flash_attn_d512(q, k, v)
    torch.cuda.synchronize()
    want = tfa.flash_attention_plain(q, k, v)
    _close(got, want, _ulps_tol(want))


@pytest.mark.gpu
@pytest.mark.parametrize("shape, pre", [((1, 20, 36, 128, 128), True), ((1, 12, 24, 256, 512), True),
                                        ((1, 16, 16, 512, 512), False)])
def test_gpu_conv3x3_matches_plain(shape, pre):
    dev = _cuda_or_skip()
    B, H, W, C, Co = shape
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((B, H, W, C), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 3, C, Co), generator=g, device=dev) * C ** -0.5 / 3).to(torch.bfloat16)
    b = torch.randn((Co,), generator=g, device=dev) * 0.1
    aff = None
    if pre:
        aff = (torch.rand((B, C), generator=g, device=dev) + 0.5, torch.randn((B, C), generator=g, device=dev))
    act = "swish" if pre else "none"
    torch.backends.cudnn.allow_tf32 = False
    got = tconv.conv3x3_gn_swish(x, w, b, pre_affine=aff, act=act)
    torch.cuda.synchronize()
    want = tconv.conv3x3_plain(x, w, b, aff, act)
    _close(got, want, 1e-2 * want.abs().max().item())  # bf16 in, fp32 sums in another order
