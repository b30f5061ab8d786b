"""Fused GroupNorm-affine + swish + 3x3 conv: wrapper, plain version and
launch counter of kernel B (`conv3x3_gn_swish`).

Counterpart of the Pallas kernel visualcloze_tpu/ops/conv2d.py:conv3x3_fused
(`_kernel` / `_kernel_wtiled`):

    y = conv3x3_SAME(act(x * a + b0), w) + bias

in NHWC with HWIO weights. a and b0 are the per-(batch, channel) GroupNorm
affine; act is swish or none. The activation runs in fp32 and is rounded to
x.dtype; the conv's zero padding applies AFTER the activation (swish(b0) != 0
on the border). The residual add stays outside the kernel, as in JAX.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build


def conv3x3_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    pre_affine: tuple[torch.Tensor, torch.Tensor] | None = None,
    act: str = "swish",
) -> torch.Tensor:
    """Plain PyTorch version of kernel B: fp32 activation rounded to x.dtype,
    fp32 conv accumulation, fp32 bias, result rounded to x.dtype."""
    xa = x
    if pre_affine is not None:
        a, b0 = pre_affine
        x32 = x.to(torch.float32) * a[:, None, None, :].to(torch.float32) + b0[:, None, None, :].to(
            torch.float32
        )
        if act == "swish":
            x32 = x32 * torch.sigmoid(x32)
        xa = x32.to(x.dtype)
    y = F.conv2d(
        xa.permute(0, 3, 1, 2).to(torch.float32),
        w.permute(3, 2, 0, 1).to(torch.float32),
        padding=1,
    )
    y = y.permute(0, 2, 3, 1) + b.to(torch.float32)
    return y.to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def conv3x3_gn_swish(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    pre_affine: tuple[torch.Tensor, torch.Tensor] | None = None,
    act: str = "swish",
) -> torch.Tensor:
    """Kernel B. x: (B, H, W, C) bf16; w: (3, 3, C, Cout) bf16; b: (Cout,);
    pre_affine: optional fp32 (a, b0), each (B, C); act: "swish" or "none"
    (act needs pre_affine). Returns (B, H, W, Cout) in x.dtype. C and Cout
    must be multiples of 8 on CUDA."""
    if pre_affine is None and act != "none":
        raise ValueError("act is applied to the pre_affine transform; pass act='none' for a plain conv")
    if act not in ("swish", "none"):
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, pre_affine, act)
    name = "conv3x3_gn_swish"
    if not (x.is_cuda and w.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16):
        raise ValueError(f"{name}: x and w must be bfloat16 CUDA tensors")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"{name}: expects x (B, H, W, C) and w (3, 3, C, Cout), got {x.shape} {w.shape}")
    B, H, W, C = x.shape
    Cout = w.shape[3]
    if C % 8 or Cout % 8:
        raise ValueError(f"{name}: C={C} and Cout={Cout} must be multiples of 8")
    x, w = x.contiguous(), w.contiguous()
    bias = b.to(torch.float32).contiguous()
    a = b0 = None
    if pre_affine is not None:
        a, b0 = (t.to(torch.float32).contiguous() for t in pre_affine)
        if tuple(a.shape) != (B, C) or tuple(b0.shape) != (B, C):
            raise ValueError(f"{name}: pre_affine must be two (B, C) = {(B, C)} tensors")
    y = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    kernel = cuda_build.load(name, _ARGTYPES)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    status = kernel(
        ptr(x), ptr(w), ptr(bias), ptr(a), ptr(b0), ptr(y),
        B, H, W, C, Cout, int(pre_affine is not None), int(act == "swish"),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    cuda_build.check(name, status)
    conv3x3_gn_swish.launches += 1
    return y


conv3x3_gn_swish.launches = 0
