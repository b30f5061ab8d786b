"""The per-token int8 activation quantize: wrapper, plain version and launch
counter of kernel I (`act_quant_int8`, csrc/act_quant_int8.cu).

Counterpart of visualcloze_tpu/models/quant.py:act_quant_int8 with the
SmoothQuant divide of layers.linear's w8a8 branch folded in (XLA fuses both
into one pass in JAX; there is no Pallas kernel):

    xf = float(x) (* a_sinv);  scale = max(max |xf|, 1e-8) / 127  per row;
    codes = clamp(rint(xf / scale), -127, 127)

x (..., K) fp32 or bf16, flattened to (M, K); a_sinv (K,) fp32 or None.
Returns codes (M, K) int8 and scale (M,) fp32. An IEEE division and round
half to even, as jnp's: the kernel, its plain version and JAX agree bit for
bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
K_ALIGN = 8  # 8 elements a thread a step


def act_quant_plain(x: torch.Tensor, a_sinv: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel I: (codes (M, K) int8, scale (M,) fp32).
    The divisor 127 is a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal instead, which can differ in the last bit."""
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    if a_sinv is not None:
        xf = xf * a_sinv.to(torch.float32)
    amax = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8)
    scale = amax / torch.full_like(amax, 127.0)
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale[:, 0]


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"act_quant_int8: {what}")


def act_quant_int8(x: torch.Tensor, a_sinv: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel I: x (..., K) -> (codes (M, K) int8, scale (M,) fp32), M the
    product of x's leading dimensions. On CUDA x must be contiguous fp32 or
    bf16, a_sinv contiguous fp32 (K,), K a multiple of 8; anything else
    raises."""
    if x.device.type == "cpu":
        return act_quant_plain(x, a_sinv)
    _require(x.is_cuda and x.is_contiguous(), "x must be a contiguous CUDA tensor")
    _require(x.dtype in (torch.float32, torch.bfloat16), f"x must be float32 or bfloat16, got {x.dtype}")
    k = x.shape[-1]
    m = x.numel() // k if k else 0
    _require(m >= 1 and k % K_ALIGN == 0, f"K must be a positive multiple of {K_ALIGN} and x have rows, got "
             f"{tuple(x.shape)}")
    if a_sinv is not None:
        _require(a_sinv.is_cuda and a_sinv.is_contiguous() and a_sinv.dtype == torch.float32
                 and tuple(a_sinv.shape) == (k,), f"a_sinv must be a contiguous CUDA float32 ({k},)")
        _require(a_sinv.data_ptr() % 16 == 0, "a_sinv must be 16-byte aligned")
    _require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    kernel = cuda_build.load("act_quant_int8", _ARGTYPES)
    status = kernel(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(a_sinv.data_ptr() if a_sinv is not None else None),
        ctypes.c_void_p(codes.data_ptr()), ctypes.c_void_p(scale.data_ptr()), m, k, int(x.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    cuda_build.check("act_quant_int8", status)
    act_quant_int8.launches += 1
    return codes, scale


act_quant_int8.launches = 0
