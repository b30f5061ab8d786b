"""The int4 weight-only matmul: wrapper, plain version and launch counter of
kernel G4 (`int4_matmul`, csrc/int4_matmul.cu).

Counterpart of the int4 branch of visualcloze_tpu/models/layers.py:linear
(through quant.dequant_weight_int4), which JAX leaves to XLA:

    y = x @ bf16(q * scale)

x (..., K) with its leading dimensions flattened into M; w_int4 (K/2, N)
uint8, two sign-extended 4-bit codes q a byte (row 2i in the low nibble, 2i+1
in the high one); scale (K/g, N) fp32, one per (g-row input group, output
column). Each weight is dequantized as JAX does it, an fp32 product rounded
once to bf16, the bf16 x bf16 products are summed in fp32 and rounded once
to `out_dtype`; with a bias (N,) (bf16 output only) y + bias in bf16 after
that, as JAX's `linear` adds it to the dot's output. It is the int4 DiT
linear of the port (models/layers.Int4DiTLinear): a per-call dequantize
would write a bf16 copy of every weight to device memory at every DiT
evaluation. On the card the kernel takes
M <= 16 rows (the modulation and embedder GEMVs) in a body that streams the
packed weights without tensor cores, larger M in a wgmma body.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .int8_matmul import add_bias_plain, check_bias, sm_count, wide_pairs

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# a paired CTA's time for one tile over a lone CTA's, at the same K (0.84-0.87
# on the H100, PERF.md): the pair halves G4's convert, which sets its pace
PAIR_TIME = 0.85
BLOCK_K = 64  # the kernel's K step: K and the group must be multiples of it
N_ALIGN = 16  # 16-byte packed column chunks: N must be a multiple of it


def dequant_int4_plain(w_int4: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(..., K/2, N) packed codes and (..., K/g, N) fp32 scales -> the (..., K,
    N) weight in `dtype`: the sign-extended nibble times its scale in fp32,
    one rounding (JAX dequant_weight_int4)."""
    lo = ((w_int4 & 0xF).to(torch.int8) ^ 8) - 8
    hi = ((w_int4 >> 4).to(torch.int8) ^ 8) - 8
    *lead, half, n = w_int4.shape
    groups = scale.shape[-2]
    q = torch.stack([lo, hi], dim=-2).reshape(*lead, groups, 2 * half // groups, n)
    w = q.to(torch.float32) * scale.to(torch.float32)[..., :, None, :]
    return w.reshape(*lead, 2 * half, n).to(dtype)


def int4_matmul_plain(x: torch.Tensor, w_int4: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel G4: bf16(x) @ the dequantized bf16
    weight, summed in fp32, one rounding to `out_dtype`; then + bias in bf16
    (int8_matmul.add_bias_plain). Any group size."""
    *lead, k = x.shape
    w = dequant_int4_plain(w_int4, scale).to(torch.float32)
    y = torch.matmul(x.reshape(-1, k).to(torch.bfloat16).to(torch.float32), w)
    return add_bias_plain(y.to(out_dtype).reshape(*lead, w_int4.shape[1]), bias, "int4_matmul")


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"int4_matmul: {what}")


def int4_matmul(x: torch.Tensor, w_int4: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel G4: x (..., K) @ dequant(w_int4 (K/2, N), scale (K/g, N)) ->
    (..., N) in `out_dtype` (bf16 or fp32), + bias (N,) in the epilogue:
    bf16(bf16(y) + bias), the plain `y + bias` of a bf16 y. A bias is taken
    with a bf16 output only (with fp32 the kernel and the plain version
    refuse it). On CUDA x must be contiguous bf16, w_int4 contiguous uint8,
    scale contiguous fp32 and bias contiguous bf16, K and g multiples of 64
    and N of 16; anything else raises."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, w_int4, scale, out_dtype, bias)
    _require(x.dtype == torch.bfloat16, f"x must be bfloat16, got {x.dtype}")
    _require(w_int4.dtype == torch.uint8 and w_int4.dim() == 2, f"w_int4 must be (K/2, N) uint8, got "
             f"{w_int4.dtype} {tuple(w_int4.shape)}")
    _require(scale.dtype == torch.float32 and scale.dim() == 2, f"scale must be (K/g, N) float32, got "
             f"{scale.dtype} {tuple(scale.shape)}")
    _require(out_dtype in (torch.bfloat16, torch.float32), f"out_dtype must be bf16 or fp32, got {out_dtype}")
    half, n = w_int4.shape
    k = 2 * half
    _require(x.dim() >= 1 and x.shape[-1] == k, f"x {tuple(x.shape)} does not match w_int4 {(half, n)}")
    groups = scale.shape[0]
    _require(scale.shape[1] == n and groups >= 1 and k % groups == 0,
             f"scale {tuple(scale.shape)} does not divide K={k} into groups of N={n} columns")
    group = k // groups
    _require(k % BLOCK_K == 0 and group % BLOCK_K == 0 and n % N_ALIGN == 0,
             f"K and the group must be multiples of {BLOCK_K} and N of {N_ALIGN}, got K={k} group={group} N={n}")
    m = x.numel() // k
    _require(m >= 1, "x has no rows")
    for t in (x, w_int4, scale):
        _require(t.is_cuda, "x, w_int4 and scale must be CUDA tensors")
        _require(t.is_contiguous(), "x, w_int4 and scale must be contiguous")
    _require(x.data_ptr() % 16 == 0 and w_int4.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0,
             "x, w_int4 and scale must be 16-byte aligned")
    check_bias(bias, n, out_dtype, "int4_matmul")
    y = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=x.device)
    kernel = cuda_build.load("int4_matmul", _ARGTYPES)
    status = kernel(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_int4.data_ptr()), ctypes.c_void_p(scale.data_ptr()),
        ctypes.c_void_p(bias.data_ptr() if bias is not None else 0), ctypes.c_void_p(y.data_ptr()), m, n, k, group,
        int(out_dtype == torch.float32),
        int(wide_pairs(m, n, sm_count(x.device), PAIR_TIME)),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    cuda_build.check("int4_matmul", status)
    cuda_build.count_launch(int4_matmul)
    return y


int4_matmul.launches = 0
