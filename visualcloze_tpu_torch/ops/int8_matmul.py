"""The int8 weight-only matmul: wrapper, plain version and launch counter of
kernel G (`int8_matmul`, csrc/int8_matmul.cu).

Counterpart of the Pallas kernel visualcloze_tpu/ops/int8_matmul.py:
int8_matmul (`_kernel`), in its layout:

    y = x @ (w_int8 * scale)

x (..., K) with its leading dimensions flattened into M, w_int8 (K, N) int8
row-major, scale (N,) fp32: bf16 x int8 products summed in fp32, the scale
applied once to the sums, then one rounding to `out_dtype`. It is the int8
linear of the port (models/layers.Int8Linear): the JAX package's int8 linear
leaves the convert to XLA, which fuses it into the matmul's weight loads;
PyTorch has no fused convert-dot, and a dequantized bf16 copy would write
every weight to device memory on every call. On the card the kernel takes
M <= 16 rows (the modulation and embedder GEMVs) in a body that streams the
weights without tensor cores, larger M in a wgmma body.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
BLOCK_K = 64  # the kernel's K step: K must be a multiple of it
N_ALIGN = 16  # 16-byte int8 column chunks: N must be a multiple of it


def int8_matmul_plain(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of kernel G, in fp32: bf16(x) @ w * scale, then
    one rounding to `out_dtype`."""
    *lead, k = x.shape
    y = torch.matmul(x.reshape(-1, k).to(torch.bfloat16).to(torch.float32), w_int8.to(torch.float32))
    return (y * scale.to(torch.float32)).to(out_dtype).reshape(*lead, w_int8.shape[1])


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"int8_matmul: {what}")


def int8_matmul(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel G: x (..., K) @ (w_int8 (K, N) * scale (N,)) -> (..., N) in
    `out_dtype` (bf16 or fp32). On CUDA x must be contiguous bf16, w_int8
    contiguous int8 and scale contiguous fp32, K a multiple of 64 and N of 16;
    anything else raises."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_int8, scale, out_dtype)
    for t in (x, w_int8, scale):
        _require(t.is_cuda, "x, w_int8 and scale must be CUDA tensors")
        _require(t.is_contiguous(), "x, w_int8 and scale must be contiguous")
    _require(x.dtype == torch.bfloat16, f"x must be bfloat16, got {x.dtype}")
    _require(w_int8.dtype == torch.int8 and w_int8.dim() == 2, f"w_int8 must be (K, N) int8, got "
             f"{w_int8.dtype} {tuple(w_int8.shape)}")
    _require(scale.dtype == torch.float32, f"scale must be float32, got {scale.dtype}")
    _require(out_dtype in (torch.bfloat16, torch.float32), f"out_dtype must be bf16 or fp32, got {out_dtype}")
    k, n = w_int8.shape
    _require(x.dim() >= 1 and x.shape[-1] == k, f"x {tuple(x.shape)} does not match w_int8 {(k, n)}")
    _require(tuple(scale.shape) == (n,), f"scale must be ({n},), got {tuple(scale.shape)}")
    _require(k % BLOCK_K == 0 and n % N_ALIGN == 0, f"K must be a multiple of {BLOCK_K} and N of "
             f"{N_ALIGN}, got K={k} N={n}")
    m = x.numel() // k
    _require(m >= 1, "x has no rows")
    _require(x.data_ptr() % 16 == 0 and w_int8.data_ptr() % 16 == 0, "x and w_int8 must be 16-byte aligned")
    y = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=x.device)
    kernel = cuda_build.load("int8_matmul", _ARGTYPES)
    status = kernel(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_int8.data_ptr()), ctypes.c_void_p(scale.data_ptr()),
        ctypes.c_void_p(y.data_ptr()), m, n, k, int(out_dtype == torch.float32),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    cuda_build.check("int8_matmul", status)
    cuda_build.count_launch(int8_matmul)
    return y


int8_matmul.launches = 0
