"""The int8 weight-only matmul: wrapper, plain version and launch counter of
kernel G (`int8_matmul`, csrc/int8_matmul.cu).

Counterpart of the Pallas kernel visualcloze_tpu/ops/int8_matmul.py:
int8_matmul (`_kernel`), in its layout:

    y = x @ (w_int8 * scale)

x (..., K) with its leading dimensions flattened into M, w_int8 (K, N) int8
row-major, scale (N,) fp32: bf16 x int8 products summed in fp32, the scale
applied once to the sums, then one rounding to `out_dtype`; with a bias (N,)
(bf16 output only) y + bias in bf16 after that, as JAX's `linear` adds its
bias to the dot's output (XLA fuses the add into the dot). It is the int8
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

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
BLOCK_K = 64  # the kernel's K step: K must be a multiple of it
N_ALIGN = 16  # 16-byte int8 column chunks: N must be a multiple of it
SMALL_M = 16  # M at or below it takes the GEMV body
TILE_M, TILE_N = 128, 256  # the wide body's output tile
# a paired CTA's time for one tile over a lone CTA's, at the same K (0.87-0.92
# on the H100, PERF.md)
PAIR_TIME = 0.9
_SMS: dict[int, int] = {}  # SMs of each card, asked once


def wide_pairs(m: int, n: int, sms: int, pair_time: float = PAIR_TIME) -> bool:
    """Whether the wide body of G (and G4, with its own pair_time) runs its
    CTAs in clusters of two along M on a card of `sms` SMs: pairs round the
    128-row tiles up to even, so they pay where that adds a wave. Paired when
    the waves of the rounded grid, each pair_time of a lone wave, take less
    than the lone grid's waves; never for the GEMV body (m <= 16)."""
    if m <= SMALL_M:
        return False
    mt, nt = -(-m // TILE_M), -(-n // TILE_N)
    return -(-2 * -(-mt // 2) * nt // sms) * pair_time < -(-mt * nt // sms)


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (asked once a device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def add_bias_plain(y: torch.Tensor, bias: torch.Tensor | None, name: str = "int8_matmul") -> torch.Tensor:
    """y + bias cast to y's dtype (a bf16 add: in fp32, one rounding), the
    bias add of kernels G and G4 and of their plain versions; a bias with an
    fp32 output is refused, as the kernels refuse it."""
    if bias is None:
        return y
    if y.dtype != torch.bfloat16:
        raise ValueError(f"{name}: a bias is added to a bf16 output only, got out_dtype {y.dtype}")
    return y + bias.to(y.dtype)


def int8_matmul_plain(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel G, in fp32: bf16(x) @ w * scale, then
    one rounding to `out_dtype`; then + bias in bf16 (add_bias_plain)."""
    *lead, k = x.shape
    y = torch.matmul(x.reshape(-1, k).to(torch.bfloat16).to(torch.float32), w_int8.to(torch.float32))
    y = (y * scale.to(torch.float32)).to(out_dtype).reshape(*lead, w_int8.shape[1])
    return add_bias_plain(y, bias)


def _require(cond: bool, what: str, name: str = "int8_matmul") -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def check_bias(bias: torch.Tensor | None, n: int, out_dtype: torch.dtype, name: str) -> None:
    """What kernels G and G4 take as a bias: None, or a contiguous bf16 (N,)
    CUDA tensor with a bf16 output (the kernels read it an element at a
    time, so a bf16 tensor's own alignment serves)."""
    if bias is None:
        return
    _require(bias.is_cuda and bias.dtype == torch.bfloat16 and tuple(bias.shape) == (n,) and bias.is_contiguous(),
             f"bias must be a contiguous bf16 CUDA ({n},), got {bias.dtype} {tuple(bias.shape)}", name)
    _require(out_dtype == torch.bfloat16, f"a bias is added to a bf16 output only, got out_dtype {out_dtype}", name)


def int8_matmul(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel G: x (..., K) @ (w_int8 (K, N) * scale (N,)) -> (..., N) in
    `out_dtype` (bf16 or fp32), + bias (N,) in the epilogue: bf16(bf16(y) +
    bias), the plain `y + bias` of a bf16 y. A bias is taken with a bf16
    output only (with fp32 the kernel and the plain version refuse it). On
    CUDA x must be contiguous bf16, w_int8 contiguous int8, scale contiguous
    fp32 and bias contiguous bf16, K a multiple of 64 and N of 16; anything
    else raises."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_int8, scale, out_dtype, bias)
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
    check_bias(bias, n, out_dtype, "int8_matmul")
    y = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=x.device)
    kernel = cuda_build.load("int8_matmul", _ARGTYPES)
    status = kernel(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_int8.data_ptr()), ctypes.c_void_p(scale.data_ptr()),
        ctypes.c_void_p(bias.data_ptr() if bias is not None else 0), ctypes.c_void_p(y.data_ptr()), m, n, k,
        int(out_dtype == torch.float32),
        int(wide_pairs(m, n, sm_count(x.device))), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    cuda_build.check("int8_matmul", status)
    cuda_build.count_launch(int8_matmul)
    return y


int8_matmul.launches = 0
