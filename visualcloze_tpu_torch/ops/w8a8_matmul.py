"""The int8 x int8 matmul: wrapper, plain version and launch counter of
kernel H (`w8a8_matmul`, csrc/w8a8_matmul.cu).

Counterpart of the product of visualcloze_tpu/models/layers.py:linear's w8a8
branch (XLA fuses the s8 x s8 -> s32 einsum and the rescale into one pass;
there is no Pallas kernel):

    y = bf16((float(codes @ w^T) * x_scale[:, None]) * w_scale[None, :])  (+ bf16 bias)

codes (M, K) int8 from kernel I, w (N, K) int8, x_scale (M,) and w_scale (N,)
fp32. The weight is K-major, (N, K): the JAX entry's (K, N) w_int8
transposed once, where the linear is quantized or converted, because the
8-bit tensor-core products take both operands K-major. The integer sums are
exact, so the kernel equals the plain version bit for bit. The linear's
bias is added in the kernel's epilogue, as JAX adds it after the rounding
(a bf16 add). PyTorch's torch._int_mm would write the s32 product to device
memory and rescale it in two more passes; it is the kernel's yardstick in
chip_smoke.py only.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
BLOCK_K = 128  # the kernel's K step: K must be a multiple of it
N_ALIGN = 16
TILE_M = 128  # the kernel's tile rows
_RESIDENT: list[int] = []  # the card's resident 2-CTA clusters, asked once


def tile_plan(m: int, n: int, resident_pairs: int) -> tuple[int, bool, int]:
    """(tile_n, paired, clusters) of kernel H for an (M, N) output on a card
    that keeps `resident_pairs` clusters of two CTAs at once (66 on the
    H100's 132 SMs), or twice as many lone CTAs. Each option's time is
    counted in rounds of the resident clusters over its tiles, in units of
    a 128-column tile: pairs round the 128-row tiles up to even, so they
    are taken only where that costs no round (the multicast they share
    measured no faster than lone CTAs' own loads on the H100); 128-column
    tiles only where they take 10% less than 256-column ones (the 512-row
    text stream). clusters: the persistent grid, in clusters."""
    mt = -(-m // TILE_M)

    def rounds(bn, cl):
        tiles = -(-mt // cl) * -(-n // bn)
        return -(-tiles // (resident_pairs * 2 // cl)), tiles

    plans = {}
    for bn in (256, 128):
        (r2, t2), (r1, t1) = rounds(bn, 2), rounds(bn, 1)
        if r2 <= r1:
            plans[bn] = r2 * bn, True, min(t2, resident_pairs)
        else:
            plans[bn] = r1 * bn, False, min(t1, 2 * resident_pairs)
    bn = 128 if plans[128][0] < 0.9 * plans[256][0] else 256
    return bn, plans[bn][1], plans[bn][2]


def _resident_clusters() -> int:
    if not _RESIDENT:
        n = cuda_build.load("w8a8_resident_clusters", [], source="w8a8_matmul")()
        if n <= 0:
            raise RuntimeError("w8a8_matmul: the card reports no resident 2-CTA clusters of kernel H")
        _RESIDENT.append(n)
    return _RESIDENT[0]


def w8a8_matmul_plain(codes: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel H: the integer product in float64
    (exact: |sum| < 2^53), rounded to fp32 as an int32 would be, then the
    fp32 rescale in JAX's order, one rounding to bf16 and the bias as a bf16
    add."""
    acc = torch.matmul(codes.to(torch.float64), w.to(torch.float64).t()).to(torch.float32)
    y = (acc * x_scale.to(torch.float32)[:, None] * w_scale.to(torch.float32)).to(torch.bfloat16)
    return y if bias is None else y + bias.to(torch.bfloat16)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"w8a8_matmul: {what}")


def w8a8_matmul(codes: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel H: codes (M, K) int8, w (N, K) int8, x_scale (M,), w_scale (N,)
    fp32, bias (N,) or None -> (M, N) bf16. On CUDA every input must be
    contiguous, K a multiple of 128 and N of 16; anything else raises. The
    bias is taken in bf16 (cast first if it is not)."""
    if codes.device.type == "cpu":
        return w8a8_matmul_plain(codes, w, x_scale, w_scale, bias)
    for t in (codes, w, x_scale, w_scale):
        _require(t.is_cuda and t.is_contiguous(), "codes, w, x_scale and w_scale must be contiguous CUDA tensors")
    _require(codes.dtype == torch.int8 and codes.dim() == 2, f"codes must be (M, K) int8, got {codes.dtype} "
             f"{tuple(codes.shape)}")
    _require(w.dtype == torch.int8 and w.dim() == 2, f"w must be (N, K) int8, got {w.dtype} {tuple(w.shape)}")
    m, k = codes.shape
    n = w.shape[0]
    _require(w.shape[1] == k, f"codes {(m, k)} do not match w {tuple(w.shape)}")
    _require(x_scale.dtype == torch.float32 and tuple(x_scale.shape) == (m,), f"x_scale must be float32 ({m},)")
    _require(w_scale.dtype == torch.float32 and tuple(w_scale.shape) == (n,), f"w_scale must be float32 ({n},)")
    _require(m >= 1 and k % BLOCK_K == 0 and n % N_ALIGN == 0,
             f"M must be positive, K a multiple of {BLOCK_K} and N of {N_ALIGN}, got M={m} K={k} N={n}")
    _require(codes.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0, "codes and w must be 16-byte aligned")
    if bias is not None:
        bias = bias.to(torch.bfloat16).contiguous()
        _require(bias.is_cuda and tuple(bias.shape) == (n,), f"bias must be a CUDA ({n},) tensor")
    y = torch.empty((m, n), dtype=torch.bfloat16, device=codes.device)
    kernel = cuda_build.load("w8a8_matmul", _ARGTYPES)
    tile_n, paired, _ = tile_plan(m, n, _resident_clusters())
    status = kernel(
        ctypes.c_void_p(codes.data_ptr()), ctypes.c_void_p(w.data_ptr()), ctypes.c_void_p(x_scale.data_ptr()),
        ctypes.c_void_p(w_scale.data_ptr()), ctypes.c_void_p(bias.data_ptr() if bias is not None else None),
        ctypes.c_void_p(y.data_ptr()), m, n, k, tile_n, int(paired),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    cuda_build.check("w8a8_matmul", status)
    cuda_build.count_launch(w8a8_matmul)
    return y


w8a8_matmul.launches = 0
