"""The DiT blocks' fused passes: wrappers, plain versions and launch counters
of kernels J (`layernorm_modulate`, csrc/layernorm_modulate.cu), K
(`gated_residual`, csrc/gated_residual.cu), L (`qk_norm_split`,
csrc/qk_norm_split.cu) and M (`merge_heads`, csrc/merge_heads.cu), of their
backward kernels J' (`layernorm_modulate_bwd`, csrc/layernorm_modulate_bwd.cu),
K' (`gated_residual_bwd`, csrc/gated_residual_bwd.cu), L'
(`qk_norm_split_bwd`, csrc/qk_norm_split_bwd.cu) and M' (`merge_heads_bwd`,
csrc/merge_heads_bwd.cu), and the autograd Functions built on them.

No Pallas kernel stands behind them: XLA fuses each of these chains inside
the JAX package's `double_block` and `single_block`
(visualcloze_tpu/models/layers.py), and their transposes under `jax.grad`,
where eager PyTorch runs them as many fp32 passes over the token axis:
  - J: `layer_norm` and the adaLN modulate, (1 + scale) * LN(x) + shift,
    stored in the dtype its consumer takes (bf16 before a dense, int8 or
    int4 linear and in the single block; fp32 before a w8a8 linear, whose
    kernel I quantizes the fp32 value);
  - K: the gated residual, x + bf16(gate * fp32(y));
  - L: the head split of a qkv projection with the q/k RMSNorm, written
    into contiguous (B, H, L, D) buffers at a token offset (the double
    block's txt and img streams land in one joint buffer);
  - M: attention's head merge with padded query rows zeroed and, in the
    single block, gelu(tanh) of the MLP half beside it: linear2's input.

Each plain version is the blocks' former PyTorch code; each plain backward
is the closed-form gradient of that code in the rounding order autograd
takes through it. A wrapper takes its plain version only for a CPU tensor;
on a CUDA tensor it launches the kernel or raises.

The blocks (models/layers.py) and attention() reach them through the
`apply_*` entry points: the forward kernel alone on the no-grad forward,
and when an input wants a gradient the autograd Function (`LayerNormModulate`,
`GatedResidual`, `QKNormSplit`, `MergeHeads`), whose forward is the same
kernel and whose backward is the backward kernel (first order only:
once_differentiable). Calibration (collect_stats) keeps the plain versions.
The column sums of the backward kernels (dshift, dscale, dgate, the q/k
scales' gradients) are per-CTA fp32 partials summed in a fixed order by a
second pass: the same bits from run to run, no atomics.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import cuda_build

BF16 = torch.bfloat16
VEC = 8  # elements a thread loads at once: 16 bytes of bf16
MAX_ROW = 8 * 1024  # J's row: one 8-element vector a thread, 1024 threads
MAX_ROW_BWD = 8 * 512  # J' and K' (and L''s H * D): 512 threads, whose registers hold a row's state

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_J_ARGTYPES = [_P, _LL, _LL, _P, _LL, _P, _LL, _P, _I, _I, _I, _I, _P]
_K_ARGTYPES = [_P, _P, _P, _LL, _P, _I, _I, _I, _P]
_L_ARGTYPES = [_P, _LL, _LL, _P, _P, _P, _P, _P] + [_I] * 6 + [_P]
_M_ARGTYPES = [_P, _P, _P, _LL, _LL, _P] + [_I] * 6 + [_P]
_JB_ARGTYPES = [_P, _LL, _LL, _P, _LL, _P, _I, _P, _P, _P, _P] + [_I] * 4 + [_P]
_KB_ARGTYPES = [_P, _P, _P, _LL, _P, _P, _P] + [_I] * 4 + [_P]
_LB_ARGTYPES = [_P, _LL, _LL, _P, _P, _P, _P, _P, _P, _LL, _LL, _P, _P] + [_I] * 7 + [_P]
_MB_ARGTYPES = [_P, _P, _P, _LL, _LL, _P, _P, _LL, _LL] + [_I] * 5 + [_P]
SM_COUNT = 132  # the H100 SXM's SMs: the backward kernels' row chunks aim at two CTAs on each


def _layer_norm_stats(x: torch.Tensor, eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(layer_norm(x), rstd): the fp32 normalized rows and 1 / sqrt(var + eps)."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (x32 - mu) * rstd, rstd


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm in fp32 (returns fp32)."""
    return _layer_norm_stats(x, eps)[0]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """fp32 RMS norm, cast back before the learned scale."""
    x32 = x.to(torch.float32)
    rrms = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * rrms).to(x.dtype) * scale.to(x.dtype)


def split_heads(qkv: torch.Tensor, num_heads: int):
    """(B, L, 3*H*D) -> three (B, H, L, D); feature order (k, h, d)."""
    b, l, f = qkv.shape
    d = f // (3 * num_heads)
    x = qkv.reshape(b, l, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def _ptr(t: torch.Tensor | None):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def _check_rows(name: str, what: str, t: torch.Tensor, dtype) -> None:
    """t (B, L, N) on the card in `dtype`: its last axis contiguous, every
    row 16-byte aligned (the kernels' vector loads)."""
    _require(t.is_cuda, name, f"{what} must be a CUDA tensor")
    _require(t.dtype == dtype and t.dim() == 3, name, f"{what} must be (B, L, N) {dtype}, got {t.dtype} "
             f"{tuple(t.shape)}")
    vec = 16 // t.element_size()
    _require(t.stride(-1) == 1 and t.shape[-1] % VEC == 0 and t.data_ptr() % 16 == 0
             and t.stride(0) % vec == 0 and t.stride(1) % vec == 0, name,
             f"{what} needs a contiguous last axis of a multiple of {VEC} and 16-byte aligned rows")


def _wants_grad(*ts) -> bool:
    """Whether autograd records a call on these tensors (None skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def _rows_per_cta(b: int, l: int) -> int:
    """Rows (tokens) each CTA of a backward kernel takes: about two CTAs an
    SM over the B * L rows, at least 4, so the fp32 column-sum partials stay
    a small share of the traffic. Fixed by the shape: the same sums in the
    same order at every launch."""
    return max(4, -(-b * l // (2 * SM_COUNT)))


def _check_vector(name: str, what: str, t: torch.Tensor, b: int, c: int) -> None:
    """A modulation vector: fp32 (B, 1, C) on the card, contiguous along C,
    16-byte aligned rows (a chunk of Modulation's output is a strided view)."""
    _require(t.is_cuda and t.dtype == torch.float32 and tuple(t.shape) == (b, 1, c), name,
             f"{what} must be a CUDA float32 ({b}, 1, {c})")
    _require(t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0, name,
             f"{what} needs a contiguous last axis and 16-byte aligned rows")


# ----------------------------- J: LayerNorm + modulate -----------------------------


def layernorm_modulate_plain(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of kernel J: (1 + scale) * layer_norm(x) + shift
    in fp32, cast to out_dtype. shift, scale (B, 1, C) fp32."""
    return ((1.0 + scale) * layer_norm(x) + shift).to(out_dtype)


def layernorm_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel J: x (B, L, C) -> (1 + scale) * layer_norm(x) + shift as
    out_dtype (bf16 or fp32), contiguous. On CUDA x must be bf16 with a
    contiguous last axis (its rows may be strided: the final layer's image
    tokens), C a multiple of 8 up to 8192; shift and scale fp32 (B, 1, C)."""
    if x.device.type == "cpu":
        return layernorm_modulate_plain(x, shift, scale, out_dtype)
    name = "layernorm_modulate"
    _check_rows(name, "x", x, BF16)
    b, l, c = x.shape
    _require(l >= 1 and c <= MAX_ROW, name, f"x must have rows of at most {MAX_ROW}, got {tuple(x.shape)}")
    _require(out_dtype in (BF16, torch.float32), name, f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    for what, t in (("shift", shift), ("scale", scale)):
        _check_vector(name, what, t, b, c)
    y = torch.empty((b, l, c), dtype=out_dtype, device=x.device)
    kernel = cuda_build.load(name, _J_ARGTYPES)
    status = kernel(_ptr(x), x.stride(0), x.stride(1), _ptr(scale), scale.stride(0), _ptr(shift), shift.stride(0),
                    _ptr(y), b, l, c, int(out_dtype == BF16), _stream())
    cuda_build.check(name, status)
    cuda_build.count_launch(layernorm_modulate)
    return y


layernorm_modulate.launches = 0


# ----------------------------- K: gated residual -----------------------------


def gated_residual_plain(x: torch.Tensor, gate: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel K: x + bf16(gate * fp32(y)) (the
    product rounded to x's dtype, then the sum). gate (B, 1, C) fp32."""
    return x + (gate * y.to(torch.float32)).to(x.dtype)


def gated_residual(x: torch.Tensor, gate: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kernel K: x + bf16(gate * fp32(y)), out of place. On CUDA x and y
    bf16 (B, L, C) (made contiguous), C a multiple of 8; gate fp32 (B, 1, C)."""
    if x.device.type == "cpu":
        return gated_residual_plain(x, gate, y)
    name = "gated_residual"
    _require(x.is_cuda and y.is_cuda, name, "x and y must be CUDA tensors")
    x, y = x.contiguous(), y.contiguous()
    for what, t in (("x", x), ("y", y)):
        _check_rows(name, what, t, BF16)
    _require(x.shape == y.shape and x.shape[1] >= 1, name, f"x and y shapes differ: {tuple(x.shape)} {tuple(y.shape)}")
    b, l, c = x.shape
    _check_vector(name, "gate", gate, b, c)
    out = torch.empty_like(x)
    kernel = cuda_build.load(name, _K_ARGTYPES)
    status = kernel(_ptr(x), _ptr(y), _ptr(gate), gate.stride(0), _ptr(out), b, l, c, _stream())
    cuda_build.check(name, status)
    cuda_build.count_launch(gated_residual)
    return out


gated_residual.launches = 0


# ----------------------------- L: head split + q/k RMSNorm -----------------------------


def qk_norm_split_plain(qkv: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor, num_heads: int,
                        out: tuple | None = None, offset: int = 0):
    """Plain PyTorch version of kernel L: split_heads, then rms_norm of q and k
    with their scales, cast to v's dtype; written into `out` (three (B, H,
    L_total, D) buffers) at tokens [offset, offset + L) when given.
    Returns (q, k, v): the buffers, or new (B, H, L, D) tensors."""
    q, k, v = split_heads(qkv, num_heads)
    q, k = rms_norm(q, q_scale).to(v.dtype), rms_norm(k, k_scale).to(v.dtype)
    if out is None:
        return q, k, v
    for buf, t in zip(out, (q, k, v)):
        buf[:, :, offset:offset + t.shape[2]] = t
    return out


def qkv_buffers(qkv: torch.Tensor, num_heads: int, length: int) -> tuple:
    """Three empty contiguous (B, H, length, D) buffers for kernel L's output
    of `qkv` (B, L, 3*H*D) (length: the joint sequence)."""
    b, _, f = qkv.shape
    shape = (b, num_heads, length, f // (3 * num_heads))
    return tuple(torch.empty(shape, dtype=qkv.dtype, device=qkv.device) for _ in range(3))


def qk_norm_split(qkv: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor, num_heads: int,
                  out: tuple | None = None, offset: int = 0):
    """Kernel L: qkv (B, L, 3*H*D) -> q, k RMS-normalized and v, each
    (B, H, L, D), or written into `out` (qkv_buffers) at token `offset`.
    On CUDA qkv is bf16 with a contiguous last axis (its rows may be
    strided: linear1's first 3*H*D columns), D / 8 a power of two up to 32;
    the scales (D,) are cast to bf16, as rms_norm casts them."""
    if qkv.device.type == "cpu":
        return qk_norm_split_plain(qkv, q_scale, k_scale, num_heads, out, offset)
    name = "qk_norm_split"
    _check_rows(name, "qkv", qkv, BF16)
    b, l, f = qkv.shape
    d = f // (3 * num_heads)
    _require(f == 3 * num_heads * d and d % VEC == 0 and l >= 1, name,
             f"qkv (B, L, 3*H*D) with D a multiple of {VEC}, got {tuple(qkv.shape)} for {num_heads} heads")
    lanes = d // VEC
    _require(lanes <= 32 and lanes & (lanes - 1) == 0 and num_heads * lanes <= 1024, name,
             f"D / {VEC} must be a power of two up to 32 and H * D / {VEC} at most 1024, got H {num_heads}, D {d}")
    if out is None:
        out = qkv_buffers(qkv, num_heads, l)
    total = out[0].shape[2]
    for t in out:
        _require(t.is_cuda and t.dtype == BF16 and t.is_contiguous() and tuple(t.shape) == (b, num_heads, total, d),
                 name, f"out must be three contiguous bf16 CUDA ({b}, {num_heads}, L_total, {d})")
    _require(0 <= offset and offset + l <= total, name, f"tokens [{offset}, {offset + l}) outside L_total {total}")
    scales = []
    for what, s in (("q_scale", q_scale), ("k_scale", k_scale)):
        s = s.to(BF16).contiguous()
        _require(s.is_cuda and tuple(s.shape) == (d,) and s.data_ptr() % 16 == 0, name,
                 f"{what} must be a 16-byte aligned CUDA ({d},)")
        scales.append(s)
    kernel = cuda_build.load(name, _L_ARGTYPES)
    status = kernel(_ptr(qkv), qkv.stride(0), qkv.stride(1), _ptr(scales[0]), _ptr(scales[1]), _ptr(out[0]),
                    _ptr(out[1]), _ptr(out[2]), b, l, num_heads, d, total, offset, _stream())
    cuda_build.check(name, status)
    cuda_build.count_launch(qk_norm_split)
    return out


qk_norm_split.launches = 0


# ----------------------------- M: head merge (+ gelu) -----------------------------


def merge_heads_plain(x: torch.Tensor, mask: torch.Tensor | None = None,
                      gelu: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel M: (B, H, L, D) -> (B, L, H*D) with the
    rows where mask (B, L) is 0 zeroed; then, given gelu (B, L, G),
    concatenated with gelu_tanh(gelu) -> (B, L, H*D + G)."""
    b, h, l, d = x.shape
    x = x.transpose(1, 2).reshape(b, l, h * d)
    if mask is not None:
        x = x * mask[..., None].to(x.dtype)
    if gelu is not None:
        x = torch.cat([x, F.gelu(gelu, approximate="tanh")], dim=-1)
    return x


def merge_heads(x: torch.Tensor, mask: torch.Tensor | None = None, gelu: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel M: merge_heads_plain in one pass into one new (B, L, H*D [+ G])
    bf16 tensor. On CUDA x is bf16 (B, H, L, D) (made contiguous), D a
    multiple of 8; mask (B, L) {1 real, 0 pad} (taken as int32); gelu bf16
    (B, L, G) with a contiguous last axis, G a multiple of 8 (its rows may be
    strided: linear1's last columns)."""
    if x.device.type == "cpu":
        return merge_heads_plain(x, mask, gelu)
    name = "merge_heads"
    _require(x.is_cuda, name, "x must be a CUDA tensor")
    x = x.contiguous()
    _require(x.dtype == BF16 and x.dim() == 4 and x.shape[-1] % VEC == 0 and x.shape[2] >= 1, name,
             f"x must be (B, H, L, D) bfloat16 with D a multiple of {VEC}, got {x.dtype} {tuple(x.shape)}")
    b, h, l, d = x.shape
    if mask is not None:
        _require(mask.is_cuda and tuple(mask.shape) == (b, l), name, f"mask must be a CUDA ({b}, {l})")
        mask = mask.to(torch.int32).contiguous()
    g = 0
    if gelu is not None:
        _check_rows(name, "gelu", gelu, BF16)
        _require(tuple(gelu.shape[:2]) == (b, l), name, f"gelu must be ({b}, {l}, G), got {tuple(gelu.shape)}")
        g = gelu.shape[-1]
    out = torch.empty((b, l, h * d + g), dtype=BF16, device=x.device)
    kernel = cuda_build.load(name, _M_ARGTYPES)
    status = kernel(_ptr(x), _ptr(mask), _ptr(gelu), gelu.stride(0) if g else 0, gelu.stride(1) if g else 0,
                    _ptr(out), b, l, h, d, g, h * d + g, _stream())
    cuda_build.check(name, status)
    cuda_build.count_launch(merge_heads)
    return out


merge_heads.launches = 0


# ----------------------------- J': the backward of J -----------------------------


def layernorm_modulate_bwd_plain(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, need_dx: bool = True,
                                 need_vectors: bool = True):
    """Plain PyTorch version of kernel J': the gradients of
    layernorm_modulate_plain(x, shift, scale) given dy (its output's dtype).
    With n = layer_norm(x) and g = dy * (1 + scale), all in fp32:
    dx = rstd * (g - mean(g) - n * mean(g * n)) in x's dtype;
    dshift = sum_L dy, dscale = sum_L dy * n, fp32 (B, 1, C).
    Returns (dx, dshift, dscale), None for what is not asked for."""
    n, rstd = _layer_norm_stats(x)
    dy32 = dy.to(torch.float32)
    dx = dshift = dscale = None
    if need_dx:
        g = dy32 * (1.0 + scale)
        dx = (rstd * (g - g.mean(dim=-1, keepdim=True) - n * (g * n).mean(dim=-1, keepdim=True))).to(x.dtype)
    if need_vectors:
        dshift = dy32.sum(dim=1, keepdim=True)
        dscale = (dy32 * n).sum(dim=1, keepdim=True)
    return dx, dshift, dscale


def layernorm_modulate_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, need_dx: bool = True,
                           need_vectors: bool = True):
    """Kernel J': layernorm_modulate_bwd_plain in one pass over x and dy
    (mean and rstd recomputed from each row, not saved), the column sums as
    per-CTA partials and a fixed-order second pass. On CUDA x as kernel J
    takes it (bf16, rows may be strided) with C at most 4096, scale fp32
    (B, 1, C), dy bf16 or fp32 (B, L, C) (made contiguous); dx a new
    contiguous bf16 tensor."""
    if x.device.type == "cpu":
        return layernorm_modulate_bwd_plain(x, scale, dy, need_dx, need_vectors)
    name = "layernorm_modulate_bwd"
    _check_rows(name, "x", x, BF16)
    b, l, c = x.shape
    _require(l >= 1 and c <= MAX_ROW_BWD, name, f"x must have rows of at most {MAX_ROW_BWD}, got {tuple(x.shape)}")
    _check_vector(name, "scale", scale, b, c)
    _require(dy.is_cuda and dy.dtype in (BF16, torch.float32) and dy.shape == x.shape, name,
             f"dy must be a CUDA bfloat16 or float32 {tuple(x.shape)}, got {dy.dtype} {tuple(dy.shape)}")
    dy = dy.contiguous()
    rows = _rows_per_cta(b, l)
    chunks = -(-l // rows)
    dx = torch.empty((b, l, c), dtype=BF16, device=x.device) if need_dx else None
    partial = dshift = dscale = None
    if need_vectors:
        partial = torch.empty((2, b, chunks, c), dtype=torch.float32, device=x.device)
        dshift, dscale = (torch.empty((b, 1, c), dtype=torch.float32, device=x.device) for _ in range(2))
    kernel = cuda_build.load(name, _JB_ARGTYPES)
    status = kernel(_ptr(x), x.stride(0), x.stride(1), _ptr(scale), scale.stride(0), _ptr(dy), int(dy.dtype == BF16),
                    _ptr(dx), _ptr(partial), _ptr(dshift), _ptr(dscale), b, l, c, rows, _stream())
    cuda_build.check(name, status)
    cuda_build.count_launch(layernorm_modulate_bwd)
    return dx, dshift, dscale


layernorm_modulate_bwd.launches = 0


# ----------------------------- K': the backward of K -----------------------------


def gated_residual_bwd_plain(gate: torch.Tensor, y: torch.Tensor, dout: torch.Tensor, need_dy: bool = True,
                             need_dgate: bool = True):
    """Plain PyTorch version of kernel K': the gradients of
    gated_residual_plain(x, gate, y) given dout, apart from dx = dout:
    dy = bf16(gate * fp32(dout)) (y's dtype), dgate = sum_L fp32(dout) *
    fp32(y), fp32 (B, 1, C). Returns (dy, dgate), None for what is not
    asked for."""
    d32 = dout.to(torch.float32)
    dy = (d32 * gate).to(y.dtype) if need_dy else None
    dgate = (d32 * y.to(torch.float32)).sum(dim=1, keepdim=True) if need_dgate else None
    return dy, dgate


def gated_residual_bwd(gate: torch.Tensor, y: torch.Tensor, dout: torch.Tensor, need_dy: bool = True,
                       need_dgate: bool = True):
    """Kernel K': gated_residual_bwd_plain in one pass over dout and y, dgate
    as per-CTA partials and a fixed-order second pass. On CUDA y and dout
    bf16 (B, L, C) (made contiguous), C a multiple of 8 up to 4096; gate fp32
    (B, 1, C)."""
    if y.device.type == "cpu":
        return gated_residual_bwd_plain(gate, y, dout, need_dy, need_dgate)
    name = "gated_residual_bwd"
    _require(y.is_cuda and dout.is_cuda, name, "y and dout must be CUDA tensors")
    y, dout = y.contiguous(), dout.contiguous()
    for what, t in (("y", y), ("dout", dout)):
        _check_rows(name, what, t, BF16)
    _require(y.shape == dout.shape and y.shape[1] >= 1 and y.shape[2] <= MAX_ROW_BWD, name,
             f"y and dout must be one (B, L, C) shape with C at most {MAX_ROW_BWD}: {tuple(y.shape)} "
             f"{tuple(dout.shape)}")
    b, l, c = y.shape
    _check_vector(name, "gate", gate, b, c)
    rows = _rows_per_cta(b, l)
    dy = torch.empty_like(y) if need_dy else None
    partial = dgate = None
    if need_dgate:
        partial = torch.empty((b, -(-l // rows), c), dtype=torch.float32, device=y.device)
        dgate = torch.empty((b, 1, c), dtype=torch.float32, device=y.device)
    kernel = cuda_build.load(name, _KB_ARGTYPES)
    status = kernel(_ptr(y), _ptr(dout), _ptr(gate), gate.stride(0), _ptr(dy), _ptr(partial), _ptr(dgate), b, l, c,
                    rows, _stream())
    cuda_build.check(name, status)
    cuda_build.count_launch(gated_residual_bwd)
    return dy, dgate


gated_residual_bwd.launches = 0


# ----------------------------- L': the backward of L -----------------------------


def qk_norm_split_bwd_plain(qkv: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor, num_heads: int,
                            dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, offset: int = 0,
                            out: torch.Tensor | None = None, need_scales: bool = False):
    """Plain PyTorch version of kernel L': the gradients of
    qk_norm_split_plain(qkv, ..., offset=offset) given dq, dk, dv (B, H,
    L_total, D), read at tokens [offset, offset + L). For q and k (x, its
    scale s): dn = fp32(bf16(dq * s)) (rms_norm's multiply in x's dtype),
    then in fp32 with n = x * rrms: dx = rrms * (dn - n * mean(dn * n));
    v's gradient is dv. dqkv (B, L, 3*H*D) in x's dtype, feature order (k,
    h, d), written into out[..., :3*H*D] when given (out's rows may be
    strided); with need_scales also dq_scale, dk_scale: (D,) fp32 sums over
    B, H and L of fp32(dq) * fp32(bf16(n)). Returns (dqkv, dq_scale,
    dk_scale)."""
    b, l, _ = qkv.shape
    q, k, _ = split_heads(qkv, num_heads)
    span = slice(offset, offset + l)
    grads, dscales = [], []
    for x, s, dt in ((q, q_scale, dq), (k, k_scale, dk)):
        x32 = x.to(torch.float32)
        rrms = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + 1e-6)
        n = x32 * rrms
        d = dt[:, :, span]
        dn = (d.to(x.dtype) * s.to(x.dtype)).to(torch.float32)
        grads.append((rrms * (dn - n * (dn * n).mean(dim=-1, keepdim=True))).to(x.dtype))
        if need_scales:
            dscales.append((d.to(torch.float32) * n.to(x.dtype).to(torch.float32)).sum(dim=(0, 1, 2)))
    grads.append(dv[:, :, span].to(qkv.dtype))
    dqkv = torch.stack(grads, dim=0).permute(1, 3, 0, 2, 4).reshape(b, l, -1)
    if out is not None:
        out[..., : dqkv.shape[-1]] = dqkv
        dqkv = out
    return (dqkv, *dscales) if need_scales else (dqkv, None, None)


def qk_norm_split_bwd(qkv: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor, num_heads: int,
                      dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, offset: int = 0,
                      out: torch.Tensor | None = None, need_scales: bool = False):
    """Kernel L': qk_norm_split_bwd_plain in one pass: a CTA a chunk of
    tokens and one of q, k, v, raw q and k re-read from qkv's strided rows,
    dq, dk, dv read from (B, H, L_total, D) at `offset` (made contiguous),
    dqkv written in _split_heads' feature order into `out` (B, L, >= 3*H*D
    bf16, rows may be strided: linear1's gradient buffer) or a new (B, L,
    3*H*D); the scales' sums as per-CTA partials and a fixed-order second
    pass. Shapes as kernel L takes them, H * D at most 4096."""
    if qkv.device.type == "cpu":
        return qk_norm_split_bwd_plain(qkv, q_scale, k_scale, num_heads, dq, dk, dv, offset, out, need_scales)
    name = "qk_norm_split_bwd"
    _check_rows(name, "qkv", qkv, BF16)
    b, l, f = qkv.shape
    d = f // (3 * num_heads)
    _require(f == 3 * num_heads * d and d % VEC == 0 and l >= 1, name,
             f"qkv (B, L, 3*H*D) with D a multiple of {VEC}, got {tuple(qkv.shape)} for {num_heads} heads")
    lanes = d // VEC
    _require(lanes <= 32 and lanes & (lanes - 1) == 0 and num_heads * d <= MAX_ROW_BWD, name,
             f"D / {VEC} must be a power of two up to 32 and H * D at most {MAX_ROW_BWD}, got H {num_heads}, D {d}")
    grads = []
    for what, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        _require(t.is_cuda and t.dtype == BF16 and t.dim() == 4 and tuple(t.shape[:2]) == (b, num_heads)
                 and t.shape[3] == d, name, f"{what} must be a CUDA bf16 ({b}, {num_heads}, L_total, {d})")
        grads.append(t.contiguous())
    total = grads[0].shape[2]
    _require(all(t.shape[2] == total for t in grads) and 0 <= offset and offset + l <= total, name,
             f"tokens [{offset}, {offset + l}) outside L_total {total}")
    if out is None:
        out = torch.empty((b, l, f), dtype=BF16, device=qkv.device)
    _check_rows(name, "out", out, BF16)
    _require(tuple(out.shape[:2]) == (b, l) and out.shape[2] >= f, name,
             f"out must be ({b}, {l}, >= {f}), got {tuple(out.shape)}")
    scales = []
    for what, s in (("q_scale", q_scale), ("k_scale", k_scale)):
        s = s.to(BF16).contiguous()
        _require(s.is_cuda and tuple(s.shape) == (d,) and s.data_ptr() % 16 == 0, name,
                 f"{what} must be a 16-byte aligned CUDA ({d},)")
        scales.append(s)
    rows = _rows_per_cta(b, l)
    partial = dscales = None
    if need_scales:
        partial = torch.empty((2, b * -(-l // rows), d), dtype=torch.float32, device=qkv.device)
        dscales = torch.empty((2, d), dtype=torch.float32, device=qkv.device)
    kernel = cuda_build.load(name, _LB_ARGTYPES)
    status = kernel(_ptr(qkv), qkv.stride(0), qkv.stride(1), _ptr(scales[0]), _ptr(scales[1]), *map(_ptr, grads),
                    _ptr(out), out.stride(0), out.stride(1), _ptr(partial), _ptr(dscales), b, l, num_heads, d, total,
                    offset, rows, _stream())
    cuda_build.check(name, status)
    cuda_build.count_launch(qk_norm_split_bwd)
    return (out, dscales[0], dscales[1]) if need_scales else (out, None, None)


qk_norm_split_bwd.launches = 0


# ----------------------------- M': the backward of M -----------------------------

GELU_BETA, GELU_KAPPA = math.sqrt(2.0) * (2.0 / math.sqrt(math.pi)) * 0.5, 0.044715  # PyTorch's tanh gelu


def gelu_tanh_grad(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dy * gelu_tanh'(x) in fp32 (returns fp32), in the order of PyTorch's
    gelu backward (approximate="tanh")."""
    x32 = x.to(torch.float32)
    x_sq = x32 * x32
    t = torch.tanh(GELU_BETA * (x32 + GELU_KAPPA * (x_sq * x32)))
    left_derivative = 0.5 * (1.0 + t)
    right_derivative = (0.5 * x32) * (1.0 - t * t) * (GELU_BETA * (1.0 + 3.0 * GELU_KAPPA * x_sq))
    return dy.to(torch.float32) * (left_derivative + right_derivative)


def _grad_rows(g: torch.Tensor) -> torch.Tensor:
    """An empty gradient for g (B, L, G). When g is a column block of wider
    contiguous rows (linear1's gelu half of its (B, L, W) output), it is the
    same columns of a new (B, L, W) buffer, so the producer of the other
    columns' gradient (QKNormSplit's backward) completes that buffer in place
    and linear1 gets one gradient with no sum; else a new (B, L, G)."""
    b, l, cols = g.shape
    w = g.stride(1)
    col = g.storage_offset() % w if w else 0
    if w > cols and g.stride() == (l * w, w, 1) and col + cols <= w:
        return torch.empty((b, l, w), dtype=g.dtype, device=g.device)[..., col:col + cols]
    return torch.empty_like(g, memory_format=torch.contiguous_format)


def merge_heads_bwd_plain(dout: torch.Tensor, num_heads: int, mask: torch.Tensor | None = None,
                          gelu: torch.Tensor | None = None, need_dx: bool = True, need_dg: bool = True):
    """Plain PyTorch version of kernel M': the gradients of
    merge_heads_plain(x, mask, gelu) given dout (B, L, H*D [+ G]):
    dx (B, H, L, D) = dout's first H*D columns with the padded rows (mask
    0) zeroed, transposed; with gelu, dg = dout[..., H*D:] *
    gelu_tanh'(gelu) in fp32, rounded once to gelu's dtype, in a buffer laid
    out as _grad_rows says. Returns (dx, dg), None for what is not asked for."""
    b, l, cols = dout.shape
    g = 0 if gelu is None else gelu.shape[-1]
    hd = cols - g
    dx = dg = None
    if need_dx:
        da = dout[..., :hd]
        if mask is not None:
            da = da * mask[..., None].to(da.dtype)
        dx = da.reshape(b, l, num_heads, hd // num_heads).transpose(1, 2).contiguous()
    if gelu is not None and need_dg:
        dg = _grad_rows(gelu)
        dg.copy_(gelu_tanh_grad(dout[..., hd:], gelu))
    return dx, dg


def merge_heads_bwd(dout: torch.Tensor, num_heads: int, mask: torch.Tensor | None = None,
                    gelu: torch.Tensor | None = None, need_dx: bool = True, need_dg: bool = True):
    """Kernel M': merge_heads_bwd_plain in one pass, a CTA a token. On CUDA
    dout bf16 (B, L, H*D + G) (made contiguous), D and G multiples of 8;
    mask (B, L) (taken as int32); gelu the forward's bf16 (B, L, G) input
    (its rows may be strided: linear1's last columns)."""
    if dout.device.type == "cpu":
        return merge_heads_bwd_plain(dout, num_heads, mask, gelu, need_dx, need_dg)
    name = "merge_heads_bwd"
    _require(dout.is_cuda, name, "dout must be a CUDA tensor")
    dout = dout.contiguous()
    _require(dout.dtype == BF16 and dout.dim() == 3, name, f"dout must be (B, L, N) bfloat16, got {dout.dtype} "
             f"{tuple(dout.shape)}")
    b, l, cols = dout.shape
    g = 0
    if gelu is not None:
        _check_rows(name, "gelu", gelu, BF16)
        _require(tuple(gelu.shape[:2]) == (b, l), name, f"gelu must be ({b}, {l}, G), got {tuple(gelu.shape)}")
        g = gelu.shape[-1]
    hd = cols - g
    d = hd // num_heads
    _require(l >= 1 and hd == num_heads * d and d % VEC == 0, name,
             f"dout's first H*D columns with D a multiple of {VEC}, got {cols} - {g} for {num_heads} heads")
    if mask is not None:
        _require(mask.is_cuda and tuple(mask.shape) == (b, l), name, f"mask must be a CUDA ({b}, {l})")
        mask = mask.to(torch.int32).contiguous()
    dx = torch.empty((b, num_heads, l, d), dtype=BF16, device=dout.device) if need_dx else None
    dg = _grad_rows(gelu) if g and need_dg else None
    if dx is None and dg is None:
        return None, None
    kernel = cuda_build.load(name, _MB_ARGTYPES)
    status = kernel(_ptr(dout), _ptr(mask), _ptr(gelu if dg is not None else None),
                    gelu.stride(0) if dg is not None else 0, gelu.stride(1) if dg is not None else 0, _ptr(dx),
                    _ptr(dg), dg.stride(0) if dg is not None else 0, dg.stride(1) if dg is not None else 0,
                    b, l, num_heads, d, g, _stream())
    cuda_build.check(name, status)
    cuda_build.count_launch(merge_heads_bwd)
    return dx, dg


merge_heads_bwd.launches = 0


# ----------------------------- the autograd Functions -----------------------------


class LayerNormModulate(torch.autograd.Function):
    """layernorm_modulate with kernel J' as its backward; saves x and scale."""

    @staticmethod
    def forward(ctx, x, shift, scale, out_dtype):
        ctx.save_for_backward(x, scale)
        return layernorm_modulate(x, shift, scale, out_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        need_x, need_shift, need_scale = ctx.needs_input_grad[:3]
        dx, dshift, dscale = layernorm_modulate_bwd(x, scale, dy, need_x, need_shift or need_scale)
        return dx, dshift if need_shift else None, dscale if need_scale else None, None


class GatedResidual(torch.autograd.Function):
    """gated_residual with kernel K' as its backward (dx is dout itself);
    saves gate and y."""

    @staticmethod
    def forward(ctx, x, gate, y):
        ctx.save_for_backward(gate, y)
        return gated_residual(x, gate, y)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        gate, y = ctx.saved_tensors
        need_x, need_gate, need_y = ctx.needs_input_grad
        dy = dgate = None
        if need_y or need_gate:
            dy, dgate = gated_residual_bwd(gate, y, dout, need_y, need_gate)
        return dout if need_x else None, dgate, dy


def _complete_rows(x: torch.Tensor, d_rest: torch.Tensor, cols: int) -> torch.Tensor:
    """The gradient buffer of x (B, L, W) whose columns [cols, W) hold d_rest,
    the gradient of x[..., cols:]: the (B, L, W) buffer d_rest is a view of
    when merge_heads_bwd laid it out so (_grad_rows), else a new one with
    d_rest copied in. Its columns [0, cols) are for the caller to write."""
    b, l, w = x.shape
    start = d_rest.storage_offset() - cols
    if (d_rest.dtype == x.dtype and d_rest.stride() == (l * w, w, 1) and start >= 0 and start % w == 0
            and d_rest.untyped_storage().nbytes() >= (start + b * l * w) * d_rest.element_size()):
        return d_rest.as_strided((b, l, w), (l * w, w, 1), start)
    dh = torch.empty((b, l, w), dtype=x.dtype, device=x.device)
    dh[..., cols:] = d_rest
    return dh


class QKNormSplit(torch.autograd.Function):
    """qk_norm_split of one or more streams into one joint (B, H, sum L, D)
    q, k, v (in order, each at its token offset), kernel L' as the backward
    (one launch a stream each way). The streams come flat: (x, q_scale,
    k_scale) each, qkv = x[..., :qkv_cols]. A single stream wider than
    qkv_cols (the single block's linear1 output h) also returns its other
    columns (the gelu half) as a fourth output, which kernel M takes: M'
    writes that output's gradient into a (B, L, W) buffer (_grad_rows) and
    L' writes qkv's gradient into the same buffer's first qkv_cols columns,
    so h gets one gradient tensor, with no zero-filled slice gradients
    and no sum."""

    @staticmethod
    def forward(ctx, num_heads, qkv_cols, *flat):
        streams = [flat[i:i + 3] for i in range(0, len(flat), 3)]
        out = _split_streams(streams, num_heads, qkv_cols)
        ctx.num_heads, ctx.qkv_cols = num_heads, qkv_cols
        ctx.save_for_backward(*flat)
        rest = _rest_columns(streams, qkv_cols)
        return out if rest is None else (*out, rest)

    @staticmethod
    @once_differentiable
    def backward(ctx, dq, dk, dv, *d_rest):
        flat, cols = ctx.saved_tensors, ctx.qkv_cols
        grads, offset = [], 0
        for i in range(0, len(flat), 3):
            x, q_scale, k_scale = flat[i:i + 3]
            need_x, need_q, need_k = ctx.needs_input_grad[2 + i:5 + i]
            dx = dqs = dks = None
            if need_x or need_q or need_k:
                out = _complete_rows(x, d_rest[0], cols) if d_rest else None
                dx, dqs, dks = qk_norm_split_bwd(x[..., :cols], q_scale, k_scale, ctx.num_heads, dq, dk, dv, offset,
                                                 out, need_q or need_k)
            grads += [dx if need_x else None, dqs.to(q_scale.dtype) if need_q else None,
                      dks.to(k_scale.dtype) if need_k else None]
            offset += x.shape[1]
        return (None, None, *grads)


class MergeHeads(torch.autograd.Function):
    """merge_heads with kernel M' as its backward; saves the mask and the
    gelu input."""

    @staticmethod
    def forward(ctx, x, mask, gelu):
        ctx.save_for_backward(mask, gelu)
        ctx.num_heads = x.shape[1]
        return merge_heads(x, mask, gelu)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        mask, gelu = ctx.saved_tensors
        dx, dg = merge_heads_bwd(dout, ctx.num_heads, mask, gelu, ctx.needs_input_grad[0], ctx.needs_input_grad[2])
        return dx, None, dg


# ----------------------------- the fused route's entry points -----------------------------


def apply_layernorm_modulate(x, shift, scale, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel J; under autograd LayerNormModulate (J forward, J' backward)."""
    if _wants_grad(x, shift, scale):
        return LayerNormModulate.apply(x, shift, scale, out_dtype)
    return layernorm_modulate(x, shift, scale, out_dtype)


def apply_gated_residual(x, gate, y) -> torch.Tensor:
    """Kernel K; under autograd GatedResidual (K forward, K' backward)."""
    if _wants_grad(x, gate, y):
        return GatedResidual.apply(x, gate, y)
    return gated_residual(x, gate, y)


def _split_streams(streams, num_heads: int, qkv_cols: int) -> tuple:
    """Kernel L on each stream's x[..., :qkv_cols], into one joint buffer."""
    first = streams[0][0][..., :qkv_cols]
    out = qkv_buffers(first, num_heads, sum(s[0].shape[1] for s in streams))
    offset = 0
    for x, q_scale, k_scale in streams:
        qk_norm_split(x[..., :qkv_cols], q_scale, k_scale, num_heads, out, offset)
        offset += x.shape[1]
    return out


def _rest_columns(streams, qkv_cols: int):
    """x[..., qkv_cols:] of a single stream wider than qkv_cols, else None."""
    x = streams[0][0]
    if len(streams) == 1 and x.shape[-1] > qkv_cols:
        return x[..., qkv_cols:]
    return None


def apply_qk_norm_split(streams, num_heads: int, qkv_cols: int):
    """Kernel L on each stream (x, q_scale, k_scale) of `streams`: q, k, v
    (B, H, sum L, D), the streams' tokens in order, each from x[...,
    :qkv_cols]; under autograd QKNormSplit (L forward, L' backward). Returns
    (q, k, v, rest): rest the other columns of a single stream wider than
    qkv_cols (the single block's gelu half), else None."""
    flat = [t for s in streams for t in s]
    if _wants_grad(*flat):
        out = QKNormSplit.apply(num_heads, qkv_cols, *flat)
        return tuple(out) if len(out) == 4 else (*out, None)
    return (*_split_streams(streams, num_heads, qkv_cols), _rest_columns(streams, qkv_cols))


def apply_merge_heads(x, mask=None, gelu=None) -> torch.Tensor:
    """Kernel M; under autograd MergeHeads (M forward, M' backward)."""
    if _wants_grad(x, gelu):
        return MergeHeads.apply(x, mask, gelu)
    return merge_heads(x, mask, gelu)
