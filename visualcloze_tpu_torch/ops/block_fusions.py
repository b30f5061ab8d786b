"""The DiT blocks' fused passes: wrappers, plain versions and launch counters
of kernels J (`layernorm_modulate`, csrc/layernorm_modulate.cu), K
(`gated_residual`, csrc/gated_residual.cu), L (`qk_norm_split`,
csrc/qk_norm_split.cu) and M (`merge_heads`, csrc/merge_heads.cu).

No Pallas kernel stands behind them: XLA fuses each of these chains inside
the JAX package's `double_block` and `single_block`
(visualcloze_tpu/models/layers.py), where eager PyTorch runs them as many
fp32 passes over the token axis:
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

Each plain version is the blocks' former PyTorch code. A wrapper takes its
plain version only for a CPU tensor; on a CUDA tensor it launches the kernel
or raises. They have no backward: the blocks call them on the no-grad
forward only (models/layers.py), and keep the plain versions under autograd
and in calibration.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

BF16 = torch.bfloat16
VEC = 8  # elements a thread loads at once: 16 bytes of bf16
MAX_ROW = 8 * 1024  # J's row: one 8-element vector a thread, 1024 threads

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_J_ARGTYPES = [_P, _LL, _LL, _P, _LL, _P, _LL, _P, _I, _I, _I, _I, _P]
_K_ARGTYPES = [_P, _P, _P, _LL, _P, _I, _I, _I, _P]
_L_ARGTYPES = [_P, _LL, _LL, _P, _P, _P, _P, _P] + [_I] * 6 + [_P]
_M_ARGTYPES = [_P, _P, _P, _LL, _LL, _P] + [_I] * 6 + [_P]


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm in fp32 (returns fp32)."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps)


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
