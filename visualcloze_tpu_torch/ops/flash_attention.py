"""Flash-attention forwards: wrappers, plain versions and launch counters of
kernels A (`flash_attn_rope`) and C (`flash_attn_d512`).

Counterparts of the Pallas kernels in visualcloze_tpu/ops/flash_attention.py:
  - kernel A replaces `flash_mha_rope` (the pipelined `_flash_fwd_pipelined`
    with `_flash_kernel_pipe_rope`, and the blocked `_flash_fwd_rope`): the
    RoPE rotation of q and k on the card (one pass into bf16 scratch), then
    an online-softmax attention kernel with a key-padding bias, D = 128;
  - kernel C replaces `_flash_fwd` as the VAE bottleneck calls it
    (`autoencoder._flash_fwd_only`): one head, D = 512, no bias.

The plain versions repeat the kernels' arithmetic in PyTorch: q rotated in
fp32, scaled by scale * log2(e) and rounded to the input dtype; k rotated and
rounded; S in fp32 plus bias * log2(e); a row max floored at -1e30; P = 2^(S -
max) rounded to the input dtype before P @ V; a row with no key left gives 0.
(Kernel A takes the max online over key tiles, so its P rounds relative to
the running max: the same function up to bf16 rounding.)
A wrapper takes its plain version only for a CPU tensor; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _rot_half(x32: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """rot(x) = cf * x + sf * swap_halves(x), cf = [cos|cos], sf = [-sin|sin];
    x32 (B, H, L, D) fp32, cos/sin (B, L, D/2)."""
    cf = torch.cat([cos, cos], dim=-1)[:, None].to(torch.float32)
    sf = torch.cat([-sin, sin], dim=-1)[:, None].to(torch.float32)
    d2 = x32.shape[-1] // 2
    swapped = torch.cat([x32[..., d2:], x32[..., :d2]], dim=-1)
    return cf * x32 + sf * swapped


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    cos: torch.Tensor | None = None,
    sin: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernels A (with cos/sin) and C (without).

    q, k, v: (B, H, L, D); bias: (B, L) fp32 additive key bias or None;
    cos/sin: (B, L, D/2) half-layout RoPE tables or None. Returns q.dtype."""
    d = q.shape[-1]
    q32 = q.to(torch.float32)
    if cos is not None:
        q32 = _rot_half(q32, cos, sin)
        k = _rot_half(k.to(torch.float32), cos, sin).to(k.dtype)
    qs = (q32 * (d ** -0.5 * LOG2E)).to(q.dtype)
    s = torch.matmul(qs.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    if bias is not None:
        s = s + (bias.to(torch.float32) * LOG2E)[:, None, None, :]
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return (o / l).to(q.dtype)


def _ptr(t: torch.Tensor | None):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


_ROPE_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
_D512_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def _check_qkv(name: str, q, k, v, d: int) -> None:
    for t in (q, k, v):
        _require(t.is_cuda, name, "q, k, v must be CUDA tensors")
        _require(t.dtype == torch.bfloat16, name, f"q, k, v must be bfloat16, got {t.dtype}")
        _require(t.is_contiguous(), name, "q, k, v must be contiguous")
        _require(t.shape == q.shape, name, f"q, k, v shapes differ: {q.shape} {t.shape}")
    _require(q.dim() == 4 and q.shape[-1] == d, name, f"expects (B, H, L, {d}), got {tuple(q.shape)}")


def flash_attn_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None,
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> torch.Tensor:
    """Kernel A: softmax(scale * rot(q) rot(k)^T + bias) v, non-causal.

    q, k, v: (B, H, L, 128) bf16, unrotated, half RoPE layout; bias: (B, L)
    fp32 (0 / -1e30) or None; cos/sin: (B, L, 64) fp32 embed_nd tables."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, cos, sin)
    name = "flash_attn_rope"
    _check_qkv(name, q, k, v, 128)
    b, h, L, d = q.shape
    for t in (cos, sin):
        _require(t.is_cuda and t.dtype == torch.float32 and t.is_contiguous(), name,
                 "cos/sin must be contiguous fp32 CUDA tensors")
        _require(tuple(t.shape) == (b, L, d // 2), name, f"cos/sin must be {(b, L, d // 2)}")
    if bias is not None:
        _require(bias.is_cuda and bias.dtype == torch.float32 and bias.is_contiguous()
                 and tuple(bias.shape) == (b, L), name, f"bias must be contiguous fp32 {(b, L)}")
    o = torch.empty_like(q)
    qr, kr = torch.empty_like(q), torch.empty_like(k)  # scratch: rotated q and k
    lib = cuda_build.load(name, _ROPE_ARGTYPES)
    status = lib.flash_attn_rope(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(cos), _ptr(sin), _ptr(qr), _ptr(kr), _ptr(o),
        b, h, L, ctypes.c_float(d ** -0.5 * LOG2E), _stream(),
    )
    cuda_build.check(name, status)
    flash_attn_rope.launches += 1
    return o


flash_attn_rope.launches = 0


def flash_attn_d512(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel C: softmax(q k^T / sqrt(512)) v for (B, H, L, 512) bf16, no bias."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    name = "flash_attn_d512"
    _check_qkv(name, q, k, v, 512)
    b, h, L, d = q.shape
    o = torch.empty_like(q)
    lib = cuda_build.load(name, _D512_ARGTYPES)
    status = lib.flash_attn_d512(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), b, h, L, ctypes.c_float(d ** -0.5 * LOG2E), _stream(),
    )
    cuda_build.check(name, status)
    flash_attn_d512.launches += 1
    return o


flash_attn_d512.launches = 0
