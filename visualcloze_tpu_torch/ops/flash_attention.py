"""Flash attention of the port: wrappers, plain versions and launch counters
of kernels A (`flash_attn_rope`), C (`flash_attn_d512`), D (`flash_attn_fwd`),
E (`flash_attn_fwd_lse`) and F (`flash_attn_bwd_dq`, `flash_attn_bwd_dkv`),
and the two autograd Functions built on them.

Counterparts of the Pallas kernels in visualcloze_tpu/ops/flash_attention.py:
  - kernel A replaces `flash_mha_rope` (the pipelined `_flash_fwd_pipelined`
    with `_flash_kernel_pipe_rope`, and the blocked `_flash_fwd_rope`): the
    RoPE rotation of q and k on the card (one pass into bf16 scratch), then
    an online-softmax attention kernel with a key-padding bias, D = 128 (a
    warp-specialised Hopper kernel: TMA into an mbarrier ring, wgmma in two
    consumer warpgroups that take turns issuing; deterministic);
  - kernel C replaces `_flash_fwd` as the VAE bottleneck calls it
    (`autoencoder._flash_fwd_only`): one head, D = 512, no bias;
  - kernel D replaces `flash_mha`'s primal (`_flash_fwd_pipelined` without
    RoPE, and `_flash_fwd`): A's attention kernel on pre-rotated q and k;
  - kernel E replaces `_flash_fwd_lse`: D plus the row log-sum-exp in log2
    units, stored compact (B, H, Lq) fp32;
  - kernel F replaces `_pallas_bwd_padded`: dq (F-dq) and dk/dv (F-dkv) from
    q, k, v, bias, dO and the given lse and delta, as two warp-specialised
    Hopper kernels (TMA into an mbarrier ring, wgmma; a CTA per 128 queries,
    resp. 128 keys, so neither needs atomics: deterministic).

The plain versions repeat the kernels' arithmetic in PyTorch: q (rotated in
fp32 for A) scaled by scale * log2(e) and rounded to the input dtype; k
rotated and rounded (A); S in fp32 plus bias * log2(e); a row max floored at
-1e30; P = 2^(S - max) rounded to the input dtype before P @ V; a row with no
key left gives 0 and lse = -1e30. The backward: P = 2^(S - lse), dl = P *
(dO V^T - delta) in fp32, dl and P rounded before dl @ K, dl^T @ q and P^T @
dO (kernels A, D and E take the max online over key tiles, so their P rounds
relative to the running max: the same function up to bf16 rounding).
A wrapper takes its plain version only for a CPU tensor; on a CUDA tensor it
launches the kernel or raises.

Gradients: `flash_mha` is flash_mha's custom VJP (`FlashMHA`: E forward when
a gradient is wanted, else D; backward delta = rowsum(dO * O) in fp32, then
F). `flash_mha_rope` is kernel A without gradients and, under autograd,
`FlashMHARope`: q and k rotated in PyTorch, E, and in the backward F followed
by the inverse rotation (sin -> -sin), as JAX's `_flash_mha_rope_fwd/bwd`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .rope import apply_rope_half

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


def _attend_plain(q32, k, v, bias, dtype):
    """(o, lse) of fp32 q32 (scaled and rounded to `dtype` here) against k, v."""
    d = q32.shape[-1]
    qs = (q32 * (d ** -0.5 * LOG2E)).to(dtype)
    s = torch.matmul(qs.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    if bias is not None:
        s = s + (bias.to(torch.float32) * LOG2E)[:, None, None, :]
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return (o / l).to(dtype), (m + torch.log2(l))[..., 0]


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    cos: torch.Tensor | None = None,
    sin: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernels A (with cos/sin), C and D (without).

    q, k, v: (B, H, L, D); bias: (B, L) fp32 additive key bias or None;
    cos/sin: (B, L, D/2) half-layout RoPE tables or None. Returns q.dtype."""
    q32 = q.to(torch.float32)
    if cos is not None:
        q32 = _rot_half(q32, cos, sin)
        k = _rot_half(k.to(torch.float32), cos, sin).to(k.dtype)
    return _attend_plain(q32, k, v, bias, q.dtype)[0]


def flash_fwd_lse_plain(q, k, v, bias=None):
    """Plain PyTorch version of kernel E: (o in q.dtype, lse (B, H, Lq) fp32
    in log2 units)."""
    return _attend_plain(q.to(torch.float32), k, v, bias, q.dtype)


def _bwd_common_plain(q, k, v, bias, do, lse, delta):
    """p = 2^(s - lse) and dl = p * (dO V^T - delta), both fp32."""
    d = q.shape[-1]
    qs = (q.to(torch.float32) * (d ** -0.5 * LOG2E)).to(q.dtype).to(torch.float32)
    s = torch.matmul(qs, k.to(torch.float32).transpose(-1, -2))
    if bias is not None:
        s = s + (bias.to(torch.float32) * LOG2E)[:, None, None, :]
    p = torch.exp2(s - lse[..., None])
    dp = torch.matmul(do.to(torch.float32), v.to(torch.float32).transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, bias, do, lse, delta):
    """Plain PyTorch version of F-dq: scale * bf16(dl) @ k, in q.dtype."""
    _, dl = _bwd_common_plain(q, k, v, bias, do, lse, delta)
    dq = torch.matmul(dl.to(k.dtype).to(torch.float32), k.to(torch.float32))
    return (dq * q.shape[-1] ** -0.5).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, bias, do, lse, delta):
    """Plain PyTorch version of F-dkv: (scale * bf16(dl)^T @ q, bf16(p)^T @ dO)."""
    p, dl = _bwd_common_plain(q, k, v, bias, do, lse, delta)
    dk = torch.matmul(dl.to(q.dtype).to(torch.float32).transpose(-1, -2), q.to(torch.float32))
    dv = torch.matmul(p.to(do.dtype).to(torch.float32).transpose(-1, -2), do.to(torch.float32))
    return (dk * q.shape[-1] ** -0.5).to(k.dtype), dv.to(v.dtype)


def _ptr(t: torch.Tensor | None):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ROPE_ARGTYPES = [_P] * 9 + [_I] * 3 + [_F, _P]
_D512_ARGTYPES = [_P] * 4 + [_I] * 3 + [_F, _P]
_FWD_ARGTYPES = [_P] * 6 + [_I] * 4 + [_F, _P]
_DQ_ARGTYPES = [_P] * 8 + [_I] * 4 + [_F, _F, _P]
_DKV_ARGTYPES = [_P] * 9 + [_I] * 4 + [_F, _F, _P]


def _check_qkv(name: str, q, k, v, d: int) -> None:
    for t in (q, k, v):
        _require(t.is_cuda, name, "q, k, v must be CUDA tensors")
        _require(t.dtype == torch.bfloat16, name, f"q, k, v must be bfloat16, got {t.dtype}")
        _require(t.is_contiguous(), name, "q, k, v must be contiguous")
        _require(t.shape == q.shape, name, f"q, k, v shapes differ: {q.shape} {t.shape}")
    _require(q.dim() == 4 and q.shape[-1] == d, name, f"expects (B, H, L, {d}), got {tuple(q.shape)}")


def _check_fp32(name: str, what: str, t, shape) -> None:
    _require(t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()
             and tuple(t.shape) == tuple(shape), name, f"{what} must be contiguous fp32 CUDA {tuple(shape)}")


def _check_attn(name: str, q, k, v, bias, do=None, lse=None, delta=None) -> None:
    """q (and do) (B, H, Lq, 128), k, v (B, H, Lk, 128) bf16; bias (B, Lk),
    lse and delta (B, H, Lq) fp32."""
    for t in (q, k, v) + ((do,) if do is not None else ()):
        _require(t.is_cuda, name, "q, k, v, do must be CUDA tensors")
        _require(t.dtype == torch.bfloat16, name, f"q, k, v, do must be bfloat16, got {t.dtype}")
        _require(t.is_contiguous(), name, "q, k, v, do must be contiguous")
        _require(t.dim() == 4 and t.shape[-1] == 128, name, f"expects (B, H, L, 128), got {tuple(t.shape)}")
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    _require(tuple(k.shape) == (b, h, lk, 128) and k.shape == v.shape, name,
             f"k, v must be (B, H, Lk, 128) with q's B, H: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if do is not None:
        _require(do.shape == q.shape, name, f"do must be {tuple(q.shape)}")
    if bias is not None:
        _check_fp32(name, "bias", bias, (b, lk))
    for what, t in (("lse", lse), ("delta", delta)):
        if t is not None:
            _check_fp32(name, what, t, (b, h, lq))


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
        _check_fp32(name, "cos/sin", t, (b, L, d // 2))
    if bias is not None:
        _check_fp32(name, "bias", bias, (b, L))
    o = torch.empty_like(q)
    qr, kr = torch.empty_like(q), torch.empty_like(k)  # scratch: rotated q and k
    kernel = cuda_build.load(name, _ROPE_ARGTYPES)
    status = kernel(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(cos), _ptr(sin), _ptr(qr), _ptr(kr), _ptr(o),
        b, h, L, ctypes.c_float(d ** -0.5 * LOG2E), _stream(),
    )
    cuda_build.check(name, status)
    cuda_build.count_launch(flash_attn_rope)
    return o


flash_attn_rope.launches = 0


def _launch_fwd(name: str, q, k, v, bias, lse):
    _check_attn(name, q, k, v, bias)
    b, h, lq, d = q.shape
    o = torch.empty_like(q)
    kernel = cuda_build.load("flash_attn_fwd", _FWD_ARGTYPES, source="flash_attn_rope")
    status = kernel(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(o), _ptr(lse), b, h, lq, k.shape[2],
        ctypes.c_float(d ** -0.5 * LOG2E), _stream(),
    )
    cuda_build.check(name, status)
    return o


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel D: softmax(scale * q k^T + bias) v on pre-rotated q, k.

    q (B, H, Lq, 128), k, v (B, H, Lk, 128) bf16; bias (B, Lk) fp32 or None."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias)
    o = _launch_fwd("flash_attn_fwd", q, k, v, bias, None)
    cuda_build.count_launch(flash_attn_fwd)
    return o


flash_attn_fwd.launches = 0


def flash_attn_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel E: (o, lse) with lse (B, H, Lq) fp32 in log2 units; shapes as D."""
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v, bias)
    b, h, lq, _ = q.shape
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    o = _launch_fwd("flash_attn_fwd_lse", q, k, v, bias, lse)
    cuda_build.count_launch(flash_attn_fwd_lse)
    return o, lse


flash_attn_fwd_lse.launches = 0


def flash_attn_bwd_dq(q, k, v, bias, do, lse, delta) -> torch.Tensor:
    """Kernel F-dq: dq (B, H, Lq, 128) bf16. q, do (B, H, Lq, 128), k, v
    (B, H, Lk, 128) bf16; bias (B, Lk) fp32 or None; lse, delta (B, H, Lq) fp32."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, bias, do, lse, delta)
    name = "flash_attn_bwd_dq"
    _check_attn(name, q, k, v, bias, do, lse, delta)
    b, h, lq, d = q.shape
    dq = torch.empty_like(q)
    kernel = cuda_build.load(name, _DQ_ARGTYPES, source="flash_attn_bwd")
    status = kernel(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq),
        b, h, lq, k.shape[2], ctypes.c_float(d ** -0.5 * LOG2E), ctypes.c_float(d ** -0.5), _stream(),
    )
    cuda_build.check(name, status)
    cuda_build.count_launch(flash_attn_bwd_dq)
    return dq


flash_attn_bwd_dq.launches = 0


def flash_attn_bwd_dkv(q, k, v, bias, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel F-dkv: (dk, dv), each (B, H, Lk, 128) bf16; inputs as F-dq."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, bias, do, lse, delta)
    name = "flash_attn_bwd_dkv"
    _check_attn(name, q, k, v, bias, do, lse, delta)
    b, h, lq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kernel = cuda_build.load(name, _DKV_ARGTYPES, source="flash_attn_bwd")
    status = kernel(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv),
        b, h, lq, k.shape[2], ctypes.c_float(d ** -0.5 * LOG2E), ctypes.c_float(d ** -0.5), _stream(),
    )
    cuda_build.check(name, status)
    cuda_build.count_launch(flash_attn_bwd_dkv)
    return dk, dv


flash_attn_bwd_dkv.launches = 0


def _flash_bwd(q, k, v, bias, o, lse, do):
    """delta = rowsum(dO * O) in fp32 (XLA's part in JAX), then F-dq and F-dkv."""
    do = do.contiguous()
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
    dq = flash_attn_bwd_dq(q, k, v, bias, do, lse, delta)
    dk, dv = flash_attn_bwd_dkv(q, k, v, bias, do, lse, delta)
    return dq, dk, dv


def chunk_bwd(q, k, v, bias, do, lse, delta):
    """The ring's chunk backward (JAX `chunk_bwd_pallas`): partial (dq, dk,
    dv) of one (query shard, key chunk) pair through F-dq and F-dkv, in the
    inputs' dtype. Unpadded q, do (B, H, Lq, D), k, v (B, H, Lk, D); bias
    (B, Lk) fp32 or None; lse (B, H, Lq) the GLOBAL log-sum-exp in log2
    units, delta (B, H, Lq) fp32 rowsum(dO * O_final). On CPU tensors the
    plain versions."""
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    lse, delta = lse.to(torch.float32).contiguous(), delta.to(torch.float32).contiguous()
    dq = flash_attn_bwd_dq(q, k, v, bias, do, lse, delta)
    dk, dv = flash_attn_bwd_dkv(q, k, v, bias, do, lse, delta)
    return dq, dk, dv


class FlashMHA(torch.autograd.Function):
    """flash_mha's custom VJP: kernel E forward saving (q, k, v, bias, o,
    lse), kernel F backward."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attn_fwd_lse(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, bias, o, lse, do)
        return dq, dk, dv, None


class FlashMHARope(torch.autograd.Function):
    """flash_mha_rope's custom VJP: q, k rotated (half layout) and rounded in
    PyTorch, kernel E; backward kernel F, then d(unrotated) = R^T d(rotated),
    the inverse rotation."""

    @staticmethod
    def forward(ctx, q, k, v, bias, cos, sin):
        c, s = cos[:, None], sin[:, None]
        qr = apply_rope_half(q, c, s).contiguous()
        kr = apply_rope_half(k, c, s).contiguous()
        v = v.contiguous()
        o, lse = flash_attn_fwd_lse(qr, kr, v, bias)
        ctx.save_for_backward(qr, kr, v, bias, o, lse, cos, sin)
        return o

    @staticmethod
    def backward(ctx, do):
        qr, kr, v, bias, o, lse, cos, sin = ctx.saved_tensors
        dq_r, dk_r, dv = _flash_bwd(qr, kr, v, bias, o, lse, do)
        c, s = cos[:, None], -sin[:, None]
        return apply_rope_half(dq_r, c, s), apply_rope_half(dk_r, c, s), dv, None, None, None


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_mha(q, k, v, bias=None):
    """Flash attention on pre-rotated q, k (B, H, L, D), bias (B, Lk) fp32 or
    None: kernel D, or under autograd kernels E and F."""
    if _wants_grad(q, k, v):
        return FlashMHA.apply(q, k, v, bias)
    return flash_attn_fwd(q.contiguous(), k.contiguous(), v.contiguous(), bias)


def flash_mha_rope(q, k, v, bias, cos, sin):
    """RoPE-fused flash attention on unrotated, half-layout q, k: kernel A, or
    under autograd the rotation in PyTorch and kernels E and F."""
    if _wants_grad(q, k, v):
        return FlashMHARope.apply(q, k, v, bias, cos, sin)
    return flash_attn_rope(q.contiguous(), k.contiguous(), v.contiguous(), bias,
                           cos.contiguous(), sin.contiguous())


def flash_attn_d512(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel C: softmax(q k^T / sqrt(512)) v for (B, H, L, 512) bf16, no bias."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    name = "flash_attn_d512"
    _check_qkv(name, q, k, v, 512)
    b, h, L, d = q.shape
    o = torch.empty_like(q)
    kernel = cuda_build.load(name, _D512_ARGTYPES)
    status = kernel(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), b, h, L, ctypes.c_float(d ** -0.5 * LOG2E), _stream(),
    )
    cuda_build.check(name, status)
    cuda_build.count_launch(flash_attn_d512)
    return o


flash_attn_d512.launches = 0
