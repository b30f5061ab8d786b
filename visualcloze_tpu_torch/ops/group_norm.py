"""The VAE's GroupNorm: wrappers, plain versions and launch counters of
kernel N (csrc/group_norm.cu), `group_norm_stats` and `group_norm_apply`.

Counterparts of XLA fusions, not of a Pallas kernel:
visualcloze_tpu/models/autoencoder.py `group_norm_affine` (:37), GroupNorm
collapsed to a per-(batch, channel) fp32 affine y = x * a + bb, and
`group_norm` (:61) with `swish` (:68) after it where no conv takes the
affine (the attention block's norm and the two norm_outs).

group_norm_stats keeps JAX's order: per-channel means over (H, W), their
group means, then per-channel means of (x - group mean)^2 and their group
means, rsqrt(var + eps), a = rsig * scale, bb = bias - mu * a, all in fp32
(two passes over x, no Welford). group_norm_apply rounds h = x * a + bb to
x's dtype and, with act "swish", computes h * sigmoid(h) on that value as
JAX's bf16 swish does (both roundings kept). The plain versions are this
arithmetic in PyTorch; a wrapper takes its plain version only for a CPU
tensor, and on a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

MAX_C = 2048  # csrc/group_norm.cu: C / 8 threads a pixel, at most 256
STATS_CTA_BYTES = 64 << 10  # x's bytes a statistics CTA streams, at least (fewer rows for the last CTA to sum)
APPLY_CTA_BYTES = 32 << 10


def group_norm_stats_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                           eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of group_norm_stats: (a, bb), each (B, C) fp32."""
    b, h, w, c = x.shape
    cg = c // groups
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=(1, 2)).reshape(b, groups, cg).mean(-1)
    mu_c = mu.repeat_interleave(cg, dim=-1)
    var_c = (x32 - mu_c[:, None, None, :]).square().mean(dim=(1, 2))
    var = var_c.reshape(b, groups, cg).mean(-1)
    rsig_c = torch.rsqrt(var + eps).repeat_interleave(cg, dim=-1)
    a = rsig_c * scale.to(torch.float32)[None]
    bb = bias.to(torch.float32)[None] - mu_c * a
    return a, bb


def group_norm_apply_plain(x: torch.Tensor, a: torch.Tensor, bb: torch.Tensor, act: str = "none") -> torch.Tensor:
    """Plain version of group_norm_apply: x * a + bb rounded to x.dtype, then
    (act "swish") h * sigmoid(h) in x.dtype."""
    h = (x.to(torch.float32) * a[:, None, None, :] + bb[:, None, None, :]).to(x.dtype)
    return h * torch.sigmoid(h) if act == "swish" else h


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(x: torch.Tensor, cta_bytes: int, per_sm: int) -> int:
    """CTAs a batch element: enough that each streams about cta_bytes of x,
    at most per_sm an SM over the batch, at most one a pixel lane group."""
    b, h, w, c = x.shape
    lanes = max(1, 256 // (c // 8))
    want = -(-h * w * c * x.element_size() // cta_bytes)
    cap = max(1, per_sm * _sms(x.device.index or 0) // b)
    return max(1, min(want, cap, -(-h * w // lanes), 65535))


def _check(name: str, x: torch.Tensor, groups: int | None = None) -> None:
    if not (x.is_cuda and x.dtype == torch.bfloat16):
        raise ValueError(f"{name}: x must be a bfloat16 CUDA tensor, got {x.dtype} on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{name}: expects x (B, H, W, C), got {tuple(x.shape)}")
    c = x.shape[3]
    if c % 8 or c > MAX_C:
        raise ValueError(f"{name}: C={c} must be a multiple of 8 and at most {MAX_C}")
    if groups is not None and (c < 32 or groups <= 0 or c % groups):
        raise ValueError(f"{name}: groups={groups} must divide C={c}, and C must be at least 32 (the tiny "
                         "configs' min(32, C) clamp runs on the CPU only)")


def _vector(name: str, what: str, t: torch.Tensor, shape: tuple, device, keep_bf16: bool = False) -> torch.Tensor:
    """t on `device`, contiguous, fp32 (bf16 kept where keep_bf16: the kernel
    reads the VAE's bf16 parameters itself, with no cast launched)."""
    dtype = torch.bfloat16 if keep_bf16 and t.dtype == torch.bfloat16 else torch.float32
    t = t.to(device=device, dtype=dtype).contiguous()
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: {what} must be {shape}, got {tuple(t.shape)}")
    return t


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


_STATS_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
_APPLY_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def group_norm_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                     eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel N's statistics. x: (B, H, W, C) bf16 NHWC; scale, bias: (C,).
    Returns (a, bb), each (B, C) fp32: GroupNorm as y = x * a + bb. On CUDA
    C is a multiple of 8 in [32, 2048] and groups divides it."""
    if x.device.type == "cpu":
        return group_norm_stats_plain(x, scale, bias, groups, eps)
    name = "group_norm_stats"
    _check(name, x, groups)
    b, h, w, c = x.shape
    x = x.contiguous()
    params_bf16 = scale.dtype == bias.dtype == torch.bfloat16
    scale = _vector(name, "scale", scale, (c,), x.device, params_bf16)
    bias = _vector(name, "bias", bias, (c,), x.device, params_bf16)
    nblk = _blocks(x, STATS_CTA_BYTES, 2)
    out = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    # scratch: mu (B, C), the CTAs' partial sums (B, nblk, C), the tickets (B,) as uint32
    scratch = torch.empty(b * c * (nblk + 1) + b, dtype=torch.float32, device=x.device)
    mu, partial, ticket = scratch[:b * c], scratch[b * c:b * c * (nblk + 1)], scratch[b * c * (nblk + 1):]
    kernel = cuda_build.load(name, _STATS_ARGTYPES, source="group_norm")
    status = kernel(_ptr(x), _ptr(scale), _ptr(bias), int(params_bf16), _ptr(out[0]), _ptr(out[1]), _ptr(mu),
                    _ptr(partial), _ptr(ticket), b, h * w, c, groups, nblk, ctypes.c_float(eps),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    cuda_build.check(name, status)
    cuda_build.count_launch(group_norm_stats)
    return out[0], out[1]


group_norm_stats.launches = 0


def group_norm_apply(x: torch.Tensor, a: torch.Tensor, bb: torch.Tensor, act: str = "none") -> torch.Tensor:
    """Kernel N's apply: act(bf16(x * a + bb)), act "none" or "swish". x: (B,
    H, W, C) bf16; a, bb: (B, C) fp32 (group_norm_stats). Returns x's shape
    and dtype."""
    if act not in ("none", "swish"):
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return group_norm_apply_plain(x, a, bb, act)
    name = "group_norm_apply"
    _check(name, x)
    b, h, w, c = x.shape
    x = x.contiguous()
    a = _vector(name, "a", a, (b, c), x.device)
    bb = _vector(name, "bb", bb, (b, c), x.device)
    y = torch.empty_like(x)
    kernel = cuda_build.load(name, _APPLY_ARGTYPES, source="group_norm")
    status = kernel(_ptr(x), _ptr(a), _ptr(bb), _ptr(y), b, h * w, c, int(act == "swish"),
                    _blocks(x, APPLY_CTA_BYTES, 4), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    cuda_build.check(name, status)
    cuda_build.count_launch(group_norm_apply)
    return y


group_norm_apply.launches = 0
