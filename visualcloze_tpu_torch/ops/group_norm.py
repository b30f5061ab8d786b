"""The VAE's GroupNorm: wrappers, plain versions and launch counters of
kernel N (csrc/group_norm.cu), `group_norm_stats`, `group_norm_apply` and
`group_norm`, both in one launch where the statistics' cluster design holds
the slab.

Counterparts of XLA fusions, not of a Pallas kernel:
visualcloze_tpu/models/autoencoder.py `group_norm_affine` (:37), GroupNorm
collapsed to a per-(batch, channel) fp32 affine y = x * a + bb, and
`group_norm` (:61) with `swish` (:68) after it where no conv takes the
affine (the attention block's norm and the two norm_outs).

group_norm_stats gives JAX's statistics: per-channel means over (H, W),
their group means, the group variance about the group mean, rsqrt(var +
eps), a = rsig * scale, bb = bias - mu * a, all in fp32. stats_plan picks
one of its two designs from the shape and the card: one launch of a
thread-block cluster holding a group block's slab in shared memory, or one
launch that reads x once and pools tile-centred moments (the plain version
keeps JAX's two passes; the kernel's order is stable in the same way, see
csrc/group_norm.cu). group_norm_apply rounds h = x * a + bb to
x's dtype and, with act "swish", computes h * sigmoid(h) on that value as
JAX's bf16 swish does (both roundings kept; on the card sigmoid is one
ex2.approx and one rcp.approx, within one bf16 ulp of the plain version at
every bf16 h). group_norm is JAX's `group_norm` (+ `swish`): where
stats_plan picks the cluster design, one launch that normalises the slab
the statistics hold in shared memory (the same bits as the two launches),
elsewhere group_norm_stats then group_norm_apply. The plain versions are
this arithmetic in PyTorch; a wrapper takes its plain version only for a
CPU tensor, and on a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading

import torch

from . import cuda_build

MAX_C = 2048  # csrc/group_norm.cu: C / 8 threads a pixel, at most 256
APPLY_CTA_BYTES = 32 << 10
# the statistics' cluster design (csrc/group_norm.cu group_norm_stats_cluster)
CLUSTER_WARPS = 16  # 512 threads a CTA
MAX_CLUSTER = 8  # CTAs a cluster, the portable limit
MAX_BLOCK_CHUNKS = 32  # 16-byte channel chunks of a group block, a power of two: a warp's lanes
ROW_BYTES = 128  # a group block's bytes a pixel, at most where a choice is left: one L2 line a request
MIN_ROW_BYTES = 32  # a narrower row takes half of every 32-byte sector the L2 serves
CLUSTER_MAX_BYTES = 30 << 20  # x's bytes, at most, where the cluster design beats the moments design (PERF.md)
# the statistics' moments design (csrc/group_norm.cu group_norm_stats_moments)
MOMENTS_CONSUMERS = 256  # consumer threads a CTA: (C / 8) x P hold a tile's vectors
MOMENTS_VECS = 8  # a consumer's 16-byte vectors a tile
MOMENTS_STAGE_BYTES = MOMENTS_VECS * MOMENTS_CONSUMERS * 16  # a ring stage: 32 KB
MOMENTS_STAGES = 2  # stages a CTA, one CTA an SM: the fastest of 2, 3, 4, 6 (PERF.md)
MOMENTS_MAX_STAGES = 6
MOMENTS_SLOTS = 256  # ticket slots of the library: one a stream (torch pools 32 streams a priority)
MOMENTS_SLOT_TICKETS = 4096
MOMENTS_PARAM_BYTES = 2 * MAX_C * 4  # the kernel's static shared memory: scale and bias in fp32


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


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float = 1e-6,
                     act: str = "none") -> torch.Tensor:
    """Plain version of group_norm: the plain statistics, then the plain apply."""
    return group_norm_apply_plain(x, *group_norm_stats_plain(x, scale, bias, groups, eps), act)


@dataclasses.dataclass(frozen=True)
class StatsPlan:
    """How kernel N takes the statistics of one shape on one card.

    design "cluster": one launch; a cluster of `cluster` CTAs per batch
    element and group block of `block_groups` neighbouring groups, each CTA
    holding `per` pixels of the block's channels in `cta_bytes` of shared
    memory. design "moments": one launch of `ctas` CTAs per batch element,
    each streaming `per` pixels of all channels through a ring of `stages`
    stages (`cta_bytes` of shared memory), its row of partial moments
    merged by teams of `team` CTAs, then by the last team."""

    design: str
    cluster: int
    block_groups: int
    ctas: int  # CTAs per batch element
    per: int  # pixels a CTA
    cta_bytes: int
    stages: int = 0
    team: int = 0


def cluster_smem(per: int, block_channels: int) -> int:
    """The cluster design's shared memory a CTA: the slab (per pixels x the
    block's channels, bf16), then its fp32 sums (CLUSTER_WARPS + 4 rows)."""
    return per * block_channels * 2 + (CLUSTER_WARPS + 4) * block_channels * 4


def moments_tile(c: int) -> int:
    """The moments design's tile in pixels: 8 pixels of each of the P =
    256 // (C / 8) lanes of consumer threads."""
    return MOMENTS_VECS * (MOMENTS_CONSUMERS // (c // 8))


def moments_row_floats(c: int, groups: int) -> int:
    """The floats of a row of partial moments (C channel sums, G group
    means, G moments), padded to 16 bytes."""
    return -(-(c + 2 * groups) // 4) * 4


def moments_scratch(c: int, groups: int, rows: int) -> int:
    """The moments design's shared memory a CTA uses past its ring's use
    (csrc/group_norm.cu moments_scratch): its own merge of its threads'
    pieces, or a merge of `rows` rows."""
    p, w = MOMENTS_CONSUMERS // (c // 8), math.gcd(c // groups, 8)
    own = p * c + 2 * p * (c // w) + p + c + 2 * groups
    return 4 * max(own, rows * moments_row_floats(c, groups) + c + 2 * groups)


def moments_plan(b: int, hw: int, c: int, groups: int, sms: int, ctas: int | None = None,
                 stages: int = MOMENTS_STAGES) -> StatsPlan:
    """The moments design for x (b, hw pixels, c) on a card of `sms` SMs:
    `ctas` CTAs a batch element (default: one an SM over the batch), each a
    run of whole tiles, the runs as even as whole tiles allow and none
    empty; teams of ceil(sqrt(CTAs)); at least `stages` ring stages, more
    where a merge's rows need the room."""
    tp = moments_tile(c)
    tiles = -(-hw // tp)
    want = max(1, min(tiles, ctas or sms // b or 1))
    per_tiles = -(-tiles // want)
    n = -(-tiles // per_tiles)
    team = math.isqrt(n - 1) + 1
    stages = max(stages, -(-moments_scratch(c, groups, max(team, -(-n // team))) // MOMENTS_STAGE_BYTES))
    if stages > MOMENTS_MAX_STAGES:
        raise ValueError(f"kernel N's moments design: a merge of C={c}, groups={groups} rows needs {stages} stages "
                         f"of shared memory, at most {MOMENTS_MAX_STAGES}")
    return StatsPlan("moments", 1, groups, n, per_tiles * tp, stages * MOMENTS_STAGE_BYTES, stages, team)


def cluster_plan(b: int, h: int, w: int, c: int, groups: int, smem_per_cta: int) -> StatsPlan | None:
    """The cluster design for x (b, h, w, c) on a card of `smem_per_cta`
    bytes of shared memory a CTA, or None where no cluster holds a group
    block's slab in rows of MIN_ROW_BYTES or more.

    Its loads fetch one row of the block a pixel, so the L2 serves a request
    for each row: the block is the widest run of neighbouring groups up to
    ROW_BYTES a pixel (8 K channels, K a power of two) whose slab fits
    MAX_CLUSTER CTAs; the cluster then halves while a CTA's share stays
    within half a CTA's shared memory (two CTAs an SM)."""
    hw, cg = h * w, c // groups

    def cta_bytes(bg: int, cluster: int) -> int:
        return cluster_smem(-(-hw // cluster), bg * cg)

    fits = [bg for bg in range(1, groups + 1)
            if groups % bg == 0 and bg * cg % 8 == 0 and (bg * cg // 8) & (bg * cg // 8 - 1) == 0
            and bg * cg // 8 <= MAX_BLOCK_CHUNKS and cta_bytes(bg, MAX_CLUSTER) <= smem_per_cta]
    narrow = [bg for bg in fits if bg * cg * 2 <= ROW_BYTES]
    bg = max(narrow) if narrow else min(fits, default=0)
    if not bg or bg * cg * 2 < MIN_ROW_BYTES:
        return None
    cluster = MAX_CLUSTER
    while cluster > 1 and cta_bytes(bg, cluster // 2) <= smem_per_cta // 2:
        cluster //= 2
    return StatsPlan("cluster", cluster, bg, groups // bg * cluster, -(-hw // cluster), cta_bytes(bg, cluster))


def stats_plan(b: int, h: int, w: int, c: int, groups: int, sms: int, smem_per_cta: int,
               l2_bytes: int) -> StatsPlan:
    """The design kernel N's statistics take for x (b, h, w, c) bf16 on a
    card of `sms` SMs, `smem_per_cta` bytes of shared memory a CTA and an
    L2 of `l2_bytes`.

    The moments design reads x once, one CTA an SM. Its fixed cost (a
    launch, the ring's first tiles, two merges of partial rows after
    tickets) loses to the cluster design (cluster_plan) only on small x:
    at most CLUSTER_MAX_BYTES, in L2, where a cluster holds the slab. The
    constant is measured (scripts/group_norm_plans.py)."""
    if b * h * w * c * 2 <= min(CLUSTER_MAX_BYTES, l2_bytes):
        plan = cluster_plan(b, h, w, c, groups, smem_per_cta)
        if plan is not None:
            return plan
    plan = moments_plan(b, h * w, c, groups, sms)
    if plan.cta_bytes + MOMENTS_PARAM_BYTES > smem_per_cta:
        raise ValueError(f"kernel N's moments design needs {plan.cta_bytes + MOMENTS_PARAM_BYTES} bytes of shared "
                         f"memory a CTA; the card gives {smem_per_cta}")
    return plan


def _apply_ctas(b: int, hw: int, c: int, cta_bytes: int, max_ctas: int) -> int:
    """The apply kernel's CTAs a batch element: enough that each streams
    about cta_bytes of bf16 x, at most max_ctas over the batch, at most one
    a pixel lane group."""
    lanes = max(1, 256 // (c // 8))
    return max(1, min(-(-hw * c * 2 // cta_bytes), max(1, max_ctas // b), -(-hw // lanes), 65535))


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple[int, int, int]:
    """(SMs, shared memory a CTA may opt in to, L2 bytes) of CUDA device
    `index`: the card's inputs of stats_plan."""
    out = [ctypes.c_int() for _ in range(3)]
    query = cuda_build.load("group_norm_device_limits", [ctypes.c_int] + [ctypes.c_void_p] * 3, source="group_norm")
    cuda_build.check("group_norm_device_limits", query(index, *map(ctypes.byref, out)))
    return tuple(v.value for v in out)


def cluster_occupancy(h: int, w: int, c: int, groups: int, plan: StatsPlan) -> int:
    """How many clusters of a cluster-design plan the current card runs at
    once (cudaOccupancyMaxActiveClusters): the plan's waves are its clusters
    over this."""
    fn = cuda_build.load("group_norm_cluster_occupancy", [ctypes.c_int] * 5, source="group_norm")
    n = fn(h * w, c, groups, plan.block_groups, plan.cluster)
    cuda_build.check("group_norm_cluster_occupancy", max(0, -n))
    return n


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


_MOMENTS_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                     + [ctypes.c_float, ctypes.c_void_p])
_CLUSTER_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_void_p])
_FUSED_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
_APPLY_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def group_norm_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                     eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel N's statistics. x: (B, H, W, C) bf16 NHWC; scale, bias: (C,).
    Returns (a, bb), each (B, C) fp32: GroupNorm as y = x * a + bb. On CUDA
    C is a multiple of 8 in [32, 2048] and groups divides it; stats_plan
    picks the design (one launch either way: a cluster kernel, or the
    moments kernel with its scratch)."""
    if x.device.type == "cpu":
        return group_norm_stats_plain(x, scale, bias, groups, eps)
    name = "group_norm_stats"
    _check(name, x, groups)
    b, h, w, c = x.shape
    x = x.contiguous()
    params_bf16 = scale.dtype == bias.dtype == torch.bfloat16
    scale = _vector(name, "scale", scale, (c,), x.device, params_bf16)
    bias = _vector(name, "bias", bias, (c,), x.device, params_bf16)
    plan = stats_plan(b, h, w, c, groups, *device_limits(x.device.index or 0))
    a, bb = launch_stats_plan(x, scale, bias, groups, eps, plan)
    cuda_build.count_launch(group_norm_stats)
    return a, bb


_SLOTS: dict = {}  # (device, stream) -> the moments design's ticket slot
_SLOT_LOCK = threading.Lock()


def _ticket_slot(device: torch.device, stream: int) -> int:
    """The slot of the library's tickets that launches on `stream` use: one
    a stream, so that launches on two streams at once never share a ticket
    (launches on one stream run in order)."""
    with _SLOT_LOCK:
        key = (device.index or 0, stream)
        if key not in _SLOTS:
            taken = sum(1 for k in _SLOTS if k[0] == key[0])
            if taken >= MOMENTS_SLOTS:
                raise RuntimeError(f"group_norm_stats: kernel N's moments design serves at most {MOMENTS_SLOTS} "
                                   "CUDA streams a device")
            _SLOTS[key] = taken
        return _SLOTS[key]


def launch_stats_plan(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
                      plan: StatsPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel N's statistics by `plan` on x, scale and bias as
    group_norm_stats passes them (checked, contiguous, on x's device); no
    launch counted. group_norm_stats runs stats_plan's plan;
    scripts/group_norm_plans.py times others."""
    name = "group_norm_stats"
    b, h, w, c = x.shape
    params_bf16 = scale.dtype == bias.dtype == torch.bfloat16
    out = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    if plan.design == "cluster":
        kernel = cuda_build.load("group_norm_stats_cluster", _CLUSTER_ARGTYPES, source="group_norm")
        status = kernel(_ptr(x), _ptr(scale), _ptr(bias), int(params_bf16), _ptr(out[0]), _ptr(out[1]), b, h * w,
                        c, groups, plan.block_groups, plan.cluster, ctypes.c_float(eps), ctypes.c_void_p(stream))
    else:
        teams = -(-plan.ctas // plan.team)
        if b * (teams + 1) > MOMENTS_SLOT_TICKETS:
            raise ValueError(f"{name}: batch {b} needs {b * (teams + 1)} tickets, the library has "
                             f"{MOMENTS_SLOT_TICKETS} a stream")
        # scratch: a row (C channel sums, G group means, G moments) per CTA, then per team
        scratch = torch.empty((b * (plan.ctas + teams), moments_row_floats(c, groups)), dtype=torch.float32,
                              device=x.device)
        kernel = cuda_build.load("group_norm_stats_moments", _MOMENTS_ARGTYPES, source="group_norm")
        status = kernel(_ptr(x), _ptr(scale), _ptr(bias), int(params_bf16), _ptr(out[0]), _ptr(out[1]),
                        _ptr(scratch), _ticket_slot(x.device, stream), b, h * w, c, groups, plan.ctas, plan.per,
                        plan.team, plan.stages, ctypes.c_float(eps), ctypes.c_void_p(stream))
    cuda_build.check(name, status)
    return out[0], out[1]


group_norm_stats.launches = 0


def group_norm_apply(x: torch.Tensor, a: torch.Tensor, bb: torch.Tensor, act: str = "none") -> torch.Tensor:
    """Kernel N's apply: act(bf16(x * a + bb)), act "none" or "swish". x: (B,
    H, W, C) bf16; a, bb: (B, C) fp32 (group_norm_stats). Returns x's shape
    and dtype."""
    _act(act)
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
    nblk = _apply_ctas(b, h * w, c, APPLY_CTA_BYTES, 4 * device_limits(x.device.index or 0)[0])
    status = kernel(_ptr(x), _ptr(a), _ptr(bb), _ptr(y), b, h * w, c, int(act == "swish"), nblk,
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    cuda_build.check(name, status)
    cuda_build.count_launch(group_norm_apply)
    return y


group_norm_apply.launches = 0


def _act(act: str) -> None:
    if act not in ("none", "swish"):
        raise ValueError(f"unknown act {act!r}")


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float = 1e-6,
               act: str = "none") -> torch.Tensor:
    """Kernel N's GroupNorm, then act ("none" or "swish"): JAX's `group_norm`
    (+ `swish`). x: (B, H, W, C) bf16 NHWC; scale, bias: (C,). Returns x's
    shape and dtype. On CUDA, where stats_plan picks the cluster design, one
    launch (counted here) that takes the statistics and normalises the slab
    it holds; elsewhere group_norm_stats, then group_norm_apply (counted
    there)."""
    _act(act)
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, groups, eps, act)
    name = "group_norm"
    _check(name, x, groups)
    b, h, w, c = x.shape
    plan = stats_plan(b, h, w, c, groups, *device_limits(x.device.index or 0))
    if plan.design != "cluster":
        return group_norm_apply(x, *group_norm_stats(x, scale, bias, groups, eps), act)
    x = x.contiguous()
    params_bf16 = scale.dtype == bias.dtype == torch.bfloat16
    scale = _vector(name, "scale", scale, (c,), x.device, params_bf16)
    bias = _vector(name, "bias", bias, (c,), x.device, params_bf16)
    y, _, _ = launch_fused_plan(x, scale, bias, groups, eps, act, plan)
    cuda_build.count_launch(group_norm)
    return y


def launch_fused_plan(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float, act: str,
                      plan: StatsPlan) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel N's folded launch by a cluster-design `plan` on x, scale and
    bias as group_norm passes them (checked, contiguous, on x's device): (y,
    a, bb), a and bb those the statistics give; no launch counted. group_norm
    runs stats_plan's plan; scripts/group_norm_plans.py times others."""
    name = "group_norm"
    if plan.design != "cluster":
        raise ValueError(f"{name}: the folded launch takes a cluster-design plan, got {plan.design!r}")
    b, h, w, c = x.shape
    params_bf16 = scale.dtype == bias.dtype == torch.bfloat16
    out = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    kernel = cuda_build.load("group_norm_fused_cluster", _FUSED_ARGTYPES, source="group_norm")
    status = kernel(_ptr(x), _ptr(scale), _ptr(bias), int(params_bf16), _ptr(out[0]), _ptr(out[1]), _ptr(y),
                    int(act == "swish"), b, h * w, c, groups, plan.block_groups, plan.cluster, ctypes.c_float(eps),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    cuda_build.check(name, status)
    return y, out[0], out[1]


group_norm.launches = 0
