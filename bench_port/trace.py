"""What a torch.profiler trace of one query says: device busy time, the
traced window, device time by kernel class and inside the benchmark's
ranges, and the idle gaps named by the stage the host was in.

The kernel classes are the measured package's kernel names (csrc/*.cu,
demangled) and cuBLAS's, copied from its profiling script so that the
benchmark owns them.
"""

from __future__ import annotations

import bisect
import re

import torch

from .system import SPAN

KERNEL_CLASSES = (
    (re.compile(r"\bw8a8_matmul_kernel[<(]"), "w8a8 matmul (H)"),
    (re.compile(r"\bact_quant_kernel<"), "activation quantize (I)"),
    (re.compile(r"\bln_modulate_quant_kernel<"), "layernorm modulate + codes (J)"),
    (re.compile(r"\bmerge_heads_quant_kernel[<(]"), "head merge + codes (M)"),
    (re.compile(r"\bgelu_act_quant_kernel\("), "gelu + codes (O)"),
    (re.compile(r"\bint8_(matmul\w*|gemv)<|\bmatmul_wide<[^,]*\bInt8Convert\b"), "int8 matmul (G)"),
    (re.compile(r"\bint4_gemv<|\bmatmul_wide<[^,]*\bInt4Convert\b"), "int4 matmul (G4)"),
    (re.compile(r"\brope_rotate[<(]"), "rotation pass (A)"),
    (re.compile(r"\bflash_fwd[<(]"), "attention (D)"),
    (re.compile(r"\bln_modulate_kernel<"), "layernorm modulate (J)"),
    (re.compile(r"\bgated_residual_kernel\("), "gated residual (K)"),
    (re.compile(r"\bqk_norm_split_kernel\("), "head split + q/k norm (L)"),
    (re.compile(r"\bmerge_heads_kernel\("), "head merge + gelu (M)"),
    (re.compile(r"\bconv3x3_kernel<"), "vae conv (B)"),
    (re.compile(r"\bflash_d512"), "vae attention (C)"),
    (re.compile(r"\bgroup_norm_(stats|apply|fused)\w*[<(]"), "vae group norm (N)"),
)
GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass")


def kernel_class(name: str) -> str:
    for pattern, cls in KERNEL_CLASSES:
        if pattern.search(name):
            return cls
    if any(m in name.lower() for m in GEMM_MARKS):
        return "cublas gemm"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "memcpy/memset"
    return "other"


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _covered(busy: list[tuple[float, float]], starts: list[float], a: float, b: float) -> float:
    """How much of [a, b] the sorted, disjoint busy intervals cover."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    out = 0.0
    while i < len(busy) and busy[i][0] < b:
        out += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return out


def summarize(prof) -> dict | None:
    """One traced query (inside a bench::query range) -> {busy_s, window_s,
    classes {class: s}, spans {range: device s}, gaps {stage: idle s}}; None
    if the trace holds no device events. Reads the profiler's raw events
    (no event tree is built: a query holds some 10^5 of them)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    query, kernels, ranges, stages = None, [], [], []
    for e in prof.profiler.kineto_results.events():
        name, dev = e.name(), e.device_type()
        a = e.start_ns()
        b = a + e.duration_ns()
        if not name.startswith(SPAN):
            if dev == cuda:
                kernels.append((a, b, name))
            continue
        name = name[len(SPAN):]
        if dev == cpu and name == "query":
            query = (a, b)
        elif dev == cpu and name.startswith("stage::"):
            stages.append((a, b, name[len("stage::"):]))
        elif dev == cuda and not name.startswith("stage::") and name != "query":
            ranges.append((a, b, name))
    if query is None or not kernels:
        return None
    w0, w1 = query
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _ in kernels if b > w0 and a < w1])
    classes: dict[str, float] = {}
    for a, b, name in kernels:
        cls = kernel_class(name)
        classes[cls] = classes.get(cls, 0.0) + (b - a) * 1e-9
    # a range's device time: the kernel time inside its device-side span (first to last kernel it
    # launched), which holds the kernels launched through ctypes too, not only those of aten ops
    starts = [a for a, _ in busy]
    spans: dict[str, float] = {}
    for a, b, name in ranges:
        spans[name] = spans.get(name, 0.0) + _covered(busy, starts, a, b) * 1e-9
    stages.sort()
    stage_starts = [a for a, _, _ in stages]
    gaps: dict[str, float] = {}
    edges = [w0] + [t for a, b in busy for t in (a, b)] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        j = bisect.bisect_right(stage_starts, a) - 1
        where = stages[j][2] if j >= 0 and stages[j][1] > a else "outside the stages"
        gaps[where] = gaps.get(where, 0.0) + (b - a) * 1e-9
    return dict(busy_s=sum(b - a for a, b in busy) * 1e-9, window_s=(w1 - w0) * 1e-9, classes=classes,
                spans=spans, gaps=gaps)


def merge(summaries: list[dict]) -> dict:
    """The sum of several queries' summaries."""
    out = dict(busy_s=0.0, window_s=0.0, classes={}, spans={}, gaps={})
    for s in summaries:
        out["busy_s"] += s["busy_s"]
        out["window_s"] += s["window_s"]
        for key in ("classes", "spans", "gaps"):
            for k, v in s[key].items():
                out[key][k] = out[key].get(k, 0.0) + v
    return out
