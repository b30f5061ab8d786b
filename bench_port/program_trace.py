"""The program's own spans (visualcloze_tpu_torch.utils.tracing) as per-layer
readings: why the device idles inside the denoise loop, read per DiT
evaluation.

Two phases, after a window, on the same cycle indices as bench_port.run's
traced queries (run_phases):
- phase A: the tracer on, no profiler. The host durations of the spans
  (dit_enqueue_ms: what the host needs to enqueue one evaluation) and each
  query's seconds, beside the window's mean of its shape (the tracer's cost
  when it is on).
- phase B: the tracer on, under torch.profiler with CUDA activity only (no
  CPU activity, no bench:: range). The spans are placed on the device
  timeline with tracing.to_profiler_ns (place); each idle gap of the query
  goes to the innermost span open on the host when the gap starts, and the
  CUDA runtime's launch calls (cudaLaunchKernel*, cuLaunchKernel*) are
  counted inside the dit.eval spans.

The readers take a ctx whose "program_records" holds run_phases' records
and return None where it holds none, as bench_port.readings' do.

Standalone, on the card (the cell's build, warm-up and window as
bench_port.run makes them, in turns with the tracer off and on, then the
two phases; one JSON line, the idle table on stderr):

    python3 -m bench_port.program_trace --workload <cell> --seed <n> --seconds <s> [--turns 2]
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import subprocess
import sys
import time

LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel")
DIT = "dit.eval"
QUERY = "query"
TOP = 10  # rows of the idle table


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiler_events(prof) -> list[tuple[str, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every event of a trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def run_phases(send_query, indices: list[int], device) -> list[dict]:
    """Phases A and B over `indices`. send_query(i) sends query i, waits for
    the device and returns its record (a dict with "seconds"); each record
    gains "phase", "spans" (the query's tracing spans) and "trace" (phase B:
    place's summary, None where the trace holds no device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from visualcloze_tpu_torch.utils import tracing

    records = []
    try:
        tracing.enable()
        for i in indices:
            tracing.take()
            rec = send_query(i)
            records.append(dict(rec, phase="A", spans=tracing.take(), trace=None))
        # CUDA activity alone; on the CPU (the tests) the CPU's, and no device event to place
        activities = [ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU]
        with profile(activities=activities):  # the profiler's start-up, outside the traced queries
            torch.ones(1, device=device).add_(1)
            _sync(device)
        for i in indices:
            tracing.enable()  # a clock pair of this query's own
            tracing.take()
            with profile(activities=activities) as prof:
                rec = send_query(i)
            spans = tracing.take()
            records.append(dict(rec, phase="B", spans=spans,
                                trace=place(spans, profiler_events(prof), tracing.clock())))
    finally:
        tracing.disable()
        tracing.take()
    return records


def _union(intervals):
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def place(spans: list, events: list[tuple[str, bool, int, int]], clock: tuple[int, int]) -> dict | None:
    """One phase-B query: its spans (tracing.Span, perf_counter_ns) put on
    the events' timeline with clock = (perf_counter_ns, time_ns). Returns
    {window_s (the query span), busy_s, idle_by_path {path below the query
    span: s}, dit_idle_s (idle whose innermost span is a dit.eval or inside
    one), dit_launches (launch calls whose host start lies in a dit.eval),
    evals, launches, kernels (in the window)}; None without a query span or
    a device event."""
    shift = clock[1] - clock[0]
    roots = [s for s in spans if s.name == QUERY and s.parent is None]
    devices = [(a, b) for _, dev, a, b in events if dev]
    if not roots or not devices:
        return None
    root = roots[0]
    w0, w1 = root.start + shift, root.end + shift
    by_id = {s.id: s for s in spans}
    paths, in_dit = {}, {}

    def path(s):
        if s.id not in paths:
            parent = by_id.get(s.parent)
            above = path(parent) if parent is not None and parent is not root else ""
            paths[s.id] = f"{above}/{s.name}" if above else s.name
            in_dit[s.id] = s.name == DIT or (parent is not None and parent is not root and in_dit[parent.id])
        return paths[s.id]

    mine = [s for s in spans if s.query == root.query and s is not root]
    for s in mine:
        path(s)
    # the innermost open span from each span boundary on: a sweep over starts and ends
    marks = sorted([(s.start + shift, 1, s.id) for s in mine] + [(s.end + shift, 0, s.id) for s in mine])
    seg_t, seg_span, stack = [], [], []
    for t, opens, sid in marks:
        if opens:
            stack.append(sid)
        else:
            stack.remove(sid)
        seg_t.append(t)
        seg_span.append(stack[-1] if stack else None)

    busy = _union([(max(a, w0), min(b, w1)) for a, b in devices if b > w0 and a < w1])
    idle: dict[str, float] = {}
    dit_idle = 0.0
    edges = [w0] + [t for a, b in busy for t in (a, b)] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        j = bisect.bisect_right(seg_t, a) - 1
        sid = seg_span[j] if j >= 0 else None
        key = paths[sid] if sid is not None else QUERY
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-9
        if sid is not None and in_dit[sid]:
            dit_idle += (b - a) * 1e-9
    launches = sorted(a for name, dev, a, _ in events if not dev and name.startswith(LAUNCH_NAMES))
    evals = [s for s in mine if s.name == DIT]
    dit_launches = sum(bisect.bisect_right(launches, s.end + shift) - bisect.bisect_left(launches, s.start + shift)
                       for s in evals)
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=sum(b - a for a, b in busy) * 1e-9, idle_by_path=idle,
                dit_idle_s=dit_idle, dit_launches=dit_launches, evals=len(evals),
                launches=bisect.bisect_right(launches, w1) - bisect.bisect_left(launches, w0),
                kernels=sum(1 for a, b in devices if w0 <= a < w1))


def _phase(ctx: dict, phase: str) -> list[dict]:
    return [r for r in ctx.get("program_records") or [] if r["phase"] == phase]


def _placed(ctx: dict) -> list[dict]:
    return [r["trace"] for r in _phase(ctx, "B") if r["trace"] is not None]


def dit_enqueue_ms(ctx):
    """Mean host milliseconds of a dit.eval span in phase A: what the host
    needs to enqueue one DiT evaluation (the device's work where the host
    waits for it inside)."""
    durations = [s.end - s.start for r in _phase(ctx, "A") for s in r["spans"] if s.name == DIT]
    return 1e-6 * sum(durations) / len(durations) if durations else None


def dit_idle_ms(ctx):
    """Device idle put on dit.eval and its children in phase B, in ms, over
    the evaluations."""
    placed = _placed(ctx)
    evals = sum(p["evals"] for p in placed)
    return 1e3 * sum(p["dit_idle_s"] for p in placed) / evals if evals else None


def dit_launches(ctx):
    """CUDA runtime launch calls inside dit.eval spans in phase B, over the
    evaluations (cuBLAS's, aten's and the hand-written kernels' alike)."""
    placed = _placed(ctx)
    evals = sum(p["evals"] for p in placed)
    return sum(p["dit_launches"] for p in placed) / evals if evals else None


def device_idle_cuda_only(ctx):
    """100 x (1 - device busy / the query spans) over phase B: the idle share
    without the cost of the profiler's CPU activity."""
    placed = _placed(ctx)
    window = sum(p["window_s"] for p in placed)
    return 100.0 * (1.0 - sum(p["busy_s"] for p in placed) / window) if window else None


READERS = {f.__name__: f for f in (dit_enqueue_ms, dit_idle_ms, dit_launches, device_idle_cuda_only)}


def idle_table(ctx: dict, top: int = TOP) -> list[list]:
    """Phase B's idle seconds by innermost span path, the largest first."""
    out: dict[str, float] = {}
    for p in _placed(ctx):
        for k, v in p["idle_by_path"].items():
            out[k] = out.get(k, 0.0) + v
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])[:top]


def phase_seconds(ctx: dict) -> list[list]:
    """[phase, shape, seconds, the window's mean seconds of that shape] of
    each phase's query: beside the untraced window, phase A's share is the
    tracer's cost when on, phase B's the CUDA-only profiler's and the tracer's."""
    pace: dict = {}
    for r in ctx["records"]:
        if not r["traced"]:
            pace.setdefault(tuple(r["shape"]), []).append(r["seconds"])
    return [[r["phase"], list(r["shape"]), r["seconds"], statistics.fmean(pace[tuple(r["shape"])])]
            for r in ctx.get("program_records") or [] if tuple(r["shape"]) in pace]


def _smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def measure(spec: dict, seed: int, seconds: float, device, turns: int) -> dict:
    """One cell: build and warm as bench_port.run does, then `turns` pairs of
    windows (the tracer off, then on), then phases A and B on the indices
    bench_port.run traces after its window. The readings are of the
    tracer-off windows and the phases."""
    from visualcloze_tpu_torch.utils import tracing

    from . import run, system
    from .traffic import Traffic

    config = spec["config"]
    if device.type == "cuda":
        from visualcloze_tpu_torch.ops import cuda_build

        cuda_build.set_build_dir(run.ROOT / "build" / "torch_kernels")
        cuda_build.build()
    model = system.build(config, seed, device)
    traffic = Traffic(spec["mix"], seed)
    cycle = traffic.cycle
    for shape in traffic.shapes():
        run.send(model, traffic.query(cycle.index(shape)), steps=2, upsampling_steps=2)
    _sync(device)
    failed = 0

    def send_query(i: int) -> dict:
        nonlocal failed
        q = traffic.query(i)
        t = time.perf_counter()
        images = run.send(model, q)
        _sync(device)
        t = time.perf_counter() - t
        failed += not run._answered(q, images, config["assumed"]["resolution"])
        return dict(index=i, shape=q["shape"], seconds=t)

    records, windows, i = [], [], 0
    for _ in range(turns):
        for on in (False, True):
            if on:
                tracing.enable()
            t0, n, loops = time.perf_counter(), 0, 0.0
            while True:
                records.append(dict(send_query(i), traced=on, trace=None))
                loops += sum(model.stage_seconds.get(s, 0.0) for s in ("denoise", "sdedit_denoise"))
                tracing.take()
                i, n = i + 1, n + 1
                if time.perf_counter() - t0 >= seconds and i % len(cycle) == 0:
                    break
            windows.append(dict(tracer=on, queries=n, s_per_query=(time.perf_counter() - t0) / n,
                                loop_s_per_query=loops / n))
            tracing.disable()
    m = len(cycle)
    indices = [i + (k * m // run.TRACED if m >= run.TRACED else k) for k in range(run.TRACED)]
    ctx = dict(records=records, program_records=run_phases(send_query, indices, device))
    off = [w["s_per_query"] for w in windows if not w["tracer"]]
    on = [w["s_per_query"] for w in windows if w["tracer"]]
    placed = _placed(ctx)
    return dict(readings={k: f(ctx) for k, f in READERS.items()}, windows=windows,
                tracer_on_cost=statistics.fmean(on) / statistics.fmean(off) - 1.0, failed=failed,
                phase_seconds=phase_seconds(ctx), idle_table=idle_table(ctx),
                launches_in_queries=[p["launches"] for p in placed], kernels_in_queries=[p["kernels"] for p in placed],
                evals=[p["evals"] for p in placed])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args(argv)
    import torch

    from . import run

    with open(run.ROOT / "BENCHMARK.json") as f:
        spec = run.resolve(json.load(f), args.workload)
    if not torch.cuda.is_available():
        print("program_trace: the cell needs a CUDA device", file=sys.stderr)
        return 2
    out = measure(spec, args.seed, args.seconds, torch.device("cuda", 0), args.turns)
    for path, s in out["idle_table"]:
        print(f"program_trace idle {s:.4f} s {path}", file=sys.stderr)
    print(json.dumps(dict(workload=args.workload, seed=args.seed, device=_smi(), torch=torch.__version__, **out)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
