"""Runs one cell of BENCHMARK.json on the card and prints its result line.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (configs/<config>.json), a traffic mix
(traffic/<mix>.json, read by traffic.py) and, through BENCHMARK.json, its
metrics; each per-layer metric is read by metrics/<metric>.py. The run:
builds the measured package's serving pipeline with weights drawn from the
seed, warms every grid shape of the mix (one Euler step each), then sends
the mix's queries through VisualClozeModel.process_images in a closed loop
of one client. The window ends at the first completion after --seconds that
closes a cycle of the mix, so a rate is always over whole cycles. With
--trace 1 the window runs as it does untraced, and the stage clocks are read
from its queries; after it closes, three more queries (spread over the
cycle) are traced with torch.profiler, with ranges around the stages, the
DiT's linears and its attention, for the device readings; the per-layer
metrics are printed instead of the end-to-end ones. Then the program is
freed and a sample of the window's queries, drawn from the seed, is held
against the plain reference (check.py): `correct`.

Exits 2 without a result when there is no card (or fewer than the cell
asks for), and 3 when a module of the JAX package (or JAX) was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "visualcloze_tpu")
SAMPLE = 2  # queries of the window held against the reference, besides the longest
TRACED = 3  # queries traced in a --trace 1 run, after its window


def _process_start() -> float:
    """This process's start on time.perf_counter's clock (now, where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


PROCESS_START = _process_start()


def resolve(bench: dict, workload: str) -> dict:
    """The cell, its configuration, mix, limits and metrics, found by name."""
    from .check import load_limits
    from .traffic import load_mix

    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(ROOT / config_entry["file"]) as f:
        config = json.load(f)

    def for_cell(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return dict(cell=cell, config=config, mix=load_mix(cell["traffic"]), limits=load_limits(cell["config"]),
                end_to_end=for_cell(bench["end_to_end"]), per_layer=for_cell(bench["per_layer"]))


def reader(name: str):
    """metrics/<name>.py's read(ctx) -> value or None."""
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def send(model, q: dict, steps: int | None = None, upsampling_steps: int | None = None) -> list:
    return model.process_images(q["grid"], q["prompts"], seed=q["seed"], cfg=q["cfg"], steps=steps or q["steps"],
                                upsampling_steps=upsampling_steps or q["upsampling_steps"],
                                upsampling_noise=q["upsampling_noise"], is_upsampling=q["upsampling"],
                                grid_size=q["shape"])


def _answered(q: dict, images: list, resolution: int) -> bool:
    side = min(q["image_size"], 1024) if q["upsampling"] else resolution // 16 * 16
    return len(images) == 1 and images[0].size == (side, side)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, prepare=None, control: bool = False) -> dict:
    """One run of a resolved cell (resolve()) on `device`: its result line as
    a dict. prepare(model), when given, runs on the built model before the
    warm-up (the tests plant faults with it). control: also read the
    numbers of the control (check.CONTROL) on the same sample, under
    "control" (control.py; the benchmark's own runs do not)."""
    import numpy as np
    import torch

    from . import check, system
    from . import trace as tr
    from .traffic import Traffic

    config, mix, limits = spec["config"], spec["mix"], spec["limits"]
    cuda = device.type == "cuda"
    clock = {"imported": time.perf_counter() - PROCESS_START}
    if cuda:
        from visualcloze_tpu_torch.ops import cuda_build

        cuda_build.set_build_dir(ROOT / "build" / "torch_kernels")
        clock["nvcc_built"] = len(cuda_build.build())
    t = time.perf_counter()
    model = system.build(config, seed, device)
    _sync(device)
    clock["build_s"] = time.perf_counter() - t
    if prepare is not None:
        prepare(model)
    traffic = Traffic(mix, seed)
    rec = system.Recorder(model)
    cycle = traffic.cycle
    for shape in traffic.shapes():
        rec.begin(None)
        send(model, traffic.query(cycle.index(shape)), steps=2, upsampling_steps=2)
        rec.take(False)
    _sync(device)
    clock["warm_s"] = time.perf_counter() - t - clock["build_s"]
    resident = torch.cuda.memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - PROCESS_START

    rng = np.random.default_rng([seed % 2 ** 63, seed // 2 ** 63, 7])
    reservoir: list[dict] = []
    longest = None
    records, failed = [], 0
    activities = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])

    def one(i: int, traced: bool) -> tuple[dict, list]:
        """Sends query i; its record and the images it answered with."""
        nonlocal failed
        q = traffic.query(i)
        plan = None
        if not traced:
            # the evaluation each loop's capture starts at, so that EULER_SPAN steps follow it
            plan = {"denoise": int(rng.integers(0, q["steps"] - 1 - system.EULER_SPAN))}
            if q["upsampling"]:
                plan["sdedit_denoise"] = int(rng.integers(0, q["upsampling_steps"] - 1 - system.EULER_SPAN))
        rec.begin(plan, trace=traced)
        # the profiler and the layer ranges only around a traced query
        prof = torch.profiler.profile(activities=activities) if traced else contextlib.nullcontext()
        spans = system.layer_spans() if traced else contextlib.nullcontext()
        tq = time.perf_counter()
        with prof, spans:
            with torch.profiler.record_function(system.SPAN + "query") if traced else contextlib.nullcontext():
                images = send(model, q)
                _sync(device)
        tq = time.perf_counter() - tq
        failed += not _answered(q, images, config["assumed"]["resolution"])
        t = time.perf_counter()
        record = dict(index=i, shape=q["shape"], seconds=tq, stage_seconds=dict(model.stage_seconds),
                      work=list(rec.work), traced=traced, trace=tr.summarize(prof) if traced else None)
        clock["trace_read_s"] = clock.get("trace_read_s", 0.0) + time.perf_counter() - t
        return record, images

    t0 = time.perf_counter()
    i = 0
    while True:
        record, images = one(i, False)
        q = traffic.query(i)
        tokens = sum(u[1] for u in record["work"] if u[0] == "dit")
        keep = len(reservoir) < SAMPLE or int(rng.integers(0, i + 1)) < SAMPLE
        is_longest = longest is None or tokens > longest["tokens"]
        caps = rec.take(to_host=keep or is_longest)
        item = dict(query=q, captures=caps, tokens=tokens, index=i,
                    answer=np.asarray(images[0]) if (keep or is_longest) and images else None)
        if keep:
            if len(reservoir) < SAMPLE:
                reservoir.append(item)
            else:
                reservoir[int(rng.integers(0, SAMPLE))] = item
        if is_longest:
            longest = item
        records.append(record)
        i += 1
        if time.perf_counter() - t0 >= seconds and i % len(cycle) == 0:
            break
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        # after the window, so that no timed query runs beside the profiler or after it
        n = len(cycle)
        with torch.profiler.profile(activities=activities):  # the profiler's start-up, outside the traced queries
            torch.ones(1, device=device).add_(1)
            _sync(device)
        for k in range(TRACED):
            record, _ = one(i + (k * n // TRACED if n >= TRACED else k), True)
            rec.take(False)
            records.append(record)
        timed = {}
        for r in records:
            if not r["traced"]:
                timed.setdefault(tuple(r["shape"]), []).append(r["seconds"])
        # the profiler's cost: each traced query's seconds beside the window's mean of its shape
        clock["traced_vs_timed_s"] = [[list(r["shape"]), r["seconds"], float(np.mean(timed[tuple(r["shape"])]))]
                                      for r in records if r["traced"]]

    del model, rec, item
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sample = {it["index"]: it for it in reservoir + [longest]}
    t = time.perf_counter()
    readings: dict = {}
    numbers = check.compare(config, seed, [sample[k] for k in sorted(sample)], device, readings=readings)
    clock.update(window_s=window, reference_s=time.perf_counter() - t, sample=sorted(sample), readings=readings)
    print(f"bench_port: {json.dumps(clock)} query_s={[round(r['seconds'], 4) for r in records]}", file=sys.stderr)
    correct = failed == 0 and all(numbers[n] <= limits[n] for n in limits)

    gib = 2 ** 30
    ctx = dict(config=config, records=records, resident_bytes=resident, peak_bytes=peak)
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # a quantity split by cell (s_per_query.w8a8) reads as the quantity its name starts with
        e2e = {"s_per_query": window / i, "peak_mem_gib": peak / gib, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]} for m in spec["end_to_end"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1, "memory_peak_bytes": peak}
    result = dict(correct=bool(correct), attempted=len(records), failed=failed, metrics=metrics, device=dev)
    if trace:
        summary = tr.merge([r["trace"] for r in records if r["trace"] is not None])
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in summary["classes"].items()), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in summary["gaps"].items()), key=lambda kv: -kv[1])[:10]}
    if control:
        result["control"] = check.compare(config, seed, [sample[k] for k in sorted(sample)], device, control=True)
    result["checks"] = {n: {"value": numbers[n], "limit": limits[n]} for n in check.NUMBERS}
    return result


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        spec = resolve(json.load(f), args.workload)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["USE_FLAX"] = "0"
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {found}, which the measured program must not use", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
