"""The port's tracer (visualcloze_tpu_torch/utils/tracing.py) and its spans
in the pipeline.

The tracer's own cases; the tiny CPU pipeline through process_images with
tracing on and off (the same images and stage keys, the spans of every
stage, evaluation and solver step under one query id); the solvers' steps;
a query's stages run on two threads; the clock a span is placed on the
profiler's timeline with. The `gpu` case checks, on the card, that a span
around a launched kernel holds the kernel's runtime launch event in a
CUDA-only trace. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q -m gpu
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from visualcloze_tpu_torch.utils import tracing

EVAL_CHILDREN = ["dit.embed", "dit.double_blocks", "dit.single_blocks", "dit.final"]


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _by_id(spans):
    return {s.id: s for s in spans}


def _path(s, by_id):
    names = []
    while s is not None:
        names.append(s.name)
        s = by_id.get(s.parent)
    return "/".join(reversed(names))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_spans_nest_and_name_their_parents(depth):
    tracing.enable()
    with tracing.span("query", query=tracing.new_query()) as root:

        def nest(level):
            if level == depth:
                return
            with tracing.span(f"level{level}", step=level):
                nest(level + 1)

        nest(0)
    spans = tracing.take()
    assert [s.name for s in spans] == ["query"] + [f"level{k}" for k in range(depth)]
    for outer, inner in zip(spans, spans[1:]):
        assert inner.parent == outer.id
        assert outer.start <= inner.start <= inner.end <= outer.end
    assert spans[0].parent is None and spans[0] is root
    assert {s.query for s in spans} == {root.query} and root.query is not None
    assert [s.attrs for s in spans[1:]] == [{"step": k} for k in range(depth)]
    assert tracing.take() == []


@pytest.mark.parametrize("children", [[], [(10, 20)], [(10, 20), (30, 45)], [(0, 100)]])
def test_self_time_is_the_span_less_its_children(children):
    parent = tracing.Span("p", 0, 100, 1, None, 7, 0)
    kids = [tracing.Span("c", a, b, 2 + k, 1, 7, 0) for k, (a, b) in enumerate(children)]
    grandchild = [tracing.Span("g", a, a + 1, 99, 2, 7, 0) for a, _ in children[:1]]
    own = tracing.self_ns([parent, *kids, *grandchild])
    assert own[1] == 100 - sum(b - a for a, b in children)
    for k, (a, b) in enumerate(children):
        assert own[2 + k] == (b - a) - (1 if k == 0 else 0)


@pytest.mark.parametrize("make", [lambda: tracing.span("dit.eval"),
                                  lambda: tracing.span("dit.eval", img_tokens=3968, txt_tokens=512),
                                  lambda: tracing.span("query", query=5),
                                  lambda: tracing.attach(5)])
def test_off_records_nothing_and_hands_out_the_shared_noop(make):
    ctx = make()
    assert ctx is tracing.NOOP
    with ctx as got:
        assert got is None
    assert tracing.new_query() is None and tracing.current_query() is None
    assert tracing.take() == []


def test_attach_with_no_id_is_the_noop_and_a_span_closes_on_an_exception():
    tracing.enable()
    assert tracing.attach(None) is tracing.NOOP
    with pytest.raises(ValueError):
        with tracing.span("query", query=3):
            with tracing.span("stage"):
                raise ValueError("boom")
    spans = tracing.take()
    assert [s.name for s in spans] == ["query", "stage"] and all(s.end >= s.start for s in spans)
    with tracing.span("after"):
        pass
    assert tracing.take()[0].parent is None  # the stack unwound


def test_two_threads_each_carrying_a_query_id_get_spans_of_their_own():
    tracing.enable()
    ids = [tracing.new_query(), tracing.new_query()]
    barrier = threading.Barrier(2, timeout=30)

    def work(qid):
        with tracing.attach(qid):
            for k in range(20):
                barrier.wait() if k % 5 == 0 else None
                with tracing.span("stage", k=k):
                    with tracing.span("dit.eval"):
                        time.sleep(0.0005)

    threads = [threading.Thread(target=work, args=(q,)) for q in ids]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    spans = tracing.take()
    by_id = _by_id(spans)
    assert len(spans) == 80
    for qid in ids:
        mine = [s for s in spans if s.query == qid]
        assert len(mine) == 40 and len({s.thread for s in mine}) == 1
        for s in mine:
            if s.name == "dit.eval":
                assert by_id[s.parent].name == "stage" and by_id[s.parent].query == qid
            else:
                assert s.parent is None  # attach sets the query, not a parent
    assert len({s.thread for s in spans}) == 2


def test_enable_reads_a_clock_pair_on_time_ns_base():
    tracing.enable()
    pair = tracing.clock()
    assert pair is not None
    now = tracing.to_profiler_ns(time.perf_counter_ns())
    assert abs(now - time.time_ns()) < 50_000_000  # the two clocks read together, within 50 ms


def test_a_converted_span_lies_inside_the_profiler_range_opened_around_it():
    from torch.profiler import ProfilerActivity, profile, record_function

    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            time.sleep(0.002)
            with tracing.span("inner"):
                time.sleep(0.002)
            time.sleep(0.002)
    (inner,) = tracing.take()
    (outer,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer"]
    a, b = outer.start_ns(), outer.start_ns() + outer.duration_ns()
    lo, hi = tracing.to_profiler_ns(inner.start), tracing.to_profiler_ns(inner.end)
    assert a <= lo < hi <= b, (a, lo, hi, b)
    assert hi - lo >= 2_000_000 and (lo - a) + (b - hi) >= 4_000_000


# --- the pipeline's spans ---------------------------------------------------

STEPS, UP_STEPS = 4, 3


@pytest.fixture(scope="module")
def model():
    from visualcloze_tpu_torch.pipeline import random_components

    return random_components(tiny=True, dtype=torch.float32, device="cpu", resolution=64)


def _grid():
    cell = Image.new("RGB", (64, 64), (120, 180, 90))
    other = Image.new("RGB", (64, 64), (30, 60, 200))
    return [[cell, other], [other, None]]


def _query(model, upsampling):
    images = model.process_images(_grid(), ["a grid", "rows", "the last image"], seed=11, steps=STEPS,
                                  upsampling_steps=UP_STEPS, is_upsampling=upsampling, grid_size=(2, 2))
    return [np.asarray(im) for im in images], dict(model.stage_seconds)


@pytest.mark.parametrize("upsampling", [False, True])
def test_tracing_changes_neither_the_images_nor_the_stage_keys(model, upsampling):
    off, off_stages = _query(model, upsampling)
    tracing.enable()
    on, on_stages = _query(model, upsampling)
    tracing.disable()
    assert tracing.take()
    again, _ = _query(model, upsampling)
    assert tracing.take() == []
    assert len(off) == len(on) == 1
    assert all(np.array_equal(a, b) for a, b in zip(off, on))
    assert all(np.array_equal(a, b) for a, b in zip(off, again))
    assert set(off_stages) == set(on_stages)


@pytest.mark.parametrize("upsampling", [False, True])
def test_a_traced_query_spans_its_stages_evaluations_and_steps(model, upsampling):
    tracing.enable()
    _, stages = _query(model, upsampling)
    spans = tracing.take()
    by_id = _by_id(spans)
    (root,) = [s for s in spans if s.name == "query"]
    assert root.parent is None and root.query is not None
    assert {s.query for s in spans} == {root.query}
    assert all(root.start <= s.start <= s.end <= root.end for s in spans)

    stage_spans = [s for s in spans if s.name in stages]
    assert collections.Counter(s.name for s in stage_spans) == collections.Counter({k: 1 for k in stages})
    for s in stage_spans:  # the stage clock's seconds hold the span (the clock starts first and stops last)
        assert (s.end - s.start) * 1e-9 <= stages[s.name] + 1e-6

    loops = {"denoise": STEPS - 1} | ({"sdedit_denoise": UP_STEPS - 1} if upsampling else {})
    evals = [s for s in spans if s.name == "dit.eval"]
    assert len(evals) == sum(loops.values())
    for s in evals:
        kids = sorted((c for c in spans if c.parent == s.id), key=lambda c: c.start)
        assert [c.name for c in kids] == EVAL_CHILDREN
        assert s.attrs["img_tokens"] > 0 and s.attrs["txt_tokens"] > 0
    steps = [s for s in spans if s.name == "solver.step"]
    for loop, n in loops.items():
        assert sum(by_id[s.parent].name == loop for s in evals) == n
        assert sum(by_id[s.parent].name == loop for s in steps) == n  # Euler: one update an evaluation
    (fin,) = [s for s in spans if s.name == "finalize"]
    assert fin.parent == root.id
    assert any(s.parent == fin.id and s.name == "vae_decode" for s in spans)
    paths = {_path(s, by_id) for s in spans}
    assert "query/denoise/dit.eval/dit.single_blocks" in paths and "query/denoise/solver.step" in paths


def test_two_queries_get_two_ids(model):
    tracing.enable()
    _query(model, False)
    _query(model, False)
    spans = tracing.take()
    roots = [s for s in spans if s.name == "query"]
    assert len(roots) == 2 and roots[0].query != roots[1].query
    for r in roots:
        assert all(s.query == r.query for s in spans if r.start <= s.start and s.end <= r.end)


def test_a_query_keeps_its_id_when_its_stages_run_on_other_threads(model):
    model.set_grid_size(2, 2)
    tracing.enable()
    with tracing.span("query", query=tracing.new_query()) as root:
        q = model.prepare_query(_grid(), ["a grid", "rows", "the last image"], seed=11, steps=STEPS)
    assert q["query_id"] == root.query
    out = {}

    def run(fn, *args, **kw):
        t = threading.Thread(target=lambda: out.setdefault(fn.__name__, fn(*args, **kw)))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()

    run(model.denoise_query, q)
    run(model.finalize_query, q, out["denoise_query"], upsampling_steps=UP_STEPS)
    spans = tracing.take()
    assert len({s.thread for s in spans}) == 3
    assert {s.query for s in spans} == {root.query}
    assert sum(s.name == "dit.eval" for s in spans) == STEPS - 1 + UP_STEPS - 1
    assert {"denoise", "sdedit_prepare", "sdedit_denoise", "sdedit_decode"} <= {s.name for s in spans}


def test_the_server_traces_each_query_under_an_id_of_its_own(model):
    from visualcloze_tpu_torch.pipeline.orchestrator import PipelinedServer

    tracing.enable()
    with PipelinedServer(model, max_inflight=2) as server:
        futures = [server.submit(_grid(), ["a grid", "rows", "the last image"], (2, 2), seed=s, steps=STEPS,
                                 upsampling_steps=UP_STEPS) for s in (5, 6)]
        for f in futures:
            assert len(f.result(timeout=300)) == 1
    spans = tracing.take()
    roots = [s for s in spans if s.name == "query"]
    assert len(roots) == 2 and len({r.query for r in roots}) == 2
    for r in roots:
        mine = [s for s in spans if s.query == r.query]
        assert sum(s.name == "dit.eval" for s in mine) == STEPS - 1 + UP_STEPS - 1
        assert {s.thread for s in mine} == {r.thread}
    assert all(s.query is not None for s in spans)


@pytest.mark.parametrize("method, updates", [("euler", lambda n: n), ("heun", lambda n: 2 * n),
                                             ("ab2", lambda n: n + 1), ("cached:2", lambda n: n),
                                             ("cached:3", lambda n: n)])
def test_each_solver_state_update_is_a_step_span(method, updates):
    from visualcloze_tpu_torch.transport.sampling import denoise_ode

    n = 6
    ts = np.linspace(1.0, 0.0, n + 1, dtype=np.float32)
    x = torch.randn((1, 8, 4), generator=torch.Generator().manual_seed(0))

    def model_fn(inp, timesteps):
        with tracing.span("dit.eval"):
            return -inp * timesteps[:, None, None]

    want = denoise_ode(model_fn, x, ts, method=method)
    tracing.enable()
    got = denoise_ode(model_fn, x, ts, method=method)
    spans = tracing.take()
    assert torch.equal(want, got)
    names = [s.name for s in spans]
    assert names.count("solver.step") == updates(n)
    assert all(s.parent is None for s in spans)  # a step is not inside an evaluation


# --- on the card ------------------------------------------------------------

LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the runtime's launch events exist only on the card)")
    return torch.device("cuda")


def _aten_kernel(dev):
    x = torch.randn((1024, 1024), device=dev)
    return lambda: x.mul(2.0)


def _port_kernel(dev):
    from visualcloze_tpu_torch.ops import block_fusions as bfu

    x, y = (torch.randn((1, 64, 3072), device=dev).to(torch.bfloat16) for _ in range(2))
    gate = torch.randn((1, 1, 3072), device=dev)
    return lambda: bfu.gated_residual(x, gate, y)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [_aten_kernel, _port_kernel], ids=["aten", "hand_written"])
def test_gpu_a_span_holds_its_kernels_launch_in_a_cuda_only_trace(kernel):
    from torch.profiler import ProfilerActivity, profile

    dev = _cuda_or_skip()
    call = kernel(dev)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):  # the profiler's start-up, outside the measured trace
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.001)
        with tracing.span("launch"):
            call()
        time.sleep(0.001)
        torch.cuda.synchronize()
    (s,) = tracing.take()
    lo, hi = tracing.to_profiler_ns(s.start), tracing.to_profiler_ns(s.end)
    events = list(prof.profiler.kineto_results.events())
    launches = [e for e in events if e.name().startswith(LAUNCH_NAMES)]
    kernels = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    inside = [e for e in launches if lo <= e.start_ns() <= hi]
    assert len(inside) == len(launches) >= 1, ([(e.name(), e.start_ns()) for e in events], lo, hi)
    # the device runs what the span launched after it opened (CUPTI has been seen to drop the
    # one kernel record of so short a trace, so the kernel's own record is not required)
    assert all(k.start_ns() >= lo for k in kernels)
