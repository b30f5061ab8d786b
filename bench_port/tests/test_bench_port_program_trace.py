"""bench_port.program_trace: the program's spans placed on a device
timeline give the known idle, launches and evaluations of a synthetic
query; the readers read phase A's and phase B's records and nothing else;
a tiny cell runs its windows and both phases on the CPU."""

from __future__ import annotations

import pytest
import torch

from bench_port import program_trace as pt
from bench_port.tests.tiny import tiny_spec
from visualcloze_tpu_torch.utils.tracing import Span

SHIFT = 10_000  # the clock pair (0, SHIFT): profiler ns = perf_counter ns + SHIFT


def _spans():
    """A query of two evaluations (the first with its four children), two
    solver steps and the finalize glue, on perf_counter_ns."""
    rows = [("query", 0, 1000, None), ("denoise", 100, 900, 1), ("dit.eval", 100, 400, 2),
            ("dit.embed", 100, 150, 3), ("dit.double_blocks", 150, 250, 3), ("dit.single_blocks", 250, 380, 3),
            ("dit.final", 380, 400, 3), ("solver.step", 400, 450, 2), ("dit.eval", 450, 800, 2),
            ("solver.step", 800, 850, 2), ("finalize", 900, 990, 1)]
    return [Span(name, a, b, k + 1, parent, 7, 1) for k, (name, a, b, parent) in enumerate(rows)]


def _events():
    kernels = [(120, 200), (260, 420), (460, 790), (870, 980), (1200, 1300)]
    launches = [110, 160, 300, 390, 420, 500, 600, 950, 1500]
    ev = [("kernel", True, a + SHIFT, b + SHIFT) for a, b in kernels]
    ev += [("cudaLaunchKernel" if t != 300 else "cuLaunchKernelEx", False, t + SHIFT, t + SHIFT + 5)
           for t in launches]
    ev += [("cudaStreamSynchronize", False, 430 + SHIFT, 440 + SHIFT)]
    return ev


def test_place_puts_each_gap_on_the_innermost_span_open_when_it_starts():
    got = pt.place(_spans(), _events(), (0, SHIFT))
    assert got["window_s"] == pytest.approx(1000e-9)
    assert got["busy_s"] == pytest.approx(680e-9)
    want = {"query": 120e-9, "denoise/dit.eval/dit.double_blocks": 60e-9, "denoise/solver.step": 40e-9,
            "denoise/dit.eval": 80e-9, "finalize": 20e-9}
    assert got["idle_by_path"] == pytest.approx(want)
    assert got["dit_idle_s"] == pytest.approx(140e-9)
    assert (got["evals"], got["dit_launches"], got["launches"], got["kernels"]) == (2, 6, 8, 4)


@pytest.mark.parametrize("drop", ["query", "device"])
def test_place_reads_nothing_without_a_query_span_or_a_device_event(drop):
    spans = [s for s in _spans() if s.name != "query"] if drop == "query" else _spans()
    events = [e for e in _events() if not e[1]] if drop == "device" else _events()
    assert pt.place(spans, events, (0, SHIFT)) is None


def _ctx():
    spans = _spans()
    trace = pt.place(spans, _events(), (0, SHIFT))
    program = [dict(phase="A", shape=(2, 3), seconds=5.0, spans=spans, trace=None),
               dict(phase="B", shape=(2, 3), seconds=6.0, spans=spans, trace=trace),
               dict(phase="B", shape=(2, 3), seconds=6.5, spans=spans, trace=trace)]
    records = [dict(shape=(2, 3), seconds=s, traced=False, trace=None) for s in (4.0, 5.0)]
    return dict(records=records, program_records=program)


@pytest.mark.parametrize("name, want", [("dit_enqueue_ms", 325e-6), ("dit_idle_ms", 140e-6 / 2),
                                        ("dit_launches", 3.0), ("device_idle_cuda_only", 32.0)])
def test_the_readers_give_the_known_values(name, want):
    assert pt.READERS[name](_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(pt.READERS))
def test_the_readers_read_nothing_where_the_run_has_no_program_records(name):
    ctx = _ctx()
    assert pt.READERS[name](dict(ctx, program_records=None)) is None
    assert pt.READERS[name]({"records": ctx["records"]}) is None


def test_the_idle_table_and_the_phase_seconds():
    ctx = _ctx()
    table = pt.idle_table(ctx)
    assert table[0] == ["query", pytest.approx(240e-9)] and len(table) == 5
    assert [r[1] for r in table] == sorted((r[1] for r in table), reverse=True)
    assert pt.phase_seconds(ctx) == [["A", [2, 3], 5.0, 4.5], ["B", [2, 3], 6.0, 4.5], ["B", [2, 3], 6.5, 4.5]]


def test_a_tiny_cell_runs_its_windows_and_both_phases_on_the_cpu():
    out = pt.measure(tiny_spec("bf16.default_query"), 2 ** 33 + 5, 0.05, torch.device("cpu"), turns=1)
    assert [w["tracer"] for w in out["windows"]] == [False, True] and out["failed"] == 0
    assert [p[0] for p in out["phase_seconds"]] == ["A"] * 3 + ["B"] * 3
    readings = out["readings"]
    assert readings["dit_enqueue_ms"] > 0
    # no device on the CPU: the phase-B readers find nothing to read
    assert readings["dit_idle_ms"] is None and readings["dit_launches"] is None
    assert readings["device_idle_cuda_only"] is None and out["idle_table"] == []
