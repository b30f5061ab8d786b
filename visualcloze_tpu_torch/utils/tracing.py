"""An in-process tracer of the port's host work, off by default.

    from visualcloze_tpu_torch.utils import tracing

    tracing.enable()
    model.process_images(...)
    spans = tracing.take()      # the finished spans, oldest first; the buffer is emptied
    tracing.disable()

`span(name, **attrs)` is a context manager that records one Span: its name,
its start and end on time.perf_counter_ns's clock, its own id, the id of the
span that was open around it on the same thread (its parent), the query it
belongs to, the thread and the attrs. Spans are kept in memory until
`take()`; nothing is written anywhere else. Off, `span` tests one flag and
returns the shared no-op context NOOP, building nothing (a caller that
passes attrs still builds its call's keyword dict).

Queries: the pipeline opens a "query" span with `query=new_query()`, and the
spans opened inside it on the same thread inherit that id. A stage that may
run on another thread takes its query's id from the query's dict and makes
it current there with `attach(query)`.

Clocks: torch.profiler stamps its events on the system clock (time.time_ns's
base), not on perf_counter's. `enable()` reads one (perf_counter_ns,
time_ns) pair, and `to_profiler_ns(t)` moves a span's time onto the
profiler's timeline with it.

No environment variable turns the tracer on: the switch is `enable()`.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field


@dataclass(slots=True)
class Span:
    name: str
    start: int  # time.perf_counter_ns()
    end: int
    id: int
    parent: int | None  # the span open around this one on its thread
    query: int | None
    thread: int
    attrs: dict = field(default_factory=dict)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()

_on = False
_spans: list[Span] = []  # finished spans; appended from any thread (one list.append each)
_span_ids = itertools.count(1)
_query_ids = itertools.count(1)
_local = threading.local()  # .stack: [(span id, query id)] of this thread's open spans and attached queries
_clock: tuple[int, int] | None = None  # (perf_counter_ns, time_ns) read together at enable()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """One span while it is open: pushed on its thread's stack on entry,
    recorded on exit (with the exception's unwinding too)."""

    __slots__ = ("rec",)

    def __init__(self, name: str, query: int | None, attrs: dict):
        self.rec = Span(name, 0, 0, next(_span_ids), None, query, threading.get_ident(), attrs)

    def __enter__(self) -> Span:
        rec, stack = self.rec, _stack()
        if stack:
            rec.parent = stack[-1][0]
            if rec.query is None:
                rec.query = stack[-1][1]
        stack.append((rec.id, rec.query))
        rec.start = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        self.rec.end = time.perf_counter_ns()
        _stack().pop()
        _spans.append(self.rec)
        return False


class _Attached:
    """Makes `query` the current query of this thread; the parent of spans
    opened inside stays the span open around this."""

    __slots__ = ("query",)

    def __init__(self, query: int):
        self.query = query

    def __enter__(self):
        stack = _stack()
        stack.append((stack[-1][0] if stack else None, self.query))

    def __exit__(self, *exc):
        _stack().pop()
        return False


def span(name: str, query: int | None = None, **attrs):
    """A context manager recording one span of `name`; `query` its query's
    id (default: the current query of this thread). Off: NOOP."""
    if not _on:
        return NOOP
    return _Open(name, query, attrs)


def attach(query: int | None):
    """A context manager making `query` (an id from new_query, carried in a
    query's dict) current on this thread. Off, or with no id: NOOP."""
    if not _on or query is None:
        return NOOP
    return _Attached(query)


def new_query() -> int | None:
    """A fresh query id; None when off."""
    return next(_query_ids) if _on else None


def current_query() -> int | None:
    """The query id current on this thread; None when off or outside any query."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1][1] if stack else None


def enable() -> None:
    """Turns the tracer on and reads the clock pair that to_profiler_ns uses
    (again on every call)."""
    global _on, _clock
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    _clock = ((a + b) // 2, wall)
    _on = True


def disable() -> None:
    """Turns the tracer off; spans still open are recorded when they close."""
    global _on
    _on = False


def take() -> list[Span]:
    """The finished spans, by start time, and an empty buffer."""
    out = _spans[:]
    del _spans[: len(out)]
    return sorted(out, key=lambda s: s.start)


def clock() -> tuple[int, int] | None:
    """The (perf_counter_ns, time_ns) pair of the last enable()."""
    return _clock


def to_profiler_ns(t: int) -> int:
    """A perf_counter_ns time on torch.profiler's clock (time_ns's base)."""
    if _clock is None:
        raise RuntimeError("the tracer has no clock pair: call enable() first")
    return t - _clock[0] + _clock[1]


def self_ns(spans: list[Span]) -> dict[int, int]:
    """Each span's duration less its children's: {span id: ns}."""
    out = {s.id: s.end - s.start for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end - s.start
    return out
