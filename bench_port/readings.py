"""The per-layer metrics' readings. metrics/<name>.py names the one its
metric reads; a reader takes ctx = {"config", "records", "resident_bytes",
"peak_bytes"} and returns a number, or None where the run holds nothing to
read. Host-clock readings come from the window's queries, none of them
traced; device readings from the queries traced after the window."""

from __future__ import annotations

from .flops import seconds_at_peak, work_cost


def untraced(ctx: dict) -> list[dict]:
    return [r for r in ctx["records"] if not r["traced"]]


def traced(ctx: dict) -> list[dict]:
    return [r for r in ctx["records"] if r["trace"] is not None]


def _mean_stage(ctx: dict, stages: tuple[str, ...]) -> float | None:
    recs = untraced(ctx)
    if not recs:
        return None
    return sum(sum(r["stage_seconds"].get(s, 0.0) for s in stages) for r in recs) / len(recs)


def preprocess_s(ctx):
    """Mean host seconds of a query's grid preprocessing (the pipeline's "preprocess" stage)."""
    return _mean_stage(ctx, ("preprocess",))


def text_encode_s(ctx):
    """Mean seconds of a query's first-stage T5 and CLIP encoding (the "text_encode" stage)."""
    return _mean_stage(ctx, ("text_encode",))


def vae_s(ctx):
    """Mean seconds of a query in vae_encode + vae_decode + sdedit_prepare +
    sdedit_decode (the last two also hold SDEdit's prompt encoding)."""
    return _mean_stage(ctx, ("vae_encode", "vae_decode", "sdedit_prepare", "sdedit_decode"))


def dit_eval_ms(ctx):
    """Milliseconds per DiT evaluation: the denoise loops' stage seconds
    (denoise + sdedit_denoise) over the evaluations they made."""
    recs = untraced(ctx)
    evals = sum(1 for r in recs for u in r["work"] if u[0] == "dit")
    if not evals:
        return None
    return 1e3 * sum(r["stage_seconds"].get(s, 0.0) for r in recs for s in ("denoise", "sdedit_denoise")) / evals


def query_mfu(ctx):
    """100 x the seconds the card would need at its peaks for the queries'
    counted operations (every DiT evaluation, VAE call and text encoding;
    each class at the peak of the precision it runs in) over their host seconds."""
    recs = untraced(ctx)
    if not recs:
        return None
    at_peak = sum(seconds_at_peak(work_cost(ctx["config"], r["work"])) for r in recs)
    return 100.0 * at_peak / sum(r["seconds"] for r in recs)


def _span_roofline(ctx: dict, span: str, classes: tuple[str, ...]) -> float | None:
    recs = [r for r in traced(ctx) if r["trace"]["spans"].get(span, 0.0) > 0]
    if not recs:
        return None
    bound = sum(work_cost(ctx["config"], r["work"]).get(c, [0.0, 0.0])[1] for r in recs for c in classes)
    return 100.0 * bound / sum(r["trace"]["spans"][span] for r in recs)


def linears_roofline(ctx):
    """100 x the DiT linears' bound (over their calls, max(ops / peak, bytes /
    HBM)) over the device seconds of the kernels inside the bench::linear ranges."""
    return _span_roofline(ctx, "linear", ("linear.bf16", "linear.int8"))


def attention_roofline(ctx):
    """100 x the DiT attention's bound (QK^T and PV over the real tokens; q,
    k, v, o moved once) over the device seconds inside the bench::attention ranges."""
    return _span_roofline(ctx, "attention", ("attention",))


def device_idle(ctx):
    """100 x (1 - device busy / traced window) over the traced queries."""
    recs = traced(ctx)
    window = sum(r["trace"]["window_s"] for r in recs)
    if not window:
        return None
    return 100.0 * (1.0 - sum(r["trace"]["busy_s"] for r in recs) / window)


def device_idle_timed(ctx):
    """100 x (1 - device busy of the traced queries / the window's mean
    seconds of queries of their shapes): the idle share at the pace of the
    untraced queries, without the host time the profiler adds (its kernel
    times taken as the profiler reads them)."""
    pace: dict = {}
    for r in untraced(ctx):
        pace.setdefault(tuple(r["shape"]), []).append(r["seconds"])
    recs = [r for r in traced(ctx) if tuple(r["shape"]) in pace]
    timed = sum(sum(pace[tuple(r["shape"])]) / len(pace[tuple(r["shape"])]) for r in recs)
    if not timed:
        return None
    return 100.0 * (1.0 - sum(r["trace"]["busy_s"] for r in recs) / timed)


def resident_gib(ctx):
    """GiB allocated on the card when the window opens: weights and what the warm-up left."""
    return ctx["resident_bytes"] / 2 ** 30 if ctx["resident_bytes"] else None
