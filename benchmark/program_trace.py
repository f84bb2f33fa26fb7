"""What the metrics of the program's own spans and counters read: the
record of ``synchformer_tpu_torch/utils/trace.py`` over the traced units
(torch.profiler, which the tracer runs over them, turns the recorder on),
its spans on the profiler's clock beside the trace's kernels and host
operations. A program without the recorder gives None, and the metric is
left out of the line.
"""
from __future__ import annotations

# the step phases in which the host dispatches the model's work
DISPATCH = ("step.forward", "step.backward", "step.update")


def records():
    """The recorder's spans of the traced units, or None (no recorder, or
    nothing recorded)."""
    try:
        from synchformer_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.spans() or None


def stream_ms(ctx, names) -> float:
    """Stream milliseconds a unit in the spans named ``names``."""
    spans = records()
    if spans is None:
        return None
    ms = [r["stream_ms"] for r in spans if r["name"] in names and r["stream_ms"] is not None]
    return ctx.per_unit(sum(ms)) if ms else None


def counter(ctx, name: str) -> float:
    """Counter ``name`` a unit."""
    if records() is None:
        return None
    from synchformer_tpu_torch.utils import trace

    return ctx.per_unit(sum(trace.counts(name).values()))


def device_kernels(trace: dict) -> list:
    """The trace's kernels without the GPU side of user annotations (a
    ``record_function`` range such as torch.optim's ``Optimizer.step#...``):
    an annotation has a host twin of the same name, a kernel never does."""
    host = {name for name, _, _ in trace["host"]}
    return [k for k in trace["kernels"] if k[0] not in host]


def idle_gaps(kernels) -> list:
    """The gaps (start us, end us) between the union of the kernels'
    intervals, from the first kernel's start to the last one's end."""
    gaps, cur_e = [], None
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def innermost(gaps, spans) -> list:
    """For each gap (in time order), the innermost program span open at the
    gap's middle (the latest to start among those open), or None."""
    order = sorted(spans, key=lambda r: (r["start_us"], r["id"]))
    out, active, j = [], [], 0
    for s, e in gaps:
        mid = (s + e) / 2
        while j < len(order) and order[j]["start_us"] <= mid:
            active.append(order[j])
            j += 1
        active = [r for r in active if r["end_us"] >= mid]
        out.append(active[-1] if active else None)
    return out


def phase_of_gaps(gaps, spans) -> list:
    """For each gap (in time order), the name of the ``step.*`` span over the
    innermost span at the gap's middle (itself or an ancestor), or None."""
    by_id = {r["id"]: r for r in spans}
    out = []
    for inner in innermost(gaps, spans):
        while inner is not None and not inner["name"].startswith("step."):
            inner = by_id.get(inner["parent"])
        out.append(None if inner is None else inner["name"])
    return out


def idle_ms(ctx, dispatch: bool) -> float:
    """Device idle milliseconds a unit whose gap's middle falls in a
    dispatch phase (``dispatch``) or elsewhere."""
    spans = records()
    kernels = device_kernels(ctx.trace)
    if spans is None or not kernels:
        return None
    gaps = idle_gaps(kernels)
    phases = phase_of_gaps(gaps, spans)
    us = sum(e - s for (s, e), phase in zip(gaps, phases) if (phase in DISPATCH) == dispatch)
    return ctx.per_unit(us / 1e3)
