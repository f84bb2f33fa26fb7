"""The readers of the program's own spans and counters (program_trace.py and
the metrics that use it) on a synthetic trace and record."""
import sys

import pytest

from benchmark import harness

STREAM = ("h2d_ms.offline", "norm_ms.offline", "norm_ms.train", "prepare_ms.train")
NEW = STREAM + ("host_syncs.train", "idle_dispatch_ms.train", "idle_boundary_ms.train")


def span(i, name, parent, start, end, stream_ms=None, unit=0):
    return {"id": i, "name": name, "parent": parent, "unit": unit, "start_us": start,
            "end_us": end, "stream_ms": stream_ms, "attrs": {}}


@pytest.fixture
def recorder(monkeypatch):
    """The recorder's reading functions returning what the test sets."""
    from synchformer_tpu_torch.utils import trace

    state = {"spans": [], "counts": {}}
    monkeypatch.setattr(trace, "spans", lambda: list(state["spans"]))
    monkeypatch.setattr(trace, "counts", lambda name: dict(state["counts"].get(name, {})))
    return state


def ctx(kernels=(), host=(), units=2, window_s=1.0):
    return harness.TraceContext({"kernels": sorted(kernels, key=lambda k: k[1]),
                                 "host": list(host), "calls": [], "spans": {},
                                 "window_s": window_s, "units": units}, 0.0, 1.0)


def test_stream_and_counter_readers(recorder):
    recorder["spans"] = [
        span(0, "predict", None, 0, 100, 90.0), span(1, "predict.h2d", 0, 0, 10, 3.0),
        span(2, "norm", 0, 20, 30, 1.5), span(3, "predict", None, 100, 200, 90.0, unit=1),
        span(4, "predict.h2d", 3, 100, 110, 4.0, unit=1), span(5, "norm", 3, 120, 130, 2.5, 1),
        span(6, "step.prepare", None, 200, 210, 12.0), span(7, "norm", 0, 30, 40)]
    recorder["counts"] = {"host_syncs": {0: 4, 1: 5}}
    c = ctx()
    read = {name: harness.reader(name)(c) for name in NEW}
    assert read["h2d_ms.offline"] == 3.5
    assert read["norm_ms.offline"] == read["norm_ms.train"] == 2.0  # no events: not counted
    assert read["prepare_ms.train"] == 6.0
    assert read["host_syncs.train"] == 4.5


def test_idle_readers_attribute_gaps_to_step_phases(recorder):
    """Gaps between kernels, an annotation's GPU side not busy, each gap put
    down to the step phase over the innermost span at its middle."""
    recorder["spans"] = [
        span(0, "step", None, 0, 95), span(1, "step.forward", 0, 0, 35),
        span(2, "model.video_tower", 1, 5, 34), span(3, "block", 2, 12, 18),
        span(4, "step.update", 0, 35, 55), span(5, "step.metrics_sync", 0, 60, 70)]
    kernels = [("k1", 0, 10), ("Optimizer.step#AdamW.step", 10, 40), ("k2", 20, 30),
               ("k3", 50, 60), ("k4", 70, 80), ("k5", 120, 130)]
    host = [("Optimizer.step#AdamW.step", 36, 50), ("aten::add", 0, 1)]
    c = ctx(kernels, host, units=1, window_s=200e-6)
    dispatch = harness.reader("idle_dispatch_ms.train")(c)
    boundary = harness.reader("idle_boundary_ms.train")(c)
    # [10, 20] in a block of the forward, [30, 50] in the update: 30 us;
    # [60, 70] in metrics_sync, [80, 120] after the step: 50 us
    assert dispatch == pytest.approx(0.030) and boundary == pytest.approx(0.050)
    busy_ms = (10 + 10 + 10 + 10 + 10) / 1e3
    assert dispatch + boundary <= c.trace["window_s"] * 1e3 - busy_ms


def test_no_recorder_reads_nothing(monkeypatch):
    """A program without utils/trace.py (the tree before it): every new
    reader returns None and raises nothing."""
    import synchformer_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "synchformer_tpu_torch.utils.trace", None)
    monkeypatch.delattr(utils, "trace", raising=False)
    c = ctx([("k1", 0, 10), ("k2", 20, 30)], units=1)
    assert all(harness.reader(name)(c) is None for name in NEW)


def test_nothing_recorded_reads_nothing(recorder):
    c = ctx([("k1", 0, 10), ("k2", 20, 30)], units=1)
    assert all(harness.reader(name)(c) is None for name in NEW)
