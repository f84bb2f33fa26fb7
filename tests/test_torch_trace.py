"""The port's span and counter recorder (synchformer_tpu_torch/utils/trace.py)
and the spans the predictor, the trainers and the towers open, on the CPU."""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from synchformer_tpu_torch.infer import SyncPredictor
from synchformer_tpu_torch.models.presets import TINY, build_tiny_avclip, build_tiny_synchformer
from synchformer_tpu_torch.ops.video import patchify_frames
from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
from synchformer_tpu_torch.train.stage_sync import SyncTrainer
from synchformer_tpu_torch.utils import trace
from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict

B, S = 2, 2
STEP_PHASES = ["step.prepare", "step.forward", "step.backward", "step.update",
               "step.metrics_sync"]


class FakeEvent:
    """torch.cuda.Event's timing surface, for the CPU: counts what is made
    and recorded."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.at = None

    def record(self):
        self.at = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


@pytest.fixture
def fake_events(monkeypatch):
    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    return FakeEvent


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def ancestors(records, r):
    ids = {x["id"]: x for x in records}
    names = []
    while r["parent"] is not None:
        r = ids[r["parent"]]
        names.append(r["name"])
    return names


def test_off_records_nothing(fake_events):
    """Neither the profiler nor recording(): span returns the shared no-op
    object, makes no CUDA event and no record, and count adds nothing."""
    assert not torch.autograd._profiler_enabled()
    with trace.recording():
        with trace.span("before", unit=0):
            pass
    before = trace.spans()
    made = fake_events.made
    s = trace.span("x", unit=1, device="cuda", k=1)
    assert s is trace.NOOP and trace.span("y") is trace.NOOP
    with s:
        with trace.span("z", device="cuda"):
            trace.count("host_syncs", 3)
    assert fake_events.made == made
    assert trace.spans() == before and trace.counts("host_syncs") == {}


def test_nesting_units_and_attributes(fake_events):
    """Parents from the thread's stack, the unit from the root, attributes
    kept, children inside their parent's interval; stream ms from a CUDA
    event pair where the root's device is CUDA, none on the CPU; a thread
    with no open span nests under the unit's innermost open span (as
    autograd's device thread does in a backward); counters by unit."""
    with trace.recording():
        with trace.span("step", unit=7, device="cpu", kind="train"):
            with trace.span("step.forward"):
                with trace.span("block", layer=0):
                    trace.count("host_syncs")
            with trace.span("step.backward"):
                t = threading.Thread(target=lambda: trace.span("block").__enter__().__exit__())
                t.start()
                t.join(10)
                assert not t.is_alive()
            trace.count("host_syncs", 4)
        with trace.span("predict", unit=3, device="cuda"):
            with trace.span("predict.h2d"):
                pass
    recs = trace.spans()
    assert [r["name"] for r in recs] == ["step", "step.forward", "block", "step.backward",
                                         "block", "predict", "predict.h2d"]
    assert [r["parent"] for r in recs] == [None, 0, 1, 0, 3, None, 5]
    assert [r["unit"] for r in recs] == [7] * 5 + [3, 3]
    assert recs[0]["attrs"] == {"kind": "train"} and recs[2]["attrs"] == {"layer": 0}
    for r in recs:
        assert r["start_us"] <= r["end_us"]
        if r["parent"] is not None:
            p = recs[r["parent"]]
            assert p["start_us"] <= r["start_us"] and r["end_us"] <= p["end_us"]
    assert [r["stream_ms"] is None for r in recs] == [True] * 5 + [False, False]
    assert fake_events.made == 4 and recs[5]["stream_ms"] >= recs[6]["stream_ms"] >= 0
    assert trace.counts("host_syncs") == {7: 5}
    assert trace.spans() == recs  # reading does not clear


def test_sessions_and_cap(monkeypatch):
    """Each recording() starts a new record; spans past MAX_SPANS are
    counted as dropped, their children parented to no dropped span."""
    with trace.recording():
        with trace.span("a", unit=0):
            pass
    with trace.recording():
        with trace.span("b", unit=0):
            pass
    assert [r["name"] for r in trace.spans()] == ["b"]
    monkeypatch.setattr(trace, "MAX_SPANS", 2)
    with trace.recording():
        with trace.span("r", unit=0):
            with trace.span("c"):
                with trace.span("d"):
                    with trace.span("e"):
                        pass
    assert [(r["name"], r["parent"]) for r in trace.spans()] == [("r", None), ("c", 0)]
    assert trace.dropped() == 2


def kineto_host_events(prof):
    return [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()]


def test_shared_clock_under_profiler():
    """Under torch.profiler (no recording()) the spans record, and a span's
    interval, converted to the profiler's clock, holds the kineto aten
    events of the ops run inside it and none of those run outside; no span
    is a record_function range. A unit opened with the profiler off ends the
    session: the next profiled run is a new record."""
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.sub(x, 1.0)
        time.sleep(0.003)
        with trace.span("step", unit=0):
            time.sleep(0.003)
            torch.mul(x, 2.0)
            torch.matmul(x, x)
            time.sleep(0.003)
        time.sleep(0.003)
        torch.div(x, 3.0)
    span = trace.spans()[-1]
    assert span["name"] == "step"
    events = kineto_host_events(prof)
    inside = [e for e in events if e[0] in ("aten::mul", "aten::matmul")]
    outside = [e for e in events if e[0] in ("aten::sub", "aten::div")]
    assert len(inside) == 2 and len(outside) == 2
    assert all(span["start_us"] <= s and e <= span["end_us"] for _, s, e in inside)
    assert all(e < span["start_us"] or s > span["end_us"] for _, s, e in outside)
    assert not any(name == "step" for name, _, _ in events)
    with trace.span("step", unit=1):  # profiler off: the session is over
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("step", unit=2):
            pass
    assert [(r["name"], r["unit"]) for r in trace.spans()] == [("step", 2)]


def sync_cfg() -> dict:
    return {"action": "train_avsync_model",
            "training": {"use_half_precision": False, "seed": 0, "base_learning_rate": 1e-3,
                         "lr_scheduler": {"name": "constant_with_warmup", "warmup": 2},
                         "optimizer": {"name": "adam"}},
            "data": {"n_segments": S, "p_horizontal_flip": 0.5}}


def loader_batch(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"video": rng.integers(0, 256, (B, S, 2 * TINY["temporal_resolution"],
                                           TINY["img_size"], TINY["img_size"], 3),
                                  dtype=np.uint8),
            "audio": (rng.standard_normal((B, S, 10240)) * 0.1).astype(np.float32),
            "offset_target": np.array([3, 17])}


def check_step(trainer, batch, unit: int, heads: int):
    """One train step inside recording(): each step.* span once under the
    step of its unit, the towers and the head under step.forward, blocks,
    norms, attentions and MLPs under the towers, and host_syncs 4 (the
    metrics read to the host; on the CPU no copy blocks)."""
    with trace.recording():
        trainer.train_step(batch)
    recs = trace.spans()
    names = by_name(recs)
    assert len(names["step"]) == 1 and names["step"][0]["unit"] == unit
    assert {r["unit"] for r in recs} == {unit}
    for phase in STEP_PHASES:
        assert len(names[phase]) == 1 and ancestors(recs, names[phase][0]) == ["step"]
    for tower in ("model.video_tower", "model.audio_tower"):
        assert [ancestors(recs, r) for r in names[tower]] == [["step.forward", "step"]]
    assert len(names["model.head"]) == heads
    assert ancestors(recs, names["model.head"][0]) == ["step.forward", "step"]
    for kind in ("block", "norm", "attn", "mlp"):
        assert names[kind]
        for r in names[kind]:
            above = ancestors(recs, r)
            assert above[-2:] == ["step.forward", "step"]
            assert {"model.video_tower", "model.audio_tower", "model.head"} & set(above)
    assert trace.counts("host_syncs") == {unit: 4}
    return names


def test_sync_trainer_step_spans():
    """A tiny Stage II step on the plain route: the step's spans, the
    towers' blocks and the offset transformer's under model.head."""
    model = build_tiny_synchformer(S)
    load_numpy_state_dict(model, seeded_state_dict(model, 0))
    tr = SyncTrainer(sync_cfg(), device="cpu", model=model, impl="plain")
    tr.train_step(loader_batch(1))
    names = check_step(tr, loader_batch(), 1, 1)
    recs = trace.spans()
    pooled = [r for r in names["block"] if "pool" in ancestors(recs, r)]
    assert len(names["block"]) - len(pooled) == 2 * TINY["depth"] + TINY["n_layer"]
    assert len(names["pool"]) == len(pooled) == 2  # off K4, each pool a pre-LN block


def test_avclip_trainer_step_spans():
    """A tiny Stage I step on the plain route: the step's spans, the InfoNCE
    loss as model.head."""
    tr = AVCLIPTrainer({"training": {"seed": 0}}, device="cpu", model=build_tiny_avclip(),
                       impl="plain")
    batch = loader_batch()
    batch.pop("offset_target")
    names = check_step(tr, batch, 0, 1)
    recs = trace.spans()
    assert len([r for r in names["block"] if "pool" not in ancestors(recs, r)]) == \
        2 * TINY["depth"]


def test_predictor_spans():
    """A tiny SyncPredictor call: predict (unit = the call's index) with
    predict.h2d, predict.frontend, both towers and the head under it; no
    host sync counted on the CPU."""
    model = build_tiny_synchformer(S)
    load_numpy_state_dict(model, seeded_state_dict(model, 0))
    pred = SyncPredictor(model, "cpu", torch.float32, "plain")
    batch = loader_batch()
    video = torch.from_numpy(patchify_frames(batch["video"], 2, TINY["patch_size"]).copy())
    pcm = torch.from_numpy(batch["audio"])
    pred(video, pcm)
    with trace.recording():
        probs = pred(video, pcm)
    assert probs.shape == (B, 21)
    recs = trace.spans()
    names = by_name(recs)
    assert [(r["name"], r["unit"]) for r in recs[:3]] == [
        ("predict", 1), ("predict.h2d", 1), ("predict.frontend", 1)]
    for name in ("predict.h2d", "predict.frontend", "model.video_tower", "model.audio_tower",
                 "model.head"):
        assert [ancestors(recs, r) for r in names[name]] == [["predict"]]
    assert all(ancestors(recs, r)[-1] == "predict" for r in recs[1:])
    assert trace.counts("host_syncs") == {}
