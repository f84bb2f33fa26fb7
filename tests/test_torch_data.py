"""The port's data pipeline (synchformer_tpu_torch/data/) against the JAX
package's (synchformer_tpu/data/) on the CPU: the same seeds give the same
items and batches bit for bit; the avstage binding, built into build/avstage,
gives the JAX binding's arrays; StagedLoader keeps order, depth, its
statistics and the producer's errors (tests/test_pipeline.py's contract)."""
import threading
import time

import numpy as np
import pytest
import torch

from synchformer_tpu.data import avstage as javstage
from synchformer_tpu.data import pipeline as jpipe
from synchformer_tpu.data import transforms as jtransforms
from synchformer_tpu.data.datasets import SyntheticAV as JSyntheticAV
from synchformer_tpu_torch.data import avstage, pipeline, transforms
from synchformer_tpu_torch.data.datasets import SyntheticAV
from synchformer_tpu_torch.registry import get_registered

# tests/test_trainer.py's tiny geometry: 3 segments of 4 frames, 16 px, 1 s
PIPE = dict(n_segments=3, crop_len_sec=1.0, input_size=16, segment_size_vframes=4,
            audio_jitter_sec=0.0)


def assert_same_batch(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("split,kw", [
    ("train", dict(p_audio_aug=0.2, audio_jitter_sec=0.05, sometimes_upscale_p=0.5,
                   smaller_input_size=48)),
    ("valid", {}),
    ("train", dict(for_syncability=True, audio_jitter_sec=0.05)),
    ("test", dict(offset_type="uniform_binary", prob_oos=0.3)),
])
def test_prepare_item_matches_jax(split, kw):
    rng = np.random.default_rng(0)
    video = rng.integers(0, 255, (250, 64, 64, 3), dtype=np.uint8)
    audio = rng.standard_normal(160_000).astype(np.float32)
    cfg = dict(n_segments=14, input_size=48, size_before_crop=64, **kw)
    for seed in range(3):
        want = jtransforms.prepare_item(video, audio, jtransforms.SyncPipelineConfig(**cfg),
                                        np.random.default_rng(seed), split)
        got = transforms.prepare_item(video, audio, transforms.SyncPipelineConfig(**cfg),
                                      np.random.default_rng(seed), split)
        assert_same_batch(got, want)
    assert ("audio_full" in got) == (split == "train" and kw.get("p_audio_aug", 0) > 0)


@pytest.mark.parametrize("split,kw", [("train", dict(p_audio_aug=0.2)),
                                      ("valid", dict(shuffle=False, drop_last=False))])
def test_loader_batches_match_jax(split, kw):
    """One epoch of SyntheticAV (7 clips, batch 2: train drops the tail, eval
    pads it with pad_mask) and a second epoch's reshuffle, from the same
    seed, through both loaders."""
    p_aug = kw.pop("p_audio_aug", 0.0)
    cfg = dict(PIPE, p_audio_aug=p_aug)
    loaders = [mod.SyncDataLoader(ds_cls(split, n_clips=7), mod_t.SyncPipelineConfig(**cfg), 2,
                                  num_workers=2, seed=5, decode_backend="synthetic", **kw)
               for mod, mod_t, ds_cls in ((jpipe, jtransforms, JSyntheticAV),
                                          (pipeline, transforms, SyntheticAV))]
    assert len(loaders[0]) == len(loaders[1])
    for epoch in (0, 1):
        for loader in loaders:
            loader.set_epoch(epoch)
        want, got = list(loaders[0]), list(loaders[1])
        assert len(got) == len(want) == (3 if split == "train" else 4)
        for g, w in zip(got, want):
            assert_same_batch(g, w)
    assert ("audio_full" in got[0]) == (p_aug > 0)


def test_epoch_sampler_matches_jax():
    for n, procs, shuffle, drop_last in ((103, 4, True, True), (10, 3, False, False),
                                         (10, 3, True, False), (8, 1, True, True)):
        for i in range(procs):
            args = (n, shuffle, 7, i, procs, drop_last)
            for epoch in (0, 3):
                np.testing.assert_array_equal(pipeline.EpochSampler(*args).indices(epoch),
                                              jpipe.EpochSampler(*args).indices(epoch))
    idx = np.concatenate([pipeline.EpochSampler(103, True, 7, i, 4).indices(3)
                          for i in range(4)])
    assert len(idx) == len(set(idx.tolist())) == 100


def test_avstage_binding_matches_jax(monkeypatch):
    """The port's library (built into build/avstage) and its numpy versions
    give the JAX binding's arrays."""
    rng = np.random.default_rng(1)
    video = rng.integers(0, 255, (40, 32, 48, 3), dtype=np.uint8)
    starts = np.array([0, 8, 20], dtype=np.int64)
    audio = rng.standard_normal(5_000).astype(np.float32)
    frames = rng.integers(0, 255, (2, 4, 32, 32, 3), dtype=np.uint8)
    pcm = rng.integers(-32768, 32767, 600, dtype=np.int16)

    def run(mod):
        return [mod.gather_video_segments(video, starts, 16, (4, 6), (24, 24)),
                mod.gather_audio_segments(audio, starts * 100, 640),
                mod.patchify_u8(frames, 2, 16), mod.pcm16_to_f32(pcm),
                mod.pcm16_to_f32(pcm, channels=2)]

    want = run(javstage)
    assert avstage.available()
    assert avstage._LIB_PATH.parent.name == "avstage" and "build" in avstage._LIB_PATH.parts
    for got, w in zip(run(avstage), want):
        np.testing.assert_array_equal(got, w)
    monkeypatch.setattr(avstage, "_LIB", None)
    monkeypatch.setattr(avstage, "_load", lambda: None)
    for got, w in zip(run(avstage), want):
        np.testing.assert_array_equal(got, w)


def test_avstage_refuses_a_stale_library(tmp_path, monkeypatch):
    """A library without avstage_patchify_u8 is not bound: with building
    off the functions take their numpy route; with building on it is
    rebuilt in place and bound."""
    import subprocess

    src = tmp_path / "stale.cpp"
    src.write_text('extern "C" int avstage_hw_threads() { return 1; }\n')
    stale = tmp_path / "libavstage.so"
    subprocess.check_call(["g++", "-shared", "-fPIC", "-o", str(stale), str(src)])
    monkeypatch.setattr(avstage, "_LIB_PATH", stale)
    monkeypatch.setattr(avstage, "_LIB", None)
    monkeypatch.setenv("SYNCHFORMER_BUILD_AVSTAGE", "0")
    assert avstage._open(stale) is None and not avstage.available()
    frames = np.arange(2 * 32 * 32 * 3, dtype=np.uint8).reshape(2, 32, 32, 3)
    np.testing.assert_array_equal(avstage.patchify_u8(frames), javstage.patchify_u8(frames))
    monkeypatch.setenv("SYNCHFORMER_BUILD_AVSTAGE", "1")
    assert avstage.available() and hasattr(avstage._load(), "avstage_patchify_u8")


def test_datasets_registered_under_jax_and_reference_names():
    from synchformer_tpu_torch.data import datasets

    assert get_registered("synchformer_tpu.data.datasets.SyntheticAV") is datasets.SyntheticAV
    assert get_registered("dataset.vggsound.VGGSound") is datasets.VGGSound
    assert get_registered("synchformer_tpu.data.datasets.AudioSet") is datasets.AudioSet
    assert get_registered("dataset.lrs.LRS3") is datasets.LRS3


def test_ingest_noncanonical_matches_jax():
    rng = np.random.default_rng(2)
    video = rng.integers(0, 255, (30, 24, 40, 3), dtype=np.uint8)
    audio = rng.standard_normal(22_050).astype(np.float32)
    kw = dict(target_vfps=25.0, target_afps=16_000, new_h=32, new_w=32)
    jv, ja = jtransforms.ingest_noncanonical(video, audio, 30.0, 22_050, **kw)
    v, a = transforms.ingest_noncanonical(video, audio, 30.0, 22_050, **kw)
    np.testing.assert_array_equal(v, jv)
    assert a.shape == ja.shape and a.dtype == np.float32
    np.testing.assert_allclose(a, ja, rtol=0, atol=1e-6 * np.abs(ja).max())


class StubLoader:
    def __init__(self, batches):
        self.batches = batches
        self.epoch = None

    def set_epoch(self, e):
        self.epoch = e

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def test_staged_loader_order_depth_and_stats():
    """Device keys arrive as tensors on the device (here the CPU), other
    keys untouched, in order; the stager runs at most ``depth`` batches
    ahead of a slow consumer; the statistics accumulate and reset; the
    source batches are not mutated."""
    batches = [{"video": np.full((2, 3), i, np.uint8), "audio": np.ones((2, 4), np.float32),
                "audio_full": np.zeros((2, 8), np.float32), "index": np.arange(2) + i}
               for i in range(5)]
    produced = []

    class Counting(StubLoader):
        def __iter__(self):
            for b in self.batches:
                produced.append(len(produced))
                yield b

    stub = Counting(batches)
    staged = pipeline.StagedLoader(stub, depth=2)
    staged.set_epoch(3)
    assert stub.epoch == 3 and len(staged) == 5
    seen = []
    for i, b in enumerate(staged):
        assert isinstance(b["video"], torch.Tensor) and b["video"].device.type == "cpu"
        assert isinstance(b["audio_full"], torch.Tensor)
        assert isinstance(b["index"], np.ndarray)
        time.sleep(0.05)  # slow consumer: the stager fills its slots meanwhile
        # consumed i + 1, at most depth in the queue and one in the stager's hand
        assert len(produced) <= i + 1 + 2 + 1
        seen.append(int(b["video"][0, 0]))
    assert seen == [0, 1, 2, 3, 4]
    assert staged.h2d_bytes == sum(b["video"].nbytes + b["audio"].nbytes
                                   + b["audio_full"].nbytes for b in batches)
    assert staged.h2d_s > 0
    staged.reset_stats()
    assert staged.h2d_s == 0.0 and staged.h2d_bytes == 0
    assert isinstance(batches[0]["video"], np.ndarray)


def test_staged_loader_propagates_errors_and_runs_host_transform():
    class Bad:
        def __iter__(self):
            yield {"video": np.zeros((1,), np.uint8)}
            raise RuntimeError("decode exploded")

    with pytest.raises(RuntimeError, match="decode exploded"):
        for _ in pipeline.StagedLoader(Bad(), depth=1):
            pass

    def xf(b):
        b["video"] = b["video"].reshape(2, 8) + 1
        return b

    got = list(pipeline.StagedLoader(StubLoader([{"video": np.full((4, 4), i, np.uint8)}
                                                 for i in range(3)]), depth=2,
                                     host_transform=xf))
    assert [tuple(b["video"].shape) for b in got] == [(2, 8)] * 3
    assert torch.equal(got[0]["video"], torch.full((2, 8), 1, dtype=torch.uint8))


def test_staged_loader_stops_its_thread_when_the_consumer_stops():
    before = threading.active_count()
    it = iter(pipeline.StagedLoader(StubLoader([{"video": np.zeros(2)}] * 50), depth=1))
    next(it)
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_batch_to_device_and_throughput():
    batch = {"video": np.zeros((2, 3), np.uint8), "audio": np.ones((2, 5), np.float32),
             "offset_target": np.array([1, 2])}
    out = pipeline.batch_to_device(batch, "cpu")
    assert isinstance(out["video"], torch.Tensor) and isinstance(out["offset_target"], np.ndarray)
    batches = [dict(batch, pad_mask=np.array([True, i < 2])) for i in range(3)]
    stats = pipeline.measure_pipeline_throughput(StubLoader(batches), lambda b: None, epochs=2)
    assert stats["clips"] == 2 * (2 + 2 + 1)
    assert stats["clips_per_sec"] > 0 and 0.0 <= stats["host_wait_frac"] <= 1.0
