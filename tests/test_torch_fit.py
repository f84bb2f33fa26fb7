"""The port's training entry point on the CPU: the fit loops of AVCLIPTrainer
(Stage I, with the audio augmentations at p_audio_aug 0.2) and SyncTrainer
(Stage II / III), their checkpoint store, early stopping and resume, and
``python -m synchformer_tpu_torch.main``.

The models are the JAX package's tiny test configs (tests/test_trainer.py's
TINY_CFG, the smoke.yaml model; tests/test_stage_clip.py's
TINY_AVCLIP_CFG) over SyntheticAV. ``fit`` is tied to the JAX package
through the step: its per-step losses equal, bit for bit, a loop of the
trainer's train_step (held against the JAX steps in
tests/test_torch_train.py and tests/test_torch_sync_train.py) over the same
loader batches. A run resumed after 2 epochs to 4 equals 4 epochs
uninterrupted bit for bit: parameters, optimizer state, step and the
generators. CheckpointManager and EarlyStopper hold to the JAX ones'
semantics (tests/test_checkpoint_manager.py).
"""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_stage_clip import TINY_AVCLIP_CFG
from test_trainer import TINY_CFG

from synchformer_tpu_torch.data.datasets import SyntheticAV
from synchformer_tpu_torch.data.pipeline import SyncDataLoader
from synchformer_tpu_torch.ops.dsp import AUG_CHAIN
from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
from synchformer_tpu_torch.train.stage_sync import SyncTrainer
from synchformer_tpu_torch.utils.checkpoint import CheckpointManager, load_stage1_tower
from synchformer_tpu_torch.utils.logger import EarlyStopper

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TELEMETRY = {"train/data_time", "train/batch_time", "train/samples_per_s", "train/lr",
             "train/loss_iter"}


def scalars(logdir) -> list:
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def store_files(ckpts, store: str) -> list:
    return sorted(os.listdir(os.path.join(ckpts, store)))


def stage1_cfg(logdir, exp: str, **training) -> dict:
    """TINY_AVCLIP_CFG (AVCLIP, D 32, S 4, f32) at p_audio_aug 0.2, B=4,
    telemetry every step."""
    cfg = copy.deepcopy(TINY_AVCLIP_CFG)
    cfg["data"]["p_audio_aug"] = 0.2
    cfg["training"].update(base_batch_size=4, **training)
    cfg["logging"] = dict(logdir=str(logdir), exp_name=exp, log_code_state=False,
                          log_frequency=1)
    return cfg


def stage1_fit(cfg, epochs: int) -> AVCLIPTrainer:
    tr = AVCLIPTrainer(cfg, device="cpu")
    tr.fit(SyntheticAV("train", n_clips=8), SyntheticAV("valid", n_clips=4), num_workers=2,
           max_epochs=epochs, decode_backend="synthetic")
    return tr


def snapshot(tr) -> dict:
    """What a resume must reproduce: parameters, optimizer state, step,
    generators."""
    return {"model": {k: v.clone() for k, v in tr.model.state_dict().items()},
            "opt": copy.deepcopy(tr.optimizer.state_dict()), "step": tr.step,
            "gens": (tr.generator.get_state(), tr.aug_generator.get_state())}


def assert_same_state(a: dict, b: dict) -> None:
    assert a["step"] == b["step"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["opt"]["state"], b["opt"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k])), (i, k)
    assert all(torch.equal(x, y) for x, y in zip(a["gens"], b["gens"]))


@pytest.fixture(scope="module")
def stage1_run(tmp_path_factory):
    """Two epochs of the tiny AVCLIP at p_audio_aug 0.2 (8 clips, B=4: 2
    steps an epoch), with what its run directory held right after."""
    logdir = tmp_path_factory.mktemp("stage1")
    cfg = stage1_cfg(logdir, "a")
    tr = stage1_fit(cfg, 2)
    run = tr.logdir
    files = {s: store_files(run / "ckpts", s) for s in ("latest", "best")}
    with open(run / "results_valid.jsonl") as f:
        results = [json.loads(line) for line in f]
    return dict(cfg=cfg, logdir=logdir, run=run, trainer=tr, state=snapshot(tr), files=files,
                scalars=scalars(run), results=results)


def test_stage1_fit_with_audio_augs(stage1_run):
    """Step count, the checkpoint stores, results_valid.jsonl, the telemetry
    tags; the augmentations drawn; the run as a Stage I tower source."""
    tr, rows = stage1_run["trainer"], stage1_run["scalars"]
    assert tr.step == 4
    assert stage1_run["files"]["latest"] == ["0.json", "0.pt", "1.json", "1.pt"]
    assert stage1_run["files"]["best"] and tr.ckpt.best_step() in (0, 1)
    assert [r["epoch"] for r in stage1_run["results"]] == [0, 1]
    assert all(np.isfinite(r["precision"]) and np.isfinite(r["loss"])
               for r in stage1_run["results"])
    tags = {r["tag"] for r in rows}
    assert TELEMETRY | {"train/precision_one_batch", "valid/precision", "train/loss"} <= tags
    assert sum(r["tag"] == "train/samples_per_s" for r in rows) == 4
    drawn = {name: sum(r["value"] for r in rows if r["tag"] == f"train/aug_steps_{name}")
             for name in AUG_CHAIN}
    assert drawn == tr.aug_drawn and sum(drawn.values()) > 0
    payload = tr.ckpt.restore_latest()
    assert payload["step"] == 4 and payload["epoch"] == 1
    assert set(payload["generators"]) == {"device", "aug"}
    tower = load_stage1_tower(str(stage1_run["run"]), "visual")
    best = tr.ckpt.restore_best()["trainable"]
    assert torch.equal(tower["cls_token"], best["vfeat_extractor.cls_token"])


def test_stage1_fit_equals_a_train_step_loop(stage1_run):
    """fit's per-step losses (train/loss_iter, logged every step) equal a
    fresh trainer's train_step over the same loader's batches, bit for
    bit, and so do the parameters after them."""
    want = [r["value"] for r in stage1_run["scalars"] if r["tag"] == "train/loss_iter"]
    tr = AVCLIPTrainer(stage1_run["cfg"], device="cpu")
    loader = SyncDataLoader(SyntheticAV("train", n_clips=8), tr.pipe_cfg, tr.batch_size,
                            num_workers=2, seed=tr.seed, decode_backend="synthetic")
    got = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        got += [tr.train_step(batch)["loss"] for batch in loader]
    assert got == want
    assert all(torch.equal(v, stage1_run["state"]["model"][k])
               for k, v in tr.model.state_dict().items())


def test_stage1_resume_is_bit_identical(stage1_run):
    """2 epochs, then a new trainer resuming 'latest' to 4, equals 4 epochs
    uninterrupted: parameters, optimizer state, step, generators."""
    logdir = stage1_run["logdir"]
    resumed = AVCLIPTrainer(stage1_cfg(logdir, "a", resume="latest"), device="cpu")
    resumed.open_run()
    assert resumed.resume(EarlyStopper(20)) == 2
    assert_same_state(snapshot(resumed), stage1_run["state"])
    resumed.fit(SyntheticAV("train", n_clips=8), SyntheticAV("valid", n_clips=4),
                num_workers=2, max_epochs=4, decode_backend="synthetic")
    straight = stage1_fit(stage1_cfg(logdir, "b"), 4)
    assert resumed.step == straight.step == 8
    assert_same_state(snapshot(resumed), snapshot(straight))
    assert resumed.ckpt.latest_step() == 3


def stage2_cfg(logdir, exp: str, **training) -> dict:
    """TINY_CFG with telemetry every step, early stopping on mROCAUC: the
    stopper starts at 0 (the reference's), and a random tiny model's
    accuracy_1 on 8 clips is often 0 every epoch, so that no best would be
    saved; mROCAUC is above 0 (0.5 where a class is missing)."""
    cfg = copy.deepcopy(TINY_CFG)
    cfg["training"].update(metric_name="mROCAUC", **training)
    cfg["logging"] = dict(logdir=str(logdir), exp_name=exp, log_code_state=False,
                          log_frequency=1)
    return cfg


@pytest.fixture(scope="module")
def stage2_run(tmp_path_factory):
    logdir = tmp_path_factory.mktemp("stage2")
    tr = SyncTrainer(stage2_cfg(logdir, "s2", trace=True), device="cpu")
    results = tr.fit(SyntheticAV("train", n_clips=16), SyntheticAV("valid", n_clips=8),
                     SyntheticAV("test", n_clips=8), num_workers=2, max_epochs=2,
                     decode_backend="synthetic")
    return dict(logdir=logdir, trainer=tr, results=results)


def test_stage2_fit_end_to_end(stage2_run):
    """tests/test_trainer.py::test_sync_trainer_end_to_end's checks on the
    port: steps, both stores, results_valid.jsonl, test_results.json, the
    telemetry tags once per step; training.trace's profile of epoch 0 and
    the port's spans of its steps beside it."""
    tr, results = stage2_run["trainer"], stage2_run["results"]
    run = tr.logdir
    assert tr.step == 4  # 16 clips / bs 8 = 2 steps x 2 epochs
    assert "best_valid" in results and 0.0 <= results["test"]["accuracy_1"] <= 1.0
    assert store_files(run / "ckpts", "latest") == ["0.json", "0.pt", "1.json", "1.pt"]
    assert tr.ckpt.best_step() is not None
    with open(run / "results_valid.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]
    with open(run / "test_results.json") as f:
        assert json.load(f)["accuracy_1"] == results["test"]["accuracy_1"]
    rows = scalars(run)
    assert TELEMETRY <= {r["tag"] for r in rows}
    assert sum(r["tag"] == "train/samples_per_s" for r in rows) == 4
    assert all(r["value"] > 0 for r in rows if r["tag"] == "train/samples_per_s")
    assert sorted(p.name for p in (run / "profile").iterdir()) == ["spans_e0.jsonl",
                                                                    "trace_e0.json"]
    with open(run / "profile" / "spans_e0.jsonl") as f:
        lines = [json.loads(line) for line in f]
    steps = [r for r in lines[:-1] if r["name"] == "step"]
    assert [r["unit"] for r in steps] == [0, 1] and lines[-1]["counts"] == {
        "host_syncs@0": 4, "host_syncs@1": 4}
    payload = tr.ckpt.restore_latest()
    assert set(payload["trainable"]) == set(tr.trainable_state_dict())
    assert not any(k.startswith(("afeat", "vfeat")) for k in payload["trainable"])


def test_stage2_resume_continues_the_run(stage2_run, tmp_path):
    """A resumed Stage II run restores the trainable parameters, optimizer,
    step and generators of its latest checkpoint, and continues epochs 2-3."""
    logdir = stage2_run["logdir"]
    tr = SyncTrainer(stage2_cfg(logdir, "s2", resume=True), device="cpu")
    tr.open_run()
    stopper = EarlyStopper(tr.patience)
    assert tr.maybe_resume(stopper) == 2 and tr.step == 4
    first = stage2_run["trainer"]
    assert_same_state(snapshot(tr), snapshot(first))
    assert stopper.state_dict() == tr.ckpt.restore_latest()["stopper"]


def test_stage3_finetunes_from_stage2_best_through_fit(stage2_run):
    """Stage III (the syncability head) fine-tunes from Stage II's best store
    through fit: the shared parameters come from that checkpoint, the
    counters start again, and the run trains and tests."""
    best = stage2_run["trainer"].ckpt.restore_best()["trainable"]
    cfg = stage2_cfg(stage2_run["logdir"], "s3", finetune=True, num_epochs=1,
                     ckpt_path=str(stage2_run["trainer"].logdir / "ckpts" / "best"))
    cfg["action"] = "ft_avsync_model_for_syncability"
    cfg["model"]["params"]["transformer"]["target"] = \
        "synchformer_tpu.models.sync_model.GlobalTransformerWithSyncabilityHead"
    tr = SyncTrainer(cfg, device="cpu")
    tr.open_run()
    assert tr.maybe_resume(EarlyStopper(5)) == 0 and tr.step == 0
    state = tr.model.state_dict()
    shared = [k for k in best if k in state]
    assert shared and "transformer.off_head.weight" not in state
    assert all(torch.equal(state[k], best[k]) for k in shared)
    results = tr.fit(SyntheticAV("train", n_clips=16), SyntheticAV("valid", n_clips=8),
                     SyntheticAV("test", n_clips=8), num_workers=2,
                     decode_backend="synthetic")
    assert tr.step == 2 and tr.target_key == "sync_target"
    assert {"accuracy_1", "precision", "recall", "f1"} <= set(results["test"])


def test_main_cli_on_smoke_yaml(tmp_path):
    """python -m synchformer_tpu_torch.main on smoke.yaml with device=cpu
    exits 0 and writes its run; without device=cpu and no CUDA it raises."""
    cmd = [sys.executable, "-m", "synchformer_tpu_torch.main",
           "config=synchformer_tpu/config/configs/smoke.yaml", "device=cpu",
           "training.num_epochs=1", "training.num_workers=2", "data.dataset.params.n_clips=8",
           f"logging.logdir={tmp_path}", "logging.exp_name=cli"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = tmp_path / "cli"
    assert store_files(run / "ckpts", "latest") == ["0.json", "0.pt"]
    assert (run / "test_results.json").exists() and (run / "cfg.yaml").exists()
    from synchformer_tpu_torch.main import main

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["config=synchformer_tpu/config/configs/smoke.yaml",
                  f"logging.logdir={tmp_path}"])


def test_checkpoint_manager_round_trip_and_stores(tmp_path):
    """A MoCo trainer's payload (model, optimizer, step, stopper, both
    generators, the momentum model and the queues) after a step round-trips
    through the store into a fresh trainer; latest and best are
    independent, each keeps two, best by best_metric."""
    from test_torch_registry import tiny_model_cfg

    cfg = {"model": tiny_model_cfg(True), "training": {"seed": 0, "precision": "fp32"},
           "data": {"n_segments": 2, "p_audio_aug": 1.0}}
    tr = AVCLIPTrainer(cfg, device="cpu", impl="plain")
    rng = np.random.default_rng(0)
    batch = {"video": rng.integers(0, 256, (2, 2, 4, 32, 32, 3), dtype=np.uint8),
             "audio": (rng.standard_normal((2, 2, 10240)) * 0.1).astype(np.float32)}
    tr.train_step(batch)
    stopper = EarlyStopper(3)
    stopper.update(0.5)
    stopper.update(0.4)
    mngr = CheckpointManager(str(tmp_path / "ckpts"))
    mngr.save_latest(0, tr.payload(0, stopper))
    fresh = AVCLIPTrainer(cfg, device="cpu", impl="plain")
    payload = mngr.restore_latest()
    fresh.load_payload(payload)
    assert_same_state(snapshot(fresh), snapshot(tr))
    assert all(torch.equal(a, b) for a, b in zip(fresh.model_m.state_dict().values(),
                                                 tr.model_m.state_dict().values()))
    for name in ("segment_v", "segment_a", "global_v", "global_a"):
        assert torch.equal(getattr(fresh.queues, name), getattr(tr.queues, name))
    assert fresh.queues.segment_ptr == tr.queues.segment_ptr
    restored = EarlyStopper(3)
    restored.load_state_dict(payload["stopper"])
    assert (restored.best, restored.count) == (0.5, 1)
    # the stores: latest every epoch, best on improvement, two kept each
    mngr = CheckpointManager(str(tmp_path / "stores"))
    for epoch, metric in enumerate((0.2, 0.9, 0.5, 0.95)):
        mngr.save_latest(epoch, {"epoch": epoch})
        if metric in (0.2, 0.9, 0.95):
            mngr.save_best(epoch, {"epoch": epoch}, metrics={"best_metric": metric})
    assert mngr.latest_step() == 3 and mngr.best_step() == 3
    assert store_files(tmp_path / "stores", "latest") == ["2.json", "2.pt", "3.json", "3.pt"]
    assert store_files(tmp_path / "stores", "best") == ["1.json", "1.pt", "3.json", "3.pt"]
    assert mngr.restore_best(1)["epoch"] == 1 and mngr.restore_latest()["epoch"] == 3


def test_interrupted_save_keeps_the_previous_latest(tmp_path, monkeypatch):
    mngr = CheckpointManager(str(tmp_path))
    mngr.save_latest(0, {"x": torch.ones(3)})

    def dies(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise KeyboardInterrupt("killed mid-save")

    monkeypatch.setattr(torch, "save", dies)
    with pytest.raises(KeyboardInterrupt):
        mngr.save_latest(1, {"x": torch.zeros(3)})
    assert mngr.latest_step() == 0
    assert torch.equal(mngr.restore_latest()["x"], torch.ones(3))
    assert store_files(tmp_path, "latest") == ["0.json", "0.pt"]


def test_early_stopper_decisions_match_jax():
    from synchformer_tpu.utils.logger import EarlyStopper as JaxStopper

    seq = [0.0, 0.5, 0.4, 0.5, 0.6, 0.6, 0.55, 0.3, 0.2]
    for to_max in (True, False):
        port, ref = EarlyStopper(3, to_max), JaxStopper(3, to_max)
        for i, m in enumerate(seq):
            assert port.update(m) == ref.update(m)
            assert (port.triggered, port.state_dict()) == (ref.triggered, ref.state_dict())
            if i == 3:
                port2, ref2 = EarlyStopper(3, to_max), JaxStopper(3, to_max)
                port2.load_state_dict(port.state_dict())
                ref2.load_state_dict(ref.state_dict())
                port, ref = port2, ref2
