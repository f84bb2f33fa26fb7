"""The port's fit loop, checkpoints and entry point at world 2 on the CPU
(gloo): Stage I fit over two ranks with a resume (tests/torch_dist_worker.py
suite 'fit'), a resume of that run at world 1, and ``python -m
synchformer_tpu_torch.main`` in two processes under torchrun's environment.

The model is tests/test_stage_clip.py's TINY_AVCLIP_CFG (D 32, S 4, f32) at
p_audio_aug 0.2 and a global batch of 4 (2 a rank) over SyntheticAV, 8 train
and 4 valid clips. A resume at the same world size continues bit for bit on
every rank (parameters, optimizer state, step and both generators, equal to
the uninterrupted run's); only rank 0 writes checkpoints; a run without
exp_name gets rank 0's directory name on both ranks. Each group has a 60 s
timeout and each spawn 110 s; the two groups run at once.
"""
import copy
import json
import logging
import os
import sys

import pytest
import torch
import torch_dist_worker as worker
from test_stage_clip import TINY_AVCLIP_CFG

from synchformer_tpu_torch.parallel import dist as pdist
from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
from synchformer_tpu_torch.utils.logger import EarlyStopper

torch.set_num_threads(2)

WORLD = 2


def fit_cfg(logdir) -> dict:
    cfg = copy.deepcopy(TINY_AVCLIP_CFG)
    cfg["data"]["p_audio_aug"] = 0.2
    cfg["training"].update(base_batch_size=4)
    cfg["logging"] = dict(logdir=str(logdir), exp_name=None, log_code_state=False,
                          log_frequency=1)
    return cfg


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The fit suite's group and the entry point's, run at once."""
    workdir = tmp_path_factory.mktemp("dist_fit")
    cli_logs = tmp_path_factory.mktemp("dist_cli")
    torch.save({"fit_cfg": fit_cfg(workdir / "runs")}, workdir / "inputs.pt")
    fit = worker.spawn_suite("fit", workdir, WORLD)
    cli = worker.spawn(lambda r: [
        sys.executable, "-m", "synchformer_tpu_torch.main",
        "config=synchformer_tpu/config/configs/smoke.yaml", "device=cpu",
        "training.num_epochs=1", "training.num_workers=1", "data.dataset.params.n_clips=8",
        f"logging.logdir={cli_logs}"], WORLD)
    outs = {"fit": worker.wait(fit), "cli": worker.wait(cli)}
    return dict(workdir=workdir, cli_logs=cli_logs, outs=outs,
                ranks=worker.results(workdir, "fit", WORLD) if all(
                    code == 0 for code, _, _ in outs["fit"]) else None)


def test_fit_resume_at_world_2_is_bit_identical(groups):
    """Run a (1 epoch) resumed to 2 epochs equals run c (2 epochs straight) on
    each rank: parameters, optimizer state, step, both generators; the ranks
    hold the same parameters and different generator streams."""
    for r, (code, _, err) in enumerate(groups["outs"]["fit"]):
        assert code == 0, f"rank {r}: {err[-3000:]}"
    for res in groups["ranks"]:
        got, want = res["checkpoint_case"]["resumed"], res["checkpoint_case"]["straight"]
        assert got["step"] == want["step"] == 4
        for k in want["model"]:
            assert torch.equal(got["model"][k], want["model"][k]), k
        for i, state in want["opt"]["state"].items():
            for k, v in state.items():
                assert torch.equal(torch.as_tensor(got["opt"]["state"][i][k]),
                                   torch.as_tensor(v)), (i, k)
        assert all(torch.equal(a, b) for a, b in zip(got["gens"], want["gens"]))
    r0, r1 = (res["checkpoint_case"]["straight"] for res in groups["ranks"])
    assert all(torch.equal(r0["model"][k], r1["model"][k]) for k in r0["model"])
    assert not torch.equal(r0["gens"][0], r1["gens"][0])


def test_only_rank_0_writes_and_names_the_run(groups):
    """Rank 0's CheckpointManager writes (latest every epoch, best on an
    improvement), rank 1's none; the run without exp_name has one directory,
    rank 0's name, on both ranks."""
    c0, c1 = (res["checkpoint_case"] for res in groups["ranks"])
    assert c1["writes"] == []
    assert ("latest", 0) in c0["writes"] and ("latest", 1) in c0["writes"]
    assert c0["unnamed"] == c1["unnamed"]
    runs = sorted(os.listdir(groups["workdir"] / "runs"))
    assert len(runs) == 3 and {"a", "c"} < set(runs)
    assert os.path.basename(c0["unnamed"]) in runs


def test_resume_at_world_1_restores_parameters_and_reseeds(groups, caplog):
    """The world-2 run resumed by one process: parameters and step restored;
    the generators re-seeded from the seed, the epoch and rank 0, with a
    warning."""
    cfg = fit_cfg(groups["workdir"] / "runs")
    cfg["logging"]["exp_name"] = "a"
    cfg["training"]["resume"] = "latest"
    tr = AVCLIPTrainer(cfg, device="cpu")
    tr.open_run()
    with caplog.at_level(logging.WARNING):
        assert tr.resume(EarlyStopper(20)) == 2
    assert "re-seeded" in caplog.text
    want = groups["ranks"][0]["checkpoint_case"]["resumed"]
    assert tr.step == want["step"]
    assert all(torch.equal(v, want["model"][k]) for k, v in tr.model.state_dict().items())
    seed = cfg["training"]["seed"]
    assert torch.equal(tr.generator.get_state(),
                       torch.Generator().manual_seed(pdist.stream_seed(seed, 0, 2)).get_state())
    assert torch.equal(tr.aug_generator.get_state(), torch.Generator().manual_seed(
        pdist.stream_seed(seed + 7, 0, 2)).get_state())
    tr.logger.close()


def test_main_under_the_launcher_env_at_world_2(groups):
    """python -m synchformer_tpu_torch.main on smoke.yaml (Stage II, global
    batch 8) in two processes with torchrun's variables and device=cpu: both
    exit 0; one run directory with one checkpoint set and the test results."""
    for r, (code, _, err) in enumerate(groups["outs"]["cli"]):
        assert code == 0, f"rank {r}: {err[-3000:]}"
    runs = os.listdir(groups["cli_logs"])
    assert len(runs) == 1
    run = groups["cli_logs"] / runs[0]
    assert sorted(os.listdir(run / "ckpts" / "latest")) == ["0.json", "0.pt"]
    with open(run / "test_results.json") as f:
        assert 0.0 <= json.load(f)["accuracy_1"] <= 1.0
    with open(run / "cfg.yaml") as f:
        assert "base_batch_size: 8" in f.read()
