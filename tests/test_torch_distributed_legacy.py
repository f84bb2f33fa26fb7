"""The legacy towers' BatchNorms at world 2 (two processes of one gloo group
on the CPU, tests/torch_dist_worker.py suite 'legacy') against the port at
world 1 over the whole batch: the statistics are the global batch's
(models/conv.py sums each channel's count, sum and sum of squares over the
data group), so world 2 repeats world 1 but for the order of f32 sums.

- ResNet18AudioFeatures alone under DDP (log-mel (2, 2, 66, 128), one clip
  pair a rank, centred seeded weights): the features, every gradient and
  every running statistic within the f32 tolerances of
  tests/test_torch_legacy_train.py (1e-5 of the largest value; gradients
  2e-5 of their layer's largest), and both ranks' running statistics equal
  bit for bit;
- one Stage II step through SyncTrainer over the legacy Synchformer with
  is_trainable towers (B=2, one a rank; the rate base_learning_rate x 2 at
  world 2, as the JAX trainer's n_data scaling, so world 1 runs at 2 x LR):
  the loss, the gradient norm, every parameter and running statistic after
  it, held by test_torch_legacy_parts.hold_family with world 1's own f32
  spread (world 1 on PERTURB's inputs: the train-mode S3D is ill-conditioned,
  so the order of f32 sums alone moves its gradients by a few percent), and
  both ranks' trainable state equal bit for bit.
"""
import copy

import numpy as np
import pytest
import torch
import torch_dist_worker as worker
from test_torch_legacy_parts import PERTURB, centred, gap, hold_family, jax_vars, value_scales
from test_torch_legacy_train import (
    GRAD_REL,
    REL,
    legacy_trainer_cfg,
    running_stats,
)
from test_torch_sync_train import layer_scale

from synchformer_tpu_torch.models.resnet_audio import ResNet18AudioFeatures
from synchformer_tpu_torch.train.stage_sync import SyncTrainer
from synchformer_tpu_torch.train.step import sync_train_step
from synchformer_tpu_torch.utils import convert
from synchformer_tpu_torch.utils.convert import load_numpy_state_dict

torch.set_num_threads(2)

WORLD = 2


def resnet_sd() -> dict:
    """Centred seeded ResNet-18 weights (the JAX tree's shapes, filled and
    converted as the parity tests do)."""
    import jax.numpy as jnp
    from synchformer_tpu.models.resnet_audio import ResNet18AudioFeatures as JResNet
    from test_torch_legacy_parts import closing_norms

    variables = centred(jax_vars(JResNet(), jnp.zeros((1, 2, 66, 128)),
                                 closing=closing_norms(ResNet18AudioFeatures())))
    return convert.legacy_tower_sd(variables["params"], variables["batch_stats"])


def step_world1(cfg: dict, vis, aud, targets, k: int = 0) -> dict:
    """World 1's step over the whole batch at 2 x the rate, on the inputs
    perturbed by x * (1 + k * 2^-21)."""
    cfg = copy.deepcopy(cfg)
    cfg["training"]["base_learning_rate"] *= WORLD
    tr = SyncTrainer(cfg, device="cpu")
    scale = np.float32(1 + k * 2.0 ** -21)
    m = sync_train_step(tr.net, tr.optimizer, tr.schedule, 0, vis * scale, aud * scale,
                        targets, torch.Generator(), "kernel", tr.max_clip_norm,
                        extractors_deterministic=False)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": {k: v.clone() for k, v in tr.trainable_state_dict().items()}}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dist_legacy")
    rng = np.random.default_rng(21)
    aud = torch.from_numpy(rng.standard_normal((2, 2, 66, 128)).astype(np.float32))
    vis = torch.from_numpy(rng.standard_normal((2, 2, 16, 64, 64, 3)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, 2, 3, 512)).astype(np.float32))
    targets = torch.tensor([3, 17])
    cfg = legacy_trainer_cfg(True)
    cfg["training"]["base_batch_size"] = 2
    sd = resnet_sd()
    torch.save({"resnet_sd": sd, "aud": aud, "cot": cot, "vis": vis, "targets": targets,
                "legacy_cfg": cfg}, workdir / "inputs.pt")
    procs = worker.spawn_suite("legacy", workdir, WORLD)
    try:
        tower = ResNet18AudioFeatures()
        load_numpy_state_dict(tower, sd)
        feats = tower(aud, "kernel", False, torch.Generator())
        (feats * cot).sum().backward()
        bn_tower = {"feats": feats.detach(),
                    "grads": {n: p.grad.clone() for n, p in tower.named_parameters()},
                    "stats": running_stats(tower.state_dict())}
        steps = [step_world1(cfg, vis, aud, targets, k) for k in PERTURB]
    finally:
        outs = worker.wait(procs)
    for r, (code, _, err) in enumerate(outs):
        assert code == 0, f"rank {r}: {err[-3000:]}"
    return dict(bn_tower=bn_tower, steps=steps, ranks=worker.results(workdir, "legacy"))


def test_resnet_tower_at_world_2_equals_world_1(group):
    """ResNet-18 in training under DDP at world 2: each rank's features
    equal world 1's rows of them, every DDP-averaged gradient and every
    running statistic world 1's, and both ranks' running statistics equal
    bit for bit."""
    want = group["bn_tower"]
    ranks = [r["legacy_bn_tower"] for r in group["ranks"]]
    feats = torch.cat([r["feats"] for r in ranks])
    assert gap(feats, want["feats"]) <= REL * float(want["feats"].abs().max())
    grads = {k: v.numpy() for k, v in want["grads"].items()}
    for r in ranks:
        assert sorted(r["grads"]) == sorted(grads)
        for name, g in r["grads"].items():
            bound = GRAD_REL * layer_scale(grads, name) + 1e-8
            assert gap(g, grads[name]) <= bound, (name, gap(g, grads[name]), bound)
        for name, v in r["stats"].items():
            assert gap(v, want["stats"][name]) <= REL * float(want["stats"][name].abs().max())
    assert all(torch.equal(ranks[0]["stats"][k], v) for k, v in ranks[1]["stats"].items())


def test_legacy_sync_step_at_world_2_equals_world_1(group):
    """One Stage II step over the legacy model with is_trainable towers at
    world 2: the loss and gradient norm (mean and global over the ranks),
    every parameter and running statistic after the step against world 1's
    step over the whole batch (hold_family, world 1's spread), and both
    ranks' trainable state equal bit for bit."""
    steps = group["steps"]
    ranks = [r["legacy_sync_step"] for r in group["ranks"]]
    want = steps[0]
    for r in ranks:
        metrics = {k: r["metrics"][k] for k in ("loss", "grad_norm")}
        hold_family(metrics, [{k: s["metrics"][k] for k in metrics} for s in steps[1:]],
                    {k: want["metrics"][k] for k in metrics},
                    value_scales({k: want["metrics"][k] for k in metrics}), 1e-5, "metrics")
        state = {k: v.numpy() for k, v in want["state"].items()}
        hold_family(r["state"], [s["state"] for s in steps[1:]], state, value_scales(state),
                    REL, "state")
    assert ranks[0]["state"].keys() == ranks[1]["state"].keys()
    assert all(torch.equal(ranks[0]["state"][k], v) for k, v in ranks[1]["state"].items())
    assert any("running" in k for k in ranks[0]["state"])
