"""The port's Stage II and Stage III steps at world 2 (two processes of one
gloo group on the CPU, tests/torch_dist_worker.py suite 'sync') against
make_sync_train_step over the concatenated global batch.

SyncTrainer builds the step (its DDP wrapper, optimizer and schedule) around
the tiny Synchformer of tests/test_torch_sync_train.py (presets.TINY, S=2,
every dropout and drop-path 0, frozen towers, f32), offsets (21 classes) and
syncability (the 2-class head), global B=4 (2 a rank). Its learning rate is
base_learning_rate x 2, the JAX trainer's n_data scaling
(synchformer_tpu/train/stage_sync.py:161-165), so the JAX step runs Adam at
2 x LR. Tolerances are tests/test_torch_sync_train.py's: loss and grad_norm
rtol 1e-5, every trainable gradient within 2e-5 of its layer's largest |JAX|
gradient + 1e-8, parameters after one Adam step (constant_with_warmup, clip
1.0) within 2e-6 where the clipped gradient exceeds 1e-5, else the step
itself. Both ranks' parameters are equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
from test_torch_distributed import (
    assert_params_after_step,
    assert_ranks_equal,
    port_vis,
    tiny_inputs,
)
from test_torch_sync_train import (
    GRAD_REL_TO_MAX,
    LOSS_TOL,
    LR,
    WARMUP,
    jax_params,
    jax_sync_model,
    layer_scale,
    trainable_sd,
)

from synchformer_tpu_torch.models.presets import TINY
from synchformer_tpu_torch.train.state import make_lr_schedule
from synchformer_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

WORLD, B, S = 2, 4, 2
TARGETS = {False: np.array([3, 17, 0, 9]), True: np.array([1, 0, 0, 1])}
CASES = {"offset": False, "syncability": True}


def trainer_cfg(syncability: bool) -> dict:
    return {"action": ("ft_avsync_model_for_syncability" if syncability
                       else "train_avsync_model"),
            "training": {"seed": 0, "base_batch_size": B, "base_learning_rate": LR,
                         "lr_scheduler": {"name": "constant_with_warmup", "warmup": WARMUP},
                         "optimizer": {"name": "adam"}, "use_half_precision": False,
                         "max_clip_norm": 1.0},
            "data": {"n_segments": S, "num_off_cls": 21}}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    from synchformer_tpu.train.state import (
        SYNC_TRAINABLE_KEYS,
        SyncTrainState,
        merge_params,
        make_optimizer,
    )
    from synchformer_tpu.train.state import make_lr_schedule as jmake_lr_schedule
    from synchformer_tpu.train.step import make_sync_train_step

    workdir = tmp_path_factory.mktemp("dist_sync")
    frames, aud = tiny_inputs(TINY, B, S)
    models = {name: jax_sync_model(sy) for name, sy in CASES.items()}
    params = {name: jax_params(models[name], frames, aud) for name in CASES}
    torch.save({"sync_cases": {name: {"syncability": sy, "sd": state_dict_from_jax(params[name]),
                                      "cfg": trainer_cfg(sy), "targets": TARGETS[sy]}
                               for name, sy in CASES.items()},
                "n_segments": S, "vis": port_vis(frames, TINY["patch_size"]),
                "aud": torch.from_numpy(aud)}, workdir / "inputs.pt")
    procs = worker.spawn_suite("sync", workdir, WORLD)
    jax_side = {}
    try:
        for name, sy in CASES.items():
            model = models[name]
            batch = {"vis": jnp.asarray(frames), "aud": jnp.asarray(aud),
                     "targets": jnp.asarray(TARGETS[sy])}
            # the JAX trainer's rate at n_data 2
            tx = make_optimizer("adam", lr=jmake_lr_schedule("constant_with_warmup",
                                                             LR * WORLD, WARMUP),
                                max_clip_norm=1.0, eps=1e-8)
            state = SyncTrainState.create(params[name], tx, SYNC_TRAINABLE_KEYS)

            def loss_fn(trainable, state=state, model=model, batch=batch):
                return model.apply({"params": merge_params(trainable, state.frozen)},
                                   batch["vis"], batch["aud"], batch["targets"],
                                   deterministic=False, extractors_deterministic=True,
                                   rngs={"dropout": jax.random.PRNGKey(1),
                                         "droppath": jax.random.PRNGKey(2)})[0]

            @jax.jit
            def everything(state, loss_fn=loss_fn, model=model, batch=batch):
                return (jax.value_and_grad(loss_fn)(state.trainable),
                        make_sync_train_step(model, donate=False)(state, batch,
                                                                  jax.random.PRNGKey(0)))

            (loss, grads), (new_state, metrics) = everything(state)
            jax_side[name] = dict(loss=float(loss), grads=trainable_sd(grads),
                                  new_params=trainable_sd(new_state.trainable),
                                  metrics={k: float(v) for k, v in metrics.items()})
    finally:
        outs = worker.wait(procs)
    for r, (code, _, err) in enumerate(outs):
        assert code == 0, f"rank {r}: {err[-3000:]}"
    return dict(jax=jax_side, ranks=[r["sync_step"] for r in worker.results(workdir, "sync")])


@pytest.mark.parametrize("name", list(CASES))
def test_sync_step_at_world_2_equals_make_sync_train_step(group, name):
    """SyncTrainer's rate is 2 x base_learning_rate at every step; the loss
    (mean over ranks) and each rank's DDP-averaged trainable gradients
    against jax.value_and_grad over the 4 clips; one sync_train_step against
    make_sync_train_step at the JAX trainer's rate (Adam, clip 1.0); both
    ranks' parameters equal bit for bit."""
    want = group["jax"][name]
    base = make_lr_schedule("constant_with_warmup", LR, WARMUP)
    for res in (r[name] for r in group["ranks"]):
        assert res["lr"] == pytest.approx([WORLD * base(s) for s in range(8)], rel=1e-12)
        np.testing.assert_allclose(res["loss"], want["loss"], **LOSS_TOL)
        assert sorted(res["grads"]) == sorted(want["grads"])
        for gname, g in res["grads"].items():
            bound = GRAD_REL_TO_MAX * layer_scale(want["grads"], gname) + 1e-8
            assert float(np.abs(g.numpy() - want["grads"][gname]).max()) <= bound, gname
        for key in ("loss", "grad_norm", "accuracy_1"):
            np.testing.assert_allclose(res["metrics"][key], want["metrics"][key], err_msg=key,
                                       **LOSS_TOL)
        assert_params_after_step(res["params"], want["new_params"], want["grads"],
                                 want["metrics"]["grad_norm"], WORLD * base(0))
    assert_ranks_equal(group["ranks"][0][name]["params"], group["ranks"][1][name]["params"])
