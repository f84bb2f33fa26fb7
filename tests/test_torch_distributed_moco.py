"""The port's MoCo Stage I step at world 2 (two processes of one gloo group
on the CPU, tests/torch_dist_worker.py suite 'moco') against
make_moco_train_step over the concatenated global batch.

The tiny MoCo of tests/test_torch_moco.py (presets.TINY widths at depth 1,
both towers with global representations over S=2, drop-path 0, the video
tower's pos_dropout 1e-9, an exact identity on both sides; queue_size 4: the
segment queue 8, the global 4; momentum 0.9, alpha 0.4), global B=2 (1 a
rank): the keys of both ranks (4 segment, 2 global) are the in-batch
negatives and what goes into the queues. JAX runs its XLA path. Tolerances
are tests/test_torch_moco.py's: each level's loss and grad_norm rtol 1e-5,
every gradient within 2e-5 of its tensor's largest |JAX| value + 1e-8,
parameters after AdamW within 2e-6 where the clipped gradient exceeds 1e-5
(else the step itself), the EMA parameters rtol 1e-6 / atol 1e-7, the
queues atol 1e-5 and the pointers exactly. Both ranks' parameters, EMA
parameters and queues are equal bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
from test_torch_distributed import (
    assert_grads_match,
    assert_params_after_step,
    assert_ranks_equal,
    port_vis,
    tiny_inputs,
)
from test_torch_models import randomize
from test_torch_moco import ALPHA, MOMENTUM, POS_DROP, Q, S, T, _queues_np, jax_tiny_moco
from test_torch_train import LOSS_TOL

from synchformer_tpu_torch.utils.convert import moco_state_dict_from_jax

torch.set_num_threads(2)

WORLD, B = 2, 2
HYPER = dict(lr=1e-3, warmup=2, total=20, wd=0.2, alpha=ALPHA, pos_drop=POS_DROP)
QUEUES = ("segment_v", "segment_a", "global_v", "global_a")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    from synchformer_tpu.models.moco_clip import init_queues
    from synchformer_tpu.models.moco_clip import moco_forward as jmoco_forward
    from synchformer_tpu.models.moco_clip import momentum_update as jmomentum_update
    from synchformer_tpu.train.state import SyncTrainState, make_lr_schedule, make_optimizer
    from synchformer_tpu.train.step import make_moco_train_step

    workdir = tmp_path_factory.mktemp("dist_moco")
    frames, aud = tiny_inputs(T, B, S)
    batch = {"vis": jnp.asarray(frames), "aud": jnp.asarray(aud)}
    model = jax_tiny_moco("xla")
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch["vis"], batch["aud"])
    scales = {k: jnp.asarray(0.07, jnp.float32)
              for k in ("segment_logit_scale", "global_logit_scale")}
    params = {**randomize(shapes)["params"], **scales}
    params_m = {**randomize(params, seed=2), **scales}
    queues = init_queues(jax.random.PRNGKey(1), T["d"], Q * S, Q)
    torch.save({"moco_sd": moco_state_dict_from_jax(params),
                "moco_m_sd": moco_state_dict_from_jax(params_m),
                "queues": _queues_np(queues), "hyper": HYPER,
                "vis": port_vis(frames, T["patch_size"]), "aud": torch.from_numpy(aud)},
               workdir / "inputs.pt")
    procs = worker.spawn_suite("moco", workdir, WORLD)
    try:
        sched = make_lr_schedule("cosine", HYPER["lr"], HYPER["warmup"], HYPER["total"])
        tx = make_optimizer("adamw", lr=sched, weight_decay=HYPER["wd"], max_clip_norm=1.0,
                            weight_decay_mask=jax.tree.map(lambda p: p.ndim >= 2, params))
        state = SyncTrainState.create(params, tx, trainable_keys=tuple(params.keys()))
        moco = {"params_m": params_m, "queues": queues}

        def loss_fn(p):
            losses, _, _ = jmoco_forward(model, p, jmomentum_update(p, params_m, MOMENTUM),
                                         queues, batch["vis"], batch["aud"], alpha=ALPHA,
                                         train=True, rngs={"dropout": jax.random.PRNGKey(3),
                                                           "droppath": jax.random.PRNGKey(4)})
            return sum(losses.values()), losses

        @jax.jit
        def everything(state, moco):
            return (jax.value_and_grad(loss_fn, has_aux=True)(state.trainable),
                    make_moco_train_step(model, donate=False)(
                        state, moco, batch, jax.random.PRNGKey(0), jnp.float32(ALPHA)))

        ((_, losses), grads), (new_state, new_moco, metrics) = everything(state, moco)
        jax_side = dict(losses={k: float(v) for k, v in losses.items()},
                        grads=moco_state_dict_from_jax(grads),
                        metrics={k: float(v) for k, v in metrics.items()},
                        new_params=moco_state_dict_from_jax(new_state.trainable),
                        new_params_m=moco_state_dict_from_jax(new_moco["params_m"]),
                        new_queues=_queues_np(new_moco["queues"]))
    finally:
        outs = worker.wait(procs)
    for r, (code, _, err) in enumerate(outs):
        assert code == 0, f"rank {r}: {err[-3000:]}"
    return dict(jax=jax_side, ranks=[r["moco_step"] for r in worker.results(workdir, "moco")])


def test_moco_losses_and_grads_at_world_2_equal_jax(group):
    """Each level's loss (mean over ranks: the global keys as negatives, the
    targets on the rank-offset diagonal) and every DDP-averaged gradient
    against jax.value_and_grad over both clips, on each rank."""
    want = group["jax"]
    for res in group["ranks"]:
        for key, value in want["losses"].items():
            np.testing.assert_allclose(res["losses"][key], value, err_msg=key, **LOSS_TOL)
        assert_grads_match(res["grads"], want["grads"])
    assert_ranks_equal(group["ranks"][0]["grads"], group["ranks"][1]["grads"])


def test_moco_step_at_world_2_equals_make_moco_train_step(group):
    """One moco_train_step under DDP on each rank against make_moco_train_step
    over both clips: the metrics, the parameters after AdamW, the EMA
    parameters, the queues holding both ranks' keys in rank order and the
    pointers; every rank's state equal bit for bit."""
    want = group["jax"]
    lr0 = HYPER["lr"] / HYPER["warmup"]
    for res in group["ranks"]:
        for key in ("loss", "segment_contrastive_loss", "global_contrastive_loss", "grad_norm"):
            np.testing.assert_allclose(res["metrics"][key], want["metrics"][key], err_msg=key,
                                       **LOSS_TOL)
        assert_params_after_step(res["params"], want["new_params"], want["grads"],
                                 want["metrics"]["grad_norm"], lr0)
        for name, p in res["params_m"].items():
            np.testing.assert_allclose(p.numpy(), want["new_params_m"][name], rtol=1e-6,
                                       atol=1e-7, err_msg=name)
        for key in QUEUES:
            np.testing.assert_allclose(res["queues"][key].numpy(), want["new_queues"][key],
                                       atol=1e-5, err_msg=key)
        assert (res["queues"]["segment_ptr"], res["queues"]["global_ptr"]) == (B * S, B)
        assert (res["queues"]["segment_ptr"], res["queues"]["global_ptr"]) == (
            int(want["new_queues"]["segment_ptr"]), int(want["new_queues"]["global_ptr"]))
    r0, r1 = group["ranks"]
    assert_ranks_equal(r0["params"], r1["params"])
    assert_ranks_equal(r0["params_m"], r1["params_m"])
    assert_ranks_equal({k: r0["queues"][k] for k in QUEUES}, {k: r1["queues"][k] for k in QUEUES})
