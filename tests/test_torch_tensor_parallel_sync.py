"""The port's Stage II and Stage III steps on a (2 data x 2 model) grid (four
processes of one gloo group on the CPU, tests/torch_dist_worker.py suite
'tp_sync') against make_sync_train_step on the JAX package's (2 x 2) mesh,
its parameters laid out by param_shardings, and on one device.

The model, batch and bounds are tests/test_torch_distributed_sync.py's: the
tiny Synchformer (presets.TINY, S=2, every dropout and drop-path 0, frozen
towers, f32), offsets and syncability, global B=4 (2 a data rank, the same
rows on both model peers), Adam on constant_with_warmup, clip 1.0, at
base_learning_rate x n_data = 2. The JAX steps run the XLA path. Loss and
grad_norm rtol 1e-5, every trainable gradient within 2e-5 of its layer's
largest |JAX| gradient + 1e-8, parameters after the step within 2e-6 where
the clipped gradient exceeds 1e-5, else the step itself. Every rank's whole
parameters are equal bit for bit; what a rank holds: each sharded parameter
as its model index's block of rows (equal bit for bit on both data peers),
each replicated one whole (equal on all four), its parameters' and Adam
moments' bytes the replicated ones plus half the sharded ones.

The evaluation: SyncTrainer's valid phase on the (2 x 2) grid over 7 clips
(data rank 0's shard 4, data rank 1's 3) against world 1's over the same
clips (the unsharded model, every clip at the global batch, in the same
process): the gathered logits, targets and every metric.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
from test_torch_distributed import (
    N_VALID,
    assert_params_after_step,
    assert_ranks_equal,
    port_vis,
    tiny_inputs,
)
from test_torch_distributed_sync import CASES, TARGETS, trainer_cfg
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
from test_trainer import TINY_CFG

from synchformer_tpu_torch.models.presets import TINY
from synchformer_tpu_torch.train.state import make_lr_schedule
from synchformer_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

WORLD, N_MODEL, B, S = 4, 2, 4, 2
N_DATA = WORLD // N_MODEL


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    from synchformer_tpu.parallel.mesh import batch_sharding, make_mesh, param_shardings, replicated
    from synchformer_tpu.train.state import (
        SYNC_TRAINABLE_KEYS,
        SyncTrainState,
        make_optimizer,
        merge_params,
    )
    from synchformer_tpu.train.state import make_lr_schedule as jmake_lr_schedule
    from synchformer_tpu.train.step import make_sync_train_step

    workdir = tmp_path_factory.mktemp("tp_sync")
    frames, aud = tiny_inputs(TINY, B, S)
    models = {name: jax_sync_model(sy) for name, sy in CASES.items()}
    params = {name: jax_params(models[name], frames, aud) for name in CASES}
    sync_cfg = dict(TINY_CFG, training=dict(TINY_CFG["training"], base_batch_size=8))
    torch.save({"sync_cases": {name: {"syncability": sy, "sd": state_dict_from_jax(params[name]),
                                      "cfg": trainer_cfg(sy), "targets": TARGETS[sy]}
                               for name, sy in CASES.items()},
                "n_segments": S, "vis": port_vis(frames, TINY["patch_size"]),
                "aud": torch.from_numpy(aud), "model_parallel": N_MODEL,
                "sync_cfg": sync_cfg, "n_valid": N_VALID}, workdir / "inputs.pt")
    procs = worker.spawn_suite("tp_sync", workdir, WORLD)
    jax_side = {}
    try:
        mesh = make_mesh(n_data=N_DATA, n_model=N_MODEL)
        for name, sy in CASES.items():
            model = models[name]
            batch = {"vis": jnp.asarray(frames), "aud": jnp.asarray(aud),
                     "targets": jnp.asarray(TARGETS[sy])}
            # the JAX trainer's rate at n_data 2
            tx = make_optimizer("adam", lr=jmake_lr_schedule("constant_with_warmup",
                                                             LR * N_DATA, WARMUP),
                                max_clip_norm=1.0, eps=1e-8)
            state = SyncTrainState.create(params[name], tx, SYNC_TRAINABLE_KEYS)
            step = make_sync_train_step(model, donate=False)

            def loss_fn(trainable, state=state, model=model, batch=batch):
                return model.apply({"params": merge_params(trainable, state.frozen)},
                                   batch["vis"], batch["aud"], batch["targets"],
                                   deterministic=False, extractors_deterministic=True,
                                   rngs={"dropout": jax.random.PRNGKey(1),
                                         "droppath": jax.random.PRNGKey(2)})[0]

            @jax.jit
            def everything(state, loss_fn=loss_fn, batch=batch, step=step):
                return (jax.value_and_grad(loss_fn)(state.trainable),
                        step(state, batch, jax.random.PRNGKey(0)))

            (loss, grads), (new_state, metrics) = everything(state)
            # the same step on the (2 x 2) mesh, as tests/test_parallel.py runs it
            sharded = jax.tree.map(jax.device_put, params[name],
                                   param_shardings(params[name], mesh))
            mesh_state = SyncTrainState.create(sharded, tx, SYNC_TRAINABLE_KEYS)
            mesh_batch = {k: jax.device_put(v, batch_sharding(mesh)) for k, v in batch.items()}
            mesh_new, mesh_metrics = step(mesh_state, mesh_batch,
                                          jax.device_put(jax.random.PRNGKey(0), replicated(mesh)))
            jax_side[name] = dict(
                loss=float(loss), grads=trainable_sd(grads),
                new_params=trainable_sd(new_state.trainable),
                metrics={k: float(v) for k, v in metrics.items()},
                mesh_params=trainable_sd(jax.device_get(mesh_new.trainable)),
                mesh_metrics={k: float(v) for k, v in mesh_metrics.items()})
    finally:
        outs = worker.wait(procs)
    for r, (code, _, err) in enumerate(outs):
        assert code == 0, f"rank {r}: {err[-3000:]}"
    return dict(jax=jax_side, ranks=worker.results(workdir, "tp_sync", WORLD))


@pytest.mark.parametrize("name", list(CASES))
def test_sync_step_at_2x2_equals_make_sync_train_step(group, name):
    """SyncTrainer's rate is n_data x base_learning_rate; each rank's loss
    (mean over the data ranks) and whole trainable gradients against
    jax.value_and_grad over the 4 clips; one sync_train_step against
    make_sync_train_step at the JAX trainer's rate, on one device and on
    the (2 x 2) mesh with param_shardings; all four ranks' whole parameters
    equal bit for bit."""
    want = group["jax"][name]
    base = make_lr_schedule("constant_with_warmup", LR, WARMUP)
    for key in ("loss", "grad_norm", "accuracy_1"):
        np.testing.assert_allclose(want["mesh_metrics"][key], want["metrics"][key], err_msg=key,
                                   **LOSS_TOL)
    ranks = [r["tp_sync_step"][name] for r in group["ranks"]]
    for res in ranks:
        assert res["lr"] == pytest.approx([N_DATA * base(s) for s in range(8)], rel=1e-12)
        np.testing.assert_allclose(res["loss"], want["loss"], **LOSS_TOL)
        assert sorted(res["grads"]) == sorted(want["grads"])
        for gname, g in res["grads"].items():
            bound = GRAD_REL_TO_MAX * layer_scale(want["grads"], gname) + 1e-8
            assert float(np.abs(g.numpy() - want["grads"][gname]).max()) <= bound, gname
        for key in ("loss", "grad_norm", "accuracy_1"):
            np.testing.assert_allclose(res["metrics"][key], want["metrics"][key], err_msg=key,
                                       **LOSS_TOL)
        for new in ("new_params", "mesh_params"):
            assert_params_after_step(res["params"], want[new], want["grads"],
                                     want["metrics"]["grad_norm"], N_DATA * base(0))
    for res in ranks[1:]:
        assert_ranks_equal(ranks[0]["params"], res["params"])


@pytest.mark.parametrize("name", list(CASES))
def test_sync_layout_at_2x2(group, name):
    """Rank r holds model index r % 2's block of each sharded parameter (the
    whole parameter's rows), equal on both data peers, and every replicated
    parameter whole, equal on all ranks; its parameters' and moments' bytes
    are the replicated ones plus half the sharded ones. The whole fc2 of a
    video block, as the kernels read it, is contiguous, f32 and 16-byte
    aligned. The trainer's whole state (trainable parameters, optimizer
    state) loads back into it unchanged."""
    ranks = [r["tp_sync_step"][name] for r in group["ranks"]]
    layouts = [res["layout"] for res in ranks]
    sharded = set(layouts[0]["sharded"])
    assert sharded and all(set(lay["sharded"]) == sharded for lay in layouts)
    assert any(n.startswith("transformer.") for n in sharded)
    assert any(n.startswith("vfeat_extractor.") for n in sharded)
    whole = ranks[0]["params"]
    want_params, want_moments = 0, 0
    for n, p in layouts[0]["local"].items():
        size = p.element_size() * (p.numel() * N_MODEL if n in sharded else p.numel())
        share = size // N_MODEL if n in sharded else size
        want_params += share
        if n in whole:  # trainable: Adam's two moments
            want_moments += 2 * share
    for r, lay in enumerate(layouts):
        for n, p in lay["local"].items():
            if n in sharded:
                peer = layouts[(r + N_MODEL) % WORLD]["local"][n]
                assert torch.equal(p, peer), (r, n)
                if n in whole:
                    rows = p.shape[0]
                    block = whole[n][(r % N_MODEL) * rows:(r % N_MODEL + 1) * rows]
                    assert torch.equal(p, block), (r, n)
            else:
                assert torch.equal(p, layouts[0]["local"][n]), (r, n)
        assert lay["param_bytes"] == want_params
        assert lay["moment_bytes"] == want_moments
        got = ranks[r]["gathered"]
        assert got == {"contiguous": True, "dtype": "torch.float32", "aligned": True,
                       "shape": (TINY["d"], 4 * TINY["d"]), "sharded": True}
        assert ranks[r]["round_trip"]


def test_eval_metrics_at_2x2_equal_world_1(group):
    """SyncTrainer's valid phase on the (2 x 2) grid over 7 clips: the
    gathered logits are world 1's in data-rank order (each clip once, not
    once per model peer), and every metric equals world 1's."""
    order = np.concatenate([np.arange(0, N_VALID, N_DATA), np.arange(1, N_VALID, N_DATA)])
    for res in group["ranks"]:
        got, want = res["tp_eval_metrics"], res["tp_eval_metrics"]["world1"]
        assert got["logits"].shape == (N_VALID, 21)
        np.testing.assert_allclose(got["logits"], want["logits"][order], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got["targets"], want["targets"][order])
        assert got["metrics"].keys() == want["metrics"].keys()
        for key, value in want["metrics"].items():
            if isinstance(value, float):
                assert got["metrics"][key] == pytest.approx(value, rel=1e-6, abs=1e-9), key
        assert got["metrics"]["per_class"] == pytest.approx(want["metrics"]["per_class"])
