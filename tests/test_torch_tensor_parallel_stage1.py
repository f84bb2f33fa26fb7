"""The port's Stage I steps and fit on a (1 data x 2 model) grid (two
processes of one gloo group on the CPU, tests/torch_dist_worker.py suite
'tp_stage1') against the JAX package, and checkpoints across layouts.

- AVCLIP: tests/test_torch_distributed.py's tiny AVCLIP, global B=4 (both
  model peers take all 4 clips), S=2, against make_avclip_train_step /
  jax.value_and_grad on the XLA path, at its bounds (loss, grad_norm and
  logit scale rtol 1e-5; every gradient within 2e-5 of its tensor's largest
  |JAX| value + 1e-8; parameters after AdamW within 2e-6 where the clipped
  gradient exceeds 1e-5, else within the step itself).
- MoCo: tests/test_torch_distributed_moco.py's tiny MoCo, global B=2,
  against make_moco_train_step, at its bounds (each level's loss, the
  clipped step's grad_norm; the EMA parameters rtol 1e-6 / atol 1e-7, the
  queues atol 1e-5, the pointers exactly); the momentum model sharded as the
  online one.
- Both: the two ranks' whole parameters (and MoCo's EMA parameters and
  queues) equal bit for bit; each rank holds its model index's block of
  every sharded parameter and every replicated one whole; its parameters'
  and AdamW moments' bytes are the replicated ones plus half the sharded
  ones.
- Checkpoints: a Stage I fit at model_parallel 2 (tests/
  test_torch_distributed_fit.py's config, global batch 4, one epoch) writes
  the names and shapes a world-1 fit writes, whole tensors equal to what
  the ranks hold; one process resumes it at model_parallel 1 with the
  parameters, moments and step bit for bit; the world-1 fit, resumed on
  the (1 x 2) grid, holds its parameters and moments bit for bit (each rank
  its blocks) and trains on.

The group has a 60 s timeout and its spawn 110 s.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
from test_torch_distributed import (
    HYPER,
    assert_grads_match,
    assert_params_after_step,
    assert_ranks_equal,
    port_vis,
    tiny_inputs,
)
from test_torch_distributed_fit import fit_cfg
from test_torch_distributed_moco import HYPER as MOCO_HYPER
from test_torch_distributed_moco import QUEUES
from test_torch_models import randomize
from test_torch_moco import ALPHA, MOMENTUM, Q, T, _queues_np, jax_tiny_moco
from test_torch_train import LOSS_TOL, jax_tiny_avclip

from synchformer_tpu_torch.data.datasets import SyntheticAV
from synchformer_tpu_torch.models.presets import TINY
from synchformer_tpu_torch.parallel import tensor as ptensor
from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
from synchformer_tpu_torch.utils.convert import avclip_state_dict_from_jax, moco_state_dict_from_jax

torch.set_num_threads(2)

WORLD, N_MODEL, B, S = 2, 2, 4, 2
MOCO_B = 2


def _fit(cfg, exp: str, epochs: int, **training) -> AVCLIPTrainer:
    cfg = copy.deepcopy(cfg)
    cfg["logging"]["exp_name"] = exp
    cfg["training"].update(training)
    tr = AVCLIPTrainer(cfg, device="cpu")
    tr.fit(SyntheticAV("train", n_clips=8), SyntheticAV("valid", n_clips=4), num_workers=1,
           max_epochs=epochs, decode_backend="synthetic")
    return tr


def _jax_avclip(frames, aud):
    """(port state dict, the JAX side) of tests/test_torch_distributed.py's
    AVCLIP step over all clips."""
    from synchformer_tpu.train.state import SyncTrainState, make_lr_schedule, make_optimizer
    from synchformer_tpu.train.step import make_avclip_train_step

    model = jax_tiny_avclip(TINY)
    params = randomize(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(frames),
                                           jnp.asarray(aud)))["params"]
    params = {**params, "logit_scale": jnp.asarray(0.07, jnp.float32)}
    batch = {"vis": jnp.asarray(frames), "aud": jnp.asarray(aud)}
    sched = make_lr_schedule("cosine", HYPER["lr"], HYPER["warmup"], HYPER["total"])
    tx = make_optimizer("adamw", lr=sched, weight_decay=HYPER["wd"], max_clip_norm=1.0,
                        weight_decay_mask=jax.tree.map(lambda p: p.ndim >= 2, params))
    state = SyncTrainState.create(params, tx, trainable_keys=tuple(params.keys()))
    rngs = {"dropout": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}

    def loss_fn(p):
        return model.apply({"params": p}, batch["vis"], batch["aud"], deterministic=False,
                           rngs=rngs)["losses"]["segment_contrastive_loss"]

    @jax.jit
    def everything(state):
        return (jax.value_and_grad(loss_fn)(state.trainable),
                make_avclip_train_step(model, donate=False)(state, batch, jax.random.PRNGKey(0)))

    return avclip_state_dict_from_jax(params), lambda: _avclip_side(everything(state))


def _avclip_side(out):
    (loss, grads), (new_state, metrics) = out
    return dict(loss=float(loss), grads=avclip_state_dict_from_jax(grads),
                new_params=avclip_state_dict_from_jax(new_state.trainable),
                metrics={k: float(v) for k, v in metrics.items()})


def _jax_moco(frames, aud):
    """(port inputs, the JAX side) of tests/test_torch_distributed_moco.py's
    MoCo step over both clips."""
    from synchformer_tpu.models.moco_clip import init_queues
    from synchformer_tpu.models.moco_clip import moco_forward as jmoco_forward
    from synchformer_tpu.models.moco_clip import momentum_update as jmomentum_update
    from synchformer_tpu.train.state import SyncTrainState, make_lr_schedule, make_optimizer
    from synchformer_tpu.train.step import make_moco_train_step

    batch = {"vis": jnp.asarray(frames), "aud": jnp.asarray(aud)}
    model = jax_tiny_moco("xla")
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch["vis"], batch["aud"])
    scales = {k: jnp.asarray(0.07, jnp.float32)
              for k in ("segment_logit_scale", "global_logit_scale")}
    params = {**randomize(shapes)["params"], **scales}
    params_m = {**randomize(params, seed=2), **scales}
    queues = init_queues(jax.random.PRNGKey(1), T["d"], Q * S, Q)
    h = MOCO_HYPER
    sched = make_lr_schedule("cosine", h["lr"], h["warmup"], h["total"])
    tx = make_optimizer("adamw", lr=sched, weight_decay=h["wd"], max_clip_norm=1.0,
                        weight_decay_mask=jax.tree.map(lambda p: p.ndim >= 2, params))
    state = SyncTrainState.create(params, tx, trainable_keys=tuple(params.keys()))
    moco = {"params_m": params_m, "queues": queues}

    def loss_fn(p):
        losses, _, _ = jmoco_forward(model, p, jmomentum_update(p, params_m, MOMENTUM), queues,
                                     batch["vis"], batch["aud"], alpha=ALPHA, train=True,
                                     rngs={"dropout": jax.random.PRNGKey(3),
                                           "droppath": jax.random.PRNGKey(4)})
        return sum(losses.values()), losses

    @jax.jit
    def everything(state, moco):
        return (jax.value_and_grad(loss_fn, has_aux=True)(state.trainable),
                make_moco_train_step(model, donate=False)(
                    state, moco, batch, jax.random.PRNGKey(0), jnp.float32(ALPHA)))

    def side():
        ((_, losses), grads), (new_state, new_moco, metrics) = everything(state, moco)
        return dict(losses={k: float(v) for k, v in losses.items()},
                    grads=moco_state_dict_from_jax(grads),
                    metrics={k: float(v) for k, v in metrics.items()},
                    new_params=moco_state_dict_from_jax(new_state.trainable),
                    new_params_m=moco_state_dict_from_jax(new_moco["params_m"]),
                    new_queues=_queues_np(new_moco["queues"]))

    inputs = {"moco_sd": moco_state_dict_from_jax(params),
              "moco_m_sd": moco_state_dict_from_jax(params_m), "queues": _queues_np(queues),
              "hyper": h, "vis": port_vis(frames, T["patch_size"]),
              "aud": torch.from_numpy(aud), "model_parallel": N_MODEL}
    return inputs, side


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The world-1 fit 'w1' written, the inputs written, the group started,
    the JAX side computed meanwhile, then each rank's results."""
    workdir = tmp_path_factory.mktemp("tp_stage1")
    cfg = fit_cfg(workdir / "runs")
    w1 = _fit(cfg, "w1", 1)
    w1_state = {"model": {k: v.clone() for k, v in w1.model.state_dict().items()},
                "opt": copy.deepcopy(w1.optimizer.state_dict()), "step": w1.step}
    frames, aud = tiny_inputs(TINY, B, S)
    avclip_sd, avclip_side = _jax_avclip(frames, aud)
    moco_frames, moco_aud = tiny_inputs(T, MOCO_B, S)
    moco_inputs, moco_side = _jax_moco(moco_frames, moco_aud)
    torch.save({"avclip": {"avclip_sd": avclip_sd, "hyper": HYPER, "model_parallel": N_MODEL,
                           "vis": port_vis(frames, TINY["patch_size"]),
                           "aud": torch.from_numpy(aud)},
                "moco": moco_inputs, "fit_cfg": cfg, "model_parallel": N_MODEL},
               workdir / "inputs.pt")
    procs = worker.spawn_suite("tp_stage1", workdir, WORLD)
    try:
        jax_side = {"avclip": avclip_side(), "moco": moco_side()}
    finally:
        outs = worker.wait(procs)
    for r, (code, _, err) in enumerate(outs):
        assert code == 0, f"rank {r}: {err[-3000:]}"
    return dict(jax=jax_side, ranks=worker.results(workdir, "tp_stage1", WORLD), cfg=cfg,
                w1=w1_state, workdir=workdir)


def test_avclip_step_at_1x2_equals_jax(group):
    """The loss, each rank's whole gradients, the step's metrics (the
    clipped step's grad_norm) and the parameters after one AdamW step
    against make_avclip_train_step / jax.value_and_grad over all 4 clips;
    both ranks equal bit for bit."""
    want = group["jax"]["avclip"]
    r0, r1 = (r["tp_avclip_step"] for r in group["ranks"])
    for r in (r0, r1):
        np.testing.assert_allclose(r["loss"], want["loss"], **LOSS_TOL)
        assert_grads_match(r["grads"], want["grads"])
        for key in ("loss", "grad_norm", "logit_scale"):
            np.testing.assert_allclose(r["metrics"][key], want["metrics"][key], err_msg=key,
                                       **LOSS_TOL)
        assert_params_after_step(r["params"], want["new_params"], want["grads"],
                                 want["metrics"]["grad_norm"], HYPER["lr"] / HYPER["warmup"])
    assert r0["loss_local"] == r1["loss_local"]  # model peers take the same rows
    assert_ranks_equal(r0["grads"], r1["grads"])
    assert_ranks_equal(r0["params"], r1["params"])


def test_moco_step_at_1x2_equals_jax(group):
    """Each level's loss and every whole gradient against jax.value_and_grad,
    then one moco_train_step against make_moco_train_step: the metrics, the
    parameters after AdamW, the EMA parameters (sharded as the online ones),
    the queues and their pointers; both ranks equal bit for bit."""
    want = group["jax"]["moco"]
    r0, r1 = (r["tp_moco_step"] for r in group["ranks"])
    lr0 = MOCO_HYPER["lr"] / MOCO_HYPER["warmup"]
    for res in (r0, r1):
        for key, value in want["losses"].items():
            np.testing.assert_allclose(res["losses"][key], value, err_msg=key, **LOSS_TOL)
        assert_grads_match(res["grads"], want["grads"])
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
        assert (res["queues"]["segment_ptr"], res["queues"]["global_ptr"]) == (
            int(want["new_queues"]["segment_ptr"]), int(want["new_queues"]["global_ptr"]))
    assert_ranks_equal(r0["params"], r1["params"])
    assert_ranks_equal(r0["params_m"], r1["params_m"])
    assert_ranks_equal({k: r0["queues"][k] for k in QUEUES}, {k: r1["queues"][k] for k in QUEUES})


@pytest.mark.parametrize("case", ["tp_avclip_step", "tp_moco_step"])
def test_stage1_layout_at_1x2(group, case):
    """Rank r holds the block r of each sharded parameter's whole rows and
    every replicated parameter whole (equal on both ranks); its parameters'
    and AdamW moments' bytes are the replicated ones plus half the sharded
    ones."""
    ranks = [r[case] for r in group["ranks"]]
    whole = ranks[0]["params"]
    sharded = set(ranks[0]["layout"]["sharded"])
    assert sharded and set(ranks[1]["layout"]["sharded"]) == sharded
    assert any(".attn.qkv." in n for n in sharded) and any("in_proj" in n for n in sharded)
    want = sum(v.numel() * v.element_size() // (N_MODEL if k in sharded else 1)
               for k, v in whole.items())
    for r, res in enumerate(ranks):
        lay = res["layout"]
        for n, p in lay["local"].items():
            rows = p.shape[0] if n in sharded else None
            want_p = whole[n][r * rows:(r + 1) * rows] if rows else whole[n]
            assert torch.equal(p, want_p), (r, n)
        assert lay["param_bytes"] == want
        assert lay["moment_bytes"] == 2 * want


def test_checkpoint_at_model_parallel_2_resumes_at_1(group):
    """The (1 x 2) fit's checkpoint has the world-1 fit's names and shapes
    (parameters and optimizer state) and holds the ranks' whole tensors;
    one process resumes it with the parameters, the AdamW moments and the
    step bit for bit."""
    tp = [r["tp_fit_case"]["tp"] for r in group["ranks"]]
    payload = torch.load(group["workdir"] / "runs" / "tp" / "ckpts" / "latest" / "0.pt",
                         weights_only=True)
    w1 = group["w1"]
    assert {k: v.shape for k, v in payload["trainable"].items()} == {
        k: v.shape for k, v in w1["model"].items()}
    assert payload["opt_state"]["state"].keys() == w1["opt"]["state"].keys()
    for i, st in payload["opt_state"]["state"].items():
        assert {k: torch.as_tensor(v).shape for k, v in st.items()} == {
            k: torch.as_tensor(v).shape for k, v in w1["opt"]["state"][i].items()}, i
    for snap in tp:
        assert snap["step"] == payload["step"]
        assert_ranks_equal(snap["model"], payload["trainable"])
        for i, st in payload["opt_state"]["state"].items():
            for k, v in st.items():
                assert torch.equal(torch.as_tensor(snap["opt"]["state"][i][k]),
                                   torch.as_tensor(v)), (i, k)
    tr = _fit(group["cfg"], "tp", 1, resume="latest")
    assert tr.step == payload["step"]
    assert_ranks_equal({k: v for k, v in tr.model.state_dict().items()}, payload["trainable"])
    for i, st in tr.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(payload["opt_state"]["state"][i][k])), (i, k)


def test_checkpoint_at_1_resumes_at_model_parallel_2(group):
    """The world-1 fit resumed on the (1 x 2) grid: each rank's whole
    parameters, AdamW moments and step equal the world-1 run's bit for bit,
    and each sharded parameter it holds is its block of the whole one; the
    resumed run trains one more epoch, both ranks equal."""
    w1 = group["w1"]
    for r, res in enumerate(group["ranks"]):
        snap = res["tp_fit_case"]["w1_resumed"]
        assert snap["step"] == w1["step"]
        assert_ranks_equal(snap["model"], w1["model"])
        for i, st in w1["opt"]["state"].items():
            for k, v in st.items():
                assert torch.equal(torch.as_tensor(snap["opt"]["state"][i][k]),
                                   torch.as_tensor(v)), (i, k)
        sharded = set(snap["layout"]["sharded"])
        assert sharded
        for n, p in snap["layout"]["local"].items():
            if n in sharded:
                rows = p.shape[0]
                assert torch.equal(p, w1["model"][n][r * rows:(r + 1) * rows]), (r, n)
        cont = res["tp_fit_case"]["w1_continued"]
        assert cont["step"] == 2 * w1["step"]
        assert all(torch.isfinite(v).all() for v in cont["model"].values())
    c0, c1 = (res["tp_fit_case"]["w1_continued"] for res in group["ranks"])
    assert_ranks_equal(c0["model"], c1["model"])


def test_optimizer_state_round_trip_without_a_grid():
    """At model_parallel 1 optimizer_state_dict is the optimizer's own state
    dict and load_optimizer_state_dict loads it unchanged; nothing is
    sharded."""
    from synchformer_tpu_torch.models.presets import build_tiny_avclip
    from synchformer_tpu_torch.train.state import make_adamw

    model = build_tiny_avclip()
    opt = make_adamw(model.named_parameters(), 0.2)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert ptensor.shard_model_(model) is model and not ptensor.sharded_names(model)
    sd = ptensor.optimizer_state_dict(opt, model)
    want = opt.state_dict()
    assert sd["param_groups"] == want["param_groups"]
    for i, st in want["state"].items():
        assert all(torch.equal(torch.as_tensor(v), torch.as_tensor(sd["state"][i][k]))
                   for k, v in st.items())
    ptensor.load_optimizer_state_dict(opt, model, sd)
    for i, st in opt.state_dict()["state"].items():
        assert all(torch.equal(torch.as_tensor(v), torch.as_tensor(want["state"][i][k]))
                   for k, v in st.items())
