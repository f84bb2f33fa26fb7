"""The port's data-parallel training at world 2 (two processes of one gloo
group on the CPU, tests/torch_dist_worker.py) against the JAX package over
the concatenated global batch: the AVCLIP step, the gathered InfoNCE and its
gradient, gather_dict, the loaders' sharding, the Stage II evaluation over
an odd number of clips; and, without a group, the refusal of a
training.model_parallel that world 1 does not split into and today's
streams at world 1.

The AVCLIP case: the tiny AVCLIP of tests/test_torch_train.py (presets.TINY,
drop-path 0, f32), global B=4 (2 a rank), S=2, no flip or augmentation (the
steps take prepared inputs). JAX runs make_avclip_train_step and
jax.value_and_grad of AVCLIP.apply on the XLA path over all 4 clips. The
tolerances are tests/test_torch_train.py's: loss and grad_norm rtol 1e-5;
every gradient within 2e-5 of its tensor's largest |JAX| value + 1e-8;
parameters after AdamW within 2e-6 where the clipped gradient exceeds 1e-5,
else within the step itself. Both ranks' gradients and parameters are equal
bit for bit (DDP's all-reduce gives every rank the same sum).

One group runs every case of the module (its worker suite 'avclip') while
this process compiles the JAX side; the group has a 60 s timeout and the
spawn 110 s.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
from test_stage_clip import TINY_AVCLIP_CFG
from test_torch_models import randomize
from test_torch_train import (
    GRAD_REL_TO_MAX,
    LOSS_TOL,
    PARAM_ATOL,
    SETTLED_GRAD,
    jax_tiny_avclip,
)
from test_trainer import TINY_CFG

from synchformer_tpu_torch.models.presets import TINY, build_tiny_avclip
from synchformer_tpu_torch.ops.video import patchify_frames
from synchformer_tpu_torch.parallel import dist as pdist
from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
from synchformer_tpu_torch.train.stage_sync import SyncTrainer
from synchformer_tpu_torch.utils.convert import avclip_state_dict_from_jax

torch.set_num_threads(2)

WORLD, B, S = 2, 4, 2
HYPER = dict(lr=1e-3, warmup=2, total=20, wd=0.2)
N_VALID = 7  # clips of the evaluation case: odd, so the ranks' shards differ


def tiny_inputs(t, b: int, s: int, seed: int = 0):
    """Seeded uint8 frames normalised to [-1, 1] (B, S, T, H, W, C) and log-mel
    (B, S, 66, 128), f32."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (b, s, 2 * t["temporal_resolution"], t["img_size"],
                               t["img_size"], 3), np.uint8)
    frames = ((u8.astype(np.float32) / 255.0) - 0.5) / 0.5
    return frames, rng.standard_normal((b, s, 66, 128)).astype(np.float32)


def port_vis(frames, patch: int):
    return torch.from_numpy(np.ascontiguousarray(patchify_frames(frames, 2, patch)))


def assert_grads_match(grads: dict, want: dict, rel=GRAD_REL_TO_MAX):
    """Every gradient within ``rel`` x its tensor's largest |JAX| value + 1e-8."""
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        bound = rel * float(np.abs(want[name]).max()) + 1e-8
        assert float(np.abs(g.numpy() - want[name]).max()) <= bound, name


def assert_params_after_step(params: dict, want: dict, grads: dict, grad_norm: float, lr0: float):
    """tests/test_torch_train.py's bound on the parameters after one Adam step."""
    clip = max(grad_norm, 1.0)
    for name, p in params.items():
        settled = np.abs(grads[name]) / clip > SETTLED_GRAD
        atol = np.where(settled, PARAM_ATOL, 2 * lr0 + PARAM_ATOL)
        assert np.all(np.abs(p.numpy() - want[name]) <= atol), name


def assert_ranks_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Inputs written, the group started, the JAX side computed meanwhile,
    then each rank's results."""
    from synchformer_tpu.models.avclip import AVCLIP as JaxAVCLIP
    from synchformer_tpu.train.state import SyncTrainState, make_lr_schedule, make_optimizer
    from synchformer_tpu.train.step import make_avclip_train_step

    workdir = tmp_path_factory.mktemp("dist_avclip")
    frames, aud = tiny_inputs(TINY, B, S)
    model = jax_tiny_avclip(TINY)
    params = randomize(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(frames),
                                           jnp.asarray(aud)))["params"]
    params = {**params, "logit_scale": jnp.asarray(0.07, jnp.float32)}
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, WORLD * 3, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    avclip_cfg = copy.deepcopy(TINY_AVCLIP_CFG)
    sync_cfg = copy.deepcopy(TINY_CFG)
    sync_cfg["training"]["base_batch_size"] = 8
    torch.save({"avclip_sd": avclip_state_dict_from_jax(params), "hyper": HYPER,
                "vis": port_vis(frames, TINY["patch_size"]), "aud": torch.from_numpy(aud),
                "feat_v": torch.from_numpy(feats[0]), "feat_a": torch.from_numpy(feats[1]),
                "avclip_cfg": avclip_cfg, "sync_cfg": sync_cfg, "n_valid": N_VALID},
               workdir / "inputs.pt")
    procs = worker.spawn_suite("avclip", workdir, WORLD)
    try:
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
                    make_avclip_train_step(model, donate=False)(state, batch,
                                                               jax.random.PRNGKey(0)))

        (loss, grads), (new_state, metrics) = everything(state)

        # the InfoNCE over the global features, and each rank's share of it
        scale = jnp.float32(0.07)
        v, a = jnp.asarray(feats[0]), jnp.asarray(feats[1])
        n = v.shape[0] // WORLD
        global_loss, (gv, ga) = jax.value_and_grad(
            lambda v, a: JaxAVCLIP.contrastive_loss(None, v, a, v, a, scale), (0, 1))(v, a)
        rank_losses = [float(JaxAVCLIP.contrastive_loss(None, v[r * n:(r + 1) * n],
                                                        a[r * n:(r + 1) * n], v, a, scale,
                                                        r * n)) for r in range(WORLD)]
        jax_side = dict(
            loss=float(loss), grads=avclip_state_dict_from_jax(grads),
            new_params=avclip_state_dict_from_jax(new_state.trainable),
            metrics={k: float(v) for k, v in metrics.items()},
            infonce=dict(loss=float(global_loss), grad_v=np.asarray(gv), grad_a=np.asarray(ga),
                         rank_losses=rank_losses, n=n))
    finally:
        outs = worker.wait(procs)
    for r, (code, _, err) in enumerate(outs):
        assert code == 0, f"rank {r}: {err[-3000:]}"
    return dict(jax=jax_side, ranks=worker.results(workdir, "avclip", WORLD), workdir=workdir)


def test_avclip_step_at_world_2_equals_jax_on_the_global_batch(group):
    """The loss (mean over ranks), each rank's DDP-averaged gradients, the
    step's metrics and the parameters after one AdamW step against
    make_avclip_train_step / jax.value_and_grad over all 4 clips; both ranks
    equal bit for bit."""
    want = group["jax"]
    r0, r1 = (r["avclip_step"] for r in group["ranks"])
    assert group["ranks"][0]["world"] == WORLD
    assert r0["loss_local"] != r1["loss_local"]  # each rank's own rows
    for r in (r0, r1):
        np.testing.assert_allclose(r["loss"], want["loss"], **LOSS_TOL)
        assert_grads_match(r["grads"], want["grads"])
        for key in ("loss", "grad_norm", "logit_scale"):
            np.testing.assert_allclose(r["metrics"][key], want["metrics"][key], err_msg=key,
                                       **LOSS_TOL)
        lr0 = HYPER["lr"] / HYPER["warmup"]
        assert_params_after_step(r["params"], want["new_params"], want["grads"],
                                 want["metrics"]["grad_norm"], lr0)
    assert_ranks_equal(r0["grads"], r1["grads"])
    assert_ranks_equal(r0["params"], r1["params"])


def test_gathered_infonce_equals_the_global_loss(group):
    """AVCLIP.contrastive_loss on each rank's 3 rows of 6: each rank's loss is
    JAX's contrastive_loss with the rank-offset labels, their mean is the
    global batch's loss, and the features' gradients (of loss / world, the
    gather's backward summing over ranks) are the global loss's rows, all at
    rtol 1e-5 / 2e-5 of the largest gradient. A gather whose backward keeps
    only this rank's part of the incoming gradient fails that check."""
    want = group["jax"]["infonce"]
    n = want["n"]
    worst_fault = 0.0
    for r, res in enumerate(group["ranks"]):
        got = res["gathered_infonce"]["summed"]
        np.testing.assert_allclose(got["loss"], want["rank_losses"][r], **LOSS_TOL)
        np.testing.assert_allclose(got["loss_mean"], want["loss"], **LOSS_TOL)
        for key in ("grad_v", "grad_a"):
            rows = want[key][r * n:(r + 1) * n]
            bound = GRAD_REL_TO_MAX * float(np.abs(want[key]).max())
            assert float(np.abs(got[key].numpy() - rows).max()) <= bound, key
            fault = res["gathered_infonce"]["local_only"]
            assert fault["loss"] == got["loss"]  # the forward is the same
            worst_fault = max(worst_fault,
                              float(np.abs(fault[key].numpy() - rows).max()) / bound)
    assert worst_fault > 1.0, worst_fault
    print(f"local-only backward: error / bound {worst_fault:.3e}")


def test_gather_dict_is_the_identity_at_world_1():
    """Without a group gather_dict returns its argument."""
    from synchformer_tpu_torch.train.metrics import gather_dict

    local = {"logits": np.zeros((3, 2)), "loss": 0.25, "tag": "x"}
    assert gather_dict(local) is local


def test_gather_dict_semantics(group):
    """Arrays concatenate in rank order, ragged ones too (3 rows and 2), lists
    become arrays, ints and floats average, strings pass through."""
    for res in group["ranks"]:
        g = res["gather_dict_case"]
        np.testing.assert_array_equal(g["logits"], np.repeat([0.0, 1.0], 3)[:, None]
                                      * np.ones((1, 2)))
        assert g["ragged"].shape == (5, 4)
        np.testing.assert_array_equal(g["ragged"][:, 0], [0, 0, 0, 1, 1])
        np.testing.assert_array_equal(g["as_list"], [0, 0, 1, 1])
        assert g["loss"] == pytest.approx(0.5) and g["count"] == pytest.approx(1.5)
        assert g["tag"] == "keep-me"


def test_sampler_and_loaders_shard_the_epoch(group):
    """EpochSampler's shards are disjoint and exhaustive; the trainer's loader
    yields batch_size / 2 rows a rank; a global batch that does not divide
    over the ranks raises."""
    r0, r1 = (r["sampler_case"] for r in group["ranks"])
    i0, i1 = set(r0["indices"]), set(r1["indices"])
    assert i0.isdisjoint(i1) and i0 | i1 == set(range(10))
    assert len(r0["indices"]) == len(r1["indices"]) == 5
    batch = TINY_AVCLIP_CFG["training"]["base_batch_size"]
    for r in (r0, r1):
        assert r["local_batch"] == batch // WORLD
        assert r["batch_rows"] == [batch // WORLD]
        assert "must divide over the 2 ranks" in r["odd_batch"]


def test_eval_metrics_at_world_2_equal_world_1(group):
    """SyncTrainer's valid phase over 7 clips (rank 0's shard 4, rank 1's 3):
    the gathered logits are world 1's (every clip at the global batch, in the
    same process) in rank order, and every metric equals world 1's over the
    same clips."""
    order = np.concatenate([np.arange(0, N_VALID, WORLD), np.arange(1, N_VALID, WORLD)])
    for res in group["ranks"]:
        got, want = res["eval_metrics_case"], res["eval_metrics_case"]["world1"]
        assert got["logits"].shape == (N_VALID, 21)
        np.testing.assert_allclose(got["logits"], want["logits"][order], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got["targets"], want["targets"][order])
        assert got["metrics"].keys() == want["metrics"].keys()
        for key, value in want["metrics"].items():
            if isinstance(value, float):
                assert got["metrics"][key] == pytest.approx(value, rel=1e-6, abs=1e-9), key
        assert got["metrics"]["per_class"] == pytest.approx(want["metrics"]["per_class"])


@pytest.mark.parametrize("trainer", ["avclip", "sync"])
def test_model_parallel_above_1_is_refused(trainer):
    """At world 1 training.model_parallel 2 raises ValueError (world 1 does
    not split into a (data x model) grid with a model axis of 2), in both
    trainers; 1 is accepted."""
    cfg = copy.deepcopy(TINY_AVCLIP_CFG if trainer == "avclip" else TINY_CFG)
    make = AVCLIPTrainer if trainer == "avclip" else SyncTrainer
    cfg["training"]["model_parallel"] = 2
    with pytest.raises(ValueError, match=r"world 1 does not split into model_parallel 2"):
        make(cfg, device="cpu")
    cfg["training"]["model_parallel"] = 1
    assert make(cfg, device="cpu").local_batch == cfg["training"]["base_batch_size"]


def test_world_1_makes_no_group_and_keeps_the_streams(monkeypatch):
    """Without torchrun's environment init_from_env joins nothing; the
    trainer runs the module itself (no DDP) and draws today's streams: the
    device generator from training.seed, the augmentations' from seed + 7."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert pdist.init_from_env("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized() and pdist.world() == 1
    x = torch.arange(4.0)
    assert pdist.all_gather_with_grad(x) is x and pdist.all_gather_no_grad(x) is x
    model = build_tiny_avclip()
    assert pdist.wrap_ddp(model, "cpu") is model
    cfg = copy.deepcopy(TINY_AVCLIP_CFG)
    tr = AVCLIPTrainer(cfg, device="cpu")
    assert tr.net is tr.model
    seed = cfg["training"]["seed"]
    assert torch.equal(tr.generator.get_state(), torch.Generator().manual_seed(seed).get_state())
    assert torch.equal(tr.aug_generator.get_state(),
                       torch.Generator().manual_seed(seed + 7).get_state())
    assert pdist.local_batch_size(3) == 3
