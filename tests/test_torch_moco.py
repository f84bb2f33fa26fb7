"""The port's MoCo Stage I slice (MultilevelMoCoCLIP with global
representations, its step and its trainer dispatch) against the JAX package
on the CPU.

A tiny MoCo model (presets.TINY widths at depth 1: D=256, 4 heads of 64, 32 px
frames, the real 128 x 66 mel geometry; both towers add_global_repr over
S=2 segments; drop-path 0; B=2; queue_size 4, so the segment queue is 8 and
the global queue 4) gets the JAX model's parameters through
moco_state_dict_from_jax, its EMA copy other random parameters, and its
queues JAX's init_queues as numpy. The video tower's pos_dropout is 1e-9:
flax's Dropout applies it as an exact identity (the keep probability rounds
to 1.0 in f32), and so does the port's, but it is above 0, so the query
pass's video global aggregator keeps its CLS row inside x and takes K4b
(JAX: fused_cls_pool, counted at _cls_pool_pallas; at B=2 its _seg_chunk is
2, so the Pallas kernel runs, in interpret mode).

The JAX step (make_moco_train_step) runs both towers on attn_impl='pallas'
in interpret mode; the gradients (jax.value_and_grad of the same loss) and
the eval step (make_moco_eval_step) run on the XLA path, which computes the
same function with exact-erf GELU. Tolerances are tests/test_torch_train.py's:
losses rtol 1e-5, each gradient within 2e-5 of its tensor's largest + 1e-8,
parameters after AdamW within 2e-6 where the clipped gradient exceeds 1e-5;
the EMA parameters rtol 1e-6 (one multiply-add in f32), the enqueued keys
atol 1e-5 (unit vectors from the f32 key pass), the pointers exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_models import randomize
from test_torch_train import GRAD_REL_TO_MAX, LOSS_TOL, PARAM_ATOL, SETTLED_GRAD

from synchformer_tpu_torch.models.moco_clip import MoCoQueues, moco_forward, momentum_update
from synchformer_tpu_torch.models.presets import TINY, build_tiny_moco_avclip
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.video import patchify_frames
from synchformer_tpu_torch.train import state as tstate
from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
from synchformer_tpu_torch.train.step import moco_eval_step, moco_train_step
from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, moco_state_dict_from_jax

torch.set_num_threads(2)

T = dict(TINY, depth=1)  # build_tiny_moco_avclip's towers, S segments, queue_size Q
B, S, Q = 2, 2, 4
MOMENTUM, ALPHA, POS_DROP = 0.9, 0.4, 1e-9
LR, WARMUP, TOTAL, WD = 1e-3, 2, 20, 0.2
MOCO_TARGET = "synchformer_tpu.models.moco_clip.MultilevelMoCoCLIP"


def jax_tiny_moco(attn_impl: str):
    from synchformer_tpu.models.moco_clip import MultilevelMoCoCLIP

    glob = dict(agg_time_module="AveragePooling", add_global_repr=True,
                agg_segments_module="TransformerEncoderLayer", max_segments=S,
                attn_impl=attn_impl)
    vis = dict(embed_dim=T["d"], depth=T["depth"], num_heads=T["heads"],
               patch_size=T["patch_size"], z_block_size=2,
               temporal_resolution=T["temporal_resolution"], img_size=T["img_size"],
               drop_path_rate=0.0, pos_dropout=POS_DROP, **glob)
    aud = dict(hidden_size=T["d"], depth=T["depth"], num_heads=T["audio_heads"], **glob)
    nothing = dict(target="synchformer_tpu.models.bridges.DoNothingBridge", params={})
    return MultilevelMoCoCLIP(
        n_embd=T["d"], queue_size=Q, momentum=MOMENTUM, aproj=nothing, vproj=nothing,
        afeat_extractor=dict(target="synchformer_tpu.models.ast_encoder.ASTEncoder",
                             params=aud),
        vfeat_extractor=dict(target="synchformer_tpu.models.motionformer.MotionFormerEncoder",
                             params=vis))


def build_port():
    return build_tiny_moco_avclip(pos_dropout=POS_DROP)


def _queues_np(q):
    return {k: np.asarray(getattr(q, k)) for k in ("segment_v", "segment_a", "segment_ptr",
                                                    "global_v", "global_a", "global_ptr")}


@pytest.fixture(scope="module")
def case(monkeypatch_module):
    """JAX side: randomised params (scales 0.07) and EMA params, queues,
    inputs; make_moco_train_step's state, EMA, queues and metrics after one
    step on 'pallas' (interpret mode), with the number of K4b traces; the XLA
    path's loss per level and gradients; make_moco_eval_step's outputs."""
    from synchformer_tpu.models.moco_clip import init_queues
    from synchformer_tpu.models.moco_clip import moco_forward as jmoco_forward
    from synchformer_tpu.models.moco_clip import momentum_update as jmomentum_update
    from synchformer_tpu.ops.pallas import cls_pool as jcls
    from synchformer_tpu.train.stage_clip import zero_shot_precision
    from synchformer_tpu.train.state import SyncTrainState, make_lr_schedule, make_optimizer
    from synchformer_tpu.train.step import make_moco_eval_step, make_moco_train_step

    rng = np.random.default_rng(0)
    t_in = 2 * T["temporal_resolution"]
    u8 = rng.integers(0, 256, (B, S, t_in, T["img_size"], T["img_size"], 3), np.uint8)
    frames = ((u8.astype(np.float32) / 255.0) - 0.5) / 0.5
    aud = rng.standard_normal((B, S, 66, 128)).astype(np.float32)
    batch = {"vis": jnp.asarray(frames), "aud": jnp.asarray(aud)}
    xla = jax_tiny_moco("xla")
    params = randomize(jax.jit(xla.init)(jax.random.PRNGKey(0), batch["vis"],
                                         batch["aud"]))["params"]
    scales = {k: jnp.asarray(0.07, jnp.float32)
              for k in ("segment_logit_scale", "global_logit_scale")}
    params = {**params, **scales}
    params_m = {**randomize(params, seed=2), **scales}
    queues = init_queues(jax.random.PRNGKey(1), T["d"], Q * S, Q)
    moco = {"params_m": params_m, "queues": queues}

    traces = []
    entry = jcls._cls_pool_pallas
    monkeypatch_module.setattr(jcls, "_cls_pool_pallas",
                               lambda *a, **k: (traces.append(a[0].shape), entry(*a, **k))[1])
    sched = make_lr_schedule("cosine", LR, WARMUP, TOTAL)
    tx = make_optimizer("adamw", lr=sched, weight_decay=WD, max_clip_norm=1.0,
                        weight_decay_mask=jax.tree.map(lambda p: p.ndim >= 2, params))
    state = SyncTrainState.create(params, tx, trainable_keys=tuple(params.keys()))
    with pltpu.force_tpu_interpret_mode():
        new_state, new_moco, metrics = make_moco_train_step(jax_tiny_moco("pallas"), donate=False)(
            state, moco, batch, jax.random.PRNGKey(0), jnp.float32(ALPHA))

    def loss_fn(p):
        losses, _, _ = jmoco_forward(xla, p, jmomentum_update(p, params_m, MOMENTUM), queues,
                                     batch["vis"], batch["aud"], alpha=ALPHA, train=True,
                                     rngs={"dropout": jax.random.PRNGKey(3),
                                           "droppath": jax.random.PRNGKey(4)})
        return sum(losses.values()), losses

    (loss, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    ev = make_moco_eval_step(xla, zero_shot_precision)(params, moco, batch, 1)
    return dict(frames=frames, aud=aud, params=params, params_m=params_m,
                queues=_queues_np(queues), k4b_traces=list(traces),
                losses={k: float(v) for k, v in losses.items()}, loss=float(loss),
                grads=moco_state_dict_from_jax(grads),
                grad_norm=float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(grads)))),
                metrics={k: float(v) for k, v in metrics.items()},
                new_params=moco_state_dict_from_jax(new_state.trainable),
                new_params_m=moco_state_dict_from_jax(new_moco["params_m"]),
                new_queues=_queues_np(new_moco["queues"]),
                eval={k: np.asarray(v) for k, v in ev.items()})


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def port_models(case):
    model, model_m = build_port(), build_port().requires_grad_(False)
    load_numpy_state_dict(model, moco_state_dict_from_jax(case["params"]))
    load_numpy_state_dict(model_m, moco_state_dict_from_jax(case["params_m"]))
    q = case["queues"]
    queues = MoCoQueues(*(torch.from_numpy(np.array(q[k])) for k in ("segment_v", "segment_a")),
                        int(q["segment_ptr"]),
                        *(torch.from_numpy(np.array(q[k])) for k in ("global_v", "global_a")),
                        int(q["global_ptr"]))
    return model, model_m, queues


def port_inputs(case):
    vis = torch.from_numpy(np.ascontiguousarray(patchify_frames(case["frames"], 2,
                                                                T["patch_size"])))
    return vis, torch.from_numpy(case["aud"])


def test_jax_query_pass_took_k4b(case):
    """The JAX step's query pass traced fused_cls_pool's Pallas entry once:
    the video global aggregator over [cls; 2 segments]."""
    assert case["k4b_traces"] == [(B, 1 + S, T["d"])]


def test_tiny_moco_forward_matches_jax(case):
    """Both levels' normalised features of the deterministic forward against
    MultilevelMoCoCLIP.apply (XLA path), and the clamped scales."""
    model, _, _ = port_models(case)
    vis, aud = port_inputs(case)
    want = jax.jit(lambda p, v, a: jax_tiny_moco("xla").apply({"params": p}, v, a))(
        case["params"], jnp.asarray(case["frames"]), jnp.asarray(case["aud"]))
    got = model(vis, aud, "kernel")
    assert got["segment_vfeat"].shape == (B * S, T["d"])
    assert got["global_vfeat"].shape == (B, T["d"])
    for key in ("segment_vfeat", "segment_afeat", "global_vfeat", "global_afeat"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for got_s, want_s in zip(model.scales(), want["logit_scales"]):
        assert got_s.item() == pytest.approx(float(want_s))


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_tiny_moco_loss_and_grads_match_jax(case, impl):
    """Each level's loss and every gradient of the summed loss (EMA update,
    query and key passes, ALBEF targets at alpha 0.4) against
    jax.value_and_grad; no launch on CPU tensors."""
    model, model_m, queues = port_models(case)
    vis, aud = port_inputs(case)
    _build.launches.clear()
    momentum_update(model, model_m, MOMENTUM)
    losses, _, _ = moco_forward(model, model_m, queues, vis, aud, impl, torch.Generator(),
                                ALPHA, train=True)
    sum(losses.values()).backward()
    assert sum(_build.launches.values()) == 0
    for key, want in case["losses"].items():
        np.testing.assert_allclose(losses[key].item(), want, err_msg=key, **LOSS_TOL)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(case["grads"])
    for name, g in grads.items():
        want = case["grads"][name]
        bound = GRAD_REL_TO_MAX * float(np.abs(want).max()) + 1e-8
        assert float(np.abs(g - want).max()) <= bound, name


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_tiny_moco_train_step_matches_jax(case, impl):
    """One moco_train_step against make_moco_train_step (query pass on the
    Pallas kernels, K4b among them): metrics, the parameters after AdamW
    (no scale clamp), the EMA parameters, the rolled queues and pointers."""
    model, model_m, queues = port_models(case)
    vis, aud = port_inputs(case)
    opt = tstate.make_adamw(model.named_parameters(), WD)
    sched = tstate.make_lr_schedule("cosine", LR, WARMUP, TOTAL)
    metrics = moco_train_step(model, model_m, queues, opt, sched, 0, vis, aud,
                              torch.Generator(), ALPHA, impl, 1.0)
    want = case["metrics"]
    for key in ("loss", "segment_contrastive_loss", "global_contrastive_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), want[key], err_msg=key, **LOSS_TOL)
    assert bool(metrics["loss_finite"]) and want["loss_finite"] == 1.0
    assert want["grad_norm"] > 1.0  # the clip is active
    clip, lr0 = max(want["grad_norm"], 1.0), sched(0)
    n_settled = n_all = 0
    for name, p in model.state_dict().items():
        settled = np.abs(case["grads"][name]) / clip > SETTLED_GRAD
        atol = np.where(settled, PARAM_ATOL, 2 * lr0 + PARAM_ATOL)
        assert np.all(np.abs(p.numpy() - case["new_params"][name]) <= atol), name
        n_settled, n_all = n_settled + int(settled.sum()), n_all + settled.size
    # the tight bound covers most elements: 88% here, where the four CLS-pool
    # layers (half of the tiny model's parameters) hold many gradients near 0
    assert n_settled > 0.85 * n_all
    for name, p in model_m.state_dict().items():
        np.testing.assert_allclose(p.numpy(), case["new_params_m"][name], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    new_q = case["new_queues"]
    for key in ("segment_v", "segment_a", "global_v", "global_a"):
        np.testing.assert_allclose(getattr(queues, key).numpy(), new_q[key], atol=1e-5,
                                   err_msg=key)
    assert (queues.segment_ptr, queues.global_ptr) == (B * S, B)
    assert (queues.segment_ptr, queues.global_ptr) == (int(new_q["segment_ptr"]),
                                                       int(new_q["global_ptr"]))


def test_tiny_moco_eval_step_matches_jax(case):
    """moco_eval_step against make_moco_eval_step: the summed loss against
    the queues as they stand, the query pass's segment features and the
    zero-shot precision; the queues are not written."""
    model, model_m, queues = port_models(case)
    vis, aud = port_inputs(case)
    before = queues.segment_v.clone()
    out = moco_eval_step(model, model_m, queues, vis, aud, window=1)
    want = case["eval"]
    np.testing.assert_allclose(float(out["loss"]), float(want["loss"]), **LOSS_TOL)
    for key in ("vfeat", "afeat"):
        np.testing.assert_allclose(out[key].numpy(), want[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    assert float(out["precision"]) == pytest.approx(float(want["precision"]))
    assert torch.equal(queues.segment_v, before) and queues.segment_ptr == 0


def test_trainer_dispatches_on_the_model_target():
    """cfg.model.target naming MoCoCLIP trains MultilevelMoCoCLIP: the
    momentum model a copy without gradients, queues of queue_size x
    max_segments and queue_size, alpha from training.alpha and its epoch-0
    ramp; a MoCo model under another target is refused. Two f32 steps and an
    eval step on the loader's batch layout, with drop-path and the positional
    dropout live."""
    rng = np.random.default_rng(2)
    batch = {"video": rng.integers(0, 256, (B, S, 4, 32, 32, 3), dtype=np.uint8),
             "audio": (rng.standard_normal((B, S, 10240)) * 0.1).astype(np.float32)}
    cfg = {"model": {"target": MOCO_TARGET},
           "training": {"precision": "fp32", "seed": 0, "warmup": 2, "total_steps": 10,
                        "zero_shot_window": 1, "alpha": 0.4}}
    model = build_tiny_moco_avclip(drop_path_rate=0.2)
    from synchformer_tpu_torch.utils.convert import seeded_state_dict

    load_numpy_state_dict(model, seeded_state_dict(model, 0))
    with pytest.raises(TypeError, match="does not name"):
        AVCLIPTrainer({"training": {"seed": 0}}, device="cpu", model=model)
    trainer = AVCLIPTrainer(cfg, device="cpu", model=model)
    assert trainer.is_moco and trainer.alpha == 0.4
    assert all(not p.requires_grad for p in trainer.model_m.parameters())
    assert trainer.queues.segment_v.shape == (T["d"], Q * S)
    assert trainer.queues.global_v.shape == (T["d"], Q)
    assert trainer.alpha_at(0, 1, 4) == pytest.approx(0.1)
    assert trainer.alpha_at(1, 0, 4) == 0.4
    ema0 = trainer.model_m.segment_logit_scale.item()
    for _ in range(2):
        m = trainer.train_step(batch)
        assert m["loss_finite"] and np.isfinite(m["grad_norm"])
        assert m["loss"] == pytest.approx(m["segment_contrastive_loss"]
                                          + m["global_contrastive_loss"])
    assert (trainer.queues.segment_ptr, trainer.queues.global_ptr) == (0, 0)  # 2 x 4 of 8
    assert trainer.model_m.segment_logit_scale.item() != ema0
    out = trainer.eval_step(batch)
    assert out["vfeat"].shape == (B, S, T["d"]) and torch.isfinite(out["loss"])
