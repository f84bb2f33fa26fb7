"""The port's Stage I training slice against the JAX package on the CPU.

A tiny AVCLIP (presets.TINY towers: D=256, 4 heads of 64, depth 2, 32 px
frames, the real 128 x 66 mel geometry; drop-path 0; S=2, B=2) gets the JAX
model's parameters through avclip_state_dict_from_jax. The check_* helpers
serve tests/test_torch_packed.py's packed-flow AVCLIP as well. Both sides take the
same normalised frames (JAX as (B, S, T, H, W, C) through its conv patch
embed, the port patch-major through its dense one) and the same log-mel, in
f32. The JAX side runs its XLA path; the Pallas kernels and their custom
VJPs are held against the port in tests/test_torch_kernels_bwd.py.

Tolerances:
- loss, grad_norm and eval features: rtol 1e-5 (f32 sums in another order);
- every parameter gradient: max |port - JAX| <= 2e-5 x max |JAX| + 1e-8 per
  tensor (f32 rounding in another order through 2 x 2 layers, the
  normalisation and the loss, relative to the tensor's scale: elements near 0
  carry the absolute error of the large ones; 1e-8 for the gradients that are
  0 in exact arithmetic, such as the attention key biases', which both sides
  give as rounding noise);
- parameters after one AdamW step at lr 5e-4: atol 2e-6 where the clipped
  gradient exceeds 1e-5. The first Adam step moves an element by
  lr * g / (|g| + 1e-8), whose sensitivity to g grows as |g| nears 1e-8: below
  1e-5 the gradients' f32 rounding (~1e-9) can move the step by several
  percent of lr, and at rounding level its sign, so there the bound is the
  step itself, 2 x lr + 2e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import randomize

from synchformer_tpu_torch.models.layers import DropPath
from synchformer_tpu_torch.models.presets import TINY, build_tiny_avclip
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.video import patchify_frames, prepare_video_batch
from synchformer_tpu_torch.train import state as tstate
from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
from synchformer_tpu_torch.train.step import (
    avclip_eval_step,
    avclip_train_step,
    zero_shot_precision,
)
from synchformer_tpu_torch.utils.convert import avclip_state_dict_from_jax, load_numpy_state_dict

torch.set_num_threads(2)

B, S = 2, 2
LR, WARMUP, TOTAL, WD = 1e-3, 2, 20, 0.2
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_REL_TO_MAX = 2e-5
PARAM_ATOL, SETTLED_GRAD = 2e-6, 1e-5


def jax_tiny_avclip(t, attn_impl: str = "xla"):
    """The JAX AVCLIP at the tiny widths ``t`` (presets.TINY or TINY_PACKED),
    both towers on ``attn_impl`` (default: the XLA path)."""
    from synchformer_tpu.models.avclip import AVCLIP

    vis = dict(embed_dim=t["d"], depth=t["depth"], num_heads=t["heads"],
               patch_size=t["patch_size"], z_block_size=2,
               temporal_resolution=t["temporal_resolution"], img_size=t["img_size"],
               drop_path_rate=0.0, agg_time_module="AveragePooling", attn_impl=attn_impl)
    aud = dict(hidden_size=t["d"], depth=t["depth"], num_heads=t["audio_heads"],
               agg_time_module="AveragePooling", attn_impl=attn_impl)
    nothing = dict(target="synchformer_tpu.models.bridges.DoNothingBridge", params={})
    return AVCLIP(
        n_embd=t["d"],
        afeat_extractor=dict(target="synchformer_tpu.models.ast_encoder.ASTEncoder",
                             params=aud),
        vfeat_extractor=dict(target="synchformer_tpu.models.motionformer.MotionFormerEncoder",
                             params=vis),
        aproj=nothing, vproj=nothing)


@pytest.fixture(scope="module")
def case():
    return make_case(TINY, build_tiny_avclip)


def make_case(t, build, attn_impl: str = "xla"):
    """JAX model at the tiny widths ``t`` on ``attn_impl`` (its Pallas
    kernels in interpret mode), randomised params (logit scale 0.07),
    inputs, the JAX loss and gradients of AVCLIP.apply(deterministic=False),
    its eval features, and the JAX state after one make_avclip_train_step;
    ``build`` makes the port's model."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return _make_case(t, build, attn_impl)


def _make_case(t, build, attn_impl):
    from synchformer_tpu.train.state import SyncTrainState, make_lr_schedule, make_optimizer
    from synchformer_tpu.train.step import make_avclip_train_step

    rng = np.random.default_rng(0)
    t_in = 2 * t["temporal_resolution"]
    u8 = rng.integers(0, 256, (B, S, t_in, t["img_size"], t["img_size"], 3), np.uint8)
    frames = ((u8.astype(np.float32) / 255.0) - 0.5) / 0.5
    aud = rng.standard_normal((B, S, 66, 128)).astype(np.float32)
    model = jax_tiny_avclip(t, attn_impl)
    # the parameter tree does not depend on attn_impl: initialise on the XLA
    # path, which traces no Pallas kernel
    params = randomize(jax.jit(jax_tiny_avclip(t).init)(jax.random.PRNGKey(0), jnp.asarray(frames),
                                                        jnp.asarray(aud)))["params"]
    params = {**params, "logit_scale": jnp.asarray(0.07, jnp.float32)}
    rngs = {"dropout": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(frames), jnp.asarray(aud),
                          deterministic=False, rngs=rngs)
        return out["losses"]["segment_contrastive_loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    ev = jax.jit(lambda p: model.apply({"params": p}, jnp.asarray(frames), jnp.asarray(aud),
                                       deterministic=True))(params)

    sched = make_lr_schedule("cosine", LR, WARMUP, TOTAL)
    tx = make_optimizer("adamw", lr=sched, weight_decay=WD, max_clip_norm=1.0,
                        weight_decay_mask=jax.tree.map(lambda p: p.ndim >= 2, params))
    state = SyncTrainState.create(params, tx, trainable_keys=tuple(params.keys()))
    new_state, metrics = make_avclip_train_step(model, donate=False)(
        state, {"vis": jnp.asarray(frames), "aud": jnp.asarray(aud)}, jax.random.PRNGKey(0))
    return dict(t=t, build=build, params=params, frames=frames, u8=u8, aud=aud,
                loss=float(loss),
                grads=avclip_state_dict_from_jax(grads),
                grad_norm=float(jnp.sqrt(sum(jnp.sum(g * g)
                                             for g in jax.tree.leaves(grads)))),
                eval_loss=float(ev["losses"]["segment_contrastive_loss"]),
                eval_vfeat=np.asarray(ev["rgb_features"][0]),
                eval_afeat=np.asarray(ev["audio_features"][0]),
                new_params=avclip_state_dict_from_jax(new_state.trainable),
                metrics={k: float(v) for k, v in metrics.items()})


def port_model(case, remat=False):
    model = case["build"](remat=remat)
    load_numpy_state_dict(model, avclip_state_dict_from_jax(case["params"]))
    return model


def port_inputs(case):
    vis = torch.from_numpy(np.ascontiguousarray(patchify_frames(case["frames"], 2,
                                                                case["t"]["patch_size"])))
    return vis, torch.from_numpy(case["aud"])


def port_grads(case, impl, remat=False):
    model = port_model(case, remat)
    vis, aud = port_inputs(case)
    loss, _, _ = model(vis, aud, impl, deterministic=False, generator=torch.Generator())
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_avclip_loss_and_grads_match_jax(case, impl):
    """Loss, every parameter's gradient and the global norm against
    jax.value_and_grad of AVCLIP.apply(deterministic=False); the kernel route
    on CPU tensors launches nothing."""
    check_loss_and_grads(case, impl)


def check_loss_and_grads(case, impl):
    _build.launches.clear()
    loss, grads = port_grads(case, impl)
    assert sum(_build.launches.values()) == 0
    np.testing.assert_allclose(loss, case["loss"], **LOSS_TOL)
    assert sorted(grads) == sorted(case["grads"])
    worst = 0.0
    for name, g in grads.items():
        want = case["grads"][name]
        err = float(np.abs(g - want).max())
        bound = GRAD_REL_TO_MAX * float(np.abs(want).max()) + 1e-8
        worst = max(worst, err / bound)
        assert err <= bound, (name, err, bound)
    print(f"worst gradient error / bound: {worst:.3e}")
    norm = float(tstate.global_norm([torch.from_numpy(g) for g in grads.values()]))
    np.testing.assert_allclose(norm, case["grad_norm"], **LOSS_TOL)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_avclip_train_step_matches_jax(case, impl):
    """Parameters and metrics after one avclip_train_step (AdamW, cosine
    schedule with the reference warm-up, clip 1.0, logit-scale clamp) against
    make_avclip_train_step with the same settings."""
    check_train_step(case, impl)


def check_train_step(case, impl):
    model = port_model(case)
    vis, aud = port_inputs(case)
    opt = tstate.make_adamw(model.named_parameters(), WD)
    sched = tstate.make_lr_schedule("cosine", LR, WARMUP, TOTAL)
    _build.launches.clear()
    metrics = avclip_train_step(model, opt, sched, 0, vis, aud, torch.Generator(), impl, 1.0)
    assert sum(_build.launches.values()) == 0
    want = case["metrics"]
    for key in ("loss", "grad_norm", "logit_scale"):
        np.testing.assert_allclose(float(metrics[key]), want[key], err_msg=key, **LOSS_TOL)
    assert bool(metrics["loss_finite"]) and want["loss_finite"] == 1.0
    assert want["grad_norm"] > 1.0  # the clip is active
    lr0 = sched(0)
    clip = max(want["grad_norm"], 1.0)
    n_settled = n_all = 0
    for name, p in model.state_dict().items():
        settled = np.abs(case["grads"][name]) / clip > SETTLED_GRAD
        atol = np.where(settled, PARAM_ATOL, 2 * lr0 + PARAM_ATOL)
        err = np.abs(p.numpy() - case["new_params"][name])
        assert np.all(err <= atol), (name, float((err - atol).max()))
        n_settled, n_all = n_settled + int(settled.sum()), n_all + settled.size
    assert n_settled > 0.9 * n_all  # the tight bound covers nearly every element


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_avclip_eval_step_matches_jax(case, impl):
    """The deterministic eval step (K1-K4 route on impl='kernel') against
    AVCLIP.apply(deterministic=True): loss and the (B, S, D) features; its
    zero-shot precision equals the probe on those features."""
    check_eval_step(case, impl)


def check_eval_step(case, impl):
    from synchformer_tpu.train.stage_clip import zero_shot_precision as jax_zsp

    vis, aud = port_inputs(case)
    out = avclip_eval_step(port_model(case), vis, aud, window=1, impl=impl)
    np.testing.assert_allclose(float(out["loss"]), case["eval_loss"], **LOSS_TOL)
    np.testing.assert_allclose(out["vfeat"].reshape(B * S, -1).numpy(), case["eval_vfeat"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["afeat"].reshape(B * S, -1).numpy(), case["eval_afeat"],
                               rtol=1e-5, atol=1e-6)
    want = float(jax_zsp(jnp.asarray(out["afeat"].numpy()), jnp.asarray(out["vfeat"].numpy()), 1))
    assert float(out["precision"]) == pytest.approx(want)


def test_remat_grads_equal_plain_grads(case):
    """remat=True (torch.utils.checkpoint around every block and layer) gives
    the gradients of remat=False."""
    check_remat(case)


def check_remat(case):
    loss0, g0 = port_grads(case, "kernel")
    loss1, g1 = port_grads(case, "kernel", remat=True)
    assert loss1 == loss0
    for name in g0:
        np.testing.assert_allclose(g1[name], g0[name], rtol=1e-6, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("name", ["cosine", "const"])
def test_lr_schedules_match_jax(name):
    """The port's schedules against make_lr_schedule, step by step over a
    warm-up + decay range. optax computes in f32, and near the cosine's end
    1 + cos cancels: rtol 1e-6 plus 1e-6 of the base rate."""
    from synchformer_tpu.train.state import make_lr_schedule

    want = make_lr_schedule(name, 1e-4, 10, 50)
    got = tstate.make_lr_schedule(name, 1e-4, 10, 50)
    for step in range(0, 60):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-10,
                                   err_msg=str(step))


def test_drop_path_one_draw_per_sample():
    """One draw per sample, shared by the CLS and patch halves; dropped
    samples add exactly zero, kept ones are scaled by 1 / (1 - p)."""
    p, n = 0.4, 64
    dp = DropPath(p)
    scale = dp.draw(n, torch.Generator().manual_seed(0), "cpu", torch.float32)
    again = dp.draw(n, torch.Generator().manual_seed(0), "cpu", torch.float32)
    assert scale.shape == (n,) and torch.equal(scale, again)
    kept_scale = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    assert set(scale.tolist()) == {0.0, kept_scale.item()}
    cls, patches = torch.randn(n, 1, 8), torch.randn(n, 2, 3, 8)
    dc, dpat = DropPath.drop(cls, scale), DropPath.drop(patches, scale)
    dropped = scale == 0
    assert 0 < int(dropped.sum()) < n
    assert torch.all(dc[dropped] == 0) and torch.all(dpat[dropped] == 0)
    assert torch.equal(dc[~dropped], cls[~dropped] * kept_scale)
    assert torch.equal(dpat[~dropped], patches[~dropped] * kept_scale)
    assert DropPath(0.0).draw(n, torch.Generator(), "cpu", torch.float32) is None


def test_prepare_video_batch_matches_jax(case):
    """No flip (eval) and p=1 (every clip flipped) against the JAX
    prepare_video_batch on the same bytes; the flip is drawn per clip."""
    from synchformer_tpu.ops.video import normalize_video
    from synchformer_tpu.ops.video import prepare_video_batch as jax_prepare

    u8 = case["u8"]
    got = prepare_video_batch(torch.from_numpy(u8))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_prepare(jnp.asarray(u8))), atol=1e-6)
    flipped = prepare_video_batch(torch.from_numpy(u8), torch.Generator(), True, 1.0)
    np.testing.assert_allclose(flipped.numpy(),
                               np.asarray(normalize_video(jnp.asarray(u8[..., ::-1, :]))),
                               atol=1e-6)
    half = prepare_video_batch(torch.from_numpy(np.repeat(u8[:1], 8, 0)),
                               torch.Generator().manual_seed(1), True, 0.5)
    kept = [bool(torch.equal(c, got[0])) for c in half]
    turned = [bool(torch.equal(c, flipped[0])) for c in half]
    assert all(k != t for k, t in zip(kept, turned))  # all segments of a clip together
    assert 0 < sum(kept) < len(kept)


def test_zero_shot_precision_matches_jax():
    from synchformer_tpu.train.stage_clip import zero_shot_precision as jax_zsp

    rng = np.random.default_rng(1)
    a, v = rng.standard_normal((4, 10, 16)), rng.standard_normal((4, 10, 16))
    v[:2] = a[:2] + 0.1 * v[:2]
    for w in (1, 4):
        want = float(jax_zsp(jnp.asarray(a, jnp.float32), jnp.asarray(v, jnp.float32), w))
        got = float(zero_shot_precision(torch.tensor(a, dtype=torch.float32),
                                        torch.tensor(v, dtype=torch.float32), w))
        assert got == pytest.approx(want)


def test_trainer_defaults_to_the_card_and_refuses_audio_augs():
    """AVCLIPTrainer's device defaults to 'cuda' and raises without CUDA
    unless the caller asks for the CPU. p_audio_aug 0.2 (the published
    Stage I config's) is accepted: a training prep draws the augmentation
    chain's row masks from the trainer's CPU generator (the crop of
    ``audio_full`` where the batch has it), an eval prep draws nothing."""
    cfg = {"training": {"seed": 0}}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            AVCLIPTrainer(cfg, model=build_tiny_avclip())
    tr = AVCLIPTrainer({**cfg, "data": {"p_audio_aug": 0.2}}, device="cpu",
                       model=build_tiny_avclip())
    rng = np.random.default_rng(0)
    batch = {"video": rng.integers(0, 256, (B, S, 4, 32, 32, 3), dtype=np.uint8),
             "audio": (rng.standard_normal((B, S, 10240)) * 0.1).astype(np.float32)}
    state = tr.aug_generator.get_state()
    tr.prepare(batch, train=False)
    assert torch.equal(tr.aug_generator.get_state(), state)
    tr.prepare(batch, train=True)
    after = tr.aug_generator.get_state()
    assert not torch.equal(after, state)
    want = torch.Generator().set_state(state)
    torch.rand(5 * B, generator=want)  # five (B,) row masks
    assert torch.equal(after, want.get_state())


@pytest.mark.parametrize("moco", [False, True], ids=["avclip", "moco"])
def test_trainer_builds_model_params_through_the_registry(moco):
    """AVCLIPTrainer builds cfg.model from its params through the port's
    registry (a tiny AVCLIP, or a tiny MoCo model with queues of 4 and
    momentum 0.9), seeded from training.seed like its preset: one f32 plain
    step from each gives the same metrics and parameters as the preset's
    trainer."""
    from test_torch_registry import tiny_model_cfg

    from synchformer_tpu_torch.models.presets import build_tiny_moco_avclip
    from synchformer_tpu_torch.utils.convert import seeded_state_dict

    rng = np.random.default_rng(2)
    batch = {"video": rng.integers(0, 256, (B, S, 4, 32, 32, 3), dtype=np.uint8),
             "audio": (rng.standard_normal((B, S, 10240)) * 0.1).astype(np.float32)}
    cfg = {"model": tiny_model_cfg(moco),
           "training": {"precision": "fp32", "seed": 0, "warmup": 2, "total_steps": 10,
                        "alpha": 0.4}}
    built = AVCLIPTrainer(cfg, device="cpu", impl="plain")
    preset = (build_tiny_moco_avclip if moco else build_tiny_avclip)()
    load_numpy_state_dict(preset, seeded_state_dict(preset, 0))
    ref = AVCLIPTrainer({**cfg, "model": {"target": cfg["model"]["target"]}}, device="cpu",
                        model=preset, impl="plain")
    assert built.is_moco == moco
    if moco:  # the config's, not the full-width preset's 1024 / 0.995
        assert (built.model.queue_size, built.model.momentum) == (4, 0.9)
    assert built.train_step(batch) == ref.train_step(batch)
    got, want = built.model.state_dict(), ref.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_trainer_steps_on_cpu():
    """AVCLIPTrainer on the loader's batch layout (uint8 frames, PCM): two f32
    steps on the CPU with drop-path live, finite, the logit scale clamped,
    then an eval step."""
    rng = np.random.default_rng(2)
    batch = {"video": rng.integers(0, 256, (B, S, 4, 32, 32, 3), dtype=np.uint8),
             "audio": (rng.standard_normal((B, S, 10240)) * 0.1).astype(np.float32)}
    cfg = {"training": {"precision": "fp32", "seed": 0, "warmup": 2, "total_steps": 10,
                        "zero_shot_window": 1}}
    model = build_tiny_avclip(drop_path_rate=0.2)
    trainer = AVCLIPTrainer(cfg, device="cpu", model=model)
    for _ in range(2):
        m = trainer.train_step(batch)
        assert m["loss_finite"] and np.isfinite(m["grad_norm"])
        assert 0.001 <= m["logit_scale"] <= 0.5
    assert trainer.step == 2
    out = trainer.eval_step(batch)
    assert out["vfeat"].shape == (B, S, TINY["d"]) and torch.isfinite(out["loss"])
