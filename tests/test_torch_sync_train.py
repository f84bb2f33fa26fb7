"""The port's Stage II/III training slice against the JAX package on the CPU.

A tiny Synchformer (presets.TINY: D=256, 4 heads of 64, depth 2, 32 px
frames, the real 128 x 66 mel geometry; S=2, B=2), offset (21 classes) and
syncability (2 classes), every dropout and drop-path rate 0, gets the JAX
model's parameters through state_dict_from_jax. Both sides take the same
normalised frames (JAX as (B, S, T, H, W, C) through its conv patch embed,
the port patch-major) and log-mel, in f32; the JAX side runs its XLA path.
The towers are frozen (the projections and the transformer train) unless a
test says otherwise.

Tolerances (tests/test_torch_train.py's):
- loss, grad_norm: rtol 1e-5; logits (training and eval): max |port - JAX|
  <= 1e-5 x max |JAX| (an element-wise rtol would hold a logit near 0 to
  the rounding of a tiny number, where the towers' error reaches every
  logit alike: seen 1.2e-6 and 3.8e-6 of the largest);
- every trainable gradient: max |port - JAX| <= 2e-5 x the largest |JAX|
  gradient of its layer + 1e-8, a bias's layer being the bias with its
  weight: a bias's gradient is a sum over tokens and samples whose terms
  cancel (the attention key biases' are 0 in exact arithmetic, the softmax
  being shift-invariant; the syncability head's sum p - y over 2 classes),
  so its own largest value understates the rounding of those terms;
- parameters after one Adam step (constant_with_warmup, clip 1.0): atol 2e-6
  where the clipped gradient exceeds 1e-5, else the step itself, 2 x lr +
  2e-6 (the first Adam step's sign is set by rounding there);
- the eval step's per-example loss: rtol 1e-5, atol 1e-6.
Also the dropouts' semantics. Trainable towers, the checkpoint surgery and
SyncTrainer: tests/test_torch_sync_trainer.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import JAX_AUD, JAX_VIS, jax_gt_cfg, randomize

from synchformer_tpu_torch.models.layers import MinGPTBlock
from synchformer_tpu_torch.models.presets import TINY, build_tiny_synchformer
from synchformer_tpu_torch.models.sync_model import GlobalTransformer, token_dropout
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.video import patchify_frames
from synchformer_tpu_torch.train import state as tstate
from synchformer_tpu_torch.train.step import sync_eval_step, sync_train_step
from synchformer_tpu_torch.utils import convert

torch.set_num_threads(2)

B, S = 2, 2
LR, WARMUP = 1e-2, 5
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_REL_TO_MAX = 2e-5
PARAM_ATOL, SETTLED_GRAD = 2e-6, 1e-5
EVAL_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_REL_TO_MAX = 1e-5
TARGETS = {False: np.array([3, 17]), True: np.array([1, 0])}
AST = "synchformer_tpu.models.ast_encoder.ASTEncoder"
MOTIONFORMER = "synchformer_tpu.models.motionformer.MotionFormerEncoder"
TRANSFORMERS = {False: "synchformer_tpu.models.sync_model.GlobalTransformer",
                True: "synchformer_tpu.models.sync_model.GlobalTransformerWithSyncabilityHead"}


def jax_sync_model(syncability: bool, n_segments: int = S):
    """The tiny JAX Synchformer with every dropout and drop-path at 0."""
    from synchformer_tpu.models.sync_model import Synchformer

    d = TINY["d"]
    lin = dict(target="torch.nn.Linear", params=dict(in_features=d, out_features=d))
    gt = dict(jax_gt_cfg(n_segments), embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    return Synchformer(
        afeat_extractor=dict(target=AST, params=JAX_AUD),
        vfeat_extractor=dict(target=MOTIONFORMER, params=dict(JAX_VIS, drop_path_rate=0.0)),
        aproj=lin, vproj=lin, transformer=dict(target=TRANSFORMERS[syncability], params=gt))


def port_sync_model(syncability: bool, params=None, n_segments: int = S):
    model = build_tiny_synchformer(n_segments, syncability=syncability, dropout=0.0,
                                   drop_path_rate=0.0)
    if params is not None:
        convert.load_numpy_state_dict(model, convert.state_dict_from_jax(params))
    return model


def trainable_sd(tree) -> dict:
    """The trainable subtree (a_proj, v_proj, sync_transformer) in port names."""
    return {**convert._linear(tree["v_proj"]["linear"], "vproj"),
            **convert._linear(tree["a_proj"]["linear"], "aproj"),
            **convert.global_transformer_sd(tree["sync_transformer"], "transformer.")}


def jax_step_state(params, trainable_keys=None):
    from synchformer_tpu.train.state import (
        SYNC_TRAINABLE_KEYS,
        SyncTrainState,
        make_lr_schedule,
        make_optimizer,
    )

    tx = make_optimizer("adam", lr=make_lr_schedule("constant_with_warmup", LR, WARMUP),
                        max_clip_norm=1.0, eps=1e-8)
    return SyncTrainState.create(params, tx, trainable_keys or SYNC_TRAINABLE_KEYS)


@pytest.fixture(scope="module", params=[False, True], ids=["offset", "syncability"])
def case(request):
    from synchformer_tpu.train.state import merge_params
    from synchformer_tpu.train.step import make_sync_eval_step, make_sync_train_step

    syncability = request.param
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (B, S, 2 * TINY["temporal_resolution"], TINY["img_size"],
                               TINY["img_size"], 3), np.uint8)
    frames = ((u8.astype(np.float32) / 255.0) - 0.5) / 0.5
    aud = rng.standard_normal((B, S, 66, 128)).astype(np.float32)
    targets = TARGETS[syncability]
    model = jax_sync_model(syncability)
    params = jax_params(model, frames, aud)
    batch = {"vis": jnp.asarray(frames), "aud": jnp.asarray(aud), "targets": jnp.asarray(targets)}
    state = jax_step_state(params)
    train_step = make_sync_train_step(model, donate=False)
    eval_step = make_sync_eval_step(model)

    def loss_fn(trainable):
        return model.apply({"params": merge_params(trainable, state.frozen)}, batch["vis"],
                           batch["aud"], batch["targets"], deterministic=False,
                           extractors_deterministic=True,
                           rngs={"dropout": jax.random.PRNGKey(1),
                                 "droppath": jax.random.PRNGKey(2)})

    @jax.jit
    def everything(state):  # one XLA program: the steps' jits inline
        return (jax.value_and_grad(loss_fn, has_aux=True)(state.trainable),
                eval_step(state.trainable, state.frozen, batch),
                train_step(state, batch, jax.random.PRNGKey(0)))

    ((loss, logits), grads), ev, (new_state, metrics) = everything(state)
    return dict(syncability=syncability, model=model, params=params, frames=frames, aud=aud,
                targets=targets, batch=batch, loss=float(loss), logits=np.asarray(logits),
                grads=trainable_sd(grads), new_params=trainable_sd(new_state.trainable),
                metrics={k: float(v) for k, v in metrics.items()},
                eval={k: np.asarray(v) for k, v in ev.items()})


def jax_params(model, frames, aud):
    """Randomised parameters of ``model`` (numpy leaves), from the shapes of
    its init: nothing compiles."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(frames),
                            jnp.asarray(aud))
    return randomize(shapes)["params"]


def port_inputs(case):
    vis = torch.from_numpy(np.ascontiguousarray(patchify_frames(case["frames"], 2,
                                                                TINY["patch_size"])))
    return vis, torch.from_numpy(case["aud"]), torch.from_numpy(case["targets"])


def frozen_port_model(case):
    model = port_sync_model(case["syncability"], case["params"])
    tstate.set_trainable(model, tstate.SYNC_TRAINABLE_KEYS)
    return model


def assert_logits_close(got: np.ndarray, want: np.ndarray) -> None:
    """max |port - JAX| <= 1e-5 x max |JAX|: the towers' f32 sums in another
    order reach every logit alike, so a logit near 0 carries the absolute
    error of the large ones."""
    err, bound = float(np.abs(got - want).max()), LOGIT_REL_TO_MAX * float(np.abs(want).max())
    assert err <= bound, (err, bound)


def layer_scale(grads: dict, name: str) -> float:
    """The largest |gradient| of ``name``'s layer: a bias with its weight."""
    names = [name] + ([name[:-len("bias")] + "weight"] if name.endswith(".bias") else [])
    return max(float(np.abs(grads[n]).max()) for n in names if n in grads)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_sync_loss_logits_and_grads_match_jax(case, impl):
    """Loss, logits and every trainable gradient against jax.value_and_grad
    over the trainable subtree of Synchformer.apply(deterministic=False); the
    frozen towers run under no_grad (no gradient, no kernel launch on the
    CPU)."""
    model = frozen_port_model(case)
    vis, aud, targets = port_inputs(case)
    _build.launches.clear()
    loss, logits = model(vis, aud, targets, impl, deterministic=False,
                         generator=torch.Generator(), extractors_deterministic=True)
    loss.backward()
    assert sum(_build.launches.values()) == 0
    np.testing.assert_allclose(loss.item(), case["loss"], **LOSS_TOL)
    assert_logits_close(logits.detach().numpy(), case["logits"])
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.requires_grad}
    assert sorted(grads) == sorted(case["grads"])
    assert all(p.grad is None for n, p in model.named_parameters() if not p.requires_grad)
    for name, g in grads.items():
        err = float(np.abs(g - case["grads"][name]).max())
        bound = GRAD_REL_TO_MAX * layer_scale(case["grads"], name) + 1e-8
        assert err <= bound, (name, err, bound)


def test_sync_train_step_matches_jax(case):
    """One sync_train_step (Adam, constant_with_warmup, clip 1.0) against
    make_sync_train_step: loss and grad_norm at rtol 1e-5, accuracy_1 equal,
    the trainable parameters after it at PARAM_ATOL, the frozen ones
    untouched."""
    model = frozen_port_model(case)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    vis, aud, targets = port_inputs(case)
    opt = tstate.make_optimizer("adam", model.parameters(), eps=1e-8)
    sched = tstate.make_lr_schedule("constant_with_warmup", LR, WARMUP)
    m = sync_train_step(model, opt, sched, 0, vis, aud, targets, torch.Generator(), "kernel", 1.0)
    want = case["metrics"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), want[key], err_msg=key, **LOSS_TOL)
    assert float(m["accuracy_1"]) == want["accuracy_1"] and bool(m["loss_finite"])
    clip = max(want["grad_norm"], 1.0)
    lr0 = sched(0)
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, before[name]), name
            continue
        settled = np.abs(case["grads"][name]) / clip > SETTLED_GRAD
        atol = np.where(settled, PARAM_ATOL, 2 * lr0 + PARAM_ATOL)
        err = np.abs(p.detach().numpy() - case["new_params"][name])
        assert np.all(err <= atol), (name, float((err - atol).max()))


def test_sync_eval_step_matches_jax(case):
    """sync_eval_step against make_sync_eval_step: f32 logits, loss_vec,
    targets."""
    vis, aud, targets = port_inputs(case)
    out = sync_eval_step(port_sync_model(case["syncability"], case["params"]), vis, aud, targets)
    assert out["logits"].dtype == out["loss_vec"].dtype == torch.float32
    assert_logits_close(out["logits"].numpy(), case["eval"]["logits"])
    np.testing.assert_allclose(out["loss_vec"].numpy(), case["eval"]["loss_vec"], **EVAL_TOL)
    np.testing.assert_array_equal(out["targets"].numpy(), case["eval"]["targets"])


def test_token_dropout_semantics():
    """Whole tokens are zeroed (one draw per token), survivors scale by
    1 / (1 - p), one generator seed gives one mask, rate 0 is the identity."""
    p = 0.3
    x = torch.randn(4, 50, 16)
    a = token_dropout(x, p, torch.Generator().manual_seed(0))
    b = token_dropout(x, p, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    dropped = (a == 0).all(-1)
    assert 0 < int(dropped.sum()) < dropped.numel()
    assert torch.equal((a == 0).any(-1), dropped)  # a token goes whole
    kept = ~dropped
    torch.testing.assert_close(a[kept], x[kept] / (1 - p), rtol=0, atol=0)
    assert token_dropout(x, 0.0, torch.Generator()) is x


def test_transformer_dropouts_train_and_eval():
    """The GlobalTransformer's eval forward ignores the generator; training
    with rates > 0 differs from it and repeats under one seed; the block's
    dropouts at rate 0 are the eval code."""
    gt = GlobalTransformer(2, 4, 64, seq_len=12, num_cls=5, tok_pdrop=0.2)
    sd = convert.seeded_state_dict(gt, 0)
    convert.load_numpy_state_dict(gt, sd)
    v, a = torch.randn(3, 6, 64), torch.randn(3, 4, 64)
    ev = gt(v, a)
    assert torch.equal(gt(v, a, True, torch.Generator()), ev)
    t1 = gt(v, a, False, torch.Generator().manual_seed(3))
    t2 = gt(v, a, False, torch.Generator().manual_seed(3))
    assert torch.equal(t1, t2) and not torch.allclose(t1, ev)
    with pytest.raises(ValueError, match="generator"):
        gt(v, a, False)
    blk = MinGPTBlock(64, 4)
    convert.load_numpy_state_dict(blk, convert.seeded_state_dict(blk, 1))
    x = torch.randn(2, 7, 64)
    assert torch.equal(blk(x, "plain", generator=torch.Generator()), blk(x, "plain"))


