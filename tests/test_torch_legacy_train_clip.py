"""The Stage I AVCLIP step over the legacy S3D and ResNet-18 towers in the
port against the JAX AVCLIP on the CPU, and AVCLIPTrainer on such a model.

The JAX AVCLIP instantiates its towers from its config nodes
(synchformer_tpu/models/avclip.py:46-47): S3DVisualFeatures and
ResNet18AudioFeatures with the AveragePooling time tail, Linear projections
1024 -> 64 and 512 -> 64. Its trainer keeps ``params`` alone
(synchformer_tpu/train/stage_clip.py:170), so the test composes the JAX step
from the JAX module: jax.value_and_grad over model.apply with
deterministic=False and mutable batch_stats, then optax AdamW (cosine
schedule, clip 1.0, tests/test_torch_train.py's settings) and the logit
scale's clamp. The port's model comes from the same node through its
registry, its weights and running statistics through
convert.avclip_state_dict_from_jax. Frames (1, 2, 16, 64, 64, 3), log-mel
(1, 2, 66, 128) (two InfoNCE pairs), centred seeded weights
(test_torch_legacy_parts.centred).
Tolerances: tests/test_torch_legacy_train.py's hold_family and assert_step
(JAX in f64 the reference, with JAX's own f32 spread: a train-mode S3D in
f32 is ill-conditioned).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_legacy_parts import (
    PERTURB,
    centred,
    closing_norms,
    gap,
    grad_scales,
    hold_family,
    jax_runs,
    jax_vars,
    t,
    value_scales,
)
from test_torch_legacy_train import (
    GRAD_REL,
    LOSS_TOL,
    PARAM_ATOL,
    REL,
    assert_step,
    grad_norm_of,
    running_stats,
    with_dtype,
)
from test_torch_train import LR, TOTAL, WARMUP, WD

from synchformer_tpu_torch.registry import instantiate_from_config
from synchformer_tpu_torch.train import state as tstate
from synchformer_tpu_torch.train.step import avclip_train_step
from synchformer_tpu_torch.utils import convert

torch.set_num_threads(2)

S3D = "model.modules.feat_extractors.visual.s3d.S3DVisualFeatures"
RESNET = "model.modules.feat_extractors.audio.resnet.ResNet18AudioFeatures"


def legacy_avclip_cfg() -> dict:
    """An AVCLIP node over S3D + ResNet-18 (AveragePooling time tails),
    projections to 64."""
    def lin(n):
        return {"target": "torch.nn.Linear", "params": {"in_features": n, "out_features": 64}}

    return {"target": "synchformer_tpu.models.avclip.AVCLIP", "params": {
        "n_embd": 64,
        "vfeat_extractor": {"target": S3D, "params": {"agg_time_module": "AveragePooling"}},
        "afeat_extractor": {"target": RESNET, "params": {"agg_time_module": "AveragePooling"}},
        "vproj": lin(1024), "aproj": lin(512)}}


def jax_avclip(variables, vis, aud, dtype, perturb=(0,)) -> list:
    """jax.value_and_grad of the JAX AVCLIP's contrastive loss applied with
    deterministic=False and mutable batch_stats: loss, new batch_stats,
    gradients; one per perturbation (jax_runs)."""
    from synchformer_tpu.models.avclip import AVCLIP as JAVCLIP

    def make_run():
        model = JAVCLIP(**with_dtype(legacy_avclip_cfg()["params"], dtype))

        @jax.jit
        def run(params, stats, vis, aud):
            def loss_fn(params):
                out, state = model.apply({"params": params, "batch_stats": stats}, vis, aud,
                                         deterministic=False, mutable=["batch_stats"])
                return out["losses"]["segment_contrastive_loss"], state["batch_stats"]

            (loss, new), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            return dict(loss=loss, stats=new, grads=grads)

        return run

    return jax_runs(make_run, variables, (vis, aud), dtype, perturb)


@pytest.fixture(scope="module")
def clip_case():
    from synchformer_tpu.models.avclip import AVCLIP as JAVCLIP
    from synchformer_tpu.train.state import SyncTrainState, make_lr_schedule, make_optimizer

    rng = np.random.default_rng(12)
    vis = rng.standard_normal((1, 2, 16, 64, 64, 3)).astype(np.float32)
    aud = rng.standard_normal((1, 2, 66, 128)).astype(np.float32)
    port = instantiate_from_config(legacy_avclip_cfg(), device="meta")
    closing = frozenset(f"{'v_encoder' if k.startswith('v') else 'a_encoder'}."
                        f"{k.split('.', 1)[1]}" for k in closing_norms(port))
    variables = centred(jax_vars(JAVCLIP(**legacy_avclip_cfg()["params"]), jnp.asarray(vis),
                                 jnp.asarray(aud), closing=closing))
    variables = {**variables, "params": {**variables["params"],
                                         "logit_scale": np.float32(0.07)}}
    j32 = jax_avclip(variables, vis, aud, jnp.float32, PERTURB)
    (j64,) = jax_avclip(variables, vis, aud, jnp.float64)
    params = variables["params"]
    tx = make_optimizer("adamw", lr=make_lr_schedule("cosine", LR, WARMUP, TOTAL),
                        weight_decay=WD, max_clip_norm=1.0,
                        weight_decay_mask=jax.tree.map(lambda p: np.ndim(p) >= 2, params))
    state = SyncTrainState.create(params, tx, trainable_keys=tuple(params))
    new_state, _ = jax.jit(lambda s, g: s.apply_gradients(g))(
        state, jax.tree_util.tree_map(jnp.float32, j32[0]["grads"]))
    new = dict(new_state.trainable)
    new["logit_scale"] = jnp.clip(new["logit_scale"], 0.001, 0.5)
    return dict(vis=vis, aud=aud, variables=variables, j32=j32, j64=j64,
                new_params=sd_of(variables, new, j32[0]["stats"]))


def sd_of(variables, params=None, stats=None) -> dict:
    """The port's AVCLIP state dict of ``variables``, with ``params`` (e.g.
    gradients) and ``stats`` in place of its own where given."""
    return convert.avclip_state_dict_from_jax(
        {"params": variables["params"] if params is None else params,
         "batch_stats": variables["batch_stats"] if stats is None else stats})


def test_legacy_avclip_step_matches_jax(clip_case):
    """AVCLIP over S3D + ResNet-18 built through the port's registry, one
    avclip_train_step on the kernel route against the JAX step composed from
    the JAX AVCLIP: every parameter's gradient before the step, the loss and
    gradient norm (hold_family), every parameter after the step
    (assert_step), the clamped logit scale and every running statistic the
    step leaves (hold_family)."""
    c = clip_case
    j32, j64, v = c["j32"], c["j64"], c["variables"]
    model = instantiate_from_config(legacy_avclip_cfg())
    convert.load_numpy_state_dict(model, sd_of(v))
    vis, aud = t(c["vis"]), t(c["aud"])
    loss, _, _ = model(vis, aud, "kernel", deterministic=False, generator=torch.Generator())
    loss.backward()
    stats64 = running_stats(sd_of(v, stats=j64["stats"]))
    want = {k: x for k, x in sd_of(v, j64["grads"], j64["stats"]).items() if k not in stats64}
    hold_family({n: p.grad for n, p in model.named_parameters()},
                [sd_of(v, j["grads"], j["stats"]) for j in j32], want, grad_scales(want),
                GRAD_REL, "gradients")

    model = instantiate_from_config(legacy_avclip_cfg())
    convert.load_numpy_state_dict(model, sd_of(v))
    opt = tstate.make_adamw(model.named_parameters(), WD)
    sched = tstate.make_lr_schedule("cosine", LR, WARMUP, TOTAL)
    m = avclip_train_step(model, opt, sched, 0, vis, aud, torch.Generator(), "kernel", 1.0)

    def scalars(j):
        return {"loss": float(j["loss"]), "grad_norm": grad_norm_of(j)}

    hold_family({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()},
                [scalars(j) for j in j32], scalars(j64), value_scales(scalars(j64)),
                LOSS_TOL["rtol"], "metrics")
    assert_step({n: p.detach() for n, p in model.named_parameters()}, c["new_params"],
                [sd_of(v, j["grads"], j["stats"]) for j in j32], sd_of(v, j64["grads"],
                                                                        j64["stats"]),
                grad_norm_of(j32[0]), sched(0))
    hold_family(running_stats(model.state_dict()),
                [running_stats(sd_of(v, stats=j["stats"])) for j in j32], stats64,
                value_scales(stats64), REL, "running statistics")
    assert gap(model.logit_scale, c["new_params"]["logit_scale"]) <= PARAM_ATOL


def test_avclip_trainer_stages_frames_for_s3d():
    """AVCLIPTrainer on the CPU over the legacy AVCLIP node: prepare hands
    the S3D the normalised frames (B, S, T, H, W, C), not patches; a train
    step moves the towers' running statistics and returns a finite loss;
    the eval step leaves them as they are."""
    from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer

    cfg = {"model": legacy_avclip_cfg(),
           "training": {"seed": 0, "precision": "fp32", "learning_rate": 1e-4,
                        "zero_shot_window": 2},
           "data": {"n_segments": 2}}
    tr = AVCLIPTrainer(cfg, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"video": rng.integers(0, 256, (2, 2, 16, 64, 64, 3), dtype=np.uint8),
             "audio": (rng.standard_normal((2, 2, 10240)) * 0.1).astype(np.float32)}
    vis, aud = tr.prepare(batch, train=False)
    assert vis.shape == (2, 2, 16, 64, 64, 3) and aud.shape == (2, 2, 66, 128)
    before = running_stats({k: v.clone() for k, v in tr.model.state_dict().items()})
    assert np.isfinite(tr.train_step(batch)["loss"])
    after = running_stats(tr.model.state_dict())
    assert all(not torch.equal(before[k], after[k]) for k in before)
    tr.eval_step(batch)
    assert all(torch.equal(after[k], v) for k, v in running_stats(tr.model.state_dict()).items())
