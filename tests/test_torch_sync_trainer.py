"""Stage II/III beyond one frozen-tower step, against the JAX package on the
CPU (tests/test_torch_sync_train.py's tiny models and tolerances):

- one step with is_trainable towers (drop-path 0, extractors_deterministic
  False) against make_sync_train_step over every subtree;
- Stage II/III's schedules and optimizers against the optax ones;
- the non-strict state-dict merge and the pos-emb trim against
  merge_params_nonstrict / trim_sync_pos_emb on the JAX trees;
- Stage I tower loading from a .pt (load_stage1_tower,
  init_tower_from_stage1);
- SyncTrainer on the CPU, built from configs through the registry: Stage II
  steps with a tower from a Stage I checkpoint, the fine-tune surgery into
  Stage III, the refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import JAX_AUD, JAX_VIS, jax_gt_cfg
from test_torch_sync_train import (
    LOSS_TOL,
    LR,
    MOTIONFORMER,
    PARAM_ATOL,
    TARGETS,
    TRANSFORMERS,
    WARMUP,
    B,
    S,
    jax_params,
    jax_step_state,
    jax_sync_model,
    port_sync_model,
)

from synchformer_tpu_torch.models.presets import TINY, build_tiny_avclip
from synchformer_tpu_torch.ops.video import patchify_frames
from synchformer_tpu_torch.train import state as tstate
from synchformer_tpu_torch.train.stage_sync import SyncTrainer
from synchformer_tpu_torch.train.step import sync_train_step
from synchformer_tpu_torch.utils import convert
from synchformer_tpu_torch.utils.checkpoint import init_tower_from_stage1, load_stage1_tower

torch.set_num_threads(2)


def test_trainable_towers_step_matches_jax():
    """is_trainable towers (drop-path 0): one step with
    extractors_deterministic=False, every parameter training, against
    make_sync_train_step(extractors_deterministic=False) over all subtrees:
    loss, grad_norm and the parameters after it."""
    from synchformer_tpu.train.step import make_sync_train_step

    rng = np.random.default_rng(1)
    frames = rng.standard_normal((B, S, 4, 32, 32, 3)).astype(np.float32)
    aud = rng.standard_normal((B, S, 66, 128)).astype(np.float32)
    model = jax_sync_model(False)
    params = jax_params(model, frames, aud)
    state = jax_step_state(params, tuple(params))
    batch = {"vis": jnp.asarray(frames), "aud": jnp.asarray(aud),
             "targets": jnp.asarray(TARGETS[False])}
    new_state, want = make_sync_train_step(model, donate=False, extractors_deterministic=False)(
        state, batch, jax.random.PRNGKey(0))
    port = port_sync_model(False, params)
    tstate.set_trainable(port, ("vfeat_extractor", "afeat_extractor",
                                *tstate.SYNC_TRAINABLE_KEYS))
    opt = tstate.make_optimizer("adam", port.parameters(), eps=1e-8)
    vis = torch.from_numpy(np.ascontiguousarray(patchify_frames(frames, 2, TINY["patch_size"])))
    m = sync_train_step(port, opt, tstate.make_lr_schedule("constant_with_warmup", LR, WARMUP),
                        0, vis, torch.from_numpy(aud), torch.from_numpy(TARGETS[False]),
                        torch.Generator(), "kernel", 1.0, extractors_deterministic=False)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(want[key]), err_msg=key, **LOSS_TOL)
    new = convert.state_dict_from_jax(new_state.trainable)
    moved = 0
    for name, p in port.named_parameters():
        err = float(np.abs(p.detach().numpy() - new[name]).max())
        assert err <= 2 * LR / 100 + PARAM_ATOL, (name, err)
        moved += int(name.startswith("vfeat_extractor.blocks.0.attn.qkv")
                     and not np.array_equal(new[name], convert.state_dict_from_jax(params)[name]))
    assert moved == 2  # the towers trained


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup"])
def test_sync_lr_schedules_match_jax(name):
    """Stage II/III's schedules against make_lr_schedule, step by step over
    the warm-up and past it (optax in f32: rtol 1e-6)."""
    from synchformer_tpu.train.state import make_lr_schedule

    want = make_lr_schedule(name, 2e-6, 10)
    got = tstate.make_lr_schedule(name, 2e-6, 10)
    for step in range(0, 30):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=0,
                                   err_msg=str(step))


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_make_optimizer_matches_optax(name):
    """Three steps of make_optimizer's adam, adamw (decay on every
    parameter) and sgd with momentum after the global-norm clip, at the
    constant_with_warmup rate, against make_optimizer's optax chain on the
    same gradients (some steps clipped, some not): rtol 1e-6 (a few f32
    ulps of the O(1) parameters, which each side rounds in its own order)."""
    from synchformer_tpu.train.state import make_lr_schedule, make_optimizer

    rng = np.random.default_rng(6)
    shapes = ((4, 3), (5,), (2, 2, 2))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
             for scale in (2.0, 0.05, 1.0)]
    kw = dict(betas=(0.9, 0.999), momentum=0.9, weight_decay=0.1, eps=1e-7)
    sched = tstate.make_lr_schedule("constant_with_warmup", 1e-2, 2)
    tx = make_optimizer(name, lr=make_lr_schedule("constant_with_warmup", 1e-2, 2),
                        max_clip_norm=1.0, **kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = tstate.make_optimizer(name, tp, **kw)
    for step, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        tstate.clip_grads_by_global_norm_([p.grad for p in tp], 1.0)
        tstate.set_lr(opt, sched(step))
        opt.step()
    for p, want in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _jax_shapes(model, n_segments):
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, n_segments, 4, 32, 32, 3)),
                          jnp.zeros((1, n_segments, 66, 128)))["params"]
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)


def _port_names(report: dict) -> dict:
    """A report's names as the modules they belong to (JAX names a missing
    subtree; the port each tensor)."""
    out = {}
    for field, names in report.items():
        mods = set()
        for name in names:
            name, _, shapes = name.partition(": ")
            name = name.replace("sync_transformer.", "transformer.").replace(
                "pos_emb.pos_emb", "pos_emb_cfg.pos_emb")
            if name.endswith((".weight", ".bias")):
                name = name.rsplit(".", 1)[0]
            mods.add(name + (f": {shapes}" if shapes else ""))
        out[field] = mods
    return out


@pytest.mark.parametrize("trim", [True, False])
def test_nonstrict_merge_and_pos_emb_trim_match_jax(trim):
    """Stage II (S=2, pos-emb 18) into the Stage III model (S=1, pos-emb
    10): with the trim, the fresh sync_head is missing and the dropped
    off_head unexpected, as merge_params_nonstrict reports on the JAX trees;
    without it the pos-emb is also mismatched. A shorter pos-emb is refused
    by both."""
    from synchformer_tpu.utils.checkpoint import merge_params_nonstrict
    from synchformer_tpu.utils.checkpoint import trim_sync_pos_emb as jax_trim

    jax_src = _jax_shapes(jax_sync_model(False, 2), 2)
    src = convert.state_dict_from_jax(jax_src)
    dst = port_sync_model(True, n_segments=1).state_dict()
    jax_dst = _jax_shapes(jax_sync_model(True, 1), 1)
    if trim:
        src, jax_src = convert.trim_sync_pos_emb(src, 10), jax_trim(jax_src, 10)
        assert src[convert.SYNC_POS_EMB].shape == (1, 10, TINY["d"])
    merged, report = convert.merge_state_dict_nonstrict(dst, src)
    _, want = merge_params_nonstrict(jax_dst, jax_src)
    assert _port_names(report) == _port_names(want)
    assert _port_names(report)["missing"] == {"transformer.sync_head"}
    assert _port_names(report)["unexpected"] == {"transformer.off_head"}
    assert bool(report["mismatched"]) != trim
    assert merged["transformer.sync_head.weight"] is dst["transformer.sync_head.weight"]
    with pytest.raises(ValueError, match="shorter"):
        convert.trim_sync_pos_emb(dst, 18)
    with pytest.raises(ValueError, match="shorter"):
        jax_trim(jax_dst, 18)


def test_load_stage1_tower(tmp_path):
    """From a .pt of a tiny AVCLIP state dict (under "model") or a bare one
    with the MoCo prefixes: each tower's tensors by their names inside the
    tower, and init_tower_from_stage1 loads them into a sync model's tower
    (the Stage I tower's AveragePooling tail holds nothing). A missing path,
    a tower with no entry and a tower that matches no parameter raise."""
    clip = build_tiny_avclip()
    sd = {k: torch.from_numpy(v) for k, v in convert.seeded_state_dict(clip, 2).items()}
    torch.save({"model": sd}, tmp_path / "avclip.pt")
    torch.save({k.replace("vfeat_extractor.", "v_encoder."): v for k, v in sd.items()
                if k.startswith("vfeat_extractor.")}, tmp_path / "moco.pt")
    audio = load_stage1_tower(str(tmp_path / "avclip.pt"), "audio")
    assert torch.equal(audio["ast.layernorm.weight"], sd["afeat_extractor.ast.layernorm.weight"])
    visual = load_stage1_tower(str(tmp_path / "moco.pt"), "visual")
    assert sorted(visual) == sorted(k[len("vfeat_extractor."):] for k in sd
                                    if k.startswith("vfeat_extractor."))
    model = port_sync_model(False)
    report = init_tower_from_stage1(model.vfeat_extractor, str(tmp_path / "moco.pt"), "visual")
    assert report == {"missing": [], "unexpected": [], "mismatched": []}
    assert torch.equal(model.vfeat_extractor.cls_token, sd["vfeat_extractor.cls_token"])
    with pytest.raises(FileNotFoundError):
        load_stage1_tower(str(tmp_path / "absent.pt"), "audio")
    with pytest.raises(ValueError, match="no audio tower"):
        load_stage1_tower(str(tmp_path / "moco.pt"), "audio")
    torch.save({"afeat_extractor.unrelated": torch.zeros(1)}, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="matched no parameter"):
        init_tower_from_stage1(model.afeat_extractor, str(tmp_path / "other.pt"), "audio")


def tiny_sync_cfg(action: str, n_segments: int, **extra) -> dict:
    """A config of the tiny sync model through the registry (towers at the
    TINY widths, reference target names), B=2, f32."""
    d = TINY["d"]
    syncability = action == "ft_avsync_model_for_syncability"
    lin = dict(target="torch.nn.Linear", params=dict(in_features=d, out_features=d))
    gt = dict(jax_gt_cfg(n_segments), embd_pdrop=0.1, resid_pdrop=0.1, attn_pdrop=0.1)
    vis = dict(JAX_VIS, agg_time_module="Identity", ckpt_path=extra.pop("v_ckpt", None))
    aud = dict(JAX_AUD, max_spec_t=66, ckpt_path=None)
    return {"action": action,
            "model": {"target": "model.sync_model.Synchformer", "params": dict(
                afeat_extractor=dict(target="model.modules.feat_extractors.audio.ast.AST",
                                     params=aud, is_trainable=False),
                vfeat_extractor=dict(target=MOTIONFORMER, params=vis, is_trainable=False),
                aproj=lin, vproj=lin,
                transformer=dict(target=TRANSFORMERS[syncability], params=gt))},
            "training": {"use_half_precision": False, "seed": 0, "base_learning_rate": 1e-3,
                         "lr_scheduler": {"name": "constant_with_warmup", "warmup": 2},
                         "optimizer": {"name": "adam"}},
            "data": {"n_segments": n_segments, "p_color_jitter": 0.5, "p_gray_scale": 0.5,
                     "p_horizontal_flip": 0.5}, **extra}


def loader_batch(n_segments: int, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"video": rng.integers(0, 256, (B, n_segments, 4, 32, 32, 3), dtype=np.uint8),
            "audio": (rng.standard_normal((B, n_segments, 10240)) * 0.1).astype(np.float32),
            "offset_target": np.array([3, 17]), "sync_target": np.array([1, 0])}


def test_sync_trainer_stage2_then_stage3_on_cpu(tmp_path):
    """SyncTrainer from configs through the registry: Stage II (video tower
    from a Stage I .pt, colour jitter and grayscale live) takes two finite
    steps that move only the trainable parameters; its state dict then
    fine-tunes the Stage III trainer (S=1): pos-emb trimmed 18 -> 10, fresh
    sync_head kept, off_head dropped, counters reset, then a step and an
    eval step."""
    clip = build_tiny_avclip()
    sd = {k: torch.from_numpy(v) for k, v in convert.seeded_state_dict(clip, 4).items()}
    torch.save(sd, tmp_path / "stage1.pt")
    tr = SyncTrainer(tiny_sync_cfg("train_avsync_model", S, v_ckpt=str(tmp_path / "stage1.pt")),
                     device="cpu")
    assert torch.equal(tr.model.vfeat_extractor.cls_token, sd["vfeat_extractor.cls_token"])
    assert tr.target_key == "offset_target" and tr.num_cls == 21 and not tr.towers_trainable
    frozen = {n: p.clone() for n, p in tr.model.named_parameters() if not p.requires_grad}
    assert frozen and all(n.startswith(("vfeat", "afeat")) for n in frozen)
    for _ in range(2):
        m = tr.train_step(loader_batch(S))
        assert m["loss_finite"] and np.isfinite(m["grad_norm"])
    assert all(torch.equal(p, frozen[n]) for n, p in tr.model.named_parameters() if n in frozen)
    ft = SyncTrainer(tiny_sync_cfg("ft_avsync_model_for_syncability", 1), device="cpu")
    report = ft.finetune_from(tr.model.state_dict())
    assert report["missing"] == ["transformer.sync_head.weight", "transformer.sync_head.bias"]
    assert report["unexpected"] == ["transformer.off_head.weight", "transformer.off_head.bias"]
    assert report["mismatched"] == [] and ft.step == 0
    assert torch.equal(ft.model.transformer.pos_emb_cfg.pos_emb,
                       tr.model.transformer.pos_emb_cfg.pos_emb[:, :10])
    assert ft.train_step(loader_batch(1))["loss_finite"] and ft.step == 1
    out = ft.eval_step(loader_batch(1))
    assert out["logits"].shape == (B, 2) and out["loss_vec"].shape == (B,)


def test_sync_trainer_refusals():
    """Without CUDA the trainer raises unless device='cpu'; p_audio_aug 0.2
    is accepted and a train step draws the augmentation chain (five row
    masks from the CPU generator); a non-finite loss raises."""
    cfg = tiny_sync_cfg("train_avsync_model", S)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SyncTrainer(cfg)
    aug = SyncTrainer({**cfg, "data": {**cfg["data"], "p_audio_aug": 0.2}}, device="cpu")
    state = aug.aug_generator.get_state()
    assert aug.train_step(loader_batch(S))["loss_finite"]
    want = torch.Generator().set_state(state)
    torch.rand(5 * B, generator=want)  # five (B,) row masks
    assert torch.equal(aug.aug_generator.get_state(), want.get_state())
    tr = SyncTrainer(cfg, device="cpu")
    with torch.no_grad():
        tr.model.transformer.ln_f.bias.fill_(float("nan"))
    with pytest.raises(RuntimeError, match="non-finite"):
        tr.train_step(loader_batch(S))
