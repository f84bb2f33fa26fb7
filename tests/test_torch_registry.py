"""The port's config-driven construction and the host code of Stage II/III
against the JAX package on the CPU.

- the K3 gate (the JAX layer's ``groupable``): an AST attention of heads
  that do not pair into 128 lanes never reaches K3, one that does does, and
  both equal the JAX MultiHeadSelfAttention (its Pallas route in interpret
  mode where it takes it): rtol = atol = 1e-5;
- the registry: the shipped sync.yaml and ft_synchability.yaml model
  sections, read as data files, build port models on the meta device whose
  state-dict names and shapes equal the presets' and the port names of the
  JAX models the JAX registry builds from the same sections; a tiny AVCLIP
  and MoCo model from model.params equal the presets; parameters the port
  does not implement are refused;
- config loading and cfg_sanity_check_and_patch against the JAX copies;
- calc_cls_metrics, per_class_accuracy, roc_outputs and
  tiered_offset_metrics against the JAX functions (which call sklearn) on
  seeded logits with ties: 1e-7;
- the colour jitter and grayscale against the JAX _adjust_* on the same
  factors: 1e-6.
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import randomize

from synchformer_tpu_torch.config.core import load_config
from synchformer_tpu_torch.config.sanity import cfg_sanity_check_and_patch
from synchformer_tpu_torch.models import layers as tlayers
from synchformer_tpu_torch.models.layers import BlockParams, multi_head_self_attention
from synchformer_tpu_torch.models.presets import (
    build_synchformer,
    build_tiny_avclip,
    build_tiny_moco_avclip,
)
from synchformer_tpu_torch.ops import video as tvideo
from synchformer_tpu_torch.ops.kernels.standard_attention import groupable
from synchformer_tpu_torch.registry import instantiate_from_config
from synchformer_tpu_torch.train import metrics as tmetrics
from synchformer_tpu_torch.train import syncability_eval as tsync
from synchformer_tpu_torch.utils.convert import (
    load_numpy_state_dict,
    seeded_state_dict,
    state_dict_from_jax,
)

torch.set_num_threads(2)

CONFIGS = Path(__file__).resolve().parents[1] / "synchformer_tpu" / "config" / "configs"
REF = dict(rtol=1e-5, atol=1e-5)
MOTIONFORMER_REF = "model.modules.feat_extractors.visual.motionformer.MotionFormer"
METRIC_TOL = 1e-7


@pytest.mark.parametrize("heads,dh,k3", [(2, 96, False), (4, 64, True)])
def test_k3_gate_follows_groupable(monkeypatch, heads, dh, k3):
    """impl='kernel' reaches K3's wrapper only where the heads are groupable
    (2 x 96: no; 4 x 64: yes), and either way equals the JAX layer on its
    Pallas route, which takes the same gate."""
    from jax.experimental.pallas import tpu as pltpu

    from synchformer_tpu.models.layers import MultiHeadSelfAttention
    from synchformer_tpu.ops.pallas.standard_attention import groupable as jax_groupable

    assert groupable(heads, dh) == jax_groupable(heads, dh) == k3
    calls = []
    real = tlayers.standard_attention
    monkeypatch.setattr(tlayers, "standard_attention",
                        lambda qkv, h, impl: calls.append(qkv.shape) or real(qkv, h, impl))
    d = heads * dh
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((3, 74, d)).astype(np.float32))
    mod = MultiHeadSelfAttention(num_heads=heads, impl="pallas")
    # the parameter tree does not depend on impl: initialise on the XLA path
    params = randomize(MultiHeadSelfAttention(num_heads=heads).init(jax.random.PRNGKey(0), x))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(mod.apply)(params, x))
    p = params["params"]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    ones, zeros = torch.ones(d), torch.zeros(d)
    bp = BlockParams(ones, zeros, t(p["qkv"]["kernel"]).T, t(p["qkv"]["bias"]),
                     t(p["proj"]["kernel"]).T, t(p["proj"]["bias"]), ones, zeros,
                     *(torch.zeros(1),) * 4)
    got = multi_head_self_attention(torch.from_numpy(np.array(x)), bp, heads, "kernel")
    assert len(calls) == int(k3)
    np.testing.assert_allclose(got.numpy(), want, **REF)


def _section(name: str) -> dict:
    return load_config(str(CONFIGS / f"{name}.yaml")).to_dict()


def _shapes(sd) -> dict:
    return {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("name,syncability,n_segments",
                         [("sync", False, 14), ("ft_synchability", True, 13)])
def test_shipped_config_builds_the_preset(name, syncability, n_segments):
    """The model section, read as data, builds a port model on the meta
    device whose state dict has the preset's names and shapes, and the port
    names and shapes of the JAX model that the JAX registry builds from the
    same section (jax.eval_shape of its init)."""
    from synchformer_tpu.registry import instantiate_from_config as jax_instantiate

    cfg = _section(name)
    got = _shapes(instantiate_from_config(cfg["model"], device="meta").state_dict())
    assert got == _shapes(build_synchformer(n_segments, syncability, device="meta").state_dict())
    jax_model = jax_instantiate(copy.deepcopy(cfg["model"]))
    tree = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 1, 16, 224, 224, 3)), jnp.zeros((1, 1, 66, 128)))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)
    assert got == _shapes(state_dict_from_jax(tree))
    assert any(k.endswith("sync_head.weight") for k in got) == syncability
    assert any(k.endswith("off_head.weight") for k in got) != syncability


def _tiny_tower_nodes(glob: dict, drop_path: float = 0.0, pos_dropout=None) -> tuple:
    """build_tiny_avclip's / build_tiny_moco_avclip's towers as config nodes."""
    from synchformer_tpu_torch.models.presets import TINY as T

    vis = dict(embed_dim=T["d"], num_heads=T["heads"], patch_size=T["patch_size"],
               img_size=T["img_size"], temporal_resolution=T["temporal_resolution"],
               drop_path_rate=drop_path, agg_time_module="AveragePooling",
               ckpt_path="ignored.pyth", factorize_space_time=True,
               agg_space_module="TransformerEncoderLayer", **glob)
    if pos_dropout is not None:
        vis["pos_dropout"] = pos_dropout
    aud = dict(hidden_size=T["d"], num_heads=T["audio_heads"], agg_time_module="AveragePooling",
               max_spec_t=66, factorize_freq_time=True, agg_freq_module="TransformerEncoderLayer",
               **glob)
    return (dict(target="synchformer_tpu.models.ast_encoder.ASTEncoder", params=aud),
            dict(target="synchformer_tpu.models.motionformer.MotionFormerEncoder", params=vis))


def tiny_model_cfg(moco: bool) -> dict:
    """cfg.model of the tiny AVCLIP (depth 2) or MoCo model (depth 1, queues
    of 4, momentum 0.9), with reference target names."""
    from synchformer_tpu_torch.models.presets import TINY as T

    nothing = dict(target="model.modules.bridges.DoNothingBridge", params={})
    if moco:
        a, v = _tiny_tower_nodes(dict(depth=1, add_global_repr=True, max_segments=2),
                                 pos_dropout=0.1)
        return dict(target="synchformer_tpu.models.moco_clip.MultilevelMoCoCLIP",
                    params=dict(n_embd=T["d"], queue_size=4, momentum=0.9,
                                afeat_extractor=a, vfeat_extractor=v, aproj=nothing,
                                vproj=nothing))
    a, v = _tiny_tower_nodes(dict(depth=T["depth"]))
    return dict(target="model.modules.feat_extractors.train_clip_src.open_clip.model.AVCLIP",
                params=dict(n_embd=T["d"], afeat_extractor=a, vfeat_extractor=v, aproj=nothing,
                            vproj=nothing, gather_for_loss=False))


@pytest.mark.parametrize("moco", [False, True])
def test_tiny_stage1_model_from_params_equals_the_preset(moco):
    """The tiny AVCLIP / MoCo model built from cfg.model.params through the
    registry has the preset's state-dict names and shapes, and on the same
    seeded weights the same features."""
    model = instantiate_from_config(tiny_model_cfg(moco))
    preset = build_tiny_moco_avclip() if moco else build_tiny_avclip()
    assert _shapes(model.state_dict()) == _shapes(preset.state_dict())
    sd = seeded_state_dict(preset, seed=0)
    for m in (model, preset):
        load_numpy_state_dict(m, sd)
    rng = np.random.default_rng(4)
    vis = torch.from_numpy(rng.standard_normal((2, 2, 2, 16, 384)).astype(np.float32))
    aud = torch.from_numpy(rng.standard_normal((2, 2, 66, 128)).astype(np.float32))
    with torch.no_grad():
        a, b = model(vis, aud, "plain"), preset(vis, aud, "plain")
    for x, y in zip(a.values() if moco else a, b.values() if moco else b):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("change,match", [
    (("afeat_extractor", "factorize_freq_time", False), "item 7"),
    (("vfeat_extractor", "agg_space_module", "Identity"), "item 7"),
    (("afeat_extractor", "hidden_dropout", 0.1), "item 7"),
    (("vfeat_extractor", "attn_layer", "joint"), "item 7"),
])
def test_registry_refuses_what_the_port_lacks(change, match):
    """A parameter the port does not implement raises NotImplementedError
    naming the ROADMAP item; so does a tower the port has not ported (the
    joint-attention Motionformer)."""
    cfg = _section("sync")["model"]
    tower, key, value = change
    cfg["params"][tower]["params"][key] = value
    with pytest.raises(NotImplementedError, match=match):
        instantiate_from_config(cfg, device="meta")
    with pytest.raises(NotImplementedError, match="item 7"):
        instantiate_from_config({"target": MOTIONFORMER_REF, "params": {"attn_layer": "joint"}},
                                device="meta")


def test_load_config_and_overrides_match_jax():
    """The port's copy resolves the shipped configs as the JAX one does, CLI
    overrides and the ${add: ...} resolver included."""
    from synchformer_tpu.config.core import Config as JConfig
    from synchformer_tpu.config.core import load_config as jax_load
    from synchformer_tpu.config.core import merge_cli_overrides as jax_merge
    from synchformer_tpu_torch.config.core import Config, merge_cli_overrides

    overrides = ["training.base_learning_rate=1e-5", "data.n_segments=13", "logging.x.y=[1, 2]"]
    for path in sorted(CONFIGS.glob("*.yaml")):
        got = merge_cli_overrides(load_config(str(path)), overrides).to_dict()
        assert got == jax_merge(jax_load(str(path)), overrides).to_dict(), path.name
    tree = {"a": 2, "b": {"c": "${add: 3, a}", "d": "${a}x"}}
    assert Config(tree).to_dict() == JConfig(tree).to_dict() == {"a": 2, "b": {"c": 5, "d": "2x"}}


def _sanity_cases():
    sync, ft, avclip = _section("sync"), _section("ft_synchability"), _section("segment_avclip")
    bad_avclip = copy.deepcopy(avclip)
    bad_avclip["model"]["params"]["vfeat_extractor"]["params"]["max_segments"] = 3
    legacy = copy.deepcopy(sync)
    legacy["data"]["dataset"]["params"] = {"load_fixed_offsets_on_test": True}
    resume = copy.deepcopy(sync)
    resume["training"]["resume"] = True
    resume["model"]["params"]["afeat_extractor"]["params"]["ckpt_path"] = "a.pt"
    modes = copy.deepcopy(sync)
    modes["training"].update(resume=True, finetune=True)
    crop = copy.deepcopy(sync)
    crop["data"]["crop_len_sec"] = 4
    jitter = copy.deepcopy(sync)
    jitter["data"]["audio_jitter_sec"] = 0.2
    ft_head = copy.deepcopy(ft)
    ft_head["model"]["params"]["transformer"]["target"] = "model.sync_model.GlobalTransformer"
    return {"sync": sync, "ft": ft, "avclip": avclip, "avclip_max_segments": bad_avclip,
            "legacy_flag": legacy, "resume_drops_ckpt": resume, "exclusive_modes": modes,
            "crop_too_short": crop, "jitter_too_large": jitter, "ft_without_head": ft_head,
            "bad_action": {**sync, "action": "nope"}}


@pytest.mark.parametrize("case", list(_sanity_cases()))
def test_cfg_sanity_check_matches_jax(case):
    """Each config passes or fails in both copies, and the patched config
    (legacy flag, dropped tower ckpt paths) is the same."""
    from synchformer_tpu.config.sanity import cfg_sanity_check_and_patch as jax_check

    cfg = _sanity_cases()[case]
    results = []
    for check in (cfg_sanity_check_and_patch, jax_check):
        c = copy.deepcopy(cfg)
        try:
            results.append(("ok", check(c)))
        except AssertionError:
            results.append(("refused", None))
    assert results[0] == results[1]
    assert (results[0][0] == "ok") == (case in ("sync", "ft", "avclip", "legacy_flag",
                                                "resume_drops_ckpt"))


@pytest.fixture(scope="module")
def logits_with_ties():
    """Seeded logits rounded to one decimal (many ties), a block of equal
    rows, and targets: 21 classes (300), 2 classes (200), 5 classes with one
    class missing (60)."""
    rng = np.random.default_rng(7)
    out = {}
    for c, n in ((21, 300), (2, 200), (5, 60)):
        logits = np.round(rng.standard_normal((n, c)), 1).astype(np.float32)
        logits[:12] = logits[0]
        targets = rng.integers(0, c - (c == 5), n)
        out[c] = (logits, targets)
    return out


METRIC_CASES = [(c, kw) for c in (21, 2, 5)
                for kw in ({}, {"topk": (1,), "prefix": "valid"}, {"add_doubt_cls": True},
                           {"softmaxed_outputs": True})] + [(2, {"calc_pr_rec_f1": True})]


@pytest.mark.parametrize("c,kw", METRIC_CASES)
def test_calc_cls_metrics_matches_jax(logits_with_ties, c, kw):
    from synchformer_tpu.train.metrics import calc_cls_metrics, per_class_accuracy

    logits, targets = logits_with_ties[c]
    if kw.get("softmaxed_outputs"):
        logits = np.asarray(jax.nn.softmax(logits, -1))
    want = calc_cls_metrics(targets, logits, verbose=False, **kw)
    got = tmetrics.calc_cls_metrics(targets, logits, verbose=False, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])
    assert tmetrics.per_class_accuracy(targets, logits) == per_class_accuracy(targets, logits)


def test_syncability_eval_matches_jax(logits_with_ties):
    """roc_outputs (the curve with sklearn's drop_intermediate rule and the
    mean AUC) and tiered_offset_metrics against the JAX functions; the port's
    evaluate_syncability over a list of batches gives the same."""
    from synchformer_tpu.train.syncability_eval import roc_outputs, tiered_offset_metrics

    ls, ts = logits_with_ties[2]
    lo, to = logits_with_ties[21]
    lo, to = lo[:200], to[:200]
    want, got = roc_outputs(ls, ts), tsync.roc_outputs(ls, ts)
    for k in ("fpr", "tpr", "thresholds"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=METRIC_TOL)
    assert abs(got["roc_curve_sc"] - want["roc_curve_sc"]) <= METRIC_TOL
    tiers = (0.3, 0.5, 0.6, 0.99)
    want_t = tiered_offset_metrics(ls, ts, lo, to, tiers)
    assert tsync.tiered_offset_metrics(ls, ts, lo, to, tiers) == want_t
    batches = [{"video": np.zeros((100, 14, 1)), "audio": np.zeros((100, 14, 1)),
                "sync_target": ts[i:i + 100], "offset_target": to[i:i + 100],
                "pad_mask": np.ones(100, bool)} for i in (0, 100)]
    logits = {13: [ls[:100], ls[100:]], 14: [lo[:100], lo[100:]]}

    def fake(batch):  # the syncability model sees 13 segments, the offset one 14
        return logits[batch["video"].shape[1]].pop(0)

    out = tsync.evaluate_syncability(fake, batches, eval_off=fake)
    assert out["n_evaluated"] == 200
    assert out["roc"]["roc_curve_sc"] == got["roc_curve_sc"]
    assert out["tiered"][0.5] == want_t[0.5]


def test_color_jitter_and_grayscale_match_jax():
    """apply_color_jitter on drawn factors against the JAX _adjust_* chain
    with the same factors (random_color_jitter's composition), f32; the
    draws take nothing where both probabilities are 0."""
    from synchformer_tpu.ops import video as jvideo

    rng = np.random.default_rng(5)
    x = rng.random((4, 2, 3, 6, 5, 3)).astype(np.float32)
    draws = tvideo.draw_color_jitter(4, torch.Generator().manual_seed(0), 0.5, 0.5)
    assert 0 < int(draws["apply_jitter"].sum()) < 4 or 0 < int(draws["apply_gray"].sum()) < 4
    got = tvideo.apply_color_jitter(torch.from_numpy(x), draws).numpy()

    def f(name, extra=1):
        return jnp.asarray(draws[name].numpy()).reshape(-1, *(1,) * (x.ndim - extra))

    xj = jnp.asarray(x)
    jit = jvideo._adjust_brightness(xj, f("brightness"))
    jit = jvideo._adjust_contrast(jit, f("contrast"))
    jit = jvideo._adjust_saturation(jit, f("saturation"))
    jit = jnp.clip(jvideo._adjust_hue(jit, f("hue", 2)), 0.0, 1.0)
    want = jnp.where(f("apply_jitter").astype(bool), jit, xj)
    gray = jnp.broadcast_to(jnp.sum(want * jvideo._LUMA, -1, keepdims=True), x.shape)
    want = jnp.where(f("apply_gray").astype(bool), gray, want)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    assert tvideo.draw_color_jitter(4, torch.Generator(), 0.0, 0.0) is None
    g = torch.Generator().manual_seed(1)
    u8 = torch.from_numpy((x * 255).astype(np.uint8))
    plain = tvideo.prepare_video_batch(u8, g, True, 0.0)
    assert torch.equal(plain, tvideo.prepare_video_batch(u8, torch.Generator().manual_seed(1),
                                                         True, 0.0, torch.float32, 0.0, 0.0))
