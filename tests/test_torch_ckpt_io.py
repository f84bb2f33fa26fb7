"""Reading reference checkpoints in the port against the JAX package on the
CPU:

- load_torch_checkpoint + plain_from_ckpt_args on a .pt whose args are a
  pickled omegaconf DictConfig (the port's stand-ins,
  utils/reference_ckpt.py), '???' and a ListConfig included: the same plain
  dict as the JAX functions;
- patch_ckpt_model_cfg on the reference-style config and the four shipped
  configs rewritten with the reference's target names: equal to JAX's;
- build_synchformer_from_ckpt_args: the same info and the same dropped keys
  as JAX's; the port's table of the JAX classes' fields against
  dataclasses.fields; a key that JAX reads and the port lacks raises;
- the towers' options (time tails 'torch.nn.Identity' and
  'TransformerEncoderLayer', AveragePooling frequency / space pools)
  against the JAX towers, the time tail also against _cls_pool_tokens_pallas
  in interpret mode;
- the Stage I reader on a reference-style file ("state_dict", module.,
  an AST position embedding of 1214 tokens) at the published mel geometry
  against JAX load_stage1_tower, and the parent's non-strict merge, which
  left that embedding at its fresh values.

Tolerances: rtol = atol = 1e-5 in f32 (tests/test_torch_models.py's REF),
the Pallas kernel in interpret mode 2e-4 / 3e-5 (PALLAS); readers and
configs exactly.
"""
import copy
import dataclasses
import logging
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_example_reconstruct import REF_STYLE_CFG
from test_torch_models import (
    D,
    HEADS,
    JAX_AUD,
    JAX_VIS,
    N_PATCH,
    PALLAS,
    PATCH_K,
    close,
    jit_apply,
    randomize,
)

from synchformer_tpu_torch.config.core import Config
from synchformer_tpu_torch.models import aggregators as tagg
from synchformer_tpu_torch.models import presets as tpresets
from synchformer_tpu_torch.models.ast_encoder import ASTEncoder
from synchformer_tpu_torch.models.motionformer import MotionFormerEncoder
from synchformer_tpu_torch.models.presets import TINY, build_tiny_avclip
from synchformer_tpu_torch.registry import instantiate_from_config
from synchformer_tpu_torch.utils import checkpoint as tckpt
from synchformer_tpu_torch.utils import convert
from synchformer_tpu_torch.utils.reference_ckpt import (
    as_omegaconf,
    save_reference_ckpt,
    save_with_fake_omegaconf,
)

torch.set_num_threads(2)

CONFIGS = Path(__file__).resolve().parents[1] / "synchformer_tpu" / "config" / "configs"
SHIPPED = ("ft_synchability", "segment_avclip", "smoke", "sync")
# the JAX package's target names -> the reference's (the port's alias table
# inverted); the transformers under the legacy feature_selector module
TO_REFERENCE = {v: k for k, v in tpresets.JAX_ALIASES.items() if not k.startswith("torch.")}
for _head in ("GlobalTransformer", "GlobalTransformerWithSyncabilityHead"):
    TO_REFERENCE[f"synchformer_tpu.models.sync_model.{_head}"] = \
        f"model.modules.feature_selector.{_head}"


def reference_named(node):
    """A config tree with every target renamed to the reference's name."""
    if isinstance(node, dict):
        node = {k: reference_named(v) for k, v in node.items()}
        if node.get("target") in TO_REFERENCE:
            node["target"] = TO_REFERENCE[node["target"]]
    elif isinstance(node, list):
        node = [reference_named(v) for v in node]
    return node


def shipped(name: str) -> dict:
    """A shipped config as a checkpoint stores it: interpolations unresolved,
    the reference's target names."""
    from synchformer_tpu.config.core import load_config

    return reference_named(load_config(str(CONFIGS / f"{name}.yaml")).to_dict(resolve=False))


def ref_style_unknowns() -> dict:
    """REF_STYLE_CFG with unknown keys in four more nodes (the towers, a
    projection, the positional embedding), beside the AST's legacy_knob."""
    cfg = copy.deepcopy(REF_STYLE_CFG)
    p = cfg["model"]["params"]
    p["vfeat_extractor"]["params"]["legacy_temporal"] = "x"
    p["aproj"]["params"]["legacy_scale"] = 2.0
    p["transformer"]["params"]["pos_emb_cfg"]["params"]["legacy_init"] = "randn"
    p["transformer"]["params"]["legacy_gate"] = True
    return cfg


ARGS = {"ref_style": lambda: REF_STYLE_CFG, "ref_style_unknowns": ref_style_unknowns,
        **{name: (lambda n=name: shipped(n)) for name in SHIPPED}}


def test_load_torch_checkpoint_matches_jax(tmp_path):
    """A .pt with fake-omegaconf args ('???', a ListConfig, nested
    DictConfigs) and weights: both loaders give the weights, and
    plain_from_ckpt_args the same plain dict."""
    from synchformer_tpu.utils.checkpoint import load_torch_checkpoint, plain_from_ckpt_args

    args = {"action": "train_avsync_model",
            "data": {"num_off_cls": 21, "missing": "???", "grid": [1, 2, {"deep": "???"}]},
            "model": REF_STYLE_CFG["model"]}
    path = str(tmp_path / "ckpt.pt")
    save_with_fake_omegaconf(lambda mods: {"model": {"w": torch.arange(3.0)},
                                           "args": as_omegaconf(args, mods)}, path)
    want = load_torch_checkpoint(path)
    got = tckpt.load_torch_checkpoint(path)
    assert torch.equal(got["model"]["w"], want["model"]["w"])
    plain = tckpt.plain_from_ckpt_args(got["args"])
    assert plain == plain_from_ckpt_args(want["args"])
    assert plain["data"] == {"num_off_cls": 21, "missing": None, "grid": [1, 2, {"deep": None}]}
    assert plain["model"] == REF_STYLE_CFG["model"]
    # a plain dict (a file the port wrote) reads as it is
    assert tckpt.plain_from_ckpt_args({"a": [1, "???"]}) == {"a": [1, None]}


@pytest.mark.parametrize("name", list(ARGS))
def test_patch_ckpt_model_cfg_matches_jax(name):
    from synchformer_tpu.models.presets import patch_ckpt_model_cfg

    cfg = ARGS[name]()
    before = copy.deepcopy(cfg)
    got = tpresets.patch_ckpt_model_cfg(cfg["model"])
    assert got == patch_ckpt_model_cfg(cfg["model"])
    assert cfg == before  # the input is left as it was
    assert ".feature_selector." not in str(got)


def jax_dropped(records) -> list:
    """(target, keys) from the JAX package's 'dropping unsupported cfg
    params' warnings."""
    out = []
    for rec in records:
        m = re.fullmatch(r"(\S+): dropping unsupported cfg params (\[.*\])", rec.getMessage())
        if m:
            out.append((m.group(1), eval(m.group(2))))  # noqa: S307 (a list of str)
    return out


@pytest.mark.parametrize("name", list(ARGS))
def test_build_from_ckpt_args_matches_jax(name, caplog):
    """info equal to JAX's; the params dropped (with a warning) equal to
    those the JAX package drops; the port's model built (on the meta device:
    the shipped configs are full width)."""
    from synchformer_tpu.models.presets import build_synchformer_from_ckpt_args

    cfg = ARGS[name]()
    with caplog.at_level(logging.WARNING):
        _, want = build_synchformer_from_ckpt_args(cfg)
        want_dropped = jax_dropped(caplog.records)
        caplog.clear()
        model, info = tpresets.build_synchformer_from_ckpt_args(cfg, device="meta")
        assert jax_dropped(caplog.records) == want_dropped
    assert info == want
    dropped = []
    patched = tpresets.patch_ckpt_model_cfg(Config(cfg).to_dict()["model"])
    tpresets.drop_unknown_ckpt_params(patched, None, dropped)
    assert dropped == want_dropped
    if name == "ref_style_unknowns":
        assert len(dropped) == 5
    assert isinstance(model, torch.nn.Module)


@pytest.mark.parametrize("target", sorted(tpresets.JAX_FIELDS) + sorted(tpresets.JAX_ALIASES))
def test_jax_field_table_matches_dataclasses(target):
    """The port's copy of each JAX class's fields (JAX_FIELDS, by the
    JAX package's target name or, through JAX_ALIASES, the reference's) is
    dataclasses.fields of the class the JAX registry resolves."""
    from synchformer_tpu.registry import _populate_default_registry, get_registered

    _populate_default_registry()
    cls = get_registered(target)
    want = tuple(f.name for f in dataclasses.fields(cls))
    assert tpresets.JAX_FIELDS[tpresets.JAX_ALIASES.get(target, target)] == want


@pytest.mark.parametrize("tower,key,value", [
    ("afeat_extractor", "hidden_dropout", 0.1),
    ("vfeat_extractor", "attn_layer", "joint"),
    ("afeat_extractor", "agg_freq_module", "Identity"),
])
def test_jax_key_the_port_lacks_raises(tower, key, value):
    """A key of the JAX class that the port once lacked (and refused with
    NotImplementedError, whence the name) is neither dropped nor ignored:
    JAX builds the model, and the port builds it with the option in its
    tower."""
    from synchformer_tpu.models.presets import build_synchformer_from_ckpt_args

    cfg = copy.deepcopy(REF_STYLE_CFG)
    cfg["model"]["params"][tower]["params"][key] = value
    build_synchformer_from_ckpt_args(cfg)
    dropped = []
    tpresets.drop_unknown_ckpt_params(cfg["model"], None, dropped)
    assert all(key not in keys for _, keys in dropped)
    model, _ = tpresets.build_synchformer_from_ckpt_args(cfg, device="meta")
    if key == "hidden_dropout":
        assert all(layer.resid_dropout == value
                   for layer in model.afeat_extractor.ast.encoder.layer)
    elif key == "attn_layer":
        assert model.vfeat_extractor.joint
    else:
        assert model.afeat_extractor.freq_attn_agg is None


def test_legacy_knob_is_dropped_not_passed():
    """The parent passed REF_STYLE_CFG's unknown legacy_knob to ASTEncoder
    (TypeError); now it is dropped and the tower built."""
    node = copy.deepcopy(REF_STYLE_CFG["model"]["params"]["afeat_extractor"])
    with pytest.raises(TypeError, match="legacy_knob"):
        instantiate_from_config(node)
    model, _ = tpresets.build_synchformer_from_ckpt_args(REF_STYLE_CFG)
    assert isinstance(model.afeat_extractor, ASTEncoder)
    assert model.afeat_extractor.temp_attn_agg is None


# ---------------------------------------------------------------------------
# the towers' options against the JAX towers
# ---------------------------------------------------------------------------

TOWER_OPTIONS = {
    "ast_time_identity": ("ast", {"agg_time_module": "torch.nn.Identity"}),
    "ast_time_transformer": ("ast", {"agg_time_module": "TransformerEncoderLayer"}),
    "ast_freq_average": ("ast", {"agg_freq_module": "AveragePooling",
                                 "agg_time_module": "AveragePooling"}),
    "mf_time_identity": ("mf", {"agg_time_module": "torch.nn.Identity"}),
    "mf_time_transformer": ("mf", {"agg_time_module": "TransformerEncoderLayer"}),
    "mf_space_average": ("mf", {"agg_space_module": "AveragePooling",
                                "agg_time_module": "TransformerEncoderLayer"}),
}


def tower_pair(kind: str, opts: dict):
    """(input, JAX module, its randomised params, the port tower with them)."""
    if kind == "ast":
        from synchformer_tpu.models.ast_encoder import ASTEncoder as JT

        x = np.random.default_rng(0).standard_normal((1, 2, 66, 128)).astype(np.float32)
        jmod = JT(**JAX_AUD, **opts)
        params = randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        mod = ASTEncoder(hidden_size=D, depth=TINY["depth"], num_heads=HEADS, **opts)
        convert.load_numpy_state_dict(mod, convert.ast_sd(params["params"]))
    else:
        from synchformer_tpu.models.motionformer import MotionFormerEncoder as JT

        x = np.random.default_rng(0).standard_normal(
            (1, 2, TINY["temporal_resolution"], N_PATCH, PATCH_K)).astype(np.float32)
        jmod = JT(**JAX_VIS, **opts)
        params = randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        mod = MotionFormerEncoder(embed_dim=D, depth=TINY["depth"], num_heads=HEADS,
                                  patch_size=TINY["patch_size"],
                                  temporal_resolution=TINY["temporal_resolution"],
                                  img_size=TINY["img_size"], drop_path_rate=0.0, **opts)
        convert.load_numpy_state_dict(mod, convert.motionformer_sd(params["params"]))
    return x, jmod, params, mod


@pytest.mark.parametrize("case", list(TOWER_OPTIONS))
def test_tower_options_match_jax(case):
    """Each option against the JAX tower on its XLA path, both routes of the
    port (on CPU tensors the kernel route runs the plain versions); the
    state names are the ones the JAX converter reads (temp_attn_agg.*, no
    freq_attn_agg / spatial_attn_agg for an AveragePooling)."""
    kind, opts = TOWER_OPTIONS[case]
    x, jmod, params, mod = tower_pair(kind, opts)
    want, _ = jit_apply(jmod)(params, jnp.asarray(x))
    pool = "freq_attn_agg" if kind == "ast" else "spatial_attn_agg"
    names = set(mod.state_dict())
    assert any(n.startswith("temp_attn_agg.") for n in names) == \
        (opts.get("agg_time_module") == "TransformerEncoderLayer")
    assert any(n.startswith(pool + ".") for n in names) == ("AveragePooling" not in opts.get(
        "agg_freq_module", opts.get("agg_space_module", "")))
    for impl in ("plain", "kernel"):
        got = mod(torch.from_numpy(x), impl)
        assert got.shape == want.shape
        close(got, want)


def test_time_tail_matches_pallas_cls_pool_tokens(monkeypatch):
    """The TransformerEncoderLayer time tail (a TemporalAggregator without a
    positional embedding: K4 on the port's kernel route) against the JAX
    aggregator on impl='pallas' in interpret mode, which runs
    _cls_pool_tokens_pallas (counted)."""
    from synchformer_tpu.models import aggregators as jagg
    from synchformer_tpu.ops.pallas import cls_pool as jcls

    calls = []
    real = jcls._cls_pool_tokens_pallas
    monkeypatch.setattr(jcls, "_cls_pool_tokens_pallas",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = np.random.default_rng(3).standard_normal((4, 6, D)).astype(np.float32)
    jmod = jagg.TemporalAggregator(num_heads=HEADS)
    params = randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    with pltpu.force_tpu_interpret_mode():
        want = jit_apply(jagg.TemporalAggregator(num_heads=HEADS, impl="pallas"))(
            params, jnp.asarray(x))
    assert calls
    want_xla = jit_apply(jmod)(params, jnp.asarray(x))
    mod = tagg.time_tail("TransformerEncoderLayer", D, HEADS)
    sd = convert.cls_pool_layer_sd(params["params"]["cls_layer"], "agg")
    convert.load_numpy_state_dict(mod, {k[len("agg."):]: v for k, v in sd.items()})
    for impl in ("plain", "kernel"):
        got = mod(torch.from_numpy(x), impl)
        close(got, want_xla)
        close(got, want, PALLAS)


@pytest.mark.parametrize("option", ["torch.nn.Identity", "TransformerEncoderLayer",
                                    "AveragePooling"])
def test_registry_builds_time_tails(option):
    """The registry's tower factories take every time tail the JAX towers
    take, and the AveragePooling frequency / space pools (the parent refused
    all but 'Identity' and 'AveragePooling' time tails)."""
    for target, extra in (("model.modules.feat_extractors.audio.ast.AST",
                           {"agg_freq_module": "AveragePooling"}),
                          ("model.modules.feat_extractors.visual.motionformer.MotionFormer",
                           {"agg_space_module": "AveragePooling"})):
        tower = instantiate_from_config(
            {"target": target, "params": {"agg_time_module": option, "depth": 1, **extra}},
            device="meta")
        assert isinstance(tower.temp_attn_agg, {"torch.nn.Identity": type(None),
                                                "TransformerEncoderLayer": tagg.TemporalAggregator,
                                                "AveragePooling": tagg.AveragePooling}[option])


# ---------------------------------------------------------------------------
# the Stage I reader on a reference-style file
# ---------------------------------------------------------------------------

AST_POS = convert.AST_POS_EMB


@pytest.fixture(scope="module")
def stage1_file(tmp_path_factory):
    """A reference-style Stage I checkpoint of a seeded tiny AVCLIP (TINY
    widths, the published mel geometry: 74 AST tokens): the towers under
    a_encoder. / v_encoder., module.-prefixed, under "state_dict", the AST
    position embedding 1214 tokens long with the model's own 74 first, a
    logit scale and args beside them."""
    sd = convert.seeded_state_dict(build_tiny_avclip(), 4)
    sd = {k.replace("vfeat_extractor.", "v_encoder.").replace("afeat_extractor.", "a_encoder."): v
          for k, v in sd.items()}
    own = sd[f"a_encoder.{AST_POS}"]
    tail = np.random.default_rng(5).standard_normal((1, 1214 - 74, own.shape[2])).astype(np.float32)
    sd[f"a_encoder.{AST_POS}"] = np.concatenate([own, tail], axis=1)
    path = tmp_path_factory.mktemp("stage1") / "avclip.pt"
    save_reference_ckpt(str(path), sd, {"action": "train_avclip"}, weights_key="state_dict")
    return str(path), sd


@pytest.mark.parametrize("tower", ["audio", "visual"])
def test_stage1_reader_matches_jax(stage1_file, tower):
    """load_stage1_tower on the reference-style file equals JAX
    load_stage1_tower's tower (its converted params in the port's names);
    the AST position embedding is the file's first 74 rows. The parent read
    it with weights_only and looked under "model" only: it raised."""
    from synchformer_tpu.utils.checkpoint import load_stage1_tower

    path, sd = stage1_file
    got = tckpt.load_stage1_tower(path, tower)
    jax_tower = load_stage1_tower(path, tower)
    want = (convert.ast_sd if tower == "audio" else convert.motionformer_sd)(jax_tower)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)
    if tower == "audio":
        np.testing.assert_array_equal(got[AST_POS].numpy(), sd[f"a_encoder.{AST_POS}"][:, :74])


def test_stage1_init_loads_every_tensor(stage1_file):
    """init_tower_from_stage1 into a sync model's towers: an empty report,
    the AST position embedding the file's first 74 rows bit for bit."""
    from test_torch_sync_train import port_sync_model

    path, sd = stage1_file
    model = port_sync_model(False)
    for tower, key, prefix in (("audio", "afeat_extractor", "a_encoder."),
                               ("visual", "vfeat_extractor", "v_encoder.")):
        report = tckpt.init_tower_from_stage1(getattr(model, key), path, tower)
        assert report == {"missing": [], "unexpected": [], "mismatched": []}
    got = model.afeat_extractor.ast.embeddings.position_embeddings.detach().numpy()
    np.testing.assert_array_equal(got, sd[f"a_encoder.{AST_POS}"][:, :74])


def test_parent_merge_left_the_ast_pos_emb_fresh(stage1_file):
    """The parent's route (no trim, a non-strict merge that only reports
    shape mismatches): the 1214-token embedding lands in ``mismatched`` and
    the tower keeps its fresh values. The reader now trims it, and a tensor
    of another shape raises."""
    from test_torch_sync_train import port_sync_model

    path, sd = stage1_file
    tower = port_sync_model(False).afeat_extractor
    init = tower.state_dict()
    untrimmed = tckpt.load_stage1_tower(path, "audio", max_patches=None)
    merged, report = convert.merge_state_dict_nonstrict(init, untrimmed)
    assert report["mismatched"] == [f"{AST_POS}: ckpt (1, 1214, {D}) vs model (1, 74, {D})"]
    assert merged[AST_POS] is init[AST_POS]
    assert not np.array_equal(merged[AST_POS].numpy(), sd[f"a_encoder.{AST_POS}"][:, :74])


def test_stage1_reader_refuses_other_shapes(tmp_path, stage1_file):
    """A shorter AST position embedding raises in the reader; a tower tensor
    of another shape raises in the initialisation (the parent kept the fresh
    tensor with a warning)."""
    from test_torch_sync_train import port_sync_model

    _, sd = stage1_file
    short = {**sd, f"a_encoder.{AST_POS}": sd[f"a_encoder.{AST_POS}"][:, :40]}
    save_reference_ckpt(str(tmp_path / "short.pt"), short, None, weights_key="state_dict")
    with pytest.raises(ValueError, match="shorter AST pos emb"):
        tckpt.load_stage1_tower(str(tmp_path / "short.pt"), "audio")
    bad = {**sd, "v_encoder.cls_token": np.zeros((1, 2, D), np.float32)}
    save_reference_ckpt(str(tmp_path / "bad.pt"), bad, None, weights_key="state_dict")
    with pytest.raises(ValueError, match="other shapes"):
        tckpt.init_tower_from_stage1(port_sync_model(False).vfeat_extractor,
                                     str(tmp_path / "bad.pt"), "visual")


def test_stage1_init_trims_the_ast_pos_emb(tmp_path, stage1_file):
    """A Stage I file in the layout the parent read (torch.save of the
    port's names under "model") whose AST position embedding holds 1214
    tokens: the tower takes the file's first 74 rows. The parent merged it
    non-strictly and kept the fresh embedding, with a warning."""
    from test_torch_sync_train import port_sync_model

    _, sd = stage1_file
    port_names = {k.replace("a_encoder.", "afeat_extractor."): torch.from_numpy(v)
                  for k, v in sd.items() if k.startswith("a_encoder.")}
    torch.save({"model": port_names}, tmp_path / "port_layout.pt")
    tower = port_sync_model(False).afeat_extractor
    report = tckpt.init_tower_from_stage1(tower, str(tmp_path / "port_layout.pt"), "audio")
    assert report["mismatched"] == []
    np.testing.assert_array_equal(tower.ast.embeddings.position_embeddings.detach().numpy(),
                                  sd[f"a_encoder.{AST_POS}"][:, :74])
