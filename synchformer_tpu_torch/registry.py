"""Target-name registry: the port's models and datasets built from the configs'
``target`` / ``params`` nodes (the counterpart of synchformer_tpu/registry.py:19-70).

The target strings of the shipped configs and of the reference
(``synchformer_tpu.models.sync_model.Synchformer``, its alias
``model.sync_model.Synchformer``, ``torch.nn.Linear``, ...) resolve to
factories of the port's classes. Each factory takes the node's own ``params``
(Synchformer's towers, projections and transformer as target / params nodes)
plus ``device``, which ``instantiate_from_config`` passes down. A parameter
the port does not implement raises NotImplementedError naming ROADMAP §1
item 7 (or the item that holds it); it is never dropped. A tower's
``ckpt_path`` is not the model's: the trainer reads it (SyncTrainer
.init_towers_from_ckpts). Parameters the JAX package itself ignores
(``agg_segments_module``, ``feat_type``, the AST's ``num_labels`` in feature
mode) are accepted. The towers' ``agg_time_module`` takes every value the
JAX towers take ('TransformerEncoderLayer', 'AveragePooling', anything else
as no time pool, e.g. the reference's 'torch.nn.Identity');
``agg_freq_module`` / ``agg_space_module`` take 'TransformerEncoderLayer'
and 'AveragePooling'. Keys outside the JAX classes' fields are not dropped
here: models/presets.py::build_synchformer_from_ckpt_args drops them, as
the JAX package does for checkpoint configs. The JAX route option ``attn_impl`` of the towers keeps
its meaning where the port has it ('pallas_fused'); 'xla' and 'pallas' are
the port's default flow, whose kernels the caller's ``impl`` picks.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Mapping

from synchformer_tpu_torch.models.ast_encoder import ASTEncoder
from synchformer_tpu_torch.models.avclip import AVCLIP
from synchformer_tpu_torch.models.bridges import DoNothingBridge, LinearBridge
from synchformer_tpu_torch.models.moco_clip import MultilevelMoCoCLIP
from synchformer_tpu_torch.models.motionformer import MotionFormerEncoder
from synchformer_tpu_torch.models.pos_emb import RandInitPositionalEncoding
from synchformer_tpu_torch.models.sync_model import (
    GlobalTransformer,
    GlobalTransformerWithSyncabilityHead,
    Synchformer,
)

_REGISTRY: Dict[str, Callable] = {}
# target prefixes of the JAX package and of the reference: a target there
# that the port lacks is one it has not ported
_FOREIGN = ("synchformer_tpu.", "model.", "torch.nn.", "dataset.")
# the target prefixes of the datasets: the JAX package's and the reference's
_DATASETS = ("synchformer_tpu.data.datasets.", "dataset.")
ITEM7 = "not ported (ROADMAP §1 item 7)"


def register(*names: str) -> Callable:
    """Decorator: register a factory under one or more target names."""

    def deco(obj):
        for name in names:
            if name in _REGISTRY and _REGISTRY[name] is not obj:
                raise ValueError(f"duplicate registry entry: {name}")
            _REGISTRY[name] = obj
        return obj

    return deco


def get_registered(target: str) -> Callable:
    """Resolve a target name: the registry first, then a dotted import path
    outside the JAX package and the reference. The datasets
    (synchformer_tpu_torch.data.datasets, which registers them here) are
    imported at the first lookup that needs them."""
    if target in _REGISTRY:
        return _REGISTRY[target]
    if target.startswith(_DATASETS):
        import synchformer_tpu_torch.data.datasets  # noqa: F401

        if target in _REGISTRY:
            return _REGISTRY[target]
    if target.startswith(_FOREIGN):
        raise NotImplementedError(f"target {target!r}: {ITEM7}")
    if "." in target:
        module_name, attr = target.rsplit(".", 1)
        try:
            return getattr(importlib.import_module(module_name), attr)
        except (ImportError, AttributeError) as e:
            raise KeyError(f"unknown target {target!r}: {e}") from e
    raise KeyError(f"unknown target {target!r}")


def node_params(config: Mapping[str, Any]) -> Dict[str, Any]:
    """A node's params as a dict, each value read through the node (a Config
    resolves its interpolations there)."""
    params = config.get("params") or {}
    return {k: params[k] for k in params}


def instantiate_from_config(config: Mapping[str, Any], **extra_kwargs) -> Any:
    """Build ``config['target']`` with ``config['params']`` and
    ``extra_kwargs`` (e.g. device)."""
    if "target" not in config:
        raise KeyError(f"config has no 'target': {dict(config)!r}")
    return get_registered(config["target"])(**{**node_params(config), **extra_kwargs})


def _refuse(what: str, item: str = ITEM7) -> None:
    raise NotImplementedError(f"{what}: {item}")


def _common_tower_params(p: dict, tower: str) -> dict:
    """Drop what the model does not read (ckpt_path: the trainer's; the
    inert reference fields) and refuse what the port does not implement."""
    p = dict(p)
    for key in ("ckpt_path", "agg_segments_module", "feat_type"):
        p.pop(key, None)
    if not p.pop("extract_features", True):
        _refuse(f"{tower} extract_features: false (the classification head)")
    if float(p.pop("mlp_ratio", 4.0)) != 4.0:
        _refuse(f"{tower} mlp_ratio other than 4")
    return p


# the pools a tower takes in place of its CLS-pool aggregator (the JAX towers
# run any other value as no pool, which leaves features no sync model takes)
_POOLS = ("TransformerEncoderLayer", "AveragePooling")


def ast_params(params: Mapping[str, Any]) -> dict:
    """An ASTEncoder node's params -> the port ASTEncoder's keyword arguments."""
    p = _common_tower_params(params, "ASTEncoder")
    p.pop("num_labels", None)
    if not p.pop("factorize_freq_time", True):
        _refuse("ASTEncoder factorize_freq_time: false")
    if p.get("agg_freq_module", _POOLS[0]) not in _POOLS:
        _refuse(f"ASTEncoder agg_freq_module {p['agg_freq_module']!r}")
    if float(p.get("hidden_dropout", 0.0)) > 0.0 or float(p.get("attn_dropout", 0.0)) > 0.0:
        _refuse("the AST's hidden_dropout / attn_dropout above 0")
    if p.pop("attn_impl", "xla") not in ("xla", "pallas"):
        _refuse("ASTEncoder attn_impl other than 'xla' / 'pallas'")
    return p


def motionformer_params(params: Mapping[str, Any]) -> dict:
    """A MotionFormerEncoder node's params -> the port's keyword arguments."""
    p = _common_tower_params(params, "MotionFormerEncoder")
    if not p.pop("factorize_space_time", True):
        _refuse("MotionFormerEncoder factorize_space_time: false")
    if p.get("agg_space_module", _POOLS[0]) not in _POOLS:
        _refuse(f"MotionFormerEncoder agg_space_module {p['agg_space_module']!r}")
    if p.pop("attn_layer", "divided") != "divided":
        _refuse("the joint-attention Motionformer (attn_layer 'joint')")
    if float(p.pop("drop_rate", 0.0)) > 0.0:
        _refuse("the Motionformer blocks' drop_rate above 0")
    if p.get("attn_impl", "pallas") in ("xla", "pallas"):
        p["attn_impl"] = "pallas"
    return p


@register("synchformer_tpu.models.ast_encoder.ASTEncoder",
          "model.modules.feat_extractors.audio.ast.AST")
def build_ast(device=None, **params) -> ASTEncoder:
    return ASTEncoder(device=device, **ast_params(params))


@register("synchformer_tpu.models.motionformer.MotionFormerEncoder",
          "model.modules.feat_extractors.visual.motionformer.MotionFormer")
def build_motionformer(device=None, **params) -> MotionFormerEncoder:
    return MotionFormerEncoder(device=device, **motionformer_params(params))


@register("synchformer_tpu.models.bridges.LinearBridge", "torch.nn.Linear")
def build_linear(in_features: int, out_features: int, bias: bool = True,
                 use_bias: bool = True, device=None) -> LinearBridge:
    return LinearBridge(in_features, out_features, bias=bias and use_bias, device=device)


@register("synchformer_tpu.models.bridges.DoNothingBridge", "model.modules.bridges.DoNothingBridge")
def build_do_nothing(in_features=None, out_features=None, device=None) -> DoNothingBridge:
    return DoNothingBridge()


@register("synchformer_tpu.models.pos_emb.RandInitPositionalEncoding",
          "model.modules.transformer.RandInitPositionalEncoding")
def build_pos_emb(block_shape, n_embd: int, device=None) -> RandInitPositionalEncoding:
    return RandInitPositionalEncoding(list(block_shape), n_embd, device)


def _transformer(cls, n_layer: int = 3, n_head: int = 8, n_embd: int = 768,
                 tok_pdrop: float = 0.0, embd_pdrop: float = 0.1, resid_pdrop: float = 0.1,
                 attn_pdrop: float = 0.1, pos_emb_cfg=None, off_head_cfg=None, device=None):
    if pos_emb_cfg is None:
        _refuse("a GlobalTransformer without pos_emb_cfg (NoPosEncoding)")
    pos_emb = instantiate_from_config(pos_emb_cfg, device=device)
    if not isinstance(pos_emb, RandInitPositionalEncoding) or pos_emb.pos_emb.ndim != 3:
        _refuse("a positional embedding other than RandInitPositionalEncoding over one axis")
    drops = dict(tok_pdrop=tok_pdrop, embd_pdrop=embd_pdrop, resid_pdrop=resid_pdrop,
                 attn_pdrop=attn_pdrop, device=device)
    seq_len = pos_emb.pos_emb.shape[1]
    if cls is GlobalTransformerWithSyncabilityHead:
        # the JAX module never calls its off_head, which so holds no parameters
        model = cls(n_layer, n_head, n_embd, seq_len, **drops)
    else:
        model = cls(n_layer, n_head, n_embd, seq_len, None, **drops)
        if off_head_cfg is not None:
            model.off_head = instantiate_from_config(off_head_cfg, device=device)
    model.pos_emb_cfg = pos_emb
    return model


@register("synchformer_tpu.models.sync_model.GlobalTransformer",
          "model.sync_model.GlobalTransformer")
def build_global_transformer(**params) -> GlobalTransformer:
    return _transformer(GlobalTransformer, **params)


@register("synchformer_tpu.models.sync_model.GlobalTransformerWithSyncabilityHead",
          "model.sync_model.GlobalTransformerWithSyncabilityHead")
def build_syncability_transformer(**params) -> GlobalTransformerWithSyncabilityHead:
    return _transformer(GlobalTransformerWithSyncabilityHead, **params)


@register("synchformer_tpu.models.sync_model.Synchformer", "model.sync_model.Synchformer")
def build_synchformer(afeat_extractor, vfeat_extractor, aproj, vproj, transformer,
                      device=None) -> Synchformer:
    """Synchformer from its five nodes; the modules come back in eval mode,
    as the presets."""
    def build(node):
        return instantiate_from_config(node, device=device)

    return Synchformer.from_modules(build(vfeat_extractor), build(afeat_extractor),
                                    build(vproj), build(aproj), build(transformer)).eval()


def _stage1_towers(afeat_extractor, vfeat_extractor, aproj, vproj, n_embd: int) -> tuple:
    """AVCLIP / MoCo tower nodes -> their keyword dicts (AveragePooling time
    tails and width n_embd, as both models build them); DoNothing
    projections only."""
    for name, node in (("aproj", aproj), ("vproj", vproj)):
        if get_registered(node["target"]) is not build_do_nothing:
            _refuse(f"a Stage I {name} other than DoNothingBridge")
    towers = []
    for node, factory, adapt in ((afeat_extractor, build_ast, ast_params),
                                 (vfeat_extractor, build_motionformer, motionformer_params)):
        if get_registered(node["target"]) is not factory:
            _refuse(f"a Stage I tower {node['target']!r}")
        kw = adapt(node_params(node))
        if kw.pop("agg_time_module", "AveragePooling") != "AveragePooling":
            raise ValueError("the Stage I towers pool time with AveragePooling")
        width = kw.pop("hidden_size" if adapt is ast_params else "embed_dim", n_embd)
        if width != n_embd:
            raise ValueError(f"a Stage I tower of width {width} under n_embd {n_embd}")
        towers.append(kw)
    return tuple(towers)


@register("synchformer_tpu.models.avclip.AVCLIP",
          "model.modules.feat_extractors.train_clip_src.open_clip.model.AVCLIP")
def build_avclip(afeat_extractor, vfeat_extractor, aproj, vproj, n_embd: int = 768,
                 init_scale: float = 0.07, clamp_scale_min: float = 0.001,
                 clamp_scale_max: float = 0.5, gather_for_loss: bool = False,
                 device=None) -> AVCLIP:
    """``gather_for_loss`` is accepted and changes nothing: as in the JAX
    trainer, which passes no axis_name, the InfoNCE always spans the global
    batch (models/avclip.py)."""
    a, v = _stage1_towers(afeat_extractor, vfeat_extractor, aproj, vproj, n_embd)
    return AVCLIP(vfeat_extractor=v, afeat_extractor=a, d=n_embd, init_scale=init_scale,
                  clamp_scale_min=clamp_scale_min, clamp_scale_max=clamp_scale_max,
                  device=device)


@register("synchformer_tpu.models.moco_clip.MultilevelMoCoCLIP",
          "model.modules.feat_extractors.train_clip_src.open_clip.model.MultilevelMoCoCLIP")
def build_moco(afeat_extractor, vfeat_extractor, aproj, vproj, queue_size: int,
               momentum: float, n_embd: int = 768, init_scale: float = 0.07,
               clamp_scale_min: float = 0.001, clamp_scale_max: float = 0.5,
               device=None) -> MultilevelMoCoCLIP:
    a, v = _stage1_towers(afeat_extractor, vfeat_extractor, aproj, vproj, n_embd)
    return MultilevelMoCoCLIP(vfeat_extractor=v, afeat_extractor=a, d=n_embd,
                              queue_size=queue_size, momentum=momentum,
                              init_scale=init_scale, clamp_scale_min=clamp_scale_min,
                              clamp_scale_max=clamp_scale_max, device=device)
