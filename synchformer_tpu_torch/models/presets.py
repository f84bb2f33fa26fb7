"""Model presets: the full-width sync model (configs/sync.yaml model section,
as synchformer_tpu/models/presets.py::build_synchformer; with
``syncability``, configs/ft_synchability.yaml's) and its 8-head
video-tower variant (build_synchformer_8head), the full-width Stage I AVCLIP
(configs/segment_avclip.yaml, as build_avclip), its 8-head variant
(build_avclip_8head), the MoCo Stage I model at the same widths with global
representations (build_moco_avclip), and tiny ones for the CPU tests. The
8-head towers run the packed flow and take ``attn_impl`` ('pallas' or
'pallas_fused', the JAX option). All come in f32: SyncPredictor casts the
sync model's matrices to the compute dtype once; AVCLIP and MoCo train f32
master parameters under the activations' compute dtype.

``build_synchformer_from_ckpt_args`` builds the sync model a checkpoint's
stored training config describes (a reference ``.pt``'s ``args``).
"""
from __future__ import annotations

import copy
import logging
from typing import Optional

from synchformer_tpu_torch.models.avclip import AVCLIP
from synchformer_tpu_torch.models.moco_clip import MultilevelMoCoCLIP
from synchformer_tpu_torch.models.sync_model import Synchformer

D = 768
N_OFFSET_CLS = 21

# tiny widths for the CPU parity tests: 4 heads of 64 (the JAX split path's
# 128-lane grouping holds), depth 2, 32 px frames in 8 px patches, 4 frames
# -> 2 temporal tokens; the real mel geometry (128 x 66 -> 74 AST tokens)
TINY = dict(d=256, heads=4, audio_heads=4, depth=2, img_size=32, patch_size=8,
            temporal_resolution=2, n_layer=2)
# the packed-flow counterpart: a video tower of 2 heads of 96, which do not
# pair into 128 lanes, so the JAX Motionformer takes its packed flow
# (motionformer.py:554-559); the AST keeps heads of 64, as build_avclip_8head
TINY_PACKED = dict(TINY, d=192, heads=2, audio_heads=3)


def build_synchformer(n_segments: int = 14, syncability: bool = False,
                      device=None) -> Synchformer:
    """ViT-B towers (D=768, 12 layers of 12 heads of 64) and a 3-layer,
    8-head GlobalTransformer over 2 + 14 n_segments tokens with the
    configs' dropouts (tok 0, embd / resid / attn 0.1): 21 offset logits
    (configs/sync.yaml), or with ``syncability`` 2 syncability logits
    (configs/ft_synchability.yaml, n_segments 13, pos-emb 184)."""
    return Synchformer(
        vfeat_extractor=dict(depth=12, num_heads=12),
        afeat_extractor=dict(depth=12, num_heads=12),
        d=D, n_segments=n_segments, n_layer=3, n_head=8, num_cls=N_OFFSET_CLS,
        syncability=syncability, device=device).eval()


def build_synchformer_8head(n_segments: int = 14, attn_impl: str = "pallas",
                            device=None) -> Synchformer:
    """build_synchformer with the video tower at 8 heads of 96, which runs the
    packed flow (as build_avclip_8head does for Stage I)."""
    return Synchformer(
        vfeat_extractor=dict(depth=12, num_heads=8, attn_impl=attn_impl),
        afeat_extractor=dict(depth=12, num_heads=12),
        d=D, n_segments=n_segments, n_layer=3, n_head=8, num_cls=N_OFFSET_CLS,
        device=device).eval()


# the tokens a segment gives the GlobalTransformer from the legacy towers:
# S3D's 16 frames of 224² -> t = 2, ResNet-18's 66 x 128 log-mel -> t' = 3
LEGACY_TOKENS = (2, 3)


def legacy_sync_model(n_segments: int = 14, d: int = D, n_layer: int = 3,
                      n_head: int = 8) -> dict:
    """configs/sync.yaml's model section as a config node (build it with
    registry.instantiate_from_config) with the legacy SparseSync towers under
    the reference's target names: S3DVisualFeatures (spatial
    TransformerEncoderLayer, time Identity; a ckpt_path the port warns it
    does not read) and ResNet18AudioFeatures (frequency
    TransformerEncoderLayer, time Identity); the projections 1024 -> d and
    512 -> d; the GlobalTransformer (``n_layer`` layers of ``n_head`` heads,
    dropouts as the config's) with its pos-emb over 2 + n_segments *
    sum(LEGACY_TOKENS) tokens, 72 at 14 segments."""
    seq = 2 + n_segments * sum(LEGACY_TOKENS)
    return {"target": "synchformer_tpu.models.sync_model.Synchformer", "params": {
        "vfeat_extractor": {
            "target": "model.modules.feat_extractors.visual.s3d.S3DVisualFeatures",
            "params": {"ckpt_path": "s3d_kinetics400.pt",
                       "agg_space_module": "TransformerEncoderLayer",
                       "agg_time_module": "Identity"}},
        "afeat_extractor": {
            "target": "model.modules.feat_extractors.audio.resnet.ResNet18AudioFeatures",
            "params": {"agg_freq_module": "TransformerEncoderLayer",
                       "agg_time_module": "Identity"}},
        "vproj": {"target": "torch.nn.Linear", "params": {"in_features": 1024, "out_features": d}},
        "aproj": {"target": "torch.nn.Linear", "params": {"in_features": 512, "out_features": d}},
        "transformer": {"target": "synchformer_tpu.models.sync_model.GlobalTransformer", "params": {
            "n_layer": n_layer, "n_head": n_head, "n_embd": d, "tok_pdrop": 0.0,
            "embd_pdrop": 0.1, "resid_pdrop": 0.1, "attn_pdrop": 0.1,
            "pos_emb_cfg": {"target": "synchformer_tpu.models.pos_emb.RandInitPositionalEncoding",
                            "params": {"block_shape": [seq], "n_embd": d}},
            "off_head_cfg": {"target": "torch.nn.Linear",
                             "params": {"in_features": d, "out_features": N_OFFSET_CLS}}}}}}


def build_tiny_synchformer(n_segments: int = 2, device=None, t: dict = TINY,
                           attn_impl: str = "pallas", syncability: bool = False,
                           dropout: float = 0.1, drop_path_rate: float = 0.2) -> Synchformer:
    """Towers and transformer at the tiny widths ``t`` (TINY or TINY_PACKED);
    ``dropout`` is the transformer's embd / resid / attn rate,
    ``drop_path_rate`` the video tower's (live only where it trains)."""
    return Synchformer(
        vfeat_extractor=dict(depth=t["depth"], num_heads=t["heads"],
                             patch_size=t["patch_size"], img_size=t["img_size"],
                             temporal_resolution=t["temporal_resolution"],
                             attn_impl=attn_impl, drop_path_rate=drop_path_rate),
        afeat_extractor=dict(depth=t["depth"], num_heads=t["audio_heads"]),
        d=t["d"], n_segments=n_segments, n_layer=t["n_layer"], n_head=t["heads"],
        num_cls=N_OFFSET_CLS, syncability=syncability, embd_pdrop=dropout,
        resid_pdrop=dropout, attn_pdrop=dropout, device=device).eval()


def build_avclip(remat: bool = False, device=None) -> AVCLIP:
    """ViT-B Motionformer and AST towers (D=768, 12 layers of 12 heads of 64)
    with the AveragePooling time tail, DoNothingBridge projections,
    init_scale 0.07 clamped to [0.001, 0.5]; Motionformer drop-path 0.2 (its
    default, which configs/segment_avclip.yaml keeps), every dropout 0."""
    return AVCLIP(vfeat_extractor=dict(depth=12, num_heads=12, remat=remat,
                                       drop_path_rate=0.2),
                  afeat_extractor=dict(depth=12, num_heads=12, remat=remat),
                  d=D, device=device)


def build_avclip_8head(remat: bool = False, device=None, attn_impl: str = "pallas") -> AVCLIP:
    """build_avclip with an 8-head video tower: 8 heads of 96, the head layout
    of configs/sync.yaml's GlobalTransformer (n_head 8, n_embd 768). Heads of
    96 do not pair into 128 TPU lanes, so the JAX Motionformer runs its packed
    flow (motionformer.py:554-559), which reaches K7a and K7c; this is the
    widest such shape, at the published width and depth, and it puts them
    under the same Stage I step as build_avclip. No published checkpoint has
    an 8-head Motionformer: the JAX package runs it through its config
    (vfeat_extractor.params.num_heads: 8)."""
    return AVCLIP(vfeat_extractor=dict(depth=12, num_heads=8, remat=remat,
                                       drop_path_rate=0.2, attn_impl=attn_impl),
                  afeat_extractor=dict(depth=12, num_heads=12, remat=remat),
                  d=D, device=device)


def build_moco_avclip(remat: bool = False, device=None) -> MultilevelMoCoCLIP:
    """build_avclip's towers and scales as MultilevelMoCoCLIP with global
    representations: both towers add_global_repr with a
    TransformerEncoderLayer segment aggregator over 14 segments (the towers
    must agree, config/sanity.py:25); the Motionformer's pos_dropout 0.1
    (drop_rate 0), which puts the query pass's video global aggregator on
    K4b; the AST's dropouts 0. queue_size 1024 (a segment queue of 1024 x 14
    and a global queue of 1024) and momentum 0.995 are chosen, not taken from
    a shipped config."""
    glob = dict(add_global_repr=True, max_segments=14, remat=remat)
    return MultilevelMoCoCLIP(
        vfeat_extractor=dict(depth=12, num_heads=12, drop_path_rate=0.2, pos_dropout=0.1,
                             **glob),
        afeat_extractor=dict(depth=12, num_heads=12, **glob),
        d=D, queue_size=1024, momentum=0.995, device=device)


def build_tiny_moco_avclip(remat: bool = False, drop_path_rate: float = 0.0,
                           pos_dropout: float = 0.1, device=None) -> MultilevelMoCoCLIP:
    """build_moco_avclip at the TINY widths and depth 1, max_segments 2,
    queue_size 4 (queues of 8 and 4), momentum 0.9."""
    t = TINY
    glob = dict(add_global_repr=True, max_segments=2, remat=remat)
    return MultilevelMoCoCLIP(
        vfeat_extractor=dict(depth=1, num_heads=t["heads"], patch_size=t["patch_size"],
                             img_size=t["img_size"],
                             temporal_resolution=t["temporal_resolution"],
                             drop_path_rate=drop_path_rate, pos_dropout=pos_dropout, **glob),
        afeat_extractor=dict(depth=1, num_heads=t["audio_heads"], **glob),
        d=t["d"], queue_size=4, momentum=0.9, device=device)


def build_tiny_avclip(remat: bool = False, drop_path_rate: float = 0.0,
                      device=None) -> AVCLIP:
    return _tiny_avclip(TINY, remat, drop_path_rate, device)


def build_tiny_avclip_packed(remat: bool = False, drop_path_rate: float = 0.0,
                             device=None, attn_impl: str = "pallas") -> AVCLIP:
    """TINY_PACKED towers: the video tower runs the packed flow."""
    return _tiny_avclip(TINY_PACKED, remat, drop_path_rate, device, attn_impl)


def _tiny_avclip(t: dict, remat: bool, drop_path_rate: float, device,
                 attn_impl: str = "pallas") -> AVCLIP:
    return AVCLIP(vfeat_extractor=dict(depth=t["depth"], num_heads=t["heads"],
                                       patch_size=t["patch_size"], img_size=t["img_size"],
                                       temporal_resolution=t["temporal_resolution"],
                                       remat=remat, drop_path_rate=drop_path_rate,
                                       attn_impl=attn_impl),
                  afeat_extractor=dict(depth=t["depth"], num_heads=t["audio_heads"],
                                       remat=remat),
                  d=t["d"], device=device)


# ---------------------------------------------------------------------------
# the model from the training config stored inside a checkpoint
# ---------------------------------------------------------------------------

# The fields of the JAX package's classes (dataclasses.fields of each flax
# module, parent and name included), by the class's target name: the params a
# checkpoint config may give each node. The JAX package drops every other
# key with a warning (presets.py::_inject_tpu_kwargs); so does the port.
_JAX = "synchformer_tpu.models."
JAX_FIELDS = {
    f"{_JAX}sync_model.Synchformer": (
        "afeat_extractor", "vfeat_extractor", "aproj", "vproj", "transformer", "parent", "name"),
    f"{_JAX}sync_model.GlobalTransformer": (
        "n_layer", "n_head", "n_embd", "tok_pdrop", "embd_pdrop", "resid_pdrop", "attn_pdrop",
        "pos_emb_cfg", "off_head_cfg", "dtype", "parent", "name"),
    f"{_JAX}ast_encoder.ASTEncoder": (
        "hidden_size", "depth", "num_heads", "mlp_ratio", "patch_size", "frequency_stride",
        "time_stride", "num_mel_bins", "max_spec_t", "ln_eps", "hidden_dropout",
        "attn_dropout", "extract_features", "factorize_freq_time", "agg_freq_module",
        "agg_time_module", "add_global_repr", "max_segments", "num_labels", "remat", "dtype",
        "attn_impl", "ckpt_path", "feat_type", "agg_segments_module", "parent", "name"),
    f"{_JAX}motionformer.MotionFormerEncoder": (
        "embed_dim", "depth", "num_heads", "mlp_ratio", "attn_layer", "patch_size",
        "z_block_size", "temporal_resolution", "img_size", "drop_rate", "pos_dropout",
        "drop_path_rate", "ln_eps", "factorize_space_time", "agg_space_module",
        "agg_time_module", "add_global_repr", "max_segments", "remat", "dtype", "attn_impl",
        "ckpt_path", "extract_features", "agg_segments_module", "parent", "name"),
    f"{_JAX}bridges.LinearBridge": ("in_features", "out_features", "use_bias", "dtype",
                                    "parent", "name"),
    f"{_JAX}bridges.DoNothingBridge": ("in_features", "out_features", "parent", "name"),
    f"{_JAX}pos_emb.RandInitPositionalEncoding": ("block_shape", "n_embd", "init", "parent",
                                                  "name"),
    f"{_JAX}pos_emb.ZeroInitPositionalEncoding": ("block_shape", "n_embd", "init", "parent",
                                                  "name"),
    f"{_JAX}pos_emb.PositionEmbeddingLearnedVisual": ("block_shape", "n_embd", "parent", "name"),
    f"{_JAX}pos_emb.PositionEmbeddingLearnedAudio": ("block_shape", "n_embd", "parent", "name"),
    f"{_JAX}pos_emb.NoPosEncoding": ("parent", "name"),
    f"{_JAX}pos_emb.L2Normalize": ("eps", "parent", "name"),
    f"{_JAX}bridges.Identity": ("parent", "name"),
    f"{_JAX}bridges.AppendZerosToHidden": ("target_hidden_size", "dim", "parent", "name"),
    f"{_JAX}bridges.ConvBridgeVisual": ("in_channels", "out_channels", "kernel_size", "stride",
                                        "parent", "name"),
    f"{_JAX}bridges.ConvBridgeAudio": ("in_channels", "out_channels", "kernel_size", "stride",
                                       "parent", "name"),
    f"{_JAX}bridges.AvgPoolBridgeVisual": ("kernel_size", "stride", "parent", "name"),
    f"{_JAX}bridges.AvgPoolBridgeAudio": ("kernel_size", "stride", "parent", "name"),
    f"{_JAX}bridges.SpatialpoolConvTemporalpool": ("in_channels", "out_channels", "kernel_size",
                                                   "parent", "name"),
    f"{_JAX}bridges.FrequencypoolConvTemporalpool": ("in_channels", "out_channels",
                                                     "kernel_size", "parent", "name"),
    f"{_JAX}s3d.S3DVisualFeatures": (
        "embed_dim", "num_heads", "drop_rate", "factorize_space_time", "agg_space_module",
        "agg_time_module", "add_global_repr", "max_segments", "dtype", "ckpt_path",
        "extract_features", "agg_segments_module", "parent", "name"),
    f"{_JAX}resnet_audio.ResNet18AudioFeatures": (
        "embed_dim", "stage_sizes", "num_heads", "drop_rate", "factorize_freq_time",
        "agg_freq_module", "agg_time_module", "add_global_repr", "max_segments", "dtype",
        "ckpt_path", "extract_features", "feat_type", "max_spec_t", "agg_segments_module",
        "parent", "name"),
    f"{_JAX}sparsesync.SparseSyncTransformer": (
        "num_offset_cls", "visual_block_shape", "audio_block_shape", "vis_pos_emb_module",
        "aud_pos_emb_module", "pre_norm_cfg", "n_layer", "n_head", "n_embd", "tok_pdrop",
        "embd_pdrop", "resid_pdrop", "attn_pdrop", "dtype", "parent", "name"),
    f"{_JAX}avclip.AVCLIP": (
        "n_embd", "afeat_extractor", "vfeat_extractor", "aproj", "vproj", "init_scale",
        "clamp_scale_min", "clamp_scale_max", "gather_for_loss", "parent", "name"),
    f"{_JAX}moco_clip.MultilevelMoCoCLIP": (
        "n_embd", "queue_size", "momentum", "afeat_extractor", "vfeat_extractor", "aproj",
        "vproj", "init_scale", "clamp_scale_min", "clamp_scale_max", "parent", "name"),
}
JAX_FIELDS[f"{_JAX}sync_model.GlobalTransformerWithSyncabilityHead"] = \
    JAX_FIELDS[f"{_JAX}sync_model.GlobalTransformer"]
# the reference's target names, which the JAX registry resolves to these classes
JAX_ALIASES = {
    "model.sync_model.Synchformer": f"{_JAX}sync_model.Synchformer",
    "model.sync_model.GlobalTransformer": f"{_JAX}sync_model.GlobalTransformer",
    "model.sync_model.GlobalTransformerWithSyncabilityHead":
        f"{_JAX}sync_model.GlobalTransformerWithSyncabilityHead",
    "model.modules.feat_extractors.audio.ast.AST": f"{_JAX}ast_encoder.ASTEncoder",
    "model.modules.feat_extractors.visual.motionformer.MotionFormer":
        f"{_JAX}motionformer.MotionFormerEncoder",
    "torch.nn.Linear": f"{_JAX}bridges.LinearBridge",
    "model.modules.bridges.DoNothingBridge": f"{_JAX}bridges.DoNothingBridge",
    "model.modules.transformer.RandInitPositionalEncoding":
        f"{_JAX}pos_emb.RandInitPositionalEncoding",
    **{f"model.modules.transformer.{n}": f"{_JAX}pos_emb.{n}" for n in (
        "ZeroInitPositionalEncoding", "PositionEmbeddingLearnedVisual",
        "PositionEmbeddingLearnedAudio", "NoPosEncoding", "L2Normalize")},
    "torch.nn.Identity": f"{_JAX}bridges.Identity",
    **{f"model.modules.bridges.{n}": f"{_JAX}bridges.{n}" for n in (
        "AppendZerosToHidden", "ConvBridgeVisual", "ConvBridgeAudio", "AvgPoolBridgeVisual",
        "AvgPoolBridgeAudio", "SpatialpoolConvTemporalpool", "FrequencypoolConvTemporalpool")},
    "model.modules.feat_extractors.visual.s3d.S3DVisualFeatures": f"{_JAX}s3d.S3DVisualFeatures",
    "model.modules.feat_extractors.audio.resnet.ResNet18AudioFeatures":
        f"{_JAX}resnet_audio.ResNet18AudioFeatures",
    "model.modules.transformer.Transformer": f"{_JAX}sparsesync.SparseSyncTransformer",
    "model.modules.feat_extractors.train_clip_src.open_clip.model.AVCLIP": f"{_JAX}avclip.AVCLIP",
    "model.modules.feat_extractors.train_clip_src.open_clip.model.MultilevelMoCoCLIP":
        f"{_JAX}moco_clip.MultilevelMoCoCLIP",
}


def patch_ckpt_model_cfg(model_cfg: dict) -> dict:
    """The reference's patch_config (ref: example.py:76-84): tower ckpt_paths
    are already merged into the model checkpoint, and legacy configs name the
    transformer under ``model.modules.feature_selector``."""
    cfg = copy.deepcopy(model_cfg)
    params = cfg.get("params", {})
    for tower in ("afeat_extractor", "vfeat_extractor"):
        tp = (params.get(tower) or {}).get("params")
        if isinstance(tp, dict) and "ckpt_path" in tp:
            tp["ckpt_path"] = None
    tfm = params.get("transformer")
    if isinstance(tfm, dict) and isinstance(tfm.get("target"), str):
        tfm["target"] = tfm["target"].replace(
            ".modules.feature_selector.", ".sync_model.")
    return cfg


def drop_unknown_ckpt_params(node, attn_impl: Optional[str] = None,
                             dropped: Optional[list] = None):
    """The counterpart of the JAX _inject_tpu_kwargs (presets.py:158-192) on a
    config tree: each target / params node of a JAX class loses the params
    outside that class's fields (JAX_FIELDS; keys from other reference code
    versions), with a warning, and where the class has ``attn_impl`` and one
    is given, takes it unless it names one. ``dropped`` collects
    (target, [keys]). A key the JAX class reads stays, and the port's
    registry builds it. Returns a new tree."""
    if not isinstance(node, dict):
        return node
    if "target" not in node:
        return {k: drop_unknown_ckpt_params(v, attn_impl, dropped) for k, v in node.items()}
    out = {k: v for k, v in node.items() if k != "params"}
    params = {k: drop_unknown_ckpt_params(v, attn_impl, dropped)
              for k, v in (node.get("params") or {}).items()}
    target = node["target"]
    names = JAX_FIELDS.get(JAX_ALIASES.get(target, target))
    if names is not None:
        unknown = sorted(k for k in params if k not in names)
        if unknown:
            logging.warning("%s: dropping unsupported cfg params %s", target, unknown)
            if dropped is not None:
                dropped.append((target, unknown))
            params = {k: v for k, v in params.items() if k not in unknown}
        if "attn_impl" in names and attn_impl is not None:
            params.setdefault("attn_impl", attn_impl)
    out["params"] = params
    return out


def build_synchformer_from_ckpt_args(args, device=None, attn_impl: Optional[str] = None):
    """The sync model from the training config stored inside a checkpoint
    (``ckpt['args']`` as plain_from_ckpt_args gives it, or a Config), as
    synchformer_tpu/models/presets.py:195-233 builds it: interpolations
    resolved, patch_ckpt_model_cfg, drop_unknown_ckpt_params, then the port's
    registry. ``attn_impl`` is the towers' JAX option where the config names
    none. Returns ``(model, info)``: info holds ``target_seq_len`` (the sync
    position embedding's length, for the checkpoint's trim), ``num_cls``,
    ``max_off_sec``, ``max_spec_t``, ``num_mel_bins`` and the raw ``data``
    section, equal to the JAX function's."""
    from synchformer_tpu_torch.config.core import Config
    from synchformer_tpu_torch.registry import instantiate_from_config

    cfg = args.to_dict() if isinstance(args, Config) else Config(args).to_dict()
    if "model" not in cfg or "target" not in cfg.get("model", {}):
        raise ValueError("checkpoint args carry no model.target section")
    model_cfg = drop_unknown_ckpt_params(patch_ckpt_model_cfg(cfg["model"]), attn_impl)
    model = instantiate_from_config(model_cfg, device=device)

    tfm_p = (model_cfg.get("params", {}).get("transformer") or {}).get("params", {})
    pos_p = (tfm_p.get("pos_emb_cfg") or {}).get("params", {})
    block_shape = pos_p.get("block_shape") or [None]
    off_p = (tfm_p.get("off_head_cfg") or {}).get("params", {})
    afeat_p = (model_cfg.get("params", {}).get("afeat_extractor") or {}).get("params", {})
    data = cfg.get("data", {}) or {}
    info = dict(
        target_seq_len=block_shape[0],
        num_cls=int(off_p.get("out_features") or data.get("num_off_cls") or N_OFFSET_CLS),
        max_off_sec=float(data.get("max_off_sec") or 2.0),
        max_spec_t=int(afeat_p.get("max_spec_t") or 66),
        num_mel_bins=int(afeat_p.get("num_mel_bins") or 128),
        data=data,
    )
    return model, info
