"""Weights: the JAX package's parameter tree -> the port's state dict, and a
seeded initialiser in the port's own layout.

``state_dict_from_jax`` (Synchformer), ``avclip_state_dict_from_jax``
(Stage I AVCLIP) and ``moco_state_dict_from_jax`` (MultilevelMoCoCLIP, its
online or its EMA parameters) are the inverse of synchformer_tpu/utils/checkpoint.py::
convert_sync_checkpoint: Dense (in, out) -> Linear (out, in); fused [q|k|v]
columns -> the reference's separate q/k/v rows (AST, sync transformer) or its
packed in_proj / qkv rows (aggregators, Motionformer); Conv (*K, I, O) ->
(O, I, *K); LayerNorm scale -> weight. Everything stays numpy; load with
``load_numpy_state_dict``.

On the port's own state dicts (numpy arrays or tensors): ``trim_sync_pos_emb``
(the reference's pos-emb rule, synchformer_tpu/utils/checkpoint.py:383),
``trim_ast_pos_emb`` (the AST's, convert_ast's ``max_patches``, :191) and
``merge_state_dict_nonstrict`` (load_state_dict(strict=False) with a report,
as merge_params_nonstrict, :406).

Reference Stage II / III checkpoints, which keep the reference's names:
``sync_state_dict_from_ckpt`` (the counterpart of convert_sync_checkpoint,
:276) takes the state dict out of a checkpoint and
``load_sync_state_dict`` loads it into a model, strictly on the names the
model reads.
"""
from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from synchformer_tpu_torch.models.conv import BatchNorm, Conv
from synchformer_tpu_torch.models.layers import LayerNorm

SD = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(p: Mapping, prefix: str) -> SD:
    out = {f"{prefix}.weight": _a(p["kernel"]).T}
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])
    return out


def _layernorm(p: Mapping, prefix: str) -> SD:
    return {f"{prefix}.weight": _a(p["scale"]), f"{prefix}.bias": _a(p["bias"])}


def _conv(p: Mapping, prefix: str) -> SD:
    k = _a(p["kernel"])
    nd = k.ndim - 2
    out = {f"{prefix}.weight": k.transpose((nd + 1, nd) + tuple(range(nd)))}
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])
    return out


def _batch_norm(p: Mapping, stats: Mapping, prefix: str) -> SD:
    """flax BatchNorm: scale / bias from ``params``, mean / var from
    ``batch_stats`` -> weight, bias, running_mean, running_var."""
    return {f"{prefix}.weight": _a(p["scale"]), f"{prefix}.bias": _a(p["bias"]),
            f"{prefix}.running_mean": _a(stats["mean"]),
            f"{prefix}.running_var": _a(stats["var"])}


def _separate_qkv(p: Mapping, names) -> SD:
    k, b = _a(p["kernel"]), _a(p["bias"])
    d = k.shape[0]
    out = {}
    for i, name in enumerate(names):
        out[f"{name}.weight"] = k[:, i * d:(i + 1) * d].T
        out[f"{name}.bias"] = b[i * d:(i + 1) * d]
    return out


def mingpt_block_sd(p: Mapping, prefix: str) -> SD:
    """PreLNBlock params -> the sync transformer's minGPT block names."""
    sd = {**_layernorm(p["ln1"], f"{prefix}.ln1"), **_layernorm(p["ln2"], f"{prefix}.ln2")}
    sd.update(_separate_qkv(p["attn"]["qkv"], [f"{prefix}.attn.{n}"
                                              for n in ("query", "key", "value")]))
    sd.update(_linear(p["attn"]["proj"], f"{prefix}.attn.proj"))
    sd.update(_linear(p["mlp"]["fc1"], f"{prefix}.mlp.0"))
    sd.update(_linear(p["mlp"]["fc2"], f"{prefix}.mlp.2"))
    return sd


def ast_layer_sd(p: Mapping, prefix: str) -> SD:
    """PreLNBlock params -> HF ASTLayer names."""
    sd = {**_layernorm(p["ln1"], f"{prefix}.layernorm_before"),
          **_layernorm(p["ln2"], f"{prefix}.layernorm_after")}
    att = f"{prefix}.attention"
    sd.update(_separate_qkv(p["attn"]["qkv"], [f"{att}.attention.{n}"
                                              for n in ("query", "key", "value")]))
    sd.update(_linear(p["attn"]["proj"], f"{att}.output.dense"))
    sd.update(_linear(p["mlp"]["fc1"], f"{prefix}.intermediate.dense"))
    sd.update(_linear(p["mlp"]["fc2"], f"{prefix}.output.dense"))
    return sd


def cls_pool_layer_sd(p: Mapping, prefix: str) -> SD:
    """CLSPoolEncoderLayer params -> BaseEncoderLayer names (with its
    positional embedding where it has one)."""
    blk = p["block"]
    sd = {f"{prefix}.{k}": _a(p[k]) for k in ("cls_token", "pos_emb") if k in p}
    sd.update({
          **_layernorm(blk["ln1"], f"{prefix}.norm1"),
          **_layernorm(blk["ln2"], f"{prefix}.norm2"),
          f"{prefix}.self_attn.in_proj_weight": _a(blk["attn"]["qkv"]["kernel"]).T,
          f"{prefix}.self_attn.in_proj_bias": _a(blk["attn"]["qkv"]["bias"])})
    sd.update(_linear(blk["attn"]["proj"], f"{prefix}.self_attn.out_proj"))
    sd.update(_linear(blk["mlp"]["fc1"], f"{prefix}.linear1"))
    sd.update(_linear(blk["mlp"]["fc2"], f"{prefix}.linear2"))
    return sd


def _depth(p: Mapping, stem: str) -> int:
    n = 0
    while f"{stem}{n}" in p:
        n += 1
    return n


def divided_block_sd(b: Mapping, prefix: str) -> SD:
    """DividedSpaceTimeBlock params -> the reference block names. The JAX
    tree is the same in the split and the packed flow."""
    sd = {}
    for n in ("norm1", "norm2", "norm3"):
        sd.update(_layernorm(b[n], f"{prefix}.{n}"))
    for n in ("attn", "timeattn"):
        sd.update(_linear(b[n]["qkv"], f"{prefix}.{n}.qkv"))
        sd.update(_linear(b[n]["proj"], f"{prefix}.{n}.proj"))
    sd.update(_linear(b["mlp"]["fc1"], f"{prefix}.mlp.fc1"))
    sd.update(_linear(b["mlp"]["fc2"], f"{prefix}.mlp.fc2"))
    return sd


def motionformer_sd(p: Mapping, prefix: str = "") -> SD:
    sd = {f"{prefix}cls_token": _a(p["cls_token"]),
          f"{prefix}pos_embed": _a(p["pos_embed"]),
          f"{prefix}temp_embed": _a(p["temp_embed"]),
          **_conv(p["patch_embed_3d"], f"{prefix}patch_embed_3d.proj"),
          **_layernorm(p["norm"], f"{prefix}norm")}
    for i in range(_depth(p, "blocks_")):
        sd.update(divided_block_sd(p[f"blocks_{i}"], f"{prefix}blocks.{i}"))
    return {**sd, **_aggregators_sd(p, prefix)}


def _aggregators_sd(p: Mapping, prefix: str) -> SD:
    """A tower's CLS-pool aggregators where it has them: its spatial or
    frequency pool (an AveragePooling holds nothing), its time tail
    (``temp_attn_agg``, a TransformerEncoderLayer) and its global segment
    aggregator."""
    sd = {}
    for name in ("spatial_attn_agg", "freq_attn_agg", "temp_attn_agg", "global_attn_agg"):
        if name in p:
            sd.update(cls_pool_layer_sd(p[name]["cls_layer"], f"{prefix}{name}"))
    return sd


def ast_sd(p: Mapping, prefix: str = "") -> SD:
    e = f"{prefix}ast.embeddings"
    sd = {f"{e}.cls_token": _a(p["cls_token"]),
          f"{e}.distillation_token": _a(p["distillation_token"]),
          f"{e}.position_embeddings": _a(p["position_embeddings"]),
          **_conv(p["patch_embed"], f"{e}.patch_embeddings.projection"),
          **_layernorm(p["layernorm"], f"{prefix}ast.layernorm")}
    for i in range(_depth(p, "layer_")):
        sd.update(ast_layer_sd(p[f"layer_{i}"], f"{prefix}ast.encoder.layer.{i}"))
    return {**sd, **_aggregators_sd(p, prefix)}


def global_transformer_sd(p: Mapping, prefix: str = "transformer.") -> SD:
    """The offset head where the tree has one, the syncability head
    (``sync_head``, a bare Dense) where it has that; the positional
    embedding's parameters where it has any."""
    sd = {**_layernorm(p["vis_in_lnorm"], f"{prefix}vis_in_lnorm"),
          **_layernorm(p["aud_in_lnorm"], f"{prefix}aud_in_lnorm"),
          f"{prefix}OFF_tok": _a(p["OFF_tok"]), f"{prefix}MOD_tok": _a(p["MOD_tok"]),
          **leaves_sd(p.get("pos_emb", {}), f"{prefix}pos_emb_cfg."),
          **_layernorm(p["ln_f"], f"{prefix}ln_f")}
    if "off_head" in p:
        sd.update(_linear(p["off_head"]["linear"], f"{prefix}off_head"))
    if "sync_head" in p:
        sd.update(_linear(p["sync_head"], f"{prefix}sync_head"))
    for i in range(_depth(p, "blocks_")):
        sd.update(mingpt_block_sd(p[f"blocks_{i}"], f"{prefix}blocks.{i}"))
    return sd


def leaves_sd(p: Mapping, prefix: str = "") -> SD:
    """Every leaf of a parameter tree under its dotted path: the positional
    encodings, whose JAX names are the port's."""
    sd = {}
    for name, node in p.items():
        if isinstance(node, Mapping):
            sd.update(leaves_sd(node, f"{prefix}{name}."))
        else:
            sd[f"{prefix}{name}"] = _a(node)
    return sd


def legacy_trunk_sd(p: Mapping, stats: Mapping, prefix: str = "") -> SD:
    """An S3D or ResNet-18 trunk (params and batch_stats trees; the port's
    names are the JAX module names): each Conv (a kernel of 3 or more axes,
    no bias) and each BatchNorm (``scale`` beside its running statistics);
    the aggregators (``*_attn_agg``) are left to _aggregators_sd."""
    sd = {}
    for name, node in p.items():
        if name.endswith("_attn_agg"):
            continue
        path = f"{prefix}{name}"
        if "kernel" in node:
            sd.update(_conv(node, path))
        elif "scale" in node:
            sd.update(_batch_norm(node, stats[name], path))
        else:
            sd.update(legacy_trunk_sd(node, stats[name], path + "."))
    return sd


def legacy_tower_sd(p: Mapping, stats: Mapping, prefix: str = "") -> SD:
    """S3DVisualFeatures or ResNet18AudioFeatures (params and batch_stats)
    -> the port's state dict."""
    return {**legacy_trunk_sd(p, stats, prefix), **_aggregators_sd(p, prefix)}


def bridge_sd(p: Mapping, prefix: str) -> SD:
    """A bridge's Conv (ConvBridgeVisual / ConvBridgeAudio) or Dense (the
    pool-conv-pool heads' ``conv``) under ``prefix`` + its JAX name;
    LinearBridge's ``linear`` is the bridge itself. The pools and identities
    hold nothing (and flax leaves them out of the tree)."""
    sd = {}
    for name, node in p.items():
        fn = _linear if np.ndim(node["kernel"]) == 2 else _conv
        sd.update(fn(node, prefix[:-1] if name == "linear" else prefix + name))
    return sd


def sparsesync_sd(p: Mapping, prefix: str = "") -> SD:
    """SparseSyncTransformer -> the port's state dict: the tokens, the
    pre-norms' and positional embeddings' parameters where they have any,
    the minGPT blocks, ln_f and the bias-free offset head."""
    sd = {f"{prefix}OFF_tok": _a(p["OFF_tok"]), f"{prefix}MOD_tok": _a(p["MOD_tok"]),
          **_layernorm(p["ln_f"], f"{prefix}ln_f"), **_linear(p["off_head"], f"{prefix}off_head")}
    for name in ("pre_lnorm_vis", "pre_lnorm_aud", "vis_pos_emb", "aud_pos_emb"):
        sd.update(leaves_sd(p.get(name, {}), f"{prefix}{name}."))
    for i in range(_depth(p, "blocks_")):
        sd.update(mingpt_block_sd(p[f"blocks_{i}"], f"{prefix}blocks.{i}"))
    return sd


def tower_sd(p: Mapping, stats: Optional[Mapping], prefix: str) -> SD:
    """A tower's state dict, its kind read from its tree: Motionformer
    (``patch_embed_3d``), AST (``patch_embed``), S3D (``stem_sep``) or
    ResNet-18 (``layer1_0``); the legacy towers also read ``stats``, their
    batch_stats."""
    if "patch_embed_3d" in p:
        return motionformer_sd(p, prefix)
    if "patch_embed" in p:
        return ast_sd(p, prefix)
    if stats is None:
        raise KeyError(f"{prefix}: a legacy tower needs its batch_stats")
    return legacy_tower_sd(p, stats, prefix)


def state_dict_from_jax(variables: Mapping) -> SD:
    """Synchformer variables (numpy or JAX arrays; ``params`` and, for the
    legacy towers, ``batch_stats``, or the params tree alone) -> the port's
    state dict, named as the reference's Stage II checkpoint (Stage III's
    with the syncability transformer)."""
    p = variables.get("params", variables)
    stats = variables.get("batch_stats", {})
    return {**tower_sd(p["v_encoder"], stats.get("v_encoder"), "vfeat_extractor."),
            **tower_sd(p["a_encoder"], stats.get("a_encoder"), "afeat_extractor."),
            **bridge_sd(p.get("v_proj", {}), "vproj."),
            **bridge_sd(p.get("a_proj", {}), "aproj."),
            **global_transformer_sd(p["sync_transformer"], "transformer.")}


def avclip_state_dict_from_jax(params: Mapping) -> SD:
    """AVCLIP params tree -> the port's AVCLIP state dict: both towers (their
    AveragePooling time tails and the DoNothing bridges hold no parameters)
    and the 0-d ``logit_scale``."""
    p = params.get("params", params)
    return {**motionformer_sd(p["v_encoder"], "vfeat_extractor."),
            **ast_sd(p["a_encoder"], "afeat_extractor."),
            "logit_scale": _a(p["logit_scale"])}


def moco_state_dict_from_jax(params: Mapping) -> SD:
    """MultilevelMoCoCLIP params tree (the online parameters or the EMA
    copy) -> the port's MoCo state dict: both towers with their global
    segment aggregators and the 0-d logit scales (its four DoNothing
    projections hold no parameters)."""
    p = params.get("params", params)
    sd = {**motionformer_sd(p["v_encoder"], "v_encoder."),
          **ast_sd(p["a_encoder"], "a_encoder.")}
    for scale in ("segment_logit_scale", "global_logit_scale"):
        if scale in p:
            sd[scale] = _a(p[scale])
    return sd


SYNC_POS_EMB = "transformer.pos_emb_cfg.pos_emb"


def trim_sync_pos_emb(sd: Mapping, target_seq_len: Optional[int],
                      key: str = SYNC_POS_EMB) -> dict:
    """A copy of ``sd`` whose sync positional embedding (1, L, D) is cut to
    ``target_seq_len`` tokens where it is longer (e.g. 198 for S=14 -> 184
    for S=13, ref sync_model.py:101-114); a shorter one is refused. No
    target, or no such entry: the copy unchanged."""
    out = dict(sd)
    if target_seq_len is None or key not in out:
        return out
    pos = out[key]
    if pos.shape[1] > target_seq_len:
        logging.warning(f"trimming sync pos emb {pos.shape[1]} -> {target_seq_len}")
        out[key] = pos[:, :target_seq_len]
    elif pos.shape[1] < target_seq_len:
        raise ValueError(f"cannot load shorter pos emb ({pos.shape[1]} < {target_seq_len})")
    return out


def merge_state_dict_nonstrict(init: Mapping, loaded: Mapping) -> Tuple[dict, dict]:
    """torch's load_state_dict(strict=False) with a report, on flat state
    dicts: names in both with equal shapes take the loaded value; names only
    in ``init`` keep theirs (``missing``: a fresh head); names only in
    ``loaded`` are dropped (``unexpected``); shape mismatches keep the init
    value (``mismatched``, 'name: ckpt (..) vs model (..)'). Returns (merged,
    report); the report's lists are in ``init``'s / ``loaded``'s order."""
    report = {"missing": [], "unexpected": [], "mismatched": []}
    merged = {}
    for name, val in init.items():
        if name not in loaded:
            report["missing"].append(name)
            merged[name] = val
        elif tuple(loaded[name].shape) != tuple(val.shape):
            report["mismatched"].append(f"{name}: ckpt {tuple(loaded[name].shape)} vs model "
                                        f"{tuple(val.shape)}")
            merged[name] = val
        else:
            merged[name] = loaded[name]
    report["unexpected"] = [name for name in loaded if name not in init]
    return merged, report


@torch.no_grad()
def load_numpy_state_dict(model: torch.nn.Module, sd: Mapping[str, np.ndarray]) -> None:
    """Copy numpy arrays into the model's parameters and buffers (the
    BatchNorms' running statistics; strict: every name on both sides),
    converting to each one's dtype and device."""
    params = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    missing = sorted(set(params) - set(sd))
    extra = sorted(set(sd) - set(params))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:5]}, unexpected {extra[:5]}")
    for name, arr in sd.items():
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, np.float32)).reshape(p.shape))


def seeded_state_dict(model: torch.nn.Module, seed: int) -> SD:
    """Random weights in the port's layout from a numpy seed: LayerNorm
    weight 1 and bias 0; an AVCLIP's ``logit_scale`` (a MoCo model's
    ``segment_logit_scale`` and ``global_logit_scale``) its ``init_scale``;
    every other parameter normal with std 0.02. In a model with BatchNorms
    (the legacy towers), so that activations stay of order 1 through their
    trunks: each models/conv.py Conv's kernel normal with std (2 /
    fan_in)^0.5 (He), BatchNorm weight 1 + 0.1 N, bias 0.1 N, then the
    buffers, running mean 0.1 N and running var uniform in [0.5, 1.5]; the
    BatchNorms that close a residual sum (``closes_residual``: a ResNet
    BasicBlock's bn2 and downsample_bn) at half that weight, else each of
    ResNet-18's eight sums doubles the variance (trunk output std 38 at
    weight 1, 1.3 at half, on a seeded mel of std 1). A model without
    BatchNorms draws exactly as before."""
    rng = np.random.default_rng(seed)
    ln_params, convs, bns, closing = set(), set(), {}, set()
    for mname, mod in model.named_modules():
        if isinstance(mod, LayerNorm):
            ln_params.update({f"{mname}.weight", f"{mname}.bias"})
        elif isinstance(mod, Conv):
            convs.add(f"{mname}.weight")
        elif isinstance(mod, BatchNorm):
            bns[f"{mname}.weight"], bns[f"{mname}.bias"] = 1.0, 0.0
            if mod.closes_residual:
                closing.add(f"{mname}.weight")
    sd = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name in ln_params:
            fill = 1.0 if name.endswith("weight") else 0.0
            sd[name] = np.full(shape, fill, np.float32)
        elif name.endswith("logit_scale"):
            sd[name] = np.full(shape, model.init_scale, np.float32)
        elif bns and name in convs:
            std = np.float32((2.0 / np.prod(shape[1:])) ** 0.5)
            sd[name] = rng.standard_normal(shape, dtype=np.float32) * std
        elif name in bns:
            sd[name] = np.float32(bns[name]) + rng.standard_normal(
                shape, dtype=np.float32) * np.float32(0.1)
            if name in closing:
                sd[name] *= np.float32(0.5)
        else:
            sd[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
    for name, buf in model.named_buffers():
        shape = tuple(buf.shape)
        if name.endswith("running_mean"):
            sd[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.1)
        elif name.endswith("running_var"):
            sd[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return sd


AST_POS_EMB = "ast.embeddings.position_embeddings"


def trim_ast_pos_emb(sd: Mapping, n_tokens: Optional[int], prefix: str = "") -> dict:
    """A copy of ``sd`` whose AST position embedding (``prefix`` +
    ast.embeddings.position_embeddings, (1, N, D)) is cut to ``n_tokens``
    where it is longer: a reference AST keeps the AudioSet embedding of 1214
    tokens and slices it to the 2 + f * t tokens of its geometry at run time
    (ref: audio/ast.py:240-245), 74 at the published 128 x 66 mel. A shorter
    one is refused. No count, or no such entry: the copy unchanged."""
    out = dict(sd)
    key = prefix + AST_POS_EMB
    if n_tokens is None or key not in out:
        return out
    pos = out[key]
    if pos.shape[1] > n_tokens:
        logging.info(f"trimming AST pos emb {pos.shape[1]} -> {n_tokens}")
        out[key] = pos[:, :n_tokens]
    elif pos.shape[1] < n_tokens:
        raise ValueError(f"{key}: cannot load a shorter AST pos emb "
                         f"({pos.shape[1]} < {n_tokens} tokens)")
    return out


def strip_module_prefix(sd: Mapping) -> dict:
    """The names of a state dict saved from DistributedDataParallel without
    its ``module.`` (every occurrence, as the JAX converter strips it)."""
    return {k.replace("module.", ""): v for k, v in sd.items()}


def sync_state_dict_from_ckpt(ckpt: Mapping, target_seq_len: Optional[int] = None) -> dict:
    """A Stage II / III checkpoint ({'model': state dict, ...}, or a bare
    state dict) -> the state dict in the port's names, which are the
    reference's: ``module.`` stripped, the sync position embedding cut to
    ``target_seq_len`` (trim_sync_pos_emb; a shorter one refused), as
    synchformer_tpu/utils/checkpoint.py::convert_sync_checkpoint reads it."""
    if not isinstance(ckpt, Mapping):
        raise ValueError(f"a checkpoint is a mapping, not a {type(ckpt).__name__}")
    sd = ckpt["model"] if "model" in ckpt else ckpt
    return trim_sync_pos_emb(strip_module_prefix(sd), target_seq_len)


@torch.no_grad()
def load_sync_state_dict(model: torch.nn.Module, sd: Mapping) -> list:
    """Load a state dict into ``model`` (its parameters keep their dtype and
    device), strict on the names the model reads: a name the model reads and
    ``sd`` lacks raises, naming it, as does a shape that differs, except that
    the AST's position embedding is first cut to the model's tokens
    (trim_ast_pos_emb). Names ``sd`` has and the model does not read are
    logged and returned, as the JAX converter ignores them."""
    own = model.state_dict()
    pos = f"afeat_extractor.{AST_POS_EMB}"
    if pos in own:
        sd = trim_ast_pos_emb(sd, own[pos].shape[1], "afeat_extractor.")
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} tensors the model reads: "
                       f"{missing[:8]}")
    for name, val in own.items():
        if tuple(sd[name].shape) != tuple(val.shape):
            raise ValueError(f"{name}: checkpoint {tuple(sd[name].shape)} vs model "
                             f"{tuple(val.shape)}")
    model.load_state_dict({k: torch.as_tensor(sd[k]) for k in own})
    unused = [k for k in sd if k not in own]
    if unused:
        logging.info(f"the checkpoint's {len(unused)} tensors the model does not read: "
                     f"{unused[:8]}")
    return unused
