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
    return {f"{prefix}.weight": k.transpose((nd + 1, nd) + tuple(range(nd))),
            f"{prefix}.bias": _a(p["bias"])}


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
    return {**sd, **_aggregators_sd(p, prefix, "spatial_attn_agg")}


def _aggregators_sd(p: Mapping, prefix: str, pool: str) -> SD:
    """A tower's CLS-pool aggregators where it has them: its spatial or
    frequency pool (``pool``; an AveragePooling holds nothing), its time
    tail (``temp_attn_agg``, a TransformerEncoderLayer) and its global
    segment aggregator."""
    sd = {}
    for name in (pool, "temp_attn_agg", "global_attn_agg"):
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
    return {**sd, **_aggregators_sd(p, prefix, "freq_attn_agg")}


def global_transformer_sd(p: Mapping, prefix: str = "transformer.") -> SD:
    """The offset head where the tree has one, the syncability head
    (``sync_head``, a bare Dense) where it has that."""
    sd = {**_layernorm(p["vis_in_lnorm"], f"{prefix}vis_in_lnorm"),
          **_layernorm(p["aud_in_lnorm"], f"{prefix}aud_in_lnorm"),
          f"{prefix}OFF_tok": _a(p["OFF_tok"]), f"{prefix}MOD_tok": _a(p["MOD_tok"]),
          f"{prefix}pos_emb_cfg.pos_emb": _a(p["pos_emb"]["pos_emb"]),
          **_layernorm(p["ln_f"], f"{prefix}ln_f")}
    if "off_head" in p:
        sd.update(_linear(p["off_head"]["linear"], f"{prefix}off_head"))
    if "sync_head" in p:
        sd.update(_linear(p["sync_head"], f"{prefix}sync_head"))
    for i in range(_depth(p, "blocks_")):
        sd.update(mingpt_block_sd(p[f"blocks_{i}"], f"{prefix}blocks.{i}"))
    return sd


def state_dict_from_jax(params: Mapping) -> SD:
    """Synchformer params tree (numpy or JAX arrays) -> the port's state dict,
    named as the reference's Stage II checkpoint (Stage III's with the
    syncability transformer)."""
    p = params.get("params", params)
    return {**motionformer_sd(p["v_encoder"], "vfeat_extractor."),
            **ast_sd(p["a_encoder"], "afeat_extractor."),
            **_linear(p["v_proj"]["linear"], "vproj"),
            **_linear(p["a_proj"]["linear"], "aproj"),
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
    """Copy numpy arrays into the model's parameters (strict: every name on
    both sides), converting to each parameter's dtype and device."""
    params = dict(model.named_parameters())
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
    every other parameter normal with std 0.02."""
    rng = np.random.default_rng(seed)
    ln_params = set()
    for mname, mod in model.named_modules():
        if isinstance(mod, LayerNorm):
            ln_params.update({f"{mname}.weight", f"{mname}.bias"})
    sd = {}
    for name, p in model.named_parameters():
        if name in ln_params:
            fill = 1.0 if name.endswith("weight") else 0.0
            sd[name] = np.full(tuple(p.shape), fill, np.float32)
        elif name.endswith("logit_scale"):
            sd[name] = np.full(tuple(p.shape), model.init_scale, np.float32)
        else:
            sd[name] = rng.standard_normal(tuple(p.shape), dtype=np.float32) * np.float32(0.02)
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
