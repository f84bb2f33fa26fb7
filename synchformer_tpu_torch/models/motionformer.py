"""Motionformer video tower (synchformer_tpu/models/motionformer.py) on 5-D
patch-major input, in the JAX package's two token flows.

The flow follows the JAX choice (motionformer.py:554-559) for every head
layout, whatever ``impl``: the split (CLS, patches) flow where the heads pair
into 128 lanes (``heads_groupable``, the TPU's lane rule, of which the port
keeps its own copy), the packed (B*S, 1 + f*n, D) flow otherwise. The two
round at other points (split eval fuses projection + residual and chains the
LN statistics; packed does neither), so taking JAX's flow keeps the port's
numbers on the JAX package's for every layout. ``packed`` says which.

Split flow. Eval (``deterministic=True``), per block, as the JAX package's deterministic
kernel path runs it (motionformer.py:494-516, 548-610):
- time attention on norm3 (LN of the patches from the previous block's row
  statistics), then space attention on norm1, each through K1 with the
  projection + residual in its epilogue; the CLS row's projection and residual
  run outside the kernel;
- norm2 + MLP + residual on the patches through K2, which also emits the row
  statistics for the next norm3; the CLS row's MLP runs as the plain
  composition.
The final norm also applies the statistics.

Training (``deterministic=False``), per block, as the JAX split flow runs it
with the stochastic pieces live (motionformer.py:300-381): no statistics
chain; time then space attention as LN -> QKV -> K5 (backward K6, through
DividedAttentionFn) -> projection; drop-path on the space branch only, one
draw per sample shared by the CLS and patch halves; the MLP through K2 where
the block is not stochastic (drop-path 0, the first block at the default
linspace(0, 0.2, depth)), else the plain composition with drop-path. The
drop-path factors are drawn before the block, so that ``remat=True``
(torch.utils.checkpoint around each block) recomputes the same ones.

Packed flow (motionformer.py:612-667), eval and training alike: the CLS
row is prepended to the patch tokens with the tiled 'separate' position
embedding; per block, time attention on norm3 (LN -> QKV -> K7a/K7b through
DividedAttentionPackedFn, backward K7c -> projection) with its residual,
space attention on norm1 with drop-path on its residual, then the MLP on the
whole packed x through K2 where the block is not stochastic (eval, or
drop-path 0), else the plain composition with drop-path; drop-path factors
drawn before the block as in the split flow. At the end the CLS row is dropped
and the final norm is a plain LayerNorm. No statistics chain, no fused
projection.

``attn_impl`` is the JAX option of the same name: 'pallas' (the default, all
of the above) or 'pallas_fused'. Under 'pallas_fused' the packed flow runs
each attention's LN + QKV + attention through K8a (FusedDividedAttentionFn,
backward K7c; motionformer.py:176-189) and the MLP of each non-stochastic
block through K8b (:394-403); the split flow's eval takes neither the fused
projection (K1) nor the statistics chain (:300-301, :581-582): its blocks run
as in training with no drop-path (K5, then the projection and residual
outside; K2 without statistics), then a plain final norm. Split-flow training
is the same on both routes. ``impl`` keeps its meaning on both: on
'pallas_fused' the plain versions are the JAX _fused_attention_ref and
_fused_mlp_ref, the same operations as the 'pallas' plain path.

Then the SpatialAggregator (K4) pools each frame (``agg_space_module``
'AveragePooling': the mean over the frame's patches), and the time tail that
``agg_time_module`` names pools the frames as the JAX tower reads it
(aggregators.time_tail): 'AveragePooling' their mean,
'TransformerEncoderLayer' a TemporalAggregator (K4), any other string (the
reference's 'torch.nn.Identity') none. With
``add_global_repr`` (the MoCo Stage I towers) a TemporalAggregator with a
positional embedding over ``max_segments`` pools the (B, S, D) segment
features into one global feature per clip (motionformer.py:696-705); in
training its positional dropout is ``pos_dropout``, and where that is above 0
the CLS row goes in inside x, through K4b. ``pos_dropout`` also drops the
tokens after their positional embeddings in training, on both flows
(motionformer.py:569-571, 629). ``forward`` returns the segment features,
``forward_with_global`` them and the global feature. State names follow the
reference (``patch_embed_3d.proj``,
``blocks.{i}.{norm1,norm2,norm3,attn,timeattn,mlp}``, ``norm``,
``spatial_attn_agg``, ``global_attn_agg``).

The other JAX options (motionformer.py:457-705):
- ``drop_rate``, live in training: each attention's projection is dropped
  (after K5 on the split flow, after K7a / K8a on the packed one), and a
  block with a live dropout or drop-path runs its MLP as the plain
  composition with both of its dropouts; the aggregators take it as their
  block dropout. Eval is unchanged (K1, K2).
- 6-D frames (B, S, T, H, W, C) go through the same patch embed, patchified
  on the device (ops/video.py::patchify_frames); the 5-D patch-major route
  is unchanged.
- ``keep_mask`` (B, S, T, H, W, C), with 6-D frames only: the content keep
  becomes a token keep, the minimum over each patch's z x p x p x C window
  (JAX :533-544), and the tower takes the packed flow (JAX ``use_split`` is
  false under a mask) with the divided attention as the JAX XLA composition
  (ops/kernels/divided_attention.py::divided_attention_packed_plain with
  its ``keep``: no K1, K5, K7a-K7c or K8a); the MLP keeps K2 /
  K8b where nothing is stochastic; the spatial aggregator masks its keys.
- ``attn_layer='joint'``: one ``st_embed`` (1, 1 + f*n, D) and plain pre-LN
  blocks (layers.ViTBlock: ``blocks.{i}.{norm1,attn,norm2,mlp}``) over all
  tokens, their residual dropout ``drop_rate`` and drop-path, on the plain
  route always (the JAX blocks run at PreLNBlock's default impl 'xla'); the
  spatial pool stays on K4.
- ``factorize_space_time=False`` keeps the (f, h, w) grid, (B, S, f, h, w,
  D); an ``agg_space_module`` other than the two pools runs no pool, as the
  JAX tower; ``mlp_ratio`` sets the blocks' hidden width;
  ``extract_features`` is accepted and read nowhere, as in the JAX tower.

Spans of the port's recorder (utils/trace.py): each divided block is a
``block``; in it each attention (QKV, K1 / K5 / K7a / K8a, the projection) an
``attn``, the MLP (K2, K8b or the plain composition) an ``mlp``, and each
LayerNorm composition outside a kernel (norm3 / norm1 of the CLS row and the
patches, the plain MLP's, the packed flow's pre-norms) a ``norm``; the final
norm (or ``layer_norm_from_stats``) a ``norm``.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from synchformer_tpu_torch.models.aggregators import (
    AveragePooling,
    SpatialAggregator,
    TemporalAggregator,
    time_tail,
)
from synchformer_tpu_torch.models.layers import (
    Container,
    DropPath,
    LayerNorm,
    Linear,
    ViTBlock,
    checkpoint_with_generator,
    element_dropout,
    mlp,
)
from synchformer_tpu_torch.ops.kernels.divided_attention import (
    divided_attention_packed_plain,
    divided_attention_proj,
    heads_groupable,
)
from synchformer_tpu_torch.ops.kernels.divided_attention_bwd import (
    divided_attention_split,
    packed_divided_attention,
)
from synchformer_tpu_torch.ops.kernels.fused_block import (
    fused_divided_attention,
    fused_mlp_residual,
)
from synchformer_tpu_torch.ops.kernels.fused_rows import (
    fused_ln_mlp_residual,
    ln_mlp_residual_plain,
    pitched,
)
from synchformer_tpu_torch.ops.numerics import dense, layer_norm, layer_norm_from_stats
from synchformer_tpu_torch.ops.video import patch_embed_matrix, patchify_frames
from synchformer_tpu_torch.utils import trace


def _normed(norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm(x)`` in a ``norm`` span (utils/trace.py)."""
    with trace.span("norm"):
        return norm(x)


class DividedAttention(nn.Module):
    def __init__(self, d: int, num_heads: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = float(dropout)
        self.qkv = Linear(d, 3 * d, device=device)
        self.proj = Linear(d, d, device=device)

    def forward(self, cls, patches, ln_cls, ln_patches, mode: str, impl: str):
        """Eval: residual inputs (cls, patches) and their LN'd versions -> the
        post-residual (cls, patches), through K1."""
        dtype = patches.dtype
        qkv_c = self.qkv(ln_cls)
        qkv_p = self.qkv(ln_patches)
        y_p, attn_c = divided_attention_proj(qkv_p, qkv_c, patches, self.proj.weight.to(dtype),
                                             self.proj.bias, self.num_heads, mode, impl=impl)
        proj_c = torch.matmul(attn_c.float(), self.proj.weight.float().t()) + self.proj.bias.float()
        return cls + proj_c.to(dtype), y_p

    def _drop(self, t, generator: Optional[torch.Generator]):
        """The projection's dropout (JAX proj_dropout), live with a generator."""
        return t if generator is None else element_dropout(t, self.dropout, generator)

    def attend(self, ln_cls, ln_patches, mode: str, impl: str,
               generator: Optional[torch.Generator] = None):
        """Training: LN'd (cls, patches) -> projected attention (cls, patches),
        differentiable (K5 forward, K6 backward on the kernel route), each
        projection dropped with a generator (the CLS row's first)."""
        qkv_c = self.qkv(ln_cls)
        qkv_p = self.qkv(ln_patches)
        out_p, out_c = divided_attention_split(qkv_p, qkv_c, self.num_heads, mode, impl=impl)
        return self._drop(self.proj(out_c), generator), self._drop(self.proj(out_p), generator)

    def attend_packed(self, x, norm: LayerNorm, num_frames: int, mode: str, impl: str,
                      attn_impl: str, generator: Optional[torch.Generator] = None,
                      keep_mask: Optional[torch.Tensor] = None):
        """Packed flow, eval and training: the block's x (B, 1 + f*n, D) and
        this attention's pre-norm -> projected attention, differentiable,
        dropped with a generator. Under a keep-mask (B, 1 + f*n): LN -> QKV ->
        divided_attention_packed_plain with the mask on every route. Otherwise, on the kernel
        route 'pallas' runs LN -> QKV -> K7a/K7b, 'pallas_fused' K8a; the
        backward is K7c on both."""
        if keep_mask is not None:
            out = divided_attention_packed_plain(self.qkv(_normed(norm, x)), self.num_heads,
                                                 num_frames, mode, keep=keep_mask)
        elif attn_impl == "pallas_fused":
            out = fused_divided_attention(x, norm.weight, norm.bias, self.qkv.weight.to(x.dtype),
                                          self.qkv.bias, self.num_heads, num_frames, mode,
                                          norm.eps, impl=impl)
        else:
            out = packed_divided_attention(self.qkv(_normed(norm, x)), self.num_heads,
                                           num_frames, mode, impl=impl)
        return self._drop(self.proj(out), generator)


class DividedSpaceTimeBlock(nn.Module):
    def __init__(self, d: int, num_heads: int, eps: float = 1e-6, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, attn_impl: str = "pallas", dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.eps = eps
        self.attn_impl = attn_impl
        self.dropout = float(dropout)
        hidden = int(d * mlp_ratio)
        self.norm1 = LayerNorm(d, eps, device)
        self.norm2 = LayerNorm(d, eps, device)
        self.norm3 = LayerNorm(d, eps, device)
        self.attn = DividedAttention(d, num_heads, dropout, device)
        self.timeattn = DividedAttention(d, num_heads, dropout, device)
        self.mlp = Container(fc1=Linear(d, hidden, device=device),
                             fc2=Linear(hidden, d, device=device))
        self.drop_path = DropPath(drop_path)

    def stochastic(self, generator: Optional[torch.Generator]) -> bool:
        """Training with a live dropout or drop-path: the MLP leaves K2 / K8b
        for the plain composition (JAX ``stochastic``, motionformer.py:333)."""
        return generator is not None and (self.dropout > 0.0 or self.drop_path.rate > 0.0)

    def _ln_patches(self, norm: LayerNorm, patches, stats):
        if stats is None:
            return norm(patches)
        return layer_norm_from_stats(patches, stats[..., 0:1], stats[..., 1:2],
                                     norm.weight, norm.bias, self.eps, patches.dtype)

    def _mlp_args(self, dtype):
        return (self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight.to(dtype),
                self.mlp.fc1.bias, pitched(self.mlp.fc2.weight, dtype), self.mlp.fc2.bias, self.eps)

    def forward(self, cls, patches, stats, impl: str):
        """Eval: (cls (BS, 1, D), patches (BS, f, n, D), row stats of patches
        or None) -> (cls, patches, stats of the new patches)."""
        with trace.span("block"):
            cls, patches = self._attention(self.timeattn, self.norm3, cls, patches, stats,
                                           "time", impl)
            cls, patches = self._attention(self.attn, self.norm1, cls, patches, None,
                                           "space", impl)
            with trace.span("mlp"):
                mlp_args = self._mlp_args(patches.dtype)
                patches, stats = fused_ln_mlp_residual(patches, *mlp_args, emit_stats=True,
                                                       impl=impl)
                cls = ln_mlp_residual_plain(cls, *mlp_args)
            return cls, patches, stats

    def _attention(self, attn: DividedAttention, norm: LayerNorm, cls, patches, stats,
                   mode: str, impl: str):
        """Eval: one attention of the block, its LayerNorms (from the
        previous block's row statistics where given) in a ``norm`` span and
        K1 in an ``attn`` span."""
        with trace.span("norm"):
            ln_cls, ln_patches = norm(cls), self._ln_patches(norm, patches, stats)
        with trace.span("attn"):
            return attn(cls, patches, ln_cls, ln_patches, mode, impl)

    def _attend(self, attn: DividedAttention, norm: LayerNorm, cls, patches, mode: str,
                impl: str, generator: Optional[torch.Generator]):
        """Training: one attention's LayerNorms in a ``norm`` span, the rest
        (DividedAttention.attend) in an ``attn`` span."""
        with trace.span("norm"):
            ln_cls, ln_patches = norm(cls), norm(patches)
        with trace.span("attn"):
            return attn.attend(ln_cls, ln_patches, mode, impl, generator)

    def forward_train(self, cls, patches, impl: str, space_scale: Optional[torch.Tensor],
                      mlp_scale: Optional[torch.Tensor],
                      generator: Optional[torch.Generator] = None):
        """Training, and eval under 'pallas_fused': (cls, patches) -> (cls,
        patches). ``space_scale`` and ``mlp_scale`` are this block's drop-path
        factors (DropPath.draw), both None at drop-path 0 and in eval;
        ``generator`` (training) draws the dropouts."""
        with trace.span("block"):
            t_c, t_p = self._attend(self.timeattn, self.norm3, cls, patches, "time", impl,
                                    generator)
            cls, patches = cls + t_c, patches + t_p
            s_c, s_p = self._attend(self.attn, self.norm1, cls, patches, "space", impl,
                                    generator)
            cls = cls + DropPath.drop(s_c, space_scale)
            patches = patches + DropPath.drop(s_p, space_scale)
            with trace.span("mlp"):
                mlp_args = self._mlp_args(patches.dtype)
                if not self.stochastic(generator):  # the patches' MLP is K2
                    patches = fused_ln_mlp_residual(patches, *mlp_args, impl=impl)
                    return ln_mlp_residual_plain(cls, *mlp_args), patches
                return (cls + DropPath.drop(self._mlp_plain(cls, generator), mlp_scale),
                        patches + DropPath.drop(self._mlp_plain(patches, generator), mlp_scale))

    def _mlp_plain(self, t, generator: Optional[torch.Generator] = None):
        with trace.span("norm"):
            h = layer_norm(t, self.norm2.weight, self.norm2.bias, self.eps, t.dtype)
        return mlp(h, self.mlp.fc1.weight, self.mlp.fc1.bias, self.mlp.fc2.weight,
                   self.mlp.fc2.bias, self.dropout, generator)

    def forward_packed(self, x, num_frames: int, impl: str,
                       space_scale: Optional[torch.Tensor], mlp_scale: Optional[torch.Tensor],
                       generator: Optional[torch.Generator] = None,
                       keep_mask: Optional[torch.Tensor] = None):
        """Packed flow, eval and training: x (B, 1 + f*n, D) -> x. The scales
        are this block's drop-path factors (DropPath.draw), both None in eval
        and at drop-path 0; ``generator`` (training) draws the dropouts;
        ``keep_mask`` (B, 1 + f*n) masks both attentions. Where nothing is
        stochastic the MLP is K2 ('pallas') or K8b ('pallas_fused') on the
        whole packed x."""
        with trace.span("block"):
            with trace.span("attn"):
                x = x + self.timeattn.attend_packed(x, self.norm3, num_frames, "time", impl,
                                                    self.attn_impl, generator, keep_mask)
            with trace.span("attn"):
                x = x + DropPath.drop(self.attn.attend_packed(
                    x, self.norm1, num_frames, "space", impl, self.attn_impl, generator,
                    keep_mask), space_scale)
            with trace.span("mlp"):
                if not self.stochastic(generator):
                    mlp = (fused_mlp_residual if self.attn_impl == "pallas_fused"
                           else fused_ln_mlp_residual)
                    return mlp(x, *self._mlp_args(x.dtype), impl=impl)
                return x + DropPath.drop(self._mlp_plain(x, generator), mlp_scale)


class MotionFormerEncoder(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, z_block_size: int = 2, temporal_resolution: int = 8,
                 img_size: int = 224, in_chans: int = 3, ln_eps: float = 1e-6,
                 drop_path_rate: float = 0.2,
                 agg_space_module: str = "TransformerEncoderLayer",
                 agg_time_module: str = "Identity",
                 remat: bool = False, attn_impl: str = "pallas", pos_dropout: float = 0.0,
                 add_global_repr: bool = False, max_segments: Optional[int] = None,
                 mlp_ratio: float = 4.0, attn_layer: str = "divided", drop_rate: float = 0.0,
                 factorize_space_time: bool = True, extract_features: bool = True,
                 device=None):
        super().__init__()
        if attn_layer not in ("divided", "joint"):
            raise ValueError(f"attn_layer must be 'divided' or 'joint', got {attn_layer!r}")
        if attn_impl not in ("pallas", "pallas_fused"):
            raise ValueError(f"attn_impl must be 'pallas' or 'pallas_fused', got {attn_impl!r}")
        space_pools = agg_space_module in ("TransformerEncoderLayer", "AveragePooling")
        tail = (time_tail(agg_time_module, embed_dim, num_heads, device, drop_rate)
                if factorize_space_time else None)
        if tail is not None and not space_pools:
            raise ValueError(f"the time tail {agg_time_module!r} takes (BS, t, D) features: "
                             f"agg_space_module {agg_space_module!r} pools no frame")
        if add_global_repr and tail is None:
            raise ValueError("add_global_repr pools (B, S, D) segment features: it needs "
                             "agg_time_module 'AveragePooling' or 'TransformerEncoderLayer' "
                             "on a factorized tower")
        d = embed_dim
        self.eps = ln_eps
        self.f = temporal_resolution
        self.z = z_block_size
        self.patch_size = patch_size
        self.grid = img_size // patch_size
        self.remat = remat
        self.attn_impl = attn_impl
        self.joint = attn_layer == "joint"
        self.packed = not heads_groupable(num_heads, embed_dim // num_heads)
        n = self.grid * self.grid
        self.patch_embed_3d = Container(proj=nn.Conv3d(
            in_chans, d, (z_block_size, patch_size, patch_size),
            stride=(z_block_size, patch_size, patch_size), device=device))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        dpr = np.linspace(0.0, drop_path_rate, depth)
        if self.joint:
            self.st_embed = nn.Parameter(torch.zeros(1, temporal_resolution * n + 1, d,
                                                     device=device))
            self.blocks = nn.ModuleList([ViTBlock(d, num_heads, ln_eps, mlp_ratio, drop_rate,
                                                  float(dpr[i]), device=device)
                                         for i in range(depth)])
        else:
            self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, d, device=device))
            self.temp_embed = nn.Parameter(torch.zeros(1, temporal_resolution, d,
                                                       device=device))
            self.blocks = nn.ModuleList([DividedSpaceTimeBlock(d, num_heads, ln_eps, mlp_ratio,
                                                               float(dpr[i]), attn_impl,
                                                               drop_rate, device=device)
                                         for i in range(depth)])
        self.norm = LayerNorm(d, ln_eps, device)
        self.spatial_attn_agg = None
        if factorize_space_time and agg_space_module == "TransformerEncoderLayer":
            self.spatial_attn_agg = SpatialAggregator(d, num_heads, dropout=drop_rate,
                                                      device=device)
        elif factorize_space_time and agg_space_module == "AveragePooling":
            self.spatial_attn_agg = AveragePooling((2, 3))
        self.temp_attn_agg = tail
        self.pos_dropout = float(pos_dropout)
        self.max_segments = max_segments
        self.global_attn_agg = (
            TemporalAggregator(d, num_heads, dropout=drop_rate, add_pos_emb=True,
                               pos_max_len=max_segments if max_segments is not None else 16,
                               pos_emb_drop=pos_dropout, device=device)
            if add_global_repr else None)

    def forward(self, x: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, S, f, n, z*p*p*c) patch-major frames, or (B, S, T, H, W, C)
        frames: uint8 with the folded normalisation, or normalised floats in
        the compute dtype -> (B, S, f, D), or (B, S, D) with a time tail.
        ``deterministic=False`` runs the training block and needs
        ``generator`` for drop-path and dropout. ``keep_mask`` (B, S, T, H, W,
        C) content keep, with 6-D frames only."""
        return self.forward_with_global(x, impl, deterministic, generator, keep_mask)[0]

    def token_keep(self, keep_mask: torch.Tensor) -> torch.Tensor:
        """(B, S, T, H, W, C) content keep -> (B*S, 1 + f*n) token keep: the
        minimum over each patch window above 0.5, frame-major; CLS kept."""
        b, s = keep_mask.shape[:2]
        km = patchify_frames(keep_mask, self.z, self.patch_size)
        tok = km.float().amin(dim=-1).reshape(b * s, -1) > 0.5
        return torch.cat([torch.ones(b * s, 1, dtype=torch.bool, device=tok.device), tok], 1)

    def forward_with_global(self, x: torch.Tensor, impl: str = "plain",
                            deterministic: bool = True,
                            generator: Optional[torch.Generator] = None,
                            keep_mask: Optional[torch.Tensor] = None):
        """forward's features and, with add_global_repr, the (B, D) global
        feature (else None)."""
        if x.ndim == 6:
            x = patchify_frames(x, self.z, self.patch_size)
        elif keep_mask is not None:
            raise ValueError("keep_mask needs 6-D frames (B, S, T, H, W, C), as the JAX tower")
        b, s, f, n, pk = x.shape
        if (f, n) != (self.f, self.grid * self.grid):
            raise ValueError(f"patch-major input {tuple(x.shape)} does not match the tower")
        conv = self.patch_embed_3d.proj
        dtype = x.dtype if x.is_floating_point() else conv.weight.dtype
        d = conv.weight.shape[0]
        tokens = dense(x.reshape(b * s, f, n, pk), patch_embed_matrix(conv.weight),
                       conv.bias, dtype)
        tok_keep = None if keep_mask is None else self.token_keep(keep_mask)
        if not deterministic and generator is None:
            raise ValueError("training (deterministic=False) needs a generator")
        gen = None if deterministic else generator
        cls = self.cls_token.to(dtype).expand(b * s, 1, d)
        if self.joint:
            x = torch.cat([cls, tokens.reshape(b * s, f * n, d)], dim=1) + self.st_embed.to(dtype)
            if gen is not None:
                x = element_dropout(x, self.pos_dropout, gen)
            feats = self._joint_flow(x, gen, tok_keep)
        else:
            patch_pos = (self.pos_embed[:, None, 1:] + self.temp_embed[:, :, None]).to(dtype)
            patches = (tokens + patch_pos).contiguous()
            cls = cls + self.pos_embed[:, :1].to(dtype)
            if gen is not None:
                cls = element_dropout(cls, self.pos_dropout, gen)
                patches = element_dropout(patches, self.pos_dropout, gen)
            if self.packed or tok_keep is not None:
                feats = self._packed_flow(cls, patches, impl, deterministic, gen, tok_keep)
            elif deterministic and self.attn_impl == "pallas":
                stats = None
                for blk in self.blocks:
                    cls, patches, stats = blk(cls, patches, stats, impl)
                with trace.span("norm"):
                    feats = layer_norm_from_stats(patches, stats[..., 0:1], stats[..., 1:2],
                                                  self.norm.weight, self.norm.bias, self.eps,
                                                  dtype)
            else:
                for blk in self.blocks:
                    cls, patches = self._run_block(blk.forward_train, blk, deterministic, gen,
                                                   cls, patches, impl)
                feats = _normed(self.norm, patches)
        feats = feats.reshape(b * s, f, self.grid, self.grid, d)
        if self.spatial_attn_agg is None:
            return feats.reshape(b, s, *feats.shape[1:]), None
        feat_keep = (None if tok_keep is None
                     else tok_keep[:, 1:].reshape(b * s, f, self.grid, self.grid))
        feats = self.spatial_attn_agg(feats, impl, deterministic, gen, feat_keep)
        if self.temp_attn_agg is None:
            return feats.reshape(b, s, f, d), None
        feats = self.temp_attn_agg(feats, impl, deterministic, gen).reshape(b, s, d)
        if self.global_attn_agg is None:
            return feats, None
        return feats, self.global_attn_agg(feats, impl, deterministic, gen)

    def _run_block(self, fn, blk, deterministic: bool, generator, *args):
        """One block: ``fn(*args, None, None, None)`` in eval; in training its
        drop-path factors drawn first (space then MLP, as the JAX block draws
        them), then ``fn(*args, *scales, generator)``, under
        checkpoint_with_generator with remat."""
        if deterministic:
            return fn(*args, None, None, None)
        n = args[0].shape[0]
        scales = [blk.drop_path.draw(n, generator, args[0].device, args[0].dtype)
                  for _ in range(2)]
        if self.remat:
            return checkpoint_with_generator(fn, generator, *args, *scales)
        return fn(*args, *scales, generator)

    def _packed_flow(self, cls, patches, impl: str, deterministic: bool,
                     generator: Optional[torch.Generator],
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[CLS; patches] -> the blocks on the packed (B*S, 1 + f*n, D) layout,
        masked by ``keep`` (B*S, 1 + f*n) where given -> the final norm of the
        patch rows (B*S, f, n, D)."""
        bs, f, n, d = patches.shape
        x = torch.cat([cls, patches.reshape(bs, f * n, d)], dim=1)
        for blk in self.blocks:
            fn = functools.partial(blk.forward_packed, keep_mask=keep)
            x = self._run_block(fn, blk, deterministic, generator, x, f, impl)
        return _normed(self.norm, x[:, 1:]).reshape(bs, f, n, d)

    def _joint_flow(self, x, generator: Optional[torch.Generator],
                    keep: Optional[torch.Tensor]) -> torch.Tensor:
        """The joint blocks (plain pre-LN, every route) over x (B*S, 1 + f*n,
        D), masked by ``keep`` where given -> the final norm of the patch rows
        (B*S, f*n, D)."""
        for blk in self.blocks:
            if self.remat and generator is not None:
                x = checkpoint_with_generator(
                    lambda t, g, blk=blk: blk(t, "plain", generator=g, keep_mask=keep),
                    generator, x)
            else:
                x = blk(x, "plain", generator=generator, keep_mask=keep)
        return _normed(self.norm, x[:, 1:])
