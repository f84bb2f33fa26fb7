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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    element_dropout,
    mlp,
)
from synchformer_tpu_torch.ops.kernels.divided_attention import (
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
)
from synchformer_tpu_torch.ops.numerics import dense, layer_norm, layer_norm_from_stats
from synchformer_tpu_torch.ops.video import patch_embed_matrix


class DividedAttention(nn.Module):
    def __init__(self, d: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
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

    def attend(self, ln_cls, ln_patches, mode: str, impl: str):
        """Training: LN'd (cls, patches) -> projected attention (cls, patches),
        differentiable (K5 forward, K6 backward on the kernel route)."""
        qkv_c = self.qkv(ln_cls)
        qkv_p = self.qkv(ln_patches)
        out_p, out_c = divided_attention_split(qkv_p, qkv_c, self.num_heads, mode, impl=impl)
        return self.proj(out_c), self.proj(out_p)

    def attend_packed(self, x, norm: LayerNorm, num_frames: int, mode: str, impl: str,
                      attn_impl: str):
        """Packed flow, eval and training: the block's x (B, 1 + f*n, D) and
        this attention's pre-norm -> projected attention, differentiable. On
        the kernel route 'pallas' runs LN -> QKV -> K7a/K7b, 'pallas_fused'
        K8a; the backward is K7c on both."""
        if attn_impl == "pallas_fused":
            out = fused_divided_attention(x, norm.weight, norm.bias, self.qkv.weight.to(x.dtype),
                                          self.qkv.bias, self.num_heads, num_frames, mode,
                                          norm.eps, impl=impl)
        else:
            out = packed_divided_attention(self.qkv(norm(x)), self.num_heads, num_frames, mode,
                                           impl=impl)
        return self.proj(out)


class DividedSpaceTimeBlock(nn.Module):
    def __init__(self, d: int, num_heads: int, eps: float = 1e-6, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, attn_impl: str = "pallas", device=None):
        super().__init__()
        self.eps = eps
        self.attn_impl = attn_impl
        hidden = int(d * mlp_ratio)
        self.norm1 = LayerNorm(d, eps, device)
        self.norm2 = LayerNorm(d, eps, device)
        self.norm3 = LayerNorm(d, eps, device)
        self.attn = DividedAttention(d, num_heads, device)
        self.timeattn = DividedAttention(d, num_heads, device)
        self.mlp = Container(fc1=Linear(d, hidden, device=device),
                             fc2=Linear(hidden, d, device=device))
        self.drop_path = DropPath(drop_path)

    def _ln_patches(self, norm: LayerNorm, patches, stats):
        if stats is None:
            return norm(patches)
        return layer_norm_from_stats(patches, stats[..., 0:1], stats[..., 1:2],
                                     norm.weight, norm.bias, self.eps, patches.dtype)

    def _mlp_args(self, dtype):
        return (self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight.to(dtype),
                self.mlp.fc1.bias, self.mlp.fc2.weight.to(dtype), self.mlp.fc2.bias, self.eps)

    def forward(self, cls, patches, stats, impl: str):
        """Eval: (cls (BS, 1, D), patches (BS, f, n, D), row stats of patches
        or None) -> (cls, patches, stats of the new patches)."""
        cls, patches = self.timeattn(cls, patches, self.norm3(cls),
                                     self._ln_patches(self.norm3, patches, stats), "time", impl)
        cls, patches = self.attn(cls, patches, self.norm1(cls), self.norm1(patches),
                                 "space", impl)
        mlp_args = self._mlp_args(patches.dtype)
        patches, stats = fused_ln_mlp_residual(patches, *mlp_args, emit_stats=True, impl=impl)
        cls = ln_mlp_residual_plain(cls, *mlp_args)
        return cls, patches, stats

    def forward_train(self, cls, patches, impl: str, space_scale: Optional[torch.Tensor],
                      mlp_scale: Optional[torch.Tensor]):
        """Training, and eval under 'pallas_fused': (cls, patches) -> (cls,
        patches). ``space_scale`` and ``mlp_scale`` are this block's drop-path
        factors (DropPath.draw), both None at drop-path 0 and in eval."""
        t_c, t_p = self.timeattn.attend(self.norm3(cls), self.norm3(patches), "time", impl)
        cls, patches = cls + t_c, patches + t_p
        s_c, s_p = self.attn.attend(self.norm1(cls), self.norm1(patches), "space", impl)
        cls = cls + DropPath.drop(s_c, space_scale)
        patches = patches + DropPath.drop(s_p, space_scale)
        mlp_args = self._mlp_args(patches.dtype)
        if mlp_scale is None:  # not stochastic: the patches' MLP is K2
            patches = fused_ln_mlp_residual(patches, *mlp_args, impl=impl)
            return ln_mlp_residual_plain(cls, *mlp_args), patches
        return (cls + DropPath.drop(self._mlp_plain(cls), mlp_scale),
                patches + DropPath.drop(self._mlp_plain(patches), mlp_scale))

    def _mlp_plain(self, t):
        return mlp(layer_norm(t, self.norm2.weight, self.norm2.bias, self.eps, t.dtype),
                   self.mlp.fc1.weight, self.mlp.fc1.bias, self.mlp.fc2.weight,
                   self.mlp.fc2.bias)

    def forward_packed(self, x, num_frames: int, impl: str,
                       space_scale: Optional[torch.Tensor], mlp_scale: Optional[torch.Tensor]):
        """Packed flow, eval and training: x (B, 1 + f*n, D) -> x. The scales
        are this block's drop-path factors (DropPath.draw); both None in eval
        and at drop-path 0, where the MLP is K2 ('pallas') or K8b
        ('pallas_fused') on the whole packed x."""
        x = x + self.timeattn.attend_packed(x, self.norm3, num_frames, "time", impl,
                                            self.attn_impl)
        x = x + DropPath.drop(self.attn.attend_packed(x, self.norm1, num_frames, "space", impl,
                                                      self.attn_impl), space_scale)
        if mlp_scale is None:  # not stochastic
            mlp = fused_mlp_residual if self.attn_impl == "pallas_fused" else fused_ln_mlp_residual
            return mlp(x, *self._mlp_args(x.dtype), impl=impl)
        return x + DropPath.drop(self._mlp_plain(x), mlp_scale)


class MotionFormerEncoder(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, z_block_size: int = 2, temporal_resolution: int = 8,
                 img_size: int = 224, in_chans: int = 3, ln_eps: float = 1e-6,
                 drop_path_rate: float = 0.2,
                 agg_space_module: str = "TransformerEncoderLayer",
                 agg_time_module: str = "Identity",
                 remat: bool = False, attn_impl: str = "pallas", pos_dropout: float = 0.0,
                 add_global_repr: bool = False, max_segments: Optional[int] = None,
                 device=None):
        super().__init__()
        if agg_space_module not in ("TransformerEncoderLayer", "AveragePooling"):
            raise ValueError(f"agg_space_module must be 'TransformerEncoderLayer' or "
                             f"'AveragePooling', got {agg_space_module!r}")
        tail = time_tail(agg_time_module, embed_dim, num_heads, device)
        if add_global_repr and tail is None:
            raise ValueError("add_global_repr pools (B, S, D) segment features: it needs "
                             "agg_time_module 'AveragePooling' or 'TransformerEncoderLayer'")
        if attn_impl not in ("pallas", "pallas_fused"):
            raise ValueError(f"attn_impl must be 'pallas' or 'pallas_fused', got {attn_impl!r}")
        d = embed_dim
        self.eps = ln_eps
        self.f = temporal_resolution
        self.grid = img_size // patch_size
        self.remat = remat
        self.attn_impl = attn_impl
        self.packed = not heads_groupable(num_heads, embed_dim // num_heads)
        n = self.grid * self.grid
        self.patch_embed_3d = Container(proj=nn.Conv3d(
            in_chans, d, (z_block_size, patch_size, patch_size),
            stride=(z_block_size, patch_size, patch_size), device=device))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, d, device=device))
        self.temp_embed = nn.Parameter(torch.zeros(1, temporal_resolution, d, device=device))
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.blocks = nn.ModuleList([DividedSpaceTimeBlock(d, num_heads, ln_eps,
                                                           drop_path=float(dpr[i]),
                                                           attn_impl=attn_impl, device=device)
                                     for i in range(depth)])
        self.norm = LayerNorm(d, ln_eps, device)
        self.spatial_attn_agg = (SpatialAggregator(d, num_heads, device=device)
                                 if agg_space_module == "TransformerEncoderLayer"
                                 else AveragePooling((2, 3)))
        self.temp_attn_agg = tail
        self.pos_dropout = float(pos_dropout)
        self.max_segments = max_segments
        self.global_attn_agg = (
            TemporalAggregator(d, num_heads, add_pos_emb=True,
                               pos_max_len=max_segments if max_segments is not None else 16,
                               pos_emb_drop=pos_dropout, device=device)
            if add_global_repr else None)

    def forward(self, x: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, S, f, n, z*p*p*c) patch-major frames: uint8 with the folded
        normalisation, or normalised floats in the compute dtype -> (B, S, f, D),
        or (B, S, D) with a time tail. ``deterministic=False``
        runs the training block and needs ``generator`` for drop-path and
        dropout."""
        return self.forward_with_global(x, impl, deterministic, generator)[0]

    def forward_with_global(self, x: torch.Tensor, impl: str = "plain",
                            deterministic: bool = True,
                            generator: Optional[torch.Generator] = None):
        """forward's features and, with add_global_repr, the (B, D) global
        feature (else None)."""
        b, s, f, n, pk = x.shape
        if (f, n) != (self.f, self.grid * self.grid):
            raise ValueError(f"patch-major input {tuple(x.shape)} does not match the tower")
        conv = self.patch_embed_3d.proj
        dtype = x.dtype if x.is_floating_point() else conv.weight.dtype
        d = conv.weight.shape[0]
        tokens = dense(x.reshape(b * s, f, n, pk), patch_embed_matrix(conv.weight),
                       conv.bias, dtype)
        patch_pos = (self.pos_embed[:, None, 1:] + self.temp_embed[:, :, None]).to(dtype)
        patches = (tokens + patch_pos).contiguous()
        cls = self.cls_token.to(dtype).expand(b * s, 1, d) + self.pos_embed[:, :1].to(dtype)
        if not deterministic and generator is None:
            raise ValueError("training (deterministic=False) needs a generator")
        if not deterministic:
            cls = element_dropout(cls, self.pos_dropout, generator)
            patches = element_dropout(patches, self.pos_dropout, generator)
        if self.packed:
            feats = self._packed_flow(cls, patches, impl, deterministic, generator)
        elif deterministic and self.attn_impl == "pallas":
            stats = None
            for blk in self.blocks:
                cls, patches, stats = blk(cls, patches, stats, impl)
            feats = layer_norm_from_stats(patches, stats[..., 0:1], stats[..., 1:2],
                                          self.norm.weight, self.norm.bias, self.eps, dtype)
        else:
            for blk in self.blocks:
                cls, patches = self._run_block(blk.forward_train, blk, deterministic, generator,
                                               cls, patches, impl)
            feats = self.norm(patches)
        feats = feats.reshape(b * s, f, self.grid, self.grid, d)
        feats = self.spatial_attn_agg(feats, impl)
        if self.temp_attn_agg is None:
            return feats.reshape(b, s, f, d), None
        feats = self.temp_attn_agg(feats, impl).reshape(b, s, d)
        if self.global_attn_agg is None:
            return feats, None
        return feats, self.global_attn_agg(feats, impl, deterministic, generator)

    def _run_block(self, fn, blk, deterministic: bool, generator, *args):
        """One block: ``fn(*args, None, None)`` in eval; in training its
        drop-path factors drawn first (space then MLP, as the JAX block draws
        them), then ``fn(*args, *scales)``, under torch.utils.checkpoint with
        remat."""
        if deterministic:
            return fn(*args, None, None)
        n = args[0].shape[0]
        scales = [blk.drop_path.draw(n, generator, args[0].device, args[0].dtype)
                  for _ in range(2)]
        if self.remat:
            return checkpoint(fn, *args, *scales, use_reentrant=False)
        return fn(*args, *scales)

    def _packed_flow(self, cls, patches, impl: str, deterministic: bool,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """[CLS; patches] -> the blocks on the packed (B*S, 1 + f*n, D) layout
        -> the final norm of the patch rows (B*S, f, n, D)."""
        bs, f, n, d = patches.shape
        x = torch.cat([cls, patches.reshape(bs, f * n, d)], dim=1)
        for blk in self.blocks:
            x = self._run_block(blk.forward_packed, blk, deterministic, generator, x, f, impl)
        return self.norm(x[:, 1:]).reshape(bs, f, n, d)
