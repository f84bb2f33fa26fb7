"""Motionformer video tower (synchformer_tpu/models/motionformer.py) on 5-D
patch-major input, split (CLS, patches) flow only.

Eval (``deterministic=True``), per block, as the JAX package's deterministic
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

Then the SpatialAggregator (K4) pools each frame, and with
``agg_time_module='AveragePooling'`` the frames are averaged. State names
follow the reference (``patch_embed_3d.proj``,
``blocks.{i}.{norm1,norm2,norm3,attn,timeattn,mlp}``, ``norm``,
``spatial_attn_agg``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from synchformer_tpu_torch.models.aggregators import AveragePooling, SpatialAggregator
from synchformer_tpu_torch.models.layers import Container, DropPath, LayerNorm, Linear, mlp
from synchformer_tpu_torch.ops.kernels.divided_attention import divided_attention_proj
from synchformer_tpu_torch.ops.kernels.divided_attention_bwd import divided_attention_split
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


class DividedSpaceTimeBlock(nn.Module):
    def __init__(self, d: int, num_heads: int, eps: float = 1e-6, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, device=None):
        super().__init__()
        self.eps = eps
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
        """Training: (cls, patches) -> (cls, patches). ``space_scale`` and
        ``mlp_scale`` are this block's drop-path factors (DropPath.draw), or
        None at drop-path 0."""
        t_c, t_p = self.timeattn.attend(self.norm3(cls), self.norm3(patches), "time", impl)
        cls, patches = cls + t_c, patches + t_p
        s_c, s_p = self.attn.attend(self.norm1(cls), self.norm1(patches), "space", impl)
        cls = cls + DropPath.drop(s_c, space_scale)
        patches = patches + DropPath.drop(s_p, space_scale)
        mlp_args = self._mlp_args(patches.dtype)
        if self.drop_path.rate == 0.0:  # not stochastic: the patches' MLP is K2
            patches = fused_ln_mlp_residual(patches, *mlp_args, impl=impl)
            return ln_mlp_residual_plain(cls, *mlp_args), patches

        def mlp_part(t):
            return mlp(layer_norm(t, self.norm2.weight, self.norm2.bias, self.eps, t.dtype),
                       self.mlp.fc1.weight, self.mlp.fc1.bias, self.mlp.fc2.weight,
                       self.mlp.fc2.bias)

        return (cls + DropPath.drop(mlp_part(cls), mlp_scale),
                patches + DropPath.drop(mlp_part(patches), mlp_scale))


class MotionFormerEncoder(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, z_block_size: int = 2, temporal_resolution: int = 8,
                 img_size: int = 224, in_chans: int = 3, ln_eps: float = 1e-6,
                 drop_path_rate: float = 0.2, agg_time_module: str = "Identity",
                 remat: bool = False, device=None):
        super().__init__()
        if agg_time_module not in ("Identity", "AveragePooling"):
            raise ValueError(f"agg_time_module must be 'Identity' or 'AveragePooling', "
                             f"got {agg_time_module!r}")
        d = embed_dim
        self.eps = ln_eps
        self.f = temporal_resolution
        self.grid = img_size // patch_size
        self.remat = remat
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
                                                           device=device)
                                     for i in range(depth)])
        self.norm = LayerNorm(d, ln_eps, device)
        self.spatial_attn_agg = SpatialAggregator(d, num_heads, device=device)
        self.temp_attn_agg = (AveragePooling(1) if agg_time_module == "AveragePooling"
                              else None)

    def forward(self, x: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, S, f, n, z*p*p*c) patch-major frames: uint8 with the folded
        normalisation, or normalised floats in the compute dtype -> (B, S, f, D),
        or (B, S, D) with the AveragePooling time tail. ``deterministic=False``
        runs the training block and needs ``generator`` for drop-path."""
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
        if deterministic:
            stats = None
            for blk in self.blocks:
                cls, patches, stats = blk(cls, patches, stats, impl)
            feats = layer_norm_from_stats(patches, stats[..., 0:1], stats[..., 1:2],
                                          self.norm.weight, self.norm.bias, self.eps, dtype)
        else:
            if generator is None:
                raise ValueError("training (deterministic=False) needs a generator")
            for blk in self.blocks:
                # space then MLP, as the JAX block draws them
                scales = [blk.drop_path.draw(b * s, generator, x.device, dtype)
                          for _ in range(2)]
                if self.remat:
                    cls, patches = checkpoint(blk.forward_train, cls, patches, impl, *scales,
                                              use_reentrant=False)
                else:
                    cls, patches = blk.forward_train(cls, patches, impl, *scales)
            feats = self.norm(patches)
        feats = feats.reshape(b * s, f, self.grid, self.grid, d)
        feats = self.spatial_attn_agg(feats, impl)
        if self.temp_attn_agg is not None:
            return self.temp_attn_agg(feats).reshape(b, s, d)
        return feats.reshape(b, s, f, d)
