"""Motionformer video tower (synchformer_tpu/models/motionformer.py), eval
path on 5-D patch-major input, split (CLS, patches) flow only.

Per block, as the JAX package's deterministic kernel path runs it
(motionformer.py:494-516, 548-610):
- time attention on norm3 (LN of the patches from the previous block's row
  statistics), then space attention on norm1, each through K1 with the
  projection + residual in its epilogue; the CLS row's projection and residual
  run outside the kernel;
- norm2 + MLP + residual on the patches through K2, which also emits the row
  statistics for the next norm3; the CLS row's MLP runs as the plain
  composition.
The final norm also applies the statistics, then the SpatialAggregator (K4)
pools each frame. State names follow the reference (``patch_embed_3d.proj``,
``blocks.{i}.{norm1,norm2,norm3,attn,timeattn,mlp}``, ``norm``,
``spatial_attn_agg``).
"""
from __future__ import annotations

import torch
from torch import nn

from synchformer_tpu_torch.models.aggregators import SpatialAggregator
from synchformer_tpu_torch.models.layers import Container, LayerNorm, Linear
from synchformer_tpu_torch.ops.kernels.divided_attention import divided_attention_proj
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
        """Residual inputs (cls, patches) and their LN'd versions -> the
        post-residual (cls, patches)."""
        dtype = patches.dtype
        qkv_c = self.qkv(ln_cls)
        qkv_p = self.qkv(ln_patches)
        y_p, attn_c = divided_attention_proj(qkv_p, qkv_c, patches, self.proj.weight,
                                             self.proj.bias, self.num_heads, mode, impl=impl)
        proj_c = torch.matmul(attn_c.float(), self.proj.weight.float().t()) + self.proj.bias.float()
        return cls + proj_c.to(dtype), y_p


class DividedSpaceTimeBlock(nn.Module):
    def __init__(self, d: int, num_heads: int, eps: float = 1e-6, mlp_ratio: float = 4.0,
                 device=None):
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

    def _ln_patches(self, norm: LayerNorm, patches, stats):
        if stats is None:
            return norm(patches)
        return layer_norm_from_stats(patches, stats[..., 0:1], stats[..., 1:2],
                                     norm.weight, norm.bias, self.eps, patches.dtype)

    def forward(self, cls, patches, stats, impl: str):
        """(cls (BS, 1, D), patches (BS, f, n, D), row stats of patches or
        None) -> (cls, patches, stats of the new patches)."""
        cls, patches = self.timeattn(cls, patches, self.norm3(cls),
                                     self._ln_patches(self.norm3, patches, stats), "time", impl)
        cls, patches = self.attn(cls, patches, self.norm1(cls), self.norm1(patches),
                                 "space", impl)
        mlp_args = (self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                    self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias, self.eps)
        patches, stats = fused_ln_mlp_residual(patches, *mlp_args, emit_stats=True, impl=impl)
        cls = ln_mlp_residual_plain(cls, *mlp_args)
        return cls, patches, stats


class MotionFormerEncoder(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, z_block_size: int = 2, temporal_resolution: int = 8,
                 img_size: int = 224, in_chans: int = 3, ln_eps: float = 1e-6, device=None):
        super().__init__()
        d = embed_dim
        self.eps = ln_eps
        self.f = temporal_resolution
        self.grid = img_size // patch_size
        n = self.grid * self.grid
        self.patch_embed_3d = Container(proj=nn.Conv3d(
            in_chans, d, (z_block_size, patch_size, patch_size),
            stride=(z_block_size, patch_size, patch_size), device=device))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, d, device=device))
        self.temp_embed = nn.Parameter(torch.zeros(1, temporal_resolution, d, device=device))
        self.blocks = nn.ModuleList([DividedSpaceTimeBlock(d, num_heads, ln_eps, device=device)
                                     for _ in range(depth)])
        self.norm = LayerNorm(d, ln_eps, device)
        self.spatial_attn_agg = SpatialAggregator(d, num_heads, device=device)

    def forward(self, x: torch.Tensor, impl: str = "plain") -> torch.Tensor:
        """x (B, S, f, n, z*p*p*c) patch-major frames (uint8 with the folded
        normalisation, or float) -> (B, S, f, D)."""
        b, s, f, n, pk = x.shape
        if (f, n) != (self.f, self.grid * self.grid):
            raise ValueError(f"patch-major input {tuple(x.shape)} does not match the tower")
        conv = self.patch_embed_3d.proj
        dtype = conv.weight.dtype
        d = conv.weight.shape[0]
        tokens = dense(x.reshape(b * s, f, n, pk), patch_embed_matrix(conv.weight),
                       conv.bias, dtype)
        patch_pos = (self.pos_embed[:, None, 1:] + self.temp_embed[:, :, None]).to(dtype)
        patches = (tokens + patch_pos).contiguous()
        cls = self.cls_token.to(dtype).expand(b * s, 1, d) + self.pos_embed[:, :1].to(dtype)
        stats = None
        for blk in self.blocks:
            cls, patches, stats = blk(cls, patches, stats, impl)
        feats = layer_norm_from_stats(patches, stats[..., 0:1], stats[..., 1:2],
                                      self.norm.weight, self.norm.bias, self.eps, dtype)
        feats = feats.reshape(b * s, f, self.grid, self.grid, d)
        return self.spatial_attn_agg(feats, impl).reshape(b, s, f, d)
