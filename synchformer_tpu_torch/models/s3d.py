"""S3D video tower of the legacy SparseSync model (synchformer_tpu/models/
s3d.py; ref: model/modules/feat_extractors/visual/s3d.py), inference.

(B, S, T, H, W, C) frames -> (BS, C, T, H, W) -> the separable-3D-conv
Inception trunk (embed 1024): stem SepConv3d 7/2, max pool (1,3,3)/(1,2,2),
BasicConv3d 1x1x1, SepConv3d 3, max pool, the Mixed blocks of _MIXED_SPECS
with a (3,3,3)/2 max pool after 3c and a (2,2,2)/2 VALID one after 4f ->
(BS, t, h, w, 1024); 16 frames of 224² give (2, 7, 7). Every conv and pool
pads as flax's SAME (models/conv.py: asymmetric at stride 2, -inf for the
pools); BatchNorm eps 1e-3 in eval. Then, with ``factorize_space_time`` (the
default), the spatial pool ``agg_space_module`` names (a SpatialAggregator,
K4 on the kernel route, or 'AveragePooling' the mean over h, w) -> (B, S,
t, 1024), the time tail ``agg_time_module`` names (aggregators.time_tail)
and, with ``add_global_repr``, a TemporalAggregator over ``max_segments``
segments; without it the dense (B, S, t, h, w, 1024) map. Training is not
ported: ``deterministic=False`` raises (the running-statistics update of the
BatchNorms). State names as the JAX parameters (``stem_sep.{conv_s, bn_s,
conv_t, bn_t}``, ``stem_1x1.{conv, bn}``, ``stem_sep2``,
``mixed_{i}.{branch0, branch1_0, branch1_1, branch2_0, branch2_1,
branch3}``, ``spatial_attn_agg``, ``temp_attn_agg``, ``global_attn_agg``);
the BatchNorms' running statistics are buffers. ``embed_dim`` and
``drop_rate`` are accepted as the JAX tower takes them: the width is the
trunk's 1024, and the aggregators' dropout is live only in training.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synchformer_tpu_torch.models.aggregators import (
    AveragePooling,
    SpatialAggregator,
    TemporalAggregator,
    time_tail,
)
from synchformer_tpu_torch.models.conv import NOT_TRAINED, BatchNorm, Conv, max_pool_same

BN_EPS = 1e-3
D = 1024

# (b0, (b1a, b1b), (b2a, b2b), b3) per Mixed block: the S3D topology
# (synchformer_tpu/models/s3d.py:81-93)
_MIXED_SPECS = [
    (64, (96, 128), (16, 32), 32),       # 3b  -> 256
    (128, (128, 192), (32, 96), 64),     # 3c  -> 480
    "pool",
    (192, (96, 208), (16, 48), 64),      # 4b  -> 512
    (160, (112, 224), (24, 64), 64),     # 4c  -> 512
    (128, (128, 256), (24, 64), 64),     # 4d  -> 512
    (112, (144, 288), (32, 64), 64),     # 4e  -> 528
    (256, (160, 320), (32, 128), 128),   # 4f  -> 832
    "pool2",
    (256, (160, 320), (32, 128), 128),   # 5b  -> 832
    (384, (192, 384), (48, 128), 128),   # 5c  -> 1024
]


class BasicConv3d(nn.Module):
    """conv (no bias) + BN + ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: Sequence[int],
                 strides: Sequence[int] = (1, 1, 1), device=None):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel, strides, bias=False, device=device)
        self.bn = BatchNorm(features, BN_EPS, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x), relu=True)


class SepConv3d(nn.Module):
    """(1, k, k) conv + BN + ReLU, then (k, 1, 1) conv + BN + ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: int, strides: int = 1, device=None):
        super().__init__()
        k, s = kernel, strides
        self.conv_s = Conv(in_ch, features, (1, k, k), (1, s, s), bias=False, device=device)
        self.bn_s = BatchNorm(features, BN_EPS, device)
        self.conv_t = Conv(features, features, (k, 1, 1), (s, 1, 1), bias=False, device=device)
        self.bn_t = BatchNorm(features, BN_EPS, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn_s(self.conv_s(x), relu=True)
        return self.bn_t(self.conv_t(x), relu=True)


class InceptionMixed(nn.Module):
    """Four branches, concatenated on channels: 1x1 | 1x1 -> sep 3 | 1x1 ->
    sep 3 | max pool 3x3x3 -> 1x1."""

    def __init__(self, in_ch: int, b0: int, b1: Tuple[int, int], b2: Tuple[int, int], b3: int,
                 device=None):
        super().__init__()
        self.out_channels = b0 + b1[1] + b2[1] + b3
        self.branch0 = BasicConv3d(in_ch, b0, (1, 1, 1), device=device)
        self.branch1_0 = BasicConv3d(in_ch, b1[0], (1, 1, 1), device=device)
        self.branch1_1 = SepConv3d(b1[0], b1[1], 3, device=device)
        self.branch2_0 = BasicConv3d(in_ch, b2[0], (1, 1, 1), device=device)
        self.branch2_1 = SepConv3d(b2[0], b2[1], 3, device=device)
        self.branch3 = BasicConv3d(in_ch, b3, (1, 1, 1), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y0 = self.branch0(x)
        y1 = self.branch1_1(self.branch1_0(x))
        y2 = self.branch2_1(self.branch2_0(x))
        y3 = self.branch3(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([y0, y1, y2, y3], dim=1)


class S3DVisualFeatures(nn.Module):
    def __init__(self, embed_dim: int = D, num_heads: int = 8, drop_rate: float = 0.0,
                 factorize_space_time: bool = True,
                 agg_space_module: str = "TransformerEncoderLayer",
                 agg_time_module: str = "Identity", add_global_repr: bool = False,
                 max_segments: Optional[int] = None, device=None):
        super().__init__()
        if agg_space_module not in ("TransformerEncoderLayer", "AveragePooling"):
            raise ValueError(f"agg_space_module must be 'TransformerEncoderLayer' or "
                             f"'AveragePooling', got {agg_space_module!r}")
        self.embed_dim = D
        self.stem_sep = SepConv3d(3, 64, 7, strides=2, device=device)
        self.stem_1x1 = BasicConv3d(64, 64, (1, 1, 1), device=device)
        self.stem_sep2 = SepConv3d(64, 192, 3, device=device)
        self.mixed = []  # the trunk's order after the stem: Mixed block names and pools
        ch, i = 192, 0
        for spec in _MIXED_SPECS:
            if isinstance(spec, str):
                self.mixed.append(spec)
                continue
            block = InceptionMixed(ch, *spec, device=device)
            self.add_module(f"mixed_{i}", block)
            self.mixed.append(f"mixed_{i}")
            ch, i = block.out_channels, i + 1
        self.factorize_space_time = factorize_space_time
        tail = time_tail(agg_time_module, D, num_heads, device) if factorize_space_time else None
        if add_global_repr and tail is None:
            raise ValueError("add_global_repr pools (B, S, D) segment features: it needs "
                             "factorize_space_time and agg_time_module 'AveragePooling' or "
                             "'TransformerEncoderLayer'")
        self.spatial_attn_agg = None
        if factorize_space_time:
            self.spatial_attn_agg = (SpatialAggregator(D, num_heads, device=device)
                                     if agg_space_module == "TransformerEncoderLayer"
                                     else AveragePooling((2, 3)))
        self.temp_attn_agg = tail
        self.global_attn_agg = (
            TemporalAggregator(D, num_heads, add_pos_emb=True,
                               pos_max_len=max_segments if max_segments is not None else 16,
                               device=device)
            if add_global_repr else None)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(BS, 3, T, H, W) -> (BS, 1024, t, h, w)."""
        y = self.stem_sep(x)
        y = max_pool_same(y, (1, 3, 3), (1, 2, 2))
        y = self.stem_sep2(self.stem_1x1(y))
        y = max_pool_same(y, (1, 3, 3), (1, 2, 2))
        for name in self.mixed:
            if name == "pool":
                y = max_pool_same(y, (3, 3, 3), (2, 2, 2))
            elif name == "pool2":
                y = F.max_pool3d(y, 2, 2)  # flax VALID
            else:
                y = getattr(self, name)(y)
        return y

    def forward(self, x: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, S, T, H, W, C) normalised frames in the compute dtype -> (B,
        S, t, D), (B, S, D) with a time tail, or (B, S, t, h, w, D)
        unfactorized. ``generator`` is unused: no dropout of inference is
        live."""
        return self.forward_with_global(x, impl, deterministic)[0]

    def forward_with_global(self, x: torch.Tensor, impl: str = "plain",
                            deterministic: bool = True):
        if not deterministic:
            raise NotImplementedError(NOT_TRAINED)
        b, s = x.shape[:2]
        y = self.trunk(x.reshape(b * s, *x.shape[2:]).permute(0, 4, 1, 2, 3))
        y = y.permute(0, 2, 3, 4, 1)  # (BS, t, h, w, D)
        if not self.factorize_space_time:
            return y.reshape(b, s, *y.shape[1:]), None
        y = self.spatial_attn_agg(y, impl)
        if self.temp_attn_agg is not None:
            y = self.temp_attn_agg(y, impl)
        y = y.reshape(b, s, *y.shape[1:])
        if self.global_attn_agg is None:
            return y, None
        return y, self.global_attn_agg(y, impl)
