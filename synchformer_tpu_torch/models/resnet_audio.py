"""ResNet-18 audio tower of the legacy SparseSync model
(synchformer_tpu/models/resnet_audio.py; ref:
model/modules/feat_extractors/audio/resnet.py), inference.

(B, S, T, F) log-mel -> (BS, 1, F, T), frequency as height -> conv1 7x7/2,
BN, ReLU, max pool 3x3/2 -> four stages of two BasicBlocks (64, 128, 256,
512; the first block of stages 2-4 at stride 2 with a 1x1 conv + BN on its
residual) -> (BS, f', t', 512), (4, 3) at 128 x 66. Every conv and pool pads
as flax's SAME (models/conv.py: asymmetric at stride 2); BatchNorm eps 1e-5
in eval. Then, with ``factorize_freq_time`` (the default), the frequency pool
``agg_freq_module`` names (a FrequencyAggregator, K4 on the kernel route, or
'AveragePooling' the mean) -> (B, S, t', 512), the time tail
``agg_time_module`` names (aggregators.time_tail) and, with
``add_global_repr``, a TemporalAggregator over ``max_segments`` segments;
without it the (B, S, f', t', 512) map. Training is not ported:
``deterministic=False`` raises (the running-statistics update of the
BatchNorms). State names as the JAX parameters: ``conv1``, ``bn1``,
``layer{stage}_{block}.{conv1,bn1,conv2,bn2,downsample_conv,downsample_bn}``,
``freq_attn_agg``, ``temp_attn_agg``, ``global_attn_agg``; the BatchNorms'
running statistics are buffers. ``embed_dim`` and ``drop_rate`` are
accepted as the JAX tower takes them: the width follows ``stage_sizes``
(512 for four stages), and the aggregators' dropout is live only in
training.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from synchformer_tpu_torch.models.aggregators import (
    AveragePooling,
    FrequencyAggregator,
    TemporalAggregator,
    time_tail,
)
from synchformer_tpu_torch.models.conv import NOT_TRAINED, BatchNorm, Conv, max_pool_same

BN_EPS = 1e-5


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, strides: int = 1, device=None):
        super().__init__()
        s = (strides, strides)
        self.conv1 = Conv(in_features, features, (3, 3), s, bias=False, device=device)
        self.bn1 = BatchNorm(features, BN_EPS, device)
        self.conv2 = Conv(features, features, (3, 3), bias=False, device=device)
        self.bn2 = BatchNorm(features, BN_EPS, device, closes_residual=True)
        if strides != 1 or in_features != features:
            self.downsample_conv = Conv(in_features, features, (1, 1), s, bias=False,
                                        device=device)
            self.downsample_bn = BatchNorm(features, BN_EPS, device, closes_residual=True)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(self.bn1(self.conv1(x), relu=True)))
        res = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + res)


class ResNet18AudioFeatures(nn.Module):
    def __init__(self, embed_dim: int = 512, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 num_heads: int = 8, drop_rate: float = 0.0, factorize_freq_time: bool = True,
                 agg_freq_module: str = "TransformerEncoderLayer",
                 agg_time_module: str = "Identity", add_global_repr: bool = False,
                 max_segments: Optional[int] = None, device=None):
        super().__init__()
        if agg_freq_module not in ("TransformerEncoderLayer", "AveragePooling"):
            raise ValueError(f"agg_freq_module must be 'TransformerEncoderLayer' or "
                             f"'AveragePooling', got {agg_freq_module!r}")
        d = 64 * 2 ** (len(stage_sizes) - 1)
        self.embed_dim = d
        self.conv1 = Conv(1, 64, (7, 7), (2, 2), bias=False, device=device)
        self.bn1 = BatchNorm(64, BN_EPS, device)
        features = 64
        self.layers = []
        for stage, n_blocks in enumerate(stage_sizes):
            out = 64 * 2 ** stage
            for blk in range(n_blocks):
                name = f"layer{stage + 1}_{blk}"
                self.add_module(name, BasicBlock(features, out, 2 if stage > 0 and blk == 0 else 1,
                                                 device))
                self.layers.append(name)
                features = out
        self.factorize_freq_time = factorize_freq_time
        tail = time_tail(agg_time_module, d, num_heads, device) if factorize_freq_time else None
        if add_global_repr and tail is None:
            raise ValueError("add_global_repr pools (B, S, D) segment features: it needs "
                             "factorize_freq_time and agg_time_module 'AveragePooling' or "
                             "'TransformerEncoderLayer'")
        self.freq_attn_agg = None
        if factorize_freq_time:
            self.freq_attn_agg = (FrequencyAggregator(d, num_heads, device=device)
                                  if agg_freq_module == "TransformerEncoderLayer"
                                  else AveragePooling(1))
        self.temp_attn_agg = tail
        self.global_attn_agg = (
            TemporalAggregator(d, num_heads, add_pos_emb=True,
                               pos_max_len=max_segments if max_segments is not None else 16,
                               device=device)
            if add_global_repr else None)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(BS, 1, F, T) -> (BS, 512, f', t')."""
        y = self.bn1(self.conv1(x), relu=True)
        y = max_pool_same(y, (3, 3), (2, 2))
        for name in self.layers:
            y = getattr(self, name)(y)
        return y

    def forward(self, x: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, S, T, F) log-mel in the compute dtype -> (B, S, t', D), (B,
        S, D) with a time tail, or (B, S, f', t', D) unfactorized.
        ``generator`` is unused: no dropout of inference is live."""
        return self.forward_with_global(x, impl, deterministic)[0]

    def forward_with_global(self, x: torch.Tensor, impl: str = "plain",
                            deterministic: bool = True):
        if not deterministic:
            raise NotImplementedError(NOT_TRAINED)
        b, s, t_spec, f_spec = x.shape
        y = self.trunk(x.reshape(b * s, t_spec, f_spec).transpose(1, 2).unsqueeze(1))
        y = y.permute(0, 2, 3, 1)  # (BS, f', t', D)
        if not self.factorize_freq_time:
            return y.reshape(b, s, *y.shape[1:]), None
        y = self.freq_attn_agg(y, impl)
        if self.temp_attn_agg is not None:
            y = self.temp_attn_agg(y, impl)
        y = y.reshape(b, s, *y.shape[1:])
        if self.global_attn_agg is None:
            return y, None
        return y, self.global_attn_agg(y, impl)
