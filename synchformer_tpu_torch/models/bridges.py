"""Projection bridges (synchformer_tpu/models/bridges.py; ref:
model/modules/bridges.py).

LinearBridge, which the reference configs name ``torch.nn.Linear`` (the sync
model's audio and video projections and the offset head), DoNothingBridge,
the identity of the Stage I configuration and of the configs'
``torch.nn.Identity``; ``AppendZerosToHidden``; the legacy SparseSync
bridges over the S3D / ResNet-18 feature maps, in the JAX layouts: visual
(B, T, D, h, w) and audio (B, D, f, t), channels at axis 2 / axis 1 —
``ConvBridgeVisual`` / ``ConvBridgeAudio`` (a conv with flax's SAME padding
and bias, then exact GELU), ``AvgPoolBridgeVisual`` / ``AvgPoolBridgeAudio``
(VALID average pools), and the AVCLIP heads ``SpatialpoolConvTemporalpool``
/ ``FrequencypoolConvTemporalpool`` (pool, a Dense named ``conv``, temporal
mean) -> (B, D).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from synchformer_tpu_torch.models.conv import Conv
from synchformer_tpu_torch.models.layers import Linear
from synchformer_tpu_torch.ops.numerics import exact_gelu


class LinearBridge(Linear):
    """Plain Linear projection with flax Dense numerics; state names
    ``weight``, ``bias``."""


class DoNothingBridge(nn.Module):
    """Identity (configs/segment_avclip.yaml's aproj / vproj); no parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class AppendZerosToHidden(nn.Module):
    """Zero-pad axis ``dim`` up to ``target_hidden_size``."""

    def __init__(self, target_hidden_size: int, dim: int = -1):
        super().__init__()
        self.target_hidden_size = target_hidden_size
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dim = self.dim % x.ndim
        pad = self.target_hidden_size - x.shape[dim]
        if pad < 0:
            raise ValueError(f"axis {dim} of size {x.shape[dim]} is longer than "
                             f"target_hidden_size {self.target_hidden_size}")
        return F.pad(x, (0, 0) * (x.ndim - 1 - dim) + (0, pad))


class ConvBridgeVisual(nn.Module):
    """(B, T, D, h, w) -> Conv3d over (T, h, w) + exact GELU -> (B, T', D', h', w')."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int] = (1, 1, 1), stride: Sequence[int] = (1, 1, 1),
                 device=None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, stride, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = exact_gelu(self.conv(x.permute(0, 2, 1, 3, 4)))
        return y.permute(0, 2, 1, 3, 4)


class ConvBridgeAudio(nn.Module):
    """(B, D, f, t) -> Conv2d over (f, t) + exact GELU -> (B, D', f', t')."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Sequence[int] = (1, 1),
                 stride: Sequence[int] = (1, 1), device=None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, stride, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return exact_gelu(self.conv(x))


class AvgPoolBridgeVisual(nn.Module):
    """(B, T, D, h, w) -> a VALID average pool over (T, h, w); no parameters."""

    def __init__(self, kernel_size: Sequence[int] = (1, 7, 7), stride: Sequence[int] = (1, 1, 1)):
        super().__init__()
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.avg_pool3d(x.permute(0, 2, 1, 3, 4), self.kernel_size, self.stride)
        return y.permute(0, 2, 1, 3, 4)


class AvgPoolBridgeAudio(nn.Module):
    """(B, D, f, t) -> a VALID average pool over (f, t); no parameters."""

    def __init__(self, kernel_size: Sequence[int] = (1, 1), stride: Sequence[int] = (1, 1)):
        super().__init__()
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.kernel_size, self.stride)


class SpatialpoolConvTemporalpool(nn.Module):
    """(B, t, d, h, w) -> spatial mean -> Dense ``conv`` -> temporal mean -> (B, D)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(1, 1, 1), device=None):
        super().__init__()
        self.conv = Linear(in_channels, out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.mean(dim=(3, 4))).mean(dim=1)


class FrequencypoolConvTemporalpool(nn.Module):
    """(B, d, f, t) -> frequency mean -> Dense ``conv`` -> temporal mean -> (B, D)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(1, 1), device=None):
        super().__init__()
        self.conv = Linear(in_channels, out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.mean(dim=2).transpose(1, 2)).mean(dim=1)
