"""Convolution, pooling and BatchNorm with flax numerics, channels-first.

flax's ``padding="SAME"`` (nn.Conv's default and nn.max_pool's "SAME") is
TF-style: per spatial axis the output has ceil(n / stride) positions and the
padding total = max((out - 1) * stride + k - n, 0) is split low = total // 2,
high = total - low (lax.padtype_to_pads). At stride 2 that is asymmetric (a
7-tap conv over 224 pads (2, 3); a 3-tap one over an even length (0, 1)),
where torch's ``padding=k // 2`` pads symmetrically: same shape, other
values. ``same_pads`` computes flax's amounts; a symmetric one goes to the
conv or pool as its own padding, any other through ``F.pad`` first (zeros
for a conv, -inf for a max pool, as lax.reduce_window's init value).

Numerics as flax's layers: a conv in the compute dtype (its kernel cast to
the input's dtype), bias cast and added after; ``BatchNorm`` in eval, the
running statistics and the affine in f32, then cast to the input's dtype.
These are cuDNN calls on the card: the JAX package computes them outside any
Pallas kernel. State names: ``weight`` (out, in, *kernel), ``bias``;
BatchNorm ``weight``, ``bias`` and the buffers ``running_mean``,
``running_var``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
NOT_TRAINED = ("training the legacy towers (BatchNorm in training mode, its running-statistics "
               "update) is not ported (ROADMAP §1 item 7.5)")


def same_pads(sizes: Sequence[int], kernel: Sequence[int],
              strides: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """flax / lax ``SAME`` padding (low, high) per spatial axis."""
    pads = []
    for n, k, s in zip(sizes, kernel, strides):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _pad_or_native(x: torch.Tensor, kernel, strides, value: float):
    """(x, native padding): a symmetric SAME padding is left to the op, any
    other is applied here with ``value``."""
    pads = same_pads(x.shape[2:], kernel, strides)
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last axis first
    return F.pad(x, flat, value=value), (0,) * len(pads)


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias, strides: Sequence[int]) -> torch.Tensor:
    """flax nn.Conv (padding SAME) over channels-first x (N, C, *spatial):
    the product in x's dtype, then the bias in that dtype."""
    nd = weight.ndim - 2
    w = weight.to(x.dtype)
    x, native = _pad_or_native(x, w.shape[2:], strides, 0.0)
    y = _CONV[nd](x, w, None, tuple(strides), native)
    if bias is not None:
        y = y + bias.to(x.dtype).reshape(1, -1, *(1,) * nd)
    return y


def max_pool_same(x: torch.Tensor, kernel: Sequence[int], strides: Sequence[int]) -> torch.Tensor:
    """flax nn.max_pool(padding="SAME") over channels-first x: -inf padding."""
    x, native = _pad_or_native(x, kernel, strides, float("-inf"))
    return _MAX_POOL[len(kernel)](x, tuple(kernel), tuple(strides), native)


class Conv(nn.Module):
    """flax nn.Conv (padding SAME) with torch Conv parameters (weight (out,
    in, *kernel)); channels-first in and out."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Sequence[int],
                 strides: Sequence[int] | None = None, bias: bool = True, device=None):
        super().__init__()
        kernel = tuple(kernel)
        self.strides = tuple(strides) if strides is not None else (1,) * len(kernel)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, *kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_same(x, self.weight, self.bias, self.strides)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(use_running_average=True) over channels-first x:
    ((x - mean) * (rsqrt(var + eps) * weight) + bias) in f32, then x's dtype;
    ``relu`` applies the ReLU that follows it in both towers. Inference only:
    the running-statistics update of training is not ported.
    ``closes_residual`` marks the last BatchNorm of a branch that a residual
    sum adds (seeded_state_dict draws its weight at half scale)."""

    def __init__(self, features: int, eps: float, device=None, closes_residual: bool = False):
        super().__init__()
        self.eps = eps
        self.closes_residual = closes_residual
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        y = (x.float() - self.running_mean.float().reshape(shape)) * mul.reshape(shape)
        y = y + self.bias.float().reshape(shape)
        if relu:
            y = torch.relu(y)
        return y.to(x.dtype)
