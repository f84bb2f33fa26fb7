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
the input's dtype), bias cast and added after; ``BatchNorm`` normalises in
f32 and casts to the input's dtype, with the running statistics in eval and
with the batch's in training (``_BatchNormTrain``). These are cuDNN calls
and elementwise PyTorch on the card: the JAX package computes them outside
any Pallas kernel. State names: ``weight`` (out, in, *kernel), ``bias``;
BatchNorm ``weight``, ``bias`` and the buffers ``running_mean``,
``running_var``.

BatchNorm in training is flax's nn.BatchNorm(use_running_average=False)
(flax/linen/normalization.py ``_compute_stats``, ``_normalize``): the
statistics in f32 over every axis but the channels, mean = E[x] and the
one-pass, biased var = max(E[x^2] - E[x]^2, 0); the output (x - mean) *
rsqrt(var + eps) * weight + bias in f32; the buffers updated as
``m * running + (1 - m) * batch`` with flax's momentum m (the weight of the
old value; torch's 0.001 is flax's 0.999) and the biased var. Over data
ranks (parallel/dist.py) the per-channel count, sum and sum of squares are
summed over the data group before the statistics are formed, so that every
rank normalises with the global batch's statistics and keeps the same
buffers, as the JAX step, jitted over a batch sharded on the mesh's 'data'
axis, does; model peers hold the same rows and are not summed over. The
backward is the analytic one of that function, mean and var included (their
sums of the gradient summed over the data group too): jax.grad's, up to the
order of f32 sums. torch's batch_norm and SyncBatchNorm keep the unbiased
variance in running_var and a two-pass variance, so neither is used.

``max_pool_same``'s backward adds each window's gradient to its argmax one
window offset at a time, in a fixed order: a deterministic sum where a CUDA
max_pool3d backward adds overlapping windows' gradients with atomics, so
that a resumed run repeats a step bit for bit.
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from synchformer_tpu_torch.parallel import dist as pdist

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


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


class _MaxPool(torch.autograd.Function):
    """F.max_poolNd with its argmax; the backward adds the gradient of each
    window to its argmax one window offset at a time (a strided slice of the
    natively padded grid per offset), a fixed order of f32 sums."""

    @staticmethod
    def forward(ctx, x, kernel, strides, native):
        y, idx = _MAX_POOL[len(kernel)](x, kernel, strides, native, return_indices=True)
        ctx.save_for_backward(idx)
        ctx.geometry = (tuple(x.shape), kernel, strides, native)
        return y

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        shape, kernel, strides, native = ctx.geometry
        sizes, out = shape[2:], g.shape[2:]
        grid = g.new_zeros(*shape[:2],
                           *(n + 2 * p + s for n, p, s in zip(sizes, native, strides)))
        # each output position's window origin along each axis, in x's coordinates
        origin = [torch.arange(o, device=g.device) * s - p
                  for o, s, p in zip(out, strides, native)]
        for offset in itertools.product(*(range(k) for k in kernel)):
            coords = [o + k for o, k in zip(origin, offset)]
            flat = torch.zeros((), dtype=torch.long, device=g.device)
            valid = torch.ones((), dtype=torch.bool, device=g.device)
            for axis, (c, n) in enumerate(zip(coords, sizes)):
                view = (-1,) + (1,) * (len(sizes) - axis - 1)
                flat = flat * n + c.reshape(view)
                valid = valid & ((c >= 0) & (c < n)).reshape(view)
            hit = (idx == flat) & valid
            window = tuple(slice(k, k + s * (o - 1) + 1, s)
                           for k, s, o in zip(offset, strides, out))
            grid[(...,) + window] += torch.where(hit, g, torch.zeros((), dtype=g.dtype,
                                                                     device=g.device))
        crop = tuple(slice(p, p + n) for p, n in zip(native, sizes))
        return grid[(...,) + crop], None, None, None


def max_pool_same(x: torch.Tensor, kernel: Sequence[int], strides: Sequence[int]) -> torch.Tensor:
    """flax nn.max_pool(padding="SAME") over channels-first x: -inf padding;
    a deterministic backward (_MaxPool)."""
    x, native = _pad_or_native(x, kernel, strides, float("-inf"))
    return _MaxPool.apply(x, tuple(kernel), tuple(strides), native)


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


def _reduced_axes(x: torch.Tensor) -> list:
    return [0] + list(range(2, x.ndim))


def _channel_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (ndim - 2))


def data_sums(sums: torch.Tensor) -> torch.Tensor:
    """(k, C) f64 per-channel sums of this rank's rows -> their sums over
    the data group (this rank's own without one)."""
    if not dist.is_initialized() or pdist.n_data() == 1:
        return sums
    sums = sums.clone()
    dist.all_reduce(sums, group=pdist.data_group())
    return sums


def batch_stats(x: torch.Tensor):
    """flax _compute_stats over every axis of channels-first x but 1, over
    the data ranks: (mean, var, raw_var, count), f32; mean, var and raw_var
    (C,), the count 0-d; var = max(raw_var, 0), raw_var = E[x^2] - E[x]^2.
    A rank's f32 sums and count go over the group in f64 and are rounded to
    f32 once after the sum."""
    axes = _reduced_axes(x)
    xf = x.float()
    local = torch.stack([xf.sum(axes).double(), (xf * xf).sum(axes).double(),
                         torch.full((x.shape[1],), float(x.numel() // x.shape[1]),
                                    dtype=torch.float64, device=x.device)])
    sums = data_sums(local).float()
    count = sums[2, 0]
    mean = sums[0] / count
    raw = sums[1] / count - mean * mean
    return mean, torch.clamp_min(raw, 0.0), raw, count


def running_update_(bn: "BatchNorm", mean: torch.Tensor, var: torch.Tensor,
                    count: torch.Tensor) -> None:
    """flax's running update of ``bn``'s buffers from the batch's mean and
    biased var: ``m * running + (1 - m) * batch``, m = bn.momentum. (``count``
    is the batch's count per channel, which flax does not read.)"""
    m = bn.momentum
    with torch.no_grad():
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)


class _BatchNormTrain(torch.autograd.Function):
    """y = (x - mean) * (rsqrt(var + eps) * weight) + bias in f32 with the
    batch statistics of batch_stats, ReLU'd with ``relu``, cast to x's dtype;
    also returns mean, var and count (no gradient). Saves x and, with
    ``relu``, y; the backward recomputes x_hat and takes mean and var's
    gradient path (var's only where the unclipped var is positive, half of
    it where it is 0, as jax.grad through jnp.maximum)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, relu: bool):
        mean, var, raw, count = batch_stats(x)
        rstd = torch.rsqrt(var + eps)
        nd = x.ndim
        y = ((x.float() - _channel_view(mean, nd)) * _channel_view(rstd * weight.float(), nd)
             + _channel_view(bias.float(), nd))
        if relu:
            y = torch.relu(y)
        y = y.to(x.dtype)
        var_path = torch.where(raw > 0, 1.0, torch.where(raw == 0, 0.5, 0.0))
        ctx.save_for_backward(x, y if relu else None, weight, mean, rstd, var_path, count)
        ctx.relu = relu
        ctx.mark_non_differentiable(mean, var, count)
        return y, mean, var, count

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dcount):
        x, y, weight, mean, rstd, var_path, count = ctx.saved_tensors
        nd, axes = x.ndim, _reduced_axes(x)
        g = dy.float()
        if ctx.relu:
            g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
        xhat = (x.float() - _channel_view(mean, nd)) * _channel_view(rstd, nd)
        local = torch.stack([g.sum(axes), (g * xhat).sum(axes)])
        dbias, dweight = local[0], local[1]
        total = data_sums(local.double()).float() / count
        dx = _channel_view(rstd * weight.float(), nd) * (
            g - _channel_view(total[0], nd) - xhat * _channel_view(var_path * total[1], nd))
        return dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(weight.dtype), None, None


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over channels-first x: ((x - mean) * (rsqrt(var +
    eps) * weight) + bias) in f32, then x's dtype; ``relu`` applies the ReLU
    that follows it in both towers. In eval (``train`` False) mean and var
    are the running statistics; in training the batch's (over the data
    ranks, _BatchNormTrain), and the buffers take flax's update with
    ``momentum`` (flax's: the weight of the old value; S3D 0.999, ResNet-18
    0.9). ``closes_residual`` marks the last BatchNorm of a branch that a
    residual sum adds (seeded_state_dict draws its weight at half scale)."""

    def __init__(self, features: int, eps: float, device=None, closes_residual: bool = False,
                 momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.closes_residual = closes_residual
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, relu: bool = False, train: bool = False) -> torch.Tensor:
        if train:
            y, mean, var, count = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps,
                                                        relu)
            running_update_(self, mean, var, count)
            return y
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        y = (x.float() - self.running_mean.float().reshape(shape)) * mul.reshape(shape)
        y = y + self.bias.float().reshape(shape)
        if relu:
            y = torch.relu(y)
        return y.to(x.dtype)
