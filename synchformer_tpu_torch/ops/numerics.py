"""Shared numerics of the JAX package's layers (synchformer_tpu/ops/pallas/
fused_block.py::layer_norm, dense, exact_gelu_f32), so that every plain path
and every kernel's plain version rounds at the same places as the reference.

Weights are torch Linear layout, (out, in). ``layer_norm`` and
``exact_gelu`` keep only their inputs for the backward and recompute the rest
(ops/autograd.py::recompute): their f32 intermediates were most of a training
step's activation memory.
"""
from __future__ import annotations

import functools

import torch

from synchformer_tpu_torch.ops.autograd import recompute


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, dtype: torch.dtype) -> torch.Tensor:
    """flax LayerNorm numerics: f32 fast-variance statistics
    max(E[x^2] - E[x]^2, 0), f32 affine, cast to the compute dtype."""
    return recompute(functools.partial(_layer_norm, eps=eps, dtype=dtype), x, weight, bias)


def _layer_norm(x, weight, bias, eps, dtype):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    msq = (x32 * x32).mean(-1, keepdim=True)
    return _affine(x32, mean, msq, weight, bias, eps).to(dtype)


def layer_norm_from_stats(x: torch.Tensor, mean: torch.Tensor, msq: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor, eps: float,
                          dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm from precomputed f32 row statistics (mean and mean of
    squares, broadcastable to x[..., :1]); synchformer_tpu/ops/pallas/
    fused_rows.py::layer_norm_from_stats."""
    return _affine(x.float(), mean, msq, weight, bias, eps).to(dtype)


def _affine(x32, mean, msq, weight, bias, eps):
    var = torch.clamp(msq - mean * mean, min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y * weight.float() + bias.float()


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
          dtype: torch.dtype) -> torch.Tensor:
    """flax Dense numerics: operands in the compute dtype, the product
    rounded to it before the bias (also cast) is added."""
    y = torch.matmul(x.to(dtype), weight.to(dtype).t())
    if bias is not None:
        y = y + bias.to(dtype)
    return y


def exact_gelu_f32(x32: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU on an f32 tensor."""
    return x32 * 0.5 * (1.0 + torch.erf(x32 * (2.0 ** -0.5)))


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU in x's dtype, computed in f32 (jax.nn.gelu(approximate=False))."""
    return recompute(_exact_gelu, x)


def _exact_gelu(x):
    return exact_gelu_f32(x.float()).to(x.dtype)
