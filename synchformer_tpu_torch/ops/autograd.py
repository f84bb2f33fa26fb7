"""Backward by recomputation.

``plain_vjp`` is the backward of a forward-only kernel (K2, K3, K4): recompute
its plain PyTorch version with autograd and differentiate that, as the JAX
package's custom_vjps do (synchformer_tpu/ops/pallas/fused_rows.py:300-372,
standard_attention.py:102-119, cls_pool.py:227-262).

``recompute`` runs a function whose autograd would keep large f32
intermediates (the f32 LayerNorm and exact GELU of ops/numerics.py) so that
only its inputs are saved; the backward recomputes it. The numbers are those
of autograd through the function itself.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def plain_vjp(plain: Callable, inputs: Sequence[torch.Tensor], needs: Sequence[bool],
              grads: Sequence[torch.Tensor]) -> tuple:
    """Gradients of ``plain(*inputs)`` for the cotangents ``grads`` (one per
    output), None where ``needs`` is False."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        outs = plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [t for t, n in zip(leaves, needs) if n]
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True) if wrt else ())
    return tuple(next(got) if n else None for n in needs)


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, *inputs):
        ctx.fn = fn
        ctx.save_for_backward(*inputs)
        return fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *plain_vjp(ctx.fn, ctx.saved_tensors, ctx.needs_input_grad[1:], grads))


def recompute(fn: Callable, *inputs: torch.Tensor):
    """fn(*inputs), saving only ``inputs`` for the backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Recompute.apply(fn, *inputs)
    return fn(*inputs)
