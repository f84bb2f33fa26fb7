"""K3: unmasked full-softmax MHSA straight from packed (B, N, [q|k|v]).

Replaces synchformer_tpu/ops/pallas/standard_attention.py::standard_attention
(body _standard_attention_pallas / _kernel) with csrc/standard_attention.cu,
the tensor-core attention of csrc/mma_attention.cuh. On the main path it
serves the AST encoder's 12 layers at (112, 74, 2304): 51 MB a call, bound
by the bytes. One block per (batch row, head), a warp per 16-row query tile
(74 tokens pad to 80); both products on mma.sync, the softmax normalised in
f32 and rounded to bf16 in registers, as the TPU kernel does. It takes any
head_dim that is a multiple of 8 up to 256 (run at the next width of
_build.ATTN_WIDTHS) and any N (past 80 tokens the softmax takes a second
sweep over 80-key chunks; the AudioSet AST's 1214 tokens among them). Where a
gradient is wanted, ``impl='kernel'`` goes through ``StandardAttentionFn``:
kernel forward, backward through the plain version (the JAX custom_vjp,
standard_attention.py:102-119).
"""
from __future__ import annotations

import torch

from synchformer_tpu_torch.ops.autograd import plain_vjp
from synchformer_tpu_torch.ops.kernels import _build

__all__ = ["standard_attention", "standard_attention_plain", "StandardAttentionFn", "groupable"]


def groupable(num_heads: int, head_dim: int) -> bool:
    """The JAX layer's gate before K3 (synchformer_tpu/ops/pallas/
    standard_attention.py:33-36, used at models/layers.py:162-175): the heads
    pair into 128-lane groups. Where it fails (8 heads of 96), the attention
    takes the plain composition on every device; where it holds (head_dim
    16, 32, 64, 128, 256, ...), K3 takes it up to 256."""
    hpg = max(1, 128 // head_dim)
    return num_heads % hpg == 0 and (head_dim * hpg) % 128 == 0


def standard_attention_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The JAX reference (standard_attention_ref): q scaled in the compute
    dtype, f32 logits and softmax, probabilities rounded to the dtype."""
    b, n, threed = qkv.shape
    d = threed // 3
    dh = d // num_heads
    q, k, v = qkv.split(d, dim=-1)

    def heads(t):
        return t.reshape(b, n, num_heads, dh).transpose(1, 2)

    q, k, v = heads(q) * (dh ** -0.5), heads(k), heads(v)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = torch.matmul(probs, v)
    return out.transpose(1, 2).reshape(b, n, d)


def standard_attention(qkv: torch.Tensor, num_heads: int,
                       impl: str = "kernel") -> torch.Tensor:
    """(B, N, 3D) packed qkv -> (B, N, D), head-major. The kernel takes bf16,
    a head_dim that is a multiple of 8 up to 256, any N. Differentiable on
    both routes."""
    _build.use_kernel(qkv, impl)  # validates impl and device
    if impl == "plain":
        return standard_attention_plain(qkv, num_heads)
    if not (torch.is_grad_enabled() and qkv.requires_grad):
        # nothing to differentiate: skip the autograd Function, whose host
        # time is a large share of a call at the AST's shape
        return _standard_attention(qkv, num_heads)
    return StandardAttentionFn.apply(qkv, num_heads)


class StandardAttentionFn(torch.autograd.Function):
    """K3 forward; backward through the plain version."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return _standard_attention(qkv, num_heads)

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(lambda q: standard_attention_plain(q, ctx.num_heads),
                         ctx.saved_tensors, ctx.needs_input_grad[:1], (g,)) + (None,)


def _standard_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if not _build.use_kernel(qkv, "kernel"):
        return standard_attention_plain(qkv, num_heads)
    b, n, threed = qkv.shape
    d = threed // 3
    _build.require(qkv.dtype == torch.bfloat16 and qkv.is_contiguous(),
                   "K3 takes a contiguous bf16 qkv")
    _build.require(qkv.data_ptr() % 16 == 0,
                   "K3 reads qkv rows with 16-byte copies: 16-byte aligned qkv")
    dh = _build.head_dim("K3", d, num_heads)
    # grid: (heads x blocks of 8 query tiles, 1, batch rows)
    _build.require(0 < b <= 65535 and 0 < n and num_heads * -(-n // 128) < 2 ** 31,
                   "K3 shape out of range")
    out = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    fn = _build.library("standard_attention")
    _build.launches["K3"] += 1
    _build.check(fn(qkv.data_ptr(), out.data_ptr(), b, n, num_heads, dh,
                    _build.stream_ptr()), "K3 standard_attention")
    return out
