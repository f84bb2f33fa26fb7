"""K4: fused CLS-pool encoder layer, tokens variant (shared CLS row).

Replaces synchformer_tpu/ops/pallas/cls_pool.py::fused_cls_pool_tokens (body
_cls_pool_tokens_pallas / _cls_pool_tokens_kernel) with csrc/cls_pool.cu.
Main-path shapes: the spatial aggregator's (896, 196, 768) and the frequency
aggregator's (672, 12, 768), each with one learned CLS row.

With one query the kernel skips the (N, 2D) K/V GEMM: logits are LN(x) against
U_h = Wk_h^T q_h, and the output is the p-weighted sum of LN(x) times Wv_h.
That reads x once per group and keeps the pool pass bound by that read. The
bf16 rounding of K and V in the reference is skipped, which the bf16
tolerance on the card covers. Proj, LN2 and the MLP then run as GEMMs with
the groups as rows; their (B, D) and (B, 4D) inputs pass through device
memory, where the TPU kernel kept them in VMEM. For training,
``impl='kernel'`` goes through ``ClsPoolTokensFn``: kernel forward, backward
through the plain version (the JAX custom_vjp, cls_pool.py:227-262).
"""
from __future__ import annotations

import torch

from synchformer_tpu_torch.ops.autograd import plain_vjp
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.numerics import dense, exact_gelu, layer_norm

__all__ = ["fused_cls_pool_tokens", "cls_pool_tokens_plain", "ClsPoolTokensFn"]


def cls_pool_tokens_plain(x, cls, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1,
                          w2, fb2, num_heads: int, eps: float) -> torch.Tensor:
    """The JAX reference (_cls_pool_tokens_ref -> _cls_pool_ref): prepend the
    CLS row, then PreLNBlock(query_rows=1) math. Returns (B, D)."""
    bsz, m, d = x.shape
    dtype = x.dtype
    dh = d // num_heads
    full = torch.cat([cls.reshape(1, 1, d).to(dtype).expand(bsz, 1, d), x], dim=1)
    n = m + 1
    ln = layer_norm(full, g1, b1, eps, dtype)
    q = dense(ln[:, :1], wqkv[:d], bqkv[:d], dtype).reshape(bsz, 1, num_heads, dh)
    kv = dense(ln, wqkv[d:], bqkv[d:], dtype)
    k = kv[..., :d].reshape(bsz, n, num_heads, dh)
    v = kv[..., d:].reshape(bsz, n, num_heads, dh)
    logits = torch.einsum("bqhd,bnhd->bhqn", q.float(), k.float()) * (dh ** -0.5)
    p = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum("bhqn,bnhd->bqhd", p, v).reshape(bsz, 1, d)
    att = dense(out, wp, bp, dtype)[:, 0]
    y = full[:, 0, :] + att
    ln2 = layer_norm(y, g2, b2, eps, dtype)
    h = exact_gelu(dense(ln2, w1, fb1, dtype))
    return y + dense(h, w2, fb2, dtype)


def fused_cls_pool_tokens(x, cls, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1,
                          w2, fb2, num_heads: int, eps: float,
                          impl: str = "kernel") -> torch.Tensor:
    """One pre-LN encoder layer for the CLS row over [cls; x] -> (B, D).
    Matrices (out, in) bf16; cls, LN params and biases f32. Differentiable on
    both routes."""
    _build.use_kernel(x, impl)  # validates impl and device
    args = (x, cls, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1, w2, fb2)
    if impl == "plain":
        return cls_pool_tokens_plain(*args, num_heads, eps)
    return ClsPoolTokensFn.apply(*args, num_heads, eps)


class ClsPoolTokensFn(torch.autograd.Function):
    """K4 forward; backward through the plain version."""

    @staticmethod
    def forward(ctx, *args):
        tensors, (num_heads, eps) = args[:14], args[14:]
        ctx.save_for_backward(*tensors)
        ctx.num_heads, ctx.eps = num_heads, eps
        return _cls_pool_tokens(*args)

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(lambda *a: cls_pool_tokens_plain(*a, ctx.num_heads, ctx.eps),
                         ctx.saved_tensors, ctx.needs_input_grad[:14], (g,)) + (None, None)


def _cls_pool_tokens(x, cls, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1, w2, fb2,
                     num_heads: int, eps: float) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if not _build.use_kernel(x, "kernel"):
        return cls_pool_tokens_plain(x, cls, g1, b1, wqkv, bqkv, wp, bp, g2, b2,
                                     w1, fb1, w2, fb2, num_heads, eps)
    _build.require_same_device("K4", x, cls, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1,
                               w2, fb2)
    bsz, m, d = x.shape
    hidden = w1.shape[0]
    _build.require(x.dtype == torch.bfloat16 and x.is_contiguous(),
                   "K4 takes a contiguous bf16 x")
    mats = ((wqkv, (3 * d, d)), (wp, (d, d)), (w1, (hidden, d)), (w2, (d, hidden)))
    _build.require(all(w.shape == s and w.dtype == torch.bfloat16 and w.is_contiguous()
                       for w, s in mats), "K4 takes contiguous bf16 (out, in) matrices")
    vecs = (g1, b1, bqkv, bp, g2, b2, fb1, fb2)
    _build.require(all(t.dtype == torch.float32 and t.is_contiguous() for t in vecs),
                   "K4 takes f32 LN params and biases")
    _build.require(d % 64 == 0 and hidden % 64 == 0 and num_heads <= 16
                   and d % num_heads == 0, "K4 needs d, hidden % 64 == 0, <= 16 heads")
    _build.require(0 < bsz <= _build.MAX_GEMM_ROWS and m >= 1, "K4 shape out of range")
    dev = x.device
    cls_b = cls.reshape(d).to(torch.bfloat16).contiguous()
    work = torch.empty(3 * d + num_heads * d + 2 * num_heads, dtype=torch.float32, device=dev)
    att = torch.empty((bsz, d), dtype=x.dtype, device=dev)
    y = torch.empty_like(att)
    ln2 = torch.empty_like(att)
    hbuf = torch.empty((bsz, hidden), dtype=x.dtype, device=dev)
    out = torch.empty_like(att)
    fn = _build.library("cls_pool")
    _build.launches["K4"] += 1
    _build.check(fn(x.data_ptr(), cls_b.data_ptr(), g1.data_ptr(), b1.data_ptr(),
                    wqkv.data_ptr(), bqkv.data_ptr(), wp.data_ptr(), bp.data_ptr(),
                    g2.data_ptr(), b2.data_ptr(), w1.data_ptr(), fb1.data_ptr(),
                    w2.data_ptr(), fb2.data_ptr(), work.data_ptr(), att.data_ptr(),
                    y.data_ptr(), ln2.data_ptr(), hbuf.data_ptr(), out.data_ptr(),
                    bsz, m, d, num_heads, hidden, float(eps), _build.stream_ptr()),
                 "K4 cls_pool_tokens")
    return out
