"""K4 and K4b: the fused CLS-pool encoder layer, with a shared CLS row (K4)
or with the CLS row inside x (K4b).

K4 replaces synchformer_tpu/ops/pallas/cls_pool.py::fused_cls_pool_tokens
(body _cls_pool_tokens_pallas / _cls_pool_tokens_kernel) with
csrc/cls_pool.cu's sft_cls_pool_tokens. Main-path shapes: the spatial
aggregator's (896, 196, 768) and the frequency aggregator's (672, 12, 768),
each with one learned CLS row; the MoCo step's global aggregators at (2, 14,
768).

K4b replaces cls_pool.py::fused_cls_pool (body _cls_pool_pallas /
_cls_pool_kernel) with sft_cls_pool: row 0 of each group is its CLS row, so
the query differs per group. The model reaches it in the MoCo Stage I step's
query pass, where the video tower's global segment aggregator has its
positional dropout live: x (B, 1 + S, 768), B=2, S=14.

With one query the kernels skip the (N, 2D) K/V GEMM: logits are LN(x)
against U_h = Wk_h^T q_h, and the output is Z_h Wv_h^T with Z_h the
p-weighted sum of LN(x). csrc/cls_pool.cu forms q and U across the card,
reads x once in a pass on the tensor cores that writes Z (B, H, D) in f32,
takes every group's Wv product at once, then proj, LN2 and the MLP with the
groups as rows on the Hopper GEMM (or, at a few groups, a skinny product that
spreads the weight read over the card). The pass's plan (_build.
cls_pool_plan: groups a block, a 2-block cluster for a group longer than a
block holds) is computed here and passed in. The bf16 rounding of K and V in
the reference is skipped, which the bf16 tolerance on the card covers. For
training, ``impl='kernel'`` goes through ``ClsPoolTokensFn`` / ``ClsPoolFn``:
kernel forward, backward through the plain version (the JAX custom_vjps,
cls_pool.py:227-262 and 326-360).
"""
from __future__ import annotations

import torch

from synchformer_tpu_torch.ops.autograd import plain_vjp
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.numerics import dense, exact_gelu, layer_norm

__all__ = ["fused_cls_pool_tokens", "cls_pool_tokens_plain", "ClsPoolTokensFn",
           "fused_cls_pool", "cls_pool_plain", "ClsPoolFn"]


def cls_pool_plain(x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1, w2, fb2,
                   num_heads: int, eps: float) -> torch.Tensor:
    """The JAX reference _cls_pool_ref: PreLNBlock(query_rows=1) math over
    (B, N, D) x whose row 0 is the CLS row, exact-erf GELU. Returns (B, D)."""
    bsz, n, d = x.shape
    dtype = x.dtype
    dh = d // num_heads
    ln = layer_norm(x, g1, b1, eps, dtype)
    q = dense(ln[:, :1], wqkv[:d], bqkv[:d], dtype).reshape(bsz, 1, num_heads, dh)
    kv = dense(ln, wqkv[d:], bqkv[d:], dtype)
    k = kv[..., :d].reshape(bsz, n, num_heads, dh)
    v = kv[..., d:].reshape(bsz, n, num_heads, dh)
    logits = torch.einsum("bqhd,bnhd->bhqn", q.float(), k.float()) * (dh ** -0.5)
    p = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum("bhqn,bnhd->bqhd", p, v).reshape(bsz, 1, d)
    att = dense(out, wp, bp, dtype)[:, 0]
    y = x[:, 0, :] + att
    ln2 = layer_norm(y, g2, b2, eps, dtype)
    h = exact_gelu(dense(ln2, w1, fb1, dtype))
    return y + dense(h, w2, fb2, dtype)


def cls_pool_tokens_plain(x, cls, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1,
                          w2, fb2, num_heads: int, eps: float) -> torch.Tensor:
    """The JAX reference _cls_pool_tokens_ref: prepend the CLS row, then
    cls_pool_plain. Returns (B, D)."""
    bsz, _, d = x.shape
    full = torch.cat([cls.reshape(1, 1, d).to(x.dtype).expand(bsz, 1, d), x], dim=1)
    return cls_pool_plain(full, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1, w2, fb2,
                          num_heads, eps)


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


def _check_layer(what: str, x, wqkv, wp, w1, w2, vecs, num_heads: int, shared_u: bool) -> dict:
    """The operands both kernels take: contiguous bf16 x and (out, in)
    matrices, f32 LN params and biases, all on x's device. Returns the pool
    pass's plan."""
    _build.require_same_device(what, x, wqkv, wp, w1, w2, *vecs)
    bsz, n, d = x.shape
    hidden = w1.shape[0]
    _build.require(x.dtype == torch.bfloat16 and x.is_contiguous(),
                   f"{what} takes a contiguous bf16 x")
    mats = ((wqkv, (3 * d, d)), (wp, (d, d)), (w1, (hidden, d)), (w2, (d, hidden)))
    _build.require(all(w.shape == s and w.dtype == torch.bfloat16 and w.is_contiguous()
                       for w, s in mats), f"{what} takes contiguous bf16 (out, in) matrices")
    _build.require(all(t.dtype == torch.float32 and t.is_contiguous() for t in vecs),
                   f"{what} takes f32 LN params and biases")
    # the tail's MLP over the groups: hidden in 16-byte rows (the Hopper
    # GEMM's TMA rows, the skinny product's 8-value pieces)
    _build.require(d % 64 == 0 and hidden % 8 == 0 and num_heads <= _build.CLS_MAXH
                   and d % num_heads == 0,
                   f"{what} needs d % 64 == 0, hidden % 8 == 0, <= 16 heads")
    _build.require(bsz >= 1 and n >= 1, f"{what} shape out of range")
    plan = _build.cls_pool_plan(bsz, n, d, num_heads, shared_u)
    _build.require(plan["blocks"] < 2 ** 31, f"{what} shape out of range")
    return plan


def _scratch(x, n_wb: int, hidden: int):
    """One bf16 allocation for the kernels' scratch: wb (n_wb values, a
    multiple of 64), then att, y and ln2 (B, D) and the MLP activation (B,
    hidden), each 16-byte aligned."""
    bsz, d = x.shape[0], x.shape[-1]
    ws = torch.empty(n_wb + 3 * bsz * d + bsz * hidden, dtype=torch.bfloat16, device=x.device)
    wb, att, y, ln2, hbuf = ws.split([n_wb, bsz * d, bsz * d, bsz * d, bsz * hidden])
    return (wb, att.view(bsz, d), y.view(bsz, d), ln2.view(bsz, d), hbuf.view(bsz, hidden))


def _cls_pool_tokens(x, cls, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1, w2, fb2,
                     num_heads: int, eps: float) -> torch.Tensor:
    """K4 on a CUDA tensor, the plain version on a CPU one."""
    if not _build.use_kernel(x, "kernel"):
        return cls_pool_tokens_plain(x, cls, g1, b1, wqkv, bqkv, wp, bp, g2, b2,
                                     w1, fb1, w2, fb2, num_heads, eps)
    _build.require_same_device("K4", x, cls)
    plan = _check_layer("K4", x, wqkv, wp, w1, w2, (g1, b1, bqkv, bp, g2, b2, fb1, fb2),
                        num_heads, True)
    bsz, m, d = x.shape
    hidden, h, cl = w1.shape[0], num_heads, plan["cluster"]
    dev = x.device
    cls_b = cls.reshape(d).to(torch.bfloat16).contiguous()
    wb, att, y, ln2, hbuf = _scratch(x, (4 + 2 * h) * d, hidden)
    wf = torch.empty(bsz * cl * h * d + 2 * h + bsz * cl * h + bsz * h, dtype=torch.float32,
                     device=dev)
    out = torch.empty_like(att)
    fn = _build.library("cls_pool")
    _build.launches["K4"] += 1
    _build.check(fn(x.data_ptr(), cls_b.data_ptr(), g1.data_ptr(), b1.data_ptr(),
                    wqkv.data_ptr(), bqkv.data_ptr(), wp.data_ptr(), bp.data_ptr(),
                    g2.data_ptr(), b2.data_ptr(), w1.data_ptr(), fb1.data_ptr(),
                    w2.data_ptr(), fb2.data_ptr(), wb.data_ptr(), wf.data_ptr(), att.data_ptr(),
                    y.data_ptr(), ln2.data_ptr(), hbuf.data_ptr(), out.data_ptr(),
                    bsz, m, d, h, hidden, plan["groups"], cl, plan["rows"], float(eps),
                    _build.stream_ptr()),
                 "K4 cls_pool_tokens")
    return out


def fused_cls_pool(x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1, w2, fb2,
                   num_heads: int, eps: float, impl: str = "kernel") -> torch.Tensor:
    """One pre-LN encoder layer for row 0 of each group of x (B, N, D) ->
    (B, D). Matrices (out, in) bf16; LN params and biases f32.
    Differentiable on both routes."""
    _build.use_kernel(x, impl)  # validates impl and device
    args = (x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1, w2, fb2)
    if impl == "plain":
        return cls_pool_plain(*args, num_heads, eps)
    return ClsPoolFn.apply(*args, num_heads, eps)


class ClsPoolFn(torch.autograd.Function):
    """K4b forward; backward through the plain version (JAX _cls_pool_bwd)."""

    @staticmethod
    def forward(ctx, *args):
        tensors, (num_heads, eps) = args[:13], args[13:]
        ctx.save_for_backward(*tensors)
        ctx.num_heads, ctx.eps = num_heads, eps
        return _cls_pool(*args)

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(lambda *a: cls_pool_plain(*a, ctx.num_heads, ctx.eps),
                         ctx.saved_tensors, ctx.needs_input_grad[:13], (g,)) + (None, None)


def _cls_pool(x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1, w2, fb2,
              num_heads: int, eps: float) -> torch.Tensor:
    """K4b on a CUDA tensor, the plain version on a CPU one."""
    if not _build.use_kernel(x, "kernel"):
        return cls_pool_plain(x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1, w2, fb2,
                              num_heads, eps)
    plan = _check_layer("K4b", x, wqkv, wp, w1, w2, (g1, b1, bqkv, bp, g2, b2, fb1, fb2),
                        num_heads, False)
    bsz, n, d = x.shape
    hidden, h, cl = w1.shape[0], num_heads, plan["cluster"]
    dev = x.device
    wb, att, y, ln2, hbuf = _scratch(x, 2 * bsz * d * (1 + h), hidden)
    wf = torch.empty(bsz * cl * h * d + bsz * h + bsz * cl * h, dtype=torch.float32, device=dev)
    out = torch.empty_like(att)
    fn = _build.library("cls_pool", "sft_cls_pool")
    _build.launches["K4b"] += 1
    _build.check(fn(x.data_ptr(), g1.data_ptr(), b1.data_ptr(), wqkv.data_ptr(),
                    bqkv.data_ptr(), wp.data_ptr(), bp.data_ptr(), g2.data_ptr(),
                    b2.data_ptr(), w1.data_ptr(), fb1.data_ptr(), w2.data_ptr(),
                    fb2.data_ptr(), wb.data_ptr(), wf.data_ptr(), att.data_ptr(),
                    y.data_ptr(), ln2.data_ptr(), hbuf.data_ptr(), out.data_ptr(),
                    bsz, n, d, h, hidden, plan["groups"], cl, plan["rows"], float(eps),
                    _build.stream_ptr()),
                 "K4b cls_pool")
    return out
