"""K2: LN + MLP + residual over rows (+ per-row LN statistics of the output);
K8c: LN + one matmul.

Replaces synchformer_tpu/ops/pallas/fused_rows.py::fused_ln_mlp_residual and
fused_ln_mlp_residual_stats (bodies _ln_mlp_slab_kernel, _ln_mlp_kernel) with
csrc/ln_mlp.cu. Both the 4-D patch slabs of the video tower and the 3-D token
rows of the AST reach one kernel over flattened rows.

On the H100 the two GEMMs (fc1 768->3072 with GELU, fc2 3072->768 with the
residual) bound it on the tensor cores; they run on the Hopper GEMM
(csrc/wgmma_gemm.cuh: TMA, wgmma, a persistent grid), so the wrapper takes
what that kernel takes (ops/kernels/gemm.py::check_gemm): d and hidden
multiples of 64, 16-byte aligned rows, up to 2^31 - 1 rows. The LN output
and the (rows, 3072) fc1 activation pass through device memory, where the
TPU kernel kept them in VMEM. The stats keep the JAX (..., 8) f32 layout
[mean, meansq, 0 x 6] so that consumers and tests compare like with like.

For training, ``impl='kernel'`` goes through ``LnMlpFn``: the forward is the
kernel, the backward recomputes the plain version and differentiates it (the
JAX custom_vjp, fused_rows.py:300-372).

K8c replaces fused_rows.py::fused_ln_matmul (_ln_matmul_pallas, body
_ln_matmul_kernel) with csrc/ln_mlp.cu's ``sft_ln_matmul``: the LayerNorm
into a bf16 scratch (ln_rows), then the Hopper GEMM on it, f32
accumulation, the bias in f32 and one bf16 rounding. It takes d % 32 == 0
(the GEMM's K) and out % 64 == 0 (its N). No model path calls it (in the JAX
package only tests/test_fused_rows.py does); its two launches are K8a's
first two (ops/kernels/fused_block.py). At (175728, 768) -> 2304 it is 621.9
GFLOP, bound by the tensor cores. ``LnMatmulFn``'s backward is the plain
version's (the JAX custom_vjp, fused_rows.py:99-124).
"""
from __future__ import annotations

import torch

from synchformer_tpu_torch.ops.autograd import plain_vjp
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels.gemm import check_gemm
from synchformer_tpu_torch.ops.numerics import (
    dense,
    exact_gelu,
    layer_norm,
    layer_norm_from_stats,
)

__all__ = ["fused_ln_mlp_residual", "ln_mlp_residual_plain", "layer_norm_from_stats",
           "LnMlpFn", "ln_mlp_kernel", "fused_ln_matmul", "fused_ln_matmul_plain",
           "LnMatmulFn", "check_ln_params"]


def row_stats(out: torch.Tensor) -> torch.Tensor:
    o32 = out.float()
    mean = o32.mean(-1, keepdim=True)
    msq = (o32 * o32).mean(-1, keepdim=True)
    pad = torch.zeros((*out.shape[:-1], 6), dtype=torch.float32, device=out.device)
    return torch.cat([mean, msq, pad], dim=-1)


def ln_mlp_residual_plain(x, g, b, w1, b1, w2, b2, eps: float,
                          emit_stats: bool = False):
    """The JAX reference composition (_ln_mlp_ref / _ln_mlp_stats_ref) with
    exact-erf GELU."""
    dtype = x.dtype
    ln = layer_norm(x, g, b, eps, dtype)
    h = exact_gelu(dense(ln, w1, b1, dtype))
    out = x + dense(h, w2, b2, dtype)
    return (out, row_stats(out)) if emit_stats else out


def fused_ln_mlp_residual(x, g, b, w1, b1, w2, b2, eps: float,
                          emit_stats: bool = False, impl: str = "kernel"):
    """x + fc2(GELU(fc1(LN(x)))); with ``emit_stats`` also the (..., 8) f32
    row statistics of the output. Weights (out, in); LN params and biases f32.
    Tolerance of the kernel against the plain version on the card: bf16
    rounding of the fc1 activation and the output (chip_smoke.py).
    Differentiable on both routes."""
    _build.use_kernel(x, impl)  # validates impl and device
    if impl == "plain":
        return ln_mlp_residual_plain(x, g, b, w1, b1, w2, b2, eps, emit_stats)
    return LnMlpFn.apply(x, g, b, w1, b1, w2, b2, eps, emit_stats)


class LnMlpFn(torch.autograd.Function):
    """K2 forward; backward through the plain version."""

    @staticmethod
    def forward(ctx, x, g, b, w1, b1, w2, b2, eps: float, emit_stats: bool):
        ctx.save_for_backward(x, g, b, w1, b1, w2, b2)
        ctx.eps, ctx.emit_stats = eps, emit_stats
        return _ln_mlp(x, g, b, w1, b1, w2, b2, eps, emit_stats)

    @staticmethod
    def backward(ctx, *grads):
        return plain_vjp(
            lambda *a: ln_mlp_residual_plain(*a, ctx.eps, ctx.emit_stats),
            ctx.saved_tensors, ctx.needs_input_grad[:7], grads) + (None, None)


def _ln_mlp(x, g, b, w1, b1, w2, b2, eps: float, emit_stats: bool):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if not _build.use_kernel(x, "kernel"):
        return ln_mlp_residual_plain(x, g, b, w1, b1, w2, b2, eps, emit_stats)
    return ln_mlp_kernel("K2", x, g, b, w1, b1, w2, b2, eps, emit_stats)


def ln_mlp_kernel(what: str, x, g, b, w1, b1, w2, b2, eps: float, emit_stats: bool = False,
                  poly: bool = False):
    """csrc/ln_mlp.cu's ``sft_ln_mlp`` on CUDA tensors, counted as ``what``:
    K2 (the exact GELU, the output's row statistics with ``emit_stats``) or,
    with ``poly``, K8b (the TPU kernel's polynomial GELU)."""
    _build.require_same_device(what, x, g, b, w1, b1, w2, b2)
    d = x.shape[-1]
    hidden = w1.shape[0]
    _build.require(x.dtype == torch.bfloat16 and x.is_contiguous(),
                   f"{what} takes a contiguous bf16 x")
    _build.require(w1.shape == (hidden, d) and w2.shape == (d, hidden)
                   and w1.dtype == w2.dtype == torch.bfloat16
                   and w1.is_contiguous() and w2.is_contiguous(),
                   f"{what} takes contiguous bf16 weights (hidden, d) and (d, hidden)")
    _build.require(all(t.dtype == torch.float32 and t.is_contiguous()
                       for t in (g, b, b1, b2)) and g.shape == b.shape == (d,),
                   f"{what} takes f32 LN params (d,) and biases")
    rows = x.numel() // d
    # fc1 reads the LN output, fc2 the activation (both allocated like x) and
    # the residual x: d % 64, hidden % 64, the row limit
    check_gemm(f"{what} fc1", rows, w1, b1, x)
    check_gemm(f"{what} fc2", rows, w2, b2, x)
    ln_buf = torch.empty_like(x)
    h_buf = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    stats = (torch.empty((*x.shape[:-1], 8), dtype=torch.float32, device=x.device)
             if emit_stats else None)
    fn = _build.library("ln_mlp")
    _build.launches[what] += 1
    _build.check(fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(),
                    b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln_buf.data_ptr(),
                    h_buf.data_ptr(), out.data_ptr(), _build.ptr(stats), rows, d,
                    hidden, float(eps), int(poly), _build.stream_ptr()), f"{what} ln_mlp")
    return (out, stats) if emit_stats else out


def check_ln_params(what: str, *params: torch.Tensor) -> None:
    """LN parameters and biases a kernel reads as f32 vectors, 16 bytes at a
    time."""
    _build.require(all(t.dtype == torch.float32 and t.is_contiguous() and t.data_ptr() % 16 == 0
                       for t in params),
                   f"{what} takes contiguous, 16-byte aligned f32 LN params and biases")


def fused_ln_matmul_plain(x, g, b, w, bias, eps: float):
    """The JAX reference composition _ln_matmul_ref: dense(LayerNorm(x))."""
    return dense(layer_norm(x, g, b, eps, x.dtype), w, bias, x.dtype)


def fused_ln_matmul(x, g, b, w, bias, eps: float = 1e-6, impl: str = "kernel"):
    """K8c: LayerNorm(x) @ w^T + bias; w (out, in) in x's dtype, LN params and
    bias f32. Differentiable on both routes."""
    _build.use_kernel(x, impl)  # validates impl and device
    if impl == "plain":
        return fused_ln_matmul_plain(x, g, b, w, bias, eps)
    return LnMatmulFn.apply(x, g, b, w, bias, eps)


class LnMatmulFn(torch.autograd.Function):
    """K8c forward; backward through the plain version."""

    @staticmethod
    def forward(ctx, x, g, b, w, bias, eps: float):
        ctx.save_for_backward(x, g, b, w, bias)
        ctx.eps = eps
        return _ln_matmul(x, g, b, w, bias, eps)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(lambda *a: fused_ln_matmul_plain(*a, ctx.eps), ctx.saved_tensors,
                         ctx.needs_input_grad[:5], (grad,)) + (None,)


def _ln_matmul(x, g, b, w, bias, eps: float):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if not _build.use_kernel(x, "kernel"):
        return fused_ln_matmul_plain(x, g, b, w, bias, eps)
    _build.require_same_device("K8c", x, g, b, w, bias)
    d = x.shape[-1]
    n_out = w.shape[0]
    _build.require(x.dtype == torch.bfloat16 and x.is_contiguous() and x.data_ptr() % 16 == 0,
                   "K8c takes a contiguous, 16-byte aligned bf16 x")
    _build.require(w.shape == (n_out, d) and w.dtype == torch.bfloat16 and w.is_contiguous(),
                   "K8c takes a contiguous bf16 w (out, in)")
    check_ln_params("K8c", g, b, bias)
    _build.require(g.shape == b.shape == (d,) and bias.shape == (n_out,), "K8c shape mismatch")
    rows = x.numel() // d
    # the GEMM reads the LN output (allocated like x): d % 32, out % 64, the row limit
    check_gemm("K8c", rows, w, bias, x)
    ln_buf = torch.empty_like(x)
    out = torch.empty((*x.shape[:-1], n_out), dtype=x.dtype, device=x.device)
    fn = _build.library("ln_mlp", "sft_ln_matmul")
    _build.launches["K8c"] += 1
    _build.check(fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(),
                    ln_buf.data_ptr(), out.data_ptr(), rows, d, n_out, float(eps),
                    _build.stream_ptr()), "K8c ln_matmul")
    return out
