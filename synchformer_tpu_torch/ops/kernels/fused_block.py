"""K8a: LayerNorm -> QKV projection -> packed divided attention; K8b: LN +
MLP + residual. The attn_impl='pallas_fused' route of the Motionformer's
packed flow (synchformer_tpu/models/motionformer.py:176-189, :394-403).

K8a replaces synchformer_tpu/ops/pallas/fused_block.py::fused_divided_attention
(_fused_attention_pallas, body _fused_attn_kernel) with csrc/fused_block.cu's
``sft_fused_divided_attention``: one C entry that runs the LayerNorm of x
into a bf16 scratch (ln_rows) and the Hopper GEMM (csrc/wgmma_gemm.cuh) on
it into a (B, 1 + f*n, 3D) bf16 qkv scratch, then K7a's group and CLS-row
launches on that. The TPU kernel keeps both in VMEM; here they pass through
device memory (the qkv 810 MB a call at the serving shape (112, 1569,
768)). It takes D % 64 == 0 and up to 2^31 - 1 rows. The attention stage rounds the normalised probabilities to bf16
before an f32 P @ V, as K7a and the XLA composition do; the TPU body's time
mode rounds each exp * v product instead (the two agree in f32). The launch
counts under K8a.

``FusedDividedAttentionFn`` is the JAX custom VJP (fused_block.py:211-254)
without the unused primal: the forward runs K8a and saves its inputs; the
backward recomputes LN + QKV with autograd (plain), runs K7c
(divided_attention_packed_bwd) on that qkv and the cotangent, and carries
dqkv back through the dense and the LN. It launches no forward kernel.

K8b replaces fused_mlp_residual (_fused_mlp_pallas, body _fused_mlp_kernel)
with K2's entry, csrc/ln_mlp.cu's ``sft_ln_mlp``: three launches, the
LayerNorm into a bf16 scratch, fc1 on the Hopper GEMM with bias and GELU
into a (rows, hidden) bf16 scratch, and fc2 with bias and the residual
(csrc/ln_mlp.cu says why not one launch). It takes D and hidden multiples
of 64. Its GELU is the Pallas kernel's clamped degree-9 erf polynomial
(|err| <= 3e-5); K2 (fused_rows.py) and every plain version use exact erf.
``FusedMlpFn``'s backward is the plain version's (fused_block.py:327-329).

The plain versions are the JAX reference compositions: _fused_attention_ref
(LN, dense, the packed divided attention) and _fused_mlp_ref (LN, dense,
exact GELU, dense, residual), the same operations the 'pallas' route's plain
path runs, so one state dict gives the same plain output on both routes.
Tolerance of the kernels against the plain versions on the card: bf16
rounding at other places (chip_smoke.py).
"""
from __future__ import annotations

import torch

from synchformer_tpu_torch.ops.autograd import plain_vjp
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels.divided_attention import (
    _MODES,
    check_packed_qkv,
    divided_attention_packed_plain,
)
from synchformer_tpu_torch.ops.kernels.divided_attention_bwd import divided_attention_packed_bwd
from synchformer_tpu_torch.ops.kernels.fused_rows import (
    check_ln_params,
    ln_mlp_kernel,
    ln_mlp_residual_plain,
)
from synchformer_tpu_torch.ops.kernels.gemm import check_gemm
from synchformer_tpu_torch.ops.numerics import dense, layer_norm

__all__ = ["fused_divided_attention", "fused_divided_attention_plain",
           "FusedDividedAttentionFn", "fused_mlp_residual", "fused_mlp_residual_plain",
           "FusedMlpFn"]


def _qkv_plain(x, g, b, w, bias, eps: float):
    return dense(layer_norm(x, g, b, eps, x.dtype), w, bias, x.dtype)


def fused_divided_attention_plain(x, g, b, w, bias, num_heads: int, num_frames: int,
                                  mode: str, eps: float):
    """The JAX _fused_attention_ref: LN -> dense -> packed divided attention;
    x (B, 1 + f*n, D) -> (B, 1 + f*n, D) before the projection."""
    return divided_attention_packed_plain(_qkv_plain(x, g, b, w, bias, eps), num_heads,
                                          num_frames, mode)


def fused_divided_attention(x, g, b, w, bias, num_heads: int, num_frames: int, mode: str,
                            eps: float = 1e-6, impl: str = "kernel"):
    """K8a: x (B, 1 + f*n, D) raw block input, LN params (D,) f32, w (3D, D)
    packed [q; k; v] rows in x's dtype, bias (3D,) f32 -> the divided
    attention (B, 1 + f*n, D) before the projection (no residual).
    Differentiable on both routes."""
    _build.use_kernel(x, impl)  # validates impl and device
    if impl == "plain":
        return fused_divided_attention_plain(x, g, b, w, bias, num_heads, num_frames, mode, eps)
    return FusedDividedAttentionFn.apply(x, g, b, w, bias, num_heads, num_frames, mode, eps)


class FusedDividedAttentionFn(torch.autograd.Function):
    """K8a forward; backward: plain LN + QKV recompute, K7c, then autograd
    through the recompute (the wrappers run their plain versions on CPU
    tensors)."""

    @staticmethod
    def forward(ctx, x, g, b, w, bias, num_heads: int, num_frames: int, mode: str, eps: float):
        ctx.save_for_backward(x, g, b, w, bias)
        ctx.args = (num_heads, num_frames, mode)
        ctx.eps = eps
        return _fused_attention(x, g, b, w, bias, num_heads, num_frames, mode, eps)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            qkv = _qkv_plain(*leaves, ctx.eps)
        dqkv = divided_attention_packed_bwd(qkv.detach(), grad.contiguous(), *ctx.args)
        wrt = [t for t, n in zip(leaves, needs) if n]
        got = iter(torch.autograd.grad(qkv, wrt, dqkv) if wrt else ())
        return tuple(next(got) if n else None for n in needs) + (None,) * 4


def _fused_attention(x, g, b, w, bias, num_heads: int, num_frames: int, mode: str, eps: float):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if not _build.use_kernel(x, "kernel"):
        return fused_divided_attention_plain(x, g, b, w, bias, num_heads, num_frames, mode, eps)
    _build.require_same_device("K8a", x, g, b, w, bias)
    _build.require(x.ndim == 3 and x.dtype == torch.bfloat16 and x.is_contiguous()
                   and x.data_ptr() % 16 == 0,
                   "K8a takes a contiguous, 16-byte aligned bf16 x (B, 1 + f*n, D)")
    bsz, seq, d = x.shape
    _build.require(w.shape == (3 * d, d) and w.dtype == torch.bfloat16 and w.is_contiguous(),
                   "K8a takes a contiguous bf16 w (3D, D)")
    check_ln_params("K8a", g, b, bias)
    _build.require(g.shape == b.shape == (d,) and bias.shape == (3 * d,), "K8a shape mismatch")
    # the GEMM reads the LN output (allocated like x): D % 64 (3D % 64), the row limit
    check_gemm("K8a", bsz * seq, w, bias, x)
    qkv = torch.empty((bsz, seq, 3 * d), dtype=x.dtype, device=x.device)
    _, f, n, _ = check_packed_qkv("K8a", qkv, num_heads, num_frames, mode)
    ln = torch.empty_like(x)
    out = torch.empty_like(x)
    fn = _build.library("fused_block", "sft_fused_divided_attention")
    _build.launches["K8a"] += 1
    _build.check(fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(),
                    ln.data_ptr(), qkv.data_ptr(), out.data_ptr(), bsz, f, n, num_heads,
                    d // num_heads, _MODES[mode], float(eps), _build.stream_ptr()),
                 "K8a fused_divided_attention")
    return out


def fused_mlp_residual_plain(x, g, b, w1, b1, w2, b2, eps: float):
    """The JAX _fused_mlp_ref with exact-erf GELU (K2's plain version without
    the statistics)."""
    return ln_mlp_residual_plain(x, g, b, w1, b1, w2, b2, eps)


def fused_mlp_residual(x, g, b, w1, b1, w2, b2, eps: float = 1e-6, impl: str = "kernel"):
    """K8b: x + fc2(GELU(fc1(LN(x)))); weights (out, in) in x's dtype, LN
    params and biases f32. Differentiable on both routes."""
    _build.use_kernel(x, impl)  # validates impl and device
    if impl == "plain":
        return fused_mlp_residual_plain(x, g, b, w1, b1, w2, b2, eps)
    return FusedMlpFn.apply(x, g, b, w1, b1, w2, b2, eps)


class FusedMlpFn(torch.autograd.Function):
    """K8b forward; backward through the plain version."""

    @staticmethod
    def forward(ctx, x, g, b, w1, b1, w2, b2, eps: float):
        ctx.save_for_backward(x, g, b, w1, b1, w2, b2)
        ctx.eps = eps
        return _fused_mlp(x, g, b, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(lambda *a: fused_mlp_residual_plain(*a, ctx.eps), ctx.saved_tensors,
                         ctx.needs_input_grad[:7], (grad,)) + (None,)


def _fused_mlp(x, g, b, w1, b1, w2, b2, eps: float):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if not _build.use_kernel(x, "kernel"):
        return fused_mlp_residual_plain(x, g, b, w1, b1, w2, b2, eps)
    return ln_mlp_kernel("K8b", x, g, b, w1, b1, w2, b2, eps, poly=True)
