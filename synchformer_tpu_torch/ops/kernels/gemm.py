"""The Hopper GEMM that K1's projection, K2's two MLP products and the
fused route's products (K8a's QKV, K8b's fc1 and fc2, K8c) run on
(csrc/wgmma_gemm.cuh), on its own entry (csrc/gemm.cu): C = epilogue(A @
W^T + bias) with bf16 operands, f32 accumulation and one of four
epilogues, each rounded as the JAX kernels round:
- "bias": bf16(acc + bias) (K8a's QKV, K8c);
- "gelu": bf16(erf-GELU(acc + bias)) (K2's fc1);
- "gelu_poly": bf16(GELU(acc + bias)) with the TPU kernels' clamped
  degree-9 erf polynomial (K8b's fc1);
- "residual": bf16(residual + bf16(acc + bias)) (K2's and K8b's fc2, K1's
  projection).
The LayerNorm-fed products read the LayerNorm of x from a bf16 scratch
(csrc/tile_gemm.cuh::ln_rows).

No model path calls this entry: K1, K2 and K8a-K8c reach the kernel from
their own C entries. It takes any N and K (csrc/wgmma_gemm.cuh: TMA fills
the columns past K with zeros; past N, or at rows that are not 16-byte
aligned, its tail epilogue runs). It exists so that chip_smoke.py can hold the GEMM
against its plain version and time it beside one cuBLAS call at each
caller's shape. The launch plan and the shape checks live in ``_build``
(``gemm_plan``) and ``check_gemm``, which the kernels' wrappers share.
"""
from __future__ import annotations

import torch

from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.numerics import dense, exact_gelu

__all__ = ["gemm", "gemm_plain", "check_gemm", "gelu_poly", "EPILOGUES"]

EPILOGUES = {"bias": 0, "gelu": 1, "residual": 2, "gelu_poly": 3}

# erf(z) ~= z * P9(z^2) on |z| <= 3: the coefficients of
# synchformer_tpu/ops/pallas/fused_block.py::_ERF_POLY, lowest first, as the
# f32 constants of csrc/tile_gemm.cuh::gelu_poly
_ERF_POLY = tuple(float(torch.tensor(c, dtype=torch.float32)) for c in (
    1.1283768672322625, -0.37607043470191825, 0.11261191593609451, -0.026508097122118452,
    0.004930427932570047, -0.0007122925277970079, 7.619287512854014e-05,
    -5.581884377842221e-06, 2.462992635407088e-07, -4.884558793996662e-09))


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a * b + c on f32 tensors with one rounding, as a fused multiply-add:
    the product of two f32 values is exact in f64."""
    return (a.double() * b.double() + c).float()


def gelu_poly(x32: torch.Tensor) -> torch.Tensor:
    """The TPU kernels' GELU on an f32 tensor (_gelu_kernel_f32): x / 2 *
    (1 + erf(x / sqrt 2)) with erf the clamped degree-9 polynomial, Horner in
    f32 with the fused multiply-adds the CUDA compiler (and XLA) contract
    its steps into (csrc/tile_gemm.cuh::gelu_poly). Near the clamp the
    polynomial's terms cancel, so unfused steps differ by up to 5e-6 x
    max(|x|, 1)."""
    z = torch.clamp(x32 * float(torch.tensor(2.0 ** -0.5, dtype=torch.float32)), -3.0, 3.0)
    u = z * z
    p = torch.full_like(u, _ERF_POLY[-1])
    for c in _ERF_POLY[-2::-1]:
        p = _fma(p, u, c)
    return x32 * 0.5 * _fma(z, p, 1.0)


def gemm_plain(a, w, bias, epilogue: str = "bias", residual=None):
    """The plain composition of the kernels' products: dense, then GELU
    (exact, or the polynomial's in f32) or the residual."""
    if epilogue == "gelu_poly":
        # the kernel's order: f32 sums of the rounded operands, the bias in f32
        y = torch.matmul(a.float(), w.to(a.dtype).float().t()) + bias.float()
        return gelu_poly(y).to(a.dtype)
    y = dense(a, w, bias, a.dtype)
    if epilogue == "gelu":
        return exact_gelu(y)
    return residual + y if epilogue == "residual" else y


def check_gemm(what: str, rows: int, w, bias, *row_operands) -> dict:
    """The checks the Hopper GEMM needs before a launch over ``rows`` rows:
    w (N, K) bf16 whose rows TMA reads (a unit column stride, a row stride
    that is a multiple of 8 elements and at least K, 16-byte aligned) and a
    contiguous, 16-byte aligned f32 bias (N,); each of ``row_operands`` (A,
    the residual) a contiguous, 16-byte aligned bf16 tensor whose rows are a
    multiple of 8 elements; the row limit (gemm_plan). Any N and K. Returns
    gemm_plan's plan."""
    q = _build.WGMMA_LD_QUANTUM
    _build.require(w.ndim == 2 and w.dtype == torch.bfloat16 and w.stride(1) == 1
                   and w.stride(0) % q == 0 and w.stride(0) >= w.shape[1]
                   and w.data_ptr() % 16 == 0,
                   f"{what}'s GEMM reads its weight (N, K) by TMA: bf16 rows of a unit column "
                   f"stride at a 16-byte aligned pitch that is a multiple of {q}")
    n, k = w.shape
    _build.require(bias.dtype == torch.float32 and bias.is_contiguous() and bias.shape == (n,)
                   and bias.data_ptr() % 16 == 0,
                   f"{what}'s GEMM takes a contiguous, 16-byte aligned f32 bias (N,)")
    _build.require(all(t.dtype == torch.bfloat16 and t.is_contiguous() and t.shape[-1] % q == 0
                       and t.data_ptr() % 16 == 0 for t in row_operands),
                   f"{what}'s GEMM reads its rows by TMA and 16-byte loads: contiguous, "
                   f"16-byte aligned bf16 operands whose rows are a multiple of {q} elements")
    return _build.gemm_plan(rows, n, k)


def gemm(a, w, bias, epilogue: str = "bias", residual=None, impl: str = "kernel"):
    """epilogue(a @ w^T + bias) over a's rows; w (N, K) bf16, bias f32; the
    residual (a's rows, N) for epilogue 'residual'. Any N and K: a (M, K) and
    w may be row views of wider buffers whose pitch is a multiple of 8 (the
    way K2 holds an activation and a weight of a ragged hidden width); the
    residual is contiguous. Forward only."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {tuple(EPILOGUES)}, got {epilogue!r}")
    if (residual is None) != (epilogue != "residual"):
        raise ValueError("a residual goes with epilogue 'residual' and only with it")
    if not _build.use_kernel(a, impl):
        return gemm_plain(a, w, bias, epilogue, residual)
    _build.require_same_device("GEMM", a, w, bias, *([residual] if residual is not None else []))
    k, n = a.shape[-1], w.shape[0]
    _build.require(w.shape == (n, k) and (residual is None or residual.shape == (*a.shape[:-1], n)),
                   "GEMM takes a (..., K), w (N, K) and a residual (..., N)")
    a2 = a if a.ndim == 2 else a.reshape(-1, k)
    rows = a2.shape[0]
    q = _build.WGMMA_LD_QUANTUM
    _build.require(a2.dtype == torch.bfloat16 and a2.stride(1) == 1 and a2.stride(0) % q == 0
                   and a2.data_ptr() % 16 == 0,
                   f"GEMM reads a's rows by TMA: bf16 rows of a unit column stride at a "
                   f"16-byte aligned pitch that is a multiple of {q}")
    _build.require(residual is None or (residual.dtype == torch.bfloat16
                                        and residual.is_contiguous()
                                        and residual.data_ptr() % 16 == 0),
                   "GEMM takes a contiguous, 16-byte aligned bf16 residual")
    check_gemm("GEMM", rows, w, bias)
    out = torch.empty((*a.shape[:-1], n), dtype=a.dtype, device=a.device)
    fn = _build.library("gemm")
    _build.launches["GEMM"] += 1
    _build.check(fn(a2.data_ptr(), a2.stride(0), w.data_ptr(), w.stride(0), bias.data_ptr(),
                    _build.ptr(residual), n, out.data_ptr(), n, rows, n, k, EPILOGUES[epilogue],
                    _build.stream_ptr()),
                 "GEMM")
    return out
