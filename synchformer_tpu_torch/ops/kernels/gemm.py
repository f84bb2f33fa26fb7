"""The Hopper GEMM that K1's projection and K2's two MLP products run on
(csrc/wgmma_gemm.cuh), on its own entry (csrc/gemm.cu): C = epilogue(A @
W^T + bias) with bf16 operands, f32 accumulation and one of three epilogues,
each rounded as the JAX kernels round:
- "bias": bf16(acc + bias);
- "gelu": bf16(erf-GELU(acc + bias)) (K2's fc1);
- "residual": bf16(residual + bf16(acc + bias)) (K2's fc2, K1's projection).

No model path calls this entry: K1 and K2 reach the kernel from their own C
entries. It exists so that chip_smoke.py can hold the GEMM against its plain
version and time it beside one cuBLAS call at each caller's shape. The
launch plan and the shape checks live in ``_build`` (``gemm_plan``) and
``check_gemm``, which K1's and K2's wrappers share.
"""
from __future__ import annotations

import torch

from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.numerics import dense, exact_gelu

__all__ = ["gemm", "gemm_plain", "check_gemm", "EPILOGUES"]

EPILOGUES = {"bias": 0, "gelu": 1, "residual": 2}


def gemm_plain(a, w, bias, epilogue: str = "bias", residual=None):
    """The plain composition of K2's and K1's products: dense, then GELU or
    the residual."""
    y = dense(a, w, bias, a.dtype)
    if epilogue == "gelu":
        return exact_gelu(y)
    return residual + y if epilogue == "residual" else y


def check_gemm(what: str, rows: int, w, bias, *row_operands) -> dict:
    """The checks the Hopper GEMM needs before a launch over ``rows`` rows:
    w (N, K) contiguous bf16 and an f32 bias (N,), both 16-byte aligned (TMA
    and 16-byte loads); each of ``row_operands`` (A, the residual) a
    contiguous, 16-byte aligned bf16 tensor; N % 128 == 0, K % 64 == 0 and
    the row limit (gemm_plan). Returns gemm_plan's plan."""
    _build.require(w.ndim == 2 and w.dtype == torch.bfloat16 and w.is_contiguous()
                   and w.data_ptr() % 16 == 0,
                   f"{what}'s GEMM takes a contiguous, 16-byte aligned bf16 weight (N, K)")
    n, k = w.shape
    _build.require(bias.dtype == torch.float32 and bias.is_contiguous() and bias.shape == (n,)
                   and bias.data_ptr() % 16 == 0,
                   f"{what}'s GEMM takes a contiguous, 16-byte aligned f32 bias (N,)")
    _build.require(all(t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 16 == 0
                       for t in row_operands),
                   f"{what}'s GEMM reads its rows by TMA and 16-byte loads: contiguous, "
                   "16-byte aligned bf16 operands")
    return _build.gemm_plan(rows, n, k)


def gemm(a, w, bias, epilogue: str = "bias", residual=None, impl: str = "kernel"):
    """epilogue(a @ w^T + bias) over a's rows; w (N, K) bf16, bias f32; the
    residual (a's rows, N) for epilogue 'residual'. Forward only."""
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
    rows = a.numel() // k
    check_gemm("GEMM", rows, w, bias, a, *([residual] if residual is not None else []))
    out = torch.empty((*a.shape[:-1], n), dtype=a.dtype, device=a.device)
    fn = _build.library("gemm")
    _build.launches["GEMM"] += 1
    _build.check(fn(a.data_ptr(), w.data_ptr(), bias.data_ptr(), _build.ptr(residual), n,
                    out.data_ptr(), rows, n, k, EPILOGUES[epilogue], _build.stream_ptr()),
                 "GEMM")
    return out
