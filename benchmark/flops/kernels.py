"""Bytes and FLOPs of the functions the port's kernel wrappers compute, from
the shapes of a call, and the bound they set on one NVIDIA H100.

A frozen copy of chip_smoke.py's ``bound``, ``attention_flops`` and
``k4_cost`` and of its per-kernel (bytes, FLOPs) records (the PERF.md
"Bound ms" column). Every input byte is counted read once and every output
byte written once, whatever the kernel reads again; a matrix product is 2
FLOPs a multiply-add. The same work is counted whatever implements it.

``WRAPPERS`` names, per launch key of the port's counter
(``synchformer_tpu_torch.ops.kernels._build.launches``) that the cells'
paths launch (K1-K6), the function that enqueues that kernel on a CUDA
tensor, and the cost of one call from its arguments. The tracer times each
of these calls with CUDA events; a key whose function the program no
longer has is skipped.
"""
from __future__ import annotations

from benchmark.flops.peaks import BF16_FLOPS, HBM_BPS

BF16 = 2  # bytes
F32 = 4


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the FLOPs at the dense bf16 rate, in seconds."""
    return max(nbytes / HBM_BPS, flops / BF16_FLOPS)


def attention_flops(b: int, mode: str, matmuls: int, h: int, dh: int, f: int, n: int) -> float:
    """Divided attention over b segments: per head, every group's L queries
    against its L + 1 keys and the CLS query against 1 + f*n keys,
    ``matmuls`` (L x (L+1) x dh) products of 2 FLOPs a MAC (2 forward, 5
    backward)."""
    groups, length = (f, n) if mode == "space" else (n, f)
    per_head = groups * length * (length + 1) + f * n + 1
    return 2.0 * matmuls * b * h * per_head * dh


def k4_cost(groups: int, m: int, d: int, heads: int, hid: int):
    """(bytes, FLOPs) of the CLS-pool layer over groups of m rows with one
    shared query: q and U = Wk^T q once; per group the logits and the
    p-weighted sum over m + 1 rows per head, Wv, proj and the MLP; x, the
    weights and the output moved once."""
    flops = 4.0 * d * d + groups * (4.0 * heads * (m + 1) * d + 4.0 * d * d + 4.0 * d * hid)
    nbytes = (groups * m * d * BF16 + (4 * d * d + 2 * d * hid) * BF16 + (9 * d + hid) * F32
              + groups * d * BF16)
    return nbytes, flops


def _arg(args, kwargs, i, name):
    return kwargs[name] if name in kwargs else args[i]


def k1_cost(args, kwargs):
    """_divided_attention_proj(qkv_patches, qkv_cls, res_patches, wo, bo,
    num_heads, mode): the attention, the patches' projection and residual."""
    qkv_p, num_heads, mode = args[0], _arg(args, kwargs, 5, "num_heads"), _arg(args, kwargs, 6,
                                                                               "mode")
    b, f, n, threed = qkv_p.shape
    d = threed // 3
    act = b * f * n * d * BF16
    nbytes = 5 * act + d * d * BF16 + d * F32 + b * 3 * d * BF16 + b * d * BF16
    flops = attention_flops(b, mode, 2, num_heads, d // num_heads, f, n) + 2.0 * b * f * n * d * d
    return nbytes, flops


def k2_cost(args, kwargs):
    """ln_mlp_kernel(what, x, g, b, w1, b1, w2, b2, eps, emit_stats, poly):
    LayerNorm, fc1, GELU, fc2 and the residual over every row."""
    x, w1 = args[1], args[4]
    emit = _arg(args, kwargs, 9, "emit_stats") if len(args) > 9 or "emit_stats" in kwargs \
        else False
    d = x.shape[-1]
    hid = w1.shape[0]
    rows = x.numel() // d
    weights = 2 * d * hid * BF16 + (hid + 3 * d) * F32
    nbytes = 2 * rows * d * BF16 + (rows * 8 * F32 if emit else 0) + weights
    return nbytes, 4.0 * rows * d * hid


def k3_cost(args, kwargs):
    """_standard_attention(qkv, num_heads): softmax attention of every row."""
    qkv, h = args[0], _arg(args, kwargs, 1, "num_heads")
    b, n, threed = qkv.shape
    d = threed // 3
    return b * n * 4 * d * BF16, 4.0 * b * h * n * n * (d // h)


def k4_call_cost(args, kwargs):
    """_cls_pool_tokens(x, cls, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1,
    w2, fb2, num_heads, eps)."""
    x, w1, h = args[0], args[10], _arg(args, kwargs, 14, "num_heads")
    groups, m, d = x.shape
    return k4_cost(groups, m, d, h, w1.shape[0])


def k5_cost(args, kwargs):
    """divided_attention(qkv_patches, qkv_cls, num_heads, mode)."""
    qkv_p, h, mode = args[0], _arg(args, kwargs, 2, "num_heads"), _arg(args, kwargs, 3, "mode")
    b, f, n, threed = qkv_p.shape
    d = threed // 3
    act = b * f * n * d * BF16
    return 4 * act + b * 4 * d * BF16, attention_flops(b, mode, 2, h, d // h, f, n)


def k6_cost(args, kwargs):
    """divided_attention_bwd(qkv_patches, qkv_cls, dop, doc, num_heads,
    mode): dq, dk, dv of every row."""
    qkv_p, h, mode = args[0], _arg(args, kwargs, 4, "num_heads"), _arg(args, kwargs, 5, "mode")
    b, f, n, threed = qkv_p.shape
    d = threed // 3
    act = b * f * n * d * BF16
    return 7 * act + b * 7 * d * BF16, attention_flops(b, mode, 5, h, d // h, f, n)


# launch key -> (module, function enqueuing it, cost of one call): the
# kernels the cells' paths launch
WRAPPERS = {
    "K1": ("synchformer_tpu_torch.ops.kernels.divided_attention", "_divided_attention_proj",
           k1_cost),
    "K2": ("synchformer_tpu_torch.ops.kernels.fused_rows", "ln_mlp_kernel", k2_cost),
    "K3": ("synchformer_tpu_torch.ops.kernels.standard_attention", "_standard_attention",
           k3_cost),
    "K4": ("synchformer_tpu_torch.ops.kernels.cls_pool", "_cls_pool_tokens", k4_call_cost),
    "K5": ("synchformer_tpu_torch.ops.kernels.divided_attention", "divided_attention", k5_cost),
    "K6": ("synchformer_tpu_torch.ops.kernels.divided_attention_bwd", "divided_attention_bwd",
           k6_cost),
}
