"""K6: backward of K5, the split-layout divided space-time attention; K7c:
the same backward on the packed layout; the autograd Functions that join each
forward to its backward.

K6 replaces synchformer_tpu/ops/pallas/divided_attention_bwd.py::
_divided_attention_bwd_4d (body _bwd_kernel_4d) with
csrc/divided_attention_bwd.cu, and _divided_attention_split_vjp with
``DividedAttentionFn``: the forward runs K5 and saves only its qkv inputs; the
backward recomputes the softmax inside K6, as the JAX custom VJP does.

K7c replaces _divided_attention_bwd_pallas (_space_bwd_kernel,
_time_bwd_kernel, _cls_row_bwd) with the same file's
``sft_divided_attention_packed_bwd`` entry, and _divided_attention_vjp
(:505-520, :644-652) with ``DividedAttentionPackedFn``: K7a/K7b forward
saving only qkv, K7c backward into one packed (B, 1 + f*n, 3D) dqkv, read and
written in place.

At non-groupable heads the JAX split-layout VJP (_bwd_split, :554-566)
concatenates into the packed layout and runs the packed kernel, because its
split kernel needs heads that pair into 128 lanes. The port's K6 takes every
head_dim that is a multiple of 8 up to 256 on the split layout, so
DividedAttentionFn needs no such copy: the layout and the kernel do not
depend on the head grouping here. Both passes take any frame count whose
rows of one head fit a block (_build.time_bwd_plan: 140 frames at head_dim
64).

Stage I shapes: qkv_patches (28, 8, 196, 2304), qkv_cls (28, 1, 2304),
cotangents (28, 8, 196, 768) and (28, 1, 768), bf16; packed qkv (28, 1569,
2304) and cotangent (28, 1569, 768). A call moves ~472 MB (qkv and cotangents
in, dqkv out), which bounds it at ~141 us on the H100. Space mode (n queries
over n + 1 keys per group) runs its products on the tensor cores, time mode
(f over f + 1) on CUDA cores; both stay well above that bound (PERF.md). The
CLS token's gradient, summed over every group in VMEM on the TPU, is reduced
here through f32 scratch in a fixed order (no atomics), so the gradient is
deterministic.
"""
from __future__ import annotations

import torch

from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels.divided_attention import (
    _MODES,
    check_packed_qkv,
    check_split_qkv,
    divided_attention,
    divided_attention_packed,
    divided_attention_packed_plain,
    divided_attention_plain,
)

__all__ = ["divided_attention_bwd", "divided_attention_bwd_plain", "DividedAttentionFn",
           "divided_attention_split", "divided_attention_packed_bwd",
           "divided_attention_packed_bwd_plain", "DividedAttentionPackedFn",
           "packed_divided_attention"]


def _scratch(b: int, num_heads: int, f: int, n: int, dh: int, mode: str, dev):
    """f32 scratch of the backward: ds and p of the CLS query over every
    patch, the CLS key's own dk / dv, its partial sums (a slot per block of
    the group pass over a segment: a frame in space mode, a tile of
    positions in time mode, from _build.time_bwd_plan), and the space
    pass's row statistics (m, 1/l, sigma, 0) of every query (None in time
    mode). The wrappers' checks (check_*_qkv with backward=True) have
    already refused a shape the plans do not take."""
    f32 = torch.float32
    fn = f * n
    if mode == "space":
        slots, stats = f, torch.empty((b, num_heads, fn, 4), dtype=f32, device=dev)
    else:
        slots, stats = _build.time_bwd_plan(f, n, num_heads * dh, num_heads)["blocks"], None
    ds_cls = torch.empty((b, num_heads, fn), dtype=f32, device=dev)
    return (ds_cls, torch.empty_like(ds_cls),
            torch.empty((b, num_heads, 2 * dh), dtype=f32, device=dev),
            torch.empty((b, num_heads, slots, 2 * dh), dtype=f32, device=dev), stats)


def divided_attention_bwd_plain(qkv_patches, qkv_cls, dop, doc, num_heads: int, mode: str):
    """(d qkv_patches, d qkv_cls) by autograd through divided_attention_plain."""
    with torch.enable_grad():
        qp = qkv_patches.detach().requires_grad_()
        qc = qkv_cls.detach().requires_grad_()
        out_p, out_c = divided_attention_plain(qp, qc, num_heads, mode)
        return torch.autograd.grad((out_p, out_c), (qp, qc), (dop, doc))


def divided_attention_bwd(qkv_patches, qkv_cls, dop, doc, num_heads: int, mode: str,
                          impl: str = "kernel"):
    """K6: (d qkv_patches (B, f, n, 3D), d qkv_cls (B, 1, 3D)) from the
    cotangents dop (B, f, n, D) and doc (B, 1, D) of K5's outputs."""
    if not _build.use_kernel(qkv_patches, impl):
        return divided_attention_bwd_plain(qkv_patches, qkv_cls, dop, doc, num_heads, mode)
    b, f, n, d = check_split_qkv("K6", qkv_patches, qkv_cls, num_heads, mode, dop, doc,
                                 backward=True)
    dh = d // num_heads
    _build.require(all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in (dop, doc))
                   and dop.shape == (b, f, n, d) and doc.shape == (b, 1, d),
                   "K6 takes contiguous bf16 cotangents of the forward's shape")
    scratch = _scratch(b, num_heads, f, n, dh, mode, qkv_patches.device)
    dqkv_p = torch.empty_like(qkv_patches)
    dqkv_c = torch.empty_like(qkv_cls)
    fn = _build.library("divided_attention_bwd")
    _build.launches["K6"] += 1
    _build.check(fn(qkv_patches.data_ptr(), qkv_cls.data_ptr(), dop.data_ptr(), doc.data_ptr(),
                    *map(_build.ptr, scratch), dqkv_p.data_ptr(), dqkv_c.data_ptr(),
                    b, f, n, num_heads, dh, _MODES[mode], _build.stream_ptr()),
                 "K6 divided_attention_bwd")
    return dqkv_p, dqkv_c


def divided_attention_packed_bwd_plain(qkv, dout, num_heads: int, num_frames: int,
                                       mode: str):
    """d qkv (B, 1 + f*n, 3D) by autograd through divided_attention_packed_plain."""
    with torch.enable_grad():
        q = qkv.detach().requires_grad_()
        out = divided_attention_packed_plain(q, num_heads, num_frames, mode)
        return torch.autograd.grad(out, q, dout)[0]


def divided_attention_packed_bwd(qkv, dout, num_heads: int, num_frames: int, mode: str,
                                 impl: str = "kernel"):
    """K7c: d qkv (B, 1 + f*n, 3D) from the cotangent dout (B, 1 + f*n, D) of
    K7a/K7b's output."""
    if not _build.use_kernel(qkv, impl):
        return divided_attention_packed_bwd_plain(qkv, dout, num_heads, num_frames, mode)
    b, f, n, d = check_packed_qkv("K7c", qkv, num_heads, num_frames, mode, dout,
                                  backward=True)
    dh = d // num_heads
    _build.require(dout.dtype == torch.bfloat16 and dout.is_contiguous()
                   and dout.shape == (b, 1 + f * n, d),
                   "K7c takes a contiguous bf16 cotangent of the forward's shape")
    scratch = _scratch(b, num_heads, f, n, dh, mode, qkv.device)
    dqkv = torch.empty_like(qkv)
    fn = _build.library("divided_attention_bwd", "sft_divided_attention_packed_bwd")
    _build.launches["K7c"] += 1
    _build.check(fn(qkv.data_ptr(), dout.data_ptr(), *map(_build.ptr, scratch),
                    dqkv.data_ptr(), b, f, n, num_heads, dh, _MODES[mode], _build.stream_ptr()),
                 "K7c divided_attention_packed_bwd")
    return dqkv


class DividedAttentionFn(torch.autograd.Function):
    """K5 forward, K6 backward (the wrappers run their plain versions on CPU
    tensors). Saves only the qkv inputs."""

    @staticmethod
    def forward(ctx, qkv_patches, qkv_cls, num_heads: int, mode: str):
        ctx.save_for_backward(qkv_patches, qkv_cls)
        ctx.num_heads, ctx.mode = num_heads, mode
        return divided_attention(qkv_patches, qkv_cls, num_heads, mode)

    @staticmethod
    def backward(ctx, gp, gc):
        qkv_patches, qkv_cls = ctx.saved_tensors
        dqp, dqc = divided_attention_bwd(qkv_patches, qkv_cls, gp.contiguous(),
                                         gc.contiguous(), ctx.num_heads, ctx.mode)
        return dqp, dqc, None, None


class DividedAttentionPackedFn(torch.autograd.Function):
    """K7a/K7b forward, K7c backward (the wrappers run their plain versions on
    CPU tensors). Saves only qkv."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, num_frames: int, mode: str):
        ctx.save_for_backward(qkv)
        ctx.args = (num_heads, num_frames, mode)
        return divided_attention_packed(qkv, num_heads, num_frames, mode)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return divided_attention_packed_bwd(qkv, g.contiguous(), *ctx.args), None, None, None


def divided_attention_split(qkv_patches, qkv_cls, num_heads: int, mode: str,
                            impl: str = "kernel"):
    """Differentiable split-layout divided attention (the JAX
    divided_attention_split): impl='kernel' through DividedAttentionFn,
    impl='plain' through autograd of the plain version."""
    _build.use_kernel(qkv_patches, impl)  # validates impl and device
    if impl == "plain":
        return divided_attention_plain(qkv_patches, qkv_cls, num_heads, mode)
    return DividedAttentionFn.apply(qkv_patches, qkv_cls, num_heads, mode)


def packed_divided_attention(qkv, num_heads: int, num_frames: int, mode: str,
                             impl: str = "kernel"):
    """Differentiable packed-layout divided attention (the JAX
    divided_attention of ops/pallas/divided_attention_bwd.py): impl='kernel'
    through DividedAttentionPackedFn, impl='plain' through autograd of the
    plain version."""
    _build.use_kernel(qkv, impl)  # validates impl and device
    if impl == "plain":
        return divided_attention_packed_plain(qkv, num_heads, num_frames, mode)
    return DividedAttentionPackedFn.apply(qkv, num_heads, num_frames, mode)
