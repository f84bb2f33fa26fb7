"""K6: backward of K5, the split-layout divided space-time attention, and the
autograd Function that joins the two.

Replaces synchformer_tpu/ops/pallas/divided_attention_bwd.py::
_divided_attention_bwd_4d (body _bwd_kernel_4d) with
csrc/divided_attention_bwd.cu, and _divided_attention_split_vjp with
``DividedAttentionFn``: the forward runs K5 and saves only its qkv inputs; the
backward recomputes the softmax inside K6, as the JAX custom VJP does.

Stage I shapes: qkv_patches (28, 8, 196, 2304), qkv_cls (28, 1, 2304),
cotangents (28, 8, 196, 768) and (28, 1, 768), bf16. The call moves ~472 MB
(qkv and cotangents in, dqkv out), which bounds it at ~141 us on the H100.
Space mode (196 queries over 197 keys per group) runs its products on the
tensor cores, time mode (8 over 9) on CUDA cores; both stay well above that
bound (PERF.md). The CLS token's gradient, summed over every group in VMEM on
the TPU, is reduced here through f32 scratch in a fixed order (no atomics),
so the gradient is deterministic.
"""
from __future__ import annotations

import torch

from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels.divided_attention import (
    _MODES,
    check_split_qkv,
    divided_attention,
    divided_attention_plain,
)

__all__ = ["divided_attention_bwd", "divided_attention_bwd_plain", "DividedAttentionFn",
           "divided_attention_split"]


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
    b, f, n, d = check_split_qkv("K6", qkv_patches, qkv_cls, num_heads, mode, dop, doc)
    _build.require(all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in (dop, doc)),
                   "K6 takes contiguous bf16 cotangents")
    _build.require(dop.shape == (b, f, n, d) and doc.shape == (b, 1, d),
                   "K6 cotangent shape mismatch")
    _build.require(mode == "time" or n <= 255, "K6 takes at most 255 patches per frame")
    groups = f if mode == "space" else n
    dev = qkv_patches.device
    f32 = torch.float32
    ds_cls = torch.empty((b, num_heads, f * n), dtype=f32, device=dev)
    p_cls = torch.empty_like(ds_cls)
    cls_part = torch.empty((b, num_heads, 128), dtype=f32, device=dev)
    # the CLS key's partial dk / dv: a slot per group at most (time mode packs
    # several groups a block and fills fewer)
    cls_part_g = torch.empty((b, num_heads, groups, 128), dtype=f32, device=dev)
    dqkv_p = torch.empty_like(qkv_patches)
    dqkv_c = torch.empty_like(qkv_cls)
    fn = _build.library("divided_attention_bwd")
    _build.launches["K6"] += 1
    _build.check(fn(qkv_patches.data_ptr(), qkv_cls.data_ptr(), dop.data_ptr(), doc.data_ptr(),
                    ds_cls.data_ptr(), p_cls.data_ptr(), cls_part.data_ptr(),
                    cls_part_g.data_ptr(), dqkv_p.data_ptr(), dqkv_c.data_ptr(), b, f, n,
                    num_heads, 64, _MODES[mode], _build.stream_ptr()),
                 "K6 divided_attention_bwd")
    return dqkv_p, dqkv_c


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


def divided_attention_split(qkv_patches, qkv_cls, num_heads: int, mode: str,
                            impl: str = "kernel"):
    """Differentiable split-layout divided attention (the JAX
    divided_attention_split): impl='kernel' through DividedAttentionFn,
    impl='plain' through autograd of the plain version."""
    _build.use_kernel(qkv_patches, impl)  # validates impl and device
    if impl == "plain":
        return divided_attention_plain(qkv_patches, qkv_cls, num_heads, mode)
    return DividedAttentionFn.apply(qkv_patches, qkv_cls, num_heads, mode)
