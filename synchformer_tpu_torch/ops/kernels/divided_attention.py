"""K1: split-layout divided space-time attention with the output projection
and residual in the epilogue; K5: the same attention without them; K7a/K7b:
the same attention on the packed layout.

K1 replaces synchformer_tpu/ops/pallas/divided_attention.py::
divided_attention_proj_4d (body _kernel_4d_proj with _cls_row_4d,
_space_pair_v3, _time_pair_v3) with csrc/divided_attention.cu; K5 replaces
divided_attention_pallas_4d (body _kernel_4d) with the same file's
``sft_divided_attention`` entry. K5 is the forward of the Stage I training
step (its backward, K6, is in divided_attention_bwd.py); at Stage I's qkv
(28, 8, 196, 2304) it moves ~270 MB, which bounds it at ~81 us on the H100.
Every entry's space pass (a frame's n queries over [CLS; n] keys) runs on the
tensor cores (csrc/mma_attention.cuh, the TPU kernels' recipe: exp rounded to
bf16 unnormalised, the CLS key's term in f32, one division); the time pass
(f + 1 keys: csrc/divided_attention.cuh::time_attention_kernel, a block per
tile of spatial positions and segment, its keys and values staged once,
bound by memory) and the CLS row run on CUDA cores.

K7a replaces divided_attention_pallas (body _kernel, the v1 kernel the TPU
runs at heads that do not pair into 128 lanes) and K7b its v3 body
(_divided_attention_pallas_v3, groupable heads), both with the
``sft_divided_attention_packed`` entry: the same launches as K5 reading the
packed (B, 1 + f*n, 3D) qkv and writing the (B, 1 + f*n, D) output in place,
no copy into the split layout. The lane rule decides which row the launch
counts under (``heads_groupable``); the CUDA code is one. Main-path shape:
(28, 1569, 2304), 8 heads of 96, in the Stage I step of the 8-head video
tower (models/presets.py::build_avclip_8head).

Every kernel here takes head_dim in ``HEAD_DIMS`` (a template parameter of
the CUDA code); the CLS query of each head attends all 1 + f*n keys.

K1's main-path shapes (sync inference): qkv_patches (112, 8, 196, 2304), qkv_cls (112, 1, 2304),
res (112, 8, 196, 768), 12 heads of 64, bf16; space groups are frames (197
keys with the CLS), time groups are spatial positions (9 keys). The space call
is ~104 GFLOP of attention and the projection 207 GFLOP, both on the tensor
cores: the projection + residual on the Hopper GEMM (csrc/wgmma_gemm.cuh),
whose checks K1 takes (ops/kernels/gemm.py::check_gemm: D % 64 == 0,
16-byte aligned rows, up to 2^31 - 1 rows). The attention output passes through
a device-memory scratch before the projection, where the TPU kernel kept it in
VMEM. The CLS row's attention leaves un-projected: the caller projects it and
adds its residual (as synchformer_tpu/ops/pallas/divided_attention_bwd.py::
_divided_attention_proj_split_vjp does).
"""
from __future__ import annotations

import torch

from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels.gemm import check_gemm
from synchformer_tpu_torch.ops.numerics import dense

__all__ = ["divided_attention", "divided_attention_proj", "divided_attention_packed",
           "divided_attention_plain", "divided_attention_proj_plain",
           "divided_attention_packed_plain", "heads_groupable", "HEAD_DIMS"]

_MODES = {"space": 0, "time": 1}
# the head dims the CUDA kernels are instantiated for
HEAD_DIMS = (32, 64, 96, 128)


def heads_groupable(num_heads: int, dh: int) -> bool:
    """The JAX package's 128-lane rule (synchformer_tpu/models/motionformer.py
    :554-559, ops/pallas/divided_attention.py:611-615): heads pair into
    128-lane groups. True: the Motionformer takes the split flow and the
    packed kernel is the v3 body (K7b); False: the packed flow, v1 body (K7a)."""
    hpg = max(1, 128 // dh)
    return num_heads % hpg == 0 and (dh * hpg) % 128 == 0


def _attend(q, k, v):
    """q (..., Lq, H, dh), k/v (..., Lk, H, dh) -> (..., Lq, H, dh); f32
    logits and softmax, probabilities in the compute dtype."""
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float())
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("...hqk,...khd->...qhd", p, v)


def divided_attention_plain(qkv_patches, qkv_cls, num_heads: int, mode: str):
    """The XLA DividedAttention math (synchformer_tpu/models/motionformer.py
    :200-251) on the split layout. Returns (patches (B, f, n, D), cls
    (B, 1, D)) before the projection."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'space' or 'time', got {mode!r}")
    b, f, n, threed = qkv_patches.shape
    d = threed // 3
    dh = d // num_heads
    qp, kp, vp = (t.reshape(b, f, n, num_heads, dh)
                  for t in qkv_patches.split(d, dim=-1))
    qc, kc, vc = (t.reshape(b, 1, num_heads, dh) for t in qkv_cls.split(d, dim=-1))
    qp, qc = qp * (dh ** -0.5), qc * (dh ** -0.5)

    keys = torch.cat([kc, kp.reshape(b, f * n, num_heads, dh)], dim=1)
    vals = torch.cat([vc, vp.reshape(b, f * n, num_heads, dh)], dim=1)
    out_c = _attend(qc, keys, vals).reshape(b, 1, d)

    if mode == "time":  # groups are spatial positions
        qp, kp, vp = (t.transpose(1, 2) for t in (qp, kp, vp))
    g = qp.shape[1]
    kg = torch.cat([kc[:, None].expand(b, g, 1, num_heads, dh), kp], dim=2)
    vg = torch.cat([vc[:, None].expand(b, g, 1, num_heads, dh), vp], dim=2)
    out_p = _attend(qp, kg, vg)
    if mode == "time":
        out_p = out_p.transpose(1, 2)
    return out_p.reshape(b, f, n, d), out_c


def divided_attention_packed_plain(qkv, num_heads: int, num_frames: int, mode: str):
    """The XLA DividedAttention math on the packed layout, without the
    keep-mask: qkv (B, 1 + f*n, 3D), tokens [CLS, frame-major patches] ->
    (B, 1 + f*n, D) before the projection."""
    b, seq, threed = qkv.shape
    n = (seq - 1) // num_frames
    out_p, out_c = divided_attention_plain(qkv[:, 1:].reshape(b, num_frames, n, threed),
                                           qkv[:, :1], num_heads, mode)
    return torch.cat([out_c, out_p.reshape(b, seq - 1, -1)], dim=1)


def divided_attention_proj_plain(qkv_patches, qkv_cls, res_patches, wo, bo,
                                 num_heads: int, mode: str):
    attn_p, attn_c = divided_attention_plain(qkv_patches, qkv_cls, num_heads, mode)
    return res_patches + dense(attn_p, wo, bo, res_patches.dtype), attn_c


def _check_heads(what: str, d: int, num_heads: int, mode: str, b: int, f: int, n: int) -> int:
    """The checks every divided-attention kernel makes on its shape: head_dim
    in HEAD_DIMS and the limits of its grids (segments, frames and patches on
    grid dimensions of at most 65535; in time mode the staged rows of one
    position tile within a block's shared memory, _build.time_pass_plan).
    Returns head_dim. A GEMM a caller runs besides (K1's projection, K8a's
    QKV) checks its own rows."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'space' or 'time', got {mode!r}")
    dh = d // num_heads
    _build.require(dh * num_heads == d and dh in HEAD_DIMS,
                   f"{what} takes head_dim in {HEAD_DIMS}, got D={d} over {num_heads} heads")
    _build.require(0 < b <= 65535 and 0 < f <= 65535 and 0 < n <= 65535,
                   f"{what} shape out of range")
    if mode == "time":
        _build.time_pass_plan(f, n, d)
    return dh


def check_split_qkv(what: str, qkv_patches, qkv_cls, num_heads: int, mode: str,
                    *others: torch.Tensor):
    """The checks every split-layout kernel (K1, K5, K6) makes before it
    launches: contiguous bf16 qkv on one device, head_dim in HEAD_DIMS, grid
    ranges. Returns (b, f, n, d)."""
    _build.require_same_device(what, qkv_patches, qkv_cls, *others)
    _build.require(qkv_patches.ndim == 4, f"{what} takes qkv_patches (B, f, n, 3D)")
    b, f, n, threed = qkv_patches.shape
    d = threed // 3
    _build.require(all(t.dtype == torch.bfloat16 and t.is_contiguous()
                       for t in (qkv_patches, qkv_cls)),
                   f"{what} takes contiguous bf16 qkv")
    _build.require(qkv_cls.shape == (b, 1, threed), f"{what}: qkv_cls shape mismatch")
    _build.require(qkv_patches.data_ptr() % 16 == 0 and qkv_cls.data_ptr() % 16 == 0,
                   f"{what} reads qkv rows with 16-byte loads: 16-byte aligned qkv")
    _check_heads(what, d, num_heads, mode, b, f, n)
    return b, f, n, d


def check_packed_qkv(what: str, qkv, num_heads: int, num_frames: int, mode: str,
                     *others: torch.Tensor):
    """The checks every packed-layout kernel (K7a/b, K7c) makes before it
    launches: contiguous bf16 qkv (B, 1 + f*n, 3D) on one device, head_dim in
    HEAD_DIMS, grid ranges. Returns (b, f, n, d)."""
    _build.require_same_device(what, qkv, *others)
    _build.require(qkv.ndim == 3 and qkv.dtype == torch.bfloat16 and qkv.is_contiguous(),
                   f"{what} takes a contiguous bf16 qkv (B, 1 + f*n, 3D)")
    b, seq, threed = qkv.shape
    f = num_frames
    _build.require(f > 0 and seq > 1 and (seq - 1) % f == 0,
                   f"{what}: sequence {seq} is not 1 + {f} frames x n patches")
    n = (seq - 1) // f
    d = threed // 3
    _build.require(qkv.data_ptr() % 16 == 0,
                   f"{what} reads qkv rows with 16-byte loads: 16-byte aligned qkv")
    _check_heads(what, d, num_heads, mode, b, f, n)
    return b, f, n, d


def divided_attention(qkv_patches, qkv_cls, num_heads: int, mode: str,
                      impl: str = "kernel"):
    """K5: (patches (B, f, n, D), cls (B, 1, D)) attention outputs in
    head-major feature order, before the projection. Forward only; the
    differentiable form is divided_attention_bwd.divided_attention_split."""
    if not _build.use_kernel(qkv_patches, impl):
        return divided_attention_plain(qkv_patches, qkv_cls, num_heads, mode)
    b, f, n, d = check_split_qkv("K5", qkv_patches, qkv_cls, num_heads, mode)
    out_p = torch.empty((b, f, n, d), dtype=torch.bfloat16, device=qkv_patches.device)
    out_c = torch.empty((b, 1, d), dtype=torch.bfloat16, device=qkv_patches.device)
    fn = _build.library("divided_attention", "sft_divided_attention")
    _build.launches["K5"] += 1
    _build.check(fn(qkv_patches.data_ptr(), qkv_cls.data_ptr(), out_p.data_ptr(),
                    out_c.data_ptr(), b, f, n, num_heads, d // num_heads, _MODES[mode],
                    _build.stream_ptr()), "K5 divided_attention")
    return out_p, out_c


def divided_attention_packed(qkv, num_heads: int, num_frames: int, mode: str,
                             impl: str = "kernel"):
    """K7a / K7b: packed divided attention, qkv (B, 1 + f*n, 3D) -> (B,
    1 + f*n, D) in head-major feature order, before the projection (the JAX
    divided_attention_pallas). Forward only; the differentiable form is
    divided_attention_bwd.packed_divided_attention."""
    if not _build.use_kernel(qkv, impl):
        return divided_attention_packed_plain(qkv, num_heads, num_frames, mode)
    b, f, n, d = check_packed_qkv("K7", qkv, num_heads, num_frames, mode)
    dh = d // num_heads
    out = torch.empty((b, 1 + f * n, d), dtype=torch.bfloat16, device=qkv.device)
    fn = _build.library("divided_attention", "sft_divided_attention_packed")
    key = "K7b" if heads_groupable(num_heads, dh) else "K7a"
    _build.launches[key] += 1
    _build.check(fn(qkv.data_ptr(), out.data_ptr(), b, f, n, num_heads, dh, _MODES[mode],
                    _build.stream_ptr()), f"{key} divided_attention_packed")
    return out


def divided_attention_proj(qkv_patches, qkv_cls, res_patches, wo, bo,
                           num_heads: int, mode: str, impl: str = "kernel"):
    """K1: returns (res + attn_patches @ wo^T + bo, raw CLS attention
    (B, 1, D)). wo (D, D) bf16 (out, in); bo f32."""
    _build.use_kernel(qkv_patches, impl)  # validates impl and device
    if impl == "plain":
        return divided_attention_proj_plain(qkv_patches, qkv_cls, res_patches, wo,
                                            bo, num_heads, mode)
    return _divided_attention_proj(qkv_patches, qkv_cls, res_patches, wo, bo, num_heads, mode)


def _divided_attention_proj(qkv_patches, qkv_cls, res_patches, wo, bo, num_heads: int,
                            mode: str):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if not _build.use_kernel(qkv_patches, "kernel"):
        return divided_attention_proj_plain(qkv_patches, qkv_cls, res_patches, wo,
                                            bo, num_heads, mode)
    b, f, n, d = check_split_qkv("K1", qkv_patches, qkv_cls, num_heads, mode,
                                 res_patches, wo, bo)
    _build.require(res_patches.shape == (b, f, n, d) and wo.shape == (d, d),
                   "K1 shape mismatch")
    check_gemm("K1", b * f * n, wo, bo, res_patches)
    scratch = torch.empty_like(res_patches)
    out_p = torch.empty_like(res_patches)
    out_c = torch.empty((b, 1, d), dtype=torch.bfloat16, device=qkv_patches.device)
    fn = _build.library("divided_attention")
    _build.launches["K1"] += 1
    _build.check(fn(qkv_patches.data_ptr(), qkv_cls.data_ptr(), res_patches.data_ptr(),
                    wo.data_ptr(), bo.data_ptr(), scratch.data_ptr(), out_p.data_ptr(),
                    out_c.data_ptr(), b, f, n, num_heads, d // num_heads, _MODES[mode],
                    _build.stream_ptr()), "K1 divided_attention_proj")
    return out_p, out_c
