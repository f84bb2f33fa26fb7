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

Every kernel here takes any head_dim that is a multiple of 8 up to 256, as
the Pallas kernels take any head_dim: the CUDA code is built for the widths
of ``_build.ATTN_WIDTHS`` and runs a head_dim at the least one that holds it,
its columns past head_dim staged as zeros (csrc/mma_attention.cuh). The time
pass stages a group of heads a block, so the frames it takes depend on the
head width, not on D (``_build.time_pass_plan``). The CLS query of each head
attends all 1 + f*n keys, whose f32 logits one block holds in shared memory
(``_build.cls_row_smem``).

K1's main-path shapes (sync inference): qkv_patches (112, 8, 196, 2304), qkv_cls (112, 1, 2304),
res (112, 8, 196, 768), 12 heads of 64, bf16; space groups are frames (197
keys with the CLS), time groups are spatial positions (9 keys). The space call
is ~104 GFLOP of attention and the projection 207 GFLOP, both on the tensor
cores: the projection + residual on the Hopper GEMM (csrc/wgmma_gemm.cuh),
whose checks K1 takes (ops/kernels/gemm.py::check_gemm: 16-byte aligned
rows, up to 2^31 - 1 rows; a D that is not a multiple of 128 runs on its
tail epilogue). The attention output passes through
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
           "divided_attention_packed_plain", "heads_groupable"]

_MODES = {"space": 0, "time": 1}


def heads_groupable(num_heads: int, dh: int) -> bool:
    """The JAX package's 128-lane rule (synchformer_tpu/models/motionformer.py
    :554-559, ops/pallas/divided_attention.py:611-615): heads pair into
    128-lane groups. True: the Motionformer takes the split flow and the
    packed kernel is the v3 body (K7b); False: the packed flow, v1 body (K7a)."""
    hpg = max(1, 128 // dh)
    return num_heads % hpg == 0 and (dh * hpg) % 128 == 0


def _attend(q, k, v, keep=None):
    """q (..., Lq, H, dh), k/v (..., Lk, H, dh) -> (..., Lq, H, dh); f32
    logits and softmax, probabilities in the compute dtype. ``keep``
    (..., Lk) bool: the other keys' logits at the f32 minimum."""
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float())
    if keep is not None:
        logits = logits.masked_fill(~keep[..., None, None, :], torch.finfo(torch.float32).min)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("...hqk,...khd->...qhd", p, v)


def _split_keep(keep, f: int, n: int):
    """A token keep (B, 1 + f*n) -> (it as bool, the CLS's (B, 1), the
    patches' (B, f, n)); all None for no keep."""
    if keep is None:
        return None, None, None
    keep = keep.bool()
    return keep, keep[:, :1], keep[:, 1:].reshape(keep.shape[0], f, n)


def _group_attention(qp, kp, vp, kc, vc, mode: str, keep_c=None, keep_p=None):
    """The patch queries qp (B, f, n, H, dh), scaled, each group (a frame in
    'space', a spatial position in 'time') over [the CLS key kc / value vc
    (B, 1, H, dh); the group's patches kp / vp], keys masked by keep_c (B, 1)
    and keep_p (B, f, n) where given -> (B, f, n, H, dh)."""
    if mode == "time":  # groups are spatial positions
        qp, kp, vp = (t.transpose(1, 2) for t in (qp, kp, vp))
        keep_p = None if keep_p is None else keep_p.transpose(1, 2)
    b, g = qp.shape[:2]
    kg = torch.cat([kc[:, None].expand(b, g, *kc.shape[1:]), kp], dim=2)
    vg = torch.cat([vc[:, None].expand(b, g, *vc.shape[1:]), vp], dim=2)
    keep_g = None if keep_p is None else torch.cat([keep_c[:, None].expand(b, g, 1), keep_p],
                                                   dim=2)
    out = _attend(qp, kg, vg, keep_g)
    return out.transpose(1, 2) if mode == "time" else out


def divided_attention_plain(qkv_patches, qkv_cls, num_heads: int, mode: str, keep=None):
    """The XLA DividedAttention math (synchformer_tpu/models/motionformer.py
    :157-251) on the split layout. Returns (patches (B, f, n, D), cls
    (B, 1, D)) before the projection. ``keep`` (B, 1 + f*n), [CLS,
    frame-major patches], masks the keys: the CLS query attends to every
    kept token, each group to its kept patches and the CLS key."""
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
    keep, keep_c, keep_p = _split_keep(keep, f, n)
    out_c = _attend(qc, keys, vals, keep).reshape(b, 1, d)
    out_p = _group_attention(qp, kp, vp, kc, vc, mode, keep_c, keep_p)
    return out_p.reshape(b, f, n, d), out_c


def divided_attention_packed_plain(qkv, num_heads: int, num_frames: int, mode: str,
                                   keep=None):
    """divided_attention_plain on the packed layout: qkv (B, 1 + f*n, 3D),
    tokens [CLS, frame-major patches], keys masked by ``keep`` (B, 1 + f*n)
    where given -> (B, 1 + f*n, D) before the projection. The CLS query
    reads the packed keys in place (no concatenation)."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'space' or 'time', got {mode!r}")
    b, seq, threed = qkv.shape
    d = threed // 3
    dh = d // num_heads
    f = num_frames
    n = (seq - 1) // f
    q, k, v = (t.reshape(b, seq, num_heads, dh) for t in qkv.split(d, dim=-1))
    q = q * (dh ** -0.5)
    keep, keep_c, keep_p = _split_keep(keep, f, n)
    out_c = _attend(q[:, :1], k, v, keep)
    qp, kp, vp = (t[:, 1:].reshape(b, f, n, num_heads, dh) for t in (q, k, v))
    out_p = _group_attention(qp, kp, vp, k[:, :1], v[:, :1], mode, keep_c, keep_p)
    return torch.cat([out_c.reshape(b, 1, d), out_p.reshape(b, f * n, d)], dim=1)


def divided_attention_proj_plain(qkv_patches, qkv_cls, res_patches, wo, bo,
                                 num_heads: int, mode: str):
    attn_p, attn_c = divided_attention_plain(qkv_patches, qkv_cls, num_heads, mode)
    return res_patches + dense(attn_p, wo, bo, res_patches.dtype), attn_c


def _check_heads(what: str, d: int, num_heads: int, mode: str, b: int, f: int, n: int,
                 backward: bool = False) -> int:
    """The checks every divided-attention kernel makes on its shape: a
    head_dim that is a multiple of 8 up to 256 (_build.head_dim), the limits
    of its grids (segments, frames and patches on grid dimensions of at most
    65535), the CLS row's f32 logits of all 1 + f*n keys (two a key with
    ``backward``) within a block's shared memory, and in time mode one head's
    staged rows of f frames within it (_build.time_pass_plan, or
    time_bwd_plan with ``backward``). Returns head_dim. A GEMM a caller runs
    besides (K1's projection, K8a's QKV) checks its own rows."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'space' or 'time', got {mode!r}")
    dh = _build.head_dim(what, d, num_heads)
    _build.require(0 < b <= 65535 and 0 < f <= 65535 and 0 < n <= 65535,
                   f"{what} shape out of range")
    smem = _build.cls_row_smem(f * n, dh, backward)
    _build.require(smem <= _build.MAX_SMEM,
                   f"{what}: the CLS row holds the logits of 1 + {f} x {n} keys in "
                   f"{smem} bytes of shared memory, more than {_build.MAX_SMEM}")
    if mode == "time":
        (_build.time_bwd_plan if backward else _build.time_pass_plan)(f, n, d, num_heads)
    elif backward:
        _build.space_bwd_plan(n, dh)
    return dh


def check_split_qkv(what: str, qkv_patches, qkv_cls, num_heads: int, mode: str,
                    *others: torch.Tensor, backward: bool = False):
    """The checks every split-layout kernel (K1, K5, K6) makes before it
    launches: contiguous bf16 qkv on one device, _check_heads' head_dim,
    grid ranges and shared memory. Returns (b, f, n, d)."""
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
    _check_heads(what, d, num_heads, mode, b, f, n, backward)
    return b, f, n, d


def check_packed_qkv(what: str, qkv, num_heads: int, num_frames: int, mode: str,
                     *others: torch.Tensor, backward: bool = False):
    """The checks every packed-layout kernel (K7a/b, K7c, K8a) makes before
    it launches: contiguous bf16 qkv (B, 1 + f*n, 3D) on one device,
    _check_heads' head_dim, grid ranges and shared memory. Returns (b, f, n,
    d)."""
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
    _check_heads(what, d, num_heads, mode, b, f, n, backward)
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
