"""Show that chip_smoke.py's Stage I, packed-block, serving, MoCo and kernel
checks fail a wrong K1, K2, K4, K5, K6, K7a/K7b, K7c, K8a, K8b or K4b (and its
data-parallel, tensor-parallel and reference-checkpoint checks their planted
faults).

    python scripts/stage1_planted_faults.py            # full width, one NVIDIA GPU
    python scripts/stage1_planted_faults.py --tiny --device cpu   # a dry run

Takes the Stage I first step as chip_smoke.py's phases 4 and 6 do, once per
token flow: the split flow on build_avclip (K5 / K6) and the packed flow on
build_avclip_8head (K7a / K7c). Per flow: (c) f32 plain with remat and (b)
bf16 plain, then the bf16 kernel path once per planted fault, each from the
same seeded weights, batch and generator seed, and holds each kernel-path
step against (c) and (b) with chip_smoke.stage1_agreement. A fault is a
wrapper around a kernel's Python entry where DividedAttentionFn or
DividedAttentionPackedFn calls it; the code under test is not edited.
Split flow:
- none: the control, which must pass;
- k6_dk_zero: K6 returns a zero dk (patches and CLS);
- k6_cls_key_zero: K6 returns a zero dk and dv for the CLS key only;
- k6_mode_swapped: K6 runs the other mode's backward (space for time and back);
- k5_feature_order: K5 returns its outputs in dh-major feature order, not
  head-major.
Packed flow:
- none: the control;
- k7c_dk_zero: K7c returns a zero dk (patches and CLS);
- k7a_mode_swapped: K7a runs the other mode (space for time and back).
Packed flow on attn_impl='pallas_fused' (phase 7's step; the faults wrap the
entries of ops/kernels/fused_block.py, where FusedDividedAttentionFn and
FusedMlpFn call them):
- none: the control;
- k8a_dk_zero: the K7c call in K8a's backward returns a zero dk.
Then the packed flow's faults once more on chip_smoke.py's phase-5 packed
block (12 heads of 64: the same entry launches K7b there), held with
chip_smoke.packed_block_agreement; and these faults on phase 8's serving
check (chip_smoke.serving_agreement, the 8-head sync model on
attn_impl='pallas_fused') and, with k8b_residual_dropped and
k8a_ln_columns_swapped, on phase 2's K8a / K8b cases (chip_smoke.hold_outputs):
- k8a_mode_swapped: K8a runs the other mode;
- k8a_ln_skipped: K8a without its LayerNorm (the attention of x's own QKV);
- k8b_residual_dropped: K8b returns the MLP branch without the residual;
- k8a_ln_columns_swapped: K8a applies g / b to the wrong columns within each
  64-column span (8-column chunk j takes chunk j ^ 1's), what an indexing
  error in a LayerNorm that reads x in 16-byte chunks gives; phase 2's
  random g / b show it, where the serving checks' seeded LN (1 / 0) cannot.
Then the K4b faults (wrapping ops/kernels/cls_pool.py's _cls_pool, where
ClsPoolFn calls it) on phase 9's MoCo step (chip_smoke.moco_agreement) and on
phase 2's K4b cases (chip_smoke.hold_outputs):
- none: the control;
- k4b_shared_q: every group attends with group 0's query, the q and U that
  K4's shared-CLS prep would give (the plain composition with that query);
- k4b_residual_dropped: K4b's output without the CLS row's residual.
Then the K4 faults (wrapping _cls_pool_tokens, where ClsPoolTokensFn calls
it) on phase 2's checked K4 cases (chip_smoke.k4_cases: the MoCo step's
global aggregators, a time tail's groups, ragged rows, a part-filled last
block, guard bands, 8 heads of 96 ragged and in a guard band; and
chip_smoke.k4_legacy_cases: the legacy towers' pools at 8 heads of 128 and
of 64):
- none: the control;
- k4_cls_key_dropped: the shared CLS key's column is left out of the
  softmax (the plain composition over x's rows alone);
- k4_wv_head_shifted: head h's values take head h + 1's rows of Wv (for the
  tokens' Z and the CLS value alike), an indexing error in the Wv product.
Each kernel-case fault's line gives its margin: the error over the
tolerance of the failed case nearest to passing.
Then the faults of the two tensor-core attention kernels on phase 2's ragged
and guard-band cases (chip_smoke.ragged_cases, chip_smoke.hold_outputs), K3's
wrapping ops/kernels/standard_attention.py's _standard_attention (where
StandardAttentionFn calls it) and the space pass's wrapping the packed entry
where DividedAttentionPackedFn calls it:
- none: the control;
- k3_probs_unnormalised: K3's output scaled as if each row's softmax sum
  were 1 (the unnormalised exp(s - m) @ v);
- space_cls_key_dropped: the space pass's patch rows without the CLS key's
  f32 term (p_cls * v_cls left out).
Then the backward's faults confined to frames of more than 207 patches,
where its space pass stages the keys in a second 208-row chunk, on phase 2's
backward ragged cases (wrapping divided_attention_bwd and
divided_attention_packed_bwd where the two Functions call them):
- none: the control;
- k6_far_keys_dropped / k7c_far_keys_dropped: K6's / K7c's space pass leaves
  the keys past the first chunk out of the key-major part (their dk and dv
  zero).
Then the K1 and K2 faults (wrapping ops/kernels/divided_attention.py's
_divided_attention_proj, where divided_attention_proj calls it, and
ops/kernels/fused_rows.py's _ln_mlp, where LnMlpFn calls it) on phase 3's
sync inference (chip_smoke.serving_agreement on build_synchformer; the tiny
Synchformer at B=2, S=2 with --tiny) and on phase 2's K1 / K2 cases
(chip_smoke.k1_k2_cases, chip_smoke.hold_outputs; TINY_K12's size with
--tiny):
- none: the control;
- k1_mode_swapped: K1 runs the other mode's attention before the projection;
- k1_cls_key_dropped: K1's patch rows without the CLS key's term (p_cls *
  v_cls, projected) in their attention;
- k2_residual_dropped: K2 returns the MLP branch without the residual (and
  that branch's row statistics).
Then the K1 and K4 faults on phase 10's Stage II step (chip_smoke.sync_agreement:
the sync.yaml model through SyncTrainer, its towers from a Stage I
checkpoint of build_avclip, B=16, S=14; with --tiny the TINY towers, B=2,
S=2), where the frozen towers run the eval path: the control, and
k1_mode_swapped, k1_cls_key_dropped, k4_cls_key_dropped,
k4_wv_head_shifted as above; each line gives the margin of the update and
eval checks (error over tolerance).
Then the data-parallel faults on chip_smoke.py's phase 14 (c)
(chip_smoke.run_gloo_group: two ranks of a gloo group on the one card, each
case at world 2 held against world 1 over the same global batch). Each
fault is applied in both worker processes by apply_dp_fault before the
cases, and only on the case it concerns:
- none: the control, on every case (AVCLIP, MoCo, Stage II);
- dist_gather_local_grad: the InfoNCE's gather (parallel/dist.py
  _AllGatherWithGrad) returns this rank's part of the incoming gradient
  without the sum over ranks (AVCLIP);
- moco_keys_local: MoCo uses and enqueues this rank's keys only, not
  every rank's (models/moco_clip.py's all_gather_no_grad as the identity);
- sync_lr_unscaled: Stage II's learning rate is base_learning_rate, not x
  the number of ranks (stage_sync's make_lr_schedule given base / world).
``--only dp`` runs these alone.
Then the tensor-parallel faults on chip_smoke.py's phase 19
(chip_smoke.run_tensor_parallel: four ranks of a gloo group on the one card
as a (2 data x 2 model) grid), each applied in every worker by
apply_tp_fault before the cases, on the case it concerns:
- none: the control, on both cases (Stage II, AVCLIP);
- tp_clip_norm_local: the global-norm clip reads each rank's local shards
  only (train/state.py global_norm without its ``sharded`` marks), so that
  model peers clip differently (Stage II);
- tp_streams_by_rank: the trainers seed their generators by the global
  rank, not the data rank, so that model peers draw different numbers
  (Stage II);
- tp_lr_by_world: Stage II's rate is base_learning_rate x the world, not x
  n_data;
- tp_infonce_all_ranks: the InfoNCE gathers its negatives over every rank,
  model peers' duplicates included, not over the data group (AVCLIP);
- tp_ckpt_rank0_shards: state_dict and the optimizer's state hold each
  rank's shards, not whole tensors, so that rank 0 writes its own shards
  (Stage II).
``--only tp`` runs these alone.
Then the Stage I reader's fault on chip_smoke.py's phase 15 (c)
(chip_smoke.stage1_reference_check, ckpt_faults): the control, and
ast_pos_emb_untrimmed, a reader that keeps a reference file's 1214-token
AST position embedding. ``--only ckpt`` runs these alone.
Then the K4 faults (k4_cls_key_dropped, k4_wv_head_shifted and the control)
on chip_smoke.py's phase 16 (a), the legacy sync inference (S3D + ResNet-18
towers, whose spatial and frequency pools are K4 at (224, 49, 1024), 8 heads
of 128, and (336, 4, 512), 8 heads of 64), by serving_agreement over the
probabilities and both towers' features; phase 2's legacy K4 cases
(chip_smoke.k4_legacy_cases) are among the K4 kernel cases above.
``--only legacy`` runs these and the K4 kernel cases alone.
Then phase 17's faults (option_faults): on (a), the Stage I step with
every rate live and Linear projections (chip_smoke.stage1_agreement),
proj_dropout_skipped, the kernel route's Motionformer without the dropout
of its attention projections (its element dropouts skipped; the
positional dropout is 0 there); on (c), the sync model's partly masked
inference (chip_smoke.serving_agreement), mask_ignored, the masked divided
attention (ops/kernels/divided_attention.py::divided_attention_packed_plain
with a keep, the XLA composition models/motionformer.py runs under a
keep-mask) attending as if every token were kept. Each line gives its
margin (the largest error over its tolerance). ``--only options`` runs
these alone.
Then the faults of the shapes past the main path's (shape_faults) on phase
2's new cases (chip_smoke.shape_cases, chip_smoke.gemm_cases; each line
gives its margin):
- pad_lanes_unzeroed: the packed divided attention at head_dim 80 (run at
  width 96) with each head's 16 pad lanes holding the next head's first 16
  lanes instead of zeros (q rescaled so that only the lanes differ);
- k5_time_frames_dropped / k6_time_frames_dropped: the split time pass,
  forward and backward, over the first 27 frames only (the frames a block
  of all 12 heads once held at D = 768), the later frames' outputs zero;
- gemm_last_tile_dropped: the Hopper GEMM without its last column tile
  where N % 128 != 0 (N = 1996: columns 1920 to 1995 zero).
``--only shapes`` runs these alone.
Then the legacy towers' training faults (legacy_train_faults) on phase 20's
parts, each planted where models/conv.py or SyncTrainer calls it (and in
phase 20 (c)'s workers through the hook); each line gives its margins:
- none: the control, on every part;
- bn_unbiased_running_var: the running var updated with the unbiased batch
  variance, var * N / (N - 1), as torch's batch_norm keeps it (caught by
  (a)'s flax_bn_check);
- bn_torch_momentum: torch's momentum (S3D 0.001, ResNet-18 0.1) taken as
  flax's weight of the old value ((a)'s flax_bn_check);
- bn_local_stats_over_ranks: each rank's statistics of its own rows, not
  summed over the data group ((c): world 2 off world 1, the ranks' running
  statistics apart);
- bn_two_pass_var: a two-pass variance E[(x - E[x])^2] in place of flax's
  one-pass E[x^2] - E[x]^2 (chip_smoke.bn_unit_check's near-constant
  channel; tests/test_torch_legacy_train.py case (i) on the CPU);
- bn_stats_not_checkpointed: SyncTrainer's checkpoint payload without the
  towers' running statistics ((d): the resumed third step differs).
``--only legacy_train`` runs these alone.
Prints one line per fault with the checks that failed, and exits non-zero
unless each control passed and every fault failed at least one check.
--tiny takes the CPU tests' tiny AVCLIPs (build_tiny_avclip and
build_tiny_avclip_packed, drop-path 0.2) and tiny MoCo model
(build_tiny_moco_avclip, drop-path 0.2) at B=2, S=2, a block of TINY_BLOCK's
size, the tiny Synchformer with TINY_PACKED's towers and phase 2's K8, K4b and
K4 cases at TINY_K8's, TINY_K4B's and TINY_K4's sizes and the ragged cases at TINY_RAGGED's: on CPU tensors the kernel wrappers
run their plain versions, which the faults wrap all the same.
"""
from __future__ import annotations

import argparse
import functools
import gc
import os
import shutil
import sys
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from synchformer_tpu_torch.infer import SyncPredictor  # noqa: E402
from synchformer_tpu_torch.models import motionformer as tmf  # noqa: E402
from synchformer_tpu_torch.models.presets import (  # noqa: E402
    TINY,
    TINY_PACKED,
    build_avclip,
    build_avclip_8head,
    build_moco_avclip,
    build_synchformer,
    build_synchformer_8head,
    build_tiny_avclip,
    build_tiny_avclip_packed,
    build_tiny_moco_avclip,
    build_tiny_synchformer,
)
from synchformer_tpu_torch.ops.kernels import _build  # noqa: E402
from synchformer_tpu_torch.ops.kernels import cls_pool as tcls  # noqa: E402
from synchformer_tpu_torch.ops.kernels import divided_attention as tda  # noqa: E402
from synchformer_tpu_torch.ops.kernels import divided_attention_bwd as dab  # noqa: E402
from synchformer_tpu_torch.ops.kernels import fused_block as fb  # noqa: E402
from synchformer_tpu_torch.ops.kernels import fused_rows as frows  # noqa: E402
from synchformer_tpu_torch.ops.kernels import gemm as kgemm  # noqa: E402
from synchformer_tpu_torch.ops.kernels import standard_attention as tsa  # noqa: E402
from synchformer_tpu_torch.ops.kernels.divided_attention import (  # noqa: E402
    divided_attention_packed,
)
from synchformer_tpu_torch.ops.numerics import dense, exact_gelu, layer_norm  # noqa: E402
from synchformer_tpu_torch.utils.convert import (  # noqa: E402
    load_numpy_state_dict,
    seeded_state_dict,
)


def head_minor(t, num_heads):
    """(..., H*dh) head-major features reordered dh-major."""
    return t.unflatten(-1, (num_heads, -1)).transpose(-1, -2).flatten(-2).contiguous()


def k6_dk_zero(fwd, bwd, qkv_p, qkv_c, dop, doc, num_heads, mode):
    dqp, dqc = bwd(qkv_p, qkv_c, dop, doc, num_heads, mode)
    d = dop.shape[-1]
    dqp[..., d:2 * d] = 0
    dqc[..., d:2 * d] = 0
    return dqp, dqc


def k6_cls_key_zero(fwd, bwd, qkv_p, qkv_c, dop, doc, num_heads, mode):
    dqp, dqc = bwd(qkv_p, qkv_c, dop, doc, num_heads, mode)
    dqc[..., dop.shape[-1]:] = 0
    return dqp, dqc


def k6_mode_swapped(fwd, bwd, qkv_p, qkv_c, dop, doc, num_heads, mode):
    return bwd(qkv_p, qkv_c, dop, doc, num_heads, "time" if mode == "space" else "space")


def k5_feature_order(fwd, bwd, qkv_p, qkv_c, num_heads, mode):
    return tuple(head_minor(t, num_heads) for t in fwd(qkv_p, qkv_c, num_heads, mode))


def k7c_dk_zero(fwd, bwd, qkv, dout, num_heads, num_frames, mode):
    dqkv = bwd(qkv, dout, num_heads, num_frames, mode)
    d = dout.shape[-1]
    dqkv[..., d:2 * d] = 0
    return dqkv


def k7a_mode_swapped(fwd, bwd, qkv, num_heads, num_frames, mode):
    return fwd(qkv, num_heads, num_frames, "time" if mode == "space" else "space")


# the keys of a frame that the backward's space pass stages in its second
# chunk: key j >= 16 * BWD_SPACE_CHUNK_TILES, patch j - 1 (key 0 is the CLS row)
FAR_PATCH = 16 * _build.BWD_SPACE_CHUNK_TILES - 1


def k6_far_keys_dropped(bwd, packed_bwd, qkv_p, qkv_c, dop, doc, num_heads, mode):
    dqp, dqc = bwd(qkv_p, qkv_c, dop, doc, num_heads, mode)
    if mode == "space":
        dqp[:, :, FAR_PATCH:, dop.shape[-1]:] = 0
    return dqp, dqc


def k7c_far_keys_dropped(bwd, packed_bwd, qkv, dout, num_heads, num_frames, mode):
    dqkv = packed_bwd(qkv, dout, num_heads, num_frames, mode)
    if mode == "space":
        b, seq, d = dout.shape
        patches = dqkv[:, 1:].view(b, num_frames, (seq - 1) // num_frames, 3 * d)
        patches[:, :, FAR_PATCH:, d:] = 0
    return dqkv


def k8a_dk_zero(attn, bwd, mlp, qkv, dout, num_heads, num_frames, mode):
    return k7c_dk_zero(None, bwd, qkv, dout, num_heads, num_frames, mode)


def k8a_mode_swapped(attn, bwd, mlp, x, g, b, w, bias, num_heads, num_frames, mode, eps):
    return attn(x, g, b, w, bias, num_heads, num_frames, "time" if mode == "space" else "space",
                eps)


def k8a_ln_skipped(attn, bwd, mlp, x, g, b, w, bias, num_heads, num_frames, mode, eps):
    return divided_attention_packed(dense(x, w, bias, x.dtype).contiguous(), num_heads,
                                    num_frames, mode)


def k8b_residual_dropped(attn, bwd, mlp, x, *args):
    return mlp(x, *args) - x


def k8a_ln_columns_swapped(attn, bwd, mlp, x, g, b, w, bias, num_heads, num_frames, mode, eps):
    col = torch.arange(g.numel(), device=g.device)
    swapped = col // 64 * 64 + (col % 64 // 8 ^ 1) * 8 + col % 8
    swapped = torch.where(swapped < g.numel(), swapped, col)
    return attn(x, g[swapped].contiguous(), b[swapped].contiguous(), w, bias, num_heads,
                num_frames, mode, eps)


def k4b_shared_q(fwd, x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1, w2, fb2, num_heads,
                 eps):
    bsz, n, d = x.shape
    dtype, dh = x.dtype, d // num_heads
    ln = layer_norm(x, g1, b1, eps, dtype)
    q = dense(ln[:1, :1], wqkv[:d], bqkv[:d], dtype).reshape(1, 1, num_heads, dh)
    k, v = dense(ln, wqkv[d:], bqkv[d:], dtype).reshape(bsz, n, 2, num_heads, dh).unbind(2)
    logits = torch.einsum("bqhd,bnhd->bhqn", q.float().expand(bsz, -1, -1, -1), k.float())
    p = torch.softmax(logits * dh ** -0.5, dim=-1).to(dtype)
    att = dense(torch.einsum("bhqn,bnhd->bqhd", p, v).reshape(bsz, 1, d), wp, bp, dtype)[:, 0]
    y = x[:, 0] + att
    h = exact_gelu(dense(layer_norm(y, g2, b2, eps, dtype), w1, fb1, dtype))
    return y + dense(h, w2, fb2, dtype)


def k4b_residual_dropped(fwd, x, *args):
    return fwd(x, *args) - x[:, 0]


def k4_cls_key_dropped(fwd, x, cls, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1, w2, fb2,
                       num_heads, eps):
    bsz, m, d = x.shape
    dtype, dh = x.dtype, d // num_heads
    c = cls.reshape(1, 1, d).to(dtype)
    q = dense(layer_norm(c, g1, b1, eps, dtype), wqkv[:d], bqkv[:d], dtype)
    kv = dense(layer_norm(x, g1, b1, eps, dtype), wqkv[d:], bqkv[d:], dtype)
    k, v = kv.reshape(bsz, m, 2, num_heads, dh).unbind(2)
    logits = torch.einsum("qhd,bnhd->bhn", q.reshape(1, num_heads, dh).float(), k.float())
    p = torch.softmax(logits * dh ** -0.5, dim=-1).to(dtype)  # over x's rows alone
    att = dense(torch.einsum("bhn,bnhd->bhd", p, v).reshape(bsz, d), wp, bp, dtype)
    y = c.reshape(1, d) + att
    h = exact_gelu(dense(layer_norm(y, g2, b2, eps, dtype), w1, fb1, dtype))
    return y + dense(h, w2, fb2, dtype)


def k4_wv_head_shifted(fwd, x, cls, g1, b1, wqkv, bqkv, *args):
    d = x.shape[-1]
    dh = d // args[-2]
    wv = torch.roll(wqkv[2 * d:], -dh, dims=0)  # head h's value rows: head h + 1's
    return fwd(x, cls, g1, b1, torch.cat([wqkv[:2 * d], wv]).contiguous(), bqkv, *args)


def k3_probs_unnormalised(fwd, qkv, num_heads):
    b, n, threed = qkv.shape
    d = threed // 3
    dh = d // num_heads
    q, k = (t.float().unflatten(-1, (num_heads, dh)).transpose(1, 2)
            for t in qkv.split(d, dim=-1)[:2])
    logits = (q * dh ** -0.5) @ k.transpose(-1, -2)
    rowsum = torch.exp(logits - logits.amax(-1, keepdim=True)).sum(-1)  # (b, h, n)
    out = fwd(qkv, num_heads).float().unflatten(-1, (num_heads, dh))
    return (out * rowsum.transpose(1, 2)[..., None]).flatten(-2).to(qkv.dtype)


def space_cls_key_dropped(fwd, bwd, qkv, num_heads, num_frames, mode):
    out = fwd(qkv, num_heads, num_frames, mode)
    if mode != "space":
        return out
    b, seq, threed = qkv.shape
    d = threed // 3
    dh, n = d // num_heads, (seq - 1) // num_frames
    q, k, v = (t.float().unflatten(-1, (num_heads, dh)) for t in qkv.split(d, dim=-1))
    qp = q[:, 1:].reshape(b, num_frames, n, num_heads, dh) * dh ** -0.5
    kp = k[:, 1:].reshape(b, num_frames, n, num_heads, dh)
    cls_logit = torch.einsum("bfnhd,bhd->bfnh", qp, k[:, 0])
    logits = torch.einsum("bfnhd,bfmhd->bfnhm", qp, kp)
    m = torch.maximum(logits.amax(-1), cls_logit)
    ec = torch.exp(cls_logit - m)
    p_cls = ec / (torch.exp(logits - m[..., None]).sum(-1) + ec)      # (b, f, n, h)
    term = (p_cls[..., None] * v[:, 0][:, None, None]).reshape(b, seq - 1, d)
    out = out.clone()
    out[:, 1:] = (out[:, 1:].float() - term).to(out.dtype)
    return out


def pad_lanes_unzeroed(fwd, bwd, qkv, num_heads, num_frames, mode):
    """At head_dim 80: the attention at width 96 with each head's pad lanes
    80-95 holding the next head's lanes 0-15, q rescaled by (96 / 80)^0.5 so
    that the wider run's 96^-0.5 gives 80^-0.5; other head dims unchanged."""
    b, seq, threed = qkv.shape
    dh = threed // 3 // num_heads
    if dh != 80:
        return fwd(qkv, num_heads, num_frames, mode)
    x = qkv.unflatten(-1, (3, num_heads, dh))
    wide = torch.cat([x, torch.roll(x, -1, dims=3)[..., :16]], dim=-1)
    wide[:, :, 0] = (wide[:, :, 0].float() * (96 / 80) ** 0.5).to(qkv.dtype)
    out = fwd(wide.flatten(2).contiguous(), num_heads, num_frames, mode)
    return out.unflatten(-1, (num_heads, 96))[..., :dh].flatten(-2).contiguous()


# the frames a block of all 12 heads at D = 768 held in the backward's time pass
KEPT_FRAMES = 27


def k5_time_frames_dropped(fwd, qkv_p, qkv_c, num_heads, mode):
    """The split forward's time pass over the first KEPT_FRAMES frames only,
    the later frames' patch outputs zero (the CLS row as computed)."""
    out_p, out_c = fwd(qkv_p, qkv_c, num_heads, mode)
    if mode != "time" or qkv_p.shape[1] <= KEPT_FRAMES:
        return out_p, out_c
    kept, _ = fwd(qkv_p[:, :KEPT_FRAMES].contiguous(), qkv_c, num_heads, mode)
    return torch.cat([kept, torch.zeros_like(out_p[:, KEPT_FRAMES:])], 1), out_c


def k6_time_frames_dropped(fwd, bwd, qkv_p, qkv_c, dop, doc, num_heads, mode):
    """The split backward's time pass over the first KEPT_FRAMES frames only,
    the later frames' dqkv zero (the CLS row's as computed)."""
    dqp, dqc = bwd(qkv_p, qkv_c, dop, doc, num_heads, mode)
    if mode != "time" or qkv_p.shape[1] <= KEPT_FRAMES:
        return dqp, dqc
    kept, _ = bwd(qkv_p[:, :KEPT_FRAMES].contiguous(), qkv_c,
                  dop[:, :KEPT_FRAMES].contiguous(), doc, num_heads, mode)
    return torch.cat([kept, torch.zeros_like(dqp[:, KEPT_FRAMES:])], 1), dqc


def gemm_last_tile_dropped(fwd, a, w, bias, epilogue="bias", residual=None, impl="kernel"):
    """The GEMM with its last 128-column tile zero where N % 128 != 0."""
    out = fwd(a, w, bias, epilogue, residual, impl)
    n = out.shape[-1]
    if n % 128:
        out = out.clone()
        out[..., n - n % 128:] = 0
    return out


def k1_mode_swapped(fwd, qkv_p, qkv_c, res, wo, bo, num_heads, mode):
    return fwd(qkv_p, qkv_c, res, wo, bo, num_heads, "time" if mode == "space" else "space")


def cls_key_term(qkv_p, qkv_c, num_heads, mode, chunk: int = 8):
    """Each patch row's CLS-key term of the divided attention in f32, p_cls *
    v_cls per head, (B, f, n, D): p_cls from the softmax over [CLS; the
    group's keys], the group a frame (space) or a spatial position (time).
    Taken ``chunk`` segments at a time."""
    b, f, n, threed = qkv_p.shape
    d = threed // 3
    dh = d // num_heads
    terms = []
    for s0 in range(0, b, chunk):
        qp, kp, _ = (t.float().unflatten(-1, (num_heads, dh))
                     for t in qkv_p[s0:s0 + chunk].split(d, dim=-1))
        _, kc, vc = (t.float().unflatten(-1, (num_heads, dh))
                     for t in qkv_c[s0:s0 + chunk, 0].split(d, dim=-1))
        qp = qp * dh ** -0.5
        cls_logit = torch.einsum("bfnhd,bhd->bfnh", qp, kc)
        pattern = "bfnhd,bfmhd->bfnhm" if mode == "space" else "bfnhd,bgnhd->bfnhg"
        logits = torch.einsum(pattern, qp, kp)
        m = torch.maximum(logits.amax(-1), cls_logit)
        ec = torch.exp(cls_logit - m)
        p_cls = ec / (torch.exp(logits - m[..., None]).sum(-1) + ec)
        terms.append((p_cls[..., None] * vc[:, None, None]).flatten(-2))
        del logits
    return torch.cat(terms)


def k1_cls_key_dropped(fwd, qkv_p, qkv_c, res, wo, bo, num_heads, mode):
    out_p, out_c = fwd(qkv_p, qkv_c, res, wo, bo, num_heads, mode)
    term = cls_key_term(qkv_p, qkv_c, num_heads, mode) @ wo.float().t()
    return (out_p.float() - term).to(out_p.dtype), out_c


def k2_residual_dropped(fwd, x, g, b, w1, b1, w2, b2, eps, emit_stats):
    out = fwd(x, g, b, w1, b1, w2, b2, eps, emit_stats)
    if emit_stats:
        y = out[0] - x
        return y, frows.row_stats(y)
    return out - x


def mask_ignored(fwd, qkv, num_heads, num_frames, mode, keep=None):
    return fwd(qkv, num_heads, num_frames, mode, keep=torch.ones_like(keep))


def proj_dropout_skipped(drop, x, rate, generator):
    return x


K1_ENTRIES = (tda, ("_divided_attention_proj",))
K2_ENTRIES = (frows, ("_ln_mlp",))
K1_FAULTS = {"none": None, "k1_mode_swapped": (k1_mode_swapped, 0),
             "k1_cls_key_dropped": (k1_cls_key_dropped, 0)}
K2_FAULTS = {"none": None, "k2_residual_dropped": (k2_residual_dropped, 0)}
# the K1 / K2 faults on phase 3's sync inference, each with the entries it wraps
SLICE_FAULTS = {"none": (K1_ENTRIES, None),
                **{name: (K1_ENTRIES, f) for name, f in K1_FAULTS.items() if f is not None},
                **{name: (K2_ENTRIES, f) for name, f in K2_FAULTS.items() if f is not None}}

K3_ENTRIES = (tsa, ("_standard_attention",))
K3_FAULTS = {"none": None, "k3_probs_unnormalised": (k3_probs_unnormalised, 0)}
SPACE_FAULTS = {"none": None, "space_cls_key_dropped": (space_cls_key_dropped, 0)}
# the backward's faults confined to the multi-chunk space path (frames of more
# than FAR_PATCH patches), on phase 2's 'bwd ragged' cases
BWD_ENTRIES = (dab, ("divided_attention_bwd", "divided_attention_packed_bwd"))
BWD_FAULTS = {"none": None, "k6_far_keys_dropped": (k6_far_keys_dropped, 0),
              "k7c_far_keys_dropped": (k7c_far_keys_dropped, 1)}

K4_ENTRIES = (tcls, ("_cls_pool_tokens",))
K4_FAULTS = {"none": None, "k4_cls_key_dropped": (k4_cls_key_dropped, 0),
             "k4_wv_head_shifted": (k4_wv_head_shifted, 0)}

K4B_ENTRIES = (tcls, ("_cls_pool",))
K4B_FAULTS = {"none": None, "k4b_shared_q": (k4b_shared_q, 0),
              "k4b_residual_dropped": (k4b_residual_dropped, 0)}

# the entries of ops/kernels/fused_block.py a K8 fault may replace: K8a's
# forward, the K7c call in its backward, K8b's forward
K8_ENTRIES = (fb, ("_fused_attention", "divided_attention_packed_bwd", "_fused_mlp"))

# per flow: the module and the entries a fault may replace (forward,
# backward), each fault with the entry it replaces
FLOWS = {
    "split": (dab, ("divided_attention", "divided_attention_bwd"),
              {"none": None, "k6_dk_zero": (k6_dk_zero, 1),
               "k6_cls_key_zero": (k6_cls_key_zero, 1),
               "k6_mode_swapped": (k6_mode_swapped, 1),
               "k5_feature_order": (k5_feature_order, 0)}),
    "packed": (dab, ("divided_attention_packed", "divided_attention_packed_bwd"),
               {"none": None, "k7c_dk_zero": (k7c_dk_zero, 1),
                "k7a_mode_swapped": (k7a_mode_swapped, 0)}),
    "packed_fused": (*K8_ENTRIES, {"none": None, "k8a_dk_zero": (k8a_dk_zero, 1)}),
}
# the K8 faults on phase 8's serving check and on phase 2's K8a / K8b cases
SERVING_FAULTS = {"none": None, "k8a_mode_swapped": (k8a_mode_swapped, 0),
                  "k8a_ln_skipped": (k8a_ln_skipped, 0)}
KERNEL_FAULTS = {**SERVING_FAULTS, "k8b_residual_dropped": (k8b_residual_dropped, 2),
                 "k8a_ln_columns_swapped": (k8a_ln_columns_swapped, 0)}


# --tiny's packed block: 2 heads of 64 (groupable, so K7b's entry), 1 + 2 x 4 tokens
TINY_BLOCK = {"b": 2, "d": 128, "h": 2, "f": 2, "n": 4}
# --tiny's K8 cases: 2 heads of 48 on x (2, 1 + 2 x 4, 96)
TINY_K8 = {"bs": 2, "f": 2, "n": 4, "d": 96, "heads": 2}
# --tiny's K4b cases: 2 heads of 64, (2, 3) and (8, 5) rows
TINY_K4B = {"d": 128, "h": 2, "shapes": ((2, 3), (8, 5))}
# --tiny's K4 cases: 2 heads of 64, groups of 3, 1, 13 and 37 rows; 4 heads
# of 32 for the cases at another head width
TINY_K4 = {"d": 128, "h": 2, "global_rows": (2, 3), "ragged": ((2, 1), (2, 13)),
           "partial": (5, 3), "guard": ((2, 37),), "wide": (4, (2, 37), (3, 3)),
           "time_tail": (4, 2)}
# --tiny's legacy K4 cases: heads of 128 over 49 rows, heads of 64 over 4
TINY_K4_LEGACY = {"shapes": (("spatial", 4, 49, 256, 2), ("frequency", 6, 4, 128, 2))}
# --tiny's phase 16 (a): the full legacy towers on one clip of 2 segments of
# 16 frames of 64², a 2-layer transformer 64 wide
TINY_LEGACY = {"b": 1, "s": 2, "frames": (16, 64, 64, 3),
               "widths": {"d": 64, "n_layer": 2, "n_head": 4}}
# --tiny's ragged cases: one segment of 2 frames
TINY_RAGGED = {"bs": 1, "f": 2}
# the shape faults and the entries they replace (ops/kernels/divided_attention.py's
# split forward, gemm.py's GEMM entry; the packed forward and the split
# backward of divided_attention_bwd.py, FLOWS' entries)
PAD_FAULTS = {"none": None, "pad_lanes_unzeroed": (pad_lanes_unzeroed, 0)}
TIME_FWD_ENTRIES = (tda, ("divided_attention",))
TIME_FWD_FAULTS = {"none": None, "k5_time_frames_dropped": (k5_time_frames_dropped, 0)}
TIME_BWD_FAULTS = {"none": None, "k6_time_frames_dropped": (k6_time_frames_dropped, 1)}
GEMM_ENTRIES = (kgemm, ("gemm",))
GEMM_FAULTS = {"none": None, "gemm_last_tile_dropped": (gemm_last_tile_dropped, 0)}
# --tiny's shape cases: 2 heads of 80, 30 frames past KEPT_FRAMES at 2 heads
# of 64, small K3 and K8c
TINY_SHAPES = {"bs": 1, "f": 2, "head_dims": ((80, 2),), "space_ns": (5,), "k3_lens": (20,),
               "k3_dims": ((32, 9),), "frames": ((30,), (30,)), "time_widths": ((2, 64),),
               "time_n": 3, "k8c": (8, 40, 60), "k4": ((2, 3, 40),)}
# --tiny's GEMM cases at N = 1996
TINY_GEMM = {"shapes": (), "ragged": ((5, 1996, 64, "gelu"), (3, 1996, 40, "residual", 48)),
             "guard": ((5, 1996, 64, "bias"),)}
# --tiny's K1 / K2 cases: 2 heads of 64, 2 segments of 2 frames of 4 patches
TINY_K12 = {"bs": 2, "f": 2, "n": 4, "d": 128, "h": 2, "ast_tokens": 5}


def planted(module, entries, fault):
    """Context: the fault's wrapper in place of one of ``entries`` (names in
    ``module``); the wrapper gets every entry's original first."""
    originals = tuple(getattr(module, name) for name in entries)

    class _Ctx:
        def __enter__(self):
            if fault is not None:
                fn, which = fault
                setattr(module, entries[which], functools.partial(fn, *originals))

        def __exit__(self, *exc):
            for name, fn in zip(entries, originals):
                setattr(module, name, fn)

    return _Ctx()


def verdict(what: str, caught: dict) -> bool:
    """Log and return whether the control ("none") passed and every fault
    failed at least one check; ``caught`` maps each fault to its failed checks."""
    every = all(caught[n] for n in caught if n != "none")
    chip_smoke.log(f"[result] {what}: control passed: {not caught['none']}; every fault "
                   f"caught: {every}")
    return not caught["none"] and every


def block_faults(dev, tiny: bool) -> dict:
    """The packed flow's faults on chip_smoke's packed block (phase 5: 12
    heads of 64, K7b / K7c; TINY_BLOCK with --tiny): each fault's failed
    checks of packed_block_agreement."""
    module, entries, faults = FLOWS["packed"]
    setup = chip_smoke.packed_block(torch, dev, **(TINY_BLOCK if tiny else {}))
    ref = chip_smoke.packed_block_grads(torch, setup, torch.float32, "plain")
    plain = chip_smoke.packed_block_grads(torch, setup, torch.bfloat16, "plain")
    caught = {}
    for name, fault in faults.items():
        with planted(module, entries, fault):
            kern = chip_smoke.packed_block_grads(torch, setup, torch.bfloat16, "kernel")
        caught[name] = chip_smoke.packed_block_agreement(ref, plain, kern)
        chip_smoke.log(f"[fault] packed_block {name}: {len(caught[name])} checks failed: "
                       f"{caught[name]}")
    return caught


def serving_faults(dev, tiny: bool) -> dict:
    """The K8a faults on phase 8: the 8-head sync model on
    attn_impl='pallas_fused' (the tiny Synchformer with TINY_PACKED's towers,
    B=2, S=2, with --tiny) through SyncPredictor, each fault's failed checks
    of serving_agreement."""
    if tiny:
        build = functools.partial(build_tiny_synchformer, 2, t=TINY_PACKED,
                                  attn_impl="pallas_fused")
        video, pcm = chip_smoke.slice_inputs(torch, dev, 2, 2, (4, 32, 32, 3), 8)
    else:
        build = functools.partial(build_synchformer_8head, chip_smoke.S, "pallas_fused")
        video, pcm = chip_smoke.slice_inputs(torch, dev)
    sd = seeded_state_dict(build(device="meta"), seed=0)

    def record(dtype, impl, fault=None):
        model = build(device=dev)
        load_numpy_state_dict(model, sd)
        pred = SyncPredictor(model, dev, dtype, impl)
        with planted(*K8_ENTRIES, fault):
            return chip_smoke.serving_record(torch, pred, video, pcm)

    ref, plain = record(torch.float32, "plain"), record(torch.bfloat16, "plain")
    caught = {}
    for name, fault in SERVING_FAULTS.items():
        caught[name] = chip_smoke.serving_agreement(ref, plain,
                                                    record(torch.bfloat16, "kernel", fault),
                                                    f"serving {name}")
        chip_smoke.log(f"[fault] serving {name}: {len(caught[name])} checks failed: "
                       f"{caught[name]}")
    return caught


def kernel_faults(dev, tiny: bool) -> dict:
    """The K8a / K8b faults on phase 2's K8a and K8b cases (TINY_K8's size
    with --tiny), each fault's cases that hold_outputs failed."""
    cases = [c for c in chip_smoke.k8_cases(torch, dev, **(TINY_K8 if tiny else {}))
             if c[0] in ("K8a", "K8b")]
    return cases_caught(cases, K8_ENTRIES, KERNEL_FAULTS)


def k4b_kernel_faults(dev, tiny: bool) -> dict:
    """The K4b faults on phase 2's K4b cases (TINY_K4B's size with --tiny),
    each fault's cases that hold_outputs failed."""
    return cases_caught(chip_smoke.k4b_cases(torch, dev, **(TINY_K4B if tiny else {})),
                        K4B_ENTRIES, K4B_FAULTS)


def k4_kernel_faults(dev, tiny: bool) -> dict:
    """The K4 faults on phase 2's checked K4 cases (chip_smoke.k4_cases and
    the legacy towers' chip_smoke.k4_legacy_cases; TINY_K4's and
    TINY_K4_LEGACY's sizes with --tiny), each fault's cases that
    hold_outputs failed."""
    cases = (chip_smoke.k4_cases(torch, dev, **(TINY_K4 if tiny else {}))
             + chip_smoke.k4_legacy_cases(torch, dev, **(TINY_K4_LEGACY if tiny else {})))
    return cases_caught(cases, K4_ENTRIES, K4_FAULTS)


def legacy_faults(dev, tiny: bool) -> dict:
    """The K4 faults on phase 16 (a)'s legacy sync inference
    (chip_smoke.legacy_predictors: S3D + ResNet-18 towers at B=8, S=14;
    TINY_LEGACY's with --tiny): the f32 and bf16 plain records once, then
    the kernel path once per fault, each fault's failed checks of
    serving_agreement (the probabilities and both towers' features)."""
    preds, video, pcm = chip_smoke.legacy_predictors(torch, dev,
                                                     **(TINY_LEGACY if tiny else {}))
    ref, plain = chip_smoke.legacy_records(torch, preds, video, pcm)
    caught = {}
    for name, fault in K4_FAULTS.items():
        with planted(*K4_ENTRIES, fault):
            kern = chip_smoke.serving_record(torch, preds["kernel"], video, pcm, audio=True)
        caught[name] = chip_smoke.serving_agreement(ref, plain, kern, f"legacy {name}")
        chip_smoke.log(f"[fault] legacy {name}: {len(caught[name])} checks failed: "
                       f"{caught[name]}")
    return caught


def ragged_kernel_faults(dev, tiny: bool):
    """K3's, the space pass's and the backward's faults on phase 2's ragged
    and guard-band cases (TINY_RAGGED's size with --tiny): for each kernel,
    each fault's cases that hold_outputs failed."""
    cases = chip_smoke.ragged_cases(torch, dev, **(TINY_RAGGED if tiny else {}))
    k3 = cases_caught([c for c in cases if c[0] == "K3 ragged"], K3_ENTRIES, K3_FAULTS)
    space = cases_caught([c for c in cases if c[0] == "space ragged"], FLOWS["packed"][:2],
                         SPACE_FAULTS)
    bwd = cases_caught([c for c in cases if c[0] == "bwd ragged"], BWD_ENTRIES, BWD_FAULTS)
    return k3, space, bwd


def shape_faults(dev, tiny: bool) -> dict:
    """The shape faults on phase 2's new cases (TINY_SHAPES' and TINY_GEMM's
    sizes with --tiny): pad_lanes_unzeroed on the packed forwards at head_dim
    80, the time faults on the split time passes past KEPT_FRAMES frames,
    gemm_last_tile_dropped on the GEMM cases at N = 1996; each fault's cases
    that hold_outputs failed, by group."""
    cases = chip_smoke.shape_cases(torch, dev, **(TINY_SHAPES if tiny else {}))
    packed_80 = [c for c in cases if c[1].endswith("x80") and " packed" in c[1]]
    time_fwd = [c for c in cases if c[1].startswith("time split")
                and int(c[1].split("(")[1].split(",")[1]) > KEPT_FRAMES]
    time_bwd = [c for c in cases if c[1].startswith("K6 time")
                and int(c[1].split("(")[1].split(",")[1]) > KEPT_FRAMES]
    gemms = [("GEMM", label, kern, plain, None, None) for label, kern, plain, _, _
             in chip_smoke.gemm_cases(torch, dev, **(TINY_GEMM if tiny else {"shapes": ()}))
             if "-> 1996" in label]
    caught = {}
    for what, group, entries, faults in (
            ("pad", packed_80, FLOWS["packed"][:2], PAD_FAULTS),
            ("time_fwd", time_fwd, TIME_FWD_ENTRIES, TIME_FWD_FAULTS),
            ("time_bwd", time_bwd, FLOWS["split"][:2], TIME_BWD_FAULTS),
            ("gemm", gemms, GEMM_ENTRIES, GEMM_FAULTS)):
        chip_smoke.log(f"[fault] shapes {what}: {len(group)} cases")
        got = cases_caught(group, entries, faults)
        caught["none"] = caught.get("none", []) + got.pop("none")
        caught.update(got)
    return caught


def slice_faults(dev, tiny: bool) -> dict:
    """The K1 / K2 faults on phase 3: the sync model (build_synchformer at B=8,
    S=14; the tiny Synchformer at B=2, S=2 with --tiny) through SyncPredictor
    on the kernel route, each fault's failed checks of serving_agreement
    against the f32 and bf16 plain records."""
    if tiny:
        build = functools.partial(build_tiny_synchformer, 2)
        video, pcm = chip_smoke.slice_inputs(torch, dev, 2, 2, (4, 32, 32, 3), 8)
    else:
        build = functools.partial(build_synchformer, chip_smoke.S)
        video, pcm = chip_smoke.slice_inputs(torch, dev)
    sd = seeded_state_dict(build(device="meta"), seed=0)

    def record(dtype, impl, entries=K1_ENTRIES, fault=None):
        model = build(device=dev)
        load_numpy_state_dict(model, sd)
        pred = SyncPredictor(model, dev, dtype, impl)
        with planted(*entries, fault):
            rec = chip_smoke.serving_record(torch, pred, video, pcm)
        del model, pred
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        return rec

    ref, plain = record(torch.float32, "plain"), record(torch.bfloat16, "plain")
    caught = {}
    for name, (entries, fault) in SLICE_FAULTS.items():
        caught[name] = chip_smoke.serving_agreement(
            ref, plain, record(torch.bfloat16, "kernel", entries, fault), f"slice {name}")
        chip_smoke.log(f"[fault] slice {name}: {len(caught[name])} checks failed: "
                       f"{caught[name]}")
    return caught


def k1_k2_kernel_faults(dev, tiny: bool):
    """The K1 and K2 faults on phase 2's K1 / K2 cases (TINY_K12's size with
    --tiny): for each kernel, each fault's cases that hold_outputs failed."""
    cases = chip_smoke.k1_k2_cases(torch, dev, **(TINY_K12 if tiny else {}))
    k1 = cases_caught([c for c in cases if c[0] == "K1"], K1_ENTRIES, K1_FAULTS)
    k2 = cases_caught([c for c in cases if c[0] == "K2"], K2_ENTRIES, K2_FAULTS)
    return k1, k2


def margin(k_out, p_out, a_out) -> float:
    """The largest error / tolerance of hold_outputs' rule over the outputs
    (above 1: the check fails; non-finite: inf)."""
    k_out, p_out, a_out = (t if isinstance(t, tuple) else (t,) for t in (k_out, p_out, a_out))
    worst = 0.0
    for k, p, a in zip(k_out, p_out, a_out):
        if not bool(k.float().isfinite().all()):
            return float("inf")
        tol = 2.0 * chip_smoke.maxabs(p, a) + 1e-2 * float(a.float().abs().max())
        worst = max(worst, chip_smoke.maxabs(k, a) / tol)
    return worst


def cases_caught(cases, entries, faults) -> dict:
    """``faults`` (wrapping ``entries``) on phase 2's ``cases``, each fault's
    cases that hold_outputs failed; logs each fault's margin (the error over
    the tolerance of its case nearest to passing, of those it fails)."""
    anchors = [(plain(torch.bfloat16), plain(torch.float32)) for _, _, _, plain, _, _ in cases]
    caught = {}
    for name, fault in faults.items():
        caught[name], margins = [], []
        for (_, label, kern, _, _, _), (p_out, a_out) in zip(cases, anchors):
            with planted(*entries, fault):
                k_out = kern()
            if chip_smoke.hold_outputs(label, k_out, p_out, a_out, f"kernels {name}")[0]:
                caught[name].append(label)
                margins.append(margin(k_out, p_out, a_out))
        chip_smoke.log(f"[fault] kernels {name}: {len(caught[name])} cases failed: "
                       f"{caught[name]}" + (f"; margin {min(margins):.3g} (error / tolerance)"
                                             if margins else ""))
    return caught


def moco_faults(dev, tiny: bool) -> dict:
    """The K4b faults on phase 9's MoCo step (build_moco_avclip at B=2, S=14;
    build_tiny_moco_avclip, drop-path 0.2, at B=2, S=2 with --tiny): (c) f32
    plain with remat, (b) bf16 plain, then the bf16 kernel path once per
    fault, each fault's failed checks of moco_agreement."""
    if tiny:
        build = functools.partial(build_tiny_moco_avclip, drop_path_rate=0.2)
        batch = chip_smoke.stage1_batch(torch, 2, 2, (4, 32, 32, 3))
    else:
        build = build_moco_avclip
        batch = chip_smoke.stage1_batch(torch, chip_smoke.B1, chip_smoke.S)
    sd = seeded_state_dict(build(device="meta"), seed=0)

    def record(precision, impl, remat=False, fault=None):
        tr = chip_smoke.stage1_trainer(build, sd, dev, precision, impl, remat, moco=True)
        with planted(*K4B_ENTRIES, fault):
            rec, _ = chip_smoke.moco_first_step(torch, tr, batch, f"{precision} {impl}",
                                                "moco_faults")
        del tr
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        return rec

    ref, plain = record("fp32", "plain", remat=True), record("amp", "plain")
    caught = {}
    for name, fault in K4B_FAULTS.items():
        margins = {}
        caught[name] = chip_smoke.moco_agreement(ref, plain, record("amp", "kernel", fault=fault),
                                                 f"moco {name}", margins)
        failed = [margins[c] for c in caught[name] if c in margins]
        chip_smoke.log(f"[fault] moco {name}: {len(caught[name])} checks failed: "
                       f"{caught[name][:6]}{' ...' if len(caught[name]) > 6 else ''}"
                       + (f"; margin {min(failed):.3g} (error / tolerance, the query global "
                          f"features {margins['query global_v']:.3g})" if failed else ""))
    return caught


# the K1 and K4 faults on phase 10's Stage II step, each with the entries it wraps
STAGE2_FAULTS = {"none": (K1_ENTRIES, None),
                 **{name: (K1_ENTRIES, f) for name, f in K1_FAULTS.items() if f is not None},
                 **{name: (K4_ENTRIES, f) for name, f in K4_FAULTS.items() if f is not None}}
# --tiny's Stage II model: chip_smoke.sync_config's widths for the TINY towers
TINY_SYNC = {"d": TINY["d"], "n_layer": TINY["n_layer"], "n_head": TINY["heads"],
             "audio": {"hidden_size": TINY["d"], "depth": TINY["depth"],
                       "num_heads": TINY["audio_heads"]},
             "video": {"embed_dim": TINY["d"], "depth": TINY["depth"], "num_heads": TINY["heads"],
                       "patch_size": TINY["patch_size"], "img_size": TINY["img_size"],
                       "temporal_resolution": TINY["temporal_resolution"]}}


def stage2_faults(dev, tiny: bool) -> dict:
    """STAGE2_FAULTS on phase 10's Stage II step: (c) f32 plain, (b) bf16
    plain, then the bf16 kernel path once per fault, each from the same
    seeded weights, Stage I checkpoint, batch and generator seed; each
    fault's failed checks of sync_agreement."""
    if tiny:
        build, widths, b, s, frames = build_tiny_avclip, TINY_SYNC, 2, 2, (4, 32, 32, 3)
    else:
        build, widths, b, s, frames = build_avclip, None, chip_smoke.B2, chip_smoke.S, \
            chip_smoke.FRAMES
    ckpt = chip_smoke.stage1_tower_ckpt(torch, build, os.path.join(
        REPO, "build", "planted_faults", "stage1_avclip.pt"))
    batch = chip_smoke.sync_batch(torch, dev, b, s, frames)

    def record(impl, half, entries=K1_ENTRIES, fault=None):
        cfg = chip_smoke.sync_config("train_avsync_model", s, ckpt, widths=widths)
        tr = chip_smoke.sync_trainer(cfg, dev, impl, half)
        with planted(*entries, fault):
            rec, _ = chip_smoke.sync_record(torch, tr, batch, f"{impl} {half}", "stage2_faults")
        del tr
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        return rec

    ref, plain = record("plain", False), record("plain", True)
    caught = {}
    for name, (entries, fault) in STAGE2_FAULTS.items():
        margins = {}
        caught[name] = chip_smoke.sync_agreement(ref, plain, record("kernel", True, entries, fault),
                                                 f"stage2 {name}", margins)
        chip_smoke.log(f"[fault] stage2 {name}: {len(caught[name])} checks failed: "
                       f"{caught[name][:6]}{' ...' if len(caught[name]) > 6 else ''}; margins "
                       + ", ".join(f"{k} {v:.3g}" for k, v in margins.items()))
    os.remove(ckpt)
    return caught


# phase 17's faults: the masked divided attention (the XLA composition the
# port runs under a keep-mask) without its mask, on (c)'s partly masked sync
# inference; the Motionformer's element dropouts (with pos_dropout 0, the
# projections' after each divided attention) skipped, on (a)'s Stage I step
MASK_ENTRIES = (tmf, ("divided_attention_packed_plain",))
MASK_FAULTS = {"none": None, "mask_ignored": (mask_ignored, 0)}
PROJ_DROP_ENTRIES = (tmf, ("element_dropout",))
PROJ_DROP_FAULTS = {"none": None, "proj_dropout_skipped": (proj_dropout_skipped, 0)}
# --tiny's phase 17 (a) model: segment_avclip.yaml's at the TINY widths
TINY_OPTIONS = {"n_embd": TINY["d"],
                "audio": {"depth": TINY["depth"], "num_heads": TINY["audio_heads"]},
                "video": {k: v for k, v in TINY_SYNC["video"].items() if k != "embed_dim"}}


def serving_margin(ref: dict, plain: dict, kern: dict) -> float:
    """The largest error / tolerance of serving_agreement's rule over the
    probabilities and the features (above 1: a check fails)."""
    worst = 0.0
    for name, a in ref.items():
        if name == "logits":
            continue
        k, p = kern[name], plain[name]
        if name == "probs":
            err_k, tol = chip_smoke.maxabs(k, a), 2.0 * chip_smoke.maxabs(p, a) + 5e-3
        else:
            a64 = a.double()
            err_k, err_p = (float((t.double() - a64).norm() / a64.norm()) for t in (k, p))
            tol = 2.0 * err_p
        worst = max(worst, err_k / tol if tol > 0 else float("inf"))
    return worst


def option_faults(dev, tiny: bool) -> dict:
    """Phase 17's faults: PROJ_DROP_FAULTS on (a)'s Stage I step (f32 plain
    with remat, bf16 plain, then the bf16 kernel path once per fault; each
    fault's failed checks of stage1_agreement) and MASK_FAULTS on (c)'s
    partly masked sync inference (f32 and bf16 plain, then the bf16 kernel
    path once per fault; serving_agreement). --tiny: TINY_OPTIONS' Stage I
    model and TINY_SYNC's sync model, B=2, S=2, frames of 4 x 32²."""
    b, s, frames = (2, 2, (4, 32, 32, 3)) if tiny else (chip_smoke.B1, chip_smoke.S,
                                                        chip_smoke.FRAMES)
    build = chip_smoke.registry_build(chip_smoke.stage1_option_model(
        TINY_OPTIONS if tiny else None))
    batch = chip_smoke.stage1_batch(torch, b, s, frames)
    sd = seeded_state_dict(build(device="meta"), seed=0)

    def first_step(precision, impl, remat=False, fault=None):
        tr = chip_smoke.stage1_trainer(build, sd, dev, precision, impl, remat)
        with planted(*PROJ_DROP_ENTRIES, fault):
            m = chip_smoke.checked_step(tr, batch, f"{precision} {impl}")
        rec = chip_smoke.step_gradients(torch, tr, m)
        del tr
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return rec

    caught = {}
    ref, plain = first_step("fp32", "plain", remat=True), first_step("amp", "plain")
    for name, fault in PROJ_DROP_FAULTS.items():
        margins = {}
        caught[name] = chip_smoke.stage1_agreement(ref, plain, first_step("amp", "kernel",
                                                                          fault=fault),
                                                   f"p17a {name}", margins=margins)
        chip_smoke.log(f"[fault] p17a {name}: {len(caught[name])} checks failed: "
                       f"{caught[name][:6]}{' ...' if len(caught[name]) > 6 else ''}; margin "
                       f"{max(margins.values()):.3g} (largest error / tolerance)")
    del ref, plain
    node = chip_smoke.sync_config("train_avsync_model", s,
                                  widths=TINY_SYNC if tiny else None)["model"]
    preds = chip_smoke.option_predictors(torch, dev, node)
    # --tiny: 2 of the 4 frames (one of the two frames after the patch embed),
    # so that the segment keeps frames whose attention the mask changes
    video, pcm, keep = chip_smoke.masked_inputs(torch, dev, b, s, frames, partial=True,
                                                masked_frames=2 if tiny else 4)
    record = chip_smoke.serving_record
    ref = chip_smoke.with_last_segment(record(torch, preds["f32"], video, pcm, masks=keep))
    plain = chip_smoke.with_last_segment(record(torch, preds["plain"], video, pcm, masks=keep))
    for name, fault in MASK_FAULTS.items():
        with planted(*MASK_ENTRIES, fault):
            kern = chip_smoke.with_last_segment(record(torch, preds["kernel"], video, pcm,
                                                       masks=keep))
        caught[name + " (c)"] = chip_smoke.serving_agreement(ref, plain, kern, f"p17c {name}")
        chip_smoke.log(f"[fault] p17c {name}: {len(caught[name + ' (c)'])} checks failed: "
                       f"{caught[name + ' (c)']}; margin {serving_margin(ref, plain, kern):.3g} "
                       f"(largest error / tolerance)")
    caught["none"] = caught["none"] + caught.pop("none (c)")
    return caught


def ckpt_faults(dev, tiny: bool) -> dict:
    """The Stage I reader's fault on phase 15 (c)
    (chip_smoke.stage1_reference_check: SyncTrainer's towers from a
    reference-style Stage I file whose AST position embedding holds 1214
    tokens; --tiny: the tiny AVCLIP into TINY_SYNC's towers, B=2, S=2):
    - none: the control;
    - ast_pos_emb_untrimmed: utils/checkpoint.py reads the file without
      cutting the AST position embedding to the tower's tokens.
    Each fault's failed checks."""
    from synchformer_tpu_torch.utils import checkpoint as tckpt

    root = os.path.join(REPO, "build", "planted_faults", "reference")
    kw = {"build": build_tiny_avclip, "widths": TINY_SYNC, "s": 2} if tiny else {}
    trim = tckpt.trim_ast_pos_emb
    caught = {}
    for name, fn in (("none", trim), ("ast_pos_emb_untrimmed", lambda sd, n, prefix="": dict(sd))):
        tckpt.trim_ast_pos_emb = fn
        try:
            caught[name] = chip_smoke.stage1_reference_check(torch, dev, root, **kw)
        finally:
            tckpt.trim_ast_pos_emb = trim
        gc.collect()
        chip_smoke.log(f"[fault] ckpt {name}: {len(caught[name])} checks failed: {caught[name]}")
    return caught


# the data-parallel faults, each with the phase-14 (c) cases it runs on
DP_FAULTS = {"none": chip_smoke.DP_CASES, "dist_gather_local_grad": ("avclip",),
             "moco_keys_local": ("moco",), "sync_lr_unscaled": ("stage2",)}
# --tiny's phase 14 (c): the tiny AVCLIP and MoCo at S=2 on 32 px frames, the
# tiny Synchformer
TINY_DP = {"avclip_build": "build_tiny_avclip", "moco_build": "build_tiny_moco_avclip",
           "s": 2, "frames": (4, 32, 32, 3), "widths": TINY_SYNC}


def apply_dp_fault(name: str) -> None:
    """Plant DP_FAULTS' ``name`` in this process (a phase-14 (c) worker)."""
    from synchformer_tpu_torch.models import moco_clip
    from synchformer_tpu_torch.parallel import dist as pdist
    from synchformer_tpu_torch.train import stage_sync

    if name == "dist_gather_local_grad":
        pdist._AllGatherWithGrad.backward = staticmethod(
            lambda ctx, g: g[pdist.rank() * ctx.n:(pdist.rank() + 1) * ctx.n])
    elif name == "moco_keys_local":
        attrs = {k: getattr(pdist, k) for k in dir(pdist) if not k.startswith("__")}
        moco_clip.pdist = types.SimpleNamespace(**{**attrs, "all_gather_no_grad": lambda x: x})
    elif name == "sync_lr_unscaled":
        make = stage_sync.make_lr_schedule
        stage_sync.make_lr_schedule = lambda sched, base, warmup: make(sched, base / pdist.world(),
                                                                      warmup)
    elif name != "none":
        raise ValueError(f"no data-parallel fault {name!r}")


def dp_faults(dev, tiny: bool) -> dict:
    """DP_FAULTS on chip_smoke.run_gloo_group (phase 14 (c)); each fault's
    failed checks, its margins logged."""
    caught = {}
    for name, cases in DP_FAULTS.items():
        res = chip_smoke.run_gloo_group(torch, dev, cases=cases, tiny=TINY_DP if tiny else None,
                                        hook=f"{os.path.abspath(__file__)}:apply_dp_fault",
                                        fault=name, check=False)
        caught[name] = res["failed"]
        margins = "; ".join(f"{case}: " + ", ".join(f"{k} {v:.3g}" for k, v in
                                                     r.get("margins", {}).items())
                            for case, r in res["cases"].items())
        chip_smoke.log(f"[fault] dp {name}: {len(caught[name])} checks failed: "
                       f"{caught[name][:6]}{' ...' if len(caught[name]) > 6 else ''}; margins "
                       f"{margins}")
    return caught


# the tensor-parallel faults, each with the phase-19 cases it runs on
TP_FAULTS = {"none": chip_smoke.TP_CASES, "tp_clip_norm_local": ("stage2",),
             "tp_streams_by_rank": ("stage2",), "tp_lr_by_world": ("stage2",),
             "tp_infonce_all_ranks": ("avclip",), "tp_ckpt_rank0_shards": ("stage2",)}


def apply_tp_fault(name: str) -> None:
    """Plant TP_FAULTS' ``name`` in this process (a phase-19 worker)."""
    import torch.distributed as dist

    from synchformer_tpu_torch.models import avclip
    from synchformer_tpu_torch.parallel import dist as pdist
    from synchformer_tpu_torch.parallel import tensor as ptensor
    from synchformer_tpu_torch.train import stage_clip, stage_sync
    from synchformer_tpu_torch.train import state as tstate

    attrs = {k: getattr(pdist, k) for k in dir(pdist) if not k.startswith("__")}
    if name == "tp_clip_norm_local":
        norm = tstate.global_norm
        tstate.global_norm = lambda grads, sharded=None: norm(grads)
    elif name == "tp_streams_by_rank":
        stage_sync.pdist = stage_clip.pdist = types.SimpleNamespace(
            **{**attrs, "data_rank": pdist.rank})
    elif name == "tp_lr_by_world":
        make = stage_sync.make_lr_schedule
        stage_sync.make_lr_schedule = lambda sched, base, warmup: make(
            sched, base / pdist.n_data() * pdist.world(), warmup)
    elif name == "tp_infonce_all_ranks":
        class WorldGather(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.n = x.shape[0]
                return pdist.gather_rows(x)

            @staticmethod
            def backward(ctx, grad):
                grad = grad.contiguous().clone()
                dist.all_reduce(grad)
                return grad[pdist.rank() * ctx.n:(pdist.rank() + 1) * ctx.n]

        avclip.pdist = types.SimpleNamespace(**{**attrs,
                                                "all_gather_with_grad": WorldGather.apply})
    elif name == "tp_ckpt_rank0_shards":
        ptensor._whole_state = lambda *args: None
        ptensor.optimizer_state_dict = lambda optimizer, model: optimizer.state_dict()
    elif name != "none":
        raise ValueError(f"no tensor-parallel fault {name!r}")


def tp_faults(dev, tiny: bool) -> dict:
    """TP_FAULTS on chip_smoke.run_tensor_parallel (phase 19); each fault's
    failed checks, its margins logged."""
    caught = {}
    for name, cases in TP_FAULTS.items():
        res = chip_smoke.run_tensor_parallel(
            torch, dev, None, cases, tiny=TINY_DP if tiny else None,
            hook=f"{os.path.abspath(__file__)}:apply_tp_fault", fault=name, check=False)
        caught[name] = res["failed"]
        margins = "; ".join(f"{case}: " + ", ".join(f"{k} {v:.3g}" for k, v in
                                                     r.get("margins", {}).items())
                            for case, r in res["cases"].items())
        chip_smoke.log(f"[fault] tp {name}: {len(caught[name])} checks failed: "
                       f"{caught[name][:6]}{' ...' if len(caught[name]) > 6 else ''}; margins "
                       f"{margins}")
    return caught


# the legacy training faults (phase 20), each with the parts it runs on:
# 'unit' chip_smoke.bn_unit_check, 'step' (a)'s kernel step and flax_bn_check,
# 'resume' (d), 'gloo' (c)
LEGACY_TRAIN_FAULTS = {"none": ("unit", "step", "resume", "gloo"),
                       "bn_unbiased_running_var": ("step",), "bn_torch_momentum": ("step",),
                       "bn_local_stats_over_ranks": ("gloo",), "bn_two_pass_var": ("unit",),
                       "bn_stats_not_checkpointed": ("resume",)}


def apply_legacy_fault(name: str) -> None:
    """Plant LEGACY_TRAIN_FAULTS' ``name`` in this process (and, as the hook,
    in each phase-20 (c) worker)."""
    from synchformer_tpu_torch.models import conv
    from synchformer_tpu_torch.train import stage_sync

    if name == "bn_unbiased_running_var":
        update = conv.running_update_
        conv.running_update_ = lambda bn, mean, var, count: update(
            bn, mean, var * count / (count - 1), count)
    elif name == "bn_torch_momentum":
        update = conv.running_update_

        def torch_momentum(bn, mean, var, count):
            m = bn.momentum
            bn.momentum = 1 - m  # torch's momentum (S3D 0.001, ResNet 0.1) as flax's
            try:
                update(bn, mean, var, count)
            finally:
                bn.momentum = m

        conv.running_update_ = torch_momentum
    elif name == "bn_local_stats_over_ranks":
        conv.data_sums = lambda sums: sums
    elif name == "bn_two_pass_var":
        stats = conv.batch_stats

        def two_pass(x):
            mean, _, _, count = stats(x)
            xf = x.float() - mean.reshape((1, -1) + (1,) * (x.ndim - 2))
            var = (xf * xf).sum([0] + list(range(2, x.ndim))) / count
            return mean, var, var, count

        conv.batch_stats = two_pass
    elif name == "bn_stats_not_checkpointed":
        own = stage_sync.SyncTrainer.trainable_state_dict
        stage_sync.SyncTrainer.trainable_state_dict = lambda self: {
            k: v for k, v in own(self).items() if "running" not in k}
    elif name != "none":
        raise ValueError(f"no legacy training fault {name!r}")


def legacy_train_faults(dev, tiny: bool) -> dict:
    """LEGACY_TRAIN_FAULTS on phase 20's parts (each fault planted in this
    process, and in the (c) workers by the hook, then taken out again); each
    fault's failed checks, its margins logged."""
    size = (dict(s=2, frames=(16, 64, 64, 3), widths={"d": 64, "n_layer": 2, "n_head": 4})
            if tiny else {})
    caught = {}
    for name, parts in LEGACY_TRAIN_FAULTS.items():
        from synchformer_tpu_torch.models import conv
        from synchformer_tpu_torch.train import stage_sync

        saved = (conv.running_update_, conv.data_sums, conv.batch_stats,
                 stage_sync.SyncTrainer.trainable_state_dict)
        apply_legacy_fault(name)
        failed, margins = [], {}
        try:
            if "unit" in parts:
                f, margins["unit"] = chip_smoke.bn_unit_check(torch, dev)
                failed += f
            if "step" in parts or "resume" in parts:
                res = chip_smoke.p20_legacy_step(torch, dev, **size, check=False,
                                                 compare=False, resume="resume" in parts)
                failed += res["failed"]
                margins.update(res["margins"])
            if "gloo" in parts:
                tiny_dp = ({"s": 2, "legacy_widths": size["widths"],
                            "legacy_frames": size["frames"]} if tiny else None)
                res = chip_smoke.run_gloo_group(
                    torch, dev, cases=("legacy",), tiny=tiny_dp,
                    hook=f"{os.path.abspath(__file__)}:apply_legacy_fault", fault=name,
                    check=False, tag="p20c", timed_steps=1)
                failed += res["failed"]
                margins.update({f"gloo {k}": v for k, v in
                                res["cases"]["legacy"].get("margins", {}).items()})
        finally:
            (conv.running_update_, conv.data_sums, conv.batch_stats,
             stage_sync.SyncTrainer.trainable_state_dict) = saved
        caught[name] = failed
        chip_smoke.log(f"[fault] legacy_train {name}: {len(failed)} checks failed: "
                       f"{failed[:6]}{' ...' if len(failed) > 6 else ''}; margins "
                       + ", ".join(f"{k} {v:.3g}" for k, v in margins.items()))
    return caught


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", choices=("all", "dp", "tp", "ckpt", "legacy", "options",
                                       "shapes", "legacy_train"),
                    default="all",
                    help="dp: the data-parallel faults of phase 14 (c) alone; tp: the "
                         "tensor-parallel faults of phase 19 alone; ckpt: the Stage "
                         "I reader's of phase 15 (c) alone; legacy: the K4 faults on phase "
                         "16 (a) and on phase 2's K4 cases alone; options: phase 17's "
                         "faults alone; shapes: the faults of phase 2's new shapes alone; "
                         "legacy_train: the legacy training faults of phase 20 alone")
    args = ap.parse_args()
    dev = torch.device(args.device)
    # the world-1 references run_gloo_group keeps: this run's own
    shutil.rmtree(chip_smoke.REFS_DIR, ignore_errors=True)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu (with --tiny) for a dry run")
    if args.only == "dp":
        if dev.type == "cuda":
            chip_smoke.log(f"[device] {chip_smoke.smi_line()}")
            _build.build_all()
        return 0 if verdict("dp", dp_faults(dev, args.tiny)) else 1
    if args.only == "tp":
        if dev.type == "cuda":
            chip_smoke.log(f"[device] {chip_smoke.smi_line()}")
            _build.build_all()
        return 0 if verdict("tp", tp_faults(dev, args.tiny)) else 1
    if args.only == "ckpt":
        return 0 if verdict("ckpt", ckpt_faults(dev, args.tiny)) else 1
    if args.only == "options":
        if dev.type == "cuda":
            chip_smoke.log(f"[device] {chip_smoke.smi_line()}")
            _build.build_all()
        return 0 if verdict("options", option_faults(dev, args.tiny)) else 1
    if args.only == "shapes":
        if dev.type == "cuda":
            chip_smoke.log(f"[device] {chip_smoke.smi_line()}")
            _build.build_all()
        return 0 if verdict("shapes", shape_faults(dev, args.tiny)) else 1
    if args.only == "legacy_train":
        if dev.type == "cuda":
            chip_smoke.log(f"[device] {chip_smoke.smi_line()}")
            _build.build_all()
        return 0 if verdict("legacy_train", legacy_train_faults(dev, args.tiny)) else 1
    if args.only == "legacy":
        if dev.type == "cuda":
            chip_smoke.log(f"[device] {chip_smoke.smi_line()}")
            _build.build_all()
        ok = verdict("kernels_k4", k4_kernel_faults(dev, args.tiny))
        return 0 if verdict("legacy", legacy_faults(dev, args.tiny)) and ok else 1
    if args.tiny:
        builds = {"split": functools.partial(build_tiny_avclip, drop_path_rate=0.2),
                  "packed": functools.partial(build_tiny_avclip_packed, drop_path_rate=0.2),
                  "packed_fused": functools.partial(build_tiny_avclip_packed, drop_path_rate=0.2,
                                                    attn_impl="pallas_fused")}
        batch = chip_smoke.stage1_batch(torch, 2, 2, (4, 32, 32, 3))
    else:
        builds = {"split": build_avclip, "packed": build_avclip_8head,
                  "packed_fused": functools.partial(build_avclip_8head,
                                                    attn_impl="pallas_fused")}
        batch = chip_smoke.stage1_batch(torch, chip_smoke.B1, chip_smoke.S)
    if dev.type == "cuda":
        chip_smoke.log(f"[device] {chip_smoke.smi_line()}")

    ok = True
    for flow in ("split", "packed", "packed_fused"):
        build, (module, entries, faults) = builds[flow], FLOWS[flow]
        sd = seeded_state_dict(build(device="meta"), seed=0)

        def first_step(precision, impl, remat=False, fault=None):
            t = time.perf_counter()
            tr = chip_smoke.stage1_trainer(build, sd, dev, precision, impl, remat)
            with planted(module, entries, fault):
                m = chip_smoke.checked_step(tr, batch, f"{precision} {impl}")
            rec = chip_smoke.step_gradients(torch, tr, m)
            del tr
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            chip_smoke.log(f"[step] {flow} {precision} {impl}: loss {m['loss']:.6f}, "
                           f"grad_norm {m['grad_norm']:.6f} ({time.perf_counter() - t:.1f} s)")
            return rec

        ref = first_step("fp32", "plain", remat=True)
        plain = first_step("amp", "plain")
        caught = {}
        for name, fault in faults.items():
            chip_smoke.log(f"[fault] {flow} {name}")
            kern = first_step("amp", "kernel", fault=fault)
            caught[name] = chip_smoke.stage1_agreement(ref, plain, kern, flow)
            del kern
            chip_smoke.log(f"[fault] {flow} {name}: {len(caught[name])} checks failed: "
                           f"{caught[name][:6]}{' ...' if len(caught[name]) > 6 else ''}")
        ok = verdict(flow, caught) and ok
    ok = verdict("packed_block", block_faults(dev, args.tiny)) and ok
    ok = verdict("serving", serving_faults(dev, args.tiny)) and ok
    ok = verdict("kernels", kernel_faults(dev, args.tiny)) and ok
    ok = verdict("moco", moco_faults(dev, args.tiny)) and ok
    ok = verdict("kernels_k4b", k4b_kernel_faults(dev, args.tiny)) and ok
    ok = verdict("kernels_k4", k4_kernel_faults(dev, args.tiny)) and ok
    k3, space, bwd = ragged_kernel_faults(dev, args.tiny)
    ok = verdict("kernels_k3", k3) and ok
    ok = verdict("kernels_space", space) and ok
    ok = verdict("kernels_bwd", bwd) and ok
    ok = verdict("slice", slice_faults(dev, args.tiny)) and ok
    k1, k2 = k1_k2_kernel_faults(dev, args.tiny)
    ok = verdict("kernels_k1", k1) and ok
    ok = verdict("stage2", stage2_faults(dev, args.tiny)) and ok
    ok = verdict("dp", dp_faults(dev, args.tiny)) and ok
    ok = verdict("tp", tp_faults(dev, args.tiny)) and ok
    ok = verdict("ckpt", ckpt_faults(dev, args.tiny)) and ok
    ok = verdict("legacy", legacy_faults(dev, args.tiny)) and ok
    ok = verdict("options", option_faults(dev, args.tiny)) and ok
    ok = verdict("shapes", shape_faults(dev, args.tiny)) and ok
    ok = verdict("legacy_train", legacy_train_faults(dev, args.tiny)) and ok
    return 0 if verdict("kernels_k2", k2) and ok else 1

if __name__ == "__main__":
    sys.exit(main())
