#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU: sync inference,
the Stage I contrastive training step, the same step with an 8-head video
tower, which runs the Motionformer's packed flow, on both attention routes
(attn_impl 'pallas' and 'pallas_fused'), sync inference with that tower on
both routes, and the MoCo Stage I step with global representations.

    python3 chip_smoke.py

Phases, each printed as it runs with its seconds:
1. device and build: torch / CUDA versions, the card's name and power limit,
   the seconds nvcc took for the kernels (built into build/torch_kernels/).
2. per kernel at its main path's shapes in bf16 (K1-K4 at sync inference's,
   K5 and K6, the divided attention's forward and backward, at Stage I's;
   K7a and K7c, the packed layout's forward and backward, at the 8-head
   Stage I step's (28, 1569, 2304), 8 heads of 96, and K7c also at the
   packed block's 12 heads of 64, checked but not reported; K7b, the packed
   forward at groupable heads, at (28, 1569, 2304), 12 heads of 64; K6's
   space pass also at 36 patches a frame, checked but not reported; K8a in
   both modes, K8b and K8c at the 8-head serving tower's x (112, 1569, 768),
   8 heads of 96, hidden 3072, K8c's rows flattened, QKV 2304 wide; K4b,
   the CLS-pool layer with the CLS row inside x, at the MoCo step's video
   global aggregator (2, 15, 768) and, checked but not reported, at the
   Stage I spatial aggregator's groups with their CLS row inside, (224, 197,
   768), where each group's query differs; K8b also at D = 512, hidden 2048,
   and K2 at D = 192, hidden 768, both checked but not reported; K4b over
   [cls; x] against K4
   over x with the same CLS row, (224, 197, 768); and, checked but not
   reported, the two tensor-core attentions and the time pass at ragged
   shapes (ragged_cases: K3 at 17, 74 and 197 tokens, the space pass split
   and packed at 49 and 196 patches a frame for head_dim 32, 64, 96 and 128
   and packed at 300, where it takes two sweeps, the time pass split and
   packed at 49, 196 and 37 patches for every head_dim) and in guard bands
   (each input at the start of a buffer whose remainder is NaN), and the
   backward K6 / K7c at ragged shapes: the space pass at head_dim 128 and
   196 patches, and at 207, 208 and 300 patches (one 208-row chunk of keys,
   then two) for every head_dim, split and packed, the time pass at 8 frames
   of 37 patches for every head_dim, split and packed); first of
   all the Hopper GEMM under K1, K2 and K8a-K8c on its own entry
   (gemm_cases: K2's fc1 / fc2 at the video tower's and the AST's rows, K1's
   projection, K8a's QKV and K8b's fc1 / fc2 at the 8-head serving tower's
   rows, each timed beside one F.linear call, cuBLAS, as a yardstick; ragged
   cases at 1, 127, 129, 300 and 8288 rows, N = 192, 384 and 576 (64-wide
   last column tiles), K = 32 and 96; guard-band cases):
   the kernel against its plain PyTorch version (for K6 and K7c the autograd
   gradient of the forward's plain version, for seeded random cotangents),
   both held against a
   plain f32 anchor on the same inputs. Tolerance for each output: kernel
   error <= 2 x plain-bf16 error + eps, with eps = 1e-2 x max|anchor| (bf16
   keeps 8 bits; the two sides round at other places). Each kernel and its
   plain version are timed with CUDA events; K3, K5, K7a and K7b also against
   one torch.nn.functional.scaled_dot_product_attention call on views of the
   same packed QKV (for K5, K7a and K7b with a boolean mask of the divided
   attention's pattern; for K5 over its rows packed, 12 heads of 64), held
   to the kernel's tolerance (a yardstick only:
   the port never calls it); K6 and K7c against the backward alone of the
   same masked call (its forward run once, outside the timed region; for K6
   over the same rows packed, 12 heads of 64), held likewise. K3, the
   divided attention forwards and backwards (K1, K5, K6, K7a, K7b, K7c,
   K8a), K2, K8b and K8c, and their library calls, are also timed by launch
   with torch.profiler (device time only: the attention kernels, the CLS
   row, for the backwards its reduction, the LayerNorm pass and row
   statistics and, for K1, K2 and K8a-K8c, the GEMMs, each apart) and by the
   host's time to enqueue a call.
3. the full-width inference slice: Synchformer S=14 (ViT-B towers of 12
   layers, D=768, 3-layer GlobalTransformer), B=8, seeded weights, through
   SyncPredictor(impl='kernel') and (impl='plain') in bf16, both against an
   f32 plain run by serving_agreement (the probabilities within 2 x the
   plain bf16 error + 5e-3, the video tower's features by relative L2 error
   within 2 x plain's; scripts/stage1_planted_faults.py shows that it fails
   a mode-swapped K1, a K1 without the CLS key and a K2 without its
   residual). Launch counters are zeroed before the kernel-path forward
   and must show K1 >= 24, K2 >= 24, K3 >= 12, K4 >= 2. Then clips/s of both
   paths (host clock around synchronised forwards, after warm-up).
4. the full-width Stage I step: AVCLIP (ViT-B towers, AveragePooling time
   tails, drop-path 0.2), B=2, S=14, seeded weights, one seeded uint8 / PCM
   batch, through AVCLIPTrainer: (a) bf16 kernel path, (b) bf16 plain path,
   (c) f32 plain path with remat (the same math in less memory), each from
   the same weights and generator seed, so that the flip and drop-path draws
   agree. Counters are zeroed before (a)'s first step and must read exactly
   K5 24, K6 24, K3 12, K2 13, K4 2, K1 0. Against (c), each within 2 x
   (b)'s error: (a)'s loss (+ 1e-4 of it) and gradient norm (+ 1e-3 of it),
   the relative error of each gradient leaf that K5 / K6 feed (the video
   blocks' qkv weights by their q, k and v rows, the qkv biases, the video
   CLS token: 97 leaves), and 1 - the cosine
   of the whole gradient (stage1_agreement; scripts/stage1_planted_faults.py
   shows that it fails a wrong K5, K6, K7a or K7c); every loss finite, the logit
   scale clamped. Then 3 timed steps per bf16 path after the first
   (host clock around synchronised steps), the peak memory of each, and one
   eval step (the K1-K4 route) with its zero-shot precision.
5. one packed DividedSpaceTimeBlock at 12 heads of 64 on (28, 1569, 768), the
   path of K7b: forward and backward through forward_packed (drop-path 0, so
   its MLP is K2) in bf16 kernel, bf16 plain and f32 plain; counters read
   exactly K7b 2, K7c 2, K2 1; against f32 (packed_block_agreement), the
   output and dx within 2 x plain-bf16 error + 1% of max|f32|, the time and
   space qkv weights' gradients by their q, k and v rows within 2 x plain's
   relative L2 error (scripts/stage1_planted_faults.py shows that it fails a
   zero dk from K7c and a mode-swapped K7b).
6. the Stage I step of phase 4 with the 8-head video tower
   (build_avclip_8head: 8 heads of 96, the packed flow): the same three runs,
   counters exactly K7a 24, K7c 24, K2 13, K3 12, K4 2 and K1, K5, K6, K7b 0,
   stage1_agreement over the 97 leaves K7a / K7c feed, timing and peak
   memory, and an eval step reading K7a 24, K2 24, K3 12, K4 2.
7. in the same phase, the step on attn_impl='pallas_fused' (d), bf16 kernel
   path only, held against phase 6's (c) and (b) (same weights and generator
   seed; its plain route is the same composition): counters exactly K8a 24,
   K7c 24, K8b 1, K2 12, K3 12, K4 2 and K7a 0, stage1_agreement, timed in
   turns with phase 6's paths, peak memory, an eval step reading K8a 24, K8b
   12, K2 12, K3 12, K4 2.
8. sync inference with the 8-head video tower (build_synchformer_8head, B=8,
   S=14, seeded weights) on attn_impl='pallas_fused' through SyncPredictor:
   bf16 kernel, bf16 plain and f32 plain; counters exactly K8a 24, K8b 12,
   K2 12, K3 12, K4 2, the rest 0; serving_agreement (probabilities by phase
   3's rule, the video tower's features within 2 x plain's relative error;
   scripts/stage1_planted_faults.py shows that it fails a mode-swapped K8a
   and one without its LayerNorm); then clips/s of the fused kernel path, of
   the same weights on attn_impl='pallas' (counters K7a 24, K2 24) and of the
   plain path, taken in turns.
9. the MoCo Stage I step (build_moco_avclip: build_avclip's towers, both
   with a global segment aggregator over 14 segments, the video tower's
   positional dropout 0.1, which sends its query-pass global aggregator
   through K4b; queues 1024 x 14 and 1024, momentum 0.995, alpha 0.4), B=2,
   S=14, through AVCLIPTrainer with cfg.model.target naming
   MultilevelMoCoCLIP: (a) bf16 kernel, (b) bf16 plain, (c) f32 plain with
   remat, from one seeded state dict. Counters exactly K4b 1, K4 7, K5 24,
   K6 24, K1 24, K2 37, K3 24 and the rest 0 (the key pass takes the eval
   path); moco_agreement (stage1_agreement's checks over the leaves K5 / K6
   and K4b feed, with both levels' losses, then the momentum parameters, the
   keys written into the queues and the query pass's global aggregator
   outputs, each within 2 x plain's relative error;
   scripts/stage1_planted_faults.py shows that it fails a K4b that shares
   group 0's query and one that drops its residual); timing windows, peak
   memory, and an eval step reading K1 48, K2 48, K3 24, K4 8.
The line before the last is a JSON record of the kernels, with the TPU
kernels still to port beside them (none); the last line is {"ok": true,
"device": {...}}. Any failed phase raises, so the exit code is non-zero and no result
line is printed.
"""
from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

KEYS = ("K1", "K2", "K3", "K4", "K4b", "K5", "K6", "K7a", "K7b", "K7c", "K8a", "K8b", "K8c")
REPLACES = {
    "K1": "synchformer_tpu/ops/pallas/divided_attention.py:478",
    "K2": "synchformer_tpu/ops/pallas/fused_rows.py:188",
    "K3": "synchformer_tpu/ops/pallas/standard_attention.py:62",
    "K4": "synchformer_tpu/ops/pallas/cls_pool.py:181",
    "K4b": "synchformer_tpu/ops/pallas/cls_pool.py:265",
    "K5": "synchformer_tpu/ops/pallas/divided_attention.py:524",
    "K6": "synchformer_tpu/ops/pallas/divided_attention_bwd.py:469",
    "K7a": "synchformer_tpu/ops/pallas/divided_attention.py:599",
    "K7b": "synchformer_tpu/ops/pallas/divided_attention.py:569",
    "K7c": "synchformer_tpu/ops/pallas/divided_attention_bwd.py:211",
    "K8a": "synchformer_tpu/ops/pallas/fused_block.py:148",
    "K8b": "synchformer_tpu/ops/pallas/fused_block.py:274",
    "K8c": "synchformer_tpu/ops/pallas/fused_rows.py:65",
}
# TPU kernels without a port (ROADMAP): listed beside the kernels line
NOT_PORTED: list = []
SOURCES = {
    "K1": "synchformer_tpu_torch/csrc/divided_attention.cu",
    "K2": "synchformer_tpu_torch/csrc/ln_mlp.cu",
    "K3": "synchformer_tpu_torch/csrc/standard_attention.cu",
    "K4": "synchformer_tpu_torch/csrc/cls_pool.cu",
    "K4b": "synchformer_tpu_torch/csrc/cls_pool.cu",
    "K5": "synchformer_tpu_torch/csrc/divided_attention.cu",
    "K6": "synchformer_tpu_torch/csrc/divided_attention_bwd.cu",
    "K7a": "synchformer_tpu_torch/csrc/divided_attention.cu",
    "K7b": "synchformer_tpu_torch/csrc/divided_attention.cu",
    "K7c": "synchformer_tpu_torch/csrc/divided_attention_bwd.cu",
    "K8a": "synchformer_tpu_torch/csrc/fused_block.cu",
    "K8b": "synchformer_tpu_torch/csrc/ln_mlp.cu",
    "K8c": "synchformer_tpu_torch/csrc/ln_mlp.cu",
}
NAMES = {
    "K1": "divided_attention_proj",
    "K2": "fused_ln_mlp_residual",
    "K3": "standard_attention",
    "K4": "fused_cls_pool_tokens",
    "K4b": "fused_cls_pool",
    "K5": "divided_attention",
    "K6": "divided_attention_bwd",
    "K7a": "divided_attention_packed",
    "K7b": "divided_attention_packed_groupable",
    "K7c": "divided_attention_packed_bwd",
    "K8a": "fused_divided_attention",
    "K8b": "fused_mlp_residual",
    "K8c": "fused_ln_matmul",
}
# the path whose run gives each kernel's launches (and whose shapes it is timed at)
# (K8c: no model path calls it; its GEMM is K8a's prologue)
PATHS = {"K1": "sync_inference", "K2": "sync_inference", "K3": "sync_inference",
         "K4": "sync_inference", "K4b": "stage1_train_moco", "K5": "stage1_train",
         "K6": "stage1_train",
         "K7a": "stage1_train_8head", "K7b": "packed_block_12x64",
         "K7c": "stage1_train_8head", "K8a": "sync_inference_8head_fused",
         "K8b": "sync_inference_8head_fused", "K8c": "none"}
MIN_LAUNCHES = {"K1": 24, "K2": 24, "K3": 12, "K4": 2}
# one Stage I step: 12 blocks x (time + space) divided attentions; the AST's
# 12 layers; K2 on the AST's 12 layers and on video block 0, the one block
# whose drop-path rate (linspace(0, 0.2, 12)[0]) is 0; both aggregators
STAGE1_LAUNCHES = {"K1": 0, "K2": 13, "K3": 12, "K4": 2, "K4b": 0, "K5": 24, "K6": 24,
                   "K7a": 0, "K7b": 0, "K7c": 0}
# its eval step: the split flow's K1 pair and K2 in every video block
STAGE1_EVAL_LAUNCHES = {"K1": 24, "K2": 24, "K3": 12, "K4": 2}
# the same step with the 8-head video tower: the packed flow, K7a / K7c in
# place of K5 / K6
STAGE1_8HEAD_LAUNCHES = {"K1": 0, "K2": 13, "K3": 12, "K4": 2, "K4b": 0, "K5": 0, "K6": 0,
                         "K7a": 24, "K7b": 0, "K7c": 24, "K8a": 0, "K8b": 0}
# its eval step: the packed K7a pair and K2 over the whole packed x per block
STAGE1_8HEAD_EVAL_LAUNCHES = {"K1": 0, "K2": 24, "K3": 12, "K4": 2, "K7a": 24, "K7c": 0,
                              "K8a": 0, "K8b": 0}
# the same step under attn_impl='pallas_fused': K8a in place of LN -> QKV ->
# K7a, backward K7c; K8b for video block 0's MLP (drop-path 0), K2 for the
# AST's 12 layers
STAGE1_FUSED_LAUNCHES = {"K1": 0, "K2": 12, "K3": 12, "K4": 2, "K4b": 0, "K5": 0, "K6": 0,
                         "K7a": 0, "K7b": 0, "K7c": 24, "K8a": 24, "K8b": 1, "K8c": 0}
# its eval step: K8a's pair and K8b in every video block
STAGE1_FUSED_EVAL_LAUNCHES = {"K1": 0, "K2": 12, "K3": 12, "K4": 2, "K7a": 0, "K7c": 0,
                              "K8a": 24, "K8b": 12}
# one forward of the 8-head sync model (build_synchformer_8head) on each route
SERVING_FUSED_LAUNCHES = {"K1": 0, "K2": 12, "K3": 12, "K4": 2, "K5": 0, "K6": 0, "K7a": 0,
                          "K7b": 0, "K7c": 0, "K8a": 24, "K8b": 12, "K8c": 0}
SERVING_PALLAS_LAUNCHES = {"K1": 0, "K2": 24, "K3": 12, "K4": 2, "K7a": 24, "K8a": 0, "K8b": 0}
# one packed block at 12 heads of 64, forward and backward, drop-path 0
PACKED_BLOCK_LAUNCHES = {"K2": 1, "K7a": 0, "K7b": 2, "K7c": 2}
# one MoCo step (build_moco_avclip): the query pass as phase 4's step (K5 24,
# K2 13, K3 12, K4 for the spatial and frequency aggregators) with the audio
# global aggregator on K4 and the video one, its positional dropout live, on
# K4b; K6 24 in the backward; the key pass as the eval path (K1 24, K2 24, K3
# 12, K4 4: spatial, frequency and both global aggregators)
MOCO_LAUNCHES = {"K1": 24, "K2": 37, "K3": 24, "K4": 7, "K4b": 1, "K5": 24, "K6": 24,
                 "K7a": 0, "K7b": 0, "K7c": 0, "K8a": 0, "K8b": 0, "K8c": 0}
# its eval step: both passes on the eval path
MOCO_EVAL_LAUNCHES = {"K1": 48, "K2": 48, "K3": 24, "K4": 8, "K4b": 0, "K5": 0, "K6": 0}
MOCO_TARGET = "synchformer_tpu.models.moco_clip.MultilevelMoCoCLIP"
MOCO_ALPHA = 0.4  # training.alpha, the ALBEF weight (tests/test_stage_clip.py's)
# the leaves that K5 / K6 and K4b feed: phase 4's, and every parameter of the
# video global aggregator
MOCO_LEAVES = re.compile(
    r"v_encoder\.(cls_token|blocks\.\d+\.(attn|timeattn)\.qkv\.(weight|bias)"
    r"|global_attn_agg\..+)")
# the gradient leaves that the divided attention's backward (K6, or K7c in
# the packed flow) feeds directly (step_gradients)
STAGE1_LEAVES = re.compile(
    r"vfeat_extractor\.(cls_token|blocks\.\d+\.(attn|timeattn)\.qkv\.(weight|bias))")
PAIRED = ("K1", "K5", "K6", "K7a", "K7b", "K7c", "K8a")  # timed as a (space + time) pair
# the kernels whose calls (and library yardsticks) phase 2 also times by
# launch: the tensor-core attentions, the divided attention forwards and
# backwards, and the fused route's kernels (their GEMMs apart)
BY_LAUNCH = ("K1", "K2", "K3", "K5", "K6", "K7a", "K7b", "K7c", "K8a", "K8b", "K8c")
MAX_CLIP = 1.0  # Stage I's max_clip_norm
B, S = 8, 14
B1 = 2  # Stage I's base_batch_size
D, H, DH = 768, 12, 64
H8, DH8 = 8, 96  # the 8-head video tower's heads
F_T, N_P = 8, 196  # frames after the 3-D patch embed, patches per frame
SEQ = 1 + F_T * N_P  # the packed layout's tokens per segment
FRAMES = (16, 224, 224, 3)  # raw frames of a segment: T, H, W, C
# the NVIDIA H100 SXM's published peaks: HBM bytes/s, dense bf16 tensor FLOP/s
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(msg: str):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def maxabs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(nbytes: float, flops: float):
    """(ms, 'bytes' | 'operations'): the least time the card could take,
    the larger of the bytes at the HBM rate and the FLOPs at the bf16 rate."""
    t_b, t_f = nbytes / HBM_BPS, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def attention_flops(b: int, mode: str, matmuls: int, h: int = H, dh: int = DH, f: int = F_T,
                    n: int = N_P) -> float:
    """Divided attention over b segments: per head, every group's L queries
    against its L + 1 keys and the CLS query against 1 + f*n keys, ``matmuls``
    (L x (L+1) x dh) products of 2 FLOPs a MAC (2 forward, 5 backward)."""
    groups, length = (f, n) if mode == "space" else (n, f)
    per_head = groups * length * (length + 1) + f * n + 1
    return 2.0 * matmuls * b * h * per_head * dh


def gib(n_bytes: float) -> str:
    return f"{n_bytes / 2 ** 30:.2f} GiB"


def packed_mask(torch, dev, mode: str):
    """The packed divided attention as a boolean (1 + f*n)^2 mask, True where
    a query sees a key: the CLS query sees every key, a patch the CLS and the
    patches of its frame (space) or of its spatial position (time)."""
    idx = torch.arange(F_T * N_P, device=dev)
    group = idx // N_P if mode == "space" else idx % N_P
    mask = torch.ones(SEQ, SEQ, dtype=torch.bool, device=dev)
    mask[1:, 1:] = group[:, None] == group[None, :]
    return mask


def kernel_cases(torch, dev):
    """(key, label, kernel fn, plain fn on given dtype, (bytes, FLOPs), library
    fn or None) at main-path shapes. A library fn returns (B, heads, L, dh);
    a key with a suffix ('K7c 12x64') is another shape of its kernel, checked
    and logged but not reported."""
    import torch.nn.functional as F

    from synchformer_tpu_torch.ops.kernels.cls_pool import fused_cls_pool_tokens
    from synchformer_tpu_torch.ops.kernels.divided_attention import (
        divided_attention,
        divided_attention_packed,
    )
    from synchformer_tpu_torch.ops.kernels.divided_attention_bwd import (
        divided_attention_bwd,
        divided_attention_bwd_plain,
        divided_attention_packed_bwd,
        divided_attention_packed_bwd_plain,
    )
    from synchformer_tpu_torch.ops.kernels.fused_rows import fused_ln_mlp_residual
    from synchformer_tpu_torch.ops.kernels.standard_attention import standard_attention

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    d, hid, h = 768, 3072, 12

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def ln_params():
        return (1.0 + rn(d, std=0.1, dtype=torch.float32), rn(d, std=0.1, dtype=torch.float32))

    def mlp_params():
        return (rn(hid, d, std=0.02), rn(hid, std=0.02, dtype=torch.float32),
                rn(d, hid, std=0.02), rn(d, std=0.02, dtype=torch.float32))

    def cast(args, dtype):
        return [a.to(dtype) if torch.is_tensor(a) and a.dtype == bf else a for a in args]

    cases = k1_k2_cases(torch, dev)
    bs = B * S
    qkv = rn(bs, 74, 3 * d)
    q, k, v = (qkv.view(bs, 74, 3, h, DH)[:, :, i].transpose(1, 2) for i in range(3))
    cases.append(("K3", f"K3 ({bs},74,2304)",
                  lambda: standard_attention(qkv, h),
                  lambda dt: standard_attention(qkv.to(dt), h, impl="plain"),
                  (bs * 74 * 4 * d * 2, 4.0 * bs * h * 74 * 74 * DH),
                  lambda: F.scaled_dot_product_attention(q, k, v)))
    for label, shape in ((f"spatial ({bs * F_T},196,768)", (bs * F_T, N_P, d)),
                         (f"frequency ({bs * 6},12,768)", (bs * 6, 12, d))):
        g1, b1 = ln_params()
        g2_, b2_ = ln_params()
        args = [rn(*shape), rn(d, std=0.02, dtype=torch.float32), g1, b1,
                rn(3 * d, d, std=0.02), rn(3 * d, std=0.02, dtype=torch.float32),
                rn(d, d, std=0.02), rn(d, std=0.02, dtype=torch.float32), g2_, b2_,
                *mlp_params()]
        groups, m = shape[0], shape[1]
        # with one shared query: q and U = Wk^T q once; per group logits and
        # the p-weighted sum over m + 1 rows per head, Wv, proj and the MLP
        flops = 4.0 * d * d + groups * (4.0 * h * (m + 1) * d + 4.0 * d * d + 4.0 * d * hid)
        nbytes = (groups * m * d * 2 + (4 * d * d + 2 * d * hid) * 2 + (9 * d + hid) * 4
                  + groups * d * 2)
        cases.append(("K4", f"K4 {label}",
                      lambda a=args: fused_cls_pool_tokens(*a, num_heads=h, eps=1e-6),
                      lambda dt, a=args: fused_cls_pool_tokens(*cast(a, dt), num_heads=h,
                                                               eps=1e-6, impl="plain"),
                      (nbytes, flops), None))
    # K5 / K6 at Stage I's segments: B1 x S
    bs1 = B1 * S
    qkv_p1, qkv_c1 = rn(bs1, F_T, N_P, 3 * d), rn(bs1, 1, 3 * d)
    dop, doc = rn(bs1, F_T, N_P, d), rn(bs1, 1, d)
    act1 = bs1 * F_T * N_P * d * 2
    # K5's and K6's library yardsticks: the masked scaled_dot_product_attention
    # over the same rows in the packed layout (packed outside the timed
    # call), 12 heads of 64; its forward for K5, its backward for K6
    qkv6 = torch.cat([qkv_c1, qkv_p1.reshape(bs1, -1, 3 * d)], 1)
    do6 = torch.cat([doc, dop.reshape(bs1, -1, d)], 1)
    masks = {mode: packed_mask(torch, dev, mode) for mode in ("space", "time")}
    q6, k6, v6 = (qkv6.view(bs1, SEQ, 3, h, DH)[:, :, i].transpose(1, 2) for i in range(3))
    for mode in ("space", "time"):
        cases.append(("K5", f"K5 {mode} ({bs1},8,196,2304)",
                      lambda m=mode: divided_attention(qkv_p1, qkv_c1, h, m),
                      lambda dt, m=mode: divided_attention(qkv_p1.to(dt), qkv_c1.to(dt), h, m,
                                                           impl="plain"),
                      (4 * act1 + 2 * bs1 * 4 * d * 2, attention_flops(bs1, mode, 2)),
                      lambda m=mode: F.scaled_dot_product_attention(q6, k6, v6,
                                                                    attn_mask=masks[m])))
    for mode in ("space", "time"):
        cases.append(("K6", f"K6 {mode} ({bs1},8,196,2304)",
                      lambda m=mode: divided_attention_bwd(qkv_p1, qkv_c1, dop, doc, h, m),
                      lambda dt, m=mode: divided_attention_bwd_plain(
                          *cast([qkv_p1, qkv_c1, dop, doc], dt), h, m),
                      (7 * act1 + 2 * bs1 * 7 * d * 2, attention_flops(bs1, mode, 5)),
                      sdpa_backward(torch, qkv6, do6, h, DH, masks[mode])))
    # K6's space pass at n <= 47, where the CLS key's per-group partials take
    # the loop its small-frame repair added (checked and logged only)
    n36 = rn(bs1, F_T, 36, 3 * d), rn(bs1, 1, 3 * d), rn(bs1, F_T, 36, d), rn(bs1, 1, d)
    cases.append(("K6 n36", f"K6 space ({bs1},8,36,2304)",
                  lambda: divided_attention_bwd(*n36, h, "space"),
                  lambda dt: divided_attention_bwd_plain(*cast(list(n36), dt), h, "space"),
                  (7 * bs1 * F_T * 36 * d * 2 + 2 * bs1 * 7 * d * 2,
                   10.0 * bs1 * h * (F_T * 36 * 37 + F_T * 36 + 1) * DH), None))
    # K7a / K7c at the 8-head Stage I step's packed qkv, K7b at 12 heads of 64;
    # the library yardstick: one masked scaled_dot_product_attention over the
    # whole packed sequence (mask built outside the timed call)
    qkv7, do7 = rn(bs1, SEQ, 3 * d), rn(bs1, SEQ, d)
    act7 = bs1 * SEQ * d * 2
    for key, heads, dh in (("K7a", H8, DH8), ("K7b", h, DH)):
        q7, k7, v7 = (qkv7.view(bs1, SEQ, 3, heads, dh)[:, :, i].transpose(1, 2)
                      for i in range(3))
        for mode in ("space", "time"):
            cases.append((key, f"{key} {mode} ({bs1},{SEQ},2304) {heads}x{dh}",
                          lambda m=mode, hh=heads: divided_attention_packed(qkv7, hh, F_T, m),
                          lambda dt, m=mode, hh=heads: divided_attention_packed(
                              qkv7.to(dt), hh, F_T, m, impl="plain"),
                          (4 * act7, attention_flops(bs1, mode, 2, heads, dh)),
                          lambda m=mode, q=q7, k=k7, v=v7: F.scaled_dot_product_attention(
                              q, k, v, attn_mask=masks[m])))
    # K7c at the 8-head step's heads (reported, with the backward of K7a's
    # masked scaled_dot_product_attention as its yardstick) and at the packed
    # block's 12 heads of 64 (checked and logged only)
    for key, heads, dh in (("K7c", H8, DH8), (f"K7c {h}x{DH}", h, DH)):
        for mode in ("space", "time"):
            cases.append((key, f"K7c {mode} ({bs1},{SEQ},2304) {heads}x{dh}",
                          lambda m=mode, hh=heads: divided_attention_packed_bwd(
                              qkv7, do7, hh, F_T, m),
                          lambda dt, m=mode, hh=heads: divided_attention_packed_bwd_plain(
                              qkv7.to(dt), do7.to(dt), hh, F_T, m),
                          (7 * act7, attention_flops(bs1, mode, 5, heads, dh)),
                          sdpa_backward(torch, qkv7, do7, heads, dh, masks[mode])
                          if key == "K7c" else None))
    # K2 at a width the Hopper GEMM takes in 64-column pieces (checked and
    # logged only): D = 192, hidden 768
    d2 = 192
    args = [rn(bs1, F_T, 49, d2), 1.0 + rn(d2, std=0.1, dtype=torch.float32),
            rn(d2, std=0.1, dtype=torch.float32), rn(4 * d2, d2, std=0.05),
            rn(4 * d2, std=0.02, dtype=torch.float32), rn(d2, 4 * d2, std=0.05),
            rn(d2, std=0.02, dtype=torch.float32), 1e-6]
    rows2 = bs1 * F_T * 49
    cases.append(("K2 d192", f"K2 ({bs1},{F_T},49,{d2}) -> {4 * d2}",
                  lambda a=args: fused_ln_mlp_residual(*a),
                  lambda dt, a=args: fused_ln_mlp_residual(*cast(a, dt), impl="plain"),
                  (2 * rows2 * d2 * 2 + 2 * d2 * 4 * d2 * 2, 4.0 * rows2 * d2 * 4 * d2), None))
    return cases + k4b_cases(torch, dev) + k8_cases(torch, dev)


def sdpa_backward(torch, qkv, dout, heads: int, dh: int, mask):
    """A library yardstick for a divided attention's backward: the gradient
    (dq, dk, dv), each (B, heads, L, dh), of one masked
    scaled_dot_product_attention over views of the packed qkv (B, L, 3D) for
    the cotangent dout (B, L, D). The forward runs here, once; the returned
    fn runs the backward alone."""
    import torch.nn.functional as F

    b, seq = qkv.shape[:2]
    q, k, v = (qkv.view(b, seq, 3, heads, dh)[:, :, i].transpose(1, 2).detach()
               .requires_grad_() for i in range(3))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    grad = dout.view(b, seq, heads, dh).transpose(1, 2)
    return lambda: torch.autograd.grad(out, (q, k, v), grad, retain_graph=True)


def k1_k2_cases(torch, dev, bs: int = B * S, f: int = F_T, n: int = N_P, d: int = D,
                h: int = H, ast_tokens: int = 74) -> list:
    """kernel_cases' records of K1 (space and time) at sync inference's
    split qkv (bs, f, n, 3d), h heads, and of K2 at the video tower's
    (bs, f, n, d) with row statistics and at the AST's (bs, ast_tokens, d)
    rows, hidden 4d. The kernel calls look the wrappers up in their modules at
    call time, so that scripts/stage1_planted_faults.py can wrap their
    entries."""
    from synchformer_tpu_torch.ops.kernels import divided_attention as tda
    from synchformer_tpu_torch.ops.kernels import fused_rows as frows

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    hid = 4 * d

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def cast(args, dtype):
        return [a.to(dtype) if torch.is_tensor(a) and a.dtype == bf else a for a in args]

    cases = []
    wo, bo = rn(d, d, std=0.02), rn(d, std=0.02, dtype=torch.float32)
    qkv_p, qkv_c = rn(bs, f, n, 3 * d), rn(bs, 1, 3 * d)
    res = rn(bs, f, n, d)
    act = bs * f * n * d * 2  # one (bs, f, n, D) bf16 activation
    for mode in ("space", "time"):
        args = [qkv_p, qkv_c, res, wo, bo]
        cost = (5 * act + d * d * 2 + d * 4 + 2 * bs * 3 * d * 2,
                attention_flops(bs, mode, 2, h, d // h, f, n) + 2.0 * bs * f * n * d * d)
        cases.append(("K1", f"K1 {mode} ({bs},{f},{n},{3 * d})",
                      lambda a=args, m=mode: tda.divided_attention_proj(*a, h, m),
                      lambda dt, a=args, m=mode: tda.divided_attention_proj(
                          *cast(a, dt), h, m, impl="plain"),
                      cost, None))
    g2, b2 = 1.0 + rn(d, std=0.1, dtype=torch.float32), rn(d, std=0.1, dtype=torch.float32)

    def mlp_params():
        return (rn(hid, d, std=0.02), rn(hid, std=0.02, dtype=torch.float32),
                rn(d, hid, std=0.02), rn(d, std=0.02, dtype=torch.float32))

    weights = 2 * d * hid * 2 + (hid + 3 * d) * 4
    args = [rn(bs, f, n, d), g2, b2, *mlp_params(), 1e-6]
    rows = bs * f * n
    cases.append(("K2", f"K2 stats ({bs},{f},{n},{d})",
                  lambda a=args: frows.fused_ln_mlp_residual(*a, emit_stats=True),
                  lambda dt, a=args: frows.fused_ln_mlp_residual(*cast(a, dt), emit_stats=True,
                                                                 impl="plain"),
                  (2 * rows * d * 2 + rows * 8 * 4 + weights, 4.0 * rows * d * hid), None))
    args = [rn(bs, ast_tokens, d), g2, b2, *mlp_params(), 1e-12]
    rows = bs * ast_tokens
    cases.append(("K2", f"K2 rows ({bs},{ast_tokens},{d})",
                  lambda a=args: frows.fused_ln_mlp_residual(*a),
                  lambda dt, a=args: frows.fused_ln_mlp_residual(*cast(a, dt), impl="plain"),
                  (2 * rows * d * 2 + weights, 4.0 * rows * d * hid), None))
    return cases


def k4b_cases(torch, dev, d: int = D, h: int = H,
              shapes=((B1, 1 + S), (B1 * S * F_T, 1 + N_P))) -> list:
    """kernel_cases' records of K4b at ``shapes`` (groups, rows), the CLS row
    inside each group's rows: the MoCo step's video global aggregator (B1, 1 +
    S) (reported) and the Stage I spatial aggregator's groups with their CLS
    row inside (checked and logged only), where every group's row 0 and so its
    query differ."""
    from synchformer_tpu_torch.ops.kernels.cls_pool import cls_pool_plain, fused_cls_pool

    g = torch.Generator(device=dev).manual_seed(5)
    bf, f32 = torch.bfloat16, torch.float32
    hid = 4 * d

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def cast(args, dtype):
        return [a.to(dtype) if torch.is_tensor(a) and a.dtype == bf else a for a in args]

    # QKV and projection weights at std (2 / d)^0.5: logits of std 2, so the
    # attention is peaked and its output as large as the residual row's; a
    # wrong query then moves the output well above the 1% eps
    w_att = (2.0 / d) ** 0.5
    cases = []
    for i, (groups, n) in enumerate(shapes):
        args = [rn(groups, n, d), 1.0 + rn(d, std=0.1, dtype=f32), rn(d, std=0.1, dtype=f32),
                rn(3 * d, d, std=w_att), rn(3 * d, std=0.02, dtype=f32), rn(d, d, std=w_att),
                rn(d, std=0.02, dtype=f32), 1.0 + rn(d, std=0.1, dtype=f32),
                rn(d, std=0.1, dtype=f32), rn(hid, d, std=0.02), rn(hid, std=0.02, dtype=f32),
                rn(d, hid, std=0.02), rn(d, std=0.02, dtype=f32)]
        # per group: q and U = Wk^T q (2 D^2 each), logits and the p-weighted
        # sum over n rows per head, Wv, proj and the MLP
        flops = groups * (8.0 * d * d + 4.0 * h * n * d + 4.0 * d * hid)
        nbytes = (groups * n * d * 2 + (4 * d * d + 2 * d * hid) * 2 + (9 * d + hid) * 4
                  + groups * d * 2)
        what = "global" if i == 0 else "spatial"
        cases.append(("K4b" if i == 0 else f"K4b {what}", f"K4b {what} ({groups},{n},{d})",
                      lambda a=args: fused_cls_pool(*a, num_heads=h, eps=1e-6),
                      lambda dt, a=args: cls_pool_plain(*cast(a, dt), h, 1e-6),
                      (nbytes, flops), None))
    return cases


def check_k4b_concat(torch, dev, d: int = D, h: int = H, groups: int = B1 * S * F_T,
                     m: int = N_P, tag: str = "kernels") -> bool:
    """K4b over [cls; x] against K4 over x with the same CLS row (the JAX
    contract, tests/test_cls_pool.py:114-135): both held to the f32 anchor by
    hold_outputs' rule, and |K4b - K4| within that tolerance. Returns whether
    all three held."""
    from synchformer_tpu_torch.ops.kernels.cls_pool import (
        cls_pool_tokens_plain,
        fused_cls_pool,
        fused_cls_pool_tokens,
    )

    g = torch.Generator(device=dev).manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    x, cls = rn(groups, m, d), rn(d, dtype=f32)
    layer = [1.0 + rn(d, std=0.1, dtype=f32), rn(d, std=0.1, dtype=f32), rn(3 * d, d, std=0.02),
             rn(3 * d, std=0.02, dtype=f32), rn(d, d, std=0.02), rn(d, std=0.02, dtype=f32),
             1.0 + rn(d, std=0.1, dtype=f32), rn(d, std=0.1, dtype=f32),
             rn(4 * d, d, std=0.02), rn(4 * d, std=0.02, dtype=f32), rn(d, 4 * d, std=0.02),
             rn(d, std=0.02, dtype=f32)]
    full = torch.cat([cls.to(bf).expand(groups, 1, d), x], dim=1).contiguous()
    k4b = fused_cls_pool(full, *layer, num_heads=h, eps=1e-6)
    k4 = fused_cls_pool_tokens(x, cls, *layer, num_heads=h, eps=1e-6)
    plain = cls_pool_tokens_plain(x, cls, *layer, h, 1e-6)
    anchor = cls_pool_tokens_plain(x.float(), cls, *[t.float() for t in layer], h, 1e-6)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    label = f"K4b [cls; x] vs K4 ({groups},{1 + m},{d})"
    ok = not hold_outputs(f"{label}: K4b", k4b, plain, anchor, tag)[0]
    failed, _, tol = hold_outputs(f"{label}: K4", k4, plain, anchor, tag)
    diff = maxabs(k4b, k4)
    log(f"[{tag}] {label}: |K4b-K4| {diff:.3e} tol {tol:.3e} {'ok' if diff <= tol else 'FAIL'}")
    return ok and not failed and diff <= tol


def k8_cases(torch, dev, bs: int = B * S, f: int = F_T, n: int = N_P, d: int = D,
             heads: int = H8) -> list:
    """kernel_cases' records of K8a (space and time), K8b and K8c at the
    serving shape of the 8-head sync model's video tower: x (bs, 1 + f*n, d)
    with a row offset and scale a LayerNorm removes, ``heads`` heads, hidden
    4d, and K8c's LN + QKV product on the flattened rows; then K8b at
    another width, 2d / 3 rounded down to a multiple of 64 (512 at d = 768),
    hidden four times that, over a quarter of the segments (checked and
    logged only). The LN parameters are random, so a kernel that applies
    g / b to the wrong columns misses."""
    from synchformer_tpu_torch.ops.kernels.fused_block import (
        fused_divided_attention,
        fused_mlp_residual,
    )
    from synchformer_tpu_torch.ops.kernels.fused_rows import fused_ln_matmul

    g = torch.Generator(device=dev).manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, std=1.0, mean=0.0, dtype=bf):
        return (mean + torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def cast(args, dtype):
        return [a.to(dtype) if torch.is_tensor(a) and a.dtype == bf else a for a in args]

    seq, hid = 1 + f * n, 4 * d
    rows = bs * seq
    x = rn(bs, seq, d, std=2.0, mean=0.5)
    ln = (1.0 + rn(d, std=0.1, dtype=f32), rn(d, std=0.1, dtype=f32))
    w, bias = rn(3 * d, d, std=0.05), rn(3 * d, std=0.02, dtype=f32)
    act, wqkv = rows * d * 2, 3 * d * d * 2 + (3 * d + 2 * d) * 4
    cases = []
    for mode in ("space", "time"):
        args = [x, *ln, w, bias, heads, f, mode]
        flops = 2.0 * rows * d * 3 * d + attention_flops(bs, mode, 2, heads, d // heads)
        cases.append(("K8a", f"K8a {mode} ({bs},{seq},{d}) {heads}x{d // heads}",
                      lambda a=args: fused_divided_attention(*a),
                      lambda dt, a=args: fused_divided_attention(*cast(a, dt), impl="plain"),
                      (2 * act + wqkv, flops), None))
    args = [x, *ln, rn(hid, d, std=0.02), rn(hid, std=0.02, dtype=f32), rn(d, hid, std=0.02),
            rn(d, std=0.02, dtype=f32), 1e-6]
    cases.append(("K8b", f"K8b ({bs},{seq},{d}) -> {hid}",
                  lambda a=args: fused_mlp_residual(*a),
                  lambda dt, a=args: fused_mlp_residual(*cast(a, dt), impl="plain"),
                  (2 * act + 2 * d * hid * 2 + (hid + 3 * d) * 4, 4.0 * rows * d * hid), None))
    args = [x.view(rows, d), *ln, w, bias]
    cases.append(("K8c", f"K8c ({rows},{d}) -> {3 * d}",
                  lambda a=args: fused_ln_matmul(*a),
                  lambda dt, a=args: fused_ln_matmul(*cast(a, dt), impl="plain"),
                  (act + rows * 3 * d * 2 + wqkv, 2.0 * rows * d * 3 * d), None))
    bw, dw = max(1, bs // 4), max(64, 2 * d // 3 // 64 * 64)
    args = [rn(bw, seq, dw, std=2.0, mean=0.5), 1.0 + rn(dw, std=0.1, dtype=f32),
            rn(dw, std=0.1, dtype=f32), rn(4 * dw, dw, std=0.02),
            rn(4 * dw, std=0.02, dtype=f32), rn(dw, 4 * dw, std=0.02),
            rn(dw, std=0.02, dtype=f32), 1e-6]
    cases.append((f"K8b d{dw}", f"K8b ({bw},{seq},{dw}) -> {4 * dw}",
                  lambda a=args: fused_mlp_residual(*a),
                  lambda dt, a=args: fused_mlp_residual(*cast(a, dt), impl="plain"),
                  (2 * bw * seq * dw * 2 + 2 * dw * 4 * dw * 2, 4.0 * bw * seq * dw * 4 * dw),
                  None))
    return cases


# rows of NaN after a guard-band case's input: a kernel that reads past the
# last row of its input makes its output non-finite
GUARD_ROWS = 64


def guarded(torch, t):
    """t's values at the start of a larger buffer whose remainder is NaN."""
    n = t.numel()
    buf = torch.full((n + GUARD_ROWS * t.shape[-1],), float("nan"), dtype=t.dtype,
                     device=t.device)
    buf[:n] = t.flatten()
    return buf[:n].view(t.shape)


def ragged_cases(torch, dev, bs: int = 4, d: int = D, f: int = F_T, k3_lens=(17, 74, 197),
                 space_ns=(49, N_P), long_n: int = 300, time_ns=(49, N_P, 37),
                 bwd_ns=(207, 208, 300), bwd_time_n: int = 37) -> list:
    """kernel_cases' records (no cost, no library) of the two tensor-core
    attention kernels at ragged shapes, checked and logged only: K3 at
    ``k3_lens`` tokens (197: two sweeps over 80-key chunks); the space pass
    through K5's split entry and K7's packed entry at ``space_ns`` patches a
    frame for every head_dim of HEAD_DIMS, and packed at ``long_n`` patches,
    head_dim 64 (two sweeps over 208-key chunks); then each kernel with its
    input at the start of a NaN-filled buffer (guarded); then the time pass
    split and packed at ``time_ns`` patches a frame for every head_dim (49
    and 37: no tile of 2 or 4 positions divides them), and in guard bands;
    then the backward (K6 split, K7c packed, keyed 'bwd ragged'): the space
    pass at head_dim 128 and 196 patches, at ``bwd_ns`` patches (207: one
    208-row chunk of keys; 208 and 300: two) for every head_dim, split and
    packed, and the time pass at f frames of ``bwd_time_n`` patches for every
    head_dim, split and packed. The packed entries are
    called through divided_attention_bwd, where the packed flow's Function
    calls them, so that scripts/stage1_planted_faults.py can wrap them. q and k at
    std 1.5: logits of std about 2, so one key's weight can be large;
    cotangents at std 1."""
    from synchformer_tpu_torch.ops.kernels import divided_attention as tda
    from synchformer_tpu_torch.ops.kernels import divided_attention_bwd as dab
    from synchformer_tpu_torch.ops.kernels.standard_attention import standard_attention

    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16

    def rn(*shape):
        return (torch.randn(*shape, generator=g, device=dev) * 1.5).to(bf)

    def k3(qkv, label):
        h = d // DH
        return ("K3 ragged", label, lambda: standard_attention(qkv, h),
                lambda dt: standard_attention(qkv.to(dt), h, impl="plain"), None, None)

    def split(qkv_p, qkv_c, h, label, mode="space"):
        return (f"{mode} ragged", label, lambda: tda.divided_attention(qkv_p, qkv_c, h, mode),
                lambda dt: tda.divided_attention(qkv_p.to(dt), qkv_c.to(dt), h, mode,
                                                 impl="plain"), None, None)

    def packed(qkv, h, label, mode="space"):
        return (f"{mode} ragged", label,
                lambda: dab.divided_attention_packed(qkv, h, f, mode),
                lambda dt: dab.divided_attention_packed(qkv.to(dt), h, f, mode,
                                                        impl="plain"), None, None)

    cases = [k3(rn(4 * bs, n, 3 * d), f"K3 ({4 * bs},{n},{3 * d})") for n in k3_lens]
    for n in space_ns:
        for dh in tda.HEAD_DIMS:
            h = d // dh
            cases.append(split(rn(bs, f, n, 3 * d), rn(bs, 1, 3 * d), h,
                               f"space split ({bs},{f},{n},{3 * d}) {h}x{dh}"))
            cases.append(packed(rn(bs, 1 + f * n, 3 * d), h,
                                f"space packed ({bs},{1 + f * n},{3 * d}) {h}x{dh}"))
    cases.append(packed(rn(bs, 1 + f * long_n, 3 * d), d // 64,
                        f"space packed ({bs},{1 + f * long_n},{3 * d}) {d // 64}x64"))
    n = space_ns[-1]
    cases.append(k3(guarded(torch, rn(4 * bs, 74, 3 * d)), f"K3 guard band ({4 * bs},74,{3 * d})"))
    cases.append(split(guarded(torch, rn(bs, f, n, 3 * d)), guarded(torch, rn(bs, 1, 3 * d)),
                       d // 64, f"space split guard band ({bs},{f},{n},{3 * d}) {d // 64}x64"))
    cases.append(packed(guarded(torch, rn(bs, 1 + f * n, 3 * d)), d // 96,
                        f"space packed guard band ({bs},{1 + f * n},{3 * d}) {d // 96}x96"))
    # the time pass (a block per tile of spatial positions): every head_dim
    # at time_ns patches a frame, split and packed, then in guard bands
    for n in time_ns:
        for dh in tda.HEAD_DIMS:
            h = d // dh
            cases.append(split(rn(bs, f, n, 3 * d), rn(bs, 1, 3 * d), h,
                               f"time split ({bs},{f},{n},{3 * d}) {h}x{dh}", "time"))
            cases.append(packed(rn(bs, 1 + f * n, 3 * d), h,
                                f"time packed ({bs},{1 + f * n},{3 * d}) {h}x{dh}", "time"))
    n = time_ns[0]
    cases.append(split(guarded(torch, rn(bs, f, n, 3 * d)), guarded(torch, rn(bs, 1, 3 * d)),
                       d // 64, f"time split guard band ({bs},{f},{n},{3 * d}) {d // 64}x64",
                       "time"))
    cases.append(packed(guarded(torch, rn(bs, 1 + f * n, 3 * d)), d // 96,
                        f"time packed guard band ({bs},{1 + f * n},{3 * d}) {d // 96}x96",
                        "time"))

    def cot(*shape):
        return rn(*shape) / 1.5

    def bwd_split(n, h, mode="space"):
        args = (rn(bs, f, n, 3 * d), rn(bs, 1, 3 * d), cot(bs, f, n, d), cot(bs, 1, d))
        return ("bwd ragged", f"K6 {mode} ({bs},{f},{n},{3 * d}) {h}x{d // h}",
                lambda: dab.divided_attention_bwd(*args, h, mode),
                lambda dt: dab.divided_attention_bwd_plain(*(t.to(dt) for t in args), h, mode),
                None, None)

    def bwd_packed(n, h, mode="space"):
        args = (rn(bs, 1 + f * n, 3 * d), cot(bs, 1 + f * n, d))
        return ("bwd ragged", f"K7c {mode} ({bs},{1 + f * n},{3 * d}) {h}x{d // h}",
                lambda: dab.divided_attention_packed_bwd(*args, h, f, mode),
                lambda dt: dab.divided_attention_packed_bwd_plain(*(t.to(dt) for t in args), h,
                                                                  f, mode), None, None)

    cases.append(bwd_split(N_P, d // 128))
    for n in bwd_ns:
        for dh in tda.HEAD_DIMS:
            cases += [bwd_split(n, d // dh), bwd_packed(n, d // dh)]
    for dh in tda.HEAD_DIMS:
        cases += [bwd_split(bwd_time_n, d // dh, "time"), bwd_packed(bwd_time_n, d // dh, "time")]
    return cases


# the Hopper GEMM at its callers' shapes (rows, N, K, epilogue): K2's fc1 /
# fc2 at the video tower's and the AST's rows, K1's projection, K8a's QKV
# (K8c's product) and K8b's fc1 / fc2 at the 8-head serving tower's rows;
# then ragged rows (one, either side of the 128-row tile), 64-wide last
# column tiles (N = 192, 576) and K % 64 == 32 (K8c's d = 96)
GEMM_SHAPES = (
    ("K2 fc1 video", B * S * F_T * N_P, 4 * D, D, "gelu"),
    ("K2 fc2 video", B * S * F_T * N_P, D, 4 * D, "residual"),
    ("K2 fc1 AST", B * S * 74, 4 * D, D, "gelu"),
    ("K2 fc2 AST", B * S * 74, D, 4 * D, "residual"),
    ("K1 projection", B * S * F_T * N_P, D, D, "residual"),
    ("K8a QKV", B * S * SEQ, 3 * D, D, "bias"),
    ("K8b fc1", B * S * SEQ, 4 * D, D, "gelu_poly"),
    ("K8b fc2", B * S * SEQ, D, 4 * D, "residual"),
)
GEMM_RAGGED = ((1, D, D, "residual"), (127, 4 * D, D, "gelu"), (129, D, 4 * D, "residual"),
               (8288, 4 * D, D, "gelu"), (300, 384, 128, "bias"), (300, 192, 128, "residual"),
               (127, 576, 192, "gelu_poly"), (1, 192, D, "bias"), (127, 576, D, "gelu_poly"),
               (129, 4 * D, D, "gelu_poly"), (300, 3 * D, 96, "bias"),
               (300, 192, 32, "residual"))
# the guard-band cases (rows, N, K, epilogue): A, W and the residual each at
# the start of a NaN-filled buffer; at K = 96 the last k-step reaches past K
GEMM_GUARD = ((129, D, 4 * D, "residual"), (129, 576, 96, "residual"),
              (129, D, 96, "gelu_poly"))


def gemm_cases(torch, dev, shapes=GEMM_SHAPES, ragged=GEMM_RAGGED, guard=GEMM_GUARD) -> list:
    """(label, kernel fn, plain fn on given dtype, (bytes, FLOPs), library fn)
    of the Hopper GEMM alone (ops/kernels/gemm.py) at ``shapes`` (timed), at
    ``ragged`` rows (library None: checked and logged only) and at
    ``guard``'s, with each input at the start of a NaN-filled buffer
    (guarded). The library fn is one F.linear call with the bias (cuBLAS: a
    yardstick, never called by the port)."""
    import torch.nn.functional as F

    from synchformer_tpu_torch.ops.kernels.gemm import gemm

    g = torch.Generator(device=dev).manual_seed(8)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def case(label, m, n, k, epi, timed, wrap=lambda t: t):
        a, w = wrap(rn(m, k)), wrap(rn(n, k, std=k ** -0.5))
        bias = rn(n, std=0.1, dtype=f32)
        r = wrap(rn(m, n)) if epi == "residual" else None
        up = (lambda t, dt: None if t is None else t.to(dt))
        nbytes = (m * k + n * k + m * n * (2 if r is not None else 1)) * 2 + n * 4
        lib_bias = bias.to(bf)
        return (f"GEMM {label} ({m},{k}) -> {n} {epi}",
                lambda: gemm(a, w, bias, epi, r),
                lambda dt: gemm(a.to(dt), w.to(dt), bias, epi, up(r, dt), impl="plain"),
                (nbytes, 2.0 * m * n * k),
                (lambda: F.linear(a, w, lib_bias)) if timed else None)

    cases = [case(*shape, timed=True) for shape in shapes]
    cases += [case(f"ragged {m} rows", m, n, k, epi, False) for m, n, k, epi in ragged]
    cases += [case("guard band", m, n, k, epi, False, lambda t: guarded(torch, t))
              for m, n, k, epi in guard]
    return cases


def check_gemms(torch, dev) -> None:
    """gemm_cases, each held by hold_outputs' rule (the ragged and
    guard-band cases before any timing); the timed ones logged with TFLOP/s,
    their bound and one F.linear call's time."""
    cases = gemm_cases(torch, dev)
    for label, kern, plain, _, _ in cases:
        k_out, p_out, a_out = kern(), plain(torch.bfloat16), plain(torch.float32)
        torch.cuda.synchronize()
        if hold_outputs(label, k_out, p_out, a_out)[0]:
            fail(f"{label} outside tolerance")
        del k_out, p_out, a_out
    for label, kern, plain, cost, library in cases:
        if library is None:
            continue
        ms, lib_ms = cuda_time_ms(kern), cuda_time_ms(library)
        bound_ms, bound_by = bound(*cost)
        log(f"[timing] {label}: kernel {ms:.3f} ms = {cost[1] / ms / 1e9:.1f} TFLOP/s, "
            f"F.linear (cuBLAS) {lib_ms:.3f} ms = {cost[1] / lib_ms / 1e9:.1f} TFLOP/s, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {cost[0] / 1e6:.1f} MB, {cost[1] / 1e9:.2f} GFLOP)")


def check_ragged(torch, dev) -> None:
    """ragged_cases, each held by hold_outputs' rule; fails on any miss."""
    for _, label, kern, plain, _, _ in ragged_cases(torch, dev):
        k_out, p_out, a_out = kern(), plain(torch.bfloat16), plain(torch.float32)
        torch.cuda.synchronize()
        failed = hold_outputs(label, k_out, p_out, a_out, "ragged")[0]
        if failed:
            fail(f"{label} outputs {failed} outside tolerance")


def host_ms(torch, fn, calls: int = 20) -> float:
    """Host ms per call to enqueue ``calls`` calls of ``fn`` back to back,
    from an idle device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def launch_times(torch, fn, calls: int = 5) -> dict:
    """Device ms per call of each CUDA kernel that ``fn`` launches, by name,
    from torch.profiler over ``calls`` calls after one warm-up call; {} when
    the profiler records no device time."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            by_name[re.sub(r"\(.*", "", name)] += e.time_range.elapsed_us() / 1e3 / calls
    return dict(by_name)


def hold_outputs(label: str, k_out, p_out, a_out, tag: str = "kernels"):
    """Each output of a kernel case against the f32 anchor: finite, of the
    anchor's shape, and within 2 x the plain bf16 error + 1e-2 x max|anchor|.
    Returns (the failed output indices, the largest |kernel - plain|, output
    0's tolerance)."""
    failed, worst, tol0 = [], 0.0, 0.0
    k_out, p_out, a_out = (t if isinstance(t, tuple) else (t,) for t in (k_out, p_out, a_out))
    for i, (k, p, a) in enumerate(zip(k_out, p_out, a_out)):
        if k.shape != a.shape or not bool(k.float().isfinite().all()):
            log(f"[{tag}] {label} output {i}: shape {tuple(k.shape)} or non-finite values FAIL")
            failed.append(i)
            continue
        err_k, err_p = maxabs(k, a), maxabs(p, a)
        amax = float(a.float().abs().max())
        tol = 2.0 * err_p + 1e-2 * amax
        kp = maxabs(k, p)
        worst = max(worst, kp)
        if i == 0:
            tol0 = tol
        if err_k > tol:
            failed.append(i)
        rel = err_k / max(amax, 1e-30)
        log(f"[{tag}] {label} out{i}: |kernel-f32| {err_k:.3e} (rel {rel:.2e}) "
            f"|plain_bf16-f32| {err_p:.3e} |kernel-plain| {kp:.3e} tol {tol:.3e} "
            f"{'ok' if err_k <= tol else 'FAIL'}")
    return failed, worst, tol0


def check_kernels(torch, dev, report):
    check_gemms(torch, dev)
    if not check_k4b_concat(torch, dev):
        fail("K4b over [cls; x] disagrees with K4 over x")
    check_ragged(torch, dev)
    for key, label, kern, plain, cost, library in kernel_cases(torch, dev):
        k_out, p_out, a_out = kern(), plain(torch.bfloat16), plain(torch.float32)
        torch.cuda.synchronize()
        failed, worst, tol0 = hold_outputs(label, k_out, p_out, a_out)
        if failed:
            fail(f"{label} outputs {failed} outside tolerance")
        if library is not None:
            # the yardstick must compute the same function: held to output 0's
            # tolerance against the f32 anchor (a backward's (dq, dk, dv) as
            # the packed dqkv; against K6's split layout, its patch rows)
            lib_out = library()
            if isinstance(lib_out, tuple):
                lib_out = torch.cat(lib_out, 1)
            lib_out = lib_out.transpose(1, 2).flatten(2)
            want = a_out if torch.is_tensor(a_out) else a_out[0]
            if lib_out.shape != want.shape:
                lib_out = lib_out[:, 1:].reshape(want.shape)
            err_l = maxabs(lib_out, want)
            log(f"[kernels] {label} library: |library-f32| {err_l:.3e} tol {tol0:.3e} "
                f"{'ok' if err_l <= tol0 else 'FAIL'}")
            if err_l > tol0:
                fail(f"{label}: the library yardstick computes another function")
            del lib_out
        del k_out, p_out, a_out
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(lambda: plain(torch.bfloat16))
        lib_ms = cuda_time_ms(library) if library is not None else None
        bound_ms, bound_by = bound(*cost)
        log(f"[timing] {label}: kernel {ms:.3f} ms, plain bf16 {plain_ms:.3f} ms, "
            f"library {'-' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {cost[0] / 1e6:.1f} MB, {cost[1] / 1e9:.2f} GFLOP)")
        if key in BY_LAUNCH:  # the device time of each launch, the host's of a call
            for what, fn in (("", kern), (" library", library)):
                if fn is not None:
                    by = launch_times(torch, fn)
                    log(f"[timing] {label}{what} by launch (torch.profiler): "
                        + (", ".join(f"{name} {t:.4f} ms" for name, t in by.items())
                           or "not measured") + f"; host {host_ms(torch, fn):.4f} ms a call")
        if key not in report:  # another shape of a kernel: checked and logged only
            continue
        r = report[key]
        r["max_abs_err"] = max(r["max_abs_err"], worst)
        # the main paths call the divided attentions in both modes per block:
        # report the pair; the other kernels report their tower shape (the
        # first case listed)
        if key in PAIRED or "ms_set" not in r:
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["bound_s"][0] += cost[0] / HBM_BPS
            r["bound_s"][1] += cost[1] / BF16_FLOPS
            if lib_ms is not None:
                r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
            r["ms_set"] = True


def slice_inputs(torch, dev, b: int = B, s: int = S, frames=FRAMES, patch: int = 16):
    """Seeded patch-major uint8 video (b, s, ...) and PCM (b, s, 10240) on dev."""
    import numpy as np

    from synchformer_tpu_torch.ops.video import patchify_frames

    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (b, s, *frames), dtype=np.uint8)
    video = torch.from_numpy(np.ascontiguousarray(patchify_frames(u8, 2, patch))).to(dev)
    pcm = torch.from_numpy((rng.standard_normal((b, s, 10240)) * 0.1).astype(np.float32)).to(dev)
    return video, pcm


def run_slice(torch, dev, report):
    from synchformer_tpu_torch.infer import SyncPredictor
    from synchformer_tpu_torch.models.presets import build_synchformer
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict

    t0 = time.perf_counter()
    sd = seeded_state_dict(build_synchformer(S, device="meta"), seed=0)
    video, pcm = slice_inputs(torch, dev)
    log(f"[slice] weights + inputs {time.perf_counter() - t0:.1f} s; video {tuple(video.shape)} "
        f"{video.dtype}, pcm {tuple(pcm.shape)}")

    def predictor(dtype, impl):
        m = build_synchformer(S, device=dev)
        load_numpy_state_dict(m, sd)
        return SyncPredictor(m, dev, dtype, impl)

    p32 = predictor(torch.float32, "plain")
    ref = serving_record(torch, p32, video, pcm)
    del p32
    pk = predictor(torch.bfloat16, "kernel")
    pp = predictor(torch.bfloat16, "plain")

    torch.cuda.synchronize()
    _build.launches.clear()
    kern = serving_record(torch, pk, video, pcm)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    log(f"[slice] launches in one kernel-path forward: {counts}")
    for key, need in MIN_LAUNCHES.items():
        if counts.get(key, 0) < need:
            fail(f"{key} launched {counts.get(key, 0)} times, expected >= {need}")
        report[key]["launches"] = counts[key]
    plain = serving_record(torch, pp, video, pcm)
    for name, rec in (("kernel", kern), ("plain", plain)):
        t = rec["probs"]
        if t.shape != (B, 21) or not bool(torch.isfinite(t).all()):
            fail(f"{name} path probabilities: shape {tuple(t.shape)} or non-finite")
    log(f"[slice] max|kernel-plain| probs {maxabs(kern['probs'], plain['probs']):.3e}; logits "
        f"max|kernel-f32| {maxabs(kern['logits'], ref['logits']):.3e}, max|plain_bf16-f32| "
        f"{maxabs(plain['logits'], ref['logits']):.3e}; f32 top-1 "
        f"{ref['probs'].argmax(-1).tolist()} kernel top-1 {kern['probs'].argmax(-1).tolist()}")
    failed = serving_agreement(ref, plain, kern, "slice")
    if failed:
        fail(f"kernel-path forward outside tolerance: {failed}")

    times = {"plain": [], "kernel": []}
    for impl in ("plain", "kernel", "kernel", "plain"):
        pred = pk if impl == "kernel" else pp
        pred(video, pcm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            pred(video, pcm)
        torch.cuda.synchronize()
        times[impl].append((time.perf_counter() - t0) / 3)
    for impl, ts in times.items():
        best = min(ts)
        log(f"[timing] slice {impl} path: {best * 1e3:.1f} ms/batch of {B} clips "
            f"= {B / best:.2f} clips/s (runs {[round(t * 1e3, 1) for t in ts]} ms)")


def serving_record(torch, pred, video, pcm) -> dict:
    """One SyncPredictor forward: its logits, probabilities and the video
    tower's output features (read by a forward hook), in f32."""
    feats = {}
    hook = pred.model.vfeat_extractor.register_forward_hook(
        lambda mod, args, out: feats.update(v=out.float()))
    try:
        logits = pred.logits(video, pcm).float()
    finally:
        hook.remove()
    return {"logits": logits, "probs": torch.softmax(logits, -1), "vfeat": feats["v"]}


def serving_agreement(ref: dict, plain: dict, kern: dict, tag: str) -> list:
    """Hold serving_record's kernel record against the f32 one: finite
    values of the f32 shapes; the probabilities within 2 x the plain bf16
    error + 5e-3 (phase 3's rule); the video tower's features by relative L2
    error within 2 x plain's, no eps (at seeded weights the probabilities sit
    near 1/21 and move little when one kernel is wrong; the features do not).
    Returns the names of the checks that failed."""
    failed = []
    for name, a in ref.items():
        k, p = kern[name], plain[name]
        if k.shape != a.shape or not bool(k.isfinite().all()):
            log(f"[{tag}] {name}: shape {tuple(k.shape)} or non-finite values FAIL")
            failed.append(name)
            continue
        if name == "logits":
            continue
        if name == "probs":
            err_k, err_p = maxabs(k, a), maxabs(p, a)
            tol = 2.0 * err_p + 5e-3
        else:
            a64 = a.double()
            err_k, err_p = (float((t.double() - a64).norm() / a64.norm()) for t in (k, p))
            tol = 2.0 * err_p
        if err_k > tol:
            failed.append(name)
        log(f"[{tag}] {name}: |kernel-f32| {err_k:.3e} |plain_bf16-f32| {err_p:.3e} "
            f"tol {tol:.3e} {'ok' if err_k <= tol else 'FAIL'}")
    return failed


def run_serving_8head(torch, dev, report):
    """The 8-head sync model (build_synchformer_8head: the video tower at 8
    heads of 96, the packed flow) under attn_impl='pallas_fused' through
    SyncPredictor at B=8, S=14: bf16 kernel (K8a, K8b), bf16 plain and f32
    plain from one seeded state dict; exact launch counts, serving_agreement,
    then clips/s of both routes' kernel paths and of the plain path, taken in
    turns, the same weights on attn_impl='pallas' (K7a, K2) beside them."""
    from synchformer_tpu_torch.infer import SyncPredictor
    from synchformer_tpu_torch.models.presets import build_synchformer_8head
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict

    tag = "serving_8head"
    sd = seeded_state_dict(build_synchformer_8head(S, device="meta"), seed=0)
    video, pcm = slice_inputs(torch, dev)

    def predictor(dtype, impl, attn_impl="pallas_fused"):
        m = build_synchformer_8head(S, attn_impl, device=dev)
        load_numpy_state_dict(m, sd)
        return SyncPredictor(m, dev, dtype, impl)

    def counted(pred, want, what):
        torch.cuda.synchronize()
        _build.launches.clear()
        rec = serving_record(torch, pred, video, pcm)
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        log(f"[{tag}] launches in one {what} forward: {counts}")
        for key, need in want.items():
            if counts.get(key, 0) != need:
                fail(f"{tag}: {key} launched {counts.get(key, 0)} times in one {what} forward, "
                     f"expected {need}")
        return rec, counts

    p32 = predictor(torch.float32, "plain")
    ref = serving_record(torch, p32, video, pcm)
    del p32
    preds = {"fused": predictor(torch.bfloat16, "kernel"),
             "plain": predictor(torch.bfloat16, "plain"),
             "pallas": predictor(torch.bfloat16, "kernel", "pallas")}
    kern, counts = counted(preds["fused"], SERVING_FUSED_LAUNCHES, "pallas_fused kernel-path")
    for key in KEYS:
        if PATHS[key] == "sync_inference_8head_fused":
            report[key]["launches"] = counts[key]
    plain = serving_record(torch, preds["plain"], video, pcm)
    failed = serving_agreement(ref, plain, kern, tag)
    log(f"[{tag}] f32 top-1 {ref['probs'].argmax(-1).tolist()} kernel top-1 "
        f"{kern['probs'].argmax(-1).tolist()}")
    if failed:
        fail(f"{tag}: kernel path outside tolerance: {failed}")
    counted(preds["pallas"], SERVING_PALLAS_LAUNCHES, "pallas kernel-path")

    times = {name: [] for name in preds}
    for name in ("plain", "fused", "pallas", "pallas", "fused", "plain"):
        pred = preds[name]
        pred(video, pcm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            pred(video, pcm)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / 3)
    for name, what in (("fused", "pallas_fused kernel"), ("pallas", "pallas kernel"),
                       ("plain", "plain")):
        best = min(times[name])
        log(f"[timing] {tag} {what} path: {best * 1e3:.1f} ms/batch of {B} clips = "
            f"{B / best:.2f} clips/s (runs {[round(t * 1e3, 1) for t in times[name]]} ms)")


def stage1_batch(torch, b: int, s: int, frames=FRAMES) -> dict:
    """One seeded loader batch: uint8 frames (b, s, *frames), PCM (b, s, 10240)."""
    import numpy as np

    rng = np.random.default_rng(2)
    return {"video": torch.from_numpy(rng.integers(0, 256, (b, s, *frames), dtype=np.uint8)),
            "audio": torch.from_numpy((rng.standard_normal((b, s, 10240)) * 0.1)
                                      .astype(np.float32))}


def stage1_trainer(build, state_dict, dev, precision: str, impl: str, remat: bool = False,
                   moco: bool = False):
    """An AVCLIPTrainer on ``build(remat=..., device=dev)`` loaded with
    ``state_dict``: Stage I's optimiser settings, generator seed 0, flip p 0.5;
    with ``moco``, cfg.model.target names MultilevelMoCoCLIP and alpha is
    MOCO_ALPHA."""
    from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict

    model = build(remat=remat, device=dev)
    load_numpy_state_dict(model, state_dict)
    cfg = {"training": {"seed": 0, "precision": precision, "learning_rate": 1e-4,
                        "weight_decay": 0.2, "warmup": 1000, "total_steps": 100_000,
                        "max_clip_norm": MAX_CLIP, "zero_shot_window": 8, "alpha": MOCO_ALPHA},
           "data": {"p_horizontal_flip": 0.5, "p_audio_aug": 0.0}}
    if moco:
        cfg["model"] = {"target": MOCO_TARGET}
    return AVCLIPTrainer(cfg, device=dev, model=model, impl=impl)


def checked_step(tr, batch, what: str) -> dict:
    """One train step's metrics, failing on a non-finite loss or gradient norm
    or (AVCLIP) a logit scale outside its clamp."""
    import math

    m = tr.train_step(batch)
    if not (m["loss_finite"] and math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
        fail(f"{what}: non-finite loss or gradient norm {m}")
    if "logit_scale" in m and not 0.001 <= m["logit_scale"] <= 0.5:
        fail(f"{what}: logit scale {m['logit_scale']} outside [0.001, 0.5]")
    return m


def step_gradients(torch, tr, m, leaves_re=STAGE1_LEAVES) -> dict:
    """The gradient of the step just taken, as Stage I's check reads it: the
    metrics, every parameter's gradient flattened in f32 (``flat``), and the
    leaves that K5 / K6 feed directly (``leaves``), undone from the clip: each
    video block's time and space qkv weight, split into its q, k and v rows
    (at random weights the attention is near uniform and the v rows carry
    most of the norm), each qkv bias whole (its k part is zero in exact math:
    the softmax is shift-invariant), and the video CLS token, whose gradient
    flows through the CLS rows of every divided attention. ``leaves_re``
    picks the leaves (MOCO_LEAVES for the MoCo step, whose aggregator
    in_proj weights split the same way)."""
    unclip = max(m["grad_norm"] / MAX_CLIP, 1.0)
    named = dict(tr.model.named_parameters())
    leaves = {}
    for name, p in named.items():
        if leaves_re.fullmatch(name):
            g = p.grad.float() * unclip
            if name.endswith(("qkv.weight", "in_proj_weight")):
                leaves.update({f"{name}[{part}]": rows for part, rows in zip("qkv", g.chunk(3))})
            else:
                leaves[name] = g
    return {"metrics": m,
            "flat": torch.cat([p.grad.float().flatten() for p in named.values()]),
            "leaves": leaves}


def stage1_agreement(ref: dict, plain: dict, kern: dict, tag: str = "stage1",
                     metric_eps=(("loss", 1e-4), ("grad_norm", 1e-3))) -> list:
    """Hold the kernel path's first step against the f32 run, each check at
    2 x the plain bf16 path's error (the two bf16 paths round at other places
    only inside the kernels). Arguments are step_gradients' records; returns
    the names of the checks that failed.
    - loss, eps 1e-4 x |f32 loss|: the mean of 56 f32 cross-entropies over
      bf16 features; bf16 paths have read 5e-5 from f32, and at random
      weights the loss sits 0.015 above chance (ln 28), so eps is 2% of that;
    - gradient norm, eps 1e-3 x the f32 norm (both bf16 paths read ~0.3%
      low, the same rounding); ``metric_eps`` lists these metrics and their
      relative eps;
    - every leaf of step_gradients, relative L2 error, no eps;
    - 1 - cosine of the whole flattened gradient to the f32 one, no eps."""
    failed = []

    def check(name, err_k, err_p, eps):
        tol = 2.0 * err_p + eps
        ok = err_k <= tol
        if not ok:
            failed.append(name)
        return ok, tol

    for key, rel_eps in metric_eps:
        r = ref["metrics"][key]
        err_k, err_p = abs(kern["metrics"][key] - r), abs(plain["metrics"][key] - r)
        ok, tol = check(key, err_k, err_p, rel_eps * abs(r))
        log(f"[{tag}] {key}: |kernel-f32| {err_k:.3e}, |plain_bf16-f32| {err_p:.3e}, "
            f"tol {tol:.3e} {'ok' if ok else 'FAIL'}")

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    worst, bad = (0.0, ""), 0
    for name, g in ref["leaves"].items():
        err_k, err_p = rel(kern["leaves"][name], g), rel(plain["leaves"][name], g)
        ok, _ = check(name, err_k, err_p, 0.0)
        bad += not ok
        worst = max(worst, (err_k / max(err_p, 1e-30), f"{name} {err_k:.3e} vs {err_p:.3e}"))
    log(f"[{tag}] {len(ref['leaves'])} attention-fed gradient leaves, relative L2 error to "
        f"f32 within 2 x plain bf16's: {len(ref['leaves']) - bad} ok, {bad} FAIL; worst "
        f"ratio {worst[0]:.3f} ({worst[1]})")

    def one_minus_cos(a, b):
        a, b = a.double(), b.double()
        return 1.0 - float((a * b).sum() / (a.norm() * b.norm()))

    err_k, err_p = one_minus_cos(kern["flat"], ref["flat"]), one_minus_cos(plain["flat"],
                                                                           ref["flat"])
    ok, tol = check("cosine", err_k, err_p, 0.0)
    log(f"[{tag}] gradient 1 - cosine to f32: kernel {err_k:.3e}, plain bf16 {err_p:.3e}, "
        f"tol {tol:.3e} {'ok' if ok else 'FAIL'}")
    return failed


def run_stage1(torch, dev, report, build=None, launches=STAGE1_LAUNCHES,
               eval_launches=STAGE1_EVAL_LAUNCHES, tag="stage1", path="stage1_train",
               fused=None):
    """The Stage I step of ``build`` (default build_avclip) through
    AVCLIPTrainer: (c) f32 plain with remat, (a) bf16 kernel, (b) bf16 plain;
    exact launch counts of (a)'s first step (reported for the kernels whose
    PATHS entry is ``path``) and of an eval step, agreement, then timing
    windows of 3 steps (plain, kernel, kernel, plain) and the peak memory of
    each bf16 path's first step. ``fused``: (build, launches, eval launches)
    of the same model on attn_impl='pallas_fused', whose bf16 kernel step (d)
    is held against (c) and (b) (its plain route is the same composition),
    counted, and timed in the same turns."""
    from synchformer_tpu_torch.models.presets import build_avclip
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.utils.convert import seeded_state_dict

    build = build or build_avclip
    t0 = time.perf_counter()
    sd = seeded_state_dict(build(device="meta"), seed=0)
    batch = stage1_batch(torch, B1, S)
    log(f"[{tag}] weights + batch {time.perf_counter() - t0:.1f} s; video "
        f"{tuple(batch['video'].shape)} uint8, audio {tuple(batch['audio'].shape)}")

    def trainer(precision, impl, remat=False, make=build):
        return stage1_trainer(make, sd, dev, precision, impl, remat)

    def first_step(tr, what, resident=0):
        """step_gradients' record of the first step, and its peak memory above
        ``resident`` bytes (what was allocated before the trainer was built:
        another trainer's state, earlier gradients)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        m = checked_step(tr, batch, what)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - resident
        log(f"[{tag}] {what} first step: loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.6f}, logit_scale {m['logit_scale']:.6f}, {secs:.2f} s, "
            f"peak memory {gib(peak)}")
        return step_gradients(torch, tr, m), peak

    def exact_counts(what, want):
        counts = dict(_build.launches)
        log(f"[{tag}] launches in {what}: {counts}")
        for key, need in want.items():
            if counts.get(key, 0) != need:
                fail(f"{tag}: {key} launched {counts.get(key, 0)} times in {what}, "
                     f"expected {need}")
        return counts

    t0 = time.perf_counter()
    tr = trainer("fp32", "plain", remat=True)
    ref, _ = first_step(tr, "(c) f32 plain, remat")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] (c) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    resident = torch.cuda.memory_allocated()
    trainers = {"kernel": trainer("amp", "kernel")}
    _build.launches.clear()
    kern, k_peak = first_step(trainers["kernel"], "(a) bf16 kernel", resident)
    counts = exact_counts("one kernel-path step", launches)
    for key in KEYS:
        if PATHS[key] == path:
            report[key]["launches"] = counts[key]
    resident = torch.cuda.memory_allocated()
    trainers["plain"] = trainer("amp", "plain")
    plain, p_peak = first_step(trainers["plain"], "(b) bf16 plain", resident)
    peaks = {"kernel": k_peak, "plain": p_peak}
    order = ("plain", "kernel", "kernel", "plain")
    if fused is not None:
        resident = torch.cuda.memory_allocated()
        trainers["fused"] = trainer("amp", "kernel", make=fused[0])
        _build.launches.clear()
        kern_f, peaks["fused"] = first_step(trainers["fused"],
                                            "(d) bf16 kernel, attn_impl='pallas_fused'", resident)
        exact_counts("one pallas_fused kernel-path step", fused[1])
        order = ("plain", "kernel", "fused", "fused", "kernel", "plain")
    log(f"[{tag}] bf16 first steps {time.perf_counter() - t0:.1f} s")

    # 3 steps per window, in the order plain, kernel, kernel, plain (with
    # the fused route's windows in the middle)
    times = {name: [] for name in trainers}
    for name in order:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            checked_step(trainers[name], batch, name)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t) / 3)

    def eval_step(name, want):
        _build.launches.clear()
        out = trainers[name].eval_step(batch)
        torch.cuda.synchronize()
        exact_counts(f"one {name} eval step", want)
        if (out["vfeat"].shape != (B1, S, D) or not bool(torch.isfinite(out["loss"]))
                or not bool(torch.isfinite(out["vfeat"]).all())):
            fail(f"{tag} {name} eval step: features of the wrong shape or non-finite")
        log(f"[{tag}] {name} eval step: loss {out['loss'].item():.6f}, zero-shot precision "
            f"{out['precision'].item():.4f} (window 8 of {S} segments)")

    eval_step("kernel", eval_launches)
    if fused is not None:
        eval_step("fused", fused[2])
    del trainers

    failed = stage1_agreement(ref, plain, kern, tag)
    if fused is not None:
        failed += [f"fused {name}" for name in stage1_agreement(ref, plain, kern_f,
                                                                 f"{tag}_fused")]
    if failed:
        fail(f"{tag}: kernel-path first step outside tolerance: {failed}")
    for name, what in (("kernel", "kernel"), ("fused", "pallas_fused kernel"), ("plain", "plain")):
        if name not in times:
            continue
        best = min(times[name]) * 1e3
        log(f"[timing] {tag} {what} path: {best:.1f} ms/step of {B1} clips x {S} segments "
            f"= {B1 * 1e3 / best:.3f} samples/s (runs "
            f"{[round(t * 1e3, 1) for t in times[name]]} ms); peak memory {gib(peaks[name])}")


def run_stage1_8head(torch, dev, report):
    """Phase 6, with phase 7 (the step on attn_impl='pallas_fused') held
    against the same f32 and plain bf16 runs."""
    import functools

    from synchformer_tpu_torch.models.presets import build_avclip_8head

    fused = (functools.partial(build_avclip_8head, attn_impl="pallas_fused"),
             STAGE1_FUSED_LAUNCHES, STAGE1_FUSED_EVAL_LAUNCHES)
    run_stage1(torch, dev, report, build_avclip_8head, STAGE1_8HEAD_LAUNCHES,
               STAGE1_8HEAD_EVAL_LAUNCHES, "stage1_8head", "stage1_train_8head", fused)


def packed_block(torch, dev, b: int = B1 * S, d: int = D, h: int = H, f: int = F_T,
                 n: int = N_P):
    """(block, x, cotangent, f): a DividedSpaceTimeBlock of width d at h
    heads with seeded weights (LN scales 1 + 0.1 N(0,1), the rest 0.02
    N(0,1)), and a seeded f32 input (b, 1 + f*n, d) and output cotangent."""
    from synchformer_tpu_torch.models.motionformer import DividedSpaceTimeBlock

    g = torch.Generator(device=dev).manual_seed(3)
    blk = DividedSpaceTimeBlock(d, h, device=dev)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.startswith("norm"):
                p.copy_((1.0 if name.endswith("weight") else 0.0)
                        + 0.1 * torch.randn(p.shape, generator=g, device=dev))
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=g, device=dev))
    x0 = torch.randn(b, 1 + f * n, d, generator=g, device=dev)
    cot = torch.randn(b, 1 + f * n, d, generator=g, device=dev)
    return blk, x0, cot, f


def packed_block_grads(torch, setup, dtype, impl: str) -> dict:
    """One forward and backward of packed_block's block through forward_packed
    (training, drop-path 0: its MLP is K2) in ``dtype`` on route ``impl``:
    the output y, dx, and the time and space qkv weights' gradients by their
    q, k and v rows."""
    blk, x0, cot, f = setup
    blk.zero_grad(set_to_none=True)
    x = x0.detach().to(dtype).requires_grad_()  # a new leaf, also in f32
    y = blk.forward_packed(x, f, impl, None, None)
    (y.float() * cot).sum().backward()
    out = {"y": y.detach(), "dx": x.grad}
    named = dict(blk.named_parameters())
    for name in ("timeattn.qkv.weight", "attn.qkv.weight"):
        out.update({f"{name}[{part}]": rows.clone()
                    for part, rows in zip("qkv", named[name].grad.chunk(3))})
    return out


def packed_block_agreement(ref: dict, plain: dict, kern: dict) -> list:
    """Hold packed_block_grads' kernel record against the f32 one: y and dx
    by max-abs error within 2 x the plain bf16 record's + 1% of max|f32|; each
    weight's q, k and v rows by relative L2 error within 2 x plain's, no eps
    (a zero dk shows in the k rows as an error of 1). Returns the names that
    failed."""
    failed = []
    for name, a in ref.items():
        k, p = kern[name], plain[name]
        if name in ("y", "dx"):
            err_k, err_p = maxabs(k, a), maxabs(p, a)
            tol = 2.0 * err_p + 1e-2 * float(a.float().abs().max())
        else:
            a64 = a.double()
            err_k, err_p = (float((t.double() - a64).norm() / a64.norm()) for t in (k, p))
            tol = 2.0 * err_p
        ok = bool(k.float().isfinite().all()) and err_k <= tol
        if not ok:
            failed.append(name)
        log(f"[packed_block] {name}: |kernel-f32| {err_k:.3e} |plain_bf16-f32| {err_p:.3e} "
            f"tol {tol:.3e} {'ok' if ok else 'FAIL'}")
    return failed


def run_packed_block(torch, dev, report):
    """K7b's path: one packed DividedSpaceTimeBlock at 12 heads of 64 on
    (28, 1569, 768), forward and backward (training, drop-path 0), through
    the kernel route, against the plain route in bf16 and in f32."""
    from synchformer_tpu_torch.ops.kernels import _build

    setup = packed_block(torch, dev)
    torch.cuda.synchronize()
    _build.launches.clear()
    kern = packed_block_grads(torch, setup, torch.bfloat16, "kernel")
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    log(f"[packed_block] launches in one forward + backward: {counts}")
    for key, need in PACKED_BLOCK_LAUNCHES.items():
        if counts.get(key, 0) != need:
            fail(f"packed block: {key} launched {counts.get(key, 0)} times, expected {need}")
    report["K7b"]["launches"] = counts["K7b"]
    plain = packed_block_grads(torch, setup, torch.bfloat16, "plain")
    ref = packed_block_grads(torch, setup, torch.float32, "plain")
    failed = packed_block_agreement(ref, plain, kern)
    if failed:
        fail(f"packed block outside tolerance: {failed}")


def moco_record(torch, tr, m, feats: dict) -> dict:
    """step_gradients' record of a MoCo step over MOCO_LEAVES, with what the
    step wrote besides: the momentum model's parameters (flattened), the queue
    columns the keys went into, and the query pass's global aggregator
    outputs ``feats`` (video and audio, before normalisation), in f32."""
    rec = step_gradients(torch, tr, m, MOCO_LEAVES)
    q = tr.queues
    rec["ema"] = torch.cat([p.float().flatten() for p in tr.model_m.parameters()])
    rec["written"] = {
        "queue segment_v": q.segment_v[:, :B1 * S].float(),
        "queue segment_a": q.segment_a[:, :B1 * S].float(),
        "queue global_v": q.global_v[:, :B1].float(),
        "queue global_a": q.global_a[:, :B1].float(),
        **{f"query global_{k}": v for k, v in feats.items()}}
    return rec


def moco_agreement(ref: dict, plain: dict, kern: dict, tag: str = "moco") -> list:
    """stage1_agreement over moco_record's gradients with both levels' losses
    and the total (eps 1e-4 of each) and the gradient norm (1e-3), then, each
    by relative L2 error within 2 x the plain bf16 record's, no eps: the
    momentum parameters after the step (updated from the f32 masters before
    it, so both errors are 0), the keys written into the queues (the key
    pass, on the eval path's kernels) and the query pass's global aggregator
    outputs (the video one is K4b's). Returns the names that failed."""
    failed = stage1_agreement(ref, plain, kern, tag, (
        ("loss", 1e-4), ("segment_contrastive_loss", 1e-4),
        ("global_contrastive_loss", 1e-4), ("grad_norm", 1e-3)))

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    for name in ("ema", *ref["written"]):
        pick = (lambda r: r[name]) if name == "ema" else (lambda r: r["written"][name])
        a, k, p = pick(ref), pick(kern), pick(plain)
        err_k, err_p = rel(k, a), rel(p, a)
        ok = bool(k.isfinite().all()) and err_k <= 2.0 * err_p
        if not ok:
            failed.append(name)
        log(f"[{tag}] {name}: relative L2 |kernel-f32| {err_k:.3e} |plain_bf16-f32| "
            f"{err_p:.3e} tol {2.0 * err_p:.3e} {'ok' if ok else 'FAIL'}")
    return failed


def moco_first_step(torch, tr, batch, what: str, tag: str = "moco", resident: int = 0):
    """The first step of a MoCo trainer: moco_record's record and the peak
    memory above ``resident`` bytes (0 off the card)."""
    feats = {}
    hooks = [getattr(tr.model, f"{t}_encoder").global_attn_agg.register_forward_hook(
        lambda mod, args, out, t=t: feats.update({t: out.detach().float()})) for t in "va"]
    cuda = tr.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        m = checked_step(tr, batch, what)
    finally:
        for h in hooks:
            h.remove()
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident if cuda else 0
    log(f"[{tag}] {what} first step: loss {m['loss']:.6f} (segment "
        f"{m['segment_contrastive_loss']:.6f}, global {m['global_contrastive_loss']:.6f}), "
        f"grad_norm {m['grad_norm']:.6f}, {time.perf_counter() - t0:.2f} s, peak memory "
        f"{gib(peak)}")
    return moco_record(torch, tr, m, feats), peak


def run_moco(torch, dev, report, tag: str = "moco"):
    """The MoCo Stage I step (build_moco_avclip: build_avclip's towers with
    global representations, the video tower's positional dropout 0.1, queues
    1024 x 14 and 1024, alpha 0.4) through AVCLIPTrainer at B=2, S=14: (c) f32
    plain with remat, (a) bf16 kernel, (b) bf16 plain, from one seeded state
    dict, batch and generator seed; exact launch counts of (a)'s first step
    and of an eval step, moco_agreement, then 3-step windows in the order
    plain, kernel, kernel, plain, and each bf16 path's peak memory."""
    from synchformer_tpu_torch.models.presets import build_moco_avclip
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.utils.convert import seeded_state_dict

    t0 = time.perf_counter()
    sd = seeded_state_dict(build_moco_avclip(device="meta"), seed=0)
    batch = stage1_batch(torch, B1, S)
    log(f"[{tag}] weights + batch {time.perf_counter() - t0:.1f} s")

    def trainer(precision, impl, remat=False):
        return stage1_trainer(build_moco_avclip, sd, dev, precision, impl, remat, moco=True)

    tr = trainer("fp32", "plain", remat=True)
    ref, _ = moco_first_step(torch, tr, batch, "(c) f32 plain, remat", tag)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    resident = torch.cuda.memory_allocated()
    trainers = {"kernel": trainer("amp", "kernel")}
    _build.launches.clear()
    kern, k_peak = moco_first_step(torch, trainers["kernel"], batch, "(a) bf16 kernel", tag,
                                   resident)
    counts = dict(_build.launches)
    log(f"[{tag}] launches in one kernel-path step: {counts}")
    for key, need in MOCO_LAUNCHES.items():
        if counts.get(key, 0) != need:
            fail(f"{tag}: {key} launched {counts.get(key, 0)} times in one step, expected {need}")
    for key in KEYS:
        if PATHS[key] == "stage1_train_moco":
            report[key]["launches"] = counts.get(key, 0)
    resident = torch.cuda.memory_allocated()
    trainers["plain"] = trainer("amp", "plain")
    plain, p_peak = moco_first_step(torch, trainers["plain"], batch, "(b) bf16 plain", tag,
                                    resident)
    peaks = {"kernel": k_peak, "plain": p_peak}
    failed = moco_agreement(ref, plain, kern, tag)
    if failed:
        fail(f"{tag}: kernel-path first step outside tolerance: {failed}")
    del ref, plain, kern

    times = {name: [] for name in trainers}
    for name in ("plain", "kernel", "kernel", "plain"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            checked_step(trainers[name], batch, name)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t) / 3)

    _build.launches.clear()
    out = trainers["kernel"].eval_step(batch)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    log(f"[{tag}] launches in one kernel eval step: {counts}")
    for key, need in MOCO_EVAL_LAUNCHES.items():
        if counts.get(key, 0) != need:
            fail(f"{tag}: {key} launched {counts.get(key, 0)} times in one eval step, "
                 f"expected {need}")
    if (out["vfeat"].shape != (B1, S, D) or not bool(torch.isfinite(out["loss"]))
            or not bool(torch.isfinite(out["vfeat"]).all())):
        fail(f"{tag} eval step: features of the wrong shape or non-finite")
    log(f"[{tag}] kernel eval step: loss {out['loss'].item():.6f}, zero-shot precision "
        f"{out['precision'].item():.4f} (window 8 of {S} segments)")
    for name in ("kernel", "plain"):
        best = min(times[name]) * 1e3
        log(f"[timing] {tag} {name} path: {best:.1f} ms/step of {B1} clips x {S} segments "
            f"= {B1 * 1e3 / best:.3f} samples/s (runs "
            f"{[round(t * 1e3, 1) for t in times[name]]} ms); peak memory {gib(peaks[name])}")


PHASES = (check_kernels, run_slice, run_stage1, run_packed_block, run_stage1_8head,
          run_serving_8head, run_moco)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    try:
        from synchformer_tpu_torch.ops.kernels import _build
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    secs = _build.build_all()
    log(f"[build] nvcc sm_90a kernels in {secs:.1f} s -> {_build.BUILD_DIR}")

    report: dict = {key: {"launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                          "bound_s": [0.0, 0.0], "library_ms": None} for key in KEYS}
    for phase in PHASES:
        t0 = time.perf_counter()
        phase(torch, dev, report)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[phase] {phase.__name__} {time.perf_counter() - t0:.1f} s")
    kernels = []
    for key in KEYS:
        r = report[key]
        bound_ms = max(r["bound_s"]) * 1e3
        kernels.append({"name": NAMES[key], "route": "cuda", "source": SOURCES[key],
                        "replaces": REPLACES[key], "path": PATHS[key],
                        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                        "bound_by": ("bytes" if r["bound_s"][0] >= r["bound_s"][1]
                                     else "operations"),
                        "library_ms": r["library_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "not_ported": NOT_PORTED}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
