#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU: sync inference,
the Stage I contrastive training step, the same step with an 8-head video
tower, which runs the Motionformer's packed flow, on both attention routes
(attn_impl 'pallas' and 'pallas_fused'), sync inference with that tower on
both routes, the MoCo Stage I step with global representations, the
Stage II step and Stage III fine-tune over frozen towers, the audio
augmentations, and the training entry point (python -m
synchformer_tpu_torch.main: Stage I, II and III from the shipped configs
through the loader, fit, checkpoints and resume), data-parallel
training (DDP in a one-rank NCCL group, torchrun, two ranks over gloo), and
the reference-checkpoint entry points (python -m
synchformer_tpu_torch.example and python -m
synchformer_tpu_torch.scripts.test_syncability on reference-style .pt
files, and Stage I towers from one), and the legacy SparseSync family (S3D
and ResNet-18 towers in a Synchformer, the SparseSync transformer).

    python3 chip_smoke.py

Phases, each printed as it runs with its seconds:
1. device and build: torch / CUDA versions, the card's name and power limit,
   the media decoders the machine has (data.media.available_backends), the
   seconds nvcc took for the kernels (built into build/torch_kernels/).
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
   768), where each group's query differs; an AST layer at 8 heads of 96
   (112, 74, 768), whose heads do not pair into 128 lanes, so that K3's gate
   sends its attention to the plain composition (K3 0 launches, K2 1),
   checked but not reported; K8b also at D = 512, hidden 2048,
   and K2 at D = 192, hidden 768, both checked but not reported; K4b over
   [cls; x] against K4
   over x with the same CLS row, (224, 197, 768); K4, checked but not
   reported, at the 8-head tower's spatial aggregator (896, 196, 768), 8
   heads of 96, and (k4_cases) at the MoCo step's global aggregators (2, 14,
   768), at ragged rows (1, 13, 197 and 300 a group), at 700 groups of 12
   (the last block of three packed groups part-filled), in guard bands, and
   at 8 heads of 96 ragged and in a guard band; K4, checked, timed with
   its bound and not reported (k4_legacy_cases), at the legacy towers'
   pools: S3D's spatial (224, 49, 1024), 8 heads of 128, hidden 4096, and
   ResNet-18's frequency (336, 4, 512), 8 heads of 64, hidden 2048, the key
   weights part aligned with the query's so that the CLS key carries
   weight; and, checked but not
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
   K8a), K2, K8b, K8c, K4 and K4b, and their library calls, are also timed
   by launch with torch.profiler (device time only: the attention kernels,
   the CLS row, for the backwards its reduction, the LayerNorm pass and row
   statistics, for K1, K2, K8a-K8c, K4 and K4b the GEMMs, and K4's and
   K4b's prep, pool pass and Wv product, each apart) and by the host's time
   to enqueue a call.
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
10. the Stage II step: configs/sync.yaml's model section (as a dict,
   sync_config) built through the port's registry by SyncTrainer, its
   towers loaded from a Stage I checkpoint that the phase writes from a
   seeded full-width build_avclip(); B=16, S=14, seeded uint8 frames, PCM
   and offset targets on the card; (a) bf16 kernel, (b) bf16 plain, (c) f32
   plain from the same weights and generator seed (the flip and dropout
   draws agree: the heads are plain on every route). Counters exactly K1
   24, K2 24, K3 12, K4 2 and the rest 0 for (a)'s eval step and for its
   first train step; sync_agreement against (c), each within 2 x (b)'s
   error: the loss (+ 1e-3 of it) and gradient norm (+ 5e-3), every
   trainable leaf's relative error and 1 - the cosine of the whole trainable
   gradient, the update of one Adam step, the eval step's f32 logits and
   per-example loss (scripts/stage1_planted_faults.py shows that it fails
   the K1 and K4 faults); then 3-step windows in the order plain, kernel,
   kernel, plain: ms/step, samples/s and each path's peak memory.
11. the Stage III fine-tune: configs/ft_synchability.yaml's model (S=13,
   pos-emb 184, the 2-class syncability head) through finetune_from phase
   10's (a) state, whose report must list the fresh sync_head as missing,
   the dropped off_head as unexpected and nothing mismatched, the pos-emb
   trimmed 198 -> 184; B=16, the batch's first 13 segments, sync targets;
   the same three runs, counters, agreement and timing as phase 10.
12. the audio augmentations (ops/dsp.py) at the published Stage I crop, B=2
   x 80,000 samples (5 s at 16 kHz) of seeded tones under noise: reverb,
   volume, pitch shift, lowpass, noise and their chain, each forced on
   (every row drawn) against the same function on the CPU in float64
   (AUG_TOL; WSOLA's chosen offsets equal) and forced off (the input back
   bit for bit), the reverb also against sox_reverb_scalar, a float64
   transliteration of sox reverb.c, on 2400 samples (rtol 1e-3, atol
   2e-5); ms per transform and per chain by CUDA events and by the host's
   clock, and random_audio_aug_chain at p 0 and 0.2, draws included.
13. the training entry point, synchformer_tpu_torch.main's dispatch
   in-process (entry_plan): configs/segment_avclip.yaml (published widths,
   p_audio_aug 0.2, B=2) over SyntheticAV, one epoch, then resumed to two;
   configs/sync.yaml (B=16) with its towers from that run, two epochs;
   configs/ft_synchability.yaml fine-tuned from Stage II's best store.
   Every train step's launches exactly phase 4's or phase 10's; the step
   counts, the augmentations drawn, ckpts/latest and ckpts/best; the resume
   continuing the step counter from parameters equal bit for bit to the
   first run's; Stage I and II ms/step inside fit and the loader's share
   (scalars.jsonl); then measure_pipeline_throughput of the synthetic
   pipeline alone at B=2 and B=16.
14. data-parallel training (parallel/dist.py). (a) One process in an NCCL
   group of world 1 (a TCPStore on localhost): phase 4's Stage I step
   through AVCLIPTrainer under DDP, then the same step without a group,
   each with phase 4's exact counters and held against phase 4's f32 and
   bf16 plain records by stage1_agreement, the two compared element by
   element. (b) python -m torch.distributed.run --standalone
   --nproc_per_node 1 -m synchformer_tpu_torch.main over phase 13's Stage
   II plan (sync.yaml, SyntheticAV, one epoch, towers seeded) on NCCL, a
   subprocess with a timeout: exit 0 and its checkpoints. (c) Two ranks of
   a gloo group on the one card (NCCL refuses two ranks on one device;
   gloo stages DDP's all-reduce and the all-gathers of CUDA tensors through
   the host), subprocesses of this script (--dp-worker) with timeouts, each
   rank's randomness off (flip p 0, drop-path 0, the transformer's dropouts
   0, the positional dropout an exact identity): the full-width AVCLIP step
   at global B=2, the MoCo step at B=2 (queues 1024 x 14 and 1024, their
   bytes equal on both ranks) and the Stage II step at B=16 (K1 24, K2 24,
   K3 12, K4 2 a rank, its rate base_learning_rate x 2), each rank's first
   step on its rows held against the world-1 f32 plain step over the whole
   batch by stage1_agreement, moco_agreement and sync_agreement, within 2 x
   the world-1 bf16 kernel step's error; ms/step at world 2 and one gloo
   all-reduce of the gradients' bytes (scripts/stage1_planted_faults.py
   --only dp shows that it fails a gather without the sum over ranks, MoCo
   keys that stay local and a Stage II rate not scaled by the ranks).
15. the reference-checkpoint entry points at full width (12 + 12 layers,
   768 wide, the published mel and video geometry), files under
   build/chip_smoke/reference/, removed at the end. (a) Reference-style
   Stage II and III checkpoints of seeded build_synchformer(14) and
   build_synchformer(13, syncability): weights under "model" with module.
   prefixes and one entry no model reads, args a pickled omegaconf
   DictConfig (utils/reference_ckpt.py's stand-ins) holding the sync config
   under the reference's target names, the legacy
   model.modules.feature_selector transformer, ${} interpolations,
   'torch.nn.Identity' time tails and an unknown legacy_knob. (b) python -m
   synchformer_tpu_torch.example on the Stage II file, a subprocess with a
   timeout, on a synthetic:// clip at offset 1.6 s: exit 0, its top 5, its
   kernel launches exactly one forward's (K1 24, K2 24, K3 12, K4 2), its
   probabilities held by serving_agreement against the item it wrote (out=)
   through the plain bf16 and f32 paths in-process; ms/clip of its forward.
   (c) SyncTrainer's towers from a reference-style Stage I file of a seeded
   build_avclip() (a_encoder. / v_encoder. under "state_dict" with module.,
   an AST position embedding of 1214 tokens whose first 74 are the model's):
   empty reports, the AST embedding the file's first 74 rows bit for bit
   (scripts/stage1_planted_faults.py --only ckpt shows that it fails a
   reader that skips the trim). (d) the syncability CLI's main in-process
   over the Stage III and II files and a SyntheticAV loader (8 clips, B=8,
   iter_times 1): launches exactly both models' forwards, the ROC and
   tiered pickles written, the sync and offset logits held by
   serving_agreement against the plain f32 and bf16 paths on the same
   batches; clips/s.
16. the legacy SparseSync family (run_legacy), inference. (a)
   presets.legacy_sync_model(14): configs/sync.yaml's model with the towers
   swapped for S3DVisualFeatures (spatial TransformerEncoderLayer, time Identity)
   and ResNet18AudioFeatures (frequency TransformerEncoderLayer, time
   Identity) under the reference's names, through the port's registry,
   projections 1024 / 512 -> 768, the GlobalTransformer 3 x 8 x 96 over 72
   tokens; seeded weights (He-scale convs, BatchNorm near the identity);
   B=8, S=14, uint8 frames (16 x 224² a segment, normalised on the card) and
   PCM through SyncPredictor: bf16 kernel, bf16 plain, f32 plain with TF32
   off; launches exactly K4 2 and every other kernel 0;
   serving_agreement over the probabilities and both towers' features
   (scripts/stage1_planted_faults.py --only legacy shows that it fails
   k4_cls_key_dropped and k4_wv_head_shifted); ms/batch, clips/s and peak
   memory per route, taken in turns. (b) SparseSyncTransformer (12 layers,
   8 heads, 256 wide, L2Normalize pre-norms, the factorized positional
   embeddings) on the trunks' dense maps of one 5 s clip a row, B=8: 125
   frames of 224² -> S3D (16, 7, 7, 1024) -> ConvBridgeVisual; the clip's
   501 mel frames -> ResNet-18 (4, 16, 512) -> ConvBridgeAudio; plain route,
   bf16 against f32: finite (8, 21) logits within 0.1 relative L2; ms.
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
# backwards, the fused route's kernels (their GEMMs apart) and the CLS-pool
# layers
BY_LAUNCH = ("K1", "K2", "K3", "K4", "K4b", "K4b spatial", "K5", "K6", "K7a", "K7b", "K7c",
             "K8a", "K8b", "K8c", "K4 legacy")
MAX_CLIP = 1.0  # Stage I's max_clip_norm
B, S = 8, 14
B1 = 2  # Stage I's base_batch_size
B2, S3 = 16, 13  # Stage II / III's base_batch_size; Stage III's segments
SYNCABILITY_ACTION = "ft_avsync_model_for_syncability"
# one Stage II / III step, and its eval step, on frozen towers: the towers'
# eval path (the K1 pair and K2 in every video block, K3 and K2 in every AST
# layer, K4 for both aggregators); the projections and the transformer are
# plain on every route
STAGE2_LAUNCHES = {"K1": 24, "K2": 24, "K3": 12, "K4": 2}
D, H, DH = 768, 12, 64
# the legacy SparseSync towers (phase 16): S3D's time steps from 16 frames and
# ResNet-18's from 66 mel frames (presets.LEGACY_TOKENS); K4 at their pools (what, groups, rows, d,
# heads): S3D's spatial pool over a 7 x 7 frame at D 1024, 8 heads of 128;
# ResNet-18's frequency pool over 4 bins at D 512, 8 heads of 64
LEGACY_TV, LEGACY_TA = 2, 3
LEGACY_K4 = (("spatial", B * S * LEGACY_TV, 49, 1024, 8),
             ("frequency", B * S * LEGACY_TA, 4, 512, 8))
# one legacy sync forward: K4 for the spatial and the frequency pools, nothing else
LEGACY_LAUNCHES = {**{key: 0 for key in KEYS}, "K4": 2}
# phase 16 (b): one 5 s clip a row, 125 frames at 25 fps, 80,000 samples at 16 kHz;
# the SparseSync transformer's width (the JAX default) and the trunks' dense
# maps of such a clip: S3D (t, h, w) of 125 frames of 224², ResNet-18 (f, t)
# of its 501 mel frames
CLIP_FRAMES, CLIP_SAMPLES = 125, 80000
SPARSESYNC_D, SPARSESYNC_GRIDS = 256, ((16, 7, 7), (4, 16))
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
    # the spatial and frequency aggregators, then (key 'K4 8x96', checked and
    # logged only) the 8-head tower's spatial aggregator, 8 heads of 96, on
    # the spatial case's inputs (so that no later case's inputs move)
    k4_args = {}
    for key, label, shape, heads in (
            ("K4", f"spatial ({bs * F_T},196,768)", (bs * F_T, N_P, d), h),
            ("K4", f"frequency ({bs * 6},12,768)", (bs * 6, 12, d), h),
            (f"K4 {H8}x{DH8}", f"spatial {H8}x{DH8} ({bs * F_T},196,768)", (bs * F_T, N_P, d),
             H8)):
        if shape not in k4_args:
            g1, b1 = ln_params()
            g2_, b2_ = ln_params()
            k4_args[shape] = [rn(*shape), rn(d, std=0.02, dtype=torch.float32), g1, b1,
                              rn(3 * d, d, std=0.02), rn(3 * d, std=0.02, dtype=torch.float32),
                              rn(d, d, std=0.02), rn(d, std=0.02, dtype=torch.float32), g2_,
                              b2_, *mlp_params()]
        args = k4_args[shape]
        cases.append((key, f"K4 {label}",
                      lambda a=args, nh=heads: fused_cls_pool_tokens(*a, num_heads=nh, eps=1e-6),
                      lambda dt, a=args, nh=heads: fused_cls_pool_tokens(
                          *cast(a, dt), num_heads=nh, eps=1e-6, impl="plain"),
                      k4_cost(shape[0], shape[1], d, heads, hid), None))
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
    return cases + k4b_cases(torch, dev) + k8_cases(torch, dev) + k4_legacy_cases(torch, dev)


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


def check_ast_8x96(torch, dev, bs: int = B * S, n: int = 74, d: int = D, h: int = H8,
                   tag: str = "kernels") -> bool:
    """The K3 gate on the card: an AST layer at 8 heads of 96, which do not
    pair into 128 lanes, on impl='kernel' in bf16 runs its attention as the
    plain composition (K3's count unchanged) and its LN + MLP half on K2 (one
    launch); its output held to the f32 plain version by hold_outputs' rule.
    Returns whether all held."""
    from synchformer_tpu_torch.models.layers import ASTLayer
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict

    layer = ASTLayer(d, h, device=dev)
    load_numpy_state_dict(layer, seeded_state_dict(layer, seed=7))
    x = torch.randn(bs, n, d, generator=torch.Generator(device=dev).manual_seed(8), device=dev)
    before = dict(_build.launches)
    with torch.no_grad():
        kern = layer(x.bfloat16(), "kernel")
        torch.cuda.synchronize()
        k3, k2 = (_build.launches[k] - before.get(k, 0) for k in ("K3", "K2"))
        plain, anchor = layer(x.bfloat16(), "plain"), layer(x, "plain")
    label = f"AST layer {h}x{d // h} ({bs},{n},{d})"
    failed = hold_outputs(label, kern, plain, anchor, tag)[0]
    log(f"[{tag}] {label}: launches K3 {k3}, K2 {k2} {'ok' if (k3, k2) == (0, 1) else 'FAIL'}")
    return not failed and (k3, k2) == (0, 1)


def k4_cases(torch, dev, d: int = D, h: int = H, global_rows=(B1, S),
             ragged=((4, 1), (4, 13), (4, 197), (4, 300)), partial=(700, 12),
             guard=((4, 196), (5, 12)), wide=(H8, (4, 197), (5, 12)),
             time_tail=(B * S, F_T)) -> list:
    """kernel_cases' records of K4 (no cost, no library), checked and logged
    only: the MoCo step's global aggregators (B1 groups of S rows), ragged
    rows (one group a block; 197 and 300 on a 2-block cluster, 300 also in
    two passes a block), a group count that leaves the last block of packed
    groups part-filled (700 groups of 12: three a block), guard bands
    (every input at the start of a NaN-filled buffer) at a cluster shape and
    a packed one, and, with wide = (heads, ragged shape, guard-band shape),
    heads of another width than h's (the 8-head tower's 96: the Wv product
    takes a head in 64-column pieces and drops the columns past it) at a
    ragged cluster shape and in a guard band at a packed one, and a tower's
    TransformerEncoderLayer time tail (time_tail: B*S groups of the 8
    frames' features). The QKV and
    projection weights at std (2 / d)^0.5: a
    peaked attention, as k4b_cases'. The kernel calls look the wrapper up in
    its module at call time, so that scripts/stage1_planted_faults.py can
    wrap its entry."""
    from synchformer_tpu_torch.ops.kernels import cls_pool as tcls

    g = torch.Generator(device=dev).manual_seed(9)
    bf, f32 = torch.bfloat16, torch.float32
    hid = 4 * d

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def cast(args, dtype):
        return [a.to(dtype) if torch.is_tensor(a) and a.dtype == bf else a for a in args]

    w_att = (2.0 / d) ** 0.5
    layer = [1.0 + rn(d, std=0.1, dtype=f32), rn(d, std=0.1, dtype=f32), rn(3 * d, d, std=w_att),
             rn(3 * d, std=0.02, dtype=f32), rn(d, d, std=w_att), rn(d, std=0.02, dtype=f32),
             1.0 + rn(d, std=0.1, dtype=f32), rn(d, std=0.1, dtype=f32), rn(hid, d, std=0.02),
             rn(hid, std=0.02, dtype=f32), rn(d, hid, std=0.02), rn(d, std=0.02, dtype=f32)]
    cls = rn(d, dtype=f32)

    def case(key, what, groups, m, wrap=lambda t: t, heads=h):
        args = [wrap(t) for t in [rn(groups, m, d), cls, *layer]]
        return (key, f"K4 {what} ({groups},{m},{d})",
                lambda: tcls.fused_cls_pool_tokens(*args, num_heads=heads, eps=1e-6),
                lambda dt: tcls.fused_cls_pool_tokens(*cast(args, dt), num_heads=heads,
                                                      eps=1e-6, impl="plain"), None, None)

    cases = [case("K4 global", "global", *global_rows),
             case("K4 global", "time tail", *time_tail)]
    cases += [case("K4 ragged", "ragged", *shape) for shape in ragged]
    cases.append(case("K4 ragged", "part-filled last block", *partial))
    cases += [case("K4 ragged", "guard band", *shape, lambda t: guarded(torch, t))
              for shape in guard]
    heads, ragged_w, guard_w = wide
    hw = f"{heads}x{d // heads}"
    cases.append(case("K4 ragged", f"{hw} ragged", *ragged_w, heads=heads))
    cases.append(case("K4 ragged", f"{hw} guard band", *guard_w, lambda t: guarded(torch, t),
                      heads=heads))
    return cases


def k4_cost(groups: int, m: int, d: int, heads: int, hid: int):
    """(bytes, FLOPs) of K4 over groups of m rows: with one shared query, q
    and U = Wk^T q once; per group the logits and the p-weighted sum over m
    + 1 rows per head, Wv, proj and the MLP; x, the weights and the output
    moved once."""
    flops = 4.0 * d * d + groups * (4.0 * heads * (m + 1) * d + 4.0 * d * d + 4.0 * d * hid)
    nbytes = (groups * m * d * 2 + (4 * d * d + 2 * d * hid) * 2 + (9 * d + hid) * 4
              + groups * d * 2)
    return nbytes, flops


def k4_legacy_cases(torch, dev, shapes=LEGACY_K4) -> list:
    """kernel_cases' records of K4 at the legacy towers' pools (LEGACY_K4;
    key 'K4 legacy': checked, timed and logged with its bound, not reported,
    the kernels line's K4 keeping the main path's shapes), hidden 4d. The
    QKV and projection weights at std (2 / d)^0.5, a peaked attention, as
    k4_cases', with the key weights a quarter of the query weights plus
    noise: the CLS query attends in part to its own key (about 44% of the
    weight over 49 rows at heads of 128, 65% over 4 at heads of 64), so that
    both the CLS key and the rows' keys move the output. The kernel calls
    look the wrapper up in its module at call time, so that
    scripts/stage1_planted_faults.py can wrap its entry."""
    from synchformer_tpu_torch.ops.kernels import cls_pool as tcls

    g = torch.Generator(device=dev).manual_seed(11)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def cast(args, dtype):
        return [a.to(dtype) if torch.is_tensor(a) and a.dtype == bf else a for a in args]

    cases = []
    for what, groups, m, d, heads in shapes:
        hid, w_att = 4 * d, (2.0 / d) ** 0.5
        wq, wk, wv = (rn(d, d, std=w_att, dtype=f32) for _ in range(3))
        wqkv = torch.cat([wq, 0.25 * wq + 0.97 * wk, wv]).to(bf)
        args = [rn(groups, m, d), rn(d, dtype=f32), 1.0 + rn(d, std=0.1, dtype=f32),
                rn(d, std=0.1, dtype=f32), wqkv, rn(3 * d, std=0.02, dtype=f32),
                rn(d, d, std=w_att), rn(d, std=0.02, dtype=f32), 1.0 + rn(d, std=0.1, dtype=f32),
                rn(d, std=0.1, dtype=f32), rn(hid, d, std=0.02), rn(hid, std=0.02, dtype=f32),
                rn(d, hid, std=0.02), rn(d, std=0.02, dtype=f32)]
        cases.append(("K4 legacy", f"K4 legacy {what} {heads}x{d // heads} ({groups},{m},{d})",
                      lambda a=args, nh=heads: tcls.fused_cls_pool_tokens(*a, num_heads=nh,
                                                                          eps=1e-6),
                      lambda dt, a=args, nh=heads: tcls.fused_cls_pool_tokens(
                          *cast(a, dt), num_heads=nh, eps=1e-6, impl="plain"),
                      k4_cost(groups, m, d, heads, hid), None))
    return cases


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
    """ragged_cases and k4_cases, each held by hold_outputs' rule; fails on
    any miss."""
    for _, label, kern, plain, _, _ in ragged_cases(torch, dev) + k4_cases(torch, dev):
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
    if not check_ast_8x96(torch, dev):
        fail("the AST layer at 8 heads of 96 reached K3 or disagrees with its plain version")
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


def serving_record(torch, pred, video, pcm, audio: bool = False) -> dict:
    """One SyncPredictor forward: its logits, probabilities and the video
    tower's output features (read by a forward hook), with ``audio`` also
    the audio tower's, in f32."""
    feats = {}
    towers = {"vfeat": pred.model.vfeat_extractor}
    if audio:
        towers["afeat"] = pred.model.afeat_extractor
    hooks = [tower.register_forward_hook(
        lambda mod, args, out, name=name: feats.update({name: out.float()}))
        for name, tower in towers.items()]
    try:
        logits = pred.logits(video, pcm).float()
    finally:
        for hook in hooks:
            hook.remove()
    return {"logits": logits, "probs": torch.softmax(logits, -1), **feats}


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
                   moco: bool = False, p_flip: float = 0.5):
    """An AVCLIPTrainer on ``build(remat=..., device=dev)`` loaded with
    ``state_dict``: Stage I's optimiser settings, generator seed 0, flip p
    ``p_flip``; with ``moco``, cfg.model.target names MultilevelMoCoCLIP and
    alpha is MOCO_ALPHA."""
    from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict

    model = build(remat=remat, device=dev)
    load_numpy_state_dict(model, state_dict)
    cfg = {"training": {"seed": 0, "precision": precision, "learning_rate": 1e-4,
                        "weight_decay": 0.2, "warmup": 1000, "total_steps": 100_000,
                        "max_clip_norm": MAX_CLIP, "zero_shot_window": 8, "alpha": MOCO_ALPHA},
           "data": {"p_horizontal_flip": p_flip, "p_audio_aug": 0.0}}
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
                     metric_eps=(("loss", 1e-4), ("grad_norm", 1e-3)),
                     margins: dict | None = None) -> list:
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
    - 1 - cosine of the whole flattened gradient to the f32 one, no eps.
    Fills ``margins``, when given, with each check's error over its tolerance
    (the leaves' largest as ``leaves``)."""
    failed = []
    ratios = {}

    def check(name, err_k, err_p, eps):
        tol = 2.0 * err_p + eps
        ok = err_k <= tol
        if not ok:
            failed.append(name)
        ratios[name] = err_k / tol if tol > 0 else (0.0 if err_k == 0 else float("inf"))
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
    log(f"[{tag}] {len(ref['leaves'])} gradient leaves, relative L2 error to "
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
    if margins is not None:
        leaves = [ratios.pop(name) for name in ref["leaves"]]
        margins.update(ratios, leaves=max(leaves, default=0.0))
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
    if tag == "stage1":
        # phase 14 (a) holds its steps against these records
        KEPT["stage1"] = {"sd": sd, "batch": batch, "ref": record_to_cpu(ref),
                          "plain": record_to_cpu(plain)}
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


def moco_agreement(ref: dict, plain: dict, kern: dict, tag: str = "moco",
                   margins: dict | None = None) -> list:
    """stage1_agreement over moco_record's gradients with both levels' losses
    and the total (eps 1e-4 of each) and the gradient norm (1e-3), then, each
    by relative L2 error within 2 x the plain bf16 record's, no eps: the
    momentum parameters after the step (updated from the f32 masters before
    it, so both errors are 0), the keys written into the queues (the key
    pass, on the eval path's kernels) and the query pass's global aggregator
    outputs (the video one is K4b's). Returns the names that failed; fills
    ``margins``, when given, with each of these last checks' error over its
    tolerance."""
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
        if margins is not None:
            margins[name] = (err_k / max(2.0 * err_p, 1e-30) if bool(k.isfinite().all())
                             else float("inf"))
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


def sync_config(action: str, n_segments: int, ckpt_path=None, half: bool = True,
                widths: dict | None = None) -> dict:
    """configs/sync.yaml's (action 'train_avsync_model') or
    configs/ft_synchability.yaml's ('ft_avsync_model_for_syncability')
    model, training and data sections as a Python dict (the card's machine
    has no PyYAML): ViT-B towers (their defaults), both named ``ckpt_path``,
    the GlobalTransformer (3 layers of 8 heads of 96, dropouts 0.1, pos-emb
    2 + 14 n_segments tokens), Adam at 2e-6 on constant_with_warmup (1000
    steps), clip 1, flip p 0.5, colour jitter and grayscale p 0. ``half``
    is use_half_precision. ``widths`` (d, n_layer, n_head, audio / video
    tower params) replaces the widths, for the planted faults' dry run."""
    w = {"d": D, "n_layer": 3, "n_head": H8, "audio": {}, "video": {}, **(widths or {})}
    d = w["d"]
    seq = 2 + n_segments * (w["video"].get("temporal_resolution", F_T) + 6)
    lin = {"target": "torch.nn.Linear", "params": {"in_features": d, "out_features": d}}
    head = ("GlobalTransformerWithSyncabilityHead" if action == SYNCABILITY_ACTION
            else "GlobalTransformer")
    model = {"target": "synchformer_tpu.models.sync_model.Synchformer", "params": {
        "afeat_extractor": {"target": "synchformer_tpu.models.ast_encoder.ASTEncoder", "params": {
            "ckpt_path": ckpt_path, "max_spec_t": 66, "factorize_freq_time": True,
            "agg_freq_module": "TransformerEncoderLayer", "agg_time_module": "Identity",
            "add_global_repr": False, **w["audio"]}},
        "vfeat_extractor": {
            "target": "synchformer_tpu.models.motionformer.MotionFormerEncoder", "params": {
                "ckpt_path": ckpt_path, "factorize_space_time": True,
                "agg_space_module": "TransformerEncoderLayer", "agg_time_module": "Identity",
                "add_global_repr": False, **w["video"]}},
        "aproj": lin, "vproj": lin,
        "transformer": {"target": f"synchformer_tpu.models.sync_model.{head}", "params": {
            "n_layer": w["n_layer"], "n_head": w["n_head"], "n_embd": d, "tok_pdrop": 0.0,
            "embd_pdrop": 0.1, "resid_pdrop": 0.1, "attn_pdrop": 0.1,
            "pos_emb_cfg": {"target": "synchformer_tpu.models.pos_emb.RandInitPositionalEncoding",
                            "params": {"block_shape": [seq], "n_embd": d}},
            "off_head_cfg": {"target": "torch.nn.Linear",
                             "params": {"in_features": d, "out_features": 21}}}}}}
    training = {"base_learning_rate": 2e-6, "base_batch_size": B2, "use_half_precision": half,
                "seed": 1337, "max_clip_norm": 1, "finetune": action == SYNCABILITY_ACTION,
                "lr_scheduler": {"name": "constant_with_warmup", "warmup": 1000},
                "optimizer": {"name": "adam", "betas": [0.9, 0.999], "momentum": 0.9,
                              "weight_decay": 0}}
    data = {"num_off_cls": 21, "n_segments": n_segments, "p_horizontal_flip": 0.5,
            "p_color_jitter": 0.0, "p_gray_scale": 0.0, "p_audio_aug": 0.0}
    return {"action": action, "model": model, "training": training, "data": data}


def stage1_tower_ckpt(torch, build, path: str) -> str:
    """A Stage I checkpoint for the sync towers: ``build(device='meta')``'s
    seeded state dict (seed 1) under "model", written to ``path``."""
    from synchformer_tpu_torch.utils.convert import seeded_state_dict

    os.makedirs(os.path.dirname(path), exist_ok=True)
    sd = seeded_state_dict(build(device="meta"), seed=1)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    return path


def sync_batch(torch, dev, b: int, s: int, frames=FRAMES) -> dict:
    """One seeded loader batch on ``dev``: uint8 frames (b, s, *frames), PCM
    (b, s, 10240), offset_target in [0, 21), sync_target in {0, 1}."""
    import numpy as np

    rng = np.random.default_rng(3)
    video = rng.integers(0, 256, (b, s, *frames), dtype=np.uint8)
    pcm = (rng.standard_normal((b, s, 10240)) * 0.1).astype(np.float32)
    return {"video": torch.from_numpy(video).to(dev), "audio": torch.from_numpy(pcm).to(dev),
            "offset_target": torch.from_numpy(rng.integers(0, 21, b)).to(dev),
            "sync_target": torch.from_numpy(rng.integers(0, 2, b)).to(dev)}


def sync_trainer(cfg: dict, dev, impl: str, half: bool):
    """A SyncTrainer on ``cfg`` with use_half_precision ``half``; an f32
    trainer takes the bf16 trainers' Adam eps (1e-7), so that the three
    updates differ only by the gradients."""
    from synchformer_tpu_torch.train.stage_sync import SyncTrainer

    cfg = {**cfg, "training": {**cfg["training"], "use_half_precision": half}}
    tr = SyncTrainer(cfg, device=dev, impl=impl)
    for group in tr.optimizer.param_groups:
        group["eps"] = 1e-7
    return tr


def sync_record(torch, tr, batch, what: str, tag: str, resident: int = 0):
    """An eval step, then the first train step of a SyncTrainer: the eval
    step's f32 logits and per-example loss, the kernels launched by each
    (``launches``: eval, step; the counters are zeroed before each), the
    step's metrics, each trainable leaf's gradient undone from the clip
    (``leaves``), all of them flattened (``flat``), and the update it made
    to the trainable parameters (``update``, after - before, in f64); and
    the step's peak memory above ``resident`` bytes (0 off the card)."""
    from synchformer_tpu_torch.ops.kernels import _build

    cuda = tr.device.type == "cuda"
    _build.launches.clear()
    ev = tr.eval_step(batch)
    rec = {"eval": {k: ev[k].float() for k in ("logits", "loss_vec")}}
    params = {n: p for n, p in tr.model.named_parameters() if p.requires_grad}
    before = torch.cat([p.detach().double().flatten() for p in params.values()])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    launches = [dict(_build.launches)]
    _build.launches.clear()
    t = time.perf_counter()
    m = checked_step(tr, batch, what)
    if cuda:
        torch.cuda.synchronize()
    rec["launches"] = launches + [dict(_build.launches)]
    peak = torch.cuda.max_memory_allocated() - resident if cuda else 0
    log(f"[{tag}] {what} first step: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, "
        f"accuracy_1 {m['accuracy_1']:.4f}, {time.perf_counter() - t:.2f} s, peak memory "
        f"{gib(peak)}")
    unclip = max(m["grad_norm"] / tr.max_clip_norm, 1.0)
    rec["metrics"] = m
    rec["leaves"] = {n: p.grad.float() * unclip for n, p in params.items()}
    rec["flat"] = torch.cat([g.flatten() for g in rec["leaves"].values()])
    rec["update"] = torch.cat([p.detach().double().flatten() for p in params.values()]) - before
    return rec, peak


def sync_agreement(ref: dict, plain: dict, kern: dict, tag: str,
                   margins: dict | None = None) -> list:
    """Hold sync_record's kernel record against the f32 one, each check at
    2 x the plain bf16 record's error: stage1_agreement's loss (+ 1e-3 of
    it), gradient norm (+ 5e-3 of it), every trainable leaf's and the whole
    gradient's (1 - cosine) errors, then, by relative L2 error with no eps,
    the update of one Adam step and the eval step's f32 logits and
    per-example loss. Returns the names of the checks that failed; fills
    ``margins``, when given, with each of these last checks' error over its
    tolerance. The two scalars' eps are about 3 x the bf16 paths' readings
    at B=16 (loss 1.0e-4 to 3.3e-4 of it, gradient norm 5e-4 to 2.1e-3 of
    it), where either path's error can also cancel to near 0 (the Stage
    III plain loss read 2e-5 of it): 2 x one scalar's error alone is no
    yardstick; the vectors carry the check."""
    failed = stage1_agreement(ref, plain, kern, tag, (("loss", 1e-3), ("grad_norm", 5e-3)))

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    for name in ("update", "eval logits", "eval loss_vec"):
        def pick(r):
            return r["update"] if name == "update" else r["eval"][name.split()[1]]

        a, k, p = pick(ref), pick(kern), pick(plain)
        finite = bool(k.isfinite().all()) and k.shape == a.shape
        err_k, err_p = (rel(k, a) if finite else float("inf")), rel(p, a)
        ok = err_k <= 2.0 * err_p
        if not ok:
            failed.append(name)
        if margins is not None:
            margins[name] = err_k / max(2.0 * err_p, 1e-30)
        log(f"[{tag}] {name}: relative L2 |kernel-f32| {err_k:.3e} |plain_bf16-f32| "
            f"{err_p:.3e} tol {2.0 * err_p:.3e} {'ok' if ok else 'FAIL'}")
    return failed


def sync_step_phase(torch, dev, tag: str, make, batch, b: int) -> dict:
    """One Stage II / III phase: ``make(impl, half)`` gives a SyncTrainer;
    (c) f32 plain, (a) bf16 kernel, (b) bf16 plain from the same weights
    and generator seed (so the flip and dropout draws agree: the heads are
    plain on every route); exact launch counts of (a)'s eval step and first
    step (STAGE2_LAUNCHES each); sync_agreement; then 3-step windows in
    the order plain, kernel, kernel, plain, each path's ms/step, samples/s
    and its first step's peak memory. Returns (a)'s state dict after its
    first step, on the CPU."""
    t0 = time.perf_counter()
    tr = make("plain", False)
    ref, _ = sync_record(torch, tr, batch, "(c) f32 plain", tag)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] (c) {time.perf_counter() - t0:.1f} s")

    def exact_counts(what, counts):
        log(f"[{tag}] launches in {what}: {counts}")
        for key in KEYS:
            if counts.get(key, 0) != STAGE2_LAUNCHES.get(key, 0):
                fail(f"{tag}: {key} launched {counts.get(key, 0)} times in {what}, expected "
                     f"{STAGE2_LAUNCHES.get(key, 0)}")

    resident = torch.cuda.memory_allocated()
    trainers = {"kernel": make("kernel", True)}
    kern, k_peak = sync_record(torch, trainers["kernel"], batch, "(a) bf16 kernel", tag,
                               resident)
    exact_counts("one kernel eval step", kern["launches"][0])
    exact_counts("one kernel step", kern["launches"][1])
    state = {k: v.detach().to("cpu", copy=True)
             for k, v in trainers["kernel"].model.state_dict().items()}
    resident = torch.cuda.memory_allocated()
    trainers["plain"] = make("plain", True)
    plain, p_peak = sync_record(torch, trainers["plain"], batch, "(b) bf16 plain", tag, resident)
    failed = sync_agreement(ref, plain, kern, tag)
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
    for name, peak in (("kernel", k_peak), ("plain", p_peak)):
        best = min(times[name]) * 1e3
        log(f"[timing] {tag} {name} path: {best:.1f} ms/step of {b} clips = "
            f"{b * 1e3 / best:.3f} samples/s (runs {[round(t * 1e3, 1) for t in times[name]]} "
            f"ms); peak memory {gib(peak)}")
    return state


def run_sync_training(torch, dev, report):
    """Phases 10 and 11. Phase 10, the Stage II step: the sync.yaml model
    section built through the registry by SyncTrainer, its towers loaded
    from a Stage I checkpoint of a seeded full-width build_avclip(), B=16,
    S=14, offset targets, through sync_step_phase. Phase 11, the Stage III
    fine-tune: the ft_synchability.yaml model (S=13, the syncability head)
    fine-tuned from phase 10's (a) state (finetune_from: the pos-emb trimmed
    198 -> 184, the fresh sync_head reported missing, the dropped off_head
    unexpected), B=16, the first 13 segments of the same batch, sync
    targets, through sync_step_phase."""
    from synchformer_tpu_torch.models.presets import build_avclip

    t0 = time.perf_counter()
    ckpt = stage1_tower_ckpt(torch, build_avclip, os.path.join(REPO, "build", "chip_smoke",
                                                               "stage1_avclip.pt"))
    batch = sync_batch(torch, dev, B2, S)
    cfg = sync_config("train_avsync_model", S, ckpt)
    log(f"[stage2] Stage I checkpoint + batch {time.perf_counter() - t0:.1f} s; video "
        f"{tuple(batch['video'].shape)} uint8 on the card")
    state = sync_step_phase(torch, dev, "stage2",
                            lambda impl, half: sync_trainer(cfg, dev, impl, half), batch, B2)
    os.remove(ckpt)

    ft_cfg = sync_config(SYNCABILITY_ACTION, S3)
    ft_batch = {k: (v[:, :S3] if k in ("video", "audio") else v) for k, v in batch.items()}
    del batch
    want = {"missing": ["transformer.sync_head.weight", "transformer.sync_head.bias"],
            "unexpected": ["transformer.off_head.weight", "transformer.off_head.bias"],
            "mismatched": []}

    def make(impl, half):
        tr = sync_trainer(ft_cfg, dev, impl, half)
        report_ = tr.finetune_from(state)
        pos = tr.model.transformer.pos_emb_cfg.pos_emb
        if report_ != want or pos.shape[1] != 2 + S3 * 14 or not torch.equal(
                pos.detach().cpu(), state["transformer.pos_emb_cfg.pos_emb"][:, :pos.shape[1]]):
            fail(f"stage3: the fine-tune merge reported {report_}, expected {want}, or the "
                 f"pos-emb was not trimmed 198 -> 184")
        log(f"[stage3] finetune_from phase 10's state: {report_}; pos-emb "
            f"{state['transformer.pos_emb_cfg.pos_emb'].shape[1]} -> {pos.shape[1]}")
        return tr

    sync_step_phase(torch, dev, "stage3", make, ft_batch, B2)


# phase 14: data-parallel training (parallel/dist.py, torch.distributed)
# records of earlier phases that phase 14 reads
KEPT: dict = {}
DP_CASES = ("avclip", "moco", "stage2")
# (c)'s worker processes: the group's timeout, the spawn's
DP_GROUP_TIMEOUT_S, DP_SPAWN_TIMEOUT_S = 300, 600


def record_to_cpu(rec: dict) -> dict:
    """A step record (step_gradients' and the MoCo / Stage II records) with
    every tensor copied to the CPU (the MoCo record's queue columns are views
    of queues that later steps write)."""
    def move(v):
        if hasattr(v, "cpu"):
            return v.detach().to("cpu", copy=True)
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        return v

    return {k: move(v) for k, v in rec.items()}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def randomness_off(model) -> None:
    """Every drop-path rate to 0 and every positional dropout above 0 to 1e-9
    (an exact identity: the keep probability rounds to 1 in f32, yet the
    MoCo query pass's video global aggregator still takes K4b): a rank draws
    from its own generator stream, so that draws at world 2 could not equal
    world 1's over the same clips."""
    from synchformer_tpu_torch.models.aggregators import CLSPoolEncoderLayer
    from synchformer_tpu_torch.models.layers import DropPath

    for mod in model.modules():
        if isinstance(mod, DropPath):
            mod.rate = 0.0
        if isinstance(mod, CLSPoolEncoderLayer) and mod.pos_emb_drop > 0:
            mod.pos_emb_drop = 1e-9
        if getattr(mod, "pos_dropout", 0) > 0:
            mod.pos_dropout = 1e-9


def run_dp_world1(torch, dev, report):
    """Phase 14 (a): one process in an NCCL group of world 1 (a TCPStore on
    localhost): phase 4's Stage I step (build_avclip, B=2, S=14, amp, the
    same weights, batch and generator seed) through AVCLIPTrainer under DDP,
    its launches exactly phase 4's; then the same step without a group. Each
    held against phase 4's f32 and bf16 plain records by stage1_agreement,
    and the two compared element by element; ms/step of each (3 steps)."""
    import datetime

    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from synchformer_tpu_torch.models.presets import build_avclip
    from synchformer_tpu_torch.ops.kernels import _build

    kept = KEPT.pop("stage1")
    port = free_port()
    store = dist.TCPStore("127.0.0.1", port, 1, True, timeout=datetime.timedelta(seconds=120))
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    recs, times = {}, {}
    try:
        for what in ("ddp", "no group"):
            if what == "no group":
                dist.destroy_process_group()
            tr = stage1_trainer(build_avclip, kept["sd"], dev, "amp", "kernel")
            if isinstance(tr.net, DistributedDataParallel) != (what == "ddp"):
                fail(f"dp_world1: the trainer's net is a {type(tr.net).__name__} ({what})")
            _build.launches.clear()
            m = checked_step(tr, kept["batch"], f"dp_world1 {what}")
            torch.cuda.synchronize()
            counts = dict(_build.launches)
            log(f"[dp_world1] {what}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}; "
                f"launches {counts}")
            for key, need in STAGE1_LAUNCHES.items():
                if counts.get(key, 0) != need:
                    fail(f"dp_world1 {what}: {key} launched {counts.get(key, 0)} times, "
                         f"expected {need}")
            recs[what] = record_to_cpu(step_gradients(torch, tr, m))
            t = time.perf_counter()
            for _ in range(3):
                checked_step(tr, kept["batch"], f"dp_world1 {what}")
            torch.cuda.synchronize()
            times[what] = (time.perf_counter() - t) / 3
            del tr
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    failed = []
    for what, rec in recs.items():
        failed += [f"{what} {n}" for n in stage1_agreement(kept["ref"], kept["plain"], rec,
                                                             f"dp_world1 {what}")]
    diff = float((recs["ddp"]["flat"] - recs["no group"]["flat"]).abs().max())
    log(f"[dp_world1] DDP step against the step without a group: max |gradient difference| "
        f"{diff:.3e}, loss {recs['ddp']['metrics']['loss']:.9f} vs "
        f"{recs['no group']['metrics']['loss']:.9f}")
    for what, secs in times.items():
        log(f"[timing] dp_world1 {what}: {secs * 1e3:.1f} ms/step of {B1} clips x {S} segments")
    if failed:
        fail(f"dp_world1: outside tolerance: {failed}")


def run_dp_launcher(torch, dev, report):
    """Phase 14 (b): python -m torch.distributed.run --standalone
    --nproc_per_node 1 -m synchformer_tpu_torch.main over phase 13's Stage
    II plan (sync.yaml, SyntheticAV, B=16, 32 clips: 2 steps), one epoch, its
    towers seeded (no Stage I run), on NCCL: exits 0 within its timeout and
    writes ckpts/latest and ckpts/best; ms/step inside fit."""
    import shutil

    root = os.path.join(REPO, "build", "chip_smoke", "runs_dp")
    shutil.rmtree(root, ignore_errors=True)
    argv = [a for a in dict((t, a) for t, a, *_ in entry_plan(root))["stage2"]
            if "ckpt_path" not in a and "num_epochs" not in a] + ["training.num_epochs=1"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", "synchformer_tpu_torch.main", *argv]
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"dp_launcher: torchrun exited {proc.returncode}: {proc.stderr[-3000:]}")
    run = os.path.join(root, "stage2")
    stores = {st: sorted(os.listdir(os.path.join(run, "ckpts", st)))
              if os.path.isdir(os.path.join(run, "ckpts", st)) else [] for st in ("latest", "best")}
    log(f"[dp_launcher] torchrun --standalone --nproc_per_node 1 -m synchformer_tpu_torch.main "
        f"(sync.yaml, 1 epoch) exited 0 in {secs:.1f} s; ckpts/latest {stores['latest']}, "
        f"ckpts/best {stores['best']}")
    if stores["latest"] != ["0.json", "0.pt"]:
        fail(f"dp_launcher: checkpoint stores {stores}")
    fit_timing(run, "dp_launcher stage2")
    shutil.rmtree(root, ignore_errors=True)


def dp_case_setup(case: str, dev, tiny: dict | None, base_lr_scale: int = 1,
                  weights: dict | None = None):
    """(make, global batch) of one (c) case (a rank's rows are a slice of
    the batch): ``make(precision_or_half, impl, remat)`` builds the trainer
    with its randomness off. ``tiny``: the planted faults' dry run's widths;
    ``weights``: a cache of the Stage I cases' seeded state dicts."""
    import torch

    from synchformer_tpu_torch.models import presets
    from synchformer_tpu_torch.utils.convert import seeded_state_dict

    t = tiny or {}
    if case in ("avclip", "moco"):
        build = getattr(presets, t.get(f"{case}_build", "build_avclip" if case == "avclip"
                                       else "build_moco_avclip"))
        cache = {} if weights is None else weights
        if case not in cache:
            cache[case] = seeded_state_dict(build(device="meta"), seed=0)
        sd = cache[case]
        batch = stage1_batch(torch, B1, t.get("s", S), t.get("frames", FRAMES))

        def make(precision, impl, remat=False):
            tr = stage1_trainer(build, sd, dev, precision, impl, remat, moco=case == "moco",
                                p_flip=0.0)
            randomness_off(tr.model)
            if case == "moco":
                randomness_off(tr.model_m)
            return tr

        return make, batch
    cfg = sync_config("train_avsync_model", t.get("s", S), None, widths=t.get("widths"))
    cfg["model"]["params"]["transformer"]["params"].update(embd_pdrop=0.0, resid_pdrop=0.0,
                                                           attn_pdrop=0.0)
    cfg["data"]["p_horizontal_flip"] = 0.0
    cfg["training"]["base_learning_rate"] *= base_lr_scale
    batch = sync_batch(torch, dev, B2, t.get("s", S), t.get("frames", FRAMES))

    def make(half, impl, remat=False):
        return sync_trainer(cfg, dev, impl, half)

    return make, batch


def dp_record(torch, case: str, tr, batch, what: str):
    """The first step's record of one (c) case: step_gradients' (avclip),
    moco_record's (moco) or sync_record's (stage2)."""
    if case == "avclip":
        return step_gradients(torch, tr, checked_step(tr, batch, what)), None
    if case == "moco":
        rec, _ = moco_first_step(torch, tr, batch, what, "dp_world2")
        return rec, None
    rec, _ = sync_record(torch, tr, batch, what, "dp_world2")
    return rec, rec["launches"]


def dp_worker(spec_path: str) -> int:
    """One rank of phase 14 (c), started by run_dp_world2: joins the gloo
    group from torchrun's variables (both ranks on cuda:0), takes each
    case's first step at world 2 on its rows of the global batch under DDP,
    then 2 timed steps, and checks the MoCo queues' bytes equal on both
    ranks; then leaves the group, and rank 0 takes the world-1 steps over
    the whole batch, f32 plain (remat for Stage I) and the bf16 kernel
    path, and holds the world-2 record against the f32 one with the case's
    agreement, the world-1 kernel step's error as the yardstick (the plain
    bf16 one's slot): world 2 may differ from world 1 only by the order of
    f32 sums and by the row count each GEMM sees. (With randomness off the
    Stage I gradient is small, a norm of about 0.1, and the kernel path
    there reads up to 2 x plain bf16's error, a margin phases 4 and 9 hold
    with their randomness on.) Writes its result to spec['out'] + rank."""
    import hashlib

    import torch

    sys.path.insert(0, REPO)
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.parallel import dist as pdist

    spec = json.load(open(spec_path))
    dev = pdist.init_from_env(spec["device"], backend="gloo")
    rank, world = pdist.rank(), pdist.world()
    if spec.get("hook"):
        import importlib.util

        path, fn = spec["hook"].split(":")
        mod_spec = importlib.util.spec_from_file_location("dp_hook", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        getattr(mod, fn)(spec["fault"])
    cuda = torch.device(dev).type == "cuda"
    tiny = spec.get("tiny")
    result = {"rank": rank, "world": world, "cases": {}}
    records, weights = {}, {}
    for case in spec["cases"]:
        make, batch = dp_case_setup(case, dev, tiny, weights=weights)
        n = batch["video"].shape[0] // world
        local = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
        tr = make("amp" if case != "stage2" else True, "kernel")
        _build.launches.clear()
        rec, launches = dp_record(torch, case, tr, local, f"world {world} rank {rank} {case}")
        counts = dict(_build.launches) if launches is None else launches[1]
        res = {"launches": counts}
        if case == "stage2":
            # the eval step's outputs over the whole batch, in rank order
            rec["eval"] = {k: torch.cat([x.to(v.device) for x in pdist.all_gather_object(
                v.cpu())]) for k, v in rec["eval"].items()}
            res["eval_launches"] = launches[0]
        if case == "moco":
            # the query pass's global aggregator outputs over the whole batch
            for key in ("query global_v", "query global_a"):
                v = rec["written"][key]
                rec["written"][key] = torch.cat([x.to(v.device) for x in
                                                 pdist.all_gather_object(v.cpu())])
            q = tr.queues
            digest = hashlib.sha256(b"".join(
                getattr(q, k).cpu().numpy().tobytes()
                for k in ("segment_v", "segment_a", "global_v", "global_a"))).hexdigest()
            digests = pdist.all_gather_object((digest, q.segment_ptr, q.global_ptr))
            res["queues_equal"] = all(d == digests[0] for d in digests)
        # copied before the timed steps write the queues and gradients again
        records[case] = record_to_cpu(rec) if rank == 0 else None
        del rec
        if cuda:
            torch.cuda.synchronize()
        pdist.barrier()
        t = time.perf_counter()
        for _ in range(spec.get("timed_steps", 2)):
            checked_step(tr, local, f"world {world} {case}")
        if cuda:
            torch.cuda.synchronize()
        pdist.barrier()
        res["ms"] = (time.perf_counter() - t) / spec.get("timed_steps", 2) * 1e3
        grads = [p.grad for p in tr.model.parameters() if p.grad is not None]
        flat = torch.cat([g.flatten() for g in grads])
        pdist.barrier()
        t = time.perf_counter()
        torch.distributed.all_reduce(flat)
        if cuda:
            torch.cuda.synchronize()
        res["allreduce_ms"] = (time.perf_counter() - t) * 1e3
        res["grad_bytes"] = flat.numel() * flat.element_size()
        log(f"[dp_world2] rank {rank} {case}: launches {counts}; {res['ms']:.1f} ms/step over "
            f"gloo; one all-reduce of the gradients' {res['grad_bytes'] / 2 ** 20:.0f} MiB "
            f"{res['allreduce_ms']:.1f} ms")
        del tr, flat, grads
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        result["cases"][case] = res
    pdist.barrier()
    pdist.destroy()
    if rank == 0:
        for case in spec["cases"]:
            # the world-1 references: the JAX trainer's rate at 2 devices is
            # base_learning_rate x 2 (Stage II / III)
            make, batch = dp_case_setup(case, dev, tiny, base_lr_scale=world, weights=weights)
            refs = {}
            for name, args in (("ref", ("fp32" if case != "stage2" else False, "plain",
                                        case != "stage2")),
                               ("kernel", ("amp" if case != "stage2" else True, "kernel"))):
                tr = make(*args)
                rec, _ = dp_record(torch, case, tr, batch, f"world 1 {case} {name}")
                refs[name] = record_to_cpu(rec)
                del tr
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
            margins = {}
            agree = {"avclip": stage1_agreement, "moco": moco_agreement,
                     "stage2": sync_agreement}[case]
            failed = agree(refs["ref"], refs["kernel"], records[case], f"dp_world2 {case}",
                           margins=margins)
            result["cases"][case].update(failed=failed, margins=margins)
            del refs
            records[case] = None
    with open(f"{spec['out']}{rank}.json", "w") as f:
        json.dump(result, f)
    return 0


def run_dp_world2(torch, dev, report=None, cases=DP_CASES, tiny=None, hook=None,
                  fault=None, check: bool = True) -> dict:
    """Phase 14 (c): two processes of one gloo group on the one card (NCCL
    refuses two ranks on one device; gloo stages DDP's all-reduce and the
    all-gathers of CUDA tensors through the host), dp_worker each, with
    timeouts; each case at world 2 held against world 1 over the same
    global batch: the full-width AVCLIP step at B=2 (1 a rank), the MoCo
    step at B=2 (queues 1024 x 14 and 1024; bitwise equal on both ranks),
    the Stage II step at B=16 (8 a rank; K1 24, K2 24, K3 12, K4 2 a rank).
    ``hook`` ('path:function') is called with ``fault`` in each worker
    before the cases (the planted faults); ``tiny`` the dry run's widths.
    Returns rank 0's result; with ``check``, fails on any failed case."""
    import shutil

    workdir = os.path.join(REPO, "build", "chip_smoke", "dp")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    spec = {"device": torch.device(dev).type, "cases": list(cases), "tiny": tiny, "hook": hook,
            "fault": fault, "out": os.path.join(workdir, "result_rank"),
            "timed_steps": 1 if tiny else 2}
    spec_path = os.path.join(workdir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": "0",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "PYTHONHASHSEED": "0",
               "SFT_DIST_TIMEOUT_S": str(DP_GROUP_TIMEOUT_S),
               "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker",
                                       spec_path], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_SPAWN_TIMEOUT_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        fail(f"dp_world2: the group did not finish within {DP_SPAWN_TIMEOUT_S} s")
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("[") or line.startswith("chip_smoke"):
                log(f"  r{rank} {line}" if not line.startswith("[dp_world2]") else line)
        if p.returncode != 0:
            fail(f"dp_world2: rank {rank} exited {p.returncode}: {err[-3000:]}")
    result = json.load(open(spec["out"] + "0.json"))
    log(f"[dp_world2] two ranks over gloo on one card: {time.perf_counter() - t0:.1f} s")
    failed = []
    for case, res in result["cases"].items():
        margins = ", ".join(f"{k} {v:.3g}" for k, v in res.get("margins", {}).items())
        log(f"[dp_world2] {case}: {res['ms']:.1f} ms/step at world 2 (gloo); checks failed "
            f"{res.get('failed')}; margins (error / tolerance) {margins}")
        failed += [f"{case} {name}" for name in res.get("failed", [])]
        if case == "moco" and not res["queues_equal"]:
            failed.append("moco queues differ between the ranks")
        if case == "stage2" and not tiny:
            for what in ("launches", "eval_launches"):
                for r in range(2):
                    counts = json.load(open(spec["out"] + f"{r}.json"))["cases"][case][what]
                    want = {k: STAGE2_LAUNCHES.get(k, 0) for k in KEYS}
                    if {k: counts.get(k, 0) for k in KEYS} != want:
                        failed.append(f"stage2 rank {r} {what} {counts}")
    result["failed"] = failed
    if check and failed:
        fail(f"dp_world2: {failed}")
    shutil.rmtree(workdir, ignore_errors=True)
    return result


def run_data_parallel(torch, dev, report):
    """Phase 14: (a) run_dp_world1, (b) run_dp_launcher, (c) run_dp_world2."""
    for part in (run_dp_world1, run_dp_launcher, run_dp_world2):
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        part(torch, dev, report)
        log(f"[dp] {part.__name__} {time.perf_counter() - t0:.1f} s")


# phase 12: the audio augmentations at the published Stage I crop, 5 s at
# 16 kHz, B=2 (configs/segment_avclip.yaml: crop_len_sec 5, afps 16000)
AUG_B, AUG_N, AUG_SR = 2, 80_000, 16_000
# each transform on the card at p=1 against the same function on the CPU in
# float64, max |card - cpu64| over max |cpu64|: the FFT filters run in f64 on
# both sides (only the f32 input and output round), volume and noise are one
# rounding; the pitch shift's WSOLA correlations and its sinc sum run in f32
# on the card (the offsets chosen must be equal), so the chain holds to that
AUG_TOL = {"reverb": 1e-5, "volume": 1e-6, "pitch": 1e-4, "lowpass": 1e-5, "noise": 1e-6,
           "chain": 1e-4}


def aug_signal(b: int = AUG_B, n: int = AUG_N, sr: int = AUG_SR):
    """Seeded PCM (b, n) in f32: three tones a row (a clear best WSOLA match
    at every step) under noise at -34 dB."""
    import numpy as np

    rng = np.random.default_rng(12)
    t = np.arange(n) / sr
    rows = [0.5 * np.sin(2 * np.pi * (440 + 37 * r) * t) + 0.3 * np.sin(2 * np.pi * 1234 * t)
            + 0.2 * np.sin(2 * np.pi * (97 + 5 * r) * t) for r in range(b)]
    return (np.stack(rows) + 0.02 * rng.standard_normal((b, n))).astype(np.float32)


def sox_reverb_scalar(x, sr, reverberance=50.0, hf_damping=50.0, room_scale=100.0,
                      stereo_depth=100.0, wet_gain_db=0.0):
    """Float64 sample-loop transliteration of sox reverb.c (reverb_create /
    filter_array_create / comb_process / allpass_process), wet only, a mono
    input -> the mean of the two spread channels (the reference's
    `reverb -w` then wave.mean(dim=0))."""
    import math

    import numpy as np

    r = sr / 44100.0
    scale = room_scale / 100.0 * 0.9 + 0.1
    depth = stereo_depth / 100.0
    a = -1.0 / math.log(1.0 - 0.3)
    b = 100.0 / (math.log(1.0 - 0.98) * a + 1.0)
    feedback = 1.0 - math.exp((reverberance - b) / (a * b))
    damping = hf_damping / 100.0 * 0.3 + 0.2
    gain = 10.0 ** (wet_gain_db / 20.0) * 0.015
    n = len(x)
    outs = []
    for c in range(2):
        offset = c * depth
        combs, aps = [], []
        # the stereo-spread offset goes on the 44.1 kHz base length, before
        # the rate and room scaling
        for length in (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617):
            combs.append(int(r * scale * (length + 12 * offset) + 0.5))
            offset = -offset
        for length in (225, 341, 441, 556):
            aps.append(int(r * (length + 12 * offset) + 0.5))
            offset = -offset
        bufs = [np.zeros(d) for d in combs]
        stores = [0.0] * len(combs)
        ptrs = [0] * len(combs)
        abufs = [np.zeros(d) for d in aps]
        aptrs = [0] * len(aps)
        y = np.zeros(n)
        for i in range(n):
            out = 0.0
            for k, d in enumerate(combs):
                o = bufs[k][ptrs[k]]
                stores[k] = o + (stores[k] - o) * damping
                bufs[k][ptrs[k]] = x[i] + stores[k] * feedback
                ptrs[k] = (ptrs[k] + 1) % d
                out += o
            for k, d in enumerate(aps):
                o = abufs[k][aptrs[k]]
                abufs[k][aptrs[k]] = out + o * 0.5
                aptrs[k] = (aptrs[k] + 1) % d
                out = o - out
            y[i] = out * gain
        outs.append(y)
    return (outs[0] + outs[1]) / 2.0


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in f64."""
    return float((got.double().cpu() - want.double().cpu()).abs().max()
                 / want.double().abs().max())


def host_ms_synced(torch, fn, calls: int = 5) -> float:
    """Host milliseconds a call, synchronised (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def run_audio_augs(torch, dev, report, b: int = AUG_B, n: int = AUG_N):
    """Phase 12: the five augmentations (ops/dsp.py) and their chain on the
    card at (b, n), forced on (every row drawn) and off (no row drawn),
    against the same functions on the CPU in float64; the reverb also
    against sox_reverb_scalar on the first 2400 samples; ms per transform
    and per chain by CUDA events and by the host's clock."""
    from synchformer_tpu_torch.ops import dsp

    x_np = aug_signal(b, n)
    x = torch.from_numpy(x_np).to(dev)
    x64 = torch.from_numpy(x_np).double()
    on, off = torch.ones(b, dtype=torch.bool), torch.zeros(b, dtype=torch.bool)
    noise = torch.randn(x.shape, generator=torch.Generator(dev).manual_seed(12), device=dev)
    transforms = {
        "reverb": lambda v, rows: dsp.apply_reverb(v, rows, AUG_SR),
        "volume": lambda v, rows: dsp.apply_volume(v, rows, 2.0),
        "pitch": lambda v, rows: dsp.apply_pitch_shift(v, rows, AUG_SR, 1000.0),
        "lowpass": lambda v, rows: dsp.apply_lowpass(v, rows, AUG_SR, 100.0),
        "noise": lambda v, rows: dsp.apply_gauss_noise(v, rows, noise.to(v.device, v.dtype),
                                                       0.01),
        "chain": lambda v, rows: dsp.apply_audio_aug_chain(
            v, {**{k: rows for k in dsp.AUG_CHAIN},
                "noise_values": noise.to(v.device, v.dtype)}, AUG_SR),
    }
    t0 = time.perf_counter()
    for name, fn in transforms.items():
        got, want = fn(x, on), fn(x64, on)
        err = rel_err(got, want)
        ok = (got.dtype == torch.float32 and got.shape == x.shape
              and bool(torch.isfinite(got).all()) and err <= AUG_TOL[name])
        same_off = torch.equal(fn(x, off), x)
        log(f"[augs] {name} p=1: max|card-cpu64| / max|cpu64| {err:.3e} tol {AUG_TOL[name]:.0e} "
            f"{'ok' if ok else 'FAIL'}; p=0 {'identity' if same_off else 'CHANGED'}")
        if not (ok and same_off):
            fail(f"audio augmentation {name}: error {err:.3e} or not the identity at p=0")
    offsets, offsets64 = [], []
    stretched = dsp.tempo_wsola(x, 1.0 / 2.0 ** (1000.0 / 1200.0), AUG_SR, offsets=offsets)
    dsp.tempo_wsola(x64, 1.0 / 2.0 ** (1000.0 / 1200.0), AUG_SR, offsets=offsets64)
    same = torch.equal(torch.stack(offsets).cpu(), torch.stack(offsets64))
    log(f"[augs] WSOLA: {len(offsets)} steps of {b} rows, n_out {stretched.shape[-1]}; offsets "
        f"{'equal to' if same else 'DIFFERENT FROM'} the cpu64 run's")
    if not same:
        fail("WSOLA chose other offsets on the card than in float64 on the CPU")
    short = x[:, :2400]
    golden = torch.from_numpy(sox_reverb_scalar(x_np[0, :2400].astype("float64"), AUG_SR))
    wet = dsp.reverb(short, AUG_SR)[0].double().cpu()
    bad = (wet - golden).abs() > 2e-5 + 1e-3 * golden.abs()
    log(f"[augs] reverb vs the sox reverb.c scalar spec (2400 samples): max abs err "
        f"{float((wet - golden).abs().max()):.3e}, {int(bad.sum())} outside rtol 1e-3 atol 2e-5")
    if bool(bad.any()):
        fail("reverb disagrees with the sox scalar spec")
    log(f"[augs] checks {time.perf_counter() - t0:.1f} s")
    for name, fn in transforms.items():
        ev = cuda_time_ms(lambda: fn(x, on), iters=5, warmup=1)
        host = host_ms_synced(torch, lambda: fn(x, on))
        log(f"[timing] augs {name} p=1 at ({b}, {n}): {ev:.3f} ms by CUDA events, {host:.3f} ms "
            f"by the host's clock")
    gens = (torch.Generator().manual_seed(0), torch.Generator(dev).manual_seed(0))
    for p in (0.0, 0.2):
        host = host_ms_synced(torch, lambda: dsp.random_audio_aug_chain(x, p, AUG_SR, *gens),
                              calls=20)
        log(f"[timing] augs random_audio_aug_chain p={p} at ({b}, {n}): {host:.3f} ms by the "
            f"host's clock, draws included (mean of 20)")


# phase 13: the entry point, python -m synchformer_tpu_torch.main, in-process
ENTRY_CONFIGS = os.path.join(REPO, "synchformer_tpu", "config", "configs")
SYNTHETIC_AV = "synchformer_tpu.data.datasets.SyntheticAV"


def entry_plan(root: str) -> list:
    """The runs of phase 13, in order: (tag, argv, the kernel launches of
    each train step, the first epoch, the epochs). Stage I: the published
    segment_avclip.yaml (p_audio_aug 0.2), B=2, SyntheticAV (8 clips a
    split: 4 steps an epoch), its first epoch, then resumed for the second;
    Stage II: sync.yaml, B=16, 32 clips a split (2 steps an epoch), its
    towers from the Stage I run, 2 epochs, early stopping on mROCAUC (the
    stopper starts at 0, the reference's, and a seeded model's accuracy_1
    on 32 clips of 21 classes is 0 in about a fifth of epochs, which would
    leave no best store to fine-tune from); Stage III: ft_synchability.yaml
    fine-tuned from Stage II's best store, 1 epoch. Every run logs each step
    (log_frequency 1) without the code snapshot."""
    def argv(config, exp, n_clips, *extra):
        return [f"config={os.path.join(ENTRY_CONFIGS, config)}", "device=cuda",
                f"data.dataset.target={SYNTHETIC_AV}", f"data.dataset.params.n_clips={n_clips}",
                f"logging.logdir={root}", f"logging.exp_name={exp}",
                "logging.log_code_state=false", "logging.log_frequency=1", *extra]

    stage1 = os.path.join(root, "stage1")
    return [
        ("stage1", argv("segment_avclip.yaml", "stage1", 8, "training.num_epochs=1"),
         STAGE1_LAUNCHES, 0, 1),
        ("stage1_resumed", argv("segment_avclip.yaml", "stage1", 8, "training.num_epochs=2",
                                "training.resume=latest"), STAGE1_LAUNCHES, 1, 2),
        ("stage2", argv("sync.yaml", "stage2", 32, "training.num_epochs=2",
                        "training.metric_name=mROCAUC",
                        f"model.params.afeat_extractor.params.ckpt_path={stage1}",
                        f"model.params.vfeat_extractor.params.ckpt_path={stage1}"),
         STAGE2_LAUNCHES, 0, 2),
        ("stage3", argv("ft_synchability.yaml", "stage3", 32, "training.num_epochs=1",
                        f"training.ckpt_path={os.path.join(root, 'stage2', 'ckpts', 'best')}",
                        f"model.params.afeat_extractor.params.ckpt_path={stage1}",
                        f"model.params.vfeat_extractor.params.ckpt_path={stage1}"),
         STAGE2_LAUNCHES, 0, 1),
    ]


class FitRecorder:
    """Wraps the trainers' train_step, fit and Stage I's resume while a run
    goes: each train step's kernel launches (the counters' change across
    the call), each fit's trainer summary (step, the augmentations drawn,
    its run directory), and the parameters a Stage I resume restored,
    held against ``want_state`` (name -> CPU tensor) bit for bit."""

    def __init__(self, torch, classes):
        from synchformer_tpu_torch.ops.kernels import _build

        self.torch, self.classes, self.launches = torch, classes, _build.launches
        self.steps, self.fits, self.resumes = [], [], []
        self.want_state = None
        self.saved = []

    def __enter__(self):
        torch, rec = self.torch, self
        for cls in self.classes:
            step, fit = cls.train_step, cls.fit
            self.saved.append((cls, "train_step", step))
            self.saved.append((cls, "fit", fit))

            def train_step(tr, *a, _step=step, **k):
                before = dict(rec.launches)
                out = _step(tr, *a, **k)
                rec.steps.append({key: rec.launches.get(key, 0) - before.get(key, 0)
                                  for key in KEYS})
                return out

            def fit_(tr, *a, _fit=fit, **k):
                out = _fit(tr, *a, **k)
                rec.fits.append({"step": tr.step, "aug_drawn": dict(tr.aug_drawn),
                                 "logdir": str(tr.logdir), "trainer": type(tr).__name__,
                                 "state": {n: v.detach().to("cpu", copy=True)
                                           for n, v in tr.model.state_dict().items()}
                                 if hasattr(tr, "resume") else None})
                return out

            cls.train_step, cls.fit = train_step, fit_
            if hasattr(cls, "resume"):
                resume = cls.resume
                self.saved.append((cls, "resume", resume))

                def resume_(tr, stopper, _resume=resume):
                    start = _resume(tr, stopper)
                    sd = tr.model.state_dict()
                    equal = rec.want_state is not None and sd.keys() == rec.want_state.keys() \
                        and all(torch.equal(v.cpu(), rec.want_state[n]) for n, v in sd.items())
                    rec.resumes.append({"start": start, "step": tr.step, "equal": equal})
                    return start

                cls.resume = resume_
        return self

    def __exit__(self, *exc):
        for cls, name, fn in reversed(self.saved):
            setattr(cls, name, fn)
        return False


def fit_timing(logdir: str, tag: str, after_step: int = 0) -> dict:
    """A fit's per-step telemetry from its run's scalars.jsonl (logged every
    step), the steps after ``after_step`` (an earlier fit of the run):
    batch and data seconds a step; ms/step, the median over the fit's steps
    after its first (which waits for the loader's first batch and warms the
    card up), and the loader's share (data over batch time) over the same
    steps."""
    rows = [json.loads(line) for line in open(os.path.join(logdir, "scalars.jsonl"))]
    batch = [r["value"] for r in rows if r["tag"] == "train/batch_time" and r["step"] > after_step]
    data = [r["value"] for r in rows if r["tag"] == "train/data_time" and r["step"] > after_step]
    b, d = (batch[1:], data[1:]) if len(batch) > 1 else (batch, data)
    ms = sorted(b)[len(b) // 2] * 1e3
    share = sum(d) / sum(b)
    log(f"[timing] {tag} inside fit: {ms:.1f} ms/step (median of {len(b)} after the first; "
        f"every step {[round(v * 1e3, 1) for v in batch]} ms, loader wait "
        f"{[round(v * 1e3, 1) for v in data]} ms); loader share {share:.3f}")
    return {"ms": ms, "share": share}


def run_entry_point(torch, dev, report, plan=None, pipelines=((2, 14), (16, 14))):
    """Phase 13: synchformer_tpu_torch.main's dispatch in-process on each run
    of ``plan`` (entry_plan's by default): every train step's launches
    exact, the steps counted, the augmentations drawn, ckpts/latest and
    ckpts/best written, the resume continuing the step counter from
    restored parameters equal bit for bit to the first run's, Stage I and
    II ms/step inside fit and the loader's share; then
    measure_pipeline_throughput of the synthetic pipeline alone (Stage I's
    geometry at each (batch, segments) of ``pipelines``, through the
    StagedLoader onto the card)."""
    import shutil

    from synchformer_tpu_torch.data.datasets import SyntheticAV
    from synchformer_tpu_torch.data.pipeline import (
        StagedLoader,
        SyncDataLoader,
        measure_pipeline_throughput,
    )
    from synchformer_tpu_torch.data.transforms import SyncPipelineConfig
    from synchformer_tpu_torch.main import main as entry
    from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
    from synchformer_tpu_torch.train.stage_sync import SyncTrainer

    root = os.path.join(REPO, "build", "chip_smoke", "runs")
    shutil.rmtree(root, ignore_errors=True)
    plan = entry_plan(root) if plan is None else plan(root)
    timing, ended = {}, {}
    with FitRecorder(torch, (AVCLIPTrainer, SyncTrainer)) as rec:
        for tag, argv, launches, first_epoch, epochs in plan:
            t0 = time.perf_counter()
            n_steps = len(rec.steps)
            results = entry(argv)
            fit = rec.fits[-1]
            steps = rec.steps[n_steps:]
            shown = results.get("test", results)
            log(f"[entry] {tag}: main({' '.join(a for a in argv if '=' in a)}) "
                f"{time.perf_counter() - t0:.1f} s; {len(steps)} train steps, trainer step "
                f"{fit['step']}; augmentations drawn in {fit['aug_drawn']} steps; "
                f"{'test' if 'test' in results else 'valid'} "
                f"{ {k: round(v, 4) for k, v in shown.items() if isinstance(v, float)} }")
            for i, counts in enumerate(steps):
                want = {key: launches.get(key, 0) for key in KEYS}
                if counts != want:
                    fail(f"{tag}: train step {i} launched {counts}, expected {want}")
            log(f"[entry] {tag}: launches in each of its {len(steps)} train steps: "
                f"{ {k: v for k, v in steps[0].items() if v} }")
            start = ended["stage1"] if tag == "stage1_resumed" else 0
            if fit["step"] != start + len(steps) or not steps:
                fail(f"{tag}: trainer step {fit['step']} after {len(steps)} steps from {start}")
            ended[tag] = fit["step"]
            ckpts = os.path.join(fit["logdir"], "ckpts")
            stores = {s: sorted(os.listdir(os.path.join(ckpts, s)))
                      if os.path.isdir(os.path.join(ckpts, s)) else [] for s in ("latest", "best")}
            want_latest = [f"{epochs - 1}.json", f"{epochs - 1}.pt"]
            if not set(want_latest) <= set(stores["latest"]) or not stores["best"]:
                fail(f"{tag}: checkpoint stores {stores}, expected latest {want_latest} and a best")
            log(f"[entry] {tag}: ckpts/latest {stores['latest']}, ckpts/best {stores['best']}")
            if tag == "stage1":
                rec.want_state = fit["state"]
            if tag == "stage1_resumed":
                r = rec.resumes[-1]
                log(f"[entry] resume: from epoch {r['start']} at step {r['step']}, parameters "
                    f"{'equal to' if r['equal'] else 'DIFFERENT FROM'} the first run's, bit for bit")
                if not (r["equal"] and r["start"] == first_epoch and r["step"] == start):
                    fail(f"{tag}: resume {r}, expected epoch {first_epoch} at step {start}")
            if tag in ("stage1_resumed", "stage2"):
                timing[tag] = fit_timing(fit["logdir"], tag, start)
            fit["state"] = None
            gc.collect()
            torch.cuda.empty_cache()
    log(f"[entry] Stage I ms/step inside fit {timing['stage1_resumed']['ms']:.1f} (loader share "
        f"{timing['stage1_resumed']['share']:.3f}); Stage II {timing['stage2']['ms']:.1f} "
        f"(loader share {timing['stage2']['share']:.3f})")
    for b, s in pipelines:
        cfg = SyncPipelineConfig(n_segments=s, do_offset=False, audio_jitter_sec=0.0,
                                 p_audio_aug=0.2)
        loader = StagedLoader(SyncDataLoader(SyntheticAV("train", n_clips=8 * b // 2), cfg, b,
                                             num_workers=4, seed=0), device=dev)
        for _ in loader:  # decode every clip once (the synthetic cache)
            pass
        stats = measure_pipeline_throughput(loader, lambda batch: None, epochs=2,
                                            sync=torch.cuda.synchronize)
        log(f"[timing] synthetic pipeline alone, B={b} S={s} (decode, geometry, staging onto "
            f"the card): {stats['clips_per_sec']:.2f} clips/s over {stats['clips']} clips, host "
            f"wait {stats['host_wait_frac']:.3f}; {loader.h2d_bytes / 2 ** 20:.0f} MiB staged in "
            f"{loader.h2d_s:.2f} s of the stager's time")
    shutil.rmtree(root, ignore_errors=True)


# phase 15: the reference-checkpoint entry points (python -m
# synchformer_tpu_torch.example, python -m
# synchformer_tpu_torch.scripts.test_syncability) on reference-style .pt files
EXAMPLE_CLIP = "synthetic://example/0.mp4"
EXAMPLE_OFFSET = 1.6
# the reference's target names of the sync config's nodes (a Stage II / III
# checkpoint's args); the transformer under its legacy module
REFERENCE_TARGETS = {
    "synchformer_tpu.models.sync_model.Synchformer": "model.sync_model.Synchformer",
    "synchformer_tpu.models.ast_encoder.ASTEncoder": "model.modules.feat_extractors.audio.ast.AST",
    "synchformer_tpu.models.motionformer.MotionFormerEncoder":
        "model.modules.feat_extractors.visual.motionformer.MotionFormer",
    "synchformer_tpu.models.sync_model.GlobalTransformer":
        "model.modules.feature_selector.GlobalTransformer",
    "synchformer_tpu.models.sync_model.GlobalTransformerWithSyncabilityHead":
        "model.modules.feature_selector.GlobalTransformerWithSyncabilityHead",
    "synchformer_tpu.models.pos_emb.RandInitPositionalEncoding":
        "model.modules.transformer.RandInitPositionalEncoding",
}
# one entry each file holds that no model reads
UNREAD_KEY = "afeat_extractor.ast.embeddings.legacy_unused"
# the AudioSet position embedding a reference AST keeps (ref: audio/ast.py:240-245)
AST_REF_TOKENS = 1214


def reference_sync_args(action: str, n_segments: int, widths: dict | None = None) -> dict:
    """The training config a reference Stage II (III) checkpoint stores, as
    a plain tree: sync_config's sections under the reference's target names,
    the transformer under the legacy model.modules.feature_selector, the
    towers' ckpt_path pointing at no file, their time tails
    'torch.nn.Identity', ${} interpolations for the projections' and the
    offset head's widths, and a key no JAX class has (the AST's
    legacy_knob)."""
    cfg = sync_config(action, n_segments, ckpt_path="/nonexistent/stage1.pt", widths=widths)

    def rename(node):
        if isinstance(node, dict):
            node = {k: rename(v) for k, v in node.items()}
            if node.get("target") in REFERENCE_TARGETS:
                node["target"] = REFERENCE_TARGETS[node["target"]]
        return node

    model = rename(cfg["model"])
    p = model["params"]
    for tower in ("afeat_extractor", "vfeat_extractor"):
        p[tower]["params"]["agg_time_module"] = "torch.nn.Identity"
    p["afeat_extractor"]["params"]["legacy_knob"] = 123
    for proj in ("aproj", "vproj"):
        p[proj] = {"target": "torch.nn.Linear", "params": {
            "in_features": p[proj]["params"]["in_features"],
            "out_features": "${model.params.transformer.params.n_embd}"}}
    p["transformer"]["params"]["off_head_cfg"]["params"]["out_features"] = "${data.num_off_cls}"
    return {"action": action, "model": model, "training": cfg["training"],
            "data": {**cfg["data"], "max_off_sec": 2.0}}


def write_reference_sync_ckpt(torch, path: str, action: str, n_segments: int, seed: int) -> dict:
    """Phase 15 (a): a reference-style Stage II (III) checkpoint of a seeded
    build_synchformer(n_segments) (with the syncability head for Stage
    III's action): the weights under "model" with module. prefixes, with
    UNREAD_KEY beside them, and reference_sync_args pickled as an omegaconf
    DictConfig. Returns the seeded state dict."""
    from synchformer_tpu_torch.models.presets import build_synchformer
    from synchformer_tpu_torch.utils.convert import seeded_state_dict
    from synchformer_tpu_torch.utils.reference_ckpt import save_reference_ckpt

    sd = seeded_state_dict(build_synchformer(n_segments, action == SYNCABILITY_ACTION,
                                             device="meta"), seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_reference_ckpt(path, {**sd, UNREAD_KEY: torch.zeros(4)},
                        reference_sync_args(action, n_segments), extra={"epoch": 0})
    return sd


def write_reference_stage1_ckpt(torch, path: str, seed: int = 1, build=None) -> dict:
    """Phase 15 (c): a reference-style Stage I checkpoint of a seeded
    build_avclip() (or ``build()``): the towers under the reference's a_encoder. / v_encoder.
    names, module.-prefixed, under "state_dict"; the AST position embedding
    AST_REF_TOKENS long, its first 74 rows the model's own; a Stage I config
    pickled as args. Returns the state dict as written (without module.)."""
    import numpy as np

    from synchformer_tpu_torch.models.presets import build_avclip
    from synchformer_tpu_torch.utils.convert import AST_POS_EMB, seeded_state_dict
    from synchformer_tpu_torch.utils.reference_ckpt import save_reference_ckpt

    sd = seeded_state_dict((build or build_avclip)(device="meta"), seed)
    sd = {k.replace("vfeat_extractor.", "v_encoder.").replace("afeat_extractor.", "a_encoder."): v
          for k, v in sd.items()}
    pos = sd[f"a_encoder.{AST_POS_EMB}"]
    extra = np.random.default_rng(seed + 100).standard_normal(
        (1, AST_REF_TOKENS - pos.shape[1], pos.shape[2]), dtype=np.float32) * np.float32(0.02)
    sd[f"a_encoder.{AST_POS_EMB}"] = np.concatenate([pos, extra], axis=1)
    args = {"action": "train_avclip", "model": {
        "target": "model.modules.feat_extractors.train_clip_src.open_clip.model.AVCLIP",
        "params": {"n_embd": int(pos.shape[2]), "init_scale": 0.07}}}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_reference_ckpt(path, sd, args, weights_key="state_dict", extra={"epoch": 0})
    return sd


def stage1_reference_check(torch, dev, root: str, build=None, widths: dict | None = None,
                           s: int = S) -> list:
    """Phase 15 (c): SyncTrainer built from sync.yaml's model section with
    both towers' ckpt_path at a reference-style Stage I file: each tower's
    report lists nothing missing, unexpected or mismatched, and the AST
    position embedding equals the file's first 74 rows bit for bit (the
    video CLS token the file's). ``build`` / ``widths`` / ``s``: another
    Stage I model (build_avclip's by default), sync_config's widths and
    segments, for the planted faults' dry run. Returns the checks that
    failed ('tower_init' where the towers' initialisation raised)."""
    from synchformer_tpu_torch.utils.convert import AST_POS_EMB

    path = os.path.join(root, "stage1_reference.pt")
    sd = write_reference_stage1_ckpt(torch, path, build=build)
    cfg = sync_config("train_avsync_model", s, ckpt_path=path, widths=widths)
    try:
        tr = sync_trainer(cfg, dev, "kernel", True)
    except ValueError as e:
        log(f"[reference] stage1: the towers' initialisation raised: {str(e)[:300]} FAIL")
        return ["tower_init"]
    finally:
        os.remove(path)
    failed = []
    for key, rep in tr.tower_reports.items():
        bad = {k: v for k, v in rep.items() if v}
        log(f"[reference] stage1 -> {key}: report {bad or 'empty'} "
            f"{'ok' if not bad else 'FAIL'}")
        if bad:
            failed.append(f"{key} report")
    towers = tr.model
    for name, got, want in (
            ("ast pos emb", towers.afeat_extractor.ast.embeddings.position_embeddings,
             sd[f"a_encoder.{AST_POS_EMB}"][:, :74]),
            ("video cls token", towers.vfeat_extractor.cls_token, sd["v_encoder.cls_token"])):
        got = got.detach().float().cpu()
        want = torch.from_numpy(want)
        same = tuple(got.shape) == tuple(want.shape) and torch.equal(got, want)
        log(f"[reference] stage1: {name} {tuple(got.shape)} "
            f"{'equal to the file bit for bit' if same else 'DIFFERS from the file'}"
            + ("" if same or got.shape != want.shape
               else f" (max |diff| {maxabs(got, want):.3e})"))
        if not same:
            failed.append(name)
    del tr
    return failed


def example_records(torch, dev, ckpt: str, video, pcm) -> dict:
    """The example's item through the port in-process, each predictor on its
    own copy of the checkpoint's model: serving_record's logits and
    probabilities on the plain path in f32 and bf16 and on the kernel path
    in bf16, and the ms of one forward (CUDA events) of each bf16 path."""
    from synchformer_tpu_torch.example import load_sync_checkpoint
    from synchformer_tpu_torch.infer import SyncPredictor

    out = {}
    for name, dtype, impl in (("f32", torch.float32, "plain"), ("plain", torch.bfloat16, "plain"),
                              ("kernel", torch.bfloat16, "kernel")):
        model, info = load_sync_checkpoint(ckpt)
        pred = SyncPredictor(model, dev, dtype, impl, info["max_spec_t"], info["num_mel_bins"])
        logits = pred.logits(video, pcm).float()
        out[name] = {"logits": logits, "probs": torch.softmax(logits, -1)}
        if name != "f32":
            out[name]["ms"] = cuda_time_ms(lambda: pred.logits(video, pcm), iters=5)
        del pred, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_example_cli(torch, dev, root: str, ckpt_dir: str, exp: str) -> None:
    """Phase 15 (b): python -m synchformer_tpu_torch.example on the Stage
    II file, a subprocess with a timeout, on EXAMPLE_CLIP at EXAMPLE_OFFSET:
    exit 0, the top 5 printed, its kernel launches exactly one forward's
    (STAGE2_LAUNCHES), its probabilities held by serving_agreement against
    the same prepared item (the .npz it writes) through the plain bf16 and
    f32 paths in-process; ms/clip of each path."""
    import numpy as np

    from synchformer_tpu_torch.ops.video import patchify_frames

    out = os.path.join(root, "example.npz")
    cmd = [sys.executable, "-m", "synchformer_tpu_torch.example", f"exp_name={exp}",
           f"vid_path={EXAMPLE_CLIP}", f"offset_sec={EXAMPLE_OFFSET}", f"ckpt_dir={ckpt_dir}",
           f"out={out}"]
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"example: exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    top = [ln for ln in lines if ln.startswith("p=")]
    for ln in lines:
        log(f"[example] | {ln}")
    if "Prediction Result:" not in lines or len(top) != 5:
        fail(f"example: no top-5 printout in {proc.stdout[-2000:]}")
    launches = [json.loads(ln.split(": ", 1)[1]) for ln in lines
                if ln.startswith("kernel launches: ")]
    if launches != [STAGE2_LAUNCHES]:
        fail(f"example: kernel launches {launches}, expected one forward's {STAGE2_LAUNCHES}")
    rec = np.load(out)
    video = torch.from_numpy(np.ascontiguousarray(patchify_frames(rec["video"][None], 2, 16)))
    pcm = torch.from_numpy(rec["audio"][None])
    recs = example_records(torch, dev, os.path.join(ckpt_dir, f"{exp}.pt"), video, pcm)
    cli = {"logits": torch.from_numpy(rec["logits"][None]).to(dev),
           "probs": torch.from_numpy(rec["probs"][None]).to(dev)}
    log(f"[example] the CLI's probabilities: max|cli-f32| "
        f"{maxabs(cli['probs'], recs['f32']['probs']):.3e}, max|in-process kernel-cli| "
        f"{maxabs(cli['probs'], recs['kernel']['probs']):.3e}; top-1 cli "
        f"{int(cli['probs'].argmax())} f32 {int(recs['f32']['probs'].argmax())}")
    failed = serving_agreement(recs["f32"], recs["plain"], cli, "example")
    if failed:
        fail(f"example: the CLI's output outside tolerance: {failed}")
    log(f"[timing] example: the CLI {secs:.1f} s end to end (start, checkpoint read, model "
        f"build, clip, forward); its forward at B=1 kernel {recs['kernel']['ms']:.2f} ms/clip, "
        f"plain bf16 {recs['plain']['ms']:.2f} ms/clip; {smi_line()}")


def run_syncability_cli(torch, dev, root: str, ckpt_off: str, ckpt_sync: str) -> None:
    """Phase 15 (d): the syncability CLI's main in-process over the Stage
    III and Stage II files and a SyntheticAV loader (8 clips, B=8,
    iter_times 1): its launches exactly both models' forwards per batch, the
    ROC and tiered pickles written, its sync and offset logits held by
    serving_agreement against the same batches through the plain f32 and
    bf16 paths; clips/s end to end and of the evaluation's forwards."""
    import pickle

    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.scripts import test_syncability as cli

    logdir = os.path.join(root, "syncability")
    argv = [f"ckpt_sync={ckpt_sync}", f"ckpt_off={ckpt_off}",
            "dataset=synchformer_tpu.data.datasets.SyntheticAV", "batch_size=8", "iter_times=1",
            f"logdir={logdir}"]
    kv = dict(a.split("=", 1) for a in argv)
    batches = list(cli.make_loader(kv))  # the clips decoded once, then the same batches
    torch.cuda.synchronize()
    _build.launches.clear()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.launches)
    want = {k: 2 * v * len(batches) for k, v in STAGE2_LAUNCHES.items()}
    log(f"[syncability] main: {out['n_evaluated']} clips in {len(batches)} batches, "
        f"{secs:.1f} s end to end; launches {counts}; metrics {out['metrics_sync']}, "
        f"ROC-AUC {out['roc']['roc_curve_sc']:.4f}")
    if counts != want:
        fail(f"syncability: launches {counts}, expected {want}")
    for name in ("roc_test.pkl", "metrics_test.pkl"):
        with open(os.path.join(logdir, name), "rb") as f:
            pickle.load(f)
    log(f"[syncability] wrote {sorted(os.listdir(logdir))}")
    for tag, ckpt, n_seg, sync, key in (("sync", ckpt_sync, 13, True, "logits_sync"),
                                        ("offset", ckpt_off, 14, False, "logits_off")):
        recs, ms = {}, {}
        for name, dtype, impl in (("f32", torch.float32, "plain"),
                                  ("plain", torch.bfloat16, "plain"),
                                  ("kernel", torch.bfloat16, "kernel")):
            run = cli.eval_fn(cli.load_predictor(ckpt, n_seg, sync, dev, dtype, impl))
            logits = torch.cat([run({"video": b["video"][:, :n_seg], "audio": b["audio"][:, :n_seg]})
                                for b in batches])
            recs[name] = {"logits": logits, "probs": torch.softmax(logits, -1)}
            if name != "f32":
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for b in batches:
                    run({"video": b["video"][:, :n_seg], "audio": b["audio"][:, :n_seg]})
                torch.cuda.synchronize()
                ms[name] = (time.perf_counter() - t1) * 1e3
            del run
            gc.collect()
            torch.cuda.empty_cache()
        main_logits = torch.from_numpy(out[key]).to(dev)
        cli_rec = {"logits": main_logits, "probs": torch.softmax(main_logits, -1)}
        log(f"[syncability] {tag}: max|main-in-process kernel| logits "
            f"{maxabs(main_logits, recs['kernel']['logits']):.3e}")
        failed = serving_agreement(recs["f32"], recs["plain"], cli_rec, f"syncability {tag}")
        if failed:
            fail(f"syncability {tag}: the CLI's logits outside tolerance: {failed}")
        n = out["n_evaluated"]
        log(f"[timing] syncability {tag} model forwards over the {n} clips: kernel "
            f"{ms['kernel']:.1f} ms ({n / ms['kernel'] * 1e3:.2f} clips/s), plain bf16 "
            f"{ms['plain']:.1f} ms ({n / ms['plain'] * 1e3:.2f} clips/s)")
    log(f"[timing] syncability CLI: {out['n_evaluated'] / secs:.2f} clips/s end to end "
        f"(both checkpoints read, both models, the evaluation); {smi_line()}")


def run_reference_ckpts(torch, dev, report):
    """Phase 15: the reference-checkpoint entry points at full width. (a)
    reference-style Stage II and III files of seeded build_synchformer(14)
    and build_synchformer(13, syncability); (b) the example CLI on the Stage
    II file as a subprocess; (c) SyncTrainer's towers from a
    reference-style Stage I file; (d) the syncability CLI over both
    files."""
    import shutil

    root = os.path.join(REPO, "build", "chip_smoke", "reference")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    exp2, exp3 = "reference_stage2", "reference_stage3"
    write_reference_sync_ckpt(torch, os.path.join(root, f"{exp2}.pt"), "train_avsync_model", S, 0)
    write_reference_sync_ckpt(torch, os.path.join(root, f"{exp3}.pt"), SYNCABILITY_ACTION, S3, 2)
    log(f"[reference] (a) wrote {exp2}.pt and {exp3}.pt in {time.perf_counter() - t0:.1f} s")
    run_example_cli(torch, dev, root, root, exp2)
    failed = stage1_reference_check(torch, dev, root)
    if failed:
        fail(f"reference Stage I checkpoint: {failed}")
    run_syncability_cli(torch, dev, root, os.path.join(root, f"{exp2}.pt"),
                        os.path.join(root, f"{exp3}.pt"))
    shutil.rmtree(root, ignore_errors=True)


def legacy_predictors(torch, dev, b: int = B, s: int = S, frames=FRAMES,
                      widths: dict | None = None):
    """Phase 16 (a)'s three SyncPredictors of one seeded legacy Synchformer
    (presets.legacy_sync_model, widths as its d / n_layer / n_head, through
    the port's registry; seeded_state_dict's rule for BatchNorm models):
    'f32' plain, 'plain' bf16, 'kernel' bf16; and seeded uint8 frames (b, s,
    *frames) and PCM (b, s, 10240) on dev."""
    import numpy as np

    from synchformer_tpu_torch.infer import SyncPredictor
    from synchformer_tpu_torch.models.presets import legacy_sync_model
    from synchformer_tpu_torch.registry import instantiate_from_config
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict

    cfg = legacy_sync_model(s, **(widths or {}))
    sd = seeded_state_dict(instantiate_from_config(cfg, device="meta"), seed=0)
    preds = {}
    for name, dtype, impl in (("f32", torch.float32, "plain"), ("plain", torch.bfloat16, "plain"),
                              ("kernel", torch.bfloat16, "kernel")):
        model = instantiate_from_config(cfg, device=dev)
        load_numpy_state_dict(model, sd)
        preds[name] = SyncPredictor(model, dev, dtype, impl)
    rng = np.random.default_rng(5)
    video = torch.from_numpy(rng.integers(0, 256, (b, s, *frames), dtype=np.uint8)).to(dev)
    pcm = torch.from_numpy((rng.standard_normal((b, s, 10240)) * 0.1).astype(np.float32)).to(dev)
    return preds, video, pcm


def legacy_records(torch, preds, video, pcm, what: str = "") -> tuple:
    """serving_record with both towers' features from each of
    legacy_predictors' paths, the f32 reference with TF32 off in cuDNN's
    convs (a full-f32 anchor); the kernel path's launches by key."""
    from synchformer_tpu_torch.ops.kernels import _build

    cuda = video.is_cuda
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = serving_record(torch, preds["f32"], video, pcm, audio=True)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    plain = serving_record(torch, preds["plain"], video, pcm, audio=True)
    if cuda:
        torch.cuda.synchronize()
    _build.launches.clear()
    kern = serving_record(torch, preds["kernel"], video, pcm, audio=True)
    if cuda:
        torch.cuda.synchronize()
    return ref, plain, kern, dict(_build.launches)


def sparsesync_parts(torch, dev):
    """Phase 16 (b)'s modules through the port's registry, in a ModuleDict
    seeded by seeded_state_dict: 'v' S3D unfactorized, 'a' ResNet-18
    unfactorized, 'vb' ConvBridgeVisual 1024 -> SPARSESYNC_D, 'ab'
    ConvBridgeAudio 512 -> SPARSESYNC_D, 't' SparseSyncTransformer (its
    defaults, the JAX ones: 12 layers of 8 heads, SPARSESYNC_D wide) with
    L2Normalize pre-norms and the factorized positional embeddings over the
    maps' grids, SPARSESYNC_GRIDS."""
    d = SPARSESYNC_D
    vis_grid, aud_grid = SPARSESYNC_GRIDS
    from torch import nn

    from synchformer_tpu_torch.registry import instantiate_from_config
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict

    nodes = {
        "v": {"target": "model.modules.feat_extractors.visual.s3d.S3DVisualFeatures",
              "params": {"factorize_space_time": False}},
        "a": {"target": "model.modules.feat_extractors.audio.resnet.ResNet18AudioFeatures",
              "params": {"factorize_freq_time": False}},
        "vb": {"target": "model.modules.bridges.ConvBridgeVisual",
               "params": {"in_channels": 1024, "out_channels": d}},
        "ab": {"target": "model.modules.bridges.ConvBridgeAudio",
               "params": {"in_channels": 512, "out_channels": d}},
        "t": {"target": "model.modules.transformer.Transformer", "params": {
            "num_offset_cls": 21, "visual_block_shape": list(vis_grid),
            "audio_block_shape": list(aud_grid),
            "vis_pos_emb_module": {
                "target": "model.modules.transformer.PositionEmbeddingLearnedVisual",
                "params": {"block_shape": list(vis_grid), "n_embd": d}},
            "aud_pos_emb_module": {
                "target": "model.modules.transformer.PositionEmbeddingLearnedAudio",
                "params": {"block_shape": list(aud_grid), "n_embd": d}},
            "pre_norm_cfg": {"target": "model.modules.transformer.L2Normalize"}}}}
    parts = nn.ModuleDict({k: instantiate_from_config(v) for k, v in nodes.items()})
    load_numpy_state_dict(parts, seeded_state_dict(parts, seed=2))
    return parts.to(dev).eval()


def sparsesync_forward(torch, parts, frames_u8, pcm, dtype):
    """One SparseSync forward over whole clips: frames (B, T, H, W, C) uint8
    normalised as SyncPredictor does, S3D -> (B, t, h, w, 1024) ->
    ConvBridgeVisual in its (B, t, D, h, w) layout -> (B, t, h, w, d); the
    clip's log-mel (B, T', 128), every frame (MelSpectrogramConfig's
    max_spec_t None), as one segment through ResNet-18 -> (B, f, t', 512) ->
    ConvBridgeAudio in its (B, D, f, t') layout -> (B, f, t', d); then the
    transformer's offset logits, all on the plain route (the unfactorized
    trunks hold no CLS pool). Matrices of ``parts`` already in ``dtype``."""
    from synchformer_tpu_torch.ops.mel import MelSpectrogramConfig, log_mel_spectrogram
    from synchformer_tpu_torch.ops.video import normalize_frames

    with torch.no_grad():
        v = parts["v"](normalize_frames(frames_u8).to(dtype)[:, None])[:, 0]
        v = parts["vb"](v.permute(0, 1, 4, 2, 3)).permute(0, 1, 3, 4, 2)
        mel = log_mel_spectrogram(pcm, MelSpectrogramConfig(max_spec_t=None))
        a = parts["a"](mel.transpose(-1, -2).to(dtype)[:, None])[:, 0]
        a = parts["ab"](a.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return parts["t"](v, a)


def run_legacy(torch, dev, report):
    """Phase 16: the legacy SparseSync family (models/s3d.py,
    models/resnet_audio.py, models/sparsesync.py, the bridges and pos-embs)
    at the reference's widths, inference.
    (a) legacy sync inference: presets.legacy_sync_model(14) through the
    port's registry (S3D + ResNet-18 towers, projections 1024 / 512 -> 768, the
    GlobalTransformer 3 x 8 x 96 over 72 tokens), seeded, B=8, S=14, 16
    frames of 224² and 66 x 128 log-mel a segment, through SyncPredictor on
    the kernel route in bf16, the plain route in bf16 and the plain route in
    f32 (the reference, TF32 off): launches exactly LEGACY_LAUNCHES (K4 2:
    the spatial pool at (224, 49, 1024), 8 x 128, and the frequency pool at
    (336, 4, 512), 8 x 64), serving_agreement over the probabilities and
    both towers' features; then ms/batch, clips/s and peak memory per route.
    (b) SparseSyncTransformer on the trunks' dense maps, one 5 s clip a row,
    B=8 (sparsesync_parts, sparsesync_forward): 125 frames of 224² -> a (16,
    7, 7) map, the clip's 501 mel frames -> (4, 16); the plain route in bf16
    against f32 (TF32 off): finite (B, 21) logits, the relative L2 error of
    the logits below 0.1 and the probabilities' largest error printed; ms of
    each."""
    from synchformer_tpu_torch.models.sync_model import Synchformer

    tag = "legacy"
    smi = smi_line()
    t0 = time.perf_counter()
    preds, video, pcm = legacy_predictors(torch, dev)
    log(f"[{tag}] (a) three models + inputs {time.perf_counter() - t0:.1f} s; frames "
        f"{tuple(video.shape)}, pcm {tuple(pcm.shape)}")
    ref, plain, kern, counts = legacy_records(torch, preds, video, pcm)
    log(f"[{tag}] launches in one kernel-path forward: {counts}")
    for key, need in LEGACY_LAUNCHES.items():
        if counts.get(key, 0) != need:
            fail(f"{tag}: {key} launched {counts.get(key, 0)} times in one forward, "
                 f"expected {need}")
    for name, rec in (("kernel", kern), ("plain", plain)):
        if rec["probs"].shape != (B, 21) or not bool(torch.isfinite(rec["probs"]).all()):
            fail(f"{tag}: {name} probabilities of shape {tuple(rec['probs'].shape)} or "
                 f"non-finite")
    log(f"[{tag}] feats v {tuple(ref['vfeat'].shape)} std {float(ref['vfeat'].std()):.3f}, "
        f"a {tuple(ref['afeat'].shape)} std {float(ref['afeat'].std()):.3f}; logits "
        f"max|kernel-f32| {maxabs(kern['logits'], ref['logits']):.3e}, max|plain_bf16-f32| "
        f"{maxabs(plain['logits'], ref['logits']):.3e}; f32 top-1 "
        f"{ref['probs'].argmax(-1).tolist()} kernel top-1 {kern['probs'].argmax(-1).tolist()}")
    failed = serving_agreement(ref, plain, kern, tag)
    if failed:
        fail(f"{tag}: kernel path outside tolerance: {failed}")
    del ref, plain, kern
    peak = {}
    for name in ("plain", "kernel"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        preds[name](video, pcm)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        preds[name](video, pcm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            preds[name](video, pcm)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / 3)
    for name, ts in times.items():
        best = min(ts)
        log(f"[timing] {tag} (a) {name} path: {best * 1e3:.1f} ms/batch of {B} clips = "
            f"{B / best:.2f} clips/s (runs {[round(t * 1e3, 1) for t in ts]} ms); peak "
            f"{gib(peak[name])} above the weights; {smi}")
    del preds, video, pcm
    gc.collect()
    torch.cuda.empty_cache()

    import numpy as np

    t0 = time.perf_counter()
    rng = np.random.default_rng(6)
    frames = torch.from_numpy(rng.integers(0, 256, (B, CLIP_FRAMES, *FRAMES[1:]),
                                           dtype=np.uint8)).to(dev)
    clip_pcm = torch.from_numpy((rng.standard_normal((B, CLIP_SAMPLES)) * 0.1).astype(
        np.float32)).to(dev)
    parts = {"f32": sparsesync_parts(torch, dev), "bf16": sparsesync_parts(torch, dev)}
    Synchformer.cast_matrices_(parts["bf16"], torch.bfloat16)
    log(f"[{tag}] (b) models + clips {time.perf_counter() - t0:.1f} s; frames "
        f"{tuple(frames.shape)}, pcm {tuple(clip_pcm.shape)}")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {name: sparsesync_forward(torch, parts[name], frames, clip_pcm, dtype).float()
               for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
        ms = {name: cuda_time_ms(lambda n=name, dt=dtype: sparsesync_forward(
            torch, parts[n], frames, clip_pcm, dt), iters=3, warmup=1)
            for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    got, want = out["bf16"], out["f32"]
    if got.shape != (B, 21) or not bool(torch.isfinite(got).all()):
        fail(f"{tag}: SparseSync logits of shape {tuple(got.shape)} or non-finite")
    rel = float((got.double() - want.double()).norm() / want.double().norm())
    perr = maxabs(torch.softmax(got, -1), torch.softmax(want, -1))
    log(f"[{tag}] (b) SparseSync logits: relative L2 |bf16-f32| {rel:.3e} (limit 0.1), "
        f"max|probs bf16-f32| {perr:.3e} {'ok' if rel < 0.1 else 'FAIL'}")
    if not rel < 0.1:
        fail(f"{tag}: SparseSync bf16 logits off f32 by {rel:.3e} (relative L2)")
    log(f"[timing] {tag} (b) SparseSync plain path, B={B} clips of 5 s: bf16 "
        f"{ms['bf16']:.1f} ms, f32 {ms['f32']:.1f} ms; {smi}")


PHASES = (check_kernels, run_slice, run_stage1, run_packed_block, run_stage1_8head,
          run_serving_8head, run_moco, run_sync_training,
          run_audio_augs, run_entry_point, run_data_parallel, run_reference_ckpts, run_legacy)


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
    from synchformer_tpu_torch.data.media import available_backends

    log(f"[device] media decoders: {available_backends()}")
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
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-worker":
        sys.exit(dp_worker(sys.argv[2]))
    sys.exit(main())
