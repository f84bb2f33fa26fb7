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
files, and Stage I towers from one), the legacy SparseSync family (S3D
and ResNet-18 towers in a Synchformer, the SparseSync transformer), and the
tower options (the live dropouts, keep-masks, the joint-attention
Motionformer, the AST classifier, another MLP ratio, unfactorized towers),
and the shapes the TPU kernels take past the main path's (the AudioSet AST
at 1214 tokens, a ViT-H-width video tower of 16 heads of 80, 2.56 s
segments, mlp_ratio 2.6).

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
   rows, and K2's fc1 / fc2 at phase 18's widths, hidden 1996 (fc2's A and
   W as the first 1996 columns of rows at a pitch of 2000) and D 1280, each
   timed beside one F.linear call, cuBLAS, as a yardstick; ragged cases at
   1, 127, 129, 300 and 8288 rows, N = 192, 384 and 576 (64-wide last
   column tiles), K = 32 and 96, N and K of 1996, 1000 and 520 on every
   epilogue (the tail epilogue; K past the last full k-step), pitched A and
   W; guard-band cases, the pitched ones with NaN past K in each row); then
   (check_shapes, logged as [shapes]) the shapes past the main path's
   (shape_cases): the space and time passes forward and backward, packed and
   (at 16 and 256, where the heads pair into 128 lanes) split, at head_dim
   16, 40, 48, 80, 192 and 256, at ragged frames, a backward frame past one
   streamed key chunk of its width, and in guard bands; K3 at 1214 and 2048
   tokens and at head_dim 32 and 128 over 74 and 1214 tokens; the time pass
   at 32 and 96 frames forward and 32 and 64 backward at 12 heads of 64
   (split) and 16 of 80 (packed); K8c at (4096, 1000) -> 1996; and timed
   with their bound and library call, not reported (shape_timed_cases): K3
   at the AudioSet AST's (8, 1214, 2304) beside scaled_dot_product_attention,
   K7a / K7c at (28, 1569, 3840), 16 heads of 80, K6 at (16, 32, 196, 2304),
   K2 at hidden 1996 and at D 1280;
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
17. the tower options (run_tower_options), each built through the port's
   registry from configs/segment_avclip.yaml or configs/sync.yaml
   (sync_config) with the option changed, seeded weights. (a) The Stage I
   step of segment_avclip.yaml's model with every rate live (the AST's
   hidden_dropout and attn_dropout 0.1, the Motionformer's drop_rate 0.1,
   so the aggregators' block dropouts are live too) and Linear 768 -> 768
   aproj / vproj, B=2, S=14, precision amp, through run_stage1: the kernel
   and plain routes from one generator seed draw the same masks; launches
   exactly K5 24, K6 24 and nothing else (every AST layer, video MLP and
   aggregator is stochastic, so the JAX layers leave K2, K3 and K4);
   stage1_agreement against the f32 plain step with remat; an eval step on
   K1 24, K2 24, K3 12, K4 2; ms/step (scripts/stage1_planted_faults.py
   --only options shows that it fails a kernel route without the
   projections' dropout). (b) sync.yaml's model with attn_layer 'joint'
   (12 plain pre-LN blocks over 1 + 8 x 196 tokens, ViT-B), B=2, S=14,
   bf16, through SyncPredictor: launches exactly K2 12, K3 12 (the AST),
   K4 2 (both pools) and nothing else; serving_agreement; ms/batch and
   peak memory of both routes. (c) sync.yaml's model on uint8 frames (2,
   14, 16, 224, 224, 3) with vis_mask / aud_mask: all kept, the kernel
   route's probabilities against the unmasked kernel route's within phase
   3's rule (2 x the plain bf16 error + 5e-3) and against f32 by
   serving_agreement; partly masked (the last segment's final 4 frames,
   each segment's last 20 mel time bins), serving_agreement against f32
   plain on the same masks, the last segment's video features also apart;
   launches exactly K2 24 (every video block's MLP
   on the packed x and every AST layer's) and nothing else
   (scripts/stage1_planted_faults.py --only options shows that it fails a
   masked divided attention that ignores the mask). (d) One full-width
   forward each against f32 plain, relative L2 within 2 x plain bf16's:
   the AST classifier (extract_features false, 527 labels; K3 12, K2 12),
   sync.yaml's model at mlp_ratio 2 on both towers (K2 at hidden 1536: K1
   24, K2 24, K3 12, K4 2; probabilities and video features), the AST with
   factorize_freq_time false (K3 12, K2 12) and the Motionformer with
   factorize_space_time false (K1 24, K2 12, no K4).
18. the shapes the TPU kernels take past the main path's (run_shapes), each
   built through the registry from configs/sync.yaml or
   configs/segment_avclip.yaml with the widths changed, seeded weights,
   bf16, held against f32 plain with exact launch counts and timed in turns:
   (a) the AudioSet AST classifier (extract_features false, 527 labels,
   max_spec_t 1024: 1214 tokens, 12 heads of 64) alone on 8 clips of 10 s
   (K3 12, K2 12; relative L2 within 2 x plain bf16's); (b) sync.yaml's
   model with a video tower at ViT-H/14's width (embed_dim 1280, 16 heads of
   80, hidden 5120, the Motionformer's depth of 12 where ViT-H has 32) and a
   Linear 1280 -> 768 vproj, B=2, S=14, on attn_impl 'pallas' (K7a 24, K2
   24, K3 12, K4 2 at D 1280) and 'pallas_fused' (K8a 24, K8b 12, K2 12, K3
   12, K4 2) by serving_agreement, then segment_avclip.yaml's model with that
   video tower through run_stage1 (B=2, S=14, amp: K7a 24, K7c 24, K2 13, K3
   12, K4 2); (c) segment_avclip.yaml's model over 2.56 s segments
   (temporal_resolution 32 from 64 frames, max_spec_t 258), B=2, S=8 (at
   S=4 the loss of 8 InfoNCE pairs moves by up to 7e-4 when its similarity
   product rounds to bf16, on either route, past phase 4's loss eps;
   scripts/stage1_loss_error.py), one trainer resident at a time, the plain
   bf16 step with remat, through run_stage1 (K5 24, K6 24 with the time pass
   over 32 frames, K2 13, K3 12, K4 2); (d) sync.yaml's model at mlp_ratio
   2.6 on both towers (hidden 1996), B=2 (K1 24, K2 24, K3 12, K4 2; probabilities, both
   towers' features). scripts/stage1_planted_faults.py --only shapes shows
   that phase 2's new cases fail a padded head's lanes left unzeroed, a time
   pass that drops the frames past 27 and a GEMM that drops its last column
   tile at N = 1996.
19. tensor parallelism (parallel/tensor.py): four ranks of a gloo group on
   the one card as a (2 data x 2 model) grid (training.model_parallel 2),
   phase 14 (c)'s worker (--dp-worker) and randomness off: (a) the Stage II
   step at global B=16 (8 a data rank; K1 24, K2 24, K3 12, K4 2 a rank for
   the eval step and the train step, its rate base_learning_rate x 2) and
   (b) the AVCLIP step at global B=2 (K5 24, K6 24, K2 24: drop-path 0
   puts every video block's MLP half on K2, K3 12, K4 2). Every rank's
   first-step record (whole gradients, gathered over its model group)
   equal, held against the world-1 f32 plain step by sync_agreement /
   stage1_agreement within 2 x the world-1 bf16 kernel step's error; the
   sharded parameters exactly sharded_entries' on the model's whole shapes;
   each shard bitwise equal on its data peers, each replicated parameter on
   every rank, the generator streams on model peers; each rank's bytes of
   parameters + moments within 1% of replicated + sharded / 2; the Stage II
   checkpoint, written from the grid, read by a world-1 trainer bit for
   bit; ms/step over gloo. scripts/stage1_planted_faults.py --only tp shows
   that it fails a clip norm from local shards, streams seeded by global
   rank, a rate scaled by the world, the InfoNCE gathered over every rank
   and a checkpoint saved from rank 0's shards.
20. the legacy towers' training (run_legacy_training: models/conv.py's
   BatchNorm in training with flax's one-pass statistics and running
   update, summed over the data ranks), at their full widths (S3D 1024,
   ResNet-18 512; 16 frames of 224^2 and 66 x 128 log-mel a segment, S=14):
   bn_unit_check (a near-constant channel whose sums are exact: flax's
   output and running var bit for bit); (a) presets.legacy_sync_model(14)
   with is_trainable towers through SyncTrainer at B=2, f32 plain (TF32
   off), bf16 kernel and bf16 plain, launches exactly K4 2 in the eval and
   the train step, sync_agreement with the BatchNorms' updates
   (bn_agreement), each BatchNorm's update against flax's from the f64
   statistics of its input (flax_bn_check), ms/step and peak memory; (b)
   AVCLIPTrainer over S3D + ResNet-18 (AveragePooling time tails, Linear
   projections), B=2, S=8, held the same way; (c) the legacy step at world 2
   over gloo on the one card against world 1, every rank's running
   statistics bitwise equal; (d) the kernel trainer's checkpoint after step
   2 restored into a new trainer, step 3 bit for bit.
   scripts/stage1_planted_faults.py --only legacy_train shows that it fails
   an unbiased running var, torch's momentum, per-rank statistics, a
   two-pass variance and a checkpoint without the running statistics.
The line before the last is a JSON record of the kernels, with the TPU
kernels still to port beside them (none); the last line is {"ok": true,
"device": {...}}. Any failed phase raises, so the exit code is non-zero and no result
line is printed.
"""
from __future__ import annotations

import contextlib
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
# phase 17 (a): the Stage I step with every rate live: K5 / K6 in every
# divided attention and nothing else (the JAX layers leave K2, K3 and K4 in
# every stochastic block)
P17_TRAIN_LAUNCHES = {**{key: 0 for key in KEYS}, "K5": 24, "K6": 24}
# (b): the joint tower's blocks are plain; the AST's K3 and K2, both pools' K4
P17_JOINT_LAUNCHES = {**{key: 0 for key in KEYS}, "K2": 12, "K3": 12, "K4": 2}
# (c): under keep-masks K2 in every video block (the packed x) and AST layer
P17_MASKED_LAUNCHES = {**{key: 0 for key in KEYS}, "K2": 24}
# (d): an AST alone (classifier, unfactorized), the Motionformer alone
# unfactorized (the split flow's eval, no pool), the sync model at mlp_ratio 2
P17_AST_LAUNCHES = {**{key: 0 for key in KEYS}, "K2": 12, "K3": 12}
P17_VIDEO_LAUNCHES = {**{key: 0 for key in KEYS}, "K1": 24, "K2": 12}
P17_SYNC_LAUNCHES = {**{key: 0 for key in KEYS}, "K1": 24, "K2": 24, "K3": 12, "K4": 2}
P17_RATE = 0.1  # every live rate of (a)
H8, DH8 = 8, 96  # the 8-head video tower's heads
# phase 18 (c): 2.56 s segments, 64 frames a segment (32 after the 3-D patch
# embed's pairs), 8 segments a clip: 16 InfoNCE pairs, where the bf16
# rounding of the similarity product fails phase 4's loss rule (eps 1e-4 of
# the loss, set for its 28 pairs) in 2 of 30 seeded batches, against 7 of 30
# at 4 segments (scripts/stage1_loss_error.py)
P18_FRAMES, P18_SEGMENTS = 32, 8
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


def packed_mask(torch, dev, mode: str, f: int = F_T, n: int = N_P):
    """The packed divided attention as a boolean (1 + f*n)^2 mask, True where
    a query sees a key: the CLS query sees every key, a patch the CLS and the
    patches of its frame (space) or of its spatial position (time)."""
    idx = torch.arange(f * n, device=dev)
    group = idx // n if mode == "space" else idx % n
    mask = torch.ones(1 + f * n, 1 + f * n, dtype=torch.bool, device=dev)
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
    return (cases + k4b_cases(torch, dev) + k8_cases(torch, dev) + k4_legacy_cases(torch, dev)
            + shape_timed_cases(torch, dev))


def shape_timed_cases(torch, dev) -> list:
    """kernel_cases' records at phase 18's shapes, timed with their bound
    and library call and logged, not reported (keys with a suffix): K3 at
    the AudioSet AST's (8, 1214, 2304), 12 heads of 64, beside one
    scaled_dot_product_attention; K7a and K7c (space + time) at the
    ViT-H-width tower's packed qkv (28, 1569, 3840), 16 heads of 80, beside
    the masked scaled_dot_product_attention forward and backward; K6 (space +
    time) at the 2.56 s segments' (16, 32, 196, 2304) beside the backward of
    the masked call over 1 + 32 x 196 tokens; K2 (with row statistics) at
    the video tower's rows at B = 2, D 768 with hidden 1996 and D 1280 with
    hidden 5120."""
    import torch.nn.functional as F

    from synchformer_tpu_torch.ops.kernels.divided_attention import divided_attention_packed
    from synchformer_tpu_torch.ops.kernels.divided_attention_bwd import (
        divided_attention_bwd,
        divided_attention_bwd_plain,
        divided_attention_packed_bwd,
        divided_attention_packed_bwd_plain,
    )
    from synchformer_tpu_torch.ops.kernels.fused_rows import fused_ln_mlp_residual, pitched
    from synchformer_tpu_torch.ops.kernels.standard_attention import standard_attention

    g = torch.Generator(device=dev).manual_seed(18)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def cast(args, dtype):
        return [a.to(dtype) if torch.is_tensor(a) and a.dtype == bf else a for a in args]

    def heads_view(qkv, heads, dh):
        b, seq = qkv.shape[:2]
        return [qkv.view(b, seq, 3, heads, dh)[:, :, i].transpose(1, 2) for i in range(3)]

    cases = []
    # K3 at 1214 tokens
    bs, n3, d, h = B, 1214, D, H
    qkv3 = rn(bs, n3, 3 * d)
    q3, k3, v3 = heads_view(qkv3, h, DH)
    cases.append(("K3 N1214", f"K3 ({bs},{n3},{3 * d})",
                  lambda: standard_attention(qkv3, h),
                  lambda dt: standard_attention(qkv3.to(dt), h, impl="plain"),
                  (bs * n3 * 4 * d * 2, 4.0 * bs * h * n3 * n3 * DH),
                  lambda: F.scaled_dot_product_attention(q3, k3, v3)))
    # K7a / K7c at 16 heads of 80 over the Stage I step's 28 packed segments
    bs1, h16, dh16 = B1 * S, 16, 80
    d16 = h16 * dh16
    qkv7, do7 = rn(bs1, SEQ, 3 * d16), rn(bs1, SEQ, d16)
    act7 = bs1 * SEQ * d16 * 2
    masks = {mode: packed_mask(torch, dev, mode) for mode in ("space", "time")}
    q7, k7, v7 = heads_view(qkv7, h16, dh16)
    for mode in ("space", "time"):
        cases.append(("K7a 16x80", f"K7a {mode} ({bs1},{SEQ},{3 * d16}) {h16}x{dh16}",
                      lambda m=mode: divided_attention_packed(qkv7, h16, F_T, m),
                      lambda dt, m=mode: divided_attention_packed(qkv7.to(dt), h16, F_T, m,
                                                                  impl="plain"),
                      (4 * act7, attention_flops(bs1, mode, 2, h16, dh16)),
                      lambda m=mode: F.scaled_dot_product_attention(q7, k7, v7,
                                                                    attn_mask=masks[m])))
    for mode in ("space", "time"):
        cases.append(("K7c 16x80", f"K7c {mode} ({bs1},{SEQ},{3 * d16}) {h16}x{dh16}",
                      lambda m=mode: divided_attention_packed_bwd(qkv7, do7, h16, F_T, m),
                      lambda dt, m=mode: divided_attention_packed_bwd_plain(
                          qkv7.to(dt), do7.to(dt), h16, F_T, m),
                      (7 * act7, attention_flops(bs1, mode, 5, h16, dh16)),
                      sdpa_backward(torch, qkv7, do7, h16, dh16, masks[mode])))
    # K6 at 32 frames a segment, B = 2, S = 8 (phase 18 (c))
    bs6, f6 = B1 * P18_SEGMENTS, P18_FRAMES
    qkv_p6, qkv_c6 = rn(bs6, f6, N_P, 3 * d), rn(bs6, 1, 3 * d)
    dop6, doc6 = rn(bs6, f6, N_P, d), rn(bs6, 1, d)
    act6 = bs6 * f6 * N_P * d * 2
    qkv6 = torch.cat([qkv_c6, qkv_p6.reshape(bs6, -1, 3 * d)], 1)
    do6 = torch.cat([doc6, dop6.reshape(bs6, -1, d)], 1)
    for mode in ("space", "time"):
        cases.append(("K6 f32", f"K6 {mode} ({bs6},{f6},{N_P},{3 * d})",
                      lambda m=mode: divided_attention_bwd(qkv_p6, qkv_c6, dop6, doc6, h, m),
                      lambda dt, m=mode: divided_attention_bwd_plain(
                          *cast([qkv_p6, qkv_c6, dop6, doc6], dt), h, m),
                      (7 * act6 + 2 * bs6 * 7 * d * 2, attention_flops(bs6, mode, 5, h, DH, f6)),
                      sdpa_backward(torch, qkv6, do6, h, DH,
                                    packed_mask(torch, dev, mode, f6, N_P))))
    # K2 at hidden 1996 (D 768) and at D 1280 (hidden 5120), the video
    # tower's rows at B = 2, with the row statistics; W2 laid out at its
    # 16-byte pitch once, as the model casts it
    for key, dw, hid in (("K2 h1996", d, 1996), ("K2 d1280", d16, 4 * d16)):
        args = [rn(bs1, F_T, N_P, dw), 1.0 + rn(dw, std=0.1, dtype=f32),
                rn(dw, std=0.1, dtype=f32), rn(hid, dw, std=0.02), rn(hid, std=0.02, dtype=f32),
                pitched(rn(dw, hid, std=0.02)), rn(dw, std=0.02, dtype=f32), 1e-6]
        rows = bs1 * F_T * N_P
        cases.append((key, f"K2 stats ({bs1},{F_T},{N_P},{dw}) -> {hid}",
                      lambda a=args: fused_ln_mlp_residual(*a, emit_stats=True),
                      lambda dt, a=args: fused_ln_mlp_residual(*cast(a, dt), emit_stats=True,
                                                               impl="plain"),
                      (2 * rows * dw * 2 + rows * 8 * 4 + 2 * dw * hid * 2 + (hid + 3 * dw) * 4,
                       4.0 * rows * dw * hid), None))
    return cases


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


# the head_dims the attention kernels run at their own width (up to 128)
RAGGED_HEAD_DIMS = (32, 64, 96, 128)


def ragged_cases(torch, dev, bs: int = 4, d: int = D, f: int = F_T, k3_lens=(17, 74, 197),
                 space_ns=(49, N_P), long_n: int = 300, time_ns=(49, N_P, 37),
                 bwd_ns=(207, 208, 300), bwd_time_n: int = 37) -> list:
    """kernel_cases' records (no cost, no library) of the two tensor-core
    attention kernels at ragged shapes, checked and logged only: K3 at
    ``k3_lens`` tokens (197: two sweeps over 80-key chunks); the space pass
    through K5's split entry and K7's packed entry at ``space_ns`` patches a
    frame for every head_dim of RAGGED_HEAD_DIMS, and packed at ``long_n`` patches,
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
        for dh in RAGGED_HEAD_DIMS:
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
        for dh in RAGGED_HEAD_DIMS:
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
        for dh in RAGGED_HEAD_DIMS:
            cases += [bwd_split(n, d // dh), bwd_packed(n, d // dh)]
    for dh in RAGGED_HEAD_DIMS:
        cases += [bwd_split(bwd_time_n, d // dh, "time"), bwd_packed(bwd_time_n, d // dh, "time")]
    return cases


# the head_dims (head_dim, heads) phase 2 checks past the main path's: the
# split entries where the heads pair into 128 lanes (heads_groupable: 16 and
# 256 here), the packed ones at every one
SHAPE_HEAD_DIMS = ((16, 8), (40, 4), (48, 4), (80, 4), (192, 2), (256, 2))


def shape_cases(torch, dev, bs: int = 2, f: int = F_T, head_dims=SHAPE_HEAD_DIMS,
                space_ns=(37, 49), k3_lens=(1214, 2048),
                k3_dims=((32, 74), (32, 1214), (128, 74), (128, 1214)),
                frames=((32, 96), (32, 64)), time_widths=((12, 64), (16, 80)),
                time_n: int = 37, k8c=(4096, 1000, 1996),
                k4=((2, 14, 1000), (300, 12, 1000))) -> list:
    """ragged_cases' records (checked and logged only) of the shapes the
    kernels take past the main path's:
    - every (head_dim, heads) of ``head_dims``: the space and time passes
      forward at ``space_ns`` patches a frame and backward at the first,
      packed (K7a / K7b, K7c) and split (K5, K6) where the heads pair into
      128 lanes; the backward's space pass also at a frame one patch past its
      width's streamed chunk (209, 129 or 65 patches at widths up to 128, 192
      and 256: two chunks); a packed forward and backward in guard bands;
    - K3 at ``k3_lens`` tokens (12 heads of 64; two sweeps over 80-key
      chunks) and at ``k3_dims`` (head_dim, tokens) over D = 768, once more
      in a guard band;
    - the time pass forward at ``frames[0]`` frames and backward at
      ``frames[1]`` over ``time_n`` patches at ``time_widths`` (heads,
      head_dim): split at 12 x 64, packed at 16 x 80;
    - K8c at ``k8c`` (rows, d, out): d = 1000, out 1996, the tail epilogue
      storing rows that are not 16-byte aligned;
    - K4 at ``k4`` (groups, rows, hidden) at D 768, 12 heads, an MLP width
      of 1000 (8-value pieces): its tail on the skinny product (2 groups) and
      on the Hopper GEMM's tail epilogue (300 groups).
    Inputs at std 1.5 (logits of std about 2), cotangents at std 1."""
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.ops.kernels import divided_attention as tda
    from synchformer_tpu_torch.ops.kernels import divided_attention_bwd as dab
    from synchformer_tpu_torch.ops.kernels.cls_pool import fused_cls_pool_tokens
    from synchformer_tpu_torch.ops.kernels.fused_rows import fused_ln_matmul
    from synchformer_tpu_torch.ops.kernels.standard_attention import standard_attention

    g = torch.Generator(device=dev).manual_seed(17)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, std=1.5, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def wrap(guard):
        return (lambda t: guarded(torch, t)) if guard else (lambda t: t)

    def fwd(h, dh, n, mode, layout, ff=f, guard=False):
        d, w = h * dh, wrap(guard)
        what = f"{mode} {layout}{' guard band' if guard else ''}"
        if layout == "split":
            qp, qc = w(rn(bs, ff, n, 3 * d)), w(rn(bs, 1, 3 * d))
            return ("shapes", f"{what} ({bs},{ff},{n},{3 * d}) {h}x{dh}",
                    lambda: tda.divided_attention(qp, qc, h, mode),
                    lambda dt: tda.divided_attention(qp.to(dt), qc.to(dt), h, mode,
                                                     impl="plain"), None, None)
        qkv = w(rn(bs, 1 + ff * n, 3 * d))
        return ("shapes", f"{what} ({bs},{1 + ff * n},{3 * d}) {h}x{dh}",
                lambda: dab.divided_attention_packed(qkv, h, ff, mode),
                lambda dt: dab.divided_attention_packed(qkv.to(dt), h, ff, mode, impl="plain"),
                None, None)

    def bwd(h, dh, n, mode, layout, ff=f, guard=False):
        d, w = h * dh, wrap(guard)
        what = f"{mode}{' guard band' if guard else ''}"
        if layout == "split":
            args = (w(rn(bs, ff, n, 3 * d)), w(rn(bs, 1, 3 * d)), w(rn(bs, ff, n, d, std=1.0)),
                    w(rn(bs, 1, d, std=1.0)))
            return ("shapes", f"K6 {what} ({bs},{ff},{n},{3 * d}) {h}x{dh}",
                    lambda: dab.divided_attention_bwd(*args, h, mode),
                    lambda dt: dab.divided_attention_bwd_plain(*(t.to(dt) for t in args), h,
                                                               mode), None, None)
        args = (w(rn(bs, 1 + ff * n, 3 * d)), w(rn(bs, 1 + ff * n, d, std=1.0)))
        return ("shapes", f"K7c {what} ({bs},{1 + ff * n},{3 * d}) {h}x{dh}",
                lambda: dab.divided_attention_packed_bwd(*args, h, ff, mode),
                lambda dt: dab.divided_attention_packed_bwd_plain(*(t.to(dt) for t in args), h,
                                                                  ff, mode), None, None)

    def k3(h, n, guard=False):
        qkv = wrap(guard)(rn(4, n, 3 * D))
        return ("shapes", f"K3{' guard band' if guard else ''} (4,{n},{3 * D}) {h}x{D // h}",
                lambda: standard_attention(qkv, h),
                lambda dt: standard_attention(qkv.to(dt), h, impl="plain"), None, None)

    cases = []
    for dh, h in head_dims:
        layouts = ("packed", "split") if tda.heads_groupable(h, dh) else ("packed",)
        far = 16 * _build.space_bwd_plan(1, dh)["chunk_tiles"] + 1
        for layout in layouts:
            for mode in ("space", "time"):
                cases += [fwd(h, dh, n, mode, layout) for n in space_ns]
                cases.append(bwd(h, dh, space_ns[0], mode, layout))
            cases.append(bwd(h, dh, far, "space", layout))
        cases += [fwd(h, dh, space_ns[-1], "space", "packed", guard=True),
                  bwd(h, dh, space_ns[0], "time", "packed", guard=True)]
    cases += [k3(D // DH, n) for n in k3_lens]
    cases += [k3(D // dh, n) for dh, n in k3_dims]
    cases.append(k3(D // DH, k3_lens[0], guard=True))
    for h, dh in time_widths:
        layout = "split" if tda.heads_groupable(h, dh) else "packed"
        cases += [fwd(h, dh, time_n, "time", layout, ff) for ff in frames[0]]
        cases += [bwd(h, dh, time_n, "time", layout, ff) for ff in frames[1]]
    def cast(args, dt):
        return [a.to(dt) if torch.is_tensor(a) and a.dtype == bf else a for a in args]

    rows, d8, out8 = k8c
    args = [rn(rows, d8), 1.0 + rn(d8, std=0.1, dtype=f32), rn(d8, std=0.1, dtype=f32),
            rn(out8, d8, std=d8 ** -0.5), rn(out8, std=0.1, dtype=f32), 1e-6]
    cases.append(("shapes", f"K8c ({rows},{d8}) -> {out8}",
                  lambda a=args: fused_ln_matmul(*a),
                  lambda dt, a=args: fused_ln_matmul(*cast(a, dt), impl="plain"), None, None))
    for groups, m, hid in k4:
        args = [rn(groups, m, D), rn(D, std=0.02, dtype=f32), 1.0 + rn(D, std=0.1, dtype=f32),
                rn(D, std=0.1, dtype=f32), rn(3 * D, D, std=0.02),
                rn(3 * D, std=0.02, dtype=f32), rn(D, D, std=0.02), rn(D, std=0.02, dtype=f32),
                1.0 + rn(D, std=0.1, dtype=f32), rn(D, std=0.1, dtype=f32),
                rn(hid, D, std=0.02), rn(hid, std=0.02, dtype=f32), rn(D, hid, std=0.02),
                rn(D, std=0.02, dtype=f32)]
        cases.append(("shapes", f"K4 ({groups},{m},{D}) hidden {hid}",
                      lambda a=args: fused_cls_pool_tokens(*a, num_heads=H, eps=1e-6),
                      lambda dt, a=args: fused_cls_pool_tokens(*cast(a, dt), num_heads=H,
                                                               eps=1e-6, impl="plain"),
                      None, None))
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
    # phase 18's widths at the video tower's rows at B = 2: K2 at hidden 1996
    # (mlp_ratio 2.6; fc2's A and W at a pitch of 2000) and at D 1280
    ("K2 fc1 hidden 1996", B1 * S * F_T * N_P, 1996, D, "gelu"),
    ("K2 fc2 hidden 1996", B1 * S * F_T * N_P, D, 1996, "residual", 2000),
    ("K2 fc1 D 1280", B1 * S * F_T * N_P, 5120, 1280, "gelu"),
    ("K2 fc2 D 1280", B1 * S * F_T * N_P, 1280, 5120, "residual"),
)
GEMM_RAGGED = ((1, D, D, "residual"), (127, 4 * D, D, "gelu"), (129, D, 4 * D, "residual"),
               (8288, 4 * D, D, "gelu"), (300, 384, 128, "bias"), (300, 192, 128, "residual"),
               (127, 576, 192, "gelu_poly"), (1, 192, D, "bias"), (127, 576, D, "gelu_poly"),
               (129, 4 * D, D, "gelu_poly"), (300, 3 * D, 96, "bias"),
               (300, 192, 32, "residual"),
               # N and K of 1996, 1000 and 520 on every epilogue (the tail
               # epilogue, K past the last full k-step); (rows, N, K,
               # epilogue, pitch): A and W as the first K columns of rows at a
               # 16-byte pitch, the way K2 holds a hidden width of 1996
               (129, 1996, D, "gelu"), (8288, 1996, D, "gelu"), (129, 1996, 1000, "gelu_poly"),
               (300, 1000, 520, "bias"), (127, 520, 1000, "residual"),
               (129, 1996, 1000, "residual"), (129, D, 1996, "residual", 2000),
               (300, 1996, 1996, "bias", 2000), (1, 520, 1996, "gelu", 2000),
               (127, 1000, 1996, "gelu_poly", 2000))
# the guard-band cases (rows, N, K, epilogue[, pitch]): A, W and the residual
# each at the start of a NaN-filled buffer; at K = 96 the last k-step reaches
# past K; with a pitch, the pad columns past K are NaN too
GEMM_GUARD = ((129, D, 4 * D, "residual"), (129, 576, 96, "residual"),
              (129, D, 96, "gelu_poly"), (129, 1996, 1000, "residual"),
              (129, D, 1996, "residual", 2000), (127, 1000, 1996, "gelu_poly", 2000))


def gemm_cases(torch, dev, shapes=GEMM_SHAPES, ragged=GEMM_RAGGED, guard=GEMM_GUARD) -> list:
    """(label, kernel fn, plain fn on given dtype, (bytes, FLOPs), library fn)
    of the Hopper GEMM alone (ops/kernels/gemm.py) at ``shapes`` (timed), at
    ``ragged`` rows (library None: checked and logged only) and at
    ``guard``'s, with each input at the start of a NaN-filled buffer
    (guarded). The library fn is one F.linear call with the bias (cuBLAS: a
    yardstick, never called by the port)."""
    import torch.nn.functional as F

    from synchformer_tpu_torch.ops.kernels import gemm as kgemm

    g = torch.Generator(device=dev).manual_seed(8)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def pitched(rows, k, pitch, std, guard):
        """rows x k values as the first k columns of rows at ``pitch`` (NaN
        past k in a guard band)."""
        buf = rn(rows, pitch, std=std)
        if guard:
            buf[:, k:] = float("nan")
        return buf[:, :k]

    def case(label, m, n, k, epi, timed, guard=False, pitch=None):
        """One case; ``guard``: each input at the start of a NaN-filled
        buffer; ``pitch``: A and W as row views of (rows, pitch) buffers."""
        wrap = (lambda t: guarded(torch, t)) if guard else (lambda t: t)
        if pitch is None:
            a, w = wrap(rn(m, k)), wrap(rn(n, k, std=k ** -0.5))
        else:
            a, w = pitched(m, k, pitch, 1.0, guard), pitched(n, k, pitch, k ** -0.5, guard)
        bias = rn(n, std=0.1, dtype=f32)
        r = wrap(rn(m, n)) if epi == "residual" else None
        up = (lambda t, dt: None if t is None else t.to(dt))
        nbytes = (m * k + n * k + m * n * (2 if r is not None else 1)) * 2 + n * 4
        lib_bias = bias.to(bf)
        # the entry looked up at call time, so that scripts/stage1_planted_faults.py
        # can wrap it
        return (f"GEMM {label} ({m},{k}) -> {n} {epi}",
                lambda: kgemm.gemm(a, w, bias, epi, r),
                lambda dt: kgemm.gemm(a.to(dt), w.to(dt), bias, epi, up(r, dt), impl="plain"),
                (nbytes, 2.0 * m * n * k),
                (lambda: F.linear(a, w, lib_bias)) if timed else None)

    def pitch_of(shape, at):
        return shape[at] if len(shape) > at else None

    cases = [case(*shape[:5], timed=True, pitch=pitch_of(shape, 5)) for shape in shapes]
    cases += [case(f"ragged {r[0]} rows{f' pitch {r[4]}' if len(r) > 4 else ''}", *r[:4], False,
                   pitch=pitch_of(r, 4)) for r in ragged]
    cases += [case(f"guard band{f' pitch {r[4]}' if len(r) > 4 else ''}", *r[:4], False,
                   guard=True, pitch=pitch_of(r, 4)) for r in guard]
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


def check_ragged(torch, dev, cases=None, tag: str = "ragged") -> None:
    """``cases`` (default ragged_cases and k4_cases), each held by
    hold_outputs' rule; fails on any miss."""
    if cases is None:
        cases = ragged_cases(torch, dev) + k4_cases(torch, dev)
    for _, label, kern, plain, _, _ in cases:
        k_out, p_out, a_out = kern(), plain(torch.bfloat16), plain(torch.float32)
        torch.cuda.synchronize()
        failed = hold_outputs(label, k_out, p_out, a_out, tag)[0]
        if failed:
            fail(f"{label} outputs {failed} outside tolerance")
        del k_out, p_out, a_out


def check_shapes(torch, dev) -> None:
    """shape_cases (the head_dims, K3 lengths, frame counts and K8c width
    past the main path's), each held by hold_outputs' rule, logged as
    [shapes]; fails on any miss."""
    t0 = time.perf_counter()
    check_ragged(torch, dev, shape_cases(torch, dev), "shapes")
    log(f"[shapes] {time.perf_counter() - t0:.1f} s")


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
    check_shapes(torch, dev)
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


def counted_record(torch, tag: str, what: str, want: dict, record, at_least: bool = False):
    """``record()`` with the launch counters zeroed before it; fails unless
    each count in ``want`` is met exactly (``at_least``: reached). Returns
    the record and the counts."""
    from synchformer_tpu_torch.ops.kernels import _build

    torch.cuda.synchronize()
    _build.launches.clear()
    rec = record()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    log(f"[{tag}] launches in {what}: {counts}")
    for key, need in want.items():
        got = counts.get(key, 0)
        if got < need or (got > need and not at_least):
            fail(f"{tag}: {key} launched {got} times in {what}, expected "
                 f"{'>= ' if at_least else ''}{need}")
    return rec, counts


def timed_forwards(torch, tag: str, preds: dict, args: tuple, kwargs: dict | None = None,
                   order: tuple = ("plain", "kernel", "kernel", "plain")):
    """ms/batch of each predictor named in ``order`` (the best of its windows
    of three forwards, each window after one warm-up forward, in the turns
    of ``order``) and the peak memory of one forward above what was
    allocated before it."""
    kwargs = kwargs or {}
    peak, times = {}, {name: [] for name in order}
    for name in times:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        preds[name](*args, **kwargs)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base
    for name in order:
        preds[name](*args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            preds[name](*args, **kwargs)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / 3)
    b = args[0].shape[0]
    for name, ts in times.items():
        best = min(ts)
        log(f"[timing] {tag} {name} path: {best * 1e3:.1f} ms/batch of {b} clips = "
            f"{b / best:.2f} clips/s (runs {[round(t * 1e3, 1) for t in ts]} ms); peak "
            f"{gib(peak[name])} above the weights; {smi_line()}")


def run_slice(torch, dev, report):
    from synchformer_tpu_torch.infer import SyncPredictor
    from synchformer_tpu_torch.models.presets import build_synchformer
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

    kern, counts = counted_record(torch, "slice", "one kernel-path forward", MIN_LAUNCHES,
                                  lambda: serving_record(torch, pk, video, pcm), at_least=True)
    for key in MIN_LAUNCHES:
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

    timed_forwards(torch, "slice", {"kernel": pk, "plain": pp}, (video, pcm))


def serving_record(torch, pred, video, pcm, audio: bool = False,
                   masks: dict | None = None) -> dict:
    """One SyncPredictor forward: its logits, probabilities and the video
    tower's output features (read by a forward hook), with ``audio`` also
    the audio tower's, in f32; ``masks`` (vis_mask / aud_mask) to the
    predictor."""
    feats = {}
    towers = {"vfeat": pred.model.vfeat_extractor}
    if audio:
        towers["afeat"] = pred.model.afeat_extractor
    hooks = [tower.register_forward_hook(
        lambda mod, args, out, name=name: feats.update({name: out.float()}))
        for name, tower in towers.items()]
    try:
        logits = pred.logits(video, pcm, **(masks or {})).float()
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
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict

    tag = "serving_8head"
    sd = seeded_state_dict(build_synchformer_8head(S, device="meta"), seed=0)
    video, pcm = slice_inputs(torch, dev)

    def predictor(dtype, impl, attn_impl="pallas_fused"):
        m = build_synchformer_8head(S, attn_impl, device=dev)
        load_numpy_state_dict(m, sd)
        return SyncPredictor(m, dev, dtype, impl)

    def counted(pred, want, what):
        return counted_record(torch, tag, f"one {what} forward", want,
                              lambda: serving_record(torch, pred, video, pcm))

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

    timed_forwards(torch, tag, preds, (video, pcm),
                   order=("plain", "fused", "pallas", "pallas", "fused", "plain"))


def stage1_batch(torch, b: int, s: int, frames=FRAMES, samples: int = 10240) -> dict:
    """One seeded loader batch: uint8 frames (b, s, *frames), PCM (b, s,
    samples)."""
    import numpy as np

    rng = np.random.default_rng(2)
    return {"video": torch.from_numpy(rng.integers(0, 256, (b, s, *frames), dtype=np.uint8)),
            "audio": torch.from_numpy((rng.standard_normal((b, s, samples)) * 0.1)
                                      .astype(np.float32))}


def stage1_trainer(build, state_dict, dev, precision: str, impl: str, remat: bool = False,
                   moco: bool = False, p_flip: float = 0.5, mel_t: int | None = None,
                   window: int = 8, model_parallel: int = 1):
    """An AVCLIPTrainer on ``build(remat=..., device=dev)`` loaded with
    ``state_dict``: Stage I's optimiser settings, generator seed 0, flip p
    ``p_flip``, zero-shot window ``window``; with ``moco``, cfg.model.target
    names MultilevelMoCoCLIP and alpha is MOCO_ALPHA; ``mel_t``, the audio
    tower's max_spec_t (the log-mel's length; default 66);
    training.model_parallel ``model_parallel``."""
    from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict

    model = build(remat=remat, device=dev)
    load_numpy_state_dict(model, state_dict)
    cfg = {"training": {"seed": 0, "precision": precision, "learning_rate": 1e-4,
                        "weight_decay": 0.2, "warmup": 1000, "total_steps": 100_000,
                        "max_clip_norm": MAX_CLIP, "zero_shot_window": window,
                        "alpha": MOCO_ALPHA, "model_parallel": model_parallel},
           "data": {"p_horizontal_flip": p_flip, "p_audio_aug": 0.0}}
    if moco:
        cfg["model"] = {"target": MOCO_TARGET}
    if mel_t is not None:
        cfg["model"] = {"params": {"afeat_extractor": {"params": {"max_spec_t": mel_t}}}}
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
    in_proj weights split the same way). Under tensor parallelism the
    gradients are whole (gathered over the model group: every rank of it
    calls this)."""
    from synchformer_tpu_torch.parallel.tensor import whole_tensors

    unclip = max(m["grad_norm"] / MAX_CLIP, 1.0)
    grads = whole_tensors(tr.model, {n: p.grad for n, p in tr.model.named_parameters()})
    leaves = {}
    for name, grad in grads.items():
        if leaves_re.fullmatch(name):
            g = grad.float() * unclip
            if name.endswith(("qkv.weight", "in_proj_weight")):
                leaves.update({f"{name}[{part}]": rows for part, rows in zip("qkv", g.chunk(3))})
            else:
                leaves[name] = g
    return {"metrics": m,
            "flat": torch.cat([g.float().flatten() for g in grads.values()]),
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
               fused=None, s: int = S, frames=FRAMES, samples: int = 10240,
               mel_t: int | None = None, solo: bool = False, plain_remat: bool = False):
    """The Stage I step of ``build`` (default build_avclip) through
    AVCLIPTrainer: (c) f32 plain with remat, (a) bf16 kernel, (b) bf16 plain;
    exact launch counts of (a)'s first step (reported for the kernels whose
    PATHS entry is ``path``) and of an eval step, agreement, then timing
    windows of 3 steps (plain, kernel, kernel, plain) and the peak memory of
    each bf16 path's first step. ``fused``: (build, launches, eval launches)
    of the same model on attn_impl='pallas_fused', whose bf16 kernel step (d)
    is held against (c) and (b) (its plain route is the same composition),
    counted, and timed in the same turns. ``s`` segments of ``frames`` raw
    frames and ``samples`` PCM samples a segment, the log-mel ``mel_t`` long
    (default: the 0.64 s segments' 66). ``solo``: one bf16 trainer resident
    at a time (for models whose two trainers do not fit the card together):
    the kernel path's first step, windows and eval step, then the plain
    path's, the windows in turns within each path only. ``plain_remat``:
    the bf16 plain path with remat (the same math in less memory; plain
    launches nothing)."""
    from synchformer_tpu_torch.models.presets import build_avclip
    from synchformer_tpu_torch.utils.convert import seeded_state_dict

    build = build or build_avclip
    t0 = time.perf_counter()
    sd = seeded_state_dict(build(device="meta"), seed=0)
    batch = stage1_batch(torch, B1, s, frames, samples)
    log(f"[{tag}] weights + batch {time.perf_counter() - t0:.1f} s; video "
        f"{tuple(batch['video'].shape)} uint8, audio {tuple(batch['audio'].shape)}")

    def trainer(precision, impl, remat=False, make=build):
        return stage1_trainer(make, sd, dev, precision, impl, remat, mel_t=mel_t,
                              window=min(8, s))

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
    (kern, k_peak), counts = counted_record(
        torch, tag, "one kernel-path step", launches,
        lambda: first_step(trainers["kernel"], "(a) bf16 kernel", resident))
    for key in KEYS:
        if PATHS[key] == path:
            report[key]["launches"] = counts[key]
    times = {}

    def windows(names):
        """3 steps per window, of each path named, in turn."""
        for name in names:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(3):
                checked_step(trainers[name], batch, name)
            torch.cuda.synchronize()
            times.setdefault(name, []).append((time.perf_counter() - t) / 3)

    def eval_step(name, want):
        out, _ = counted_record(torch, tag, f"one {name} eval step", want,
                                lambda: trainers[name].eval_step(batch))
        if (out["vfeat"].shape != (B1, s, D) or not bool(torch.isfinite(out["loss"]))
                or not bool(torch.isfinite(out["vfeat"]).all())):
            fail(f"{tag} {name} eval step: features of the wrong shape or non-finite")
        log(f"[{tag}] {name} eval step: loss {out['loss'].item():.6f}, zero-shot precision "
            f"{out['precision'].item():.4f} (window {min(8, s)} of {s} segments)")

    if solo:
        windows(("kernel", "kernel"))
        eval_step("kernel", eval_launches)
        del trainers["kernel"]
        gc.collect()
        torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    trainers["plain"] = trainer("amp", "plain", remat=plain_remat)
    plain, p_peak = first_step(trainers["plain"],
                               "(b) bf16 plain" + (", remat" if plain_remat else ""), resident)
    peaks = {"kernel": k_peak, "plain": p_peak}
    order = ("plain", "plain") if solo else ("plain", "kernel", "kernel", "plain")
    if fused is not None:
        resident = torch.cuda.memory_allocated()
        trainers["fused"] = trainer("amp", "kernel", make=fused[0])
        (kern_f, peaks["fused"]), _ = counted_record(
            torch, tag, "one pallas_fused kernel-path step", fused[1],
            lambda: first_step(trainers["fused"], "(d) bf16 kernel, attn_impl='pallas_fused'",
                               resident))
        order = ("plain", "kernel", "fused", "fused", "kernel", "plain")
    log(f"[{tag}] bf16 first steps {time.perf_counter() - t0:.1f} s")

    # windows in the order plain, kernel, kernel, plain (with the fused
    # route's windows in the middle)
    windows(order)
    if not solo:
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
        log(f"[timing] {tag} {what} path: {best:.1f} ms/step of {B1} clips x {s} segments "
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
    setup = packed_block(torch, dev)
    kern, counts = counted_record(torch, "packed_block", "one forward + backward",
                                  PACKED_BLOCK_LAUNCHES,
                                  lambda: packed_block_grads(torch, setup, torch.bfloat16,
                                                             "kernel"))
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
    from synchformer_tpu_torch.parallel.tensor import whole_tensors

    rec = step_gradients(torch, tr, m, MOCO_LEAVES)
    q = tr.queues
    ema = whole_tensors(tr.model_m, dict(tr.model_m.named_parameters()))
    rec["ema"] = torch.cat([p.float().flatten() for p in ema.values()])
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
    (kern, k_peak), counts = counted_record(
        torch, tag, "one kernel-path step", MOCO_LAUNCHES,
        lambda: moco_first_step(torch, trainers["kernel"], batch, "(a) bf16 kernel", tag,
                                resident))
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

    out, _ = counted_record(torch, tag, "one kernel eval step", MOCO_EVAL_LAUNCHES,
                            lambda: trainers["kernel"].eval_step(batch))
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
    the step's peak memory above ``resident`` bytes (0 off the card). Under
    tensor parallelism the parameters and gradients are whole (gathered
    over the model group: every rank of it calls this). A model with
    BatchNorms (the legacy towers) also gives the update the step made to
    their running statistics (``bn``: bn_update)."""
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.parallel.tensor import whole_tensors

    cuda = tr.device.type == "cuda"
    _build.launches.clear()
    ev = tr.eval_step(batch)
    rec = {"eval": {k: ev[k].float() for k in ("logits", "loss_vec")}}
    params = {n: p for n, p in tr.model.named_parameters() if p.requires_grad}
    before = torch.cat([p.double().flatten() for p in whole_tensors(tr.model, params).values()])
    stats_before = bn_buffers(torch, tr.model)
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
    grads = whole_tensors(tr.model, {n: p.grad for n, p in params.items()})
    rec["leaves"] = {n: g.float() * unclip for n, g in grads.items()}
    rec["flat"] = torch.cat([g.flatten() for g in rec["leaves"].values()])
    rec["update"] = torch.cat([p.double().flatten() for p in
                               whole_tensors(tr.model, params).values()]) - before
    if stats_before:
        rec["bn"] = bn_update(stats_before, bn_buffers(torch, tr.model))
    return rec, peak


def bn_buffers(torch, model) -> dict:
    """Each BatchNorm's running mean and var (models/conv.py), f64 copies,
    by buffer name; empty for a model without BatchNorms."""
    from synchformer_tpu_torch.models.conv import BatchNorm

    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            out[f"{name}.running_mean"] = mod.running_mean.detach().double().clone()
            out[f"{name}.running_var"] = mod.running_var.detach().double().clone()
    return out


def bn_update(before: dict, after: dict) -> dict:
    """after - before of bn_buffers, for the running means ("mean") and vars
    ("var") each flattened in module order, and by buffer name ("each")."""
    each = {k: after[k] - v for k, v in before.items()}
    import torch

    return {"mean": torch.cat([v for k, v in each.items() if k.endswith("mean")]),
            "var": torch.cat([v for k, v in each.items() if k.endswith("var")]),
            "each": each}


def bn_agreement(ref: dict, plain: dict, kern: dict, tag: str,
                 margins: dict | None = None) -> list:
    """The BatchNorms' running-statistics updates of a step (sync_record's
    or legacy_stage1_record's ``bn``): the kernel record's against the f32
    one by relative L2 error, the means and the vars apart, each within 2 x
    the plain bf16 record's error; the worst single BatchNorm's ratio is
    logged. Returns the names of the checks that failed; fills ``margins``."""
    failed = []

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-300))

    for key in ("mean", "var"):
        want = ref["bn"][key]
        err_k, err_p = rel(kern["bn"][key], want), rel(plain["bn"][key], want)
        ok = err_k <= 2.0 * err_p
        if not ok:
            failed.append(f"bn {key}")
        if margins is not None:
            margins[f"bn {key}"] = err_k / max(2.0 * err_p, 1e-30)
        worst = max((rel(kern["bn"]["each"][n], w) / max(rel(plain["bn"]["each"][n], w), 1e-30),
                     n) for n, w in ref["bn"]["each"].items() if n.endswith(key))
        log(f"[{tag}] BatchNorm running {key} updates: relative L2 |kernel-f32| {err_k:.3e} "
            f"|plain_bf16-f32| {err_p:.3e} tol {2.0 * err_p:.3e} {'ok' if ok else 'FAIL'}; "
            f"worst single ratio {worst[0]:.3f} ({worst[1]})")
    return failed


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
    yardstick; the vectors carry the check. Records with ``bn`` (the legacy
    towers, phase 20 at B=2) are also held by bn_agreement, and their loss
    eps is P20_LOSS_EPS: the mean of 2 cross-entropies over a train-mode
    S3D's bf16 features read 5.6e-4 (plain) and 3.0e-3 (kernel) of the loss
    off f32 in the first call (eval logits 8.1e-3 and 9.8e-3 relative L2,
    every leaf within 1.04 x plain's)."""
    loss_eps = P20_LOSS_EPS if "bn" in ref else 1e-3
    failed = stage1_agreement(ref, plain, kern, tag, (("loss", loss_eps), ("grad_norm", 5e-3)))
    if all("bn" in r for r in (ref, plain, kern)):
        failed += bn_agreement(ref, plain, kern, tag, margins)

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
# the world-1 reference records of run_gloo_group's cases, by case and n_data:
# phase 14 (c) writes them and phase 19 reads the Stage II and AVCLIP ones
# (the same batch, weights, generator seed and rate at n_data 2); cleared by
# main at its start and end
REFS_DIR = os.path.join(REPO, "build", "chip_smoke", "refs")
DP_CASES = ("avclip", "moco", "stage2")
# the cases of run_gloo_group that run a SyncTrainer (sync_record, sync_agreement)
SYNC_CASES = ("stage2", "legacy")
# one AVCLIP step with its randomness off (randomness_off): drop-path 0 in
# every video block, so that each block's LN + MLP half takes K2, as the
# eval path's does (phase 4's step keeps K2 to block 0, the only one at
# drop-path 0)
DP_STAGE1_LAUNCHES = {**STAGE1_LAUNCHES, "K2": 24}
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
            m, _ = counted_record(torch, f"dp_world1 {what}", "one step", STAGE1_LAUNCHES,
                                  lambda: checked_step(tr, kept["batch"], f"dp_world1 {what}"))
            log(f"[dp_world1] {what}: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}")
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
                  weights: dict | None = None, model_parallel: int = 1):
    """(make, global batch, meta) of one (c) case, phase-19 case or phase-20
    (c) case ('legacy': legacy_train_config, B=P20_B; a rank's rows are a
    slice of the batch): ``make(precision_or_half, impl, remat)``
    builds the trainer with its randomness off, at training.model_parallel
    ``model_parallel``; ``meta()`` builds the case's model on the meta
    device. ``tiny``: the planted faults' dry run's widths; ``weights``: a
    cache of the Stage I cases' seeded state dicts."""
    import torch

    from synchformer_tpu_torch.models import presets
    from synchformer_tpu_torch.registry import instantiate_from_config
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
                                p_flip=0.0, model_parallel=model_parallel)
            randomness_off(tr.model)
            if case == "moco":
                randomness_off(tr.model_m)
            return tr

        return make, batch, lambda: build(device="meta")
    if case == "legacy":
        cfg = legacy_train_config(t.get("s", S), True, t.get("legacy_widths"))
        b, frames = P20_B, t.get("legacy_frames", FRAMES)
    else:
        cfg = sync_config("train_avsync_model", t.get("s", S), None, widths=t.get("widths"))
        b, frames = B2, t.get("frames", FRAMES)
    cfg["model"]["params"]["transformer"]["params"].update(embd_pdrop=0.0, resid_pdrop=0.0,
                                                           attn_pdrop=0.0)
    cfg["data"]["p_horizontal_flip"] = 0.0
    cfg["training"]["base_learning_rate"] *= base_lr_scale
    cfg["training"]["model_parallel"] = model_parallel
    batch = sync_batch(torch, dev, b, t.get("s", S), frames)

    def make(half, impl, remat=False):
        return sync_trainer(cfg, dev, impl, half)

    return make, batch, lambda: instantiate_from_config(cfg["model"], device="meta")


def dp_record(torch, case: str, tr, batch, what: str, tag: str = "dp_world2"):
    """The first step's record of one (c) case: step_gradients' (avclip),
    moco_record's (moco) or sync_record's (stage2)."""
    if case == "avclip":
        return step_gradients(torch, tr, checked_step(tr, batch, what)), None
    if case == "moco":
        rec, _ = moco_first_step(torch, tr, batch, what, tag)
        return rec, None
    rec, _ = sync_record(torch, tr, batch, what, tag)
    return rec, rec["launches"]


def tensor_digest(torch, t) -> str:
    """sha256 of a tensor's bytes, whatever its dtype and device."""
    import hashlib

    flat = t.detach().reshape(-1).contiguous().view(torch.uint8)
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def tp_checks(torch, tr, meta_model, model_parallel: int, ckpt: str | None = None) -> list:
    """Phase 19's layout checks of one case on every rank, after its steps
    (every rank calls it; the failures are rank 0's to report):
    - the sharded parameters are exactly sharded_entries' on ``meta_model``
      (the case's model on the meta device, at its whole shapes);
    - each sharded parameter bitwise equal on the ranks of its model index
      (its data peers), each replicated one on every rank;
    - the generator streams equal on the model peers (they draw alike);
    - the bytes of the parameters and the optimizer's moments within 1% of
      the figure reckoned from ``meta_model``'s shapes: replicated + sharded /
      model_parallel, in each parameter's dtype, the moments two of each
      trainable parameter's;
    - with ``ckpt``, rank 0 writes there the trainer's checkpoint state
      (trainable parameters and optimizer state, whole) for
      tp_checkpoint_check."""
    from synchformer_tpu_torch.parallel import dist as pdist
    from synchformer_tpu_torch.parallel import tensor as ptensor

    m, rank = model_parallel, pdist.rank()
    local = dict(tr.model.named_parameters())
    whole = dict(meta_model.named_parameters())
    rule = {f"{p}.{n}" if p else n for p, _, n in ptensor.sharded_entries(meta_model, m)}
    reckoned = sum(whole[n].numel() * p.element_size() // (m if n in rule else 1)
                   * (3 if p.requires_grad else 1) for n, p in local.items())
    held = sum(p.numel() * p.element_size() for p in local.values()) + sum(
        v.numel() * v.element_size() for p in local.values()
        for k, v in tr.optimizer.state.get(p, {}).items()
        if k != "step" and torch.is_tensor(v) and v.shape == p.shape)
    sharded = ptensor.sharded_names(tr.model)
    log(f"[tp] rank {rank}: {len(sharded)} sharded parameters; parameters + moments "
        f"{gib(held)} held, {gib(reckoned)} reckoned (replicated + sharded / {m})")
    info = {"rule": sharded == rule, "n_sharded": len(sharded), "held": held,
            "reckoned": reckoned, "gens": [tensor_digest(torch, g.get_state()) for g in
                                           (tr.generator, tr.aug_generator)],
            "digests": {n: tensor_digest(torch, p) for n, p in local.items()}}
    if ckpt is not None:
        payload = {"trainable": tr.trainable_state_dict(), "step": tr.step,
                   "opt_state": ptensor.optimizer_state_dict(tr.optimizer, tr.model)}
        if rank == 0:
            torch.save(payload, ckpt)
        del payload
    gathered = pdist.all_gather_object(info)
    failed = []
    for r, g in enumerate(gathered):
        if not g["rule"]:
            failed.append(f"rank {r}: sharded parameters are not sharded_entries'")
        peer = {n: r % m if n in sharded else 0 for n in g["digests"]}
        bad = [n for n, d in g["digests"].items() if d != gathered[peer[n]]["digests"][n]]
        if bad:
            failed.append(f"rank {r}: {len(bad)} parameters differ from their peers' ({bad[:3]})")
        if g["gens"] != gathered[r - r % m]["gens"]:
            failed.append(f"rank {r}: generator streams differ from its model peers'")
        if abs(g["held"] - g["reckoned"]) > 0.01 * g["reckoned"]:
            failed.append(f"rank {r}: holds {g['held']} bytes, reckoned {g['reckoned']}")
    return failed


def tp_checkpoint_check(torch, tr, path: str) -> list:
    """Phase 19's checkpoint (tp_checks' ``ckpt``: the Stage II trainer's
    trainable parameters and optimizer state under tensor parallelism)
    read by ``tr``, a new world-1 trainer: the names and shapes are those
    of its own state, and it loads them bit for bit. Returns the
    failures."""
    from synchformer_tpu_torch.parallel import tensor as ptensor

    payload = torch.load(path, map_location="cpu", weights_only=True)
    own = tr.trainable_state_dict()
    if {k: tuple(v.shape) for k, v in payload["trainable"].items()} != {
            k: tuple(v.shape) for k, v in own.items()}:
        return ["checkpoint: names or shapes differ from a model_parallel 1 trainer's"]
    tr.load_trainable(payload["trainable"])
    ptensor.load_optimizer_state_dict(tr.optimizer, tr.model, payload["opt_state"])
    failed = []
    got = tr.trainable_state_dict()
    if not all(torch.equal(got[k].cpu(), v) for k, v in payload["trainable"].items()):
        failed.append("checkpoint: parameters not restored bit for bit")
    state = tr.optimizer.state_dict()["state"]
    if state.keys() != payload["opt_state"]["state"].keys() or not all(
            torch.equal(torch.as_tensor(state[i][k]).cpu(), torch.as_tensor(v))
            for i, st in payload["opt_state"]["state"].items() for k, v in st.items()):
        failed.append("checkpoint: optimizer state not restored bit for bit")
    log(f"[tp] checkpoint at model_parallel 2 read at world 1: {len(own)} tensors, "
        f"{'ok' if not failed else failed}")
    return failed


def dp_worker(spec_path: str) -> int:
    """One rank of phase 14 (c) or phase 19, started by run_gloo_group: joins
    the gloo group from torchrun's variables (every rank on cuda:0), on the
    grid of spec['model_parallel'] (1: data parallelism alone); takes each
    case's first step on its data rank's rows of the global batch under
    DDP, then 2 timed steps, and checks the MoCo queues' bytes equal on
    every rank; on a grid with a model axis (phase 19) also each rank's
    record's digest and tp_checks; then leaves the group, and rank 0 takes
    the world-1 steps over the whole batch, f32 plain (remat for Stage I)
    and the bf16 kernel path (or reads their records from REFS_DIR, where a
    group at the same n_data wrote them), and holds the group's record
    against the f32 one with the case's agreement, the world-1 kernel step's error as the
    yardstick (the plain bf16 one's slot): the group may differ from world
    1 only by the order of f32 sums and by the row count each GEMM sees.
    (With randomness off the Stage I gradient is small, a norm of about
    0.1, and the kernel path there reads up to 2 x plain bf16's error, a
    margin phases 4 and 9 hold with their randomness on.) On a grid, a new
    world-1 kernel trainer then reads the Stage II checkpoint
    (tp_checkpoint_check). Writes its result to spec['out'] + rank."""
    import torch

    sys.path.insert(0, REPO)
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.parallel import dist as pdist

    spec = json.load(open(spec_path))
    dev = pdist.init_from_env(spec["device"], backend="gloo")
    rank, world = pdist.rank(), pdist.world()
    m, tag = int(spec.get("model_parallel", 1)), spec.get("tag", "dp_world2")
    n_data, data_rank = world // m, rank // m
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
    ckpt = os.path.join(os.path.dirname(spec["out"]), "tp_stage2.pt")
    for case in spec["cases"]:
        make, batch, meta = dp_case_setup(case, dev, tiny, weights=weights, model_parallel=m)
        n = batch["video"].shape[0] // n_data
        local = {k: v[data_rank * n:(data_rank + 1) * n] for k, v in batch.items()}
        tr = make("amp" if case not in SYNC_CASES else True, "kernel")
        _build.launches.clear()
        rec, launches = dp_record(torch, case, tr, local, f"world {world} rank {rank} {case}",
                                  tag)
        counts = dict(_build.launches) if launches is None else launches[1]
        res = {"launches": counts}
        if case in SYNC_CASES:
            # the eval step's outputs over the whole batch, in data order
            rec["eval"] = {k: torch.cat([x.to(v.device) for x in pdist.all_gather_object(
                v.cpu(), pdist.data_group())]) for k, v in rec["eval"].items()}
            res["eval_launches"] = launches[0]
        if case == "moco":
            # the query pass's global aggregator outputs over the whole batch
            for key in ("query global_v", "query global_a"):
                v = rec["written"][key]
                rec["written"][key] = torch.cat([x.to(v.device) for x in
                                                 pdist.all_gather_object(v.cpu(),
                                                                         pdist.data_group())])
            q = tr.queues
            digest = tensor_digest(torch, torch.cat([getattr(q, k).flatten() for k in
                                                     ("segment_v", "segment_a", "global_v",
                                                      "global_a")]))
            digests = pdist.all_gather_object((digest, q.segment_ptr, q.global_ptr))
            res["queues_equal"] = all(d == digests[0] for d in digests)
        if "bn" in rec:
            # the BatchNorms' running statistics after the step, on every rank
            buffers = bn_buffers(torch, tr.model)
            digests = pdist.all_gather_object(tensor_digest(torch, torch.cat(list(
                buffers.values()))))
            res["bn_equal"] = all(d == digests[0] for d in digests)
        if m > 1:
            # every rank's record: model peers gather the same whole tensors
            res["record"] = tensor_digest(torch, rec["flat"])
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
        if m > 1:
            res["tp_failed"] = tp_checks(torch, tr, meta(), m,
                                         ckpt if case == "stage2" else None)
            log(f"[{tag}] rank {rank} {case}: launches {counts}; {res['ms']:.1f} ms/step over "
                f"gloo")
        else:
            grads = [p.grad for p in tr.model.parameters() if p.grad is not None]
            flat = torch.cat([g.flatten() for g in grads])
            pdist.barrier()
            t = time.perf_counter()
            torch.distributed.all_reduce(flat)
            if cuda:
                torch.cuda.synchronize()
            res["allreduce_ms"] = (time.perf_counter() - t) * 1e3
            res["grad_bytes"] = flat.numel() * flat.element_size()
            log(f"[{tag}] rank {rank} {case}: launches {counts}; {res['ms']:.1f} ms/step over "
                f"gloo; one all-reduce of the gradients' {res['grad_bytes'] / 2 ** 20:.0f} MiB "
                f"{res['allreduce_ms']:.1f} ms")
            del flat, grads
        del tr
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        result["cases"][case] = res
    pdist.barrier()
    pdist.destroy()
    if rank == 0:
        for case in spec["cases"]:
            # the world-1 references: the JAX trainer's rate at n_data devices
            # is base_learning_rate x n_data (Stage II / III); a group of the
            # same n_data (phase 14 (c), phase 19) reads them from REFS_DIR
            make, batch, _ = dp_case_setup(case, dev, tiny, base_lr_scale=n_data,
                                           weights=weights)
            kept = os.path.join(REFS_DIR, f"{case}_n{n_data}{'_tiny' if tiny else ''}.pt")
            refs, failed = {}, []
            if os.path.exists(kept):
                refs = torch.load(kept, weights_only=True)
                log(f"[{tag}] world 1 {case}: the reference records of an earlier group")
            sync = case in SYNC_CASES
            for name, args in (("ref", ("fp32" if not sync else False, "plain", not sync)),
                               ("kernel", ("amp" if not sync else True, "kernel"))):
                if name in refs:
                    continue
                tr = make(*args)
                # the legacy convs' f32 anchor without TF32 (phase 20 (a)'s)
                with (tf32_off(torch) if case == "legacy" and name == "ref" and cuda
                      else contextlib.nullcontext()):
                    rec, _ = dp_record(torch, case, tr, batch, f"world 1 {case} {name}", tag)
                refs[name] = record_to_cpu(rec)
                del tr
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
            if not os.path.exists(kept):
                os.makedirs(REFS_DIR, exist_ok=True)
                torch.save(refs, kept)
            if m > 1 and case == "stage2":
                tr = make(True, "kernel")
                failed += tp_checkpoint_check(torch, tr, ckpt)
                del tr
                gc.collect()
            margins = {}
            agree = {"avclip": stage1_agreement, "moco": moco_agreement,
                     "stage2": sync_agreement, "legacy": sync_agreement}[case]
            failed += agree(refs["ref"], refs["kernel"], records[case], f"{tag} {case}",
                            margins=margins)
            result["cases"][case].update(failed=failed, margins=margins)
            del refs
            records[case] = None
    with open(f"{spec['out']}{rank}.json", "w") as f:
        json.dump(result, f)
    return 0


def run_gloo_group(torch, dev, report=None, cases=DP_CASES, tiny=None, hook=None,
                   fault=None, check: bool = True, world: int = 2, model_parallel: int = 1,
                   tag: str = "dp_world2", timed_steps: int = 2) -> dict:
    """``world`` processes of one gloo group on the one card (NCCL refuses
    two ranks on one device; gloo stages DDP's all-reduce and the
    all-gathers of CUDA tensors through the host), dp_worker each, with
    timeouts, on the (world / model_parallel x model_parallel) grid; each
    case held against world 1 over the same global batch. Phase 14 (c),
    world 2: the full-width AVCLIP step at B=2 (1 a rank), the MoCo step at
    B=2 (queues 1024 x 14 and 1024; bitwise equal on both ranks), the Stage
    II step at B=16 (8 a rank). Phase 19, world 4 at model_parallel 2: the
    Stage II step at B=16 (8 a data rank) and the AVCLIP step at B=2, each
    rank's record equal, tp_checks, the checkpoint read at world 1. Phase 20
    (c), world 2: the legacy Stage II step ('legacy') at B=2 (1 a rank), its
    BatchNorms' running statistics bitwise equal on every rank. Every rank's
    launches (not with ``tiny``): Stage II's K1 24, K2 24, K3 12, K4 2,
    AVCLIP's STAGE1_LAUNCHES, the legacy step's LEGACY_LAUNCHES.
    ``timed_steps`` steps a rank are timed after the first (1 with
    ``tiny``). ``hook`` ('path:function') is called with
    ``fault`` in each worker before the cases (the planted faults); ``tiny``
    the dry run's widths. Returns rank 0's result; with ``check``, fails on
    any failed case."""
    import shutil

    workdir = os.path.join(REPO, "build", "chip_smoke", tag)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    spec = {"device": torch.device(dev).type, "cases": list(cases), "tiny": tiny, "hook": hook,
            "fault": fault, "out": os.path.join(workdir, "result_rank"),
            "timed_steps": 1 if tiny else timed_steps, "model_parallel": model_parallel,
            "tag": tag}
    spec_path = os.path.join(workdir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
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
        fail(f"{tag}: the group did not finish within {DP_SPAWN_TIMEOUT_S} s")
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("[") or line.startswith("chip_smoke"):
                log(f"  r{rank} {line}" if not line.startswith(f"[{tag}]") else line)
        if p.returncode != 0:
            fail(f"{tag}: rank {rank} exited {p.returncode}: {err[-3000:]}")
    results = [json.load(open(spec["out"] + f"{r}.json")) for r in range(world)]
    result = results[0]
    log(f"[{tag}] {world} ranks (model_parallel {model_parallel}) over gloo on one card: "
        f"{time.perf_counter() - t0:.1f} s")
    failed = []
    want_launches = {"stage2": STAGE2_LAUNCHES, "avclip": DP_STAGE1_LAUNCHES,
                     "legacy": LEGACY_LAUNCHES}
    for case, res in result["cases"].items():
        margins = ", ".join(f"{k} {v:.3g}" for k, v in res.get("margins", {}).items())
        log(f"[{tag}] {case}: {res['ms']:.1f} ms/step at world {world} (gloo, model_parallel "
            f"{model_parallel}); checks failed {res.get('failed')}; margins (error / "
            f"tolerance) {margins}")
        failed += [f"{case} {name}" for name in res.get("failed", [])]
        failed += [f"{case} {name}" for name in res.get("tp_failed", [])]
        if case == "moco" and not res["queues_equal"]:
            failed.append("moco queues differ between the ranks")
        if not all(r["cases"][case].get("bn_equal", True) for r in results):
            failed.append(f"{case}: the ranks' BatchNorm running statistics differ")
        if model_parallel > 1 and len({r["cases"][case]["record"] for r in results}) != 1:
            failed.append(f"{case}: the ranks' first-step records differ")
        for what in ("launches", "eval_launches"):
            if tiny or case not in want_launches or what not in res:
                continue
            want = {k: want_launches[case].get(k, 0) for k in KEYS}
            for r in range(world):
                counts = results[r]["cases"][case][what]
                if {k: counts.get(k, 0) for k in KEYS} != want:
                    failed.append(f"{case} rank {r} {what} {counts}")
    result["failed"] = failed
    if check and failed:
        fail(f"{tag}: {failed}")
    shutil.rmtree(workdir, ignore_errors=True)
    return result


def run_data_parallel(torch, dev, report):
    """Phase 14: (a) run_dp_world1, (b) run_dp_launcher, (c) run_gloo_group at
    world 2."""
    for part in (run_dp_world1, run_dp_launcher, run_gloo_group):
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


def legacy_records(torch, preds, video, pcm) -> tuple:
    """serving_record with both towers' features from legacy_predictors'
    f32 path, with TF32 off in cuDNN's convs (a full-f32 anchor), and its
    bf16 plain path."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = serving_record(torch, preds["f32"], video, pcm, audio=True)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return ref, serving_record(torch, preds["plain"], video, pcm, audio=True)


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
    ref, plain = legacy_records(torch, preds, video, pcm)
    kern, _ = counted_record(torch, tag, "one kernel-path forward", LEGACY_LAUNCHES,
                             lambda: serving_record(torch, preds["kernel"], video, pcm,
                                                    audio=True))
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
    timed_forwards(torch, f"{tag} (a)", preds, (video, pcm))
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


# phase 17: the tower options, built through the registry from the shipped configs

def stage1_option_model(widths: dict | None = None) -> dict:
    """configs/segment_avclip.yaml's model section (the config read as the
    entry point reads it) with every rate live: the AST's hidden_dropout and
    attn_dropout and the Motionformer's drop_rate P17_RATE, and Linear
    aproj / vproj (n_embd -> n_embd). ``widths`` (n_embd, audio / video tower
    params) replaces the widths, for the planted faults' dry run."""
    from synchformer_tpu_torch.config.core import load_config

    model = load_config(os.path.join(ENTRY_CONFIGS, "segment_avclip.yaml")).to_dict()["model"]
    p, w = model["params"], widths or {}
    p["n_embd"] = d = w.get("n_embd", p["n_embd"])
    p["afeat_extractor"]["params"].update(hidden_dropout=P17_RATE, attn_dropout=P17_RATE,
                                          **w.get("audio", {}))
    p["vfeat_extractor"]["params"].update(drop_rate=P17_RATE, **w.get("video", {}))
    for name in ("aproj", "vproj"):
        p[name] = {"target": "torch.nn.Linear", "params": {"in_features": d, "out_features": d}}
    return model


def registry_build(node: dict):
    """A build(remat=..., device=...) of ``node`` through the port's registry
    (the towers' remat set where the node has towers), as the presets'."""
    import copy

    from synchformer_tpu_torch.registry import instantiate_from_config

    def build(remat: bool = False, device=None):
        cfg = copy.deepcopy(node)
        for tower in ("afeat_extractor", "vfeat_extractor"):
            if tower in cfg["params"]:
                cfg["params"][tower]["params"]["remat"] = remat
        return instantiate_from_config(cfg, device=device)

    return build


def option_predictors(torch, dev, model_node: dict) -> dict:
    """SyncPredictors of one seeded model built from ``model_node`` through
    the registry: 'f32' plain, 'plain' bf16, 'kernel' bf16."""
    from synchformer_tpu_torch.infer import SyncPredictor
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict

    build = registry_build(model_node)
    sd = seeded_state_dict(build(device="meta"), seed=0)
    preds = {}
    for name, dtype, impl in (("f32", torch.float32, "plain"), ("plain", torch.bfloat16, "plain"),
                              ("kernel", torch.bfloat16, "kernel")):
        model = build(device=dev)
        load_numpy_state_dict(model, sd)
        preds[name] = SyncPredictor(model, dev, dtype, impl)
    return preds


def masked_inputs(torch, dev, b: int = B1, s: int = S, frames=FRAMES, partial: bool = True,
                  masked_frames: int = 4):
    """Seeded uint8 frames (b, s, *frames), PCM (b, s, 10240) and the content
    keep-masks: the frames' (b, s, *frames) and the log-mel's (b, s, 66,
    128); all kept, or (``partial``) the last segment's final
    ``masked_frames`` frames and each segment's last 20 mel time bins
    masked."""
    import numpy as np

    rng = np.random.default_rng(7)
    video = torch.from_numpy(rng.integers(0, 256, (b, s, *frames), dtype=np.uint8)).to(dev)
    pcm = torch.from_numpy((rng.standard_normal((b, s, 10240)) * 0.1).astype(np.float32)).to(dev)
    vis_mask = torch.ones((b, s, *frames), dtype=torch.bool, device=dev)
    aud_mask = torch.ones((b, s, 66, 128), dtype=torch.bool, device=dev)
    if partial:
        vis_mask[:, -1, -masked_frames:] = False
        aud_mask[:, :, -20:] = False
    return video, pcm, {"vis_mask": vis_mask, "aud_mask": aud_mask}


def with_last_segment(rec: dict) -> dict:
    """serving_record's record with the video features of the last segment
    apart (``vfeat_last``): (c)'s partial mask reaches the video there only,
    and a fault confined to the masked segment moves the features of all 14
    segments by a fraction of what it moves that segment's."""
    return {**rec, "vfeat_last": rec["vfeat"][:, -1]}


def tower_alone_records(torch, dev, tag: str, node: dict, inputs: dict, want: dict,
                        name: str, timed: bool = False) -> list:
    """One tower (``node`` through the registry, seeded) alone: f32 plain,
    bf16 plain and bf16 kernel forwards of ``inputs`` (by dtype), the kernel
    forward's launches exactly ``want``; serving_agreement's rule (relative
    L2 within 2 x plain bf16's) on the outputs, under ``name``; with
    ``timed``, ms/batch and peak memory of the bf16 routes (timed_forwards)."""
    from synchformer_tpu_torch.models.sync_model import Synchformer
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict

    build = registry_build({"target": node["target"], "params": dict(node["params"])})
    sd = seeded_state_dict(build(device="meta"), seed=0)
    recs, runs = {}, {}
    for what, dtype, impl in (("f32", torch.float32, "plain"), ("plain", torch.bfloat16, "plain"),
                              ("kernel", torch.bfloat16, "kernel")):
        tower = build(device=dev).eval()
        load_numpy_state_dict(tower, sd)
        # the matrices in bf16 once, LN parameters and biases f32 (SyncPredictor's rule)
        Synchformer.cast_matrices_(tower, dtype)

        def run(x=None, tower=tower, dtype=dtype, impl=impl):
            with torch.no_grad():
                return {name: tower(inputs[dtype] if x is None else x, impl).float()}

        recs[what] = (counted_record(torch, tag, f"one {name} forward", want, run)[0]
                      if impl == "kernel" else run())
        if timed and what != "f32":
            runs[what] = run
        del tower
    log(f"[{tag}] {name}: output {tuple(recs['f32'][name].shape)}")
    failed = serving_agreement(recs["f32"], recs["plain"], recs["kernel"], tag)
    if timed:
        timed_forwards(torch, f"{tag} {name}", runs, (inputs[torch.bfloat16],))
    return failed


def run_tower_options(torch, dev, report):
    """Phase 17: (a) the Stage I step with every rate live and Linear
    projections, (b) the joint-attention sync model, (c) the sync model
    under keep-masks, (d) the AST classifier, mlp_ratio 2, unfactorized
    towers; each held against f32 plain with exact launch counts."""
    from synchformer_tpu_torch.ops.mel import MelSpectrogramConfig, log_mel_spectrogram
    from synchformer_tpu_torch.ops.video import normalize_frames

    smi = smi_line()
    # (a)
    t0 = time.perf_counter()
    run_stage1(torch, dev, report, build=registry_build(stage1_option_model()),
               launches=P17_TRAIN_LAUNCHES, eval_launches=STAGE1_EVAL_LAUNCHES, tag="p17a",
               path="phase 17 (a)")
    log(f"[p17a] {time.perf_counter() - t0:.1f} s; {smi}")

    # (b)
    t0 = time.perf_counter()
    tag = "p17b_joint"
    preds = option_predictors(torch, dev, sync_config("train_avsync_model", S, widths={
        "video": {"attn_layer": "joint"}})["model"])
    video, pcm = slice_inputs(torch, dev, B1)
    ref = serving_record(torch, preds["f32"], video, pcm)
    plain = serving_record(torch, preds["plain"], video, pcm)
    kern, _ = counted_record(torch, tag, "one kernel-path forward", P17_JOINT_LAUNCHES,
                             lambda: serving_record(torch, preds["kernel"], video, pcm))
    failed = serving_agreement(ref, plain, kern, tag)
    if failed:
        fail(f"{tag}: kernel path outside tolerance: {failed}")
    del preds["f32"]
    timed_forwards(torch, tag, preds, (video, pcm))
    del preds, ref, plain, kern
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] {time.perf_counter() - t0:.1f} s")

    # (c)
    t0 = time.perf_counter()
    tag = "p17c_masked"
    preds = option_predictors(torch, dev, sync_config("train_avsync_model", S)["model"])
    video, pcm, keep = masked_inputs(torch, dev, partial=False)
    unmasked = serving_record(torch, preds["kernel"], video, pcm)
    ref = serving_record(torch, preds["f32"], video, pcm, masks=keep)
    plain = serving_record(torch, preds["plain"], video, pcm, masks=keep)
    kern, _ = counted_record(torch, tag, "one masked kernel-path forward", P17_MASKED_LAUNCHES,
                             lambda: serving_record(torch, preds["kernel"], video, pcm,
                                                    masks=keep))
    err, err_p = maxabs(kern["probs"], unmasked["probs"]), maxabs(plain["probs"], ref["probs"])
    tol = 2.0 * err_p + 5e-3
    log(f"[{tag}] all kept: max|probs masked - unmasked| (kernel route) {err:.3e}, tol {tol:.3e} "
        f"{'ok' if err <= tol else 'FAIL'}")
    failed = serving_agreement(ref, plain, kern, f"{tag} all kept")
    if err > tol:
        failed.append("all kept against the unmasked route")
    video, pcm, keep = masked_inputs(torch, dev, partial=True)
    ref = with_last_segment(serving_record(torch, preds["f32"], video, pcm, masks=keep))
    plain = with_last_segment(serving_record(torch, preds["plain"], video, pcm, masks=keep))
    kern = with_last_segment(counted_record(
        torch, tag, "one partly masked kernel-path forward", P17_MASKED_LAUNCHES,
        lambda: serving_record(torch, preds["kernel"], video, pcm, masks=keep))[0])
    failed += serving_agreement(ref, plain, kern, f"{tag} partial")
    if failed:
        fail(f"{tag}: outside tolerance: {failed}")
    del preds["f32"]
    timed_forwards(torch, tag, preds, (video, pcm), keep)
    del preds, ref, plain, kern, unmasked, keep
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] {time.perf_counter() - t0:.1f} s")

    # (d)
    t0 = time.perf_counter()
    tag = "p17d"
    nodes = sync_config("train_avsync_model", S)["model"]["params"]
    video_u8, pcm = slice_inputs(torch, dev, B1)
    mel = log_mel_spectrogram(pcm, MelSpectrogramConfig())
    aud = {dt: mel.transpose(-1, -2).to(dt) for dt in (torch.float32, torch.bfloat16)}
    video = normalize_frames(video_u8)
    vis = {dt: video.to(dt) for dt in (torch.float32, torch.bfloat16)}
    failed = []
    for name, tower, opts, want, x in (
            ("classifier", "afeat_extractor", {"extract_features": False, "num_labels": 527},
             P17_AST_LAUNCHES, aud),
            ("ast_unfactorized", "afeat_extractor", {"factorize_freq_time": False},
             P17_AST_LAUNCHES, aud),
            ("video_unfactorized", "vfeat_extractor", {"factorize_space_time": False},
             P17_VIDEO_LAUNCHES, vis)):
        node = {"target": nodes[tower]["target"], "params": {**nodes[tower]["params"], **opts}}
        failed += tower_alone_records(torch, dev, tag, node, x, want, name)
        gc.collect()
        torch.cuda.empty_cache()
    del aud, vis, video, mel
    preds = option_predictors(torch, dev, sync_config("train_avsync_model", S, widths={
        "audio": {"mlp_ratio": 2.0}, "video": {"mlp_ratio": 2.0}})["model"])
    video = video_u8
    ref = serving_record(torch, preds["f32"], video, pcm)
    plain = serving_record(torch, preds["plain"], video, pcm)
    kern, _ = counted_record(torch, tag, "one mlp_ratio 2 kernel-path forward",
                             P17_SYNC_LAUNCHES,
                             lambda: serving_record(torch, preds["kernel"], video, pcm))
    failed += [f"mlp_ratio 2 {n}" for n in serving_agreement(ref, plain, kern,
                                                              f"{tag} mlp_ratio 2")]
    if failed:
        fail(f"{tag}: outside tolerance: {failed}")
    log(f"[{tag}] {time.perf_counter() - t0:.1f} s; {smi}")


# phase 18: the shapes the TPU kernels take past the main path's, each driven
# through the registry from a shipped config with the widths changed
# (a) the AudioSet AST classifier on 10 s clips: 1024 mel frames
AST_SPEC_T, AST_CLIP_SAMPLES, AST_LABELS = 1024, 160000, 527
P18_AST_LAUNCHES = {**{key: 0 for key in KEYS}, "K2": 12, "K3": 12}
# (b) a video tower at ViT-H/14's width and heads, the Motionformer's depth
P18_WIDE_VIDEO = {"embed_dim": 1280, "num_heads": 16}
# (c) 2.56 s segments: 64 raw frames (32 after the 3-D patch embed), 40960
# PCM samples; the log-mel 256 hops + 2, the rule that gives 0.64 s its 66
P18_RAW_FRAMES, P18_SAMPLES, P18_MEL_T = 64, 40960, 258
# (d) mlp_ratio 2.6 on both towers: hidden int(768 * 2.6) = 1996
P18_MLP_RATIO = 2.6


def wide_sync_node(attn_impl: str) -> dict:
    """configs/sync.yaml's model (sync_config) with the video tower at
    P18_WIDE_VIDEO on ``attn_impl`` and a Linear 1280 -> 768 vproj."""
    node = sync_config("train_avsync_model", S, widths={
        "video": {**P18_WIDE_VIDEO, "attn_impl": attn_impl}})["model"]
    node["params"]["vproj"] = {"target": "torch.nn.Linear", "params": {
        "in_features": P18_WIDE_VIDEO["embed_dim"], "out_features": D}}
    return node


def wide_stage1_node() -> dict:
    """configs/segment_avclip.yaml's model with the video tower at
    P18_WIDE_VIDEO and a Linear 1280 -> 768 vproj (the audio side as
    shipped)."""
    from synchformer_tpu_torch.config.core import load_config

    model = load_config(os.path.join(ENTRY_CONFIGS, "segment_avclip.yaml")).to_dict()["model"]
    p = model["params"]
    p["vfeat_extractor"]["params"].update(P18_WIDE_VIDEO)
    p["vproj"] = {"target": "torch.nn.Linear", "params": {
        "in_features": P18_WIDE_VIDEO["embed_dim"], "out_features": p["n_embd"]}}
    return model


def segment_stage1_node() -> dict:
    """configs/segment_avclip.yaml's model for 2.56 s segments: the
    Motionformer's temporal_resolution P18_FRAMES, the AST's max_spec_t
    P18_MEL_T."""
    from synchformer_tpu_torch.config.core import load_config

    model = load_config(os.path.join(ENTRY_CONFIGS, "segment_avclip.yaml")).to_dict()["model"]
    p = model["params"]
    p["vfeat_extractor"]["params"]["temporal_resolution"] = P18_FRAMES
    p["afeat_extractor"]["params"]["max_spec_t"] = P18_MEL_T
    return model


def run_shapes(torch, dev, report):
    """Phase 18: (a) the AudioSet AST classifier at 1214 tokens, (b) a
    ViT-H-width video tower (16 heads of 80, hidden 5120) in sync inference
    on both attention routes and in the Stage I step, (c) the Stage I step
    over 2.56 s segments (32 frames a segment in the time pass), (d) sync
    inference at mlp_ratio 2.6 (hidden 1996); each held against f32 plain
    with exact launch counts and timed."""
    import functools

    from synchformer_tpu_torch.infer import SyncPredictor
    from synchformer_tpu_torch.ops.mel import MelSpectrogramConfig, log_mel_spectrogram
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict

    smi = smi_line()
    nodes = sync_config("train_avsync_model", S)["model"]["params"]

    # (a)
    t0 = time.perf_counter()
    tag = "p18a_ast"
    rng = torch.Generator(device=dev).manual_seed(11)
    pcm = torch.randn(B, 1, AST_CLIP_SAMPLES, generator=rng, device=dev) * 0.1
    mel = log_mel_spectrogram(pcm, MelSpectrogramConfig(max_spec_t=AST_SPEC_T)).transpose(-1, -2)
    aud = {dt: mel.to(dt).contiguous() for dt in (torch.float32, torch.bfloat16)}
    node = {"target": nodes["afeat_extractor"]["target"], "params": {
        **nodes["afeat_extractor"]["params"], "extract_features": False,
        "num_labels": AST_LABELS, "max_spec_t": AST_SPEC_T}}
    log(f"[{tag}] log-mel {tuple(mel.shape)}: {2 + 12 * ((AST_SPEC_T - 16) // 10 + 1)} tokens")
    failed = tower_alone_records(torch, dev, tag, node, aud, P18_AST_LAUNCHES, "classifier",
                                 timed=True)
    if failed:
        fail(f"{tag}: outside tolerance: {failed}")
    del aud, mel, pcm
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] {time.perf_counter() - t0:.1f} s")

    # (b) sync inference on both routes, then the Stage I step
    t0 = time.perf_counter()
    tag = "p18b_wide"
    build, build_f = registry_build(wide_sync_node("pallas")), registry_build(
        wide_sync_node("pallas_fused"))
    sd = seeded_state_dict(build(device="meta"), seed=0)
    preds = {}
    for name, make, dtype, impl in (("f32", build, torch.float32, "plain"),
                                    ("plain", build, torch.bfloat16, "plain"),
                                    ("kernel", build, torch.bfloat16, "kernel"),
                                    ("fused", build_f, torch.bfloat16, "kernel")):
        model = make(device=dev)
        load_numpy_state_dict(model, sd)
        preds[name] = SyncPredictor(model, dev, dtype, impl)
    video, pcm = slice_inputs(torch, dev, B1)
    ref = serving_record(torch, preds["f32"], video, pcm)
    plain = serving_record(torch, preds["plain"], video, pcm)
    kern, _ = counted_record(torch, tag, "one pallas kernel-path forward",
                             SERVING_PALLAS_LAUNCHES,
                             lambda: serving_record(torch, preds["kernel"], video, pcm))
    fused, _ = counted_record(torch, tag, "one pallas_fused kernel-path forward",
                              SERVING_FUSED_LAUNCHES,
                              lambda: serving_record(torch, preds["fused"], video, pcm))
    failed = serving_agreement(ref, plain, kern, tag)
    failed += [f"fused {n}" for n in serving_agreement(ref, plain, fused, f"{tag}_fused")]
    if failed:
        fail(f"{tag}: kernel path outside tolerance: {failed}")
    del preds["f32"]
    timed_forwards(torch, tag, preds, (video, pcm),
                   order=("plain", "kernel", "fused", "fused", "kernel", "plain"))
    del preds, ref, plain, kern, fused
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] sync inference {time.perf_counter() - t0:.1f} s; {smi}")
    t0 = time.perf_counter()
    # the kernel path's step peaks near 37 GiB above its trainer, the plain
    # path's near 61: one trainer resident at a time
    run_stage1(torch, dev, report, build=registry_build(wide_stage1_node()),
               launches=STAGE1_8HEAD_LAUNCHES, eval_launches=STAGE1_8HEAD_EVAL_LAUNCHES,
               tag="p18b_stage1", path="phase 18 (b)", solo=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[p18b_stage1] {time.perf_counter() - t0:.1f} s; {smi}")

    # (c): the kernel step alone peaks near 47 GiB, the plain bf16 one near
    # 85 without remat
    t0 = time.perf_counter()
    run_stage1(torch, dev, report, build=registry_build(segment_stage1_node()),
               launches=STAGE1_LAUNCHES, eval_launches=STAGE1_EVAL_LAUNCHES,
               tag="p18c_segments", path="phase 18 (c)", s=P18_SEGMENTS,
               frames=(P18_RAW_FRAMES, *FRAMES[1:]), samples=P18_SAMPLES, mel_t=P18_MEL_T,
               solo=True, plain_remat=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[p18c_segments] {time.perf_counter() - t0:.1f} s; {smi}")

    # (d)
    t0 = time.perf_counter()
    tag = "p18d_mlp"
    preds = option_predictors(torch, dev, sync_config("train_avsync_model", S, widths={
        "audio": {"mlp_ratio": P18_MLP_RATIO}, "video": {"mlp_ratio": P18_MLP_RATIO}})["model"])
    video, pcm = slice_inputs(torch, dev, B1)
    record = functools.partial(serving_record, torch, video=video, pcm=pcm, audio=True)
    ref, plain = record(pred=preds["f32"]), record(pred=preds["plain"])
    kern, _ = counted_record(torch, tag, f"one mlp_ratio {P18_MLP_RATIO} kernel-path forward",
                             P17_SYNC_LAUNCHES, lambda: record(pred=preds["kernel"]))
    failed = serving_agreement(ref, plain, kern, tag)
    if failed:
        fail(f"{tag}: kernel path outside tolerance: {failed}")
    del preds["f32"]
    timed_forwards(torch, tag, preds, (video, pcm))
    del preds, ref, plain, kern
    log(f"[{tag}] {time.perf_counter() - t0:.1f} s; {smi}")


# phase 19: tensor parallelism (parallel/tensor.py), four ranks as a (2 data
# x 2 model) grid on the one card
TP_CASES = ("stage2", "avclip")
TP_WORLD, TP_MODEL = 4, 2


def run_tensor_parallel(torch, dev, report, cases=TP_CASES, tiny=None, hook=None,
                        fault=None, check: bool = True) -> dict:
    """Phase 19: run_gloo_group at world 4, model_parallel 2, randomness off
    as in phase 14 (c): (a) the Stage II step (sync.yaml, global B=16, 8 a
    data rank, its rate base_learning_rate x 2) and (b) the AVCLIP step
    (segment_avclip's model, every parameter trainable, global B=2); each
    rank's exact launches, its first step held against the world-1 f32
    plain step by sync_agreement / stage1_agreement within 2 x the world-1
    bf16 kernel step's error, tp_checks, the Stage II checkpoint read at
    world 1; ms/step over gloo beside nvidia-smi's name and power limit.
    ``cases``, ``tiny``, ``hook``, ``fault``, ``check``: run_gloo_group's
    (the planted faults). Returns rank 0's result."""
    t0 = time.perf_counter()
    res = run_gloo_group(torch, dev, cases=cases, tiny=tiny, hook=hook, fault=fault,
                         check=check, world=TP_WORLD, model_parallel=TP_MODEL, tag="tp_world4")
    smi = smi_line() if torch.device(dev).type == "cuda" else "cpu"
    for case, r in res["cases"].items():
        log(f"[timing] tp_world4 {case}: {r['ms']:.1f} ms/step over gloo, {TP_WORLD} ranks as "
            f"({TP_WORLD // TP_MODEL} data x {TP_MODEL} model) on one card; {smi}")
    log(f"[tp_world4] {time.perf_counter() - t0:.1f} s")
    return res


# phase 20: the legacy towers' training (models/conv.py BatchNorm in training,
# models/s3d.py, models/resnet_audio.py) through SyncTrainer and AVCLIPTrainer
P20_B = 2  # the legacy Stage II step's base_batch_size
# its loss eps (sync_agreement): about 3 x the larger bf16 path's reading at B=2
P20_LOSS_EPS = 1e-2
P20_CLIP_SEGMENTS = 8  # (b)'s segments: 16 InfoNCE pairs at B1 (phase 18 (c)'s reason)
# flax's BatchNorm momentum (the weight of the old value) of each legacy tower
# (synchformer_tpu/models/s3d.py and resnet_audio.py BN_KW), by its key
FLAX_BN_MOMENTUM = {"vfeat_extractor": 0.999, "afeat_extractor": 0.9}
# the largest relative L2 error of a BatchNorm's running-statistics update
# against flax's update from the f64 statistics of its input: an f32
# one-pass variance reads about 1e-4 of it on the worst channels of these
# seeded weights; a variance off by N / (N - 1), N the values a channel
# (336 in ResNet-18's last stage at B=2), reads 3e-3
P20_FLAX_TOL = 1e-3
# (b): the S3D spatial and the ResNet-18 frequency pools; AveragePooling time tails
P20_CLIP_LAUNCHES = {**{key: 0 for key in KEYS}, "K4": 2}
# the leaves of (b)'s gradient check: both pools' packed in-projections (K4's
# recompute backward feeds them) and each trunk's first conv
LEGACY_LEAVES = re.compile(
    r"(?:vfeat_extractor\.spatial_attn_agg|afeat_extractor\.freq_attn_agg)\.self_attn\."
    r"in_proj_weight|vfeat_extractor\.stem_sep\.conv_s\.weight|afeat_extractor\.conv1\.weight")


def legacy_train_config(s: int, half: bool = True, widths: dict | None = None,
                        b: int = P20_B) -> dict:
    """presets.legacy_sync_model(s) (``widths``: its d / n_layer / n_head)
    with both towers is_trainable and no tower checkpoint, and
    sync_config's training (Adam at 2e-6 on constant_with_warmup 1000, clip
    1, base_batch_size ``b``, use_half_precision ``half``) and data (flip p
    0.5) sections; the transformer's dropouts 0.1 as the config's."""
    from synchformer_tpu_torch.models.presets import legacy_sync_model

    model = legacy_sync_model(s, **(widths or {}))
    model["params"]["vfeat_extractor"]["params"].pop("ckpt_path", None)
    for key in FLAX_BN_MOMENTUM:
        model["params"][key]["is_trainable"] = True
    cfg = sync_config("train_avsync_model", s, half=half)
    cfg["training"]["base_batch_size"] = b
    return {**cfg, "model": model}


def legacy_avclip_node(widths: dict | None = None) -> dict:
    """An AVCLIP node over S3D + ResNet-18 with AveragePooling time tails
    and Linear projections 1024 -> n_embd, 512 -> n_embd (``widths``' d, else
    768)."""
    d = (widths or {}).get("d", D)

    def lin(n):
        return {"target": "torch.nn.Linear", "params": {"in_features": n, "out_features": d}}

    return {"target": "synchformer_tpu.models.avclip.AVCLIP", "params": {
        "n_embd": d,
        "vfeat_extractor": {"target": "model.modules.feat_extractors.visual.s3d."
                            "S3DVisualFeatures",
                            "params": {"agg_time_module": "AveragePooling"}},
        "afeat_extractor": {"target": "model.modules.feat_extractors.audio.resnet."
                            "ResNet18AudioFeatures",
                            "params": {"agg_time_module": "AveragePooling"}},
        "vproj": lin(1024), "aproj": lin(512)}}


class tf32_off:
    """Context: TF32 off in cuBLAS and cuDNN (an f32 anchor)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        b = self.torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.saved


class deterministic_convs:
    """Context: cuDNN's deterministic algorithms (a resumed step repeated bit
    for bit; the convs' backward may sum with atomics otherwise)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        c = self.torch.backends.cudnn
        self.saved = (c.deterministic, c.benchmark)
        c.deterministic, c.benchmark = True, False

    def __exit__(self, *exc):
        c = self.torch.backends.cudnn
        c.deterministic, c.benchmark = self.saved


class flax_bn_check:
    """Context: during it, each legacy BatchNorm in training of ``model``
    sums its input's count, sum and sum of squares per channel in f64 (a
    forward pre-hook); ``check()`` then holds each BatchNorm's
    running-statistics update (after - ``before``, bn_buffers) against
    flax's from those sums, m * old + (1 - m) * batch with m FLAX_BN_MOMENTUM
    of its tower and the biased var: relative L2 error within P20_FLAX_TOL.
    An independent reference of the momentum and the variance's bias."""

    def __init__(self, torch, model, tag: str):
        self.torch, self.model, self.tag = torch, model, tag
        self.sums, self.handles = {}, []

    def __enter__(self):
        from synchformer_tpu_torch.models.conv import BatchNorm

        torch = self.torch
        self.before = bn_buffers(torch, self.model)
        for name, mod in self.model.named_modules():
            if isinstance(mod, BatchNorm):
                def hook(m, args, kwargs, name=name):
                    if not kwargs.get("train"):
                        return
                    x = args[0].detach()
                    axes = [0] + list(range(2, x.ndim))
                    s1 = s2 = 0.0
                    for part in x.split(4):
                        s1 = s1 + part.sum(axes, dtype=torch.float64)
                        s2 = s2 + (part.double() ** 2).sum(axes)
                    self.sums[name] = (s1, s2, x.numel() // x.shape[1])
                self.handles.append(mod.register_forward_pre_hook(hook, with_kwargs=True))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def check(self) -> tuple:
        """(the names of the BatchNorms outside the tolerance, the largest
        error over the tolerance)."""
        after = bn_buffers(self.torch, self.model)
        failed, worst = [], (0.0, "")
        for name, (s1, s2, n) in self.sums.items():
            m = FLAX_BN_MOMENTUM[name.split(".", 1)[0]]
            mean = s1 / n
            for key, stat in (("running_mean", mean), ("running_var", s2 / n - mean * mean)):
                old = self.before[f"{name}.{key}"]
                want = (m * old + (1 - m) * stat) - old
                got = after[f"{name}.{key}"] - old
                err = float((got - want).norm() / want.norm().clamp_min(1e-300))
                worst = max(worst, (err / P20_FLAX_TOL, f"{name}.{key} {err:.3e}"))
                if err > P20_FLAX_TOL:
                    failed.append(f"{name}.{key}")
        log(f"[{self.tag}] {len(self.sums)} BatchNorms' running-statistics updates against "
            f"flax's (f64 statistics of the input, momentum by tower, biased var): "
            f"{2 * len(self.sums) - len(failed)} ok, {len(failed)} FAIL; worst {worst[1]} "
            f"(margin {worst[0]:.3f})")
        if not self.sums:
            failed.append("no BatchNorm trained")
        return failed, worst[0]


def bn_unit_check(torch, dev, tag: str = "p20") -> tuple:
    """BatchNorm(train=True) on the card at each tower's eps and momentum on
    (2, 3, 4, 4, 4) inputs whose last channel is 8 + k / 16, k in {-1, 0, 1}
    summing to 4 (every sum exact in f32, so that any order of sums gives
    flax's one-pass E[x^2] - E[x]^2 bit for bit, E[x]^2 rounded by 2^-18; a
    two-pass variance differs by 1e-3 of it): that channel's output against
    flax's formula in f32 within 1e-5 of the output's largest value, and the
    new running var bit for bit. Returns (the names of the failed checks,
    the largest margin)."""
    import numpy as np

    from synchformer_tpu_torch.models.conv import BatchNorm

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 3, 4, 4, 4)) * 1.5 + 1.0).astype(np.float32)
    k = rng.integers(-1, 2, x[:, 2].size)
    while k.sum() != 4:
        i = int(np.argmax(k < 1) if k.sum() < 4 else np.argmax(k > -1))
        k[i] += 1 if k.sum() < 4 else -1
    x[:, 2] = (8.0 + k / 16.0).reshape(x[:, 2].shape)
    c = x[:, 2].astype(np.float64)
    mean = np.float32(c.sum()) / np.float32(k.size)  # exact
    var = np.float32(np.float32((c * c).sum()) / np.float32(k.size) - np.float32(mean * mean))
    failed, worst = [], 0.0
    for kind, (eps, m) in {"s3d": (1e-3, 0.999), "resnet": (1e-5, 0.9)}.items():
        bn = BatchNorm(3, eps, device=dev, momentum=m)
        with torch.no_grad():
            y = bn(torch.from_numpy(x).to(dev), train=True)
        want = (x[:, 2] - mean) * (np.float32(1) / np.sqrt(var + np.float32(eps)))
        err = float(np.abs(y[:, 2].float().cpu().numpy() - want).max())
        tol = 1e-5 * float(y.abs().max())
        want_var = np.float32(m) * np.float32(1.0) + np.float32(1 - m) * var
        got_var = float(bn.running_var[2])
        worst = max(worst, err / tol)
        ok = err <= tol and got_var == float(want_var)
        if not ok:
            failed.append(f"bn unit {kind}")
        log(f"[{tag}] BatchNorm {kind} on the near-constant channel: max|y - flax| {err:.3e} "
            f"tol {tol:.3e}; running var {got_var!r} flax {float(want_var)!r} "
            f"{'ok' if ok else 'FAIL'}")
    return failed, worst


def legacy_trainers(torch, dev, cfg: dict, tag: str):
    """``make(impl, half)`` of phase 20 (a): sync_trainer on ``cfg``; the
    f32 trainer's steps run with TF32 off (the caller's tf32_off)."""
    def make(impl, half):
        t0 = time.perf_counter()
        tr = sync_trainer(cfg, dev, impl, half)
        log(f"[{tag}] trainer {impl} {'bf16' if half else 'f32'} built in "
            f"{time.perf_counter() - t0:.1f} s")
        return tr

    return make


def p20_legacy_step(torch, dev, s: int = S, frames=FRAMES, widths: dict | None = None,
                    check: bool = True, compare: bool = True, resume: bool = True) -> dict:
    """Phase 20 (a) and (d): the legacy Stage II step with trainable towers
    through SyncTrainer at B=P20_B, S=``s``. ``compare``: (a)'s f32 plain and
    bf16 plain records, sync_agreement and the timing; the bf16 kernel
    trainer's first step, its launches and flax_bn_check always; ``resume``:
    (d). Returns the failed checks and margins (``check``: fail on any)."""
    from synchformer_tpu_torch.utils.checkpoint import CheckpointManager
    from synchformer_tpu_torch.utils.logger import EarlyStopper

    tag = "p20a"
    cuda = torch.device(dev).type == "cuda"
    cfg = legacy_train_config(s, True, widths)
    make = legacy_trainers(torch, dev, cfg, tag)
    batch = sync_batch(torch, dev, P20_B, s, frames)
    failed, margins = [], {}

    def cleanup():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    if compare:
        with tf32_off(torch):
            tr = make("plain", False)
            with flax_bn_check(torch, tr.model, f"{tag} f32") as flax:
                ref, _ = sync_record(torch, tr, batch, "(c) f32 plain", tag)
            f, margins["flax f32"] = flax.check()
            failed += [f"flax f32 {n}" for n in f]
        del tr
        cleanup()
    resident = torch.cuda.memory_allocated() if cuda else 0
    kern_tr = make("kernel", True)
    with flax_bn_check(torch, kern_tr.model, f"{tag} kernel") as flax:
        kern, k_peak = sync_record(torch, kern_tr, batch, "(a) bf16 kernel", tag, resident)
    f, margins["flax kernel"] = flax.check()
    failed += [f"flax kernel {n}" for n in f]
    for what, counts in zip(("eval step", "train step"), kern["launches"]):
        log(f"[{tag}] launches in one kernel {what}: {counts}")
        if cuda and {k: counts.get(k, 0) for k in KEYS} != LEGACY_LAUNCHES:
            failed.append(f"{what} launches {counts}")
    if compare:
        resident = torch.cuda.memory_allocated() if cuda else 0
        plain_tr = make("plain", True)
        plain, p_peak = sync_record(torch, plain_tr, batch, "(b) bf16 plain", tag, resident)
        failed += sync_agreement(ref, plain, kern, tag, margins)
        del ref, plain
        times = {}
        for name, tr in (("plain", plain_tr), ("kernel", kern_tr)):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            checked_step(tr, batch, f"{tag} {name} step 2")
            if cuda:
                torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3
        del plain_tr
        cleanup()
        for name, peak in (("kernel", k_peak), ("plain", p_peak)):
            log(f"[timing] {tag} legacy Stage II {name} path (bf16, trainable towers): "
                f"{times[name]:.1f} ms/step of {P20_B} clips x {s} segments (its second "
                f"step); first step's peak memory {gib(peak)}; "
                f"{smi_line() if cuda else 'cpu'}")
    else:
        checked_step(kern_tr, batch, f"{tag} kernel step 2")
    del kern
    if resume:
        # (d) the payload after step 2, restored into a new trainer; step 3 on both
        import shutil

        root = os.path.join(REPO, "build", "chip_smoke", "p20_ckpt")
        shutil.rmtree(root, ignore_errors=True)
        ckpt = CheckpointManager(root)
        ckpt.save_latest(0, kern_tr.payload(0, EarlyStopper(5, "max")))
        with deterministic_convs(torch):
            m3 = checked_step(kern_tr, batch, f"{tag} kernel step 3")
        # the trainable modules' state read from the model itself, buffers included
        want = {k: v.detach().to("cpu", copy=True)
                for k, v in kern_tr.model.state_dict().items()
                if k.split(".", 1)[0] in kern_tr.trainable_keys}
        del kern_tr
        cleanup()
        resumed = {**cfg, "training": {**cfg["training"], "resume": True}}
        tr = legacy_trainers(torch, dev, resumed, "p20d")("kernel", True)
        tr.ckpt = ckpt
        epoch = tr.maybe_resume(EarlyStopper(5, "max"))
        with deterministic_convs(torch):
            r3 = checked_step(tr, batch, "p20d resumed step 3")
        got = tr.model.state_dict()
        diff = [k for k, v in want.items() if not torch.equal(got[k].cpu(), v)]
        stats = [k for k in want if "running" in k]
        ok = not diff and r3 == m3 and epoch == 1 and tr.step == 3 and bool(stats)
        log(f"[p20d] resumed after step 2 (epoch {epoch}, step {tr.step}): step 3 "
            f"{'bit for bit' if ok else 'DIFFERS'}: loss {r3['loss']!r} vs {m3['loss']!r}, "
            f"grad_norm {r3['grad_norm']!r} vs {m3['grad_norm']!r}; {len(want)} trainable "
            f"tensors ({len(stats)} running statistics), {len(diff)} differ {diff[:4]}")
        if not ok:
            failed.append(f"resume {diff[:4]}")
        margins["resume differing tensors"] = float(len(diff))
        del tr
        shutil.rmtree(root, ignore_errors=True)
    else:
        del kern_tr
    cleanup()
    if check and failed:
        fail(f"{tag}: {failed}")
    return {"failed": failed, "margins": margins}


def legacy_stage1_record(torch, tr, batch, what: str, tag: str, resident: int = 0):
    """One AVCLIP step's record (step_gradients' over LEGACY_LEAVES and the
    BatchNorms' update ``bn``), its launches and peak memory."""
    from synchformer_tpu_torch.ops.kernels import _build

    cuda = tr.device.type == "cuda"
    before = bn_buffers(torch, tr.model)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    t0 = time.perf_counter()
    m = checked_step(tr, batch, what)
    if cuda:
        torch.cuda.synchronize()
    counts = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() - resident if cuda else 0
    log(f"[{tag}] {what} first step: loss {m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, "
        f"{time.perf_counter() - t0:.2f} s, peak memory {gib(peak)}; launches {counts}")
    rec = step_gradients(torch, tr, m, LEGACY_LEAVES)
    rec["bn"] = bn_update(before, bn_buffers(torch, tr.model))
    return rec, counts, peak


def p20_legacy_avclip(torch, dev, s: int = P20_CLIP_SEGMENTS, frames=FRAMES,
                      widths: dict | None = None, check: bool = True) -> dict:
    """Phase 20 (b): one AVCLIPTrainer step over S3D + ResNet-18
    (legacy_avclip_node, built through the registry, seeded), B=B1, S=``s``:
    f32 plain (TF32 off), bf16 kernel, bf16 plain from the same weights,
    batch and generator seed; the kernel step's launches exactly
    P20_CLIP_LAUNCHES; stage1_agreement and bn_agreement; ms/step of a
    second step and peak memory."""
    from synchformer_tpu_torch.registry import instantiate_from_config
    from synchformer_tpu_torch.utils.convert import seeded_state_dict

    tag = "p20b"
    cuda = torch.device(dev).type == "cuda"
    node = legacy_avclip_node(widths)

    def build(remat=False, device=None):
        return instantiate_from_config(node, device=device)

    sd = seeded_state_dict(build(device="meta"), seed=0)
    batch = stage1_batch(torch, B1, s, frames)
    failed, margins = [], {}
    with tf32_off(torch):
        tr = stage1_trainer(build, sd, dev, "fp32", "plain", window=s)
        ref, _, _ = legacy_stage1_record(torch, tr, batch, "(c) f32 plain", tag)
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    trainers, rec, peak = {}, {}, {}
    for name, impl in (("kernel", "kernel"), ("plain", "plain")):
        resident = torch.cuda.memory_allocated() if cuda else 0
        trainers[name] = stage1_trainer(build, sd, dev, "amp", impl, window=s)
        rec[name], counts, peak[name] = legacy_stage1_record(torch, trainers[name], batch,
                                                            f"{name} bf16", tag, resident)
        if (name == "kernel" and cuda
                and {k: counts.get(k, 0) for k in KEYS} != P20_CLIP_LAUNCHES):
            failed.append(f"launches {counts}")
    failed += stage1_agreement(ref, rec["plain"], rec["kernel"], tag, margins=margins)
    failed += bn_agreement(ref, rec["plain"], rec["kernel"], tag, margins)
    for name, tr in trainers.items():
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        checked_step(tr, batch, f"{tag} {name} step 2")
        if cuda:
            torch.cuda.synchronize()
        log(f"[timing] {tag} legacy AVCLIP {name} path (amp): "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms/step of {B1} clips x {s} segments "
            f"(its second step); first step's peak memory {gib(peak[name])}; "
            f"{smi_line() if cuda else 'cpu'}")
    del trainers, ref, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if check and failed:
        fail(f"{tag}: {failed}")
    return {"failed": failed, "margins": margins}


def run_legacy_training(torch, dev, report):
    """Phase 20: the legacy towers' training at their full widths (S3D 1024,
    ResNet-18 512; 16 frames of 224^2 and 66 x 128 log-mel a segment):
    bn_unit_check (the one-pass statistics on a near-constant channel); (a)
    presets.legacy_sync_model(14) with is_trainable towers through
    SyncTrainer, B=2: f32 plain (TF32 off), bf16 kernel, bf16 plain from the
    same weights, batch and generator seed, launches exactly LEGACY_LAUNCHES
    (K4 2: the S3D spatial pool (56, 49, 1024) at 8 x 128, the ResNet-18
    frequency pool (84, 4, 512) at 8 x 64) in the kernel eval step and in
    its train step (K4's backward is its plain recompute), sync_agreement
    with the BatchNorms' updates (bn_agreement), each step's updates against
    flax's from the f64 statistics of each BatchNorm's input
    (flax_bn_check), ms/step and peak memory; (b) p20_legacy_avclip; (c) the
    legacy step at world 2 over gloo on the one card (run_gloo_group, case
    'legacy', randomness off), held against world 1 and every rank's
    running statistics bitwise equal; (d) the kernel trainer saved after its
    second step, restored into a new one (maybe_resume), and the third step
    bit for bit on both (cuDNN deterministic for that step)."""
    t0 = time.perf_counter()
    failed, _ = bn_unit_check(torch, dev)
    if failed:
        fail(f"p20: {failed}")
    log(f"[p20] unit check {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    p20_legacy_step(torch, dev)
    log(f"[p20a] (a) + (d) {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    p20_legacy_avclip(torch, dev)
    log(f"[p20b] (b) {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    res = run_gloo_group(torch, dev, cases=("legacy",), tag="p20c", timed_steps=1)
    log(f"[p20c] (c) {time.perf_counter() - t1:.1f} s; {res['cases']['legacy']['ms']:.1f} "
        f"ms/step at world 2 over gloo")
    log(f"[p20] phase 20 {time.perf_counter() - t0:.1f} s; {smi_line()}")


PHASES = (check_kernels, run_slice, run_stage1, run_packed_block, run_stage1_8head,
          run_serving_8head, run_moco, run_sync_training,
          run_audio_augs, run_entry_point, run_data_parallel, run_reference_ckpts, run_legacy,
          run_tower_options, run_shapes, run_tensor_parallel, run_legacy_training)


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
    import shutil

    shutil.rmtree(REFS_DIR, ignore_errors=True)
    for phase in PHASES:
        t0 = time.perf_counter()
        phase(torch, dev, report)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[phase] {phase.__name__} {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(REFS_DIR, ignore_errors=True)
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
