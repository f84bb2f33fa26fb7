#!/usr/bin/env python3
"""Drive the PyTorch port's two paths once on one NVIDIA GPU: sync inference
and the Stage I contrastive training step.

    python3 chip_smoke.py

Phases, each printed as it runs with its seconds:
1. device and build: torch / CUDA versions, the card's name and power limit,
   the seconds nvcc took for the kernels (built into build/torch_kernels/).
2. per kernel at its main path's shapes in bf16 (K1-K4 at sync inference's,
   K5 and K6, the divided attention's forward and backward, at Stage I's):
   the kernel against its plain PyTorch version (for K6 the autograd gradient
   of K5's plain version, for seeded random cotangents), both held against a
   plain f32 anchor on the same inputs. Tolerance for each output: kernel
   error <= 2 x plain-bf16 error + eps, with eps = 1e-2 x max|anchor| (bf16
   keeps 8 bits; the two sides round at other places). Each kernel and its
   plain version are timed with CUDA events; K3 also against
   torch.nn.functional.scaled_dot_product_attention on views of the same
   packed QKV (a yardstick only: the port never calls it).
3. the full-width inference slice: Synchformer S=14 (ViT-B towers of 12
   layers, D=768, 3-layer GlobalTransformer), B=8, seeded weights, through
   SyncPredictor(impl='kernel') and (impl='plain') in bf16, both against an
   f32 plain run. Launch counters are zeroed before the kernel-path forward
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
   shows that it fails a wrong K5 or K6); every loss finite, the logit
   scale clamped. Then 3 timed steps per bf16 path after the first
   (host clock around synchronised steps), the peak memory of each, and one
   eval step (the K1-K4 route) with its zero-shot precision.
The line before the last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}. Any failed phase raises, so the exit code is
non-zero and no result line is printed.
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

KEYS = ("K1", "K2", "K3", "K4", "K5", "K6")
REPLACES = {
    "K1": "synchformer_tpu/ops/pallas/divided_attention.py:478",
    "K2": "synchformer_tpu/ops/pallas/fused_rows.py:188",
    "K3": "synchformer_tpu/ops/pallas/standard_attention.py:62",
    "K4": "synchformer_tpu/ops/pallas/cls_pool.py:181",
    "K5": "synchformer_tpu/ops/pallas/divided_attention.py:524",
    "K6": "synchformer_tpu/ops/pallas/divided_attention_bwd.py:469",
}
SOURCES = {
    "K1": "synchformer_tpu_torch/csrc/divided_attention.cu",
    "K2": "synchformer_tpu_torch/csrc/ln_mlp.cu",
    "K3": "synchformer_tpu_torch/csrc/standard_attention.cu",
    "K4": "synchformer_tpu_torch/csrc/cls_pool.cu",
    "K5": "synchformer_tpu_torch/csrc/divided_attention.cu",
    "K6": "synchformer_tpu_torch/csrc/divided_attention_bwd.cu",
}
NAMES = {
    "K1": "divided_attention_proj",
    "K2": "fused_ln_mlp_residual",
    "K3": "standard_attention",
    "K4": "fused_cls_pool_tokens",
    "K5": "divided_attention",
    "K6": "divided_attention_bwd",
}
# the path whose run gives each kernel's launches (and whose shapes it is timed at)
PATHS = {"K1": "sync_inference", "K2": "sync_inference", "K3": "sync_inference",
         "K4": "sync_inference", "K5": "stage1_train", "K6": "stage1_train"}
MIN_LAUNCHES = {"K1": 24, "K2": 24, "K3": 12, "K4": 2}
# one Stage I step: 12 blocks x (time + space) divided attentions; the AST's
# 12 layers; K2 on the AST's 12 layers and on video block 0, the one block
# whose drop-path rate (linspace(0, 0.2, 12)[0]) is 0; both aggregators
STAGE1_LAUNCHES = {"K1": 0, "K2": 13, "K3": 12, "K4": 2, "K5": 24, "K6": 24}
# the gradient leaves that K5 / K6 feed directly (step_gradients)
STAGE1_LEAVES = re.compile(
    r"vfeat_extractor\.(cls_token|blocks\.\d+\.(attn|timeattn)\.qkv\.(weight|bias))")
MAX_CLIP = 1.0  # Stage I's max_clip_norm
B, S = 8, 14
B1 = 2  # Stage I's base_batch_size
D, H, DH = 768, 12, 64
F_T, N_P = 8, 196  # frames after the 3-D patch embed, patches per frame
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


def attention_flops(b: int, mode: str, matmuls: int) -> float:
    """Divided attention over b segments: per head, every group's L queries
    against its L + 1 keys and the CLS query against 1 + f*n keys, ``matmuls``
    (L x (L+1) x dh) products of 2 FLOPs a MAC (2 forward, 5 backward)."""
    groups, length = (F_T, N_P) if mode == "space" else (N_P, F_T)
    per_head = groups * length * (length + 1) + F_T * N_P + 1
    return 2.0 * matmuls * b * H * per_head * DH


def gib(n_bytes: float) -> str:
    return f"{n_bytes / 2 ** 30:.2f} GiB"


def kernel_cases(torch, dev):
    """(key, label, kernel fn, plain fn on given dtype, (bytes, FLOPs), library
    fn or None) at main-path shapes."""
    import torch.nn.functional as F

    from synchformer_tpu_torch.ops.kernels.cls_pool import fused_cls_pool_tokens
    from synchformer_tpu_torch.ops.kernels.divided_attention import (
        divided_attention,
        divided_attention_proj,
    )
    from synchformer_tpu_torch.ops.kernels.divided_attention_bwd import (
        divided_attention_bwd,
        divided_attention_bwd_plain,
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

    cases = []
    bs = B * S
    wo, bo = rn(d, d, std=0.02), rn(d, std=0.02, dtype=torch.float32)
    qkv_p, qkv_c = rn(bs, F_T, N_P, 3 * d), rn(bs, 1, 3 * d)
    res = rn(bs, F_T, N_P, d)
    act = bs * F_T * N_P * d * 2  # one (bs, f, n, D) bf16 activation
    for mode in ("space", "time"):
        args = [qkv_p, qkv_c, res, wo, bo]
        cost = (5 * act + d * d * 2 + d * 4 + 2 * bs * 3 * d * 2,
                attention_flops(bs, mode, 2) + 2.0 * bs * F_T * N_P * d * d)
        cases.append(("K1", f"K1 {mode} ({bs},8,196,2304)",
                      lambda a=args, m=mode, i="kernel": divided_attention_proj(*a, h, m, impl=i),
                      lambda dt, a=args, m=mode: divided_attention_proj(*cast(a, dt), h, m,
                                                                        impl="plain"),
                      cost, None))
    x4 = rn(bs, F_T, N_P, d)
    g2, b2 = ln_params()
    args = [x4, g2, b2, *mlp_params(), 1e-6]
    weights = 2 * d * hid * 2 + (hid + 3 * d) * 4
    rows = bs * F_T * N_P
    cases.append(("K2", f"K2 stats ({bs},8,196,768)",
                  lambda a=args: fused_ln_mlp_residual(*a, emit_stats=True),
                  lambda dt, a=args: fused_ln_mlp_residual(*cast(a, dt), emit_stats=True,
                                                           impl="plain"),
                  (2 * rows * d * 2 + rows * 8 * 4 + weights, 4.0 * rows * d * hid), None))
    x3 = rn(bs, 74, d)
    args = [x3, g2, b2, *mlp_params(), 1e-12]
    cases.append(("K2", f"K2 rows ({bs},74,768)",
                  lambda a=args: fused_ln_mlp_residual(*a),
                  lambda dt, a=args: fused_ln_mlp_residual(*cast(a, dt), impl="plain"),
                  (2 * bs * 74 * d * 2 + weights, 4.0 * bs * 74 * d * hid), None))
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
    for mode in ("space", "time"):
        cases.append(("K5", f"K5 {mode} ({bs1},8,196,2304)",
                      lambda m=mode: divided_attention(qkv_p1, qkv_c1, h, m),
                      lambda dt, m=mode: divided_attention(qkv_p1.to(dt), qkv_c1.to(dt), h, m,
                                                           impl="plain"),
                      (4 * act1 + 2 * bs1 * 4 * d * 2, attention_flops(bs1, mode, 2)), None))
    for mode in ("space", "time"):
        cases.append(("K6", f"K6 {mode} ({bs1},8,196,2304)",
                      lambda m=mode: divided_attention_bwd(qkv_p1, qkv_c1, dop, doc, h, m),
                      lambda dt, m=mode: divided_attention_bwd_plain(
                          *cast([qkv_p1, qkv_c1, dop, doc], dt), h, m),
                      (7 * act1 + 2 * bs1 * 7 * d * 2, attention_flops(bs1, mode, 5)), None))
    return cases


def check_kernels(torch, dev, report):
    for key, label, kern, plain, cost, library in kernel_cases(torch, dev):
        k_out, p_out, a_out = kern(), plain(torch.bfloat16), plain(torch.float32)
        torch.cuda.synchronize()
        k_out, p_out, a_out = (t if isinstance(t, tuple) else (t,)
                               for t in (k_out, p_out, a_out))
        worst = 0.0
        for i, (k, p, a) in enumerate(zip(k_out, p_out, a_out)):
            if k.shape != a.shape or not bool(torch.isfinite(k.float()).all()):
                fail(f"{label} output {i}: shape {tuple(k.shape)} or non-finite values")
            err_k, err_p = maxabs(k, a), maxabs(p, a)
            eps = 1e-2 * float(a.float().abs().max())
            rel = err_k / max(float(a.float().abs().max()), 1e-30)
            kp = maxabs(k, p)
            worst = max(worst, kp)
            ok = err_k <= 2.0 * err_p + eps
            log(f"[kernels] {label} out{i}: |kernel-f32| {err_k:.3e} (rel {rel:.2e}) "
                f"|plain_bf16-f32| {err_p:.3e} |kernel-plain| {kp:.3e} "
                f"tol {2.0 * err_p + eps:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{label} output {i} outside tolerance")
        del k_out, p_out, a_out
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(lambda: plain(torch.bfloat16))
        lib_ms = cuda_time_ms(library) if library is not None else None
        bound_ms, bound_by = bound(*cost)
        log(f"[timing] {label}: kernel {ms:.3f} ms, plain bf16 {plain_ms:.3f} ms, "
            f"library {'-' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {cost[0] / 1e6:.1f} MB, {cost[1] / 1e9:.2f} GFLOP)")
        r = report.setdefault(key, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                    "bound_s": [0.0, 0.0], "library_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], worst)
        # the main paths call K1, K5 and K6 in both modes per block: report
        # the pair; the other kernels report their tower shape (the first
        # case listed)
        if key in ("K1", "K5", "K6") or "ms_set" not in r:
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["bound_s"][0] += cost[0] / HBM_BPS
            r["bound_s"][1] += cost[1] / BF16_FLOPS
            r["library_ms"] = lib_ms
            r["ms_set"] = True


def run_slice(torch, dev, report):
    import numpy as np

    from synchformer_tpu_torch.infer import SyncPredictor
    from synchformer_tpu_torch.models.presets import build_synchformer
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.ops.video import patchify_frames
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict

    t0 = time.perf_counter()
    sd = seeded_state_dict(build_synchformer(S, device="meta"), seed=0)
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (B, S, 16, 224, 224, 3), dtype=np.uint8)
    video = torch.from_numpy(np.ascontiguousarray(patchify_frames(frames))).to(dev)
    pcm = torch.from_numpy((rng.standard_normal((B, S, 10240)) * 0.1).astype(np.float32)).to(dev)
    log(f"[slice] weights + inputs {time.perf_counter() - t0:.1f} s; video {tuple(video.shape)} "
        f"{video.dtype}, pcm {tuple(pcm.shape)}")

    def predictor(dtype, impl):
        m = build_synchformer(S, device=dev)
        load_numpy_state_dict(m, sd)
        return SyncPredictor(m, dev, dtype, impl)

    p32 = predictor(torch.float32, "plain")
    ref_logits = p32.logits(video, pcm).float()
    ref = torch.softmax(ref_logits, -1)
    del p32
    pk = predictor(torch.bfloat16, "kernel")
    pp = predictor(torch.bfloat16, "plain")

    torch.cuda.synchronize()
    _build.launches.clear()
    k_logits = pk.logits(video, pcm).float()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    log(f"[slice] launches in one kernel-path forward: {counts}")
    for key, need in MIN_LAUNCHES.items():
        if counts.get(key, 0) < need:
            fail(f"{key} launched {counts.get(key, 0)} times, expected >= {need}")
        report[key]["launches"] = counts[key]
    p_logits = pp.logits(video, pcm).float()
    k_probs, p_probs = torch.softmax(k_logits, -1), torch.softmax(p_logits, -1)
    for name, t in (("kernel", k_probs), ("plain", p_probs)):
        if t.shape != (B, 21) or not bool(torch.isfinite(t).all()):
            fail(f"{name} path probabilities: shape {tuple(t.shape)} or non-finite")
    err_k, err_p = maxabs(k_probs, ref), maxabs(p_probs, ref)
    lerr_k, lerr_p = maxabs(k_logits, ref_logits), maxabs(p_logits, ref_logits)
    tol = 2.0 * err_p + 5e-3
    log(f"[slice] probs max|kernel-f32| {err_k:.3e}, max|plain_bf16-f32| {err_p:.3e}, "
        f"max|kernel-plain| {maxabs(k_probs, p_probs):.3e}, tol {tol:.3e}; logits "
        f"max|kernel-f32| {lerr_k:.3e}, max|plain_bf16-f32| {lerr_p:.3e}; "
        f"f32 top-1 {ref.argmax(-1).tolist()} kernel top-1 {k_probs.argmax(-1).tolist()}")
    if err_k > tol:
        fail("kernel-path probabilities outside tolerance")

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


def stage1_batch(torch, b: int, s: int, frames=FRAMES) -> dict:
    """One seeded loader batch: uint8 frames (b, s, *frames), PCM (b, s, 10240)."""
    import numpy as np

    rng = np.random.default_rng(2)
    return {"video": torch.from_numpy(rng.integers(0, 256, (b, s, *frames), dtype=np.uint8)),
            "audio": torch.from_numpy((rng.standard_normal((b, s, 10240)) * 0.1)
                                      .astype(np.float32))}


def stage1_trainer(build, state_dict, dev, precision: str, impl: str, remat: bool = False):
    """An AVCLIPTrainer on ``build(remat=..., device=dev)`` loaded with
    ``state_dict``: Stage I's optimiser settings, generator seed 0, flip p 0.5."""
    from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict

    model = build(remat=remat, device=dev)
    load_numpy_state_dict(model, state_dict)
    cfg = {"training": {"seed": 0, "precision": precision, "learning_rate": 1e-4,
                        "weight_decay": 0.2, "warmup": 1000, "total_steps": 100_000,
                        "max_clip_norm": MAX_CLIP, "zero_shot_window": 8},
           "data": {"p_horizontal_flip": 0.5, "p_audio_aug": 0.0}}
    return AVCLIPTrainer(cfg, device=dev, model=model, impl=impl)


def checked_step(tr, batch, what: str) -> dict:
    """One train step's metrics, failing on a non-finite loss or gradient norm
    or a logit scale outside its clamp."""
    import math

    m = tr.train_step(batch)
    if not (m["loss_finite"] and math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
        fail(f"{what}: non-finite loss or gradient norm {m}")
    if not 0.001 <= m["logit_scale"] <= 0.5:
        fail(f"{what}: logit scale {m['logit_scale']} outside [0.001, 0.5]")
    return m


def step_gradients(torch, tr, m) -> dict:
    """The gradient of the step just taken, as Stage I's check reads it: the
    metrics, every parameter's gradient flattened in f32 (``flat``), and the
    leaves that K5 / K6 feed directly (``leaves``), undone from the clip: each
    video block's time and space qkv weight, split into its q, k and v rows
    (at random weights the attention is near uniform and the v rows carry
    most of the norm), each qkv bias whole (its k part is zero in exact math:
    the softmax is shift-invariant), and the video CLS token, whose gradient
    flows through the CLS rows of every divided attention."""
    unclip = max(m["grad_norm"] / MAX_CLIP, 1.0)
    named = dict(tr.model.named_parameters())
    leaves = {}
    for name, p in named.items():
        if STAGE1_LEAVES.fullmatch(name):
            g = p.grad.float() * unclip
            if name.endswith("weight"):
                leaves.update({f"{name}[{part}]": rows for part, rows in zip("qkv", g.chunk(3))})
            else:
                leaves[name] = g
    return {"metrics": m,
            "flat": torch.cat([p.grad.float().flatten() for p in named.values()]),
            "leaves": leaves}


def stage1_agreement(ref: dict, plain: dict, kern: dict) -> list:
    """Hold the kernel path's first step against the f32 run, each check at
    2 x the plain bf16 path's error (the two bf16 paths round at other places
    only inside the kernels). Arguments are step_gradients' records; returns
    the names of the checks that failed.
    - loss, eps 1e-4 x |f32 loss|: the mean of 56 f32 cross-entropies over
      bf16 features; bf16 paths have read 5e-5 from f32, and at random
      weights the loss sits 0.015 above chance (ln 28), so eps is 2% of that;
    - gradient norm, eps 1e-3 x the f32 norm (both bf16 paths read ~0.3%
      low, the same rounding);
    - every leaf of step_gradients, relative L2 error, no eps;
    - 1 - cosine of the whole flattened gradient to the f32 one, no eps."""
    failed = []

    def check(name, err_k, err_p, eps):
        tol = 2.0 * err_p + eps
        ok = err_k <= tol
        if not ok:
            failed.append(name)
        return ok, tol

    for key, rel_eps in (("loss", 1e-4), ("grad_norm", 1e-3)):
        r = ref["metrics"][key]
        err_k, err_p = abs(kern["metrics"][key] - r), abs(plain["metrics"][key] - r)
        ok, tol = check(key, err_k, err_p, rel_eps * abs(r))
        log(f"[stage1] {key}: |kernel-f32| {err_k:.3e}, |plain_bf16-f32| {err_p:.3e}, "
            f"tol {tol:.3e} {'ok' if ok else 'FAIL'}")

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    worst, bad = (0.0, ""), 0
    for name, g in ref["leaves"].items():
        err_k, err_p = rel(kern["leaves"][name], g), rel(plain["leaves"][name], g)
        ok, _ = check(name, err_k, err_p, 0.0)
        bad += not ok
        worst = max(worst, (err_k / max(err_p, 1e-30), f"{name} {err_k:.3e} vs {err_p:.3e}"))
    log(f"[stage1] {len(ref['leaves'])} K5/K6-fed gradient leaves, relative L2 error to "
        f"f32 within 2 x plain bf16's: {len(ref['leaves']) - bad} ok, {bad} FAIL; worst "
        f"ratio {worst[0]:.3f} ({worst[1]})")

    def one_minus_cos(a, b):
        a, b = a.double(), b.double()
        return 1.0 - float((a * b).sum() / (a.norm() * b.norm()))

    err_k, err_p = one_minus_cos(kern["flat"], ref["flat"]), one_minus_cos(plain["flat"],
                                                                           ref["flat"])
    ok, tol = check("cosine", err_k, err_p, 0.0)
    log(f"[stage1] gradient 1 - cosine to f32: kernel {err_k:.3e}, plain bf16 {err_p:.3e}, "
        f"tol {tol:.3e} {'ok' if ok else 'FAIL'}")
    return failed


def run_stage1(torch, dev, report):
    from synchformer_tpu_torch.models.presets import build_avclip
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.utils.convert import seeded_state_dict

    t0 = time.perf_counter()
    sd = seeded_state_dict(build_avclip(device="meta"), seed=0)
    batch = stage1_batch(torch, B1, S)
    log(f"[stage1] weights + batch {time.perf_counter() - t0:.1f} s; video "
        f"{tuple(batch['video'].shape)} uint8, audio {tuple(batch['audio'].shape)}")

    def trainer(precision, impl, remat=False):
        return stage1_trainer(build_avclip, sd, dev, precision, impl, remat)

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
        log(f"[stage1] {what} first step: loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.6f}, logit_scale {m['logit_scale']:.6f}, {secs:.2f} s, "
            f"peak memory {gib(peak)}")
        return step_gradients(torch, tr, m), peak

    t0 = time.perf_counter()
    tr = trainer("fp32", "plain", remat=True)
    ref, _ = first_step(tr, "(c) f32 plain, remat")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[stage1] (c) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    resident = torch.cuda.memory_allocated()
    trainers = {"kernel": trainer("amp", "kernel")}
    _build.launches.clear()
    kern, k_peak = first_step(trainers["kernel"], "(a) bf16 kernel", resident)
    counts = dict(_build.launches)
    log(f"[stage1] launches in one kernel-path step: {counts}")
    for key, need in STAGE1_LAUNCHES.items():
        if counts.get(key, 0) != need:
            fail(f"Stage I: {key} launched {counts.get(key, 0)} times, expected {need}")
    for key in ("K5", "K6"):
        report[key]["launches"] = counts.get(key, 0)
    resident = torch.cuda.memory_allocated()
    trainers["plain"] = trainer("amp", "plain")
    plain, p_peak = first_step(trainers["plain"], "(b) bf16 plain", resident)
    log(f"[stage1] (a) and (b) first steps {time.perf_counter() - t0:.1f} s")

    # 3 steps per window, in the order plain, kernel, kernel, plain
    times = {"plain": [], "kernel": []}
    for impl in ("plain", "kernel", "kernel", "plain"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            checked_step(trainers[impl], batch, impl)
        torch.cuda.synchronize()
        times[impl].append((time.perf_counter() - t) / 3)

    _build.launches.clear()
    out = trainers["kernel"].eval_step(batch)
    eval_counts = dict(_build.launches)
    if (out["vfeat"].shape != (B1, S, D) or not bool(torch.isfinite(out["loss"]))
            or not bool(torch.isfinite(out["vfeat"]).all())):
        fail("Stage I eval step: features of the wrong shape or non-finite")
    log(f"[stage1] eval step (launches {eval_counts}): loss {out['loss'].item():.6f}, "
        f"zero-shot precision {out['precision'].item():.4f} (window 8 of {S} segments)")
    del trainers, out

    failed = stage1_agreement(ref, plain, kern)
    if failed:
        fail(f"Stage I kernel-path first step outside tolerance: {failed}")
    for what, peak in (("kernel", k_peak), ("plain", p_peak)):
        best = min(times[what]) * 1e3
        log(f"[timing] stage1 {what} path: {best:.1f} ms/step of {B1} clips x {S} segments "
            f"= {B1 * 1e3 / best:.3f} samples/s (runs "
            f"{[round(t * 1e3, 1) for t in times[what]]} ms); peak memory {gib(peak)}")


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

    report: dict = {}
    for name, phase in (("kernels", check_kernels), ("slice", run_slice),
                        ("stage1", run_stage1)):
        t0 = time.perf_counter()
        phase(torch, dev, report)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[phase] {name} {time.perf_counter() - t0:.1f} s")
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
