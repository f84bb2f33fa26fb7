#!/usr/bin/env python3
"""Drive the PyTorch port's sync-inference path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs:
1. device and build: torch / CUDA versions, the card's name and power limit,
   the seconds nvcc took for the kernels (built into build/torch_kernels/).
2. per kernel (K1-K4) at the main path's shapes in bf16: the kernel against
   its plain PyTorch version, both held against a plain f32 anchor on the
   same inputs. Tolerance: kernel error <= 2 x plain-bf16 error + eps, with
   eps = 1e-2 x max|anchor| (bf16 keeps 8 bits; the two sides round at other
   places).
3. the full-width slice: Synchformer S=14 (ViT-B towers of 12 layers, D=768,
   3-layer GlobalTransformer), B=8, seeded weights, through
   SyncPredictor(impl='kernel') and (impl='plain') in bf16, both against an
   f32 plain run. Launch counters are zeroed before the kernel-path run and
   must show K1 >= 24, K2 >= 24, K3 >= 12, K4 >= 2.
4. timings: clips/s of the slice on both paths and each kernel against its
   plain version (CUDA events, after warm-up).
The line before the last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}. Any failed phase raises, so the exit code is
non-zero and no result line is printed.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

REPLACES = {
    "K1": "synchformer_tpu/ops/pallas/divided_attention.py:478",
    "K2": "synchformer_tpu/ops/pallas/fused_rows.py:188",
    "K3": "synchformer_tpu/ops/pallas/standard_attention.py:62",
    "K4": "synchformer_tpu/ops/pallas/cls_pool.py:181",
}
SOURCES = {
    "K1": "synchformer_tpu_torch/csrc/divided_attention.cu",
    "K2": "synchformer_tpu_torch/csrc/ln_mlp.cu",
    "K3": "synchformer_tpu_torch/csrc/standard_attention.cu",
    "K4": "synchformer_tpu_torch/csrc/cls_pool.cu",
}
NAMES = {
    "K1": "divided_attention_proj",
    "K2": "fused_ln_mlp_residual",
    "K3": "standard_attention",
    "K4": "fused_cls_pool_tokens",
}
MIN_LAUNCHES = {"K1": 24, "K2": 24, "K3": 12, "K4": 2}
B, S = 8, 14


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


def kernel_cases(torch, dev):
    """(key, label, kernel fn, plain fn on given dtype) at main-path shapes."""
    from synchformer_tpu_torch.ops.kernels.cls_pool import fused_cls_pool_tokens
    from synchformer_tpu_torch.ops.kernels.divided_attention import divided_attention_proj
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
    wo, bo = rn(d, d, std=0.02), rn(d, std=0.02, dtype=torch.float32)
    qkv_p, qkv_c = rn(112, 8, 196, 3 * d), rn(112, 1, 3 * d)
    res = rn(112, 8, 196, d)
    for mode in ("space", "time"):
        args = [qkv_p, qkv_c, res, wo, bo]
        cases.append(("K1", f"K1 {mode} (112,8,196,2304)",
                      lambda a=args, m=mode, i="kernel": divided_attention_proj(*a, h, m, impl=i),
                      lambda dt, a=args, m=mode: divided_attention_proj(*cast(a, dt), h, m,
                                                                        impl="plain")))
    x4 = rn(112, 8, 196, d)
    g2, b2 = ln_params()
    args = [x4, g2, b2, *mlp_params(), 1e-6]
    cases.append(("K2", "K2 stats (112,8,196,768)",
                  lambda a=args: fused_ln_mlp_residual(*a, emit_stats=True),
                  lambda dt, a=args: fused_ln_mlp_residual(*cast(a, dt), emit_stats=True,
                                                           impl="plain")))
    x3 = rn(112, 74, d)
    args = [x3, g2, b2, *mlp_params(), 1e-12]
    cases.append(("K2", "K2 rows (112,74,768)",
                  lambda a=args: fused_ln_mlp_residual(*a),
                  lambda dt, a=args: fused_ln_mlp_residual(*cast(a, dt), impl="plain")))
    qkv = rn(112, 74, 3 * d)
    cases.append(("K3", "K3 (112,74,2304)",
                  lambda: standard_attention(qkv, h),
                  lambda dt: standard_attention(qkv.to(dt), h, impl="plain")))
    for label, shape in (("spatial (896,196,768)", (896, 196, d)),
                         ("frequency (672,12,768)", (672, 12, d))):
        g1, b1 = ln_params()
        g2_, b2_ = ln_params()
        args = [rn(*shape), rn(d, std=0.02, dtype=torch.float32), g1, b1,
                rn(3 * d, d, std=0.02), rn(3 * d, std=0.02, dtype=torch.float32),
                rn(d, d, std=0.02), rn(d, std=0.02, dtype=torch.float32), g2_, b2_,
                *mlp_params()]
        cases.append(("K4", f"K4 {label}",
                      lambda a=args: fused_cls_pool_tokens(*a, num_heads=h, eps=1e-6),
                      lambda dt, a=args: fused_cls_pool_tokens(*cast(a, dt), num_heads=h,
                                                               eps=1e-6, impl="plain")))
    return cases


def check_kernels(torch, dev, report):
    for key, label, kern, plain in kernel_cases(torch, dev):
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
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(lambda: plain(torch.bfloat16))
        log(f"[timing] {label}: kernel {ms:.3f} ms, plain bf16 {plain_ms:.3f} ms")
        r = report.setdefault(key, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], worst)
        # the main path calls K1 in both modes per block: report the pair;
        # the other kernels report their tower shape (the first case listed)
        if key == "K1" or "ms_set" not in r:
            r["ms"] += ms
            r["plain_ms"] += plain_ms
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
    check_kernels(torch, dev, report)
    run_slice(torch, dev, report)
    kernels = []
    for key in ("K1", "K2", "K3", "K4"):
        r = report[key]
        kernels.append({"name": NAMES[key], "route": "cuda", "source": SOURCES[key],
                        "replaces": REPLACES[key], "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
