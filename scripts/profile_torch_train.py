"""Where the time of the PyTorch port's Stage I training step goes, on one
NVIDIA GPU.

    python scripts/profile_torch_train.py [--out build/profile_torch_train.json]

Builds the full-width AVCLIP (ViT-B towers, drop-path 0.2, seeded weights)
and one seeded batch (B=2, S=14) as chip_smoke.py does, one trainer per bf16
path (impl='kernel' and impl='plain', both resident), and after two warm-up
steps each measures trainer steps split into their parts on the stream (CUDA
events recorded by wrappers around what the step calls): device prep,
forward, backward, clip + AdamW, in the order kernel, plain, plain, kernel,
keeping each path's best step. Each kernel wrapper's stream
time inside a step (forward calls, and K6 in the backward) is summed with
CUDA events around its calls. One more step per path runs under
torch.profiler for the device time of the top CUDA kernels by name and the
share of the span from the first kernel to the last in which none ran.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from synchformer_tpu_torch.models import layers, motionformer  # noqa: E402
from synchformer_tpu_torch.models.presets import build_avclip  # noqa: E402
from synchformer_tpu_torch.ops.kernels import divided_attention_bwd  # noqa: E402
from synchformer_tpu_torch.train import stage_clip, step  # noqa: E402
from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer  # noqa: E402
from synchformer_tpu_torch.utils.convert import (  # noqa: E402
    load_numpy_state_dict,
    seeded_state_dict,
)

B, S = 2, 14
# (module, attribute) of each wrapper as the training step calls it
WRAPPERS = {
    "K5 fwd": [(divided_attention_bwd, "divided_attention")],
    "K6 bwd": [(divided_attention_bwd, "divided_attention_bwd")],
    "K2": [(motionformer, "fused_ln_mlp_residual"), (layers, "fused_ln_mlp_residual")],
    "K3": [(layers, "standard_attention")],
    "K4": [(layers, "fused_cls_pool_tokens")],
}


def timed_wrappers(spans):
    def wrap(key, fn):
        def inner(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[key].append((start, end))
            return out
        return inner

    for key, sites in WRAPPERS.items():
        for mod, name in sites:
            setattr(mod, name, wrap(key, getattr(mod, name)))


def split_step(tr: AVCLIPTrainer, batch) -> dict:
    """One ``tr.train_step(batch)`` with CUDA events at its parts' edges, from
    wrappers around what the step calls: the trainer's ``prepare`` (start, end
    of prep), the model's forward (its end), the gradient clip (which starts
    once the backward and the zero fill of unused gradients are done) and
    ``avclip_train_step`` itself (end of the AdamW update and clamp). Returns
    ms per part."""
    ev = {}

    def mark(name):
        ev[name] = torch.cuda.Event(enable_timing=True)
        ev[name].record()

    def around(fn, before=None, after=None):
        def inner(*args, **kwargs):
            if before:
                mark(before)
            out = fn(*args, **kwargs)
            if after:
                mark(after)
            return out
        return inner

    originals = (step.clip_grads_by_global_norm_, stage_clip.avclip_train_step)
    tr.prepare = around(tr.prepare, "start", "prep")
    tr.model.forward = around(tr.model.forward, after="forward")
    step.clip_grads_by_global_norm_ = around(originals[0], before="backward")
    stage_clip.avclip_train_step = around(originals[1], after="update")
    try:
        tr.train_step(batch)
    finally:
        del tr.prepare, tr.model.forward
        step.clip_grads_by_global_norm_, stage_clip.avclip_train_step = originals
    torch.cuda.synchronize()
    spans = (("prep", "start", "prep"), ("forward", "prep", "forward"),
             ("backward", "forward", "backward"), ("clip_adamw", "backward", "update"),
             ("step", "start", "update"))
    return {part: ev[a].elapsed_time(ev[b]) for part, a, b in spans}


def profile_step(tr, batch, top: int = 16):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
               if kernels else 0)
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:90]] += e.time_range.elapsed_us() / 1e3
    return {"wall_ms": wall_ms, "kernel_busy_ms": busy_us / 1e3,
            "kernel_span_ms": span_us / 1e3,
            "idle_share_of_span": 1.0 - busy_us / span_us if span_us else None,
            "kernels": len(kernels),
            "top": [[n, ms] for n, ms in by_name.most_common(top)]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile_torch_train.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the GPU")
    dev = torch.device("cuda", 0)
    sd = seeded_state_dict(build_avclip(device="meta"), seed=0)
    rng = np.random.default_rng(2)
    batch = {"video": torch.from_numpy(rng.integers(0, 256, (B, S, 16, 224, 224, 3),
                                                    dtype=np.uint8)),
             "audio": torch.from_numpy((rng.standard_normal((B, S, 10240)) * 0.1)
                                       .astype(np.float32))}
    cfg = {"training": {"seed": 0, "precision": "amp"}, "data": {"p_audio_aug": 0.0}}
    spans = collections.defaultdict(list)
    timed_wrappers(spans)
    result = {"device": torch.cuda.get_device_name(0), "batch": B, "segments": S}
    trainers, peaks = {}, {}
    for impl in ("kernel", "plain"):
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = build_avclip(device=dev)
        load_numpy_state_dict(model, sd)
        trainers[impl] = AVCLIPTrainer(cfg, device=dev, model=model, impl=impl)
        for _ in range(2):
            trainers[impl].train_step(batch)
        peaks[impl] = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    best, inside, calls = {}, {}, {}
    for impl in ("kernel", "plain", "plain", "kernel"):
        spans.clear()
        parts = split_step(trainers[impl], batch)
        if impl not in best or parts["step"] < best[impl]["step"]:
            best[impl] = parts
            inside[impl] = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}
            calls[impl] = {k: len(v) for k, v in spans.items()}
    for impl, tr in trainers.items():
        prof = profile_step(tr, batch)
        parts = best[impl]
        result[impl] = {"parts_ms": parts, "wrapper_ms": inside[impl], "calls": calls[impl],
                        "peak_gib_above_resident": peaks[impl], "profile": prof}
        print(f"[{impl}] step {parts['step']:.1f} ms: "
              f"{json.dumps({k: round(v, 2) for k, v in parts.items()})}; wrappers "
              f"{json.dumps({k: round(v, 2) for k, v in inside[impl].items()})} "
              f"calls {calls[impl]}; peak {peaks[impl]:.2f} GiB; kernel busy "
              f"{prof['kernel_busy_ms']:.1f} of {prof['kernel_span_ms']:.1f} ms span "
              f"(idle {prof['idle_share_of_span']:.4f}), {prof['kernels']} kernels", flush=True)
        for name, ms in prof["top"]:
            print(f"    {ms:9.2f} ms  {name}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
