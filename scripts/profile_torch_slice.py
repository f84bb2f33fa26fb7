"""Where the time of the PyTorch port's sync-inference slice goes, on one
NVIDIA GPU.

    python scripts/profile_torch_slice.py [--out build/profile_torch_slice.json]

Builds the full-width Synchformer (S=14, ViT-B towers, seeded weights) as
chip_smoke.py does and, after a warm-up, measures one forward of each path
(impl='kernel' and impl='plain') in bf16:
- the forward's time on the stream (CUDA events around it);
- the stream time spent inside each kernel wrapper the models call (K1-K4;
  CUDA events recorded around every call, summed per wrapper; on the plain
  path these are the plain versions the video tower calls), the rest being
  the PyTorch ops between them;
- from torch.profiler, the device time of the top CUDA kernels by name, and
  the share of the span from the first kernel to the last in which none ran.
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

from synchformer_tpu_torch.infer import SyncPredictor  # noqa: E402
from synchformer_tpu_torch.models import layers, motionformer  # noqa: E402
from synchformer_tpu_torch.models.presets import build_synchformer  # noqa: E402
from synchformer_tpu_torch.ops.video import patchify_frames  # noqa: E402
from synchformer_tpu_torch.utils.convert import (  # noqa: E402
    load_numpy_state_dict,
    seeded_state_dict,
)

B, S = 8, 14
# (module, attribute) of each kernel wrapper as the models call it
WRAPPERS = {
    "K1": [(motionformer, "divided_attention_proj")],
    "K2": [(motionformer, "fused_ln_mlp_residual"), (layers, "fused_ln_mlp_residual")],
    "K3": [(layers, "standard_attention")],
    "K4": [(layers, "fused_cls_pool_tokens")],
}


def timed_wrappers(spans):
    """Wrap each kernel wrapper so that every call records a CUDA event pair
    into spans[key]."""
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


def stream_ms(pred, video, pcm):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pred(video, pcm)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def profile_forward(pred, video, pcm, top: int = 12):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred(video, pcm)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    if kernels:
        first = min(e.time_range.start for e in kernels)
        last = max(e.time_range.end for e in kernels)
        span_us = last - first
    else:
        span_us = 0
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
    ap.add_argument("--out", default="build/profile_torch_slice.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the GPU")
    dev = torch.device("cuda", 0)
    sd = seeded_state_dict(build_synchformer(S, device="meta"), seed=0)
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (B, S, 16, 224, 224, 3), dtype=np.uint8)
    video = torch.from_numpy(np.ascontiguousarray(patchify_frames(frames))).to(dev)
    pcm = torch.from_numpy((rng.standard_normal((B, S, 10240)) * 0.1).astype(np.float32)).to(dev)

    spans = collections.defaultdict(list)
    timed_wrappers(spans)
    result = {"device": torch.cuda.get_device_name(0), "batch": B, "segments": S}
    for impl in ("kernel", "plain"):
        model = build_synchformer(S, device=dev)
        load_numpy_state_dict(model, sd)
        pred = SyncPredictor(model, dev, torch.bfloat16, impl)
        for _ in range(2):
            stream_ms(pred, video, pcm)
        spans.clear()
        total = stream_ms(pred, video, pcm)
        inside = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}
        calls = {k: len(v) for k, v in spans.items()}
        prof = profile_forward(pred, video, pcm)
        result[impl] = {"forward_ms": total, "clips_per_s": B / total * 1e3,
                        "wrapper_ms": inside, "calls": calls,
                        "outside_wrappers_ms": total - sum(inside.values()), "profile": prof}
        del pred, model
        torch.cuda.empty_cache()
        print(f"[{impl}] forward {total:.1f} ms ({B / total * 1e3:.2f} clips/s); inside "
              f"wrappers {json.dumps({k: round(v, 2) for k, v in inside.items()})}; "
              f"kernel busy {prof['kernel_busy_ms']:.1f} of {prof['kernel_span_ms']:.1f} ms "
              f"span, {prof['kernels']} kernels", flush=True)
        for name, ms in prof["top"]:
            print(f"    {ms:9.2f} ms  {name}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
