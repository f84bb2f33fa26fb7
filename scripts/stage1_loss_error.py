"""Where a bf16 Stage I loss's error against f32 comes from, on one NVIDIA
card: chip_smoke.py phase 18 (c)'s model (2.56 s segments, B = 2) at S
segments a clip, over seeded batches.

For each batch, the first train step's forward (train mode, the trainer's
flips drawn from a generator reset to seed 0, as every path's first step
draws them; no update) on three AVCLIPTrainers loaded with the same seeded
weights: f32 plain (remat), bf16 plain and bf16 kernel. Against f32, for
each bf16 path:
- dL: the loss as the step computes it (the similarity product in bf16);
- dL64: the loss recomputed in float64 from each path's features, and lin,
  its first-order prediction sum(G * E), G = dL/dS at the f32 similarities
  S = v a^T / T, E = S_path - S_f32 (float64): what the features' errors
  alone move; round = dL - dL64: what rounding the similarity product to
  bf16 moves (less the f32 path's own rounding, printed as `f32 product`);
- |cos|: the mean |v_i . a_j| of the f32 features (bf16 spaces values
  near it by 2^-8 of their power of two);
- the features' relative errors: whole (B*S, D) rows, their batch mean
  (the part every row shares) and the rows less that mean (the part that
  tells samples apart, which alone moves S's softmax);
- E entry by entry: rms, the mean of its diagonal (the positives) less the
  mean of each row's entries (what a near-uniform softmax reads).
Over the seeds: the mean of each |quantity|, and in how many seeds phase 4's
loss rule (|dL| <= 2 x the other bf16 path's |dL| + 1e-4 x the f32 loss)
holds the kernel path against plain, and plain against the kernel path.

    python3 scripts/stage1_loss_error.py --segments 4 8 --seeds 2-11

Prints one `[loss_error]` line a path and batch, then the means over seeds and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def seeds(text: str) -> list:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def infonce64(v, a, scale):
    """The symmetric InfoNCE in float64 and its gradient with respect to the
    v2a similarities (the a2v matrix is its transpose): (loss, G)."""
    import torch

    s = (v @ a.t()) / scale
    n = s.shape[0]
    eye = torch.eye(n, dtype=s.dtype, device=s.device)
    p_v2a, p_a2v = s.softmax(-1), s.t().softmax(-1)
    loss = 0.5 * (-(s.diagonal() - s.logsumexp(-1)).mean()
                  - (s.diagonal() - s.t().logsumexp(-1)).mean())
    grad = 0.5 * ((p_v2a - eye) + (p_a2v - eye).t()) / n
    return loss, grad, s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--segments", type=int, nargs="+", default=[4])
    ap.add_argument("--seeds", type=seeds, default=seeds("2-11"))
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.utils.convert import seeded_state_dict

    print(f"[loss_error] build {_build.build_all():.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    build = cs.registry_build(cs.segment_stage1_node())
    sd = seeded_state_dict(build(device="meta"), seed=0)
    frames = (cs.P18_RAW_FRAMES, 224, 224, 3)
    paths = (("f32", "fp32", "plain", True), ("plain", "amp", "plain", False),
             ("kernel", "amp", "kernel", False))
    for s in args.segments:
        trainers = {name: cs.stage1_trainer(build, sd, dev, prec, impl, remat,
                                            mel_t=cs.P18_MEL_T, window=min(8, s))
                    for name, prec, impl, remat in paths}
        rows, losses = {"plain": [], "kernel": []}, []
        for seed in args.seeds:
            rng = np.random.default_rng(seed)
            batch = {"video": torch.from_numpy(rng.integers(0, 256, (cs.B1, s, *frames),
                                                            dtype=np.uint8)),
                     "audio": torch.from_numpy((rng.standard_normal((cs.B1, s, cs.P18_SAMPLES))
                                                * 0.1).astype(np.float32))}
            out = {}
            for name, tr in trainers.items():
                tr.generator.manual_seed(0)
                tr.model.train()
                with torch.no_grad():
                    vis, aud = tr.prepare(batch, train=True)
                    loss, v, a = tr.model(vis, aud, tr.impl, deterministic=False,
                                          generator=tr.generator)
                out[name] = (float(loss), v.double(), a.double(), tr.model.scale().double())
            l32, v32, a32, scale = out["f32"]
            losses.append(abs(l32))
            ref64, grad, s32 = infonce64(v32, a32, scale)
            feats32 = torch.cat([v32, a32], 1)
            mean32 = feats32.mean(0, keepdim=True)

            def rel(x, y):
                return float((x - y).norm() / y.norm())

            for name in ("plain", "kernel"):
                lp, vp, ap_, _ = out[name]
                l64, _, sp = infonce64(vp, ap_, scale)
                err = sp - s32
                feats = torch.cat([vp, ap_], 1)
                mean = feats.mean(0, keepdim=True)
                d64 = float(l64 - ref64)
                r = dict(dL=lp - l32, dL64=d64, round=lp - l32 - d64, lin=float((grad * err).sum()),
                         feat=rel(feats, feats32), mean=rel(mean, mean32),
                         resid=rel(feats - mean, feats32 - mean32),
                         e_rms=float(err.pow(2).mean().sqrt()),
                         e_contrast=float(err.diagonal().mean() - err.mean()))
                rows[name].append(r)
                print(f"[loss_error] S={s} seed {seed} {name}: dL {r['dL']:+.3e} dL64 "
                      f"{r['dL64']:+.3e} round {r['round']:+.3e} lin {r['lin']:+.3e}; "
                      f"|cos| {float((s32 * scale).abs().mean()):.3e}; "
                      f"features rel {r['feat']:.3e}, "
                      f"batch mean {r['mean']:.3e}, rows less the mean {r['resid']:.3e} "
                      f"(f32: |rows - mean| / |rows| "
                      f"{float((feats32 - mean32).norm() / feats32.norm()):.3e}); E rms "
                      f"{r['e_rms']:.3e}, diag - mean {r['e_contrast']:+.3e} "
                      f"(f32 loss {l32:.6f}, f32 product {l32 - float(ref64):+.1e}, scale "
                      f"{float(scale):.4f})", flush=True)
        pairs = list(zip(rows["kernel"], rows["plain"], losses))
        held = {"kernel": sum(abs(k["dL"]) <= 2 * abs(p["dL"]) + 1e-4 * ls for k, p, ls in pairs),
                "plain": sum(abs(p["dL"]) <= 2 * abs(k["dL"]) + 1e-4 * ls for k, p, ls in pairs)}
        larger = sum(abs(k["dL"]) > abs(p["dL"]) for k, p, _ in pairs)
        for name, rs in rows.items():
            keys = rs[0].keys()
            print(f"[loss_error] S={s} {name} over {len(rs)} seeds: "
                  + ", ".join(f"mean |{k}| {np.mean([abs(x[k]) for x in rs]):.3e}" for k in keys)
                  + f"; phase 4's loss rule against the other path held in {held[name]}",
                  flush=True)
        print(f"[loss_error] S={s}: the kernel path's |dL| larger than plain's in {larger} of "
              f"{len(pairs)}", flush=True)
        del trainers
        torch.cuda.empty_cache()
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
