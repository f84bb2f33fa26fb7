"""Show that chip_smoke.py's Stage I check fails a wrong K5 or K6.

    python scripts/stage1_planted_faults.py            # full width, one NVIDIA GPU
    python scripts/stage1_planted_faults.py --tiny --device cpu   # a dry run

Takes the Stage I first step as chip_smoke.py's phase 4 does: (c) f32 plain
with remat and (b) bf16 plain, then the bf16 kernel path once per planted
fault, each from the same seeded weights, batch and generator seed, and holds
each kernel-path step against (c) and (b) with chip_smoke.stage1_agreement.
A fault is a wrapper around a kernel's Python entry where DividedAttentionFn
calls it; the code under test is not edited:
- none: the control, which must pass;
- k6_dk_zero: K6 returns a zero dk (patches and CLS);
- k6_cls_key_zero: K6 returns a zero dk and dv for the CLS key only;
- k6_mode_swapped: K6 runs the other mode's backward (space for time and back);
- k5_feature_order: K5 returns its outputs in dh-major feature order, not
  head-major.
Prints one line per fault with the checks that failed, and exits non-zero
unless the control passed and every fault failed at least one check.
--tiny takes the CPU tests' tiny AVCLIP (drop-path 0.2) at B=2, S=2: on CPU
tensors the kernel wrappers run their plain versions, which the faults wrap
all the same.
"""
from __future__ import annotations

import argparse
import functools
import gc
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from synchformer_tpu_torch.models.presets import build_avclip, build_tiny_avclip  # noqa: E402
from synchformer_tpu_torch.ops.kernels import divided_attention_bwd as dab  # noqa: E402
from synchformer_tpu_torch.utils.convert import seeded_state_dict  # noqa: E402


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


FAULTS = {"none": None, "k6_dk_zero": k6_dk_zero, "k6_cls_key_zero": k6_cls_key_zero,
          "k6_mode_swapped": k6_mode_swapped, "k5_feature_order": k5_feature_order}


def planted(fault):
    """Context: the fault's wrapper in place of K5's or K6's entry."""
    fwd, bwd = dab.divided_attention, dab.divided_attention_bwd
    name = "divided_attention" if fault is k5_feature_order else "divided_attention_bwd"

    class _Ctx:
        def __enter__(self):
            if fault is not None:
                setattr(dab, name, functools.partial(fault, fwd, bwd))

        def __exit__(self, *exc):
            dab.divided_attention, dab.divided_attention_bwd = fwd, bwd

    return _Ctx()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu (with --tiny) for a dry run")
    if args.tiny:
        build = functools.partial(build_tiny_avclip, drop_path_rate=0.2)
        batch = chip_smoke.stage1_batch(torch, 2, 2, (4, 32, 32, 3))
    else:
        build = build_avclip
        batch = chip_smoke.stage1_batch(torch, chip_smoke.B1, chip_smoke.S)
    if dev.type == "cuda":
        chip_smoke.log(f"[device] {chip_smoke.smi_line()}")
    sd = seeded_state_dict(build(device="meta"), seed=0)

    def first_step(precision, impl, remat=False, fault=None):
        t = time.perf_counter()
        tr = chip_smoke.stage1_trainer(build, sd, dev, precision, impl, remat)
        with planted(fault):
            m = chip_smoke.checked_step(tr, batch, f"{precision} {impl}")
        rec = chip_smoke.step_gradients(torch, tr, m)
        del tr
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        chip_smoke.log(f"[step] {precision} {impl}: loss {m['loss']:.6f}, grad_norm "
                       f"{m['grad_norm']:.6f} ({time.perf_counter() - t:.1f} s)")
        return rec

    ref = first_step("fp32", "plain", remat=True)
    plain = first_step("amp", "plain")
    caught = {}
    for name, fault in FAULTS.items():
        chip_smoke.log(f"[fault] {name}")
        kern = first_step("amp", "kernel", fault=fault)
        caught[name] = chip_smoke.stage1_agreement(ref, plain, kern)
        del kern
        chip_smoke.log(f"[fault] {name}: {len(caught[name])} checks failed: "
                       f"{caught[name][:6]}{' ...' if len(caught[name]) > 6 else ''}")
    ok = not caught["none"] and all(caught[n] for n in FAULTS if n != "none")
    chip_smoke.log(f"[result] control passed: {not caught['none']}; every fault caught: "
                   f"{all(caught[n] for n in FAULTS if n != 'none')}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
