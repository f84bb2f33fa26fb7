"""Compare the main path's times of two or more trees of this repo on one
NVIDIA card, in turns within one call (for a change against its parent:
unpack the parent with `git archive` into a directory that .gitignore lists,
then run parent, change, change, parent).

Each turn is a process of its own, started in the tree, which imports that
tree's chip_smoke.py and builds its kernels into the tree's own build/; by
default it runs chip_smoke's phase 2 (every kernel case at the main path's
shapes, checked against its plain version and timed), phase 3 (sync inference),
phase 4 (the Stage I step, 12 heads of 64) and phase 6 / 7 (the Stage I step
at 8 heads of 96, on 'pallas' and 'pallas_fused'), each as chip_smoke.py
runs it. Every `[timing]` line is then read back: a kernel case's kernel ms,
a path's ms/batch or ms/step. A turn that fails stops the comparison.

    python3 scripts/compare_trees.py --out chiprun_out/compare build/parent . . build/parent
    python3 scripts/compare_trees.py --phases run_stage1 -- build/parent . . build/parent

Prints, for every label that every turn timed, the ms of each turn in turn
order, then the card's name and power limit; writes each turn's log and a
JSON summary ({"trees": [...], "times": {label: [ms per turn]}}) under --out.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

PHASES = ("check_kernels", "run_slice", "run_stage1", "run_stage1_8head")
KERNEL_LINE = re.compile(r"^\[timing\] (.+?): kernel ([0-9.]+) ms")
PATH_LINE = re.compile(r"^\[timing\] (.+? path): ([0-9.]+) ms/(batch|step)")


def worker(phases) -> int:
    """One turn, in the tree that is the working directory: ``phases``,
    chip_smoke functions by name."""
    root = os.getcwd()
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from synchformer_tpu_torch.ops.kernels import _build

    for mod in (cs, _build):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise SystemExit(f"{mod.__name__} comes from {mod.__file__}, not from {root}")
    cs.log(f"[tree] {root}; {cs.smi_line()}")
    cs.log(f"[build] {_build.build_all():.1f} s")
    dev = torch.device("cuda", 0)
    report = {key: {"launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                    "bound_s": [0.0, 0.0], "library_ms": None} for key in cs.KEYS}
    for name in phases:
        t0 = time.perf_counter()
        getattr(cs, name)(torch, dev, report)
        cs.log(f"[phase] {name} {time.perf_counter() - t0:.1f} s")
    return 0


def read_times(text: str) -> dict:
    times = {}
    for line in text.splitlines():
        m = KERNEL_LINE.match(line) or PATH_LINE.match(line)
        if m and " by launch" not in m.group(1):
            times[m.group(1)] = float(m.group(2))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/compare")
    ap.add_argument("--timeout", type=int, default=600, help="seconds a turn may take")
    ap.add_argument("--phases", nargs="+", default=list(PHASES), choices=PHASES,
                    help="the chip_smoke phases each turn runs (default: all four)")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    script = os.path.abspath(__file__)
    turns = []
    for i, tree in enumerate(args.trees):
        log_path = os.path.join(args.out, f"turn{i}.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as f:
            rc = subprocess.run([sys.executable, script, "--worker", *args.phases], cwd=tree,
                                stdout=f, stderr=subprocess.STDOUT,
                                timeout=args.timeout).returncode
        print(f"[turn {i}] {tree}: rc {rc}, {time.perf_counter() - t0:.1f} s, log {log_path}",
              flush=True)
        if rc != 0:
            with open(log_path) as f:
                print(f.read()[-3000:])
            return rc
        with open(log_path) as f:
            turns.append(read_times(f.read()))
    labels = [k for k in turns[0] if all(k in t for t in turns[1:])]
    summary = {"trees": args.trees, "times": {k: [t[k] for t in turns] for k in labels}}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for k in labels:
        print(f"[compare] {k}: " + " / ".join(f"{t[k]:.3f}" for t in turns), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[2:]) if sys.argv[1:2] == ["--worker"] else main())
