"""What recording the port's spans costs, and what they show without the
profiler, on the benchmark's cells.

    python3 scripts/trace_overhead.py --out build/trace_overhead.json
    python3 scripts/trace_overhead.py --tiny --out build/trace_overhead.json  # CPU rehearsal

For each cell (benchmark/workloads/*.json, set up as the benchmark sets it
up, from ``--seed``): windows of ``--units`` units back to back, in turns, with
recording off, inside ``trace.recording()`` and under torch.profiler
(CPU and CUDA activities, ``--profiled`` units); each mode's ms a unit
(median of the units' host times, and the windows' means). From the record
of each recorded mode: every span's host and stream ms a unit by name, and
``host_syncs`` a unit. Then one unit under
``torch.cuda.set_sync_debug_mode("warn")``: where each synchronisation
warning fell, against the ``host_syncs`` counted in the same unit. From the
profiled window: whether each ``aten::_local_scalar_dense`` host event lies
inside its step's ``step.metrics_sync`` span (the shared clock), the device
idle time between kernels (user annotations left out) put down to the
unit's phase (the child of its root over the innermost span at the gap's
middle), against the window's idle time. Prints one JSON object, also
written to ``--out``.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import statistics
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton_cache")):
    os.environ.setdefault(var, str(ROOT / "build" / sub))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark import harness, program_trace  # noqa: E402
from benchmark.tracing import _profiler_events  # noqa: E402
from synchformer_tpu_torch.utils import trace  # noqa: E402

CELLS = ("sync_offline_b8", "stage1_avclip_b2", "stage2_sync_b16")


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(bench, device, start: int, units: int):
    """``units`` units from unit ``start``: each unit's host ms and the
    window's ms a unit."""
    sync(device)
    times, t0 = [], time.perf_counter()
    for i in range(start, start + units):
        t = time.perf_counter()
        bench.unit(i)
        times.append((time.perf_counter() - t) * 1e3)
    sync(device)
    return times, (time.perf_counter() - t0) * 1e3 / units


def span_table(records, units: int) -> dict:
    """Host and stream ms a unit, and calls a unit, of each span name."""
    host, stream, calls = (collections.defaultdict(float) for _ in range(3))
    for r in records:
        host[r["name"]] += (r["end_us"] - r["start_us"]) / 1e3
        calls[r["name"]] += 1
        if r["stream_ms"] is not None:
            stream[r["name"]] += r["stream_ms"]
    return {name: {"host_ms": host[name] / units, "calls": calls[name] / units,
                   **({"stream_ms": stream[name] / units} if name in stream else {})}
            for name in sorted(host)}


def sync_sites(bench, device, unit: int) -> dict:
    """One unit under the sync debug mode, inside recording(): where each
    synchronisation warning was raised (the innermost frame of this
    repository on the stack; the frame the warning names) and the
    host_syncs counted."""
    if device.type != "cuda":
        return {"skipped": "no CUDA device"}
    sites = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(str(ROOT)) and not f.filename.endswith(__file__)]
        where = (f"{os.path.relpath(ours[-1].filename, ROOT)}:{ours[-1].lineno}" if ours
                 else "outside the repository")
        sites[f"{where} (raised at {os.path.relpath(filename, ROOT)}:{lineno})"] += 1

    sync(device)
    with warnings.catch_warnings(), trace.recording():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            bench.unit(unit)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return {"warnings": sum(sites.values()), "sites": dict(sites),
            "host_syncs": sum(trace.counts("host_syncs").values())}


def scalar_reads(host, records) -> dict:
    """Where each aten::_local_scalar_dense host event that reads the device
    (a cudaStreamSynchronize inside it; a CPU tensor's, such as the
    optimizer's step counters, has none) lies: inside the step.metrics_sync
    of the unit that holds it, or elsewhere (the innermost span's name)."""
    waits = sorted(s for name, s, _ in host if name == "cudaStreamSynchronize")
    roots = [r for r in records if r["parent"] is None]
    syncs = {r["parent"]: r for r in records if r["name"] == "step.metrics_sync"}
    inside, host_only, elsewhere = 0, 0, collections.Counter()
    for name, s, e in host:
        if name != "aten::_local_scalar_dense":
            continue
        i = bisect.bisect_left(waits, s)
        if i == len(waits) or waits[i] > e:
            host_only += 1
            continue
        root = next((r for r in roots if r["start_us"] <= s and e <= r["end_us"]), None)
        ms = syncs.get(root["id"]) if root is not None else None
        if ms is not None and ms["start_us"] <= s and e <= ms["end_us"]:
            inside += 1
        else:
            held = [r for r in records if r["start_us"] <= s and e <= r["end_us"]]
            elsewhere[max(held, key=lambda r: r["start_us"])["name"] if held else "no span"] += 1
    return {"device_reads_inside_metrics_sync": inside, "device_reads_elsewhere": dict(elsewhere),
            "host_tensor_reads": host_only}


def idle_by_phase(kernels, records, units: int) -> dict:
    """Device idle ms a unit between kernels, by the unit's phase (the
    child of its root) over the innermost span at each gap's middle."""
    by_id = {r["id"]: r for r in records}
    gaps = program_trace.idle_gaps(kernels)
    out = collections.defaultdict(float)
    for (s, e), r in zip(gaps, program_trace.innermost(gaps, records)):
        while r is not None and r["parent"] is not None and \
                by_id[r["parent"]]["parent"] is not None:
            r = by_id[r["parent"]]
        label = ("no unit" if r is None else r["name"] if r["parent"] is not None
                 else f"{r['name']} (outside its phases)")
        out[label] += (e - s) / 1e3 / units
    return dict(sorted(out.items()))


def run_cell(name: str, args, device) -> dict:
    if args.tiny:
        from benchmark.tests.tiny import tiny_cell

        cell = tiny_cell(name)
    else:
        cell = harness.load_cell(name)
    bench = harness.driver_class(cell["traffic"]["entry"])(cell, args.seed, device)
    bench.setup()
    report = {"unit": bench.item_unit, "modes": collections.defaultdict(list)}
    at, units = 0, args.units
    for turn in range(args.turns):
        for mode in ("off", "recording", "profiler"):
            if mode == "off":
                times, mean = window(bench, device, at, units)
                at += units
            elif mode == "recording":
                with trace.recording():
                    times, mean = window(bench, device, at, units)
                at += units
                report["recording_spans"] = span_table(trace.spans(), units)
                report["recording_host_syncs"] = sum(trace.counts("host_syncs").values()) / units
            else:
                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                                 if device.type == "cuda" else [])
                sync(device)
                with profile(activities=acts) as prof:
                    times, mean = window(bench, device, at, args.profiled)
                    window_ms = mean * args.profiled
                at += args.profiled
                records = trace.spans()
                report["profiler_spans"] = span_table(records, args.profiled)
                kernels, host = _profiler_events(prof)
                real = program_trace.device_kernels({"kernels": kernels, "host": host})
                from benchmark.tracing import busy_us

                report["profiled"] = {
                    "units": args.profiled,
                    "kernels_a_unit": len(kernels) / args.profiled,
                    "annotations_a_unit": (len(kernels) - len(real)) / args.profiled,
                    "window_ms_a_unit": window_ms / args.profiled,
                    "idle_ms_a_unit": (window_ms - busy_us(real) / 1e3) / args.profiled,
                    "idle_ms_a_unit_annotations_busy":
                        (window_ms - busy_us(kernels) / 1e3) / args.profiled,
                    "idle_between_kernels_by_phase": idle_by_phase(real, records, args.profiled),
                    "scalar_reads": scalar_reads(host, records),
                    "host_syncs_a_unit": sum(trace.counts("host_syncs").values()) / args.profiled}
                del prof
            report["modes"][mode].append({"median_ms": statistics.median(times),
                                          "mean_ms": mean})
    report["sync_debug"] = sync_sites(bench, device, at)
    report["modes"] = {m: {"turns": v, "median_ms": statistics.median(t["median_ms"] for t in v)}
                       for m, v in report["modes"].items()}
    bench.close_program()
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=2147483000)
    ap.add_argument("--units", type=int, default=12, help="units a window")
    ap.add_argument("--profiled", type=int, default=3, help="units a profiled window")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--tiny", action="store_true", help="the tiny cells on the CPU")
    ap.add_argument("--out", default="build/trace_overhead.json")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.tiny else torch.device("cuda", 0)
    result = {"device": "cpu" if args.tiny else torch.cuda.get_device_name(device),
              "power_limit_w": None if args.tiny else harness.power_limit(),
              "seed": args.seed, "cells": {}}
    for name in args.cells:
        result["cells"][name] = run_cell(name, args, device)
        print(f"[trace_overhead] {name}: " + json.dumps(result["cells"][name]["modes"]),
              file=sys.stderr, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
