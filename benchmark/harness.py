"""The benchmark of ``synchformer_tpu_torch``: one run of one cell.

Everything that belongs to one configuration, traffic mix, program entry
or per-layer metric lives in a file of its own, found by name:

- ``BENCHMARK.json`` at the root: the cells and metrics;
- ``benchmark/workloads/<cell>.json``: a cell's configuration, traffic
  mix, chips, why, and the limits of its check;
- ``benchmark/configs/<config>.json``: a configuration: its source, the
  model node the port's registry builds, the trainer settings, and the
  ``sizes`` its plain reference (``reference``, a module under
  ``benchmark/reference/``) reads;
- ``benchmark/traffic/<mix>.json``: a traffic mix's parameters (the
  entry it drives, batch, pool of distinct batches, the fields of a batch,
  the units a traced run profiles), read by the general pool generator
  (inputs.py) and the entry's driver;
- ``benchmark/drivers/<entry>.py``: how a program entry is set up, driven
  one unit at a time, and checked;
- ``benchmark/metrics/<metric>.py``: the reader of one metric, ``read(ctx)``
  returning a number or None.

A run: the set-up (from process start: the device, the program's objects,
the seeded weights and inputs, the first units that build and warm every
kernel), the window of ``--seconds`` (units back to back; each unit ends
with its result on the host), then the check against the plain reference
once the program's state is freed. ``--trace 1`` profiles a few units at
the window's start and reports the per-layer metrics.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "synchformer_tpu")


class RunError(Exception):
    """A run that prints no result: the exit code and why."""

    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_cell(name: str) -> dict:
    """The workload file of cell ``name`` with its configuration, sizes and
    traffic mix loaded."""
    work = load_json(BENCH / "workloads" / f"{name}.json")
    config = load_json(BENCH / "configs" / f"{work['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{work['traffic']}.json")
    return {"name": name, **work, "config": config, "traffic": traffic,
            "sizes": config["sizes"]}


def driver_class(entry: str):
    return importlib.import_module(f"benchmark.drivers.{entry}").Driver


def reader(metric: str):
    """benchmark/metrics/<metric>.py's ``read``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or with
    ``trace`` its per-layer metrics (those listing the cell; one without a
    list where the cell reports the metric it moves)."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit():
    """The card's power limit in watts, from nvidia-smi, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class RunContext:
    """What an end-to-end metric reads: the window and the set-up."""

    def __init__(self, setup_s: float, window_s: float, items: int, units: int):
        self.setup_s, self.window_s, self.items, self.units = setup_s, window_s, items, units


class TraceContext:
    """What a per-layer metric reads: the traced units' kernels, wrapper
    calls and spans (tracing.Tracer.results) and the model FLOPs of the
    work they completed."""

    def __init__(self, trace: dict, model_flops: float, peak_flops: float):
        self.trace, self.model_flops, self.peak_flops = trace, model_flops, peak_flops
        self.units = trace["units"]

    def per_unit(self, value):
        return None if value is None or not self.units else value / self.units

    def kernel_count(self):
        return len(self.trace["kernels"]) or None

    def span_ms(self, name: str):
        ms = self.trace["spans"].get(name)
        return sum(ms) if ms else None

    def wrapper_ms(self):
        calls = self.trace["calls"]
        return sum(ms for _, ms, _ in calls) if calls else None

    def roofline_pct(self):
        """100 x the sum of the wrapper calls' bounds over their measured
        time, over the calls whose bound is known."""
        timed = [(ms, b) for _, ms, b in self.trace["calls"] if b is not None and ms > 0]
        if not timed:
            return None
        return 100.0 * sum(b for _, b in timed) * 1e3 / sum(ms for ms, _ in timed)

    def busy_s(self):
        from benchmark.tracing import busy_us

        return busy_us(self.trace["kernels"]) / 1e6

    def idle_pct(self):
        if not self.trace["kernels"] or self.trace["window_s"] <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.trace["window_s"])

    def mfu_pct(self):
        if not self.model_flops or self.trace["window_s"] <= 0:
            return None
        return 100.0 * self.model_flops / (self.trace["window_s"] * self.peak_flops)


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv, t0: float, *, cell: dict = None, allow_cpu: bool = False, fault: str = None,
        log=None) -> dict:
    """One run; returns the result object. ``cell``, ``allow_cpu`` and
    ``fault`` serve the benchmark's own tests only: a cell given whole, a
    run on the CPU, a fault planted in the timed path."""
    import torch

    from benchmark.flops.peaks import BF16_FLOPS

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    args = parse(argv)
    man = manifest() if cell is None else cell.get("manifest")
    if cell is None:
        cell = load_cell(args.workload)
    chips = int(cell["chips"])
    if allow_cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunError(2, f"needs {chips} CUDA device(s); found "
                              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    cuda = device.type == "cuda"
    traffic = cell["traffic"]
    driver = driver_class(traffic["entry"])(cell, args.seed, device, fault)
    if cuda:
        torch.cuda.init()
    start_setup = time.perf_counter()
    log(f"[setup] process start to the card {start_setup - t0:.3f} s")
    driver.setup()
    last = start_setup
    for phase, at in driver.marks:
        log(f"[setup] {phase} {at - last:.3f} s")
        last = at
    tracer = None
    if args.trace:
        if not cuda:
            raise RunError(2, "a traced run needs the card")
        from benchmark.tracing import Tracer

        tracer = Tracer(device)
        tracer.install_wrappers()
        driver.spans(tracer)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    log(f"[run] {cell['name']} seed {args.seed}: set-up {setup_s:.3f} s")

    trace_units = int(traffic.get("trace_units", 2)) if tracer else 0
    items = units = failed_units = 0
    trace_from = 1
    start = time.perf_counter()
    while True:
        if tracer and units == trace_from:
            tracer.start()
        try:
            items += driver.unit(units)
        except RuntimeError as e:  # a step the program refuses (a non-finite loss)
            log(f"[run] unit {units} failed: {e}")
            failed_units += 1
            units += 1
            break
        units += 1
        if tracer and units == trace_from + trace_units:
            tracer.stop(trace_units)
        elapsed = time.perf_counter() - start
        if elapsed >= args.seconds and (not tracer or units >= trace_from + trace_units):
            break
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"[run] window {window_s:.3f} s: {units} units, {items} {driver.item_unit}; "
        f"peak memory {peak} bytes")

    metrics = {}
    breakdown = None
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak)}
    if cuda:
        device_info["cards_visible"] = torch.cuda.device_count()
        device_info["power_limit_w"] = power_limit()
    if tracer:
        from benchmark.tracing import breakdown as make_breakdown

        trace = tracer.results()
        tracer.remove()
        tctx = TraceContext(trace, driver.model_flops(trace["units"]), BF16_FLOPS)
        device_info["busy_s"] = tctx.busy_s()
        device_info["window_s"] = trace["window_s"]
        breakdown = make_breakdown(trace)
        ctx = tctx
    else:
        ctx = RunContext(setup_s, window_s, items, units - failed_units)
    for m in cell_metrics(man, cell["name"], bool(args.trace)):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.close_program()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from benchmark import checks

    readings = driver.readings()
    ok, compared = checks.judge(readings, cell.get("limits", {}))
    attempted = units * (traffic["batch"] if driver.item_unit == "clips" else 1)
    failed = failed_units * (traffic["batch"] if driver.item_unit == "clips" else 1)
    result = {"correct": bool(ok and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    found = forbidden_modules()
    if found:
        raise RunError(3, f"modules of JAX or of the JAX package were loaded: {found}")
    for name, c in compared.items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None, t0: float = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    try:
        result = run(sys.argv[1:] if argv is None else argv, t0)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return e.code
    print(json.dumps(result), flush=True)
    return 0
