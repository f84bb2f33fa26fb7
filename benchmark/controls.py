"""The readings a cell's limits are set from, on the card at the cell's own
size, in one process (the benchmark's runs do not run this):

    python3 benchmark/controls.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--out <file>]

- sound: the program's readings on each of ``--seeds`` (the timed path as
  a run drives it: the training cells' first steps in their set-up; the
  inference cell answering each pooled batch twice);
- control: on each of ``--control-seeds``, the reference in float8 e4m3
  (per-tensor scales, every product, forward and backward) put in the
  program's place, read against the float32 reference;
- faults: on each control seed, the program with a fault planted
  (drivers: the inference cell's ``answer_altered`` and ``half_batch``; a
  training cell's ``state_unchanged``, ``half_batch`` and ``row_altered``).

Writes one JSON object (every reading by seed) to ``--out`` and prints it.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

FAULTS = {"sync_predictor": ("answer_altered", "half_batch"),
          "avclip_train_step": ("state_unchanged", "half_batch", "row_altered"),
          "sync_train_step": ("state_unchanged", "half_batch", "row_altered")}


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def program(cell, seed, device, fault=None):
    """A driver set up and driven as a run drives it, its program freed."""
    drv = harness.driver_class(cell["traffic"]["entry"])(cell, seed, device, fault)
    drv.setup()
    if drv.item_unit == "clips":
        for i in range(2 * cell["traffic"]["pool"]):
            drv.unit(i)
    drv.close_program()
    free()
    return drv


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    entry = cell["traffic"]["entry"]
    faults = FAULTS[entry]
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "power_limit_w": harness.power_limit(), "sound": {}, "control": {}, "faults": {}}

    def log(msg):
        print(f"[controls {time.perf_counter() - T0:8.1f} s] {msg}", flush=True)

    for seed in args.seeds:
        drv = program(cell, seed, device)
        reference = drv.reference()
        out["sound"][seed] = {**drv.compare(reference), **drv.detail(reference)}
        log(f"sound seed {seed}: {out['sound'][seed]}")
        if seed in args.control_seeds:
            lower = drv.reference("fp8")
            out["control"][seed] = {**drv.control(reference, lower),
                                    **drv.detail(reference, lower)}
            log(f"control seed {seed}: {out['control'][seed]}")
            del lower
            for fault in faults:
                bad = program(cell, seed, device, fault)
                out["faults"].setdefault(fault, {})[seed] = {**bad.compare(reference),
                                                             **bad.detail(reference)}
                log(f"fault {fault} seed {seed}: {out['faults'][fault][seed]}")
                del bad
                free()
        del drv, reference
        free()
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
