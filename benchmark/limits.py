"""A cell's check limits from the readings of ``benchmark/controls.py``:

    python3 benchmark/limits.py <controls.json> [--write]

For each number the cell compares:
- lower: the largest reading of the program's sound runs over the seeds;
- upper: the least of the control's readings where they are three times
  the lower or more, and of each planted fault's readings where they are
  ten times the lower or more (a state left unchanged: three times);
- limit: between them, nearer the upper (lower^0.4 x upper^0.6, two
  significant digits), so that fresh seeds, which read higher than a dozen
  did, have the more room.

Prints each number's readings and limit, and whether the control and every
fault fail at least one number on each seed under the limits. ``--write``
puts the limits into the cell's workload file.
"""
import argparse
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def _sig2(x: float) -> float:
    return float(f"{x:.2g}")


def derive(readings: dict) -> dict:
    """{number: {"lower", "control", "faults", "upper", "limit"}}."""
    sound = readings["sound"]
    numbers = sorted({k for r in sound.values() for k, v in r.items()
                      if isinstance(v, (int, float))} & _compared(readings))
    out = {}
    for name in numbers:
        lower = max(r[name] for r in sound.values())
        control = min((r[name] for r in readings["control"].values()), default=None)
        faults = {f: min(r[name] for r in by_seed.values())
                  for f, by_seed in readings["faults"].items()}
        counted = [control] if control is not None and control >= 3 * lower else []
        counted += [v for f, v in faults.items()
                    if v >= (3 if f == "state_unchanged" else 10) * lower]
        upper = min(counted) if counted else None
        limit = None if upper is None else _sig2(lower ** 0.4 * upper ** 0.6)
        out[name] = {"lower": lower, "control": control, "faults": faults, "upper": upper,
                     "limit": limit}
    return out


def _compared(readings: dict) -> set:
    work = json.loads((BENCH / "workloads" / f"{readings['workload']}.json").read_text())
    return set(work["limits"])


def failing(readings: dict, limits: dict) -> dict:
    """For the control and each fault, the seeds on which no number fails."""
    out = {}
    for kind, by_seed in [("control", readings["control"])] + list(readings["faults"].items()):
        passed = [seed for seed, r in by_seed.items()
                  if all(limits[k] is not None and r[k] <= limits[k] for k in limits)]
        out[kind] = passed
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("controls")
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()
    readings = json.loads(Path(args.controls).read_text())
    derived = derive(readings)
    limits = {k: v["limit"] for k, v in derived.items()}
    for name, d in derived.items():
        print(f"{readings['workload']} {name}: lower {d['lower']:.4g} control "
              f"{d['control'] if d['control'] is None else format(d['control'], '.4g')} "
              f"faults {json.dumps({f: float(f'{v:.4g}') for f, v in d['faults'].items()})} "
              f"upper {d['upper']} limit {d['limit']}")
    unfailed = failing(readings, limits)
    for kind, seeds in unfailed.items():
        print(f"{readings['workload']} {kind}: {'fails a number on every seed' if not seeds else 'PASSES on seeds ' + ' '.join(map(str, seeds))}")
    if args.write:
        path = BENCH / "workloads" / f"{readings['workload']}.json"
        work = json.loads(path.read_text())
        work["limits"] = limits
        path.write_text(json.dumps(work, indent=1) + "\n")
    ok = all(v is not None for v in limits.values()) and not any(unfailed.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
