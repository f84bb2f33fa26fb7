"""Run one benchmark cell once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result object; standard error
ends with each checked number beside its limit. Exits non-zero, with no
result, where no CUDA card (or fewer than the cell asks for) is found, or
where a module of JAX or of the JAX package is loaded by the end.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the program inside the checkout, at fixed
# paths; libraries that would load JAX by themselves kept from it
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
