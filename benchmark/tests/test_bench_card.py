"""On the card only: one short run of the smallest cell through run.py,
its last line the contract's result object.

    python -m pytest benchmark/tests -q -m card
"""
import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.card
def test_offline_cell_runs(cuda_card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sync_offline_b8",
                          "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert set(result["metrics"]) == {"clips_per_s", "setup_s"}
