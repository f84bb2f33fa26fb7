"""No run holds a module of JAX or of the JAX package: the check compares
each module's top-level name (before the first dot) whole, since the
port's name begins with the JAX package's."""
import subprocess
import sys
import types

from benchmark import harness


def test_names_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in ("synchformer_tpu_torch.fake", "jaxtyping_fake", "flaxen", "jax_fake"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "synchformer_tpu.models", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "synchformer_tpu"]


def test_a_run_loads_no_jax():
    """A tiny run in a fresh process, then the check that run.py makes."""
    code = (
        "import sys, time; sys.path.insert(0, '.');"
        "from benchmark import harness; from benchmark.tests.tiny import tiny_cell;"
        "cell = tiny_cell('stage2_sync_b16');"
        "harness.run(['--workload', 'stage2_sync_b16', '--seed', '5', '--seconds', '0.2',"
        " '--trace', '0'], time.perf_counter(), cell=cell, allow_cpu=True, log=lambda m: None);"
        "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_py_refuses_without_a_card():
    """Without a CUDA card run.py prints no result and exits non-zero."""
    code = ("import torch, runpy, sys; torch.cuda.is_available = lambda: False;"
            "sys.argv = ['benchmark/run.py', '--workload', 'sync_offline_b8', '--seed', '1',"
            " '--seconds', '1', '--trace', '0']; runpy.run_path('benchmark/run.py',"
            " run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
