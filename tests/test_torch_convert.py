"""The port's import hygiene, weight converter and seeded initialiser.

- synchformer_tpu_torch imports neither JAX, flax, optax nor the JAX package
  (checked in a subprocess: tests/conftest.py has already imported jax here),
  and no source file of the port names them.
- state_dict_from_jax is the inverse of the JAX package's
  convert_sync_checkpoint: JAX params -> port state dict -> JAX params gives
  the original tree back, leaf by leaf and bit for bit.
- chip_smoke.py refuses to run without a CUDA device and prints no result.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from test_torch_slice import S, jax_tiny_params

from synchformer_tpu.utils.checkpoint import convert_sync_checkpoint
from synchformer_tpu_torch.models.layers import LayerNorm
from synchformer_tpu_torch.models.presets import build_tiny_synchformer
from synchformer_tpu_torch.utils.convert import (
    load_numpy_state_dict,
    seeded_state_dict,
    state_dict_from_jax,
)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "synchformer_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "synchformer_tpu")


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import synchformer_tpu_torch as pkg\n"
        "import synchformer_tpu_torch.infer\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|synchformer_tpu)\b(?!_torch)",
                         re.M)
    offenders = [str(p.relative_to(REPO)) for p in sorted(PORT.rglob("*.py"))
                 if pattern.search(p.read_text())]
    offenders += [name for name in ("chip_smoke.py",)
                  if pattern.search((REPO / name).read_text())]
    assert not offenders


@pytest.fixture(scope="module")
def params():
    return jax_tiny_params(S)[1]


def test_state_dict_round_trip_through_jax_converter(params):
    sd = state_dict_from_jax(params)
    back = convert_sync_checkpoint({"model": sd})
    want = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_state_dict_names_are_the_port_modules(params):
    """The converted names are exactly the port model's parameters (strict
    load), with each shape."""
    model = build_tiny_synchformer(S)
    sd = state_dict_from_jax(params)
    load_numpy_state_dict(model, sd)
    name = "vfeat_extractor.blocks.0.timeattn.qkv.weight"
    np.testing.assert_array_equal(model.state_dict()[name].numpy(), sd[name])
    assert "afeat_extractor.ast.encoder.layer.1.attention.attention.query.weight" in sd
    assert "transformer.blocks.0.attn.query.weight" in sd


def test_seeded_state_dict_is_deterministic_and_scaled():
    model = build_tiny_synchformer(S, device="meta")
    a, b = seeded_state_dict(model, seed=3), seeded_state_dict(model, seed=3)
    assert a.keys() == dict(model.named_parameters()).keys()
    ln = {f"{n}.{p}" for n, m in model.named_modules() if isinstance(m, LayerNorm)
          for p in ("weight", "bias")}
    for name, arr in a.items():
        np.testing.assert_array_equal(arr, b[name])
        if name in ln:
            assert np.all(arr == (1.0 if name.endswith("weight") else 0.0)), name
    big = a["vfeat_extractor.blocks.0.mlp.fc1.weight"]
    assert abs(float(big.std()) - 0.02) < 1e-3
    assert not np.array_equal(big, seeded_state_dict(model, seed=4)[
        "vfeat_extractor.blocks.0.mlp.fc1.weight"])


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No CUDA device (hidden by CUDA_VISIBLE_DEVICES), and a directory that
    holds the script alone: both exit non-zero and print no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", lone):
        proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                              env={**os.environ, "PYTHONPATH": "", "CUDA_VISIBLE_DEVICES": ""},
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
