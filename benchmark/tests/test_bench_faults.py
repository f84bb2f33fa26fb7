"""The check sees a broken timed path: a whole run on the CPU at tiny
sizes (the look for a card skipped), with each fault the cell can have
planted underneath, comes out not correct; the same run without the fault
comes out correct. The limits here are twice the sound run's own readings
on the same seed (tiny sizes are not the cells' sizes; the cells' limits
are set on the card, PERF.md); the control, the reference in float8 put in
the program's place, reads above them too."""
import time

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny_cell

SEED = 4_000_000_007
CELLS = {"sync_offline_b8": ("answer_altered", "half_batch"),
         "stage1_avclip_b2": ("state_unchanged", "half_batch", "row_altered"),
         "stage2_sync_b16": ("state_unchanged", "half_batch", "row_altered")}
_SOUND = {}


def _run(name, limits=None, fault=None):
    cell = tiny_cell(name)
    if limits is not None:
        cell["limits"] = limits
    return harness.run(["--workload", name, "--seed", str(SEED), "--seconds", "0.3",
                        "--trace", "0"], time.perf_counter(), cell=cell, allow_cpu=True,
                       fault=fault, log=lambda msg: None)


def _limits(name):
    if name not in _SOUND:
        names = tiny_cell(name)["limits"]
        readings = {k: c["value"] for k, c in
                    _run(name, {k: float("inf") for k in names})["checks"].items()}
        _SOUND[name] = {k: 2.0 * v for k, v in readings.items()}
    return _SOUND[name]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    result = _run(name, _limits(name))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in sorted(CELLS.items()) for f in fs])
def test_fault_is_caught(name, fault):
    result = _run(name, _limits(name), fault)
    assert not result["correct"], (fault, result["checks"])


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_reads_above_the_limits(name):
    from benchmark import controls

    import torch

    cell = tiny_cell(name)
    drv = controls.program(cell, SEED, torch.device("cpu"))
    reference = drv.reference()
    control = drv.control(reference, drv.reference("fp8"))
    limits = _limits(name)
    assert any(control[k] > limits[k] for k in limits), (control, limits)
