"""chip_smoke.py's Stage I agreement check fails a wrong K5 or K6 and passes
the right ones, on the tiny AVCLIP (drop-path 0.2, B=2, S=2) on the CPU.

The faults are scripts/stage1_planted_faults.py's: wrappers around K5's or
K6's entry where DividedAttentionFn calls it. On CPU tensors the kernel path
runs the plain versions, so the unfaulted kernel path equals the plain bf16
path exactly and the control passes at a ratio of 1; each fault must fail at
least one check, and those named below the checks that the full-width chip
run saw fail.
"""
from __future__ import annotations

import importlib.util
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _faults_module():
    spec = importlib.util.spec_from_file_location(
        "stage1_planted_faults", os.path.join(REPO, "scripts", "stage1_planted_faults.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


faults = _faults_module()


@pytest.fixture(scope="module")
def setup():
    from synchformer_tpu_torch.models.presets import build_tiny_avclip
    from synchformer_tpu_torch.utils.convert import seeded_state_dict

    def build(remat=False, device=None):
        return build_tiny_avclip(remat=remat, drop_path_rate=0.2, device=device)

    sd = seeded_state_dict(build(device="meta"), seed=0)
    batch = chip_smoke.stage1_batch(torch, 2, 2, (4, 32, 32, 3))

    def first_step(precision, impl, remat=False, fault=None):
        tr = chip_smoke.stage1_trainer(build, sd, "cpu", precision, impl, remat)
        with faults.planted(fault):
            m = chip_smoke.checked_step(tr, batch, f"{precision} {impl}")
        return chip_smoke.step_gradients(torch, tr, m)

    return first_step, first_step("fp32", "plain", remat=True), first_step("amp", "plain")


# every fault must fail these (a subset of what it failed at full width)
MUST_FAIL = {
    "k6_dk_zero": ["vfeat_extractor.blocks.1.timeattn.qkv.weight[k]"],
    "k6_cls_key_zero": ["vfeat_extractor.cls_token"],
    "k6_mode_swapped": ["vfeat_extractor.blocks.0.timeattn.qkv.weight[q]"],
    "k5_feature_order": ["loss", "grad_norm", "cosine"],
}


@pytest.mark.parametrize("name", list(faults.FAULTS))
def test_stage1_check_against_planted_fault(setup, name):
    first_step, ref, plain = setup
    kern = first_step("amp", "kernel", fault=faults.FAULTS[name])
    failed = chip_smoke.stage1_agreement(ref, plain, kern)
    # per block, two qkv weights by their q, k, v rows and two qkv biases;
    # and the CLS token (97 leaves at depth 12, 17 at the tiny depth 2)
    assert len(ref["leaves"]) == 2 * 2 * 4 + 1
    if name == "none":
        assert failed == []
    else:
        assert set(MUST_FAIL[name]) <= set(failed), failed
