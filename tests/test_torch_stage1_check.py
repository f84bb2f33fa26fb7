"""chip_smoke.py's Stage I agreement check fails a wrong K5, K6, K7a, K7c or
K8a and passes the right ones, on the tiny AVCLIPs (drop-path 0.2, B=2, S=2)
on the CPU: build_tiny_avclip for the split flow (K5 / K6) and
build_tiny_avclip_packed for the packed flow (K7a / K7c) and for the packed
flow on attn_impl='pallas_fused' (K8a's backward); so does its packed-block
check (phase 5) under the packed flow's faults, on a tiny block; its
serving check (phase 8, the tiny Synchformer with TINY_PACKED's towers on
'pallas_fused') and phase 2's check of the K8a / K8b cases (at TINY_K8's
size) fail a wrong K8a or K8b; its MoCo check (phase 9, the tiny MoCo
model) and phase 2's check of the K4b cases (at TINY_K4B's size) fail a
wrong K4b; and phase 2's checked K4 cases (at TINY_K4's size) fail a wrong
K4.

The faults are scripts/stage1_planted_faults.py's: wrappers around a kernel's
entry where DividedAttentionFn or DividedAttentionPackedFn calls it. On CPU tensors the kernel path
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


SPLIT_ENTRIES, SPLIT = faults.FLOWS["split"][:2], faults.FLOWS["split"][2]
PACKED_ENTRIES, PACKED = faults.FLOWS["packed"][:2], faults.FLOWS["packed"][2]
FUSED_ENTRIES, FUSED = faults.FLOWS["packed_fused"][:2], faults.FLOWS["packed_fused"][2]


def _setup(tiny_build, entries):
    """(first_step, the f32 remat step, the plain bf16 step) of a tiny AVCLIP
    at drop-path 0.2; first_step plants a fault on ``entries`` (module,
    names)."""
    from synchformer_tpu_torch.utils.convert import seeded_state_dict

    def build(remat=False, device=None):
        return tiny_build(remat=remat, drop_path_rate=0.2, device=device)

    sd = seeded_state_dict(build(device="meta"), seed=0)
    batch = chip_smoke.stage1_batch(torch, 2, 2, (4, 32, 32, 3))

    def first_step(precision, impl, remat=False, fault=None):
        tr = chip_smoke.stage1_trainer(build, sd, "cpu", precision, impl, remat)
        with faults.planted(*entries, fault):
            m = chip_smoke.checked_step(tr, batch, f"{precision} {impl}")
        return chip_smoke.step_gradients(torch, tr, m)

    return first_step, first_step("fp32", "plain", remat=True), first_step("amp", "plain")


@pytest.fixture(scope="module")
def setup():
    from synchformer_tpu_torch.models.presets import build_tiny_avclip

    return _setup(build_tiny_avclip, SPLIT_ENTRIES)


@pytest.fixture(scope="module")
def packed_setup():
    from synchformer_tpu_torch.models.presets import build_tiny_avclip_packed

    return _setup(build_tiny_avclip_packed, PACKED_ENTRIES)


@pytest.fixture(scope="module")
def fused_setup():
    import functools

    from synchformer_tpu_torch.models.presets import build_tiny_avclip_packed

    return _setup(functools.partial(build_tiny_avclip_packed, attn_impl="pallas_fused"),
                  FUSED_ENTRIES)


# every fault must fail these (a subset of what it failed at full width)
MUST_FAIL = {
    "k6_dk_zero": ["vfeat_extractor.blocks.1.timeattn.qkv.weight[k]"],
    "k6_cls_key_zero": ["vfeat_extractor.cls_token"],
    "k6_mode_swapped": ["vfeat_extractor.blocks.0.timeattn.qkv.weight[q]"],
    "k5_feature_order": ["loss", "grad_norm", "cosine"],
    "k7c_dk_zero": ["vfeat_extractor.blocks.1.timeattn.qkv.weight[k]"],
    "k7a_mode_swapped": ["loss", "grad_norm", "cosine"],
    "k8a_dk_zero": ["vfeat_extractor.blocks.1.timeattn.qkv.weight[k]"],
}


def _check(setup, name, fault):
    first_step, ref, plain = setup
    kern = first_step("amp", "kernel", fault=fault)
    failed = chip_smoke.stage1_agreement(ref, plain, kern)
    # per block, two qkv weights by their q, k, v rows and two qkv biases;
    # and the CLS token (97 leaves at depth 12, 17 at the tiny depth 2)
    assert len(ref["leaves"]) == 2 * 2 * 4 + 1
    if name == "none":
        assert failed == []
    else:
        assert set(MUST_FAIL[name]) <= set(failed), failed


@pytest.mark.parametrize("name", list(SPLIT))
def test_stage1_check_against_planted_fault(setup, name):
    _check(setup, name, SPLIT[name])


@pytest.mark.parametrize("name", list(PACKED))
def test_packed_stage1_check_against_planted_fault(packed_setup, name):
    _check(packed_setup, name, PACKED[name])


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_stage1_check_against_planted_fault(fused_setup, name):
    _check(fused_setup, name, FUSED[name])


@pytest.fixture(scope="module")
def block_setup():
    """(block, the f32 record, the plain bf16 record) of chip_smoke's packed
    block at the script's TINY_BLOCK size (2 heads of 64, 1 + 2 x 4 tokens)."""
    setup = chip_smoke.packed_block(torch, "cpu", **faults.TINY_BLOCK)
    return (setup, chip_smoke.packed_block_grads(torch, setup, torch.float32, "plain"),
            chip_smoke.packed_block_grads(torch, setup, torch.bfloat16, "plain"))


# what each fault must fail in chip_smoke's packed-block check
BLOCK_MUST_FAIL = {"k7c_dk_zero": ["timeattn.qkv.weight[k]", "attn.qkv.weight[k]"],
                   "k7a_mode_swapped": ["y", "attn.qkv.weight[v]"]}


@pytest.mark.parametrize("name", list(PACKED))
def test_packed_block_check_against_planted_fault(block_setup, name):
    setup, ref, plain = block_setup
    with faults.planted(*PACKED_ENTRIES, PACKED[name]):
        kern = chip_smoke.packed_block_grads(torch, setup, torch.bfloat16, "kernel")
    failed = chip_smoke.packed_block_agreement(ref, plain, kern)
    # y, dx and two qkv weights by their q, k, v rows
    assert len(ref) == 2 + 2 * 3
    if name == "none":
        assert failed == []
    else:
        assert set(BLOCK_MUST_FAIL[name]) <= set(failed), failed


@pytest.fixture(scope="module")
def serving_caught():
    return faults.serving_faults("cpu", tiny=True)


@pytest.mark.parametrize("name", list(faults.SERVING_FAULTS))
def test_serving_check_against_planted_fault(serving_caught, name):
    """Phase 8's serving_agreement: the probabilities alone move little at
    seeded weights; the video tower's features fail each K8a fault."""
    failed = serving_caught[name]
    assert failed == ([] if name == "none" else ["vfeat"]), failed


@pytest.fixture(scope="module")
def kernel_caught():
    return faults.kernel_faults("cpu", tiny=True)


@pytest.mark.parametrize("name", list(faults.KERNEL_FAULTS))
def test_k8_kernel_check_against_planted_fault(kernel_caught, name):
    """Phase 2's check of the K8a (space, time) and K8b cases: each K8a fault
    (g / b on the wrong columns included: the cases' LN parameters are
    random) fails both K8a cases, the K8b fault the K8b case, the control
    none."""
    failed = [label.split()[0] + ("" if label.startswith("K8b") else " " + label.split()[1])
              for label in kernel_caught[name]]
    want = {"none": [], "k8a_mode_swapped": ["K8a space", "K8a time"],
            "k8a_ln_skipped": ["K8a space", "K8a time"], "k8b_residual_dropped": ["K8b"],
            "k8a_ln_columns_swapped": ["K8a space", "K8a time"]}
    assert failed == want[name], failed


@pytest.fixture(scope="module")
def moco_caught():
    return faults.moco_faults("cpu", tiny=True)


# what each K4b fault must fail in phase 9's moco_agreement on the tiny model
MOCO_MUST_FAIL = {"k4b_shared_q": ["query global_v"],
                  "k4b_residual_dropped": ["global_contrastive_loss", "query global_v"]}


@pytest.mark.parametrize("name", list(faults.K4B_FAULTS))
def test_moco_check_against_planted_fault(moco_caught, name):
    """Phase 9's moco_agreement: a K4b that shares group 0's query moves the
    query pass's video global features (the groups' CLS rows differ only by
    the positional dropout); one that drops its residual moves the global
    loss as well."""
    failed = moco_caught[name]
    if name == "none":
        assert failed == []
    else:
        assert set(MOCO_MUST_FAIL[name]) <= set(failed), failed


@pytest.fixture(scope="module")
def k4b_kernel_caught():
    return faults.k4b_kernel_faults("cpu", tiny=True)


@pytest.mark.parametrize("name", list(faults.K4B_FAULTS))
def test_k4b_kernel_check_against_planted_fault(k4b_kernel_caught, name):
    """Phase 2's check of the K4b cases: each fault fails both (the groups'
    rows, and so their queries, differ), the control neither."""
    failed = [label.split()[1] for label in k4b_kernel_caught[name]]
    assert failed == ([] if name == "none" else ["global", "spatial"]), failed


@pytest.fixture(scope="module")
def k4_kernel_caught():
    return faults.k4_kernel_faults("cpu", tiny=True)


@pytest.mark.parametrize("name", list(faults.K4_FAULTS))
def test_k4_kernel_check_against_planted_fault(k4_kernel_caught, name):
    """Phase 2's checked K4 cases: each fault (the shared CLS key left out of
    the softmax; head h's values from head h + 1's rows of Wv) fails every
    case, the MoCo global aggregators', a time tail's, the ragged rows', the
    part-filled last block's, the guard band's and, at another head width,
    the ragged and guard-band ones, and the legacy towers' spatial pool
    (heads of 128) and frequency pool (heads of 64); the control none."""
    failed = [" ".join(label.split()[1:-1]) for label in k4_kernel_caught[name]]
    want = ["global", "time tail", "ragged", "ragged", "part-filled last block", "guard band",
            "4x32 ragged", "4x32 guard band", "legacy spatial 2x128", "legacy frequency 2x64"]
    assert failed == ([] if name == "none" else want), failed
