"""The frozen FLOP and byte arithmetic against the bounds PERF.md's kernel
table records (NVIDIA H100: 3.35 TB/s, 989 TFLOP/s)."""
import json

import pytest
import torch

from benchmark import harness
from benchmark.flops import kernels as kf
from benchmark.flops import model as mf

B, S, F, N, D, H = 8, 14, 8, 196, 768, 12
BS = B * S


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_k2_video_rows():
    x, w1 = meta(BS, F, N, D), meta(4 * D, D)
    nbytes, flops = kf.k2_cost(("K2", x, None, None, w1), {"emit_stats": True})
    assert flops / 1e9 == pytest.approx(1657.3, abs=0.05)
    assert kf.bound_s(nbytes, flops) * 1e3 == pytest.approx(1.6758, abs=1e-4)


def test_k2_ast_rows():
    x, w1 = meta(BS, 74, D), meta(4 * D, D)
    nbytes, flops = kf.k2_cost(("K2", x, None, None, w1), {})
    assert flops / 1e9 == pytest.approx(78.2, abs=0.05)
    assert kf.bound_s(nbytes, flops) * 1e3 == pytest.approx(0.0791, abs=1e-4)


def test_k1_pair():
    args = [meta(BS, F, N, 3 * D), meta(BS, 1, 3 * D), meta(BS, F, N, D), meta(D, D),
            meta(D, dtype=torch.float32)]
    pair = sum(kf.bound_s(*kf.k1_cost(args + [H, mode], {})) for mode in ("space", "time"))
    assert pair * 1e3 == pytest.approx(0.8065, abs=2e-4)
    nbytes, _ = kf.k1_cost(args + [H, "space"], {})
    assert nbytes / 1e6 == pytest.approx(1350.9, abs=0.5)


def test_k3_and_k4():
    nbytes, flops = kf.k3_cost((meta(BS, 74, 3 * D), H), {})
    assert kf.bound_s(nbytes, flops) * 1e3 == pytest.approx(0.0152, abs=1e-4)
    assert nbytes / 1e6 == pytest.approx(50.9, abs=0.05)
    assert kf.bound_s(*kf.k4_cost(896, 196, D, H, 4 * D)) * 1e3 == pytest.approx(0.0852, abs=1e-4)


def test_k5_k6_stage1():
    bs1 = 2 * S
    act = bs1 * F * N * D * 2
    qkv = [meta(bs1, F, N, 3 * D), meta(bs1, 1, 3 * D)]
    pair5 = sum(kf.bound_s(*kf.k5_cost(qkv + [H, m], {})) for m in ("space", "time"))
    assert pair5 * 1e3 == pytest.approx(0.1612, abs=2e-4)
    nbytes, _ = kf.k6_cost(qkv + [None, None, H, "space"], {})
    assert nbytes == 7 * act + bs1 * 7 * D * 2
    assert nbytes / 1e6 == pytest.approx(472.7, abs=0.5)


def test_model_flops_of_the_configurations():
    sync = harness.load_cell("sync_offline_b8")["sizes"]
    avclip = harness.load_cell("stage1_avclip_b2")["sizes"]
    t = 1 + F * N
    per_block = 32 * t * D * D
    video = mf.video_tower_flops(sync)
    assert 12 * per_block < video < 12 * per_block * 1.2
    assert 8 * mf.sync_forward_flops(sync) / 1e12 == pytest.approx(43.5, abs=0.1)
    assert mf.avclip_step_flops(avclip, 2) / 1e12 == pytest.approx(32.5, abs=0.1)
    assert mf.sync_step_flops(sync, 16) == pytest.approx(
        16 * (mf.towers_flops(sync) + 3 * mf.head_flops(sync)))
    json.dumps(sync)
