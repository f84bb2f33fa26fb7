"""The host side of the Hopper GEMM (csrc/wgmma_gemm.cuh, under K1, K2 and
K8a-K8c; its LayerNorm-fed products: tests/test_torch_ln_gemm.py)
and of the divided attention's time pass (csrc/divided_attention.cuh), on
the CPU: the launch plans cover every output tile and every spatial position
exactly once at ragged sizes, the plans' constants are the CUDA sources',
and the wrappers refuse a shape, a dtype or an alignment the kernels do not
take before any launch (the kernels themselves run only on the card:
chip_smoke.py phase 2).
"""
import re
from pathlib import Path

import pytest
import torch

from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels import divided_attention as tda
from synchformer_tpu_torch.ops.kernels import fused_rows
from synchformer_tpu_torch.ops.kernels.gemm import check_gemm

CSRC = Path(_build.CSRC)
bf = torch.bfloat16


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*(\d+)\s*;", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def test_plan_constants_are_the_kernels():
    assert _constant("wgmma_gemm.cuh", "BM") == _build.WGMMA_BM
    assert _constant("wgmma_gemm.cuh", "BK") == _build.WGMMA_BK
    assert _constant("divided_attention.cuh", "WARPS") == _build.TIME_WARPS
    assert _constant("divided_attention.cuh", "TIME_SMEM_TARGET") == _build.TIME_SMEM_TARGET
    assert _constant("divided_attention.cuh", "MAX_SMEM") == _build.MAX_SMEM


@pytest.mark.parametrize("m", [1, 127, 128, 129, 8288, 175616])
@pytest.mark.parametrize("n", [128, 384, 768, 3072])
@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("epilogue", ["gelu", "residual"])
def test_gemm_plan_covers_every_tile_once(m, n, sms, epilogue):
    """Every (row tile, column tile) of C is walked by one block: in the
    ping-pong schedule by exactly one of its consumer warpgroups, in the
    cooperative one (GELU at N % 256 == 0) by both, 64 rows each; the tiles
    cover all m rows and n columns, and the grid is persistent (at most one
    block an SM, none idle)."""
    plan = _build.gemm_plan(m, n, 768, epilogue, sms=sms)
    cooperative = epilogue == "gelu" and n % 256 == 0
    assert plan["schedule"] == ("cooperative" if cooperative else "ping-pong")
    bm, bn = _build.WGMMA_BM, plan["bn"]
    assert bn == (256 if cooperative else 128)
    assert plan["tiles_m"] * bm >= m > (plan["tiles_m"] - 1) * bm
    assert plan["tiles_n"] * bn == n
    tiles = plan["tiles_m"] * plan["tiles_n"]
    assert plan["grid"] == min(sms, tiles)
    seen = [t for blk in range(plan["grid"]) for c in (0, 1)
            for t in _build.gemm_block_tiles(plan, blk, c)]
    assert len(seen) == tiles * (2 if cooperative else 1)
    assert set(seen) == {(i, j) for i in range(plan["tiles_m"]) for j in range(plan["tiles_n"])}
    # the tiles in flight at once share row panels: the column tile runs fastest
    if plan["tiles_n"] > 1 and plan["grid"] > 1:
        assert _build.gemm_block_tiles(plan, 1)[0] == (0, 1)


@pytest.mark.parametrize("m,n,k", [(0, 768, 768), (2 ** 31, 768, 768), (128, 32, 768),
                                   (128, 700, 768), (128, 768, 16), (128, 768, 808)])
def test_gemm_plan_refuses(m, n, k):
    with pytest.raises(ValueError):
        _build.gemm_plan(m, n, k)


def _gemm_operands(n=768, k=768, rows=10):
    return (torch.zeros(n, k, dtype=bf), torch.zeros(n, dtype=torch.float32),
            torch.zeros(rows, k, dtype=bf))


def test_check_gemm_takes_aligned_operands():
    w, bias, a = _gemm_operands()
    assert check_gemm("T", 10, w, bias, a) == {"schedule": "ping-pong", "bn": 128,
                                               "tiles_m": 1, "tiles_n": 6, "grid": 6}


@pytest.mark.parametrize("fault", ["misaligned_a", "misaligned_w", "a_f32", "w_noncontiguous",
                                   "bias_bf16", "bias_shape", "n_ragged", "k_ragged"])
def test_check_gemm_refuses(fault):
    w, bias, a = _gemm_operands()
    if fault == "misaligned_a":
        a = torch.zeros(10 * 768 + 1, dtype=bf)[1:].view(10, 768)
    elif fault == "misaligned_w":
        w = torch.zeros(768 * 768 + 1, dtype=bf)[1:].view(768, 768)
    elif fault == "a_f32":
        a = a.float()
    elif fault == "w_noncontiguous":
        w = torch.zeros(768, 1536, dtype=bf)[:, ::2]
    elif fault == "bias_bf16":
        bias = bias.to(bf)
    elif fault == "bias_shape":
        bias = torch.zeros(767, dtype=torch.float32)
    elif fault == "n_ragged":
        w, bias, a = _gemm_operands(n=672)
    elif fault == "k_ragged":
        w, bias, a = _gemm_operands(k=744)
    with pytest.raises(ValueError):
        check_gemm("T", 10, w, bias, a)


@pytest.mark.parametrize("f,n,d,p", [(8, 196, 768, 2), (8, 49, 768, 2), (8, 37, 256, 4),
                                     (8, 196, 1024, 1), (16, 196, 768, 1), (1, 5, 128, 4)])
def test_time_pass_plan_covers_every_position_once(f, n, d, p):
    """P positions a block as the kernel picks them; the position tiles
    cover 0..n-1 exactly once, the last one masked where P does not divide n;
    the block's shared memory within the card's."""
    plan = _build.time_pass_plan(f, n, d)
    assert plan["p"] == p
    covered = [g for blk in range(plan["blocks"])
               for g in range(blk * p, min(blk * p + p, n))]
    assert covered == list(range(n))
    assert plan["blocks"] * p - n < p
    assert plan["smem"] == (1 + f * p) * 2 * d * 2 + _build.TIME_WARPS * 8 * (f + 1) * 4
    assert plan["smem"] <= _build.MAX_SMEM


def test_time_pass_plan_refuses_frames_that_do_not_fit():
    # one position's 1 + f key / value rows of 2 x 768 bf16 and 8 warps'
    # logits: (f + 1) x 3328 bytes, within 232448 up to f = 68
    assert _build.time_pass_plan(68, 196, 768)["p"] == 1
    with pytest.raises(ValueError):
        _build.time_pass_plan(69, 196, 768)


def test_divided_attention_row_limits_are_per_kernel():
    """The time and space passes take as many rows as their grids allow (the
    tile GEMM's 65535 x 64 rows no longer bounds K5, K6 or K7); the time
    pass refuses frames its shared memory cannot stage."""
    assert 65535 * 8 * 196 > _build.MAX_GEMM_ROWS
    assert tda._check_heads("K5", 768, 12, "time", 65535, 8, 196) == 64
    assert tda._check_heads("K5", 768, 12, "space", 65535, 8, 196) == 64
    with pytest.raises(ValueError):
        tda._check_heads("K5", 768, 12, "space", 65536, 8, 196)
    with pytest.raises(ValueError):
        tda._check_heads("K5", 768, 12, "time", 2, 80, 196)
    tda._check_heads("K5", 768, 12, "space", 2, 80, 196)


class _Launched(Exception):
    pass


@pytest.fixture
def as_if_on_card(monkeypatch):
    """The wrappers' kernel route on CPU tensors, with the library load
    replaced by a sentinel: a call that passes every check raises _Launched,
    one that fails a check raises ValueError before it."""
    monkeypatch.setattr(_build, "use_kernel", lambda x, impl: impl == "kernel")

    def library(*args, **kwargs):
        raise _Launched

    monkeypatch.setattr(_build, "library", library)


def _k2_args(rows=(2, 3, 49), d=256, hidden=1024):
    return [torch.zeros(*rows, d, dtype=bf), torch.ones(d), torch.zeros(d),
            torch.zeros(hidden, d, dtype=bf), torch.zeros(hidden),
            torch.zeros(d, hidden, dtype=bf), torch.zeros(d)]


@pytest.mark.parametrize("fault", [None, "d_ragged", "hidden_ragged", "misaligned_x",
                                   "weights_f32"])
def test_k2_checks_before_launch(as_if_on_card, fault):
    args = _k2_args()
    if fault == "d_ragged":
        args = _k2_args(d=160, hidden=640)
    elif fault == "hidden_ragged":
        args = _k2_args(hidden=1056)
    elif fault == "misaligned_x":
        args[0] = torch.zeros(2 * 3 * 49 * 256 + 1, dtype=bf)[1:].view(2, 3, 49, 256)
    elif fault == "weights_f32":
        args[3] = args[3].float()
    with pytest.raises(_Launched if fault is None else ValueError):
        fused_rows._ln_mlp(*args, 1e-6, False)


def _k1_args(d=256, heads=4, f=8, n=49):
    return [torch.zeros(1, f, n, 3 * d, dtype=bf), torch.zeros(1, 1, 3 * d, dtype=bf),
            torch.zeros(1, f, n, d, dtype=bf), torch.zeros(d, d, dtype=bf), torch.zeros(d),
            heads]


@pytest.mark.parametrize("mode", ["space", "time"])
@pytest.mark.parametrize("fault", [None, "d_ragged", "misaligned_res", "bo_bf16", "head_dim"])
def test_k1_checks_before_launch(as_if_on_card, mode, fault):
    args = _k1_args()
    if fault == "d_ragged":
        args = _k1_args(d=160, heads=5)
    elif fault == "misaligned_res":
        args[2] = torch.zeros(8 * 49 * 256 + 1, dtype=bf)[1:].view(1, 8, 49, 256)
    elif fault == "bo_bf16":
        args[4] = args[4].to(bf)
    elif fault == "head_dim":
        args[5] = 16  # head_dim 16
    with pytest.raises(_Launched if fault is None else ValueError):
        tda._divided_attention_proj(*args, mode)
