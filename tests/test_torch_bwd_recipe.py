"""The schedule of the divided attention's backward on the card (K6 / K7c,
csrc/divided_attention_bwd.cu), emulated in PyTorch on the CPU, against the
JAX package; and the launch plans of its two group kernels.

- emulate_space_bwd follows space_bwd_mma_kernel step by step: keys in
  chunks of 13 16-row tiles; query-major sweep 1 over 16-key tiles with the
  row max, sum and sum(e * dp) accumulated online (rescaled as the max
  grows), sigma = that / sum; sweep 2 with p and ds in f32, ds rounded before
  dq += ds K, the CLS key's ds_c / p_c kept f32 outside the product; the
  key-major part from the stored (m, 1/l, sigma): p^T rounded for dv, ds^T
  rounded for dk, each patch key's CLS-query terms (cls_bwd_kernel's
  bf16-rounded ds_cls / p_cls) added in f32 before one rounding; the CLS
  key's partials summed per group, then in group order. Rounding goes to the
  working dtype: bf16 as on the card, or f32, where the emulation is the
  exact math in another order.
- In f32 it is held against _divided_attention_bwd_4d (split layout) and
  _divided_attention_bwd_pallas (packed layout) in interpret mode at the
  Pallas tolerance of the other port tests: rtol 2e-4 / atol 3e-5. The
  shapes: head_dim 128 at 196 patches a frame (the shape the previous kernel
  refused at head_dim 128), 230 patches (231 keys: a second chunk), a few
  heads, f = 2, one or two segments.
- In bf16 it meets chip_smoke.py's rule against the f32 gradient (error <=
  2 x the plain bf16 version's + 1e-2 x max|f32|).
- The plans of _build.space_bwd_plan / time_bwd_plan: the constants are the
  CUDA source's; every head_dim of HEAD_DIMS and n up to 1024 fit the
  227 KB a block may take, with shared memory fixed beyond 8 key tiles; the
  chunks cover every key and query tile once; the time pass takes Stage I's
  f = 8 at every width and refuses an f only where one head's rows and one
  warp's scratch cannot fit (past 140 frames at head_dim 64).
- The wrappers on their kernel route (the library load replaced by a
  sentinel): K6 and K7c launch a space pass of 300 patches at head_dim 128
  (no refusal left) and time passes of 27, 28 and 140 frames, and refuse 141
  frames before any launch.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from synchformer_tpu.ops.pallas.divided_attention_bwd import (
    _divided_attention_bwd_4d,
    _divided_attention_bwd_pallas,
)
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels.divided_attention_bwd import (
    divided_attention_bwd,
    divided_attention_bwd_plain,
    divided_attention_packed_bwd,
)

torch.set_num_threads(2)

# the head_dims the kernels run at their own width (the widths up to 128)
HEAD_DIMS = _build.ATTN_WIDTHS[:4]

PALLAS = dict(rtol=2e-4, atol=3e-5)
TILE = 16
CHUNK = TILE * _build.BWD_SPACE_CHUNK_TILES


def emulate_space_bwd(qkv_p, qkv_c, dop, doc, num_heads: int, dtype=torch.bfloat16):
    """(d qkv_patches, d qkv_cls) of the space mode as the card computes them,
    every operand rounded to ``dtype`` where the kernels round it; f32
    arithmetic otherwise."""
    def rnd(x):
        return x.to(dtype).float()

    b, f, n, threed = qkv_p.shape
    d = threed // 3
    dh = d // num_heads
    scale = dh ** -0.5
    qp, kp, vp = (t.float().reshape(b, f, n, num_heads, dh).permute(0, 3, 1, 2, 4)
                  for t in qkv_p.split(d, -1))          # (b, h, f, n, dh)
    qc, kc, vc = (t.float().reshape(b, num_heads, 1, dh) for t in qkv_c.split(d, -1))
    do = dop.float().reshape(b, f, n, num_heads, dh).permute(0, 3, 1, 2, 4)
    dc = doc.float().reshape(b, num_heads, 1, dh)
    qs, qcs = rnd(qp * scale), rnd(qc * scale)

    # (1) cls_bwd_kernel: the CLS query over [CLS; all f*n patches]
    k_all = torch.cat([kc, kp.flatten(2, 3)], 2)       # (b, h, 1 + fn, dh)
    v_all = torch.cat([vc, vp.flatten(2, 3)], 2)
    p_row = torch.softmax(qcs @ k_all.transpose(-1, -2), -1)
    dp_row = dc @ v_all.transpose(-1, -2)
    ds_row = p_row * (dp_row - (p_row * dp_row).sum(-1, keepdim=True))
    w_row = torch.cat([ds_row[..., :1], rnd(ds_row[..., 1:])], -1)
    dq_cls = (w_row @ k_all) * scale
    ds_cls = rnd(ds_row[..., 1:]).reshape(b, num_heads, f, n, 1)
    p_cls = rnd(p_row[..., 1:]).reshape(b, num_heads, f, n, 1)
    dk_cls, dv_cls = ds_row[..., :1] * qcs, p_row[..., :1] * dc

    # (2) space_bwd_mma_kernel, every group at once: keys [CLS; members]
    keys = torch.cat([kc[:, :, None].expand(b, num_heads, f, 1, dh), kp], 3)
    vals = torch.cat([vc[:, :, None].expand(b, num_heads, f, 1, dh), vp], 3)
    nk = n + 1
    tiles = [(j, min(j + TILE, nk)) for c0 in range(0, nk, CHUNK)
             for j in range(c0, min(c0 + CHUNK, nk), TILE)]
    m = torch.full(qs.shape[:-1] + (1,), -float("inf"))
    l = torch.zeros_like(m)
    e = torch.zeros_like(m)
    for j0, j1 in tiles:  # sweep 1: online statistics
        s = qs @ keys[..., j0:j1, :].transpose(-1, -2)
        dp = do @ vals[..., j0:j1, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        c = torch.exp(m - m_new)
        x = torch.exp(s - m_new)
        l = l * c + x.sum(-1, keepdim=True)
        e = e * c + (x * dp).sum(-1, keepdim=True)
        m = m_new
    inv = 1.0 / l
    sig = e * inv
    dq = torch.zeros_like(qs)
    for j0, j1 in tiles:  # sweep 2: ds and dq
        s = qs @ keys[..., j0:j1, :].transpose(-1, -2)
        dp = do @ vals[..., j0:j1, :].transpose(-1, -2)
        p = torch.exp(s - m) * inv
        ds = p * (dp - sig)
        if j0 == 0:
            dsc, pc = ds[..., :1].clone(), p[..., :1].clone()
            ds[..., :1] = 0.0
        dq = dq + rnd(ds) @ keys[..., j0:j1, :]
    dq = (dq + dsc * kc[:, :, None]) * scale
    # key-major: p^T and ds^T from the stored statistics, patch keys only
    s = qs @ kp.transpose(-1, -2)
    dp = do @ vp.transpose(-1, -2)
    p = torch.exp(s - m) * inv
    ds = p * (dp - sig)
    dk = rnd(ds).transpose(-1, -2) @ qs + ds_cls * qcs[:, :, None]
    dv = rnd(p).transpose(-1, -2) @ do + p_cls * dc[:, :, None]
    part_k = (dsc * qs).sum(3)                          # (b, h, f, dh) a group each
    part_v = (pc * do).sum(3)
    dk_c = dk_cls[:, :, 0] + part_k.sum(2)              # (3) in group order
    dv_c = dv_cls[:, :, 0] + part_v.sum(2)

    def patches(t):
        return t.permute(0, 2, 3, 1, 4).reshape(b, f, n, d)

    def cls(t):
        return t.reshape(b, 1, d)

    dqkv_p = torch.cat([patches(dq), patches(dk), patches(dv)], -1)
    dqkv_c = torch.cat([cls(dq_cls), cls(dk_c), cls(dv_c)], -1)
    return dqkv_p.to(dtype), dqkv_c.to(dtype)


def _case(seed, segs, f, n, heads, dh):
    rng = np.random.default_rng(seed)
    d = heads * dh

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return r(segs, f, n, 3 * d), r(segs, 1, 3 * d), r(segs, f, n, d), r(segs, 1, d)


CASES = [  # (segments, f, n, heads, head_dim)
    (1, 2, 196, 2, 128),
    (2, 2, 230, 2, 64),
]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "x".join(map(str, c)))
def space_case(request):
    segs, f, n, heads, dh = request.param
    qkv_p, qkv_c, dop, doc = _case(sum(request.param), segs, f, n, heads, dh)
    args = [jnp.asarray(a) for a in (qkv_p, qkv_c, dop, doc)]
    packed = jnp.concatenate([args[1], args[0].reshape(segs, f * n, -1)], 1)
    dout = jnp.concatenate([args[3], args[2].reshape(segs, f * n, -1)], 1)
    with pltpu.force_tpu_interpret_mode():
        split = jax.jit(_divided_attention_bwd_4d, static_argnums=(4, 5))(
            *args, heads, "space")
        pk = jax.jit(_divided_attention_bwd_pallas, static_argnums=(2, 3, 4))(
            packed, dout, heads, f, "space")
    pk = np.asarray(pk)
    return (request.param, (qkv_p, qkv_c, dop, doc),
            [np.asarray(t) for t in split],
            [pk[:, 1:].reshape(segs, f, n, -1), pk[:, :1]])


@pytest.mark.parametrize("ref", ["split", "packed"])
def test_space_schedule_matches_pallas(space_case, ref):
    """The emulated schedule in f32 against the TPU kernels' backward."""
    (segs, f, n, heads, dh), inputs, split, packed = space_case
    got = emulate_space_bwd(*(torch.from_numpy(a) for a in inputs), heads, torch.float32)
    for g_, w_ in zip(got, split if ref == "split" else packed):
        np.testing.assert_allclose(g_.numpy(), w_, **PALLAS)


def test_space_schedule_in_bf16_meets_the_card_rule(space_case):
    """In bf16, the emulated schedule against the f32 gradient: within 2 x
    the plain bf16 version's error + 1e-2 x max|f32| (chip_smoke's rule)."""
    (segs, f, n, heads, dh), inputs, split, _ = space_case
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in inputs]
    got = emulate_space_bwd(*bf, heads)
    plain = divided_attention_bwd_plain(*bf, heads, "space")
    f32 = divided_attention_bwd_plain(*(t.float() for t in bf), heads, "space")
    for g_, p_, a_ in zip(got, plain, f32):
        err = float((g_.float() - a_).abs().max())
        tol = 2 * float((p_.float() - a_).abs().max()) + 1e-2 * float(a_.abs().max())
        assert err <= tol, (err, tol)


# ------------------------------------------------------------------ plans

CU = Path(_build.CSRC) / "divided_attention_bwd.cu"


def _constant(name: str) -> int:
    m = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*(\d+)\s*;", CU.read_text())
    assert m, name
    return int(m.group(1))


def test_plan_constants_are_the_kernels():
    assert _constant("SPACE_WARPS") == _build.BWD_SPACE_WARPS
    assert _constant("SPACE_CHUNK_TILES") == _build.BWD_SPACE_CHUNK_TILES
    assert _constant("WARPS") == _build.BWD_TIME_WARPS
    assert _constant("TIME_BWD_SMEM_TARGET") == _build.BWD_TIME_SMEM_TARGET
    assert _constant("MAX_SMEM") == _build.MAX_SMEM


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_space_plan_takes_every_frame(dh):
    """Every n up to 1024 at every head_dim: within a block's shared memory,
    fixed once 8 key tiles fill the warps; the chunks cover every key and
    query tile; one chunk up to 207 patches, two from 208."""
    fixed = None
    for n in range(1, 1025):
        plan = _build.space_bwd_plan(n, dh)
        assert plan["smem"] <= _build.MAX_SMEM
        assert plan["key_tiles"] * 16 >= n + 1 > (plan["key_tiles"] - 1) * 16
        assert plan["query_tiles"] * 16 >= n > (plan["query_tiles"] - 1) * 16
        for tiles, chunks in ((plan["key_tiles"], plan["key_chunks"]),
                              (plan["query_tiles"], plan["query_chunks"])):
            covered = [t for c in range(chunks)
                       for t in range(c * 13, min(c * 13 + 13, tiles))]
            assert covered == list(range(tiles))
        if n <= 415:
            assert plan["key_chunks"] == (1 if n <= 207 else 2)
        if plan["warps"] == _build.BWD_SPACE_WARPS:
            fixed = fixed or plan["smem"]
            assert plan["smem"] == fixed


@pytest.mark.parametrize("d,heads,p", [(768, 12, 2), (768, 8, 2), (256, 4, 4), (1024, 8, 1),
                                       (384, 6, 4)])
def test_time_plan_covers_every_position_once(d, heads, p):
    plan = _build.time_bwd_plan(8, 196, d, heads)
    assert plan["p"] == p
    covered = [g for blk in range(plan["blocks"]) for g in range(blk * p, min(blk * p + p, 196))]
    assert covered == list(range(196))
    assert plan["smem"] <= (_build.BWD_TIME_SMEM_TARGET if p > 1 else _build.MAX_SMEM)


def test_time_plan_refuses_only_frames_that_do_not_fit():
    """At D = 768 (12 heads of 64): a block stages a group of heads, so past
    the 27 frames that all heads fit it takes fewer; one head's 1 + f rows of
    qkv and cotangent (512 bytes each) with one warp's f x (f + 1) scratch
    fit up to f = 140."""
    for f in range(1, 141):
        plan = _build.time_bwd_plan(f, 196, 768, 12)
        assert plan["smem"] <= _build.MAX_SMEM
        assert plan["warps"] == min(_build.BWD_TIME_WARPS, plan["heads_a_block"] * plan["p"])
    assert _build.time_bwd_plan(140, 196, 768, 12)["heads_a_block"] == 1
    with pytest.raises(ValueError):
        _build.time_bwd_plan(141, 196, 768, 12)


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


@pytest.mark.parametrize("layout", ["split", "packed"])
@pytest.mark.parametrize("mode,f,n,heads,raises", [
    ("space", 2, 300, 2, _Launched), ("time", 27, 3, 12, _Launched),
    ("time", 28, 3, 12, _Launched), ("time", 140, 3, 12, _Launched),
    ("time", 141, 3, 12, ValueError)])
def test_wrappers_launch_every_frame_they_can(as_if_on_card, layout, mode, f, n, heads, raises):
    bf = torch.bfloat16
    d = heads * (128 if mode == "space" else 64)
    _build.launches.clear()
    if layout == "split":
        args = (torch.zeros(1, f, n, 3 * d, dtype=bf), torch.zeros(1, 1, 3 * d, dtype=bf),
                torch.zeros(1, f, n, d, dtype=bf), torch.zeros(1, 1, d, dtype=bf))
        call = lambda: divided_attention_bwd(*args, heads, mode)  # noqa: E731
    else:
        args = (torch.zeros(1, 1 + f * n, 3 * d, dtype=bf), torch.zeros(1, 1 + f * n, d, dtype=bf))
        call = lambda: divided_attention_packed_bwd(*args, heads, f, mode)  # noqa: E731
    with pytest.raises(raises):
        call()
    assert sum(_build.launches.values()) == 0
