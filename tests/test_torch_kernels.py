"""The port's kernel-bearing modules (synchformer_tpu_torch/ops/kernels/, K1-K4)
against the JAX package, on the CPU, where each wrapper runs its plain
PyTorch version.

Each plain version in f32 is held against
- the JAX reference composition at rtol = atol = 1e-5 (same math, f32 sums
  in another order), and
- the JAX Pallas function under pltpu.force_tpu_interpret_mode() at
  rtol 2e-4 / atol 3e-5: the Pallas kernels use a degree-9 erf polynomial
  for GELU (|err| <= 3e-5) and, for K1, an unnormalised-softmax order;
  the port uses exact erf.
The CUDA kernels themselves are checked against these plain versions on the
card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from synchformer_tpu.ops.pallas import cls_pool as jcls
from synchformer_tpu.ops.pallas import fused_rows as jrows
from synchformer_tpu.ops.pallas import standard_attention as jstd
from synchformer_tpu.ops.pallas.divided_attention_bwd import divided_attention_proj_split
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels.cls_pool import fused_cls_pool_tokens
from synchformer_tpu_torch.ops.kernels.divided_attention import divided_attention_proj
from synchformer_tpu_torch.ops.kernels.fused_rows import (
    fused_ln_mlp_residual,
    layer_norm_from_stats,
)
from synchformer_tpu_torch.ops.kernels.standard_attention import standard_attention

torch.set_num_threads(2)

D, HEADS = 256, 4  # 4 heads of 64: the JAX 4-D split kernel's lane grouping
REF = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(rtol=2e-4, atol=3e-5)


def _r(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **tol)


def _mlp_args(rng, hidden=4 * D):
    """JAX-layout (in, out) LN + MLP params."""
    return dict(g=1.0 + _r(rng, D, s=0.1), b=_r(rng, D, s=0.1),
                w1=_r(rng, D, hidden, s=D ** -0.5), b1=_r(rng, hidden, s=0.02),
                w2=_r(rng, hidden, D, s=hidden ** -0.5), b2=_r(rng, D, s=0.02))


def _port_mlp(a):
    return (_t(a["g"]), _t(a["b"]), _t(a["w1"].T), _t(a["b1"]), _t(a["w2"].T), _t(a["b2"]))


# --------------------------------------------------------------------- K1

@pytest.mark.parametrize("mode", ["space", "time"])
def test_divided_attention_proj_matches_jax(rng, mode):
    """K1 plain vs the XLA DividedAttention + projection + residual, and vs
    divided_attention_proj_4d in interpret mode (+ the CLS projection the JAX
    caller does outside it)."""
    from synchformer_tpu.models.motionformer import DividedAttention

    b, f, n = 2, 2, 16
    x = _r(rng, b, 1 + f * n, D)
    res = _r(rng, b, 1 + f * n, D)
    wqkv, bqkv = _r(rng, D, 3 * D, s=D ** -0.5), _r(rng, 3 * D, s=0.02)
    wo, bo = _r(rng, D, D, s=D ** -0.5), _r(rng, D, s=0.02)
    variables = {"params": {"qkv": {"kernel": wqkv, "bias": bqkv},
                            "proj": {"kernel": wo, "bias": bo}}}
    golden = res + np.asarray(DividedAttention(num_heads=HEADS).apply(
        variables, jnp.asarray(x), f, mode))

    qkv = x @ wqkv + bqkv
    qkv_c, qkv_p = qkv[:, :1], qkv[:, 1:].reshape(b, f, n, 3 * D)
    res_c, res_p = res[:, :1], res[:, 1:].reshape(b, f, n, D)
    y_p, attn_c = divided_attention_proj(_t(qkv_p), _t(qkv_c), _t(res_p), _t(wo.T),
                                         _t(bo), HEADS, mode)
    y_c = res_c + (attn_c.numpy() @ wo + bo)
    _close(y_p, golden[:, 1:].reshape(b, f, n, D), REF)
    _close(y_c, golden[:, :1], REF)

    with pltpu.force_tpu_interpret_mode():
        jy_p, jy_c = divided_attention_proj_split(
            jnp.asarray(qkv_p), jnp.asarray(qkv_c), jnp.asarray(res_p), jnp.asarray(res_c),
            jnp.asarray(wo), jnp.asarray(bo), HEADS, mode)
    _close(y_p, jy_p, PALLAS)
    _close(y_c, jy_c, PALLAS)


# --------------------------------------------------------------------- K2

@pytest.mark.parametrize("shape", [(2, 2, 16, D), (2, 65, D)], ids=["rows4d", "slab3d"])
@pytest.mark.parametrize("stats", [False, True], ids=["plain", "stats"])
def test_ln_mlp_residual_matches_jax(rng, shape, stats):
    """K2 plain (with and without row stats) vs _ln_mlp_ref / _ln_mlp_stats_ref
    and vs the Pallas row / slab kernels in interpret mode."""
    x = _r(rng, *shape)
    a = _mlp_args(rng)
    jargs = [jnp.asarray(v) for v in a.values()]
    got = fused_ln_mlp_residual(_t(x), *_port_mlp(a), 1e-6, emit_stats=stats)
    if stats:
        ref = jrows._ln_mlp_stats_ref(jnp.asarray(x), *jargs, 1e-6)
        with pltpu.force_tpu_interpret_mode():
            pal = jrows.fused_ln_mlp_residual_stats(jnp.asarray(x), *jargs, 1e-6)
        assert got[1].shape == (*shape[:-1], 8)
        for g_, r_, p_ in zip(got, ref, pal):
            _close(g_, r_, REF)
            _close(g_, p_, PALLAS)
    else:
        _close(got, jrows._ln_mlp_ref(jnp.asarray(x), *jargs, 1e-6), REF)
        with pltpu.force_tpu_interpret_mode():
            pal = jrows.fused_ln_mlp_residual(jnp.asarray(x), *jargs, 1e-6)
        _close(got, pal, PALLAS)


def test_layer_norm_from_stats_matches_jax(rng):
    x = _r(rng, 3, 5, D)
    mean = x.mean(-1, keepdims=True)
    msq = (x * x).mean(-1, keepdims=True)
    g, b = 1.0 + _r(rng, D, s=0.1), _r(rng, D, s=0.1)
    want = jrows.layer_norm_from_stats(jnp.asarray(x), mean, msq, g, b, 1e-6, jnp.float32)
    got = layer_norm_from_stats(_t(x), _t(mean), _t(msq), _t(g), _t(b), 1e-6, torch.float32)
    _close(got, want, REF)


# --------------------------------------------------------------------- K3

def test_standard_attention_matches_jax(rng):
    """K3 plain vs standard_attention_ref and the Pallas kernel, at the AST's
    74 tokens (not a multiple of 16)."""
    qkv = _r(rng, 3, 74, 3 * D)
    got = standard_attention(_t(qkv), HEADS)
    _close(got, jstd.standard_attention_ref(jnp.asarray(qkv), HEADS), REF)
    with pltpu.force_tpu_interpret_mode():
        pal = jstd.standard_attention(jnp.asarray(qkv), HEADS)
    _close(got, pal, PALLAS)


# --------------------------------------------------------------------- K4

@pytest.mark.parametrize("bsz,m", [(8, 16), (4, 12)], ids=["spatial", "frequency"])
def test_cls_pool_tokens_matches_jax(rng, bsz, m):
    """K4 plain vs _cls_pool_tokens_ref and the Pallas tokens kernel."""
    x = _r(rng, bsz, m, D)
    cls = _r(rng, 1, D, s=0.5)
    att = dict(g1=1.0 + _r(rng, D, s=0.1), b1=_r(rng, D, s=0.1),
               wqkv=_r(rng, D, 3 * D, s=D ** -0.5), bqkv=_r(rng, 3 * D, s=0.02),
               wp=_r(rng, D, D, s=D ** -0.5), bp=_r(rng, D, s=0.02))
    mlp = _mlp_args(rng)
    jargs = [jnp.asarray(v) for v in (x, cls, *att.values(), mlp["g"], mlp["b"], mlp["w1"],
                                      mlp["b1"], mlp["w2"], mlp["b2"])]
    g2, b2, w1, b1, w2, b2_ = _port_mlp(mlp)
    got = fused_cls_pool_tokens(_t(x), _t(cls), _t(att["g1"]), _t(att["b1"]),
                                _t(att["wqkv"].T), _t(att["bqkv"]), _t(att["wp"].T),
                                _t(att["bp"]), g2, b2, w1, b1, w2, b2_,
                                num_heads=HEADS, eps=1e-6)
    assert got.shape == (bsz, D)
    _close(got, jcls._cls_pool_tokens_ref(*jargs, HEADS, 1e-6), REF)
    with pltpu.force_tpu_interpret_mode():
        pal = jcls.fused_cls_pool_tokens(*jargs, num_heads=HEADS, eps=1e-6)
    _close(got, pal, PALLAS)


# --------------------------------------------------------------- routing

def test_wrappers_take_plain_path_only_on_cpu_or_when_asked():
    x = torch.zeros(2, 8)
    assert _build.use_kernel(x, "plain") is False
    assert _build.use_kernel(x, "kernel") is False  # CPU tensor
    with pytest.raises(ValueError):
        _build.use_kernel(x, "fast")
    with pytest.raises(RuntimeError):
        _build.use_kernel(torch.zeros(2, 8, device="meta"), "kernel")


def test_cpu_runs_launch_no_kernel(rng):
    _build.launches.clear()
    standard_attention(_t(_r(rng, 1, 5, 3 * D)), HEADS)
    assert sum(_build.launches.values()) == 0
