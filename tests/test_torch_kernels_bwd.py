"""The Stage I kernels of the port (K5, K6) and the autograd Functions around
K2, K3, K4, against the JAX package on the CPU, where each wrapper runs its
plain PyTorch version. Inputs come from numpy seeds; everything is f32.

Tolerances:
- against the JAX XLA compositions (and jax.grad of them): rtol = atol = 1e-5,
  the same math with f32 sums in another order;
- against the Pallas kernels and their custom VJPs under
  pltpu.force_tpu_interpret_mode(): rtol 2e-4 / atol 3e-5, for their
  degree-9 erf polynomial GELU (|err| <= 3e-5, the port uses exact erf) and
  the unnormalised-softmax order of the divided attention.
The CUDA kernels themselves are held against these plain versions on the card
by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from synchformer_tpu.ops.pallas import cls_pool as jcls
from synchformer_tpu.ops.pallas import fused_rows as jrows
from synchformer_tpu.ops.pallas import standard_attention as jstd
from synchformer_tpu.ops.pallas.divided_attention import divided_attention_pallas_4d
from synchformer_tpu.ops.pallas.divided_attention_bwd import (
    _divided_attention_bwd_4d,
    divided_attention_split as jax_divided_attention_split,
)
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels.cls_pool import fused_cls_pool_tokens
from synchformer_tpu_torch.ops.kernels.divided_attention import (
    divided_attention,
    divided_attention_plain,
)
from synchformer_tpu_torch.ops.kernels.divided_attention_bwd import (
    DividedAttentionFn,
    divided_attention_bwd,
    divided_attention_bwd_plain,
    divided_attention_split,
)
from synchformer_tpu_torch.ops.kernels.fused_rows import fused_ln_mlp_residual
from synchformer_tpu_torch.ops.kernels.standard_attention import standard_attention

torch.set_num_threads(2)

REF = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(rtol=2e-4, atol=3e-5)
# the split-layout shape of tests/test_pallas_bwd.py:50: d=128, 2 heads of 64
B, F, N, HEADS2, D2 = 2, 2, 8, 2, 128
D, HEADS = 256, 4  # 4 heads of 64 for K2-K4, as tests/test_torch_kernels.py


def _r(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **tol)


def _split_case(rng):
    qkv_p = _r(rng, B, F, N, 3 * D2)
    qkv_c = _r(rng, B, 1, 3 * D2)
    dop = _r(rng, B, F, N, D2)
    doc = _r(rng, B, 1, D2)
    return qkv_p, qkv_c, dop, doc


def jax_divided_attention_xla(qkv_p, qkv_c, num_heads, mode):
    """The XLA DividedAttention math (synchformer_tpu/models/motionformer.py
    :200-251) on the split layout, for jax.grad."""
    b, f, n, threed = qkv_p.shape
    d = threed // 3
    dh = d // num_heads
    qkv = jnp.concatenate([qkv_c, qkv_p.reshape(b, f * n, threed)], axis=1)
    qkv = qkv.reshape(b, 1 + f * n, 3, num_heads, dh)
    q, k, v = (jnp.swapaxes(t, 1, 2) for t in jnp.moveaxis(qkv, 2, 0))  # (b, h, seq, dh)
    q = q * dh ** -0.5
    cls_p = jax.nn.softmax(jnp.einsum("bhqd,bhkd->bhqk", q[:, :, :1], k), -1)
    cls_out = jnp.einsum("bhqk,bhkd->bhqd", cls_p, v)

    def regroup(t):
        t = t.reshape(b, num_heads, f, n, dh)
        return jnp.swapaxes(t, 2, 3) if mode == "time" else t

    q_, k_, v_ = (regroup(t[:, :, 1:]) for t in (q, k, v))
    g = q_.shape[2]
    k_ = jnp.concatenate([jnp.broadcast_to(k[:, :, None, :1], (b, num_heads, g, 1, dh)), k_], 3)
    v_ = jnp.concatenate([jnp.broadcast_to(v[:, :, None, :1], (b, num_heads, g, 1, dh)), v_], 3)
    p = jax.nn.softmax(jnp.einsum("bhgqd,bhgkd->bhgqk", q_, k_), -1)
    out = jnp.einsum("bhgqk,bhgkd->bhgqd", p, v_)
    if mode == "time":
        out = jnp.swapaxes(out, 2, 3)
    out_p = jnp.moveaxis(out, 1, 3).reshape(b, f, n, d)
    out_c = jnp.moveaxis(cls_out, 1, 2).reshape(b, 1, d)
    return out_p, out_c


# --------------------------------------------------------------------- K5

@pytest.mark.parametrize("mode", ["space", "time"])
def test_divided_attention_matches_jax(rng, mode):
    """K5 plain (and the wrapper, which runs it on CPU tensors) vs the XLA
    composition and divided_attention_pallas_4d in interpret mode; the
    outputs are head-major, as the Pallas kernel returns them."""
    qkv_p, qkv_c, _, _ = _split_case(rng)
    plain = divided_attention_plain(_t(qkv_p), _t(qkv_c), HEADS2, mode)
    _build.launches.clear()
    wrapped = divided_attention(_t(qkv_p), _t(qkv_c), HEADS2, mode)
    assert sum(_build.launches.values()) == 0
    xla = jax_divided_attention_xla(jnp.asarray(qkv_p), jnp.asarray(qkv_c), HEADS2, mode)
    with pltpu.force_tpu_interpret_mode():
        pal = jax.jit(divided_attention_pallas_4d, static_argnums=(2, 3))(
            jnp.asarray(qkv_p), jnp.asarray(qkv_c), HEADS2, mode)
    for got in (plain, wrapped):
        assert got[0].shape == (B, F, N, D2) and got[1].shape == (B, 1, D2)
        for g_, x_, p_ in zip(got, xla, pal):
            _close(g_, x_, REF)
            _close(g_, p_, PALLAS)


# --------------------------------------------------------------------- K6

@pytest.fixture(scope="module", params=["space", "time"])
def bwd_case(request):
    """(mode, inputs, JAX grads by jax.vjp of the XLA composition, JAX grads
    of _divided_attention_bwd_4d in interpret mode)."""
    mode = request.param
    qkv_p, qkv_c, dop, doc = _split_case(np.random.default_rng(3))
    args = [jnp.asarray(a) for a in (qkv_p, qkv_c)]
    _, vjp = jax.vjp(lambda p, c: jax_divided_attention_xla(p, c, HEADS2, mode), *args)
    xla = vjp((jnp.asarray(dop), jnp.asarray(doc)))
    with pltpu.force_tpu_interpret_mode():
        pal = jax.jit(_divided_attention_bwd_4d, static_argnums=(4, 5))(
            *args, jnp.asarray(dop), jnp.asarray(doc), HEADS2, mode)
    return mode, (qkv_p, qkv_c, dop, doc), xla, pal


def _assert_bwd(got, xla, pal):
    assert got[0].shape == (B, F, N, 3 * D2) and got[1].shape == (B, 1, 3 * D2)
    for g_, x_, p_ in zip(got, xla, pal):
        _close(g_, x_, REF)
        _close(g_, p_, PALLAS)


def test_divided_attention_bwd_plain_matches_jax(bwd_case):
    """K6 plain (autograd of the plain forward) and the K6 wrapper on CPU
    tensors vs jax.vjp of the XLA composition and _divided_attention_bwd_4d."""
    mode, (qkv_p, qkv_c, dop, doc), xla, pal = bwd_case
    _assert_bwd(divided_attention_bwd_plain(_t(qkv_p), _t(qkv_c), _t(dop), _t(doc),
                                            HEADS2, mode), xla, pal)
    _build.launches.clear()
    _assert_bwd(divided_attention_bwd(_t(qkv_p), _t(qkv_c), _t(dop), _t(doc), HEADS2, mode),
                xla, pal)
    assert sum(_build.launches.values()) == 0


def test_divided_attention_fn_grads_match_jax(bwd_case):
    """DividedAttentionFn (K5 forward, K6 backward) under autograd, and the
    plain route of divided_attention_split, vs the same JAX gradients; the
    JAX custom VJP (divided_attention_split) gives them too."""
    mode, (qkv_p, qkv_c, dop, doc), xla, pal = bwd_case
    for fn in (lambda p, c: DividedAttentionFn.apply(p, c, HEADS2, mode),
               lambda p, c: divided_attention_split(p, c, HEADS2, mode, impl="plain")):
        qp, qc = _t(qkv_p, True), _t(qkv_c, True)
        out_p, out_c = fn(qp, qc)
        ((out_p * _t(dop)).sum() + (out_c * _t(doc)).sum()).backward()
        _assert_bwd((qp.grad, qc.grad), xla, pal)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda p, c: jax_divided_attention_split(p, c, HEADS2, mode),
                         jnp.asarray(qkv_p), jnp.asarray(qkv_c))
        jgrads = vjp((jnp.asarray(dop), jnp.asarray(doc)))
    for g_, p_ in zip(jgrads, pal):
        _close(g_, p_, REF)


# ------------------------------------------------------------ K2 / K3 / K4

def _sin_loss_grads(fn, inputs):
    """Gradients of sum(sin(fn(*inputs))) (a non-trivial cotangent) for every
    input; outputs that are tuples contribute each of their parts."""
    ts = [_t(a, True) for a in inputs]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    sum(torch.sin(o).sum() for o in outs).backward()
    return [t.grad for t in ts]


def _jax_sin_loss_grads(fn, inputs):
    def loss(*a):
        out = fn(*a)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(jnp.sin(o)) for o in outs)

    with pltpu.force_tpu_interpret_mode():
        return jax.jit(jax.grad(loss, argnums=tuple(range(len(inputs)))))(
            *[jnp.asarray(a) for a in inputs])


@pytest.mark.parametrize("shape,stats", [((2, 2, 16, D), False), ((2, 65, D), False),
                                         ((2, 2, 16, D), True)],
                         ids=["slab", "rows", "slab_stats"])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_ln_mlp_fn_grads_match_jax(rng, shape, stats, impl):
    """K2's gradients (LnMlpFn on impl='kernel') w.r.t. x, the LN params, both
    matrices and both biases vs jax.grad through the JAX custom_vjp of
    fused_ln_mlp_residual (_stats) with the kernel in interpret mode. The port
    takes (out, in) matrices: their gradients are compared transposed."""
    hidden = 4 * D
    x = _r(rng, *shape)
    g, b = 1.0 + _r(rng, D, s=0.1), _r(rng, D, s=0.1)
    w1, b1 = _r(rng, D, hidden, s=D ** -0.5), _r(rng, hidden, s=0.02)
    w2, b2 = _r(rng, hidden, D, s=hidden ** -0.5), _r(rng, D, s=0.02)
    jfn = jrows.fused_ln_mlp_residual_stats if stats else jrows.fused_ln_mlp_residual
    want = _jax_sin_loss_grads(lambda *a: jfn(*a, 1e-6), [x, g, b, w1, b1, w2, b2])
    got = _sin_loss_grads(
        lambda x_, g_, b_, w1t, b1_, w2t, b2_: fused_ln_mlp_residual(
            x_, g_, b_, w1t, b1_, w2t, b2_, 1e-6, emit_stats=stats, impl=impl),
        [x, g, b, w1.T, b1, w2.T, b2])
    got[3], got[5] = got[3].T, got[5].T
    for g_, w_ in zip(got, want):
        _close(g_, w_, PALLAS)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_standard_attention_fn_grads_match_jax(rng, impl):
    """K3's gradient (StandardAttentionFn) at the AST's 74 tokens vs jax.grad
    through standard_attention's custom_vjp (kernel in interpret mode)."""
    qkv = _r(rng, 3, 74, 3 * D)
    want = _jax_sin_loss_grads(lambda q: jstd.standard_attention(q, HEADS), [qkv])
    got = _sin_loss_grads(lambda q: standard_attention(q, HEADS, impl=impl), [qkv])
    _close(got[0], want[0], PALLAS)


@pytest.mark.parametrize("bsz,m", [(8, 16), (4, 12)], ids=["spatial", "frequency"])
def test_cls_pool_fn_grads_match_jax(rng, bsz, m):
    """K4's gradients (ClsPoolTokensFn) w.r.t. x, the CLS row and every LN
    param, matrix and bias vs jax.grad through fused_cls_pool_tokens'
    custom_vjp (kernel in interpret mode)."""
    x = _r(rng, bsz, m, D)
    cls = _r(rng, 1, D, s=0.5)
    g1, b1_ = 1.0 + _r(rng, D, s=0.1), _r(rng, D, s=0.1)
    wqkv, bqkv = _r(rng, D, 3 * D, s=D ** -0.5), _r(rng, 3 * D, s=0.02)
    wp, bp = _r(rng, D, D, s=D ** -0.5), _r(rng, D, s=0.02)
    g2, b2_ = 1.0 + _r(rng, D, s=0.1), _r(rng, D, s=0.1)
    w1, fb1 = _r(rng, D, 4 * D, s=D ** -0.5), _r(rng, 4 * D, s=0.02)
    w2, fb2 = _r(rng, 4 * D, D, s=(4 * D) ** -0.5), _r(rng, D, s=0.02)
    jargs = [x, cls, g1, b1_, wqkv, bqkv, wp, bp, g2, b2_, w1, fb1, w2, fb2]
    want = _jax_sin_loss_grads(
        lambda *a: jcls.fused_cls_pool_tokens(*a, num_heads=HEADS, eps=1e-6), jargs)
    mats = (4, 6, 10, 12)
    pargs = [a.T if i in mats else a for i, a in enumerate(jargs)]
    got = _sin_loss_grads(
        lambda *a: fused_cls_pool_tokens(*a, num_heads=HEADS, eps=1e-6), pargs)
    for i, (g_, w_) in enumerate(zip(got, want)):
        _close(g_.T if i in mats else g_, w_, PALLAS)


def test_backward_of_cpu_tensors_launches_no_kernel(rng):
    """Forward and backward through every Function on CPU tensors: no launch."""
    _build.launches.clear()
    qkv_p, qkv_c, dop, doc = _split_case(rng)
    qp = _t(qkv_p, True)
    out_p, _ = DividedAttentionFn.apply(qp, _t(qkv_c), HEADS2, "space")
    (out_p * _t(dop)).sum().backward()
    q3 = _t(_r(rng, 2, 5, 3 * D), True)
    standard_attention(q3, HEADS).sum().backward()
    assert q3.grad is not None and qp.grad is not None
    assert sum(_build.launches.values()) == 0
