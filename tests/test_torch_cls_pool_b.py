"""K4b (the CLS-pool layer with the CLS row inside x) and the aggregators
that reach it, against the JAX package on the CPU, where the kernel wrappers
run their plain versions.

- cls_pool_plain in f32 against _cls_pool_ref at rtol = atol = 1e-5, and
  against fused_cls_pool under pltpu.force_tpu_interpret_mode() at rtol 2e-4 /
  atol 3e-5 (the Pallas kernel's degree-9 erf polynomial GELU, |err| <= 3e-5;
  the port uses exact erf);
- ClsPoolFn's gradients of every input against jax.grad through
  fused_cls_pool's custom VJP, kernel in interpret mode, at 2e-4 / 3e-5;
- the aggregator with a positional embedding (TemporalAggregator, the global
  segment aggregator) on both of the JAX layer's branches: split (eval, or no
  positional dropout: K4 with a shared CLS row) and not split (training with
  the positional dropout live: K4b). The JAX side runs impl='pallas' in
  interpret mode with pos_emb_drop = 1e-9, which flax's Dropout applies as
  an exact identity (its keep probability rounds to 1.0 in f32) while the
  layer still takes the K4b branch; the port's dropout at 1e-9 is an identity
  for the same reason.
The CUDA kernel is checked against cls_pool_plain on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_kernels_bwd import _jax_sin_loss_grads, _sin_loss_grads

from synchformer_tpu.ops.pallas import cls_pool as jcls
from synchformer_tpu_torch.models.aggregators import TemporalAggregator
from synchformer_tpu_torch.models.layers import element_dropout
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels import cls_pool as tcls
from synchformer_tpu_torch.utils.convert import cls_pool_layer_sd, load_numpy_state_dict

torch.set_num_threads(2)

D, HEADS = 128, 2
REF = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(rtol=2e-4, atol=3e-5)
MATS = (3, 5, 9, 11)  # wqkv, wp, w1, w2: JAX (in, out), the port (out, in)


def _r(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **tol)


def _layer_args(rng, bsz, n):
    """JAX-layout arguments of fused_cls_pool: x, LN1, QKV, proj, LN2, MLP."""
    return [_r(rng, bsz, n, D), 1.0 + _r(rng, D, s=0.1), _r(rng, D, s=0.1),
            _r(rng, D, 3 * D, s=D ** -0.5), _r(rng, 3 * D, s=0.02),
            _r(rng, D, D, s=D ** -0.5), _r(rng, D, s=0.02),
            1.0 + _r(rng, D, s=0.1), _r(rng, D, s=0.1),
            _r(rng, D, 4 * D, s=D ** -0.5), _r(rng, 4 * D, s=0.02),
            _r(rng, 4 * D, D, s=(4 * D) ** -0.5), _r(rng, D, s=0.02)]


def _port(args):
    return [torch.from_numpy(np.ascontiguousarray(a.T if i in MATS else a))
            for i, a in enumerate(args)]


@pytest.mark.parametrize("bsz,n", [(2, 15), (8, 9)], ids=["global", "groups8"])
def test_cls_pool_plain_matches_jax(rng, bsz, n):
    """K4b's plain version against _cls_pool_ref and the Pallas kernel; the
    shapes are ones where the Pallas entry runs its kernel (_seg_chunk > 0)
    and not its reference fallback."""
    args = _layer_args(rng, bsz, n)
    assert jcls._seg_chunk(bsz, n) > 0
    got = tcls.fused_cls_pool(*_port(args), num_heads=HEADS, eps=1e-6)
    assert got.shape == (bsz, D)
    jargs = [jnp.asarray(a) for a in args]
    _close(got, jax.jit(lambda *a: jcls._cls_pool_ref(*a, HEADS, 1e-6))(*jargs), REF)
    with pltpu.force_tpu_interpret_mode():
        pal = jax.jit(lambda *a: jcls.fused_cls_pool(*a, num_heads=HEADS, eps=1e-6))(*jargs)
    _close(got, pal, PALLAS)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_cls_pool_fn_grads_match_jax(rng, impl):
    """ClsPoolFn's gradients (impl='kernel') and autograd of the plain
    version w.r.t. x and every LN param, matrix and bias, vs jax.grad
    through fused_cls_pool's custom VJP (kernel in interpret mode)."""
    args = _layer_args(rng, 2, 15)
    want = _jax_sin_loss_grads(lambda *a: jcls.fused_cls_pool(*a, num_heads=HEADS, eps=1e-6),
                               args)
    pargs = [a.T if i in MATS else a for i, a in enumerate(args)]
    got = _sin_loss_grads(lambda *a: tcls.fused_cls_pool(*a, num_heads=HEADS, eps=1e-6,
                                                         impl=impl), pargs)
    for i, (g_, w_) in enumerate(zip(got, want)):
        _close(g_.T if i in MATS else g_, w_, PALLAS)


def test_cls_pool_of_concat_equals_tokens(rng):
    """K4b over [cls; x] gives K4 over x with the shared CLS row, values and
    gradients (the JAX contract of tests/test_cls_pool.py:114-135)."""
    args = _port(_layer_args(rng, 4, 12))
    cls = torch.from_numpy(_r(rng, 1, D, s=0.5)).requires_grad_()
    x = args[0].requires_grad_()
    full = torch.cat([cls.reshape(1, 1, D).expand(4, 1, D), x], dim=1)
    a = tcls.fused_cls_pool(full, *args[1:], num_heads=HEADS, eps=1e-6)
    (ga_x, ga_c) = torch.autograd.grad(torch.sin(a).sum(), (x, cls))
    b = tcls.fused_cls_pool_tokens(x, cls, *args[1:], num_heads=HEADS, eps=1e-6)
    (gb_x, gb_c) = torch.autograd.grad(torch.sin(b).sum(), (x, cls))
    _close(a.detach(), b.detach(), dict(rtol=0, atol=1e-6))
    _close(ga_x, gb_x, dict(rtol=0, atol=1e-6))
    _close(ga_c, gb_c, dict(rtol=0, atol=1e-6))


def _jax_global_agg(pos_emb_drop):
    from synchformer_tpu.models.aggregators import TemporalAggregator as JTemporal

    return JTemporal(num_heads=HEADS, add_pos_emb=True, pos_max_len=4,
                     pos_emb_drop=pos_emb_drop, impl="pallas")


@pytest.fixture(scope="module")
def global_agg():
    """The global segment aggregator at D=128, 2 heads, pos_max_len 4, on
    (2, 3, D) segment features: JAX params (randomised: the CLS row and the
    positional embedding are not small) and the port's layer loaded with
    them."""
    from test_torch_models import randomize

    rng = np.random.default_rng(5)
    x = _r(rng, 2, 3, D)
    params = randomize(jax.jit(_jax_global_agg(0.0).init)(jax.random.PRNGKey(0),
                                                          jnp.asarray(x)))
    sd = cls_pool_layer_sd(params["params"]["cls_layer"], "agg")
    layer = TemporalAggregator(D, HEADS, add_pos_emb=True, pos_max_len=4, pos_emb_drop=1e-9)
    load_numpy_state_dict(layer, {k[len("agg."):]: v for k, v in sd.items()})
    return x, params, layer


@pytest.mark.parametrize("deterministic", [True, False], ids=["split_k4", "inside_k4b"])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_global_aggregator_matches_jax(global_agg, monkeypatch, deterministic, impl):
    """TemporalAggregator with its positional embedding on both branches:
    eval splits the CLS row off (JAX and the port's kernel route take K4's
    entry), training with pos_emb_drop 1e-9 keeps it inside x (both take
    K4b's entry: counted at JAX's _cls_pool_pallas and the port's _cls_pool,
    each at trace or call time)."""
    x, params, layer = global_agg
    seen = {"jax": 0, "port": 0}
    jax_entry, port_entry = jcls._cls_pool_pallas, tcls._cls_pool

    def count(side, fn):
        def wrapped(*a, **k):
            seen[side] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jcls, "_cls_pool_pallas", count("jax", jax_entry))
    monkeypatch.setattr(tcls, "_cls_pool", count("port", port_entry))
    module = _jax_global_agg(1e-9)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, a: module.apply(p, a, deterministic=deterministic,
                                                 rngs={"dropout": jax.random.PRNGKey(3)})
                       )(params, jnp.asarray(x))
    got = layer(torch.from_numpy(x), impl, deterministic, torch.Generator().manual_seed(0))
    _close(got.detach(), want, PALLAS)
    inside = not deterministic
    assert seen["jax"] == int(inside)
    assert seen["port"] == int(inside and impl == "kernel")


def test_global_aggregator_split_needs_no_generator(global_agg):
    """In eval, or with no positional dropout, nothing is drawn; training
    with the dropout live and no generator is refused."""
    x, _, layer = global_agg
    xt = torch.from_numpy(x)
    torch.testing.assert_close(layer(xt, "plain"), layer(xt, "plain", True, None))
    with pytest.raises(ValueError, match="generator"):
        layer(xt, "plain", False, None)


def test_element_dropout_statistics():
    """A fraction near p of the elements is zero, the rest are scaled by
    exactly 1 / (1 - p) in the tensor's dtype, and one generator seed gives
    one draw."""
    p, x = 0.1, torch.randn(64, 512)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        a = element_dropout(xd, p, torch.Generator().manual_seed(0))
        b = element_dropout(xd, p, torch.Generator().manual_seed(0))
        assert torch.equal(a, b)
        dropped = a == 0
        frac = dropped.float().mean().item()
        assert abs(frac - p) < 4 * (p * (1 - p) / x.numel()) ** 0.5
        assert torch.equal(a[~dropped], (xd / (1 - p))[~dropped])
    assert torch.equal(element_dropout(x, 0.0, None), x)
    assert torch.equal(element_dropout(x, 1e-9, torch.Generator()), x)


def test_cpu_route_launches_no_kernel(rng):
    """fused_cls_pool on CPU tensors, forward and backward: no launch."""
    _build.launches.clear()
    args = _port(_layer_args(rng, 2, 5))
    x = args[0].requires_grad_()
    tcls.fused_cls_pool(x, *args[1:], num_heads=HEADS, eps=1e-6).sum().backward()
    assert x.grad is not None and sum(_build.launches.values()) == 0
