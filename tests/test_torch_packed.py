"""The Motionformer's packed-layout flow in the port (K7a / K7b forward, K7c
backward, the packed block and encoder, the 8-head AVCLIP's tiny
counterpart) against the JAX package on the CPU, where every kernel wrapper
runs its plain PyTorch version. Inputs come from numpy seeds; everything is
f32.

Tolerances, as tests/test_torch_kernels_bwd.py and test_torch_train.py:
- against the JAX XLA compositions (and jax.vjp of them): rtol = atol = 1e-5,
  the same math with f32 sums in another order;
- against the Pallas kernels and their custom VJPs under
  pltpu.force_tpu_interpret_mode(): rtol 2e-4 / atol 3e-5, for the
  unnormalised-softmax order of the divided attention and the Pallas
  blocks' degree-9 erf polynomial GELU (|err| <= 3e-5; the port uses exact
  erf);
- the tiny packed AVCLIP: test_torch_train.py's (loss rtol 1e-5, each
  gradient within 2e-5 of its tensor's largest, parameters after AdamW within
  2e-6 where the clipped gradient exceeds 1e-5).
The CUDA kernels themselves are held against these plain versions on the card
by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_kernels_bwd import jax_divided_attention_xla
from test_torch_models import randomize
from test_torch_train import (
    check_eval_step,
    check_loss_and_grads,
    check_remat,
    check_train_step,
    make_case,
)

from synchformer_tpu.ops.pallas import divided_attention_bwd as jdab
from synchformer_tpu.ops.pallas.divided_attention import divided_attention_pallas
from synchformer_tpu_torch.models.motionformer import DividedSpaceTimeBlock, MotionFormerEncoder
from synchformer_tpu_torch.models.presets import TINY_PACKED, build_tiny_avclip_packed
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels.divided_attention import (
    divided_attention_packed,
    divided_attention_packed_plain,
    heads_groupable,
)
from synchformer_tpu_torch.ops.kernels.divided_attention_bwd import (
    DividedAttentionPackedFn,
    divided_attention_packed_bwd,
    divided_attention_packed_bwd_plain,
    packed_divided_attention,
)
from synchformer_tpu_torch.utils import convert

torch.set_num_threads(2)

REF = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(rtol=2e-4, atol=3e-5)
B, F, N = 2, 2, 8
# (heads, head_dim): the v1 body at 4 heads of 8 (configs/smoke.yaml's tower)
# and 2 of 96 (the 8-head tower's head_dim), the v3 body at 2 heads of 64
LAYOUTS = {"v1_4x8": (4, 8), "v1_2x96": (2, 96), "v3_2x64": (2, 64)}


def _r(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **tol)


def jax_packed_xla(qkv, num_heads, num_frames, mode):
    """The XLA DividedAttention math on the packed layout (motionformer.py
    :200-251), through the split-layout composition of the K5 tests."""
    b, seq, threed = qkv.shape
    n = (seq - 1) // num_frames
    out_p, out_c = jax_divided_attention_xla(qkv[:, 1:].reshape(b, num_frames, n, threed),
                                             qkv[:, :1], num_heads, mode)
    return jnp.concatenate([out_c, out_p.reshape(b, seq - 1, -1)], axis=1)


@pytest.fixture(scope="module", params=[(lay, m) for lay in LAYOUTS for m in ("space", "time")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def packed_case(request):
    """(layout, mode, qkv, dout, JAX XLA output and its vjp, Pallas forward
    and backward in interpret mode)."""
    layout, mode = request.param
    heads, dh = LAYOUTS[layout]
    rng = np.random.default_rng(5)
    qkv = _r(rng, B, 1 + F * N, 3 * heads * dh)
    dout = _r(rng, B, 1 + F * N, heads * dh)
    xla, vjp = jax.vjp(lambda q: jax_packed_xla(q, heads, F, mode), jnp.asarray(qkv))
    with pltpu.force_tpu_interpret_mode():
        pal = jax.jit(divided_attention_pallas, static_argnums=(1, 2, 3))(
            jnp.asarray(qkv), heads, F, mode)
        pal_bwd = jax.jit(jdab._divided_attention_bwd_pallas, static_argnums=(2, 3, 4))(
            jnp.asarray(qkv), jnp.asarray(dout), heads, F, mode)
    return dict(heads=heads, mode=mode, qkv=qkv, dout=dout, xla=xla,
                xla_bwd=vjp(jnp.asarray(dout))[0], pal=pal, pal_bwd=pal_bwd)


def test_packed_forward_matches_jax(packed_case):
    """K7a / K7b plain, and the wrapper on CPU tensors (which runs it and
    launches nothing), vs the XLA composition and divided_attention_pallas in
    interpret mode (v1 body at non-groupable heads, v3 at groupable)."""
    c = packed_case
    _build.launches.clear()
    for got in (divided_attention_packed_plain(_t(c["qkv"]), c["heads"], F, c["mode"]),
                divided_attention_packed(_t(c["qkv"]), c["heads"], F, c["mode"])):
        assert got.shape == c["dout"].shape
        _close(got, c["xla"], REF)
        _close(got, c["pal"], PALLAS)
    assert sum(_build.launches.values()) == 0


def test_packed_backward_matches_jax(packed_case):
    """K7c plain (autograd of the packed plain forward) and the wrapper on CPU
    tensors vs jax.vjp of the XLA composition and
    _divided_attention_bwd_pallas in interpret mode."""
    c = packed_case
    _build.launches.clear()
    args = (_t(c["qkv"]), _t(c["dout"]), c["heads"], F, c["mode"])
    for got in (divided_attention_packed_bwd_plain(*args), divided_attention_packed_bwd(*args)):
        assert got.shape == c["qkv"].shape
        _close(got, c["xla_bwd"], REF)
        _close(got, c["pal_bwd"], PALLAS)
    assert sum(_build.launches.values()) == 0


@pytest.mark.parametrize("mode", ["space", "time"])
def test_packed_fn_grads_match_jax(mode):
    """DividedAttentionPackedFn (K7a forward saving only qkv, K7c backward)
    and the plain route of packed_divided_attention under autograd, at 2
    heads of 96, vs jax.grad of the JAX custom VJP divided_attention (Pallas
    forward and backward in interpret mode)."""
    heads = 2
    rng = np.random.default_rng(6)
    qkv = _r(rng, B, 1 + F * N, 3 * heads * 96)
    w = _r(rng, B, 1 + F * N, heads * 96)

    def jloss(q):
        return jnp.sum(jnp.sin(jdab.divided_attention(q, heads, F, mode)) * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(jloss))(jnp.asarray(qkv))
    for fn in (lambda q: DividedAttentionPackedFn.apply(q, heads, F, mode),
               lambda q: packed_divided_attention(q, heads, F, mode, impl="plain")):
        q = _t(qkv, True)
        (torch.sin(fn(q)) * _t(w)).sum().backward()
        _close(q.grad, want, PALLAS)


def _block_sd(params):
    return convert.divided_block_sd(params["params"], "blk")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_packed_block_matches_jax(train, attn_impl):
    """DividedSpaceTimeBlock.forward_packed at 2 heads of 96 on a packed
    (B, 1 + f*n, D) x against the JAX block on the packed layout: eval
    (K2 for the MLP), and training at drop-path 0, its output and the
    gradients of x and every parameter for a sin cotangent. The JAX side runs
    its XLA path and its Pallas path (K7a, K7c, K2 in interpret mode)."""
    from synchformer_tpu.models.motionformer import DividedSpaceTimeBlock as JBlock

    heads, d = 2, 192
    rng = np.random.default_rng(7)
    x = _r(rng, B, 1 + F * N, d)
    jblk = JBlock(num_heads=heads, num_frames=F, attn_impl=attn_impl)
    params = randomize(JBlock(num_heads=heads, num_frames=F).init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    tol = REF if attn_impl == "xla" else PALLAS

    def jloss(p, xx):
        return jnp.sum(jnp.sin(jblk.apply(p, xx, deterministic=not train)))

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, xx: jblk.apply(p, xx, deterministic=not train))(
            params, jnp.asarray(x))
        if train:
            jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    blk = DividedSpaceTimeBlock(d, heads)
    convert.load_numpy_state_dict(blk, {k[4:]: v for k, v in _block_sd(params).items()})
    xt = _t(x, train)
    _build.launches.clear()
    got = blk.forward_packed(xt, F, "kernel", None, None)
    _close(got, want, tol)
    assert sum(_build.launches.values()) == 0
    if train:
        torch.sin(got).sum().backward()
        _close(xt.grad, jgrads[1], tol)
        want_sd = _block_sd(jgrads[0])
        for name, p in blk.named_parameters():
            _close(p.grad, want_sd[f"blk.{name}"], tol)


@pytest.mark.parametrize("d,heads", [(768, 12), (768, 8), (768, 6), (768, 24), (768, 16),
                                     (768, 4), (256, 4), (192, 2), (128, 2), (32, 4)])
def test_encoder_flow_matches_jax_use_split(monkeypatch, d, heads):
    """MotionFormerEncoder.packed against the flow the JAX encoder takes on
    its Pallas path (use_split, motionformer.py:554-559), read by tracing it
    abstractly with the split and packed entry points spied on."""
    from synchformer_tpu.models.motionformer import MotionFormerEncoder as JEnc

    seen = set()
    for name, flow in (("divided_attention_split", "split"),
                       ("divided_attention_proj_split", "split"),
                       ("divided_attention", "packed")):
        orig = getattr(jdab, name)
        monkeypatch.setattr(jdab, name,
                            lambda *a, _o=orig, _f=flow, **k: (seen.add(_f), _o(*a, **k))[1])
    enc = JEnc(embed_dim=d, depth=1, num_heads=heads, patch_size=8, temporal_resolution=2,
               img_size=16, attn_impl="pallas")
    x = jnp.zeros((1, 1, 4, 16, 16, 3), jnp.float32)
    jax.eval_shape(enc.init, jax.random.PRNGKey(0), x)
    assert len(seen) == 1
    assert heads_groupable(heads, d // heads) == (seen == {"split"})
    assert MotionFormerEncoder(embed_dim=d, num_heads=heads, depth=1,
                               device="meta").packed == (seen == {"packed"})


@pytest.fixture(scope="module")
def avclip_case():
    return make_case(TINY_PACKED, build_tiny_avclip_packed)


def test_tiny_packed_avclip_takes_the_packed_flow(avclip_case):
    assert build_tiny_avclip_packed(device="meta").vfeat_extractor.packed


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_packed_avclip_loss_and_grads_match_jax(avclip_case, impl):
    """The tiny packed AVCLIP (video tower 2 heads of 96): loss, every
    gradient and the global norm against jax.value_and_grad of the JAX AVCLIP
    on its XLA path (the packed flow there too)."""
    check_loss_and_grads(avclip_case, impl)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_packed_avclip_train_step_matches_jax(avclip_case, impl):
    """Parameters and metrics after one avclip_train_step against
    make_avclip_train_step."""
    check_train_step(avclip_case, impl)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_packed_avclip_eval_step_matches_jax(avclip_case, impl):
    """The eval step (K7a, K2 on the packed x, K3, K4 on impl='kernel')."""
    check_eval_step(avclip_case, impl)


def test_packed_avclip_remat_grads_equal_plain_grads(avclip_case):
    check_remat(avclip_case)


def test_packed_converter_round_trip(avclip_case):
    """avclip_state_dict_from_jax carries the packed-flow model across
    unchanged: strict load into build_tiny_avclip_packed, and the JAX
    package's own convert_avclip_checkpoint maps the port's state dict back
    onto the original tree, leaf by leaf and bit for bit."""
    from synchformer_tpu.utils.checkpoint import convert_avclip_checkpoint

    params = avclip_case["params"]
    sd = convert.avclip_state_dict_from_jax(params)
    model = build_tiny_avclip_packed()
    convert.load_numpy_state_dict(model, sd)
    got_sd = {k: v.numpy() for k, v in model.state_dict().items()}
    renamed = {k.replace("vfeat_extractor.", "v_encoder.").replace("afeat_extractor.",
                                                                     "a_encoder."): v
               for k, v in got_sd.items()}
    back = convert_avclip_checkpoint({"state_dict": renamed})
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
