"""attn_impl='pallas_fused' in the port against the JAX package on the CPU:
K8a (LN + QKV + divided attention), K8b (LN + MLP + residual) and K8c (LN +
matmul), the packed block and the encoder's split flow on that route, and the
tiny sync model with a packed-flow video tower through SyncPredictor. On CPU
tensors every kernel wrapper runs its plain PyTorch version and launches
nothing. Inputs come from numpy seeds; everything is f32; the JAX sides run
under jax.jit, their Pallas kernels under pltpu.force_tpu_interpret_mode().

Tolerances, as tests/test_torch_packed.py:
- against the XLA compositions (and jax.grad of them): rtol = atol = 1e-5,
  the same math with f32 sums in another order;
- against the Pallas kernels, their custom VJPs and what runs them
  (_fused_attention_ref runs the Pallas divided attention; the Pallas blocks):
  rtol 2e-4 / atol 3e-5, for the unnormalised-softmax order of the divided
  attention and the degree-9 erf polynomial GELU of K8b and K2 (|err| <=
  3e-5; the port's plain versions use exact erf);
- the tiny sync model: tests/test_torch_slice.py's SLICE_TOL (atol 1e-4).
The tiny Stage I step on this route is tests/test_torch_fused_train.py.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_models import JAX_VIS, N_PATCH, PATCH_K, randomize
from test_torch_packed import jax_packed_xla
from test_torch_slice import SLICE_TOL

from synchformer_tpu.ops.pallas import fused_block as jfb
from synchformer_tpu.ops.pallas import fused_rows as jfr
from synchformer_tpu_torch.infer import SyncPredictor
from synchformer_tpu_torch.models import motionformer as tmf
from synchformer_tpu_torch.models.presets import (
    TINY,
    TINY_PACKED,
    build_tiny_avclip_packed,
    build_tiny_synchformer,
)
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels.fused_block import (
    fused_divided_attention,
    fused_mlp_residual,
)
from synchformer_tpu_torch.ops.kernels.fused_rows import fused_ln_matmul
from synchformer_tpu_torch.ops.video import patchify_frames
from synchformer_tpu_torch.utils import convert

torch.set_num_threads(2)

REF = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(rtol=2e-4, atol=3e-5)
B, F, N = 2, 3, 8
SEQ = 1 + F * N
# (heads, head_dim): tests/test_fused_block.py's 4 heads of 8, and 2 of 96
# (the 8-head tower's head_dim)
LAYOUTS = {"4x8": (4, 8), "2x96": (2, 96)}
ROUTES = ["plain", "kernel"]


def _r(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **tol)


def _ln(rng, d):
    return 1.0 + _r(rng, d, s=0.1), _r(rng, d, s=0.1)


def _jax_sides(fns, args, cot):
    """{name: (value, grads of every argument)} of each (fn, interpret) in
    ``fns`` for the loss sum(sin(fn(*args)) * cot), under jax.jit."""
    args = tuple(jnp.asarray(a) for a in args)
    out = {}
    for name, (fn, interpret) in fns.items():
        def loss(*a, fn=fn):
            return jnp.sum(jnp.sin(fn(*a)) * cot)

        with pltpu.force_tpu_interpret_mode() if interpret else contextlib.nullcontext():
            out[name] = (jax.jit(fn)(*args),
                         jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(*args))
    return out


TOLS = {"xla": REF, "ref": PALLAS, "pallas": PALLAS}


def _check_port(port_fn, args, cot, jax_out, transposed=()):
    """Run ``port_fn`` on ``args`` (numpy; the indices in ``transposed`` are
    JAX (in, out) matrices, handed to the port as (out, in)) under autograd
    and hold its value and the gradient of every argument against each JAX
    side; nothing may launch."""
    leaves = [_t(a.T if i in transposed else a, True) for i, a in enumerate(args)]
    _build.launches.clear()
    out = port_fn(*leaves)
    (torch.sin(out) * _t(cot)).sum().backward()
    assert sum(_build.launches.values()) == 0
    for name, (value, grads) in jax_out.items():
        _close(out, value, TOLS[name])
        for i, (leaf, want) in enumerate(zip(leaves, grads)):
            got = leaf.grad.T if i in transposed else leaf.grad
            _close(got, want, TOLS[name])


@pytest.fixture(scope="module", params=[(lay, m) for lay in LAYOUTS for m in ("space", "time")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def attn_case(request):
    """K8a's inputs and the JAX sides: the XLA composition (LN, dense, the
    packed divided attention), _fused_attention_ref and
    fused_divided_attention (Pallas, interpret mode), values and grads."""
    layout, mode = request.param
    heads, dh = LAYOUTS[layout]
    d = heads * dh
    rng = np.random.default_rng(11)
    args = (_r(rng, B, SEQ, d), *_ln(rng, d), _r(rng, d, 3 * d, s=d ** -0.5),
            _r(rng, 3 * d, s=0.02))
    cot = _r(rng, B, SEQ, d)

    def xla(x, g, b, w, bias):
        qkv = jfb.dense(jfb.layer_norm(x, g, b, 1e-6, x.dtype), w, bias, x.dtype)
        return jax_packed_xla(qkv, heads, F, mode)

    fns = {"xla": (xla, False),
           "ref": (lambda *a: jfb._fused_attention_ref(*a, heads, F, mode, 1e-6), True),
           "pallas": (lambda *a: jfb.fused_divided_attention(*a, heads, F, mode), True)}
    return dict(heads=heads, mode=mode, args=args, cot=cot, jax=_jax_sides(fns, args, cot))


@pytest.mark.parametrize("route", ROUTES)
def test_fused_attention_matches_jax(attn_case, route):
    """K8a: fused_divided_attention on the plain route and on the kernel route
    (FusedDividedAttentionFn: the plain forward on CPU tensors, backward
    through the recomputed LN + QKV and K7c's plain version), values and the
    gradients of x, the LN params, w and the bias."""
    c = attn_case
    _check_port(lambda *a: fused_divided_attention(*a, c["heads"], F, c["mode"], impl=route),
                c["args"], c["cot"], c["jax"], transposed=(3,))


@pytest.fixture(scope="module")
def mlp_case():
    """K8b's inputs (D = 32, hidden 128) and the JAX sides: _fused_mlp_ref
    (XLA, exact GELU) and fused_mlp_residual (Pallas, polynomial GELU)."""
    d, h = 32, 128
    rng = np.random.default_rng(12)
    args = (_r(rng, B, SEQ, d), *_ln(rng, d), _r(rng, d, h, s=d ** -0.5), _r(rng, h, s=0.02),
            _r(rng, h, d, s=h ** -0.5), _r(rng, d, s=0.02))
    cot = _r(rng, B, SEQ, d)
    fns = {"xla": (lambda *a: jfb._fused_mlp_ref(*a, 1e-6), False),
           "pallas": (jfb.fused_mlp_residual, True)}
    return dict(args=args, cot=cot, jax=_jax_sides(fns, args, cot))


@pytest.mark.parametrize("route", ROUTES)
def test_fused_mlp_matches_jax(mlp_case, route):
    """K8b: fused_mlp_residual on both routes (FusedMlpFn on the kernel
    route), values and the gradients of all seven inputs."""
    c = mlp_case
    _check_port(lambda *a: fused_mlp_residual(*a, impl=route), c["args"], c["cot"], c["jax"],
                transposed=(3, 5))


@pytest.fixture(scope="module")
def ln_matmul_case():
    """K8c's inputs (tests/test_fused_rows.py's shapes) and the JAX sides:
    _ln_matmul_ref (XLA) and fused_ln_matmul (Pallas)."""
    d, dout = 64, 192
    rng = np.random.default_rng(13)
    args = (_r(rng, 2, 24, d), *_ln(rng, d), _r(rng, d, dout, s=1 / 8), _r(rng, dout, s=0.02))
    cot = _r(rng, 2, 24, dout)
    fns = {"xla": (lambda *a: jfr._ln_matmul_ref(*a, 1e-6), False),
           "pallas": (jfr.fused_ln_matmul, True)}
    return dict(args=args, cot=cot, jax=_jax_sides(fns, args, cot))


@pytest.mark.parametrize("route", ROUTES)
def test_fused_ln_matmul_matches_jax(ln_matmul_case, route):
    """K8c: fused_ln_matmul on both routes (LnMatmulFn on the kernel route),
    values and the gradients of all five inputs."""
    c = ln_matmul_case
    _check_port(lambda *a: fused_ln_matmul(*a, impl=route), c["args"], c["cot"], c["jax"],
                transposed=(3,))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fused_packed_block_matches_jax(train):
    """DividedSpaceTimeBlock.forward_packed on attn_impl='pallas_fused' (K8a
    for both attentions, K8b for the MLP) at 2 heads of 96 against the JAX
    block with attn_impl='pallas_fused' (K8a, K8b, K7c in interpret mode):
    eval, and training at drop-path 0 with the gradients of x and every
    parameter for a sin loss."""
    from synchformer_tpu.models.motionformer import DividedSpaceTimeBlock as JBlock

    heads, d, f, n = 2, 192, 2, 8
    rng = np.random.default_rng(7)
    x = _r(rng, B, 1 + f * n, d)
    jblk = JBlock(num_heads=heads, num_frames=f, attn_impl="pallas_fused")
    params = randomize(JBlock(num_heads=heads, num_frames=f).init(
        jax.random.PRNGKey(0), jnp.asarray(x)))

    def jloss(p, xx):
        return jnp.sum(jnp.sin(jblk.apply(p, xx, deterministic=not train)))

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, xx: jblk.apply(p, xx, deterministic=not train))(
            params, jnp.asarray(x))
        if train:
            jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    blk = tmf.DividedSpaceTimeBlock(d, heads, attn_impl="pallas_fused")
    sd = convert.divided_block_sd(params["params"], "blk")
    convert.load_numpy_state_dict(blk, {k[4:]: v for k, v in sd.items()})
    xt = _t(x, train)
    _build.launches.clear()
    got = blk.forward_packed(xt, f, "kernel", None, None)
    _close(got, want, PALLAS)
    if train:
        torch.sin(got).sum().backward()
        _close(xt.grad, jgrads[1], PALLAS)
        want_sd = convert.divided_block_sd(jgrads[0]["params"], "blk")
        for name, p in blk.named_parameters():
            _close(p.grad, want_sd[f"blk.{name}"], PALLAS)
    assert sum(_build.launches.values()) == 0


@pytest.fixture(scope="module")
def split_case():
    """The tiny split-flow tower (TINY: 4 heads of 64) and the JAX tower's
    eval output on attn_impl='pallas_fused' (K5, K2, K4 in interpret mode)."""
    from synchformer_tpu.models.motionformer import MotionFormerEncoder as JMF

    x = np.random.default_rng(0).standard_normal(
        (1, 2, TINY["temporal_resolution"], N_PATCH, PATCH_K)).astype(np.float32)
    params = randomize(JMF(**JAX_VIS).init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jmod = JMF(**JAX_VIS, attn_impl="pallas_fused")
    with pltpu.force_tpu_interpret_mode():
        want, _ = jax.jit(lambda p, xx: jmod.apply(p, xx))(params, jnp.asarray(x))
    return x, params, np.asarray(want)


@pytest.mark.parametrize("route", ROUTES)
def test_fused_split_flow_eval_matches_jax(split_case, monkeypatch, route):
    """The split flow's eval on attn_impl='pallas_fused': K5 (the training
    block's attention with no drop-path), the projection and residual
    outside, K2 without statistics, a plain final norm; neither K1 nor the
    statistics chain may run."""
    x, params, want = split_case
    mod = tmf.MotionFormerEncoder(embed_dim=TINY["d"], depth=TINY["depth"],
                                  num_heads=TINY["heads"], patch_size=TINY["patch_size"],
                                  temporal_resolution=TINY["temporal_resolution"],
                                  img_size=TINY["img_size"], attn_impl="pallas_fused")
    convert.load_numpy_state_dict(mod, convert.motionformer_sd(params["params"]))
    assert not mod.packed
    seen = []

    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"{name} runs on the 'pallas' route only")
        return fn

    monkeypatch.setattr(tmf, "divided_attention_proj", refuse("K1"))
    monkeypatch.setattr(tmf, "layer_norm_from_stats", refuse("the statistics chain"))
    orig = tmf.divided_attention_split
    monkeypatch.setattr(tmf, "divided_attention_split",
                        lambda *a, **k: (seen.append(a[-1]), orig(*a, **k))[1])
    _build.launches.clear()
    got = mod(torch.from_numpy(x), route)
    assert sum(_build.launches.values()) == 0
    assert seen == ["time", "space"] * TINY["depth"]
    _close(got, want, PALLAS)


def _jax_tiny_packed_synchformer(n_segments: int):
    """The JAX Synchformer at TINY_PACKED's widths, both towers on
    attn_impl='pallas_fused' (the AST takes it as 'pallas')."""
    from synchformer_tpu.models.sync_model import Synchformer

    t, d = TINY_PACKED, TINY_PACKED["d"]
    vis = dict(embed_dim=d, depth=t["depth"], num_heads=t["heads"], patch_size=t["patch_size"],
               z_block_size=2, temporal_resolution=t["temporal_resolution"],
               img_size=t["img_size"], drop_path_rate=0.0, attn_impl="pallas_fused")
    aud = dict(hidden_size=d, depth=t["depth"], num_heads=t["audio_heads"],
               attn_impl="pallas_fused")
    seq = 2 + n_segments * (t["temporal_resolution"] + 6)
    gt = dict(n_layer=t["n_layer"], n_head=t["heads"], n_embd=d, tok_pdrop=0.0,
              pos_emb_cfg=dict(target="synchformer_tpu.models.pos_emb.RandInitPositionalEncoding",
                               params=dict(block_shape=[seq], n_embd=d)),
              off_head_cfg=dict(target="torch.nn.Linear",
                                params=dict(in_features=d, out_features=21)))
    lin = dict(target="torch.nn.Linear", params=dict(in_features=d, out_features=d))
    return Synchformer(
        afeat_extractor=dict(target="synchformer_tpu.models.ast_encoder.ASTEncoder", params=aud),
        vfeat_extractor=dict(target="synchformer_tpu.models.motionformer.MotionFormerEncoder",
                             params=vis),
        aproj=lin, vproj=lin,
        transformer=dict(target="synchformer_tpu.models.sync_model.GlobalTransformer",
                         params=gt))


@pytest.fixture(scope="module")
def slice_case():
    """The tiny packed-flow Synchformer's params, inputs and the JAX infer's
    logits and probabilities (bench.py's composition, as
    tests/test_torch_slice.py), S=2, B=2."""
    from synchformer_tpu.ops.mel import log_mel_spectrogram
    from synchformer_tpu.ops.video import fold_video_normalize

    s, t = 2, TINY_PACKED
    model = _jax_tiny_packed_synchformer(s)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (B, s, 2 * t["temporal_resolution"], t["img_size"],
                                   t["img_size"], 3), dtype=np.uint8)
    video = patchify_frames(frames, 2, t["patch_size"])
    pcm = (rng.standard_normal((B, s, 10240)) * 0.1).astype(np.float32)
    params = randomize(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, *video.shape[1:])), jnp.zeros((1, s, 66, 128))))

    def infer(params, video_u8_patches, pcm):
        aud = jnp.swapaxes(log_mel_spectrogram(pcm), -1, -2)
        _, logits = model.apply(params, video_u8_patches, aud)
        return logits, jax.nn.softmax(logits.astype(jnp.float32), -1)

    with pltpu.force_tpu_interpret_mode():
        logits, probs = jax.jit(infer)(fold_video_normalize(params), jnp.asarray(video),
                                       jnp.asarray(pcm))
    return params, video, pcm, np.asarray(logits), np.asarray(probs)


def _predictor(params, attn_impl, impl):
    model = build_tiny_synchformer(2, t=TINY_PACKED, attn_impl=attn_impl)
    convert.load_numpy_state_dict(model, convert.state_dict_from_jax(params))
    return SyncPredictor(model, "cpu", torch.float32, impl)


@pytest.mark.parametrize("route", ROUTES)
def test_fused_sync_predictor_matches_jax_infer(slice_case, route):
    """SyncPredictor on the tiny Synchformer whose video tower (2 heads of 96)
    runs the packed flow on attn_impl='pallas_fused', against the JAX infer
    with attn_impl='pallas_fused' (Pallas kernels in interpret mode)."""
    params, video, pcm, want_logits, want_probs = slice_case
    pred = _predictor(params, "pallas_fused", route)
    assert pred.model.vfeat_extractor.packed
    _build.launches.clear()
    video_t, pcm_t = torch.from_numpy(np.ascontiguousarray(video)), torch.from_numpy(pcm)
    logits = pred.logits(video_t, pcm_t)
    assert sum(_build.launches.values()) == 0
    assert logits.shape == (B, 21)
    np.testing.assert_allclose(logits.numpy(), want_logits, **SLICE_TOL)
    np.testing.assert_allclose(pred(video_t, pcm_t).numpy(), want_probs, **SLICE_TOL)


def test_plain_route_is_the_same_on_both_attn_impls(slice_case):
    """One state dict gives bit-identical plain-route logits on 'pallas' and
    'pallas_fused' (the plain versions are the same composition), so the
    'pallas' route's plain runs can stand as the fused route's references."""
    params, video, pcm, _, _ = slice_case
    video_t, pcm_t = torch.from_numpy(np.ascontiguousarray(video)), torch.from_numpy(pcm)
    a, b = (_predictor(params, attn_impl, "plain").logits(video_t, pcm_t)
            for attn_impl in ("pallas", "pallas_fused"))
    assert torch.equal(a, b)


def test_plain_training_step_is_the_same_on_both_attn_impls():
    """The tiny packed AVCLIP at drop-path 0.2 from one seeded state dict and
    one generator seed: the plain route's loss and every gradient are
    bit-identical on 'pallas' and 'pallas_fused', as chip_smoke.py's phase 7
    assumes when it holds the fused kernel step against phase 6's plain runs."""
    from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer

    builds = {a: functools.partial(build_tiny_avclip_packed, drop_path_rate=0.2, attn_impl=a)
              for a in ("pallas", "pallas_fused")}
    sd = convert.seeded_state_dict(builds["pallas"](device="meta"), seed=0)
    rng = np.random.default_rng(2)
    batch = {"video": rng.integers(0, 256, (2, 2, 4, 32, 32, 3), dtype=np.uint8),
             "audio": (rng.standard_normal((2, 2, 10240)) * 0.1).astype(np.float32)}
    out = {}
    for name, build in builds.items():
        model = build()
        convert.load_numpy_state_dict(model, sd)
        tr = AVCLIPTrainer({"training": {"seed": 0, "precision": "fp32"},
                            "data": {"p_horizontal_flip": 0.5}},
                           device="cpu", model=model, impl="plain")
        m = tr.train_step(batch)
        out[name] = (m["loss"], {n: p.grad.clone() for n, p in model.named_parameters()})
    (loss_a, grads_a), (loss_b, grads_b) = out.values()
    assert loss_a == loss_b
    assert all(torch.equal(grads_a[n], grads_b[n]) for n in grads_a)
