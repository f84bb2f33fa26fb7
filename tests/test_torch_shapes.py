"""The shapes the port's kernels take past the main path's, against the JAX
package on the CPU (every kernel wrapper runs its plain PyTorch version on a
CPU tensor; the Pallas kernels run in interpret mode):

- the packed flow at 2 heads of 80 (D 160, depth 2, the head_dim of a
  ViT-H/14-width video tower, whose heads do not pair into 128 lanes): the
  tower's forward and its Stage I gradients against the JAX tower on its
  Pallas path (divided_attention_pallas forward, _divided_attention_bwd_pallas
  backward), tolerance as tests/test_torch_packed.py's Pallas one;
- K3's plain version at 1100 tokens (2 heads of 64, past the 1024 the port
  once refused) against _standard_attention_pallas;
- a Motionformer at temporal_resolution 32 (the time pass past the frame
  counts one block once staged) on a 2 x 2 patch grid against the JAX tower;
- K2's plain version at hidden 1996 (mlp_ratio 2.6 at D 768) against
  _ln_mlp_pallas;
- AVCLIP and MoCo with towers wider than n_embd, projected by Linear
  aproj / vproj, against the JAX modules;
- the port's routes (heads_groupable, k3_route, k2_route) against the JAX
  gates at every head_dim and width of these shapes;
- the launch plans and shape checks the kernels' wrappers run before a
  launch: they take every shape above (head_dim 16-256, K3 at 1214 and 2048
  tokens, the time pass at 32-96 frames, the GEMM at any N and K) and still
  refuse, with their reasons, a head_dim that is not a multiple of 8 or is
  past 256 and the CLS-pool shapes ROADMAP 2b keeps.

Tolerances: rtol 2e-4 / atol 3e-5 against the Pallas kernels (the
unnormalised-softmax order of the divided attention, the Pallas blocks'
degree-9 erf polynomial GELU); 1e-5 of the largest value against the JAX XLA
towers (the same math in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_models import randomize

from synchformer_tpu.ops.pallas import fused_rows as jfr
from synchformer_tpu.ops.pallas import standard_attention as jstd
from synchformer_tpu_torch.models import layers as tlayers
from synchformer_tpu_torch.models.motionformer import MotionFormerEncoder
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels import divided_attention as tda
from synchformer_tpu_torch.ops.kernels import divided_attention_bwd as tdab
from synchformer_tpu_torch.ops.kernels import fused_rows as tfr
from synchformer_tpu_torch.ops.kernels.cls_pool import fused_cls_pool_tokens
from synchformer_tpu_torch.ops.kernels.gemm import check_gemm
from synchformer_tpu_torch.ops.kernels.standard_attention import (
    groupable,
    standard_attention,
    standard_attention_plain,
)
from synchformer_tpu_torch.utils import convert

torch.set_num_threads(2)

PALLAS = dict(rtol=2e-4, atol=3e-5)
REL = 1e-5
# (heads, head_dim) of the shapes the kernels take past the main path's
HEAD_LAYOUTS = [(8, 16), (4, 40), (4, 48), (16, 80), (2, 192), (2, 256), (12, 64), (8, 96),
                (24, 32), (6, 128)]


def _r(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **tol)


def _rel_close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (err, scale)


def _frames(rng, b, s, t, img):
    u8 = rng.integers(0, 256, (b, s, t, img, img, 3), dtype=np.uint8)
    return (u8.astype(np.float32) / 255.0 - 0.5) / 0.5


def _towers(kw: dict, x, attn_impl: str):
    """The JAX Motionformer of ``kw`` on ``attn_impl``, its randomised params,
    and the port tower loaded with them."""
    from synchformer_tpu.models.motionformer import MotionFormerEncoder as JMF

    jmod = JMF(**kw, z_block_size=2, attn_impl=attn_impl)
    shapes = jax.eval_shape(lambda a: jmod.init(jax.random.PRNGKey(0), a), jnp.asarray(x))
    params = randomize(shapes)
    mod = MotionFormerEncoder(**kw)
    convert.load_numpy_state_dict(mod, convert.motionformer_sd(params["params"]))
    return jmod, params, mod


PACKED_80 = dict(embed_dim=160, depth=2, num_heads=2, patch_size=8, temporal_resolution=2,
                 img_size=32, drop_path_rate=0.0)


@pytest.fixture(scope="module")
def packed_80():
    """The tiny packed tower at 2 heads of 80, the JAX side on its Pallas path
    in interpret mode: forward (eval) and the gradients of sum(sin(out)) in
    training (drop-path 0: no randomness) with respect to every parameter."""
    x = _frames(np.random.default_rng(3), 1, 2, 4, 32)
    jmod, params, mod = _towers(PACKED_80, x, "pallas")

    def out(p, a, det):
        return jmod.apply(p, a, deterministic=det)[0]

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, a: out(p, a, True))(params, jnp.asarray(x))
        grads = jax.jit(jax.grad(lambda p, a: jnp.sum(jnp.sin(out(p, a, False)))))(
            params, jnp.asarray(x))
    return dict(x=x, mod=mod, want=want, grads=convert.motionformer_sd(grads["params"]))


def test_packed_tower_80_forward_matches_pallas(packed_80):
    """The port tower takes the packed flow at 2 heads of 80, as JAX's
    use_split sends it; its eval forward on both routes against the JAX
    tower's Pallas path (K7a's kernel in interpret mode)."""
    mod = packed_80["mod"]
    assert mod.packed and not tda.heads_groupable(2, 80)
    for impl in ("plain", "kernel"):
        with torch.no_grad():
            _close(mod(torch.from_numpy(packed_80["x"]), impl), packed_80["want"], PALLAS)


def test_packed_tower_80_grads_match_pallas(packed_80):
    """Stage I's gradients through the packed flow at 2 heads of 80
    (DividedAttentionPackedFn: K7a forward, K7c backward, the plain versions
    on the CPU) against jax.grad of the JAX tower on its Pallas path
    (divided_attention_pallas, _divided_attention_bwd_pallas)."""
    mod = packed_80["mod"]
    mod.zero_grad()
    out = mod(torch.from_numpy(packed_80["x"]), "kernel", deterministic=False,
              generator=torch.Generator().manual_seed(0))
    torch.sin(out).sum().backward()
    named = dict(mod.named_parameters())
    assert set(named) == set(packed_80["grads"])
    for name, p in named.items():
        _close(p.grad, packed_80["grads"][name], PALLAS)


def test_k3_plain_at_1100_tokens_matches_pallas():
    """K3's plain version, and its wrapper on a CPU tensor, at 1100 tokens
    (2 heads of 64) against _standard_attention_pallas in interpret mode."""
    qkv = _r(np.random.default_rng(11), 1, 1100, 3 * 128)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jstd._standard_attention_pallas, static_argnums=(1,))(
            jnp.asarray(qkv), 2)
    for fn in (standard_attention_plain, standard_attention):
        _close(fn(torch.from_numpy(qkv), 2), want, PALLAS)


def test_motionformer_32_frames_matches_jax():
    """A Motionformer at temporal_resolution 32 (64 raw frames) on a 2 x 2
    patch grid, 2 heads of 64 (the split flow: the time pass over 32 frames
    with the CLS key) against the JAX tower, on both routes."""
    kw = dict(embed_dim=128, depth=2, num_heads=2, patch_size=8, temporal_resolution=32,
              img_size=16, drop_path_rate=0.0)
    x = _frames(np.random.default_rng(5), 1, 1, 64, 16)
    jmod, params, mod = _towers(kw, x, "xla")
    want = jax.jit(lambda p, a: jmod.apply(p, a)[0])(params, jnp.asarray(x))
    assert not mod.packed
    for impl in ("plain", "kernel"):
        with torch.no_grad():
            _rel_close(mod(torch.from_numpy(x), impl), want)


def test_k2_plain_at_hidden_1996_matches_pallas():
    """K2's plain version, and its wrapper on a CPU tensor, at hidden 1996
    (int(768 * 2.6)) against _ln_mlp_pallas in interpret mode."""
    rng = np.random.default_rng(12)
    d, h = 128, 1996
    x, g, b = _r(rng, 2, 9, d, s=2.0), 1 + _r(rng, d, s=0.1), _r(rng, d, s=0.1)
    w1, b1 = _r(rng, h, d, s=d ** -0.5), _r(rng, h, s=0.1)
    w2, b2 = _r(rng, d, h, s=h ** -0.5), _r(rng, d, s=0.1)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda *a: jfr._ln_mlp_pallas(*a, 1e-6))(
            jnp.asarray(x), g, b, jnp.asarray(w1.T), b1, jnp.asarray(w2.T), b2)
    args = [torch.from_numpy(a) for a in (x, g, b, w1, b1, w2, b2)]
    for got in (tfr.ln_mlp_residual_plain(*args, 1e-6), tfr.fused_ln_mlp_residual(*args, 1e-6)):
        _close(got, want, PALLAS)


@pytest.mark.parametrize("moco", [False, True], ids=["avclip", "moco"])
def test_stage1_towers_keep_their_width(moco):
    """AVCLIP and MoCo from the registry with towers 128 wide under n_embd
    96, Linear projections 128 -> 96 (the layout of a ViT-H-width video
    tower under a 768-wide Stage I): each tower keeps its node's width, as
    the JAX module builds it, and the normalised features equal the JAX
    module's (XLA path) on the same parameters, 1e-5 of the largest value."""
    import copy

    from test_torch_dropouts import batch_np, model_node

    from synchformer_tpu.registry import instantiate_from_config as jax_instantiate
    from synchformer_tpu_torch.registry import instantiate_from_config

    node = model_node(moco)
    lin = dict(target="torch.nn.Linear", params=dict(in_features=128, out_features=96))
    node["params"].update(n_embd=96, aproj=lin, vproj=copy.deepcopy(lin))
    frames, aud = batch_np(2)
    jmodel = jax_instantiate(copy.deepcopy(node))
    params = randomize(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                      jnp.asarray(frames), jnp.asarray(aud)))
    out = jax.jit(jmodel.apply)(params, jnp.asarray(frames), jnp.asarray(aud))
    model = instantiate_from_config(copy.deepcopy(node))
    to_sd = convert.moco_state_dict_from_jax if moco else convert.avclip_state_dict_from_jax
    convert.load_numpy_state_dict(model, to_sd(params["params"]))  # strict, shapes checked
    with torch.no_grad():
        got = model(torch.from_numpy(frames), torch.from_numpy(aud), "kernel")
    if moco:
        for key in ("segment_vfeat", "segment_afeat", "global_vfeat", "global_afeat"):
            assert got[key].shape[-1] == 96
            _rel_close(got[key], out[key])
    else:
        assert got[1].shape[-1] == got[2].shape[-1] == 96
        _rel_close(got[1], out["rgb_features"][0])
        _rel_close(got[2], out["audio_features"][0])


@pytest.mark.parametrize("heads,dh", HEAD_LAYOUTS)
def test_routes_follow_the_jax_gates(heads, dh):
    """The port's lane rule (the Motionformer's flow), K3's gate and K2's
    route against the JAX package's: standard_attention.groupable, the
    encoder's inline use_split rule (motionformer.py:554-559) and the
    PreLNBlock's K2 condition, which no width enters."""
    hpg = max(1, 128 // dh)
    use_split = heads % hpg == 0 and (dh * hpg) % 128 == 0
    assert jstd.groupable(heads, dh) == use_split
    assert tda.heads_groupable(heads, dh) == use_split == groupable(heads, dh)
    assert tlayers.k3_route("kernel", heads, dh, None, False) == jstd.groupable(heads, dh)
    assert not tlayers.k3_route("plain", heads, dh, None, False)
    assert tlayers.k2_route("kernel", None, False) and not tlayers.k2_route("plain", None, False)


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


def _z(*shape, dtype=torch.bfloat16):
    return torch.zeros(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("heads,dh", HEAD_LAYOUTS)
@pytest.mark.parametrize("mode", ["space", "time"])
def test_attention_wrappers_take_every_head_dim(as_if_on_card, heads, dh, mode):
    """K5, K6 (split) and K7, K7c (packed) reach their launch at every
    head_dim of HEAD_LAYOUTS (any multiple of 8 up to 256), at a ragged
    frame of 37 patches (meta tensors: no data)."""
    d, f, n = heads * dh, 8, 37
    calls = [lambda: tda.divided_attention(_z(1, f, n, 3 * d), _z(1, 1, 3 * d), heads, mode),
             lambda: tdab.divided_attention_bwd(_z(1, f, n, 3 * d), _z(1, 1, 3 * d),
                                                _z(1, f, n, d), _z(1, 1, d), heads, mode),
             lambda: tda.divided_attention_packed(_z(1, 1 + f * n, 3 * d), heads, f, mode),
             lambda: tdab.divided_attention_packed_bwd(_z(1, 1 + f * n, 3 * d),
                                                       _z(1, 1 + f * n, d), heads, f, mode)]
    for call in calls:
        with pytest.raises(_Launched):
            call()


@pytest.mark.parametrize("n,heads", [(1214, 12), (2048, 12), (74, 24), (1214, 24), (74, 6),
                                     (1214, 6)])
def test_k3_takes_long_sequences_and_every_head_dim(as_if_on_card, n, heads):
    """K3 past 1024 tokens (the AudioSet AST's 1214) and at head_dim 32 and
    128 reaches its launch."""
    with pytest.raises(_Launched):
        standard_attention(_z(8, n, 3 * 768), heads)


def test_plans_take_the_new_shapes():
    """The plans the wrappers and the CUDA launches share take every shape of
    this slice: the time pass at 32 and 96 frames forward and 32 and 64
    backward at D 768 (12 x 64) and 1280 (16 x 80), a group of heads a block
    where all of them do not fit; the backward's space pass at every width;
    the Hopper GEMM at N and K of 1996, 1000 and 520 (the tail epilogue)."""
    for d, heads in ((768, 12), (1280, 16)):
        for f in (32, 96):
            plan = _build.time_pass_plan(f, 196, d, heads)
            assert plan["smem"] <= _build.MAX_SMEM
            assert plan["heads_a_block"] * plan["head_groups"] == heads
        for f in (32, 64):
            plan = _build.time_bwd_plan(f, 196, d, heads)
            assert plan["smem"] <= _build.MAX_SMEM and plan["warps"] >= 1
            assert plan["heads_a_block"] * plan["head_groups"] == heads
    for dh in (16, 40, 48, 80, 192, 256):
        assert _build.padded_width(dh) in _build.ATTN_WIDTHS
        for n in (1, 37, 196, 300):
            plan = _build.space_bwd_plan(n, dh)
            assert plan["smem"] <= _build.MAX_SMEM
            assert plan["key_chunks"] * plan["chunk_tiles"] >= plan["key_tiles"]
    for m, n, k in ((129, 1996, 768), (43904, 768, 1996), (300, 1000, 520), (127, 520, 1000)):
        plan = _build.gemm_plan(m, n, k)
        assert plan["tail"] == (n % 128 != 0)
        assert plan["tiles_n"] * plan["bn"] >= n > (plan["tiles_n"] - 1) * plan["bn"]


def test_k2_takes_hidden_1996(as_if_on_card):
    """K2 and K8b reach their launch at hidden 1996, W2 contiguous or held at
    a 16-byte pitch; ``pitched`` lays a weight out there in the compute
    dtype (zeroed pad, differentiable), returns one already there as it is,
    and Synchformer.cast_matrices_ lays a fc2 of 1996 columns out so once."""
    from synchformer_tpu_torch.models.presets import build_synchformer

    d, h = 768, 1996
    w2 = torch.randn(d, h)
    view = tfr.pitched(w2, torch.bfloat16)
    assert view.stride(0) == 2000 and view.dtype == torch.bfloat16
    assert tfr.pitched(view) is view and tfr.pitched(view, torch.bfloat16) is view
    assert torch.equal(view, w2.to(torch.bfloat16))
    assert not view.as_strided((d, 2000), (2000, 1)).narrow(1, h, 4).any()
    check_gemm("T", 18, view, torch.zeros(d))
    for w in (w2.to(torch.bfloat16), view):
        args = [torch.zeros(2, 9, d, dtype=torch.bfloat16), torch.ones(d), torch.zeros(d),
                torch.zeros(h, d, dtype=torch.bfloat16), torch.zeros(h), w, torch.zeros(d)]
        with pytest.raises(_Launched):
            tfr._ln_mlp(*args, 1e-6, False)
    w2.requires_grad_()
    tfr.pitched(w2, torch.bfloat16).float().sum().backward()
    assert torch.equal(w2.grad, torch.ones(d, h))
    model = build_synchformer(1, device="meta")
    fc2 = model.vfeat_extractor.blocks[0].mlp.fc2
    fc2.weight.data = torch.empty(d, h, device="meta")
    model.cast_matrices_(torch.bfloat16)
    assert fc2.weight.dtype == torch.bfloat16 and fc2.weight.stride(0) == 2000


@pytest.mark.parametrize("d,heads,why", [(768, 21, "split"), (528, 2, "head_dim"),
                                         (36, 1, "head_dim")])
def test_attention_refuses_what_roadmap_keeps(as_if_on_card, d, heads, why):
    """A head_dim that is not a multiple of 8 (768 / 21 does not divide; 36)
    or is past 256 (264) is refused before any launch, with its reason."""
    with pytest.raises(ValueError, match=why):
        tda.divided_attention_packed(_z(1, 1 + 8 * 4, 3 * d), heads, 8, "space")


@pytest.mark.parametrize("d,heads,hidden", [(800, 8, 3200), (768, 24, 3072), (2560, 16, 10240)])
def test_cls_pool_refuses_what_roadmap_keeps(as_if_on_card, d, heads, hidden):
    """K4 still refuses D % 64 != 0, more than 16 heads and D past 2304 at 16
    heads (ROADMAP 2b: no configuration reaches them)."""
    f32 = torch.float32
    args = [torch.zeros(2, 5, d, dtype=torch.bfloat16), torch.zeros(d), torch.ones(d),
            torch.zeros(d), torch.zeros(3 * d, d, dtype=torch.bfloat16), torch.zeros(3 * d),
            torch.zeros(d, d, dtype=torch.bfloat16), torch.zeros(d), torch.ones(d),
            torch.zeros(d), torch.zeros(hidden, d, dtype=torch.bfloat16),
            torch.zeros(hidden, dtype=f32), torch.zeros(d, hidden, dtype=torch.bfloat16),
            torch.zeros(d)]
    with pytest.raises(ValueError):
        fused_cls_pool_tokens(*args, num_heads=heads, eps=1e-6)
