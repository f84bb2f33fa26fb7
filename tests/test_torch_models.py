"""The port's model modules (synchformer_tpu_torch/models, ops/mel.py,
ops/video.py) against the JAX package on the CPU.

Each port module gets the JAX module's parameters through
synchformer_tpu_torch.utils.convert and the same numpy inputs; both run in
f32. Tolerance rtol = atol = 1e-5 (the same math; f32 sums in another order)
unless a test states otherwise. JAX modules run on their XLA path, except
where a test names the Pallas path in interpret mode (then rtol 2e-4 /
atol 3e-5: the Pallas kernels' degree-9 erf polynomial for GELU, |err| <=
3e-5, where the port uses exact erf).

The helpers here are shared by the other tests/test_torch_*.py files.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from synchformer_tpu_torch.models import aggregators as tagg
from synchformer_tpu_torch.models.layers import BlockParams, preln_block
from synchformer_tpu_torch.models.presets import TINY
from synchformer_tpu_torch.models.sync_model import GlobalTransformer
from synchformer_tpu_torch.ops import mel as tmel
from synchformer_tpu_torch.ops import video as tvideo
from synchformer_tpu_torch.utils import convert

torch.set_num_threads(2)

D, HEADS = TINY["d"], TINY["heads"]
REF = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(rtol=2e-4, atol=3e-5)

# JAX configs matching synchformer_tpu_torch.models.presets.build_tiny_synchformer
JAX_VIS = dict(embed_dim=D, depth=TINY["depth"], num_heads=HEADS,
               patch_size=TINY["patch_size"], z_block_size=2,
               temporal_resolution=TINY["temporal_resolution"], img_size=TINY["img_size"],
               drop_path_rate=0.0)
JAX_AUD = dict(hidden_size=D, depth=TINY["depth"], num_heads=HEADS)
N_PATCH = (TINY["img_size"] // TINY["patch_size"]) ** 2
PATCH_K = 2 * TINY["patch_size"] ** 2 * 3


def seq_len(n_segments: int) -> int:
    return 2 + n_segments * (TINY["temporal_resolution"] + 6)


def jax_gt_cfg(n_segments: int) -> dict:
    return dict(
        n_layer=TINY["n_layer"], n_head=HEADS, n_embd=D, tok_pdrop=0.0,
        pos_emb_cfg=dict(target="synchformer_tpu.models.pos_emb.RandInitPositionalEncoding",
                         params=dict(block_shape=[seq_len(n_segments)], n_embd=D)),
        off_head_cfg=dict(target="torch.nn.Linear",
                          params=dict(in_features=D, out_features=21)))


def randomize(tree, seed: int = 1):
    """Replace every leaf: LayerNorm scales 1 + 0.1 N(0, 1), the rest 0.05 N(0, 1)
    (zero-init leaves such as the patch embed become non-trivial)."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        last = getattr(path[-1], "key", None)
        leaves.append(1.0 + 0.1 * noise if last == "scale" else 0.05 * noise)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def jit_apply(module, **static):
    """module.apply under jax.jit, with ``static`` as its Python keyword
    arguments (the Pallas interpret path runs for minutes op by op and for
    seconds compiled)."""
    return jax.jit(lambda params, *args: module.apply(params, *args, **static))


def strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def close(got, want, tol=REF):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **tol)


def block_params(p) -> BlockParams:
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return BlockParams(
        t(p["ln1"]["scale"]), t(p["ln1"]["bias"]), t(p["attn"]["qkv"]["kernel"]).T,
        t(p["attn"]["qkv"]["bias"]), t(p["attn"]["proj"]["kernel"]).T,
        t(p["attn"]["proj"]["bias"]), t(p["ln2"]["scale"]), t(p["ln2"]["bias"]),
        t(p["mlp"]["fc1"]["kernel"]).T, t(p["mlp"]["fc1"]["bias"]),
        t(p["mlp"]["fc2"]["kernel"]).T, t(p["mlp"]["fc2"]["bias"]))


@pytest.mark.parametrize("route", ["plain", "kernel", "cls_plain", "cls_kernel"])
def test_preln_block_routes_match_jax(rng, route):
    """PreLNBlock: the full block (plain, and K3 + K2 on the kernel route)
    and the query_rows=1 + cls_row block (plain, and K4 on the kernel route),
    against JAX PreLNBlock's XLA path; the kernel routes also against its
    Pallas path in interpret mode."""
    from synchformer_tpu.models.layers import PreLNBlock

    x = jnp.asarray(rng.standard_normal((3, 10, D)).astype(np.float32))
    cls = jnp.asarray(rng.standard_normal((1, D)).astype(np.float32))
    cls_route = route.startswith("cls")

    def run(impl):
        blk = PreLNBlock(num_heads=HEADS, ln_eps=1e-6, impl=impl)
        if cls_route:
            return jax.jit(lambda p: blk.apply(p, x, query_rows=1, cls_row=cls))
        return jax.jit(lambda p: blk.apply(p, x))

    kw = dict(query_rows=1, cls_row=cls) if cls_route else {}
    params = randomize(PreLNBlock(num_heads=HEADS, ln_eps=1e-6).init(
        jax.random.PRNGKey(0), x, **kw))
    want = run("xla")(params)
    impl = route.split("_")[-1]
    tkw = dict(query_rows=1, cls_row=torch.tensor(np.asarray(cls))) if cls_route else {}
    got = preln_block(torch.tensor(np.asarray(x)), block_params(params["params"]),
                      HEADS, 1e-6, impl, **tkw)
    close(got, want)
    if impl == "kernel":
        with pltpu.force_tpu_interpret_mode():
            pal = run("pallas")(params)
        close(got, pal, PALLAS)


@pytest.mark.parametrize("which", ["spatial", "frequency"])
def test_aggregators_match_jax(rng, which):
    """SpatialAggregator (B*S, t, h, w, D) and FrequencyAggregator (B*S, f, t,
    D) on both routes (the kernel route goes through K4's wrapper)."""
    from synchformer_tpu.models import aggregators as jagg

    if which == "spatial":
        x = rng.standard_normal((2, 2, 4, 4, D)).astype(np.float32)
        jmod, tcls = jagg.SpatialAggregator(num_heads=HEADS), tagg.SpatialAggregator
    else:
        x = rng.standard_normal((2, 12, 3, D)).astype(np.float32)
        jmod, tcls = jagg.FrequencyAggregator(num_heads=HEADS), tagg.FrequencyAggregator
    params = randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jit_apply(jmod)(params, jnp.asarray(x))
    mod = tcls(D, HEADS)
    sd = convert.cls_pool_layer_sd(params["params"]["cls_layer"], "agg")
    convert.load_numpy_state_dict(mod, strip(sd, "agg."))
    for impl in ("plain", "kernel"):
        got = mod(torch.from_numpy(x), impl)
        assert got.shape == want.shape
        close(got, want)


def test_global_transformer_matches_jax(rng):
    """GlobalTransformer (no TPU kernel: plain attention on every route)."""
    from synchformer_tpu.models.sync_model import GlobalTransformer as JGT

    s = 2
    v = rng.standard_normal((2, s * TINY["temporal_resolution"], D)).astype(np.float32)
    a = rng.standard_normal((2, s * 6, D)).astype(np.float32)
    jmod = JGT(**jax_gt_cfg(s))
    params = randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(v), jnp.asarray(a)))
    want = jit_apply(jmod)(params, jnp.asarray(v), jnp.asarray(a))
    mod = GlobalTransformer(TINY["n_layer"], HEADS, D, seq_len=seq_len(s), num_cls=21)
    convert.load_numpy_state_dict(mod, convert.global_transformer_sd(params["params"], ""))
    got = mod(torch.from_numpy(v), torch.from_numpy(a))
    assert got.shape == (2, 21)
    close(got, want)


def test_log_mel_matches_jax(rng):
    """Same constants and window-folded DFT; tolerance 2e-4 absolute on the
    normalised log-mel (f32 DFT sums of 1024 terms in another order, then a
    log of small powers)."""
    from synchformer_tpu.ops.mel import MelSpectrogramConfig, _dft_constants, log_mel_spectrogram

    pcm = (rng.standard_normal((2, 3, 10240)) * 0.1).astype(np.float32)
    want = log_mel_spectrogram(jnp.asarray(pcm))
    got = tmel.log_mel_spectrogram(torch.from_numpy(pcm))
    assert got.shape == (2, 3, 128, 66)
    close(got, want, dict(rtol=0, atol=2e-4))
    for mine, theirs in zip(tmel.dft_constants(tmel.MelSpectrogramConfig()),
                            _dft_constants(MelSpectrogramConfig())):
        np.testing.assert_array_equal(mine, theirs)


def test_video_front_end_matches_jax(rng):
    """patchify_frames is the same byte shuffle; the folded patch-embed
    weights equal the JAX fold of the same weights, and the patch-embed
    matrix reads them in patchify's (z, ph, pw, c) order."""
    from synchformer_tpu.ops.video import fold_video_normalize, patchify_frames

    frames = rng.integers(0, 256, (2, 3, 4, 32, 32, 3), dtype=np.uint8)
    mine = tvideo.patchify_frames(frames, 2, 8)
    np.testing.assert_array_equal(mine, np.asarray(patchify_frames(frames, 2, 8)))
    np.testing.assert_array_equal(
        tvideo.patchify_frames(torch.from_numpy(frames), 2, 8).numpy(), mine)

    k = (0.05 * rng.standard_normal((2, 8, 8, 3, D))).astype(np.float32)
    bias = (0.05 * rng.standard_normal(D)).astype(np.float32)
    folded = fold_video_normalize({"patch_embed_3d": {"kernel": k, "bias": bias}},
                                  tower=None)["patch_embed_3d"]
    want = convert._conv(folded, "p")
    conv = convert._conv({"kernel": k, "bias": bias}, "p")
    w, b = tvideo.fold_video_normalize(torch.from_numpy(conv["p.weight"]),
                                       torch.from_numpy(conv["p.bias"]))
    close(w, want["p.weight"])
    close(b, want["p.bias"])
    mat = tvideo.patch_embed_matrix(w)
    assert mat.shape == (D, PATCH_K)
    close(mat, np.asarray(folded["kernel"]).reshape(PATCH_K, D).T)
