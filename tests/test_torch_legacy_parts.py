"""The legacy SparseSync family's parts in the port against the JAX package on
the CPU: flax's SAME padding (models/conv.py), the positional encodings and
bridges, the S3D and ResNet-18 building blocks with non-trivial
batch_stats, ResNet18AudioFeatures whole, SparseSyncTransformer, the
CLS-pool layer at the legacy towers' head widths against
_cls_pool_tokens_pallas in interpret mode, the registry's new targets, the
GlobalTransformer without a positional embedding or with a zero-init one,
and the seeded weights' scale through the trunks.

JAX modules run on their XLA path under jax.jit; both sides in f32. Inputs
and weights come from numpy seeds; a JAX tree is converted with
utils/convert.py. Tolerances: 1e-6 (rtol and atol) for the positional
encodings, bridges and padding, 1e-5 for the blocks, towers and
transformers (tests/test_torch_models.py's REF), the Pallas kernel in
interpret mode 2e-4 / 3e-5 (PALLAS).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax.experimental.pallas import tpu as pltpu
from test_torch_models import PALLAS, REF, close, jit_apply

from synchformer_tpu_torch.models import bridges as tbridges
from synchformer_tpu_torch.models import conv as tconv
from synchformer_tpu_torch.models import pos_emb as tpos
from synchformer_tpu_torch.models import resnet_audio as tres
from synchformer_tpu_torch.models import s3d as ts3d
from synchformer_tpu_torch.models.aggregators import SpatialAggregator
from synchformer_tpu_torch.models.sparsesync import SparseSyncTransformer
from synchformer_tpu_torch.registry import instantiate_from_config
from synchformer_tpu_torch.utils import convert

TIGHT = dict(rtol=1e-6, atol=1e-6)


def fill(tree, seed: int = 0, closing=frozenset()):
    """A JAX variable tree (arrays or ShapeDtypeStructs) filled from a numpy
    seed as convert.seeded_state_dict fills a port model with BatchNorms:
    conv kernels (3 or more axes) at He scale (2 / fan_in)^0.5, scales 1 +
    0.1 N (halved in the BatchNorms ``closing`` names by their dotted module
    path, those the port marks ``closes_residual``), running means 0.1 N,
    running variances uniform in [0.5, 1.5]; every other leaf 0.05 N."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        shape, last = tuple(leaf.shape), getattr(path[-1], "key", None)
        noise = rng.standard_normal(shape).astype(np.float32)
        if last == "kernel" and len(shape) >= 3:
            leaves.append(noise * np.float32((2.0 / np.prod(shape[:-1])) ** 0.5))
        elif last == "scale":
            module = ".".join(str(getattr(k, "key", k)) for k in path[1:-1])
            leaves.append((1.0 + 0.1 * noise) * (0.5 if module in closing else 1.0))
        elif last == "mean":
            leaves.append(0.1 * noise)
        elif last == "var":
            leaves.append(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        else:
            leaves.append(0.05 * noise)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def jax_vars(module, *args, seed: int = 0, closing=frozenset()):
    """fill() on the variable shapes of ``module`` (no init is compiled;
    nn.Module.init by name: the learned encodings' ``init`` field hides it)."""
    init = lambda *a: nn.Module.init(module, *a)  # noqa: E731
    return fill(jax.eval_shape(init, jax.random.PRNGKey(0), *args), seed, closing)


def closing_norms(mod: torch.nn.Module) -> frozenset:
    """The dotted paths of the port module's BatchNorms that close a
    residual sum, as fill() takes them."""
    return frozenset(name for name, m in mod.named_modules()
                     if getattr(m, "closes_residual", False))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def rand(shape, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# flax SAME padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [15, 16])
@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("kind", ["conv", "pool"])
def test_same_padding_matches_flax(kind, k, n):
    """A stride-2 conv / max pool with flax's SAME padding at odd and even
    lengths (asymmetric: k 3 over 16 pads (0, 1), k 7 over 16 (2, 3))
    against nn.Conv / nn.max_pool; the input is shifted positive so that a
    pool padded with zeros instead of -inf would differ as well."""
    x = rand((2, n, n + 1, 4)) + 0.5
    if kind == "conv":
        jmod = nn.Conv(5, (k, k), (2, 2), padding="SAME")
        params = jax_vars(jmod, jnp.asarray(x))
        want = jit_apply(jmod)(params, jnp.asarray(x))
        sd = convert._conv(params["params"], "c")
        got = tconv.conv_same(t(x).permute(0, 3, 1, 2), t(sd["c.weight"]), t(sd["c.bias"]),
                              (2, 2))
    else:
        want = nn.max_pool(jnp.asarray(x), (k, k), (2, 2), padding="SAME")
        got = tconv.max_pool_same(t(x).permute(0, 3, 1, 2), (k, k), (2, 2))
    close(got.permute(0, 2, 3, 1), want, TIGHT)


def test_same_pads_are_flax_amounts():
    assert tconv.same_pads((224, 16, 15), (7, 3, 3), (2, 2, 2)) == ((2, 3), (0, 1), (1, 1))
    assert tconv.same_pads((16,), (1,), (2,)) == ((0, 0),)


# ---------------------------------------------------------------------------
# positional encodings and bridges
# ---------------------------------------------------------------------------

POS_EMBS = {
    "NoPosEncoding": (dict(), (2, 5, 20)),
    "ZeroInitPositionalEncoding": (dict(block_shape=[7], n_embd=20), (2, 5, 20)),
    "RandInitPositionalEncoding": (dict(block_shape=[3, 4], n_embd=20), (2, 3, 2, 20)),
    "PositionEmbeddingLearnedVisual": (dict(block_shape=[4, 5, 6], n_embd=20), (2, 3, 5, 4, 20)),
    "PositionEmbeddingLearnedAudio": (dict(block_shape=[5, 6], n_embd=21), (2, 4, 6, 21)),
    "L2Normalize": (dict(), (2, 5, 20)),
}


@pytest.mark.parametrize("name", sorted(POS_EMBS))
def test_pos_emb_matches_jax(name):
    """Each positional encoding, built through the port's registry from the
    reference's name, against the JAX module (n_embd 20 and 21: neither a
    multiple of 3 nor of 2; inputs shorter than the blocks)."""
    from synchformer_tpu.models import pos_emb as jpos

    params, shape = POS_EMBS[name]
    x = rand(shape)
    jmod = getattr(jpos, name)(**params)
    variables = jax_vars(jmod, jnp.asarray(x))
    want = jit_apply(jmod)(variables, jnp.asarray(x))
    mod = instantiate_from_config({"target": f"model.modules.transformer.{name}",
                                   "params": params})
    convert.load_numpy_state_dict(mod, convert.leaves_sd(variables.get("params", {})))
    close(mod(t(x)), want, TIGHT)


BRIDGES = {
    "Identity": (dict(), (2, 3, 8, 4, 4)),
    "AppendZerosToHidden": (dict(target_hidden_size=12, dim=2), (2, 3, 8, 4, 4)),
    "ConvBridgeVisual": (dict(in_channels=8, out_channels=6, kernel_size=[1, 3, 3],
                              stride=[1, 2, 2]), (2, 3, 8, 5, 6)),
    "ConvBridgeAudio": (dict(in_channels=8, out_channels=6, kernel_size=[3, 3],
                             stride=[2, 2]), (2, 8, 4, 7)),
    "AvgPoolBridgeVisual": (dict(kernel_size=[1, 3, 3], stride=[1, 2, 1]), (2, 3, 8, 5, 6)),
    "AvgPoolBridgeAudio": (dict(kernel_size=[2, 2], stride=[1, 2]), (2, 8, 4, 7)),
    "SpatialpoolConvTemporalpool": (dict(in_channels=8, out_channels=6), (2, 3, 8, 5, 6)),
    "FrequencypoolConvTemporalpool": (dict(in_channels=8, out_channels=6), (2, 8, 4, 7)),
}


@pytest.mark.parametrize("name", sorted(BRIDGES))
def test_bridge_matches_jax(name):
    """Each bridge, built through the port's registry from the reference's
    name, in the JAX layouts ((B, T, D, h, w) visual, (B, D, f, t) audio),
    against the JAX module; the conv bridges at stride 2."""
    from synchformer_tpu.models import bridges as jbridges

    params, shape = BRIDGES[name]
    x = rand(shape)
    jmod = getattr(jbridges, name)(**params)
    variables = jax_vars(jmod, jnp.asarray(x))
    want = jit_apply(jmod)(variables, jnp.asarray(x))
    target = "torch.nn.Identity" if name == "Identity" else f"model.modules.bridges.{name}"
    mod = instantiate_from_config({"target": target, "params": params})
    convert.load_numpy_state_dict(mod, convert.bridge_sd(variables.get("params", {}), ""))
    got = mod(t(x))
    assert got.shape == want.shape
    close(got, want, TIGHT)


# ---------------------------------------------------------------------------
# the trunks' blocks
# ---------------------------------------------------------------------------

def _blocks():
    from synchformer_tpu.models import resnet_audio as jres
    from synchformer_tpu.models import s3d as js3d

    return {
        "BasicConv3d": (js3d.BasicConv3d(6, (1, 3, 3), (1, 2, 2)),
                        ts3d.BasicConv3d(4, 6, (1, 3, 3), (1, 2, 2)), (2, 4, 7, 8, 4)),
        "SepConv3d_stride2": (js3d.SepConv3d(6, 7, strides=2), ts3d.SepConv3d(4, 6, 7, 2),
                              (1, 8, 16, 15, 4)),
        "InceptionMixed": (js3d.InceptionMixed(4, (3, 5), (2, 3), 4),
                           ts3d.InceptionMixed(6, 4, (3, 5), (2, 3), 4), (1, 4, 6, 5, 6)),
        "BasicBlock": (jres.BasicBlock(8), tres.BasicBlock(8, 8), (2, 8, 6, 8)),
        "BasicBlock_stride2": (jres.BasicBlock(12, 2), tres.BasicBlock(8, 12, 2), (2, 9, 8, 8)),
    }


@pytest.mark.parametrize("name", ["BasicConv3d", "SepConv3d_stride2", "InceptionMixed",
                                  "BasicBlock", "BasicBlock_stride2"])
def test_legacy_block_matches_flax(name):
    """S3D's BasicConv3d, SepConv3d (stride 2: both its convs pad
    asymmetrically), InceptionMixed (its -inf SAME pool), ResNet's
    BasicBlock (with and without its strided 1x1 downsample) at narrow
    widths, eval BatchNorm on non-trivial batch_stats, against flax."""
    jmod, mod, shape = _blocks()[name]
    x = rand(shape)
    variables = jax_vars(jmod, jnp.asarray(x))
    want = jit_apply(jmod)(variables, jnp.asarray(x))
    convert.load_numpy_state_dict(mod, convert.legacy_trunk_sd(variables["params"],
                                                               variables["batch_stats"]))
    perm = (0, x.ndim - 1, *range(1, x.ndim - 1))
    got = mod(t(x).permute(*perm))
    close(got.permute(0, *range(2, x.ndim), 1), want)


RESNET_OPTIONS = {
    "freq_tel": dict(),
    "avg_pools_global": dict(agg_freq_module="AveragePooling",
                             agg_time_module="TransformerEncoderLayer", add_global_repr=True,
                             max_segments=2),
    "unfactorized": dict(factorize_freq_time=False),
}


@pytest.mark.parametrize("case", sorted(RESNET_OPTIONS))
def test_resnet18_audio_matches_jax(case):
    """ResNet18AudioFeatures whole at (1, 2, 66, 128), the published mel
    geometry ((4, 3) map), its aggregator options: the default frequency
    aggregator (K4 on the kernel route), AveragePooling frequency pool with a
    TransformerEncoderLayer time tail and the global aggregator, and the
    unfactorized map; both routes of the port."""
    from synchformer_tpu.models.resnet_audio import ResNet18AudioFeatures as JResNet

    opts = RESNET_OPTIONS[case]
    x = rand((1, 2, 66, 128))
    jmod = JResNet(**opts)
    mod = tres.ResNet18AudioFeatures(**opts)
    variables = jax_vars(jmod, jnp.asarray(x), closing=closing_norms(mod))
    want, want_g = jit_apply(jmod)(variables, jnp.asarray(x))
    convert.load_numpy_state_dict(mod, convert.legacy_tower_sd(variables["params"],
                                                               variables["batch_stats"]))
    for impl in ("plain", "kernel"):
        got, got_g = mod.forward_with_global(t(x), impl)
        assert got.shape == want.shape
        close(got, want)
        assert (got_g is None) == (want_g is None)
        if want_g is not None:
            close(got_g, want_g)
    with pytest.raises(NotImplementedError, match="item 7"):
        mod(t(x), deterministic=False)


def test_sparsesync_transformer_matches_jax():
    """SparseSyncTransformer at 2 layers, 4 heads, 64 wide, with
    L2Normalize pre-norms and the factorized positional embeddings over
    maps shorter than their blocks, against the JAX module."""
    from synchformer_tpu.models.sparsesync import SparseSyncTransformer as JSparse

    cfg = sparsesync_cfg(64)
    vis, aud = rand((2, 3, 2, 2, 64), 4), rand((2, 2, 3, 64), 5)
    jmod = JSparse(**cfg["params"])
    variables = jax_vars(jmod, jnp.asarray(vis), jnp.asarray(aud))
    want = jit_apply(jmod)(variables, jnp.asarray(vis), jnp.asarray(aud))
    mod = instantiate_from_config(cfg)
    assert isinstance(mod, SparseSyncTransformer)
    convert.load_numpy_state_dict(mod, convert.sparsesync_sd(variables["params"]))
    close(mod(t(vis), t(aud)), want)


def sparsesync_cfg(d: int, n_layer: int = 2, n_head: int = 4) -> dict:
    return {"target": "model.modules.transformer.Transformer", "params": dict(
        num_offset_cls=21, visual_block_shape=[4, 3, 3], audio_block_shape=[3, 4],
        vis_pos_emb_module={"target": "model.modules.transformer.PositionEmbeddingLearnedVisual",
                            "params": {"block_shape": [4, 3, 3], "n_embd": d}},
        aud_pos_emb_module={"target": "model.modules.transformer.PositionEmbeddingLearnedAudio",
                            "params": {"block_shape": [3, 4], "n_embd": d}},
        pre_norm_cfg={"target": "model.modules.transformer.L2Normalize"},
        n_layer=n_layer, n_head=n_head, n_embd=d)}


# ---------------------------------------------------------------------------
# K4 at the legacy towers' head widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,heads,rows", [(256, 2, 49), (128, 2, 4)])
def test_cls_pool_at_legacy_head_widths_matches_pallas(monkeypatch, d, heads, rows):
    """The spatial CLS-pool layer at heads of 128 over 49 rows (S3D's 7 x 7
    frame, 8 x 128 at full width) and at heads of 64 over 4 rows (ResNet's
    frequency pool, 8 x 64): the port's layer on both routes (the kernel
    route's plain version on CPU tensors) against the JAX SpatialAggregator
    on impl='pallas' in interpret mode, which runs _cls_pool_tokens_pallas
    (counted), and on its XLA path."""
    from synchformer_tpu.models import aggregators as jagg
    from synchformer_tpu.ops.pallas import cls_pool as jcls

    calls = []
    real = jcls._cls_pool_tokens_pallas
    monkeypatch.setattr(jcls, "_cls_pool_tokens_pallas",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    side = {49: (7, 7), 4: (2, 2)}[rows]
    x = rand((2, 2, *side, d), 6)
    jmod = jagg.SpatialAggregator(num_heads=heads)
    variables = jax_vars(jmod, jnp.asarray(x))
    with pltpu.force_tpu_interpret_mode():
        want = jit_apply(jagg.SpatialAggregator(num_heads=heads, impl="pallas"))(
            variables, jnp.asarray(x))
    assert calls
    want_xla = jit_apply(jmod)(variables, jnp.asarray(x))
    mod = SpatialAggregator(d, heads)
    sd = convert.cls_pool_layer_sd(variables["params"]["cls_layer"], "agg")
    convert.load_numpy_state_dict(mod, {k[len("agg."):]: v for k, v in sd.items()})
    for impl in ("plain", "kernel"):
        got = mod(t(x), impl)
        close(got, want_xla)
        close(got, want, PALLAS)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

LEGACY_TARGETS = [
    ("synchformer_tpu.models.s3d.S3DVisualFeatures",
     "model.modules.feat_extractors.visual.s3d.S3DVisualFeatures", ts3d.S3DVisualFeatures,
     dict(ckpt_path="s3d.pt", extract_features=True, agg_segments_module=None)),
    ("synchformer_tpu.models.resnet_audio.ResNet18AudioFeatures",
     "model.modules.feat_extractors.audio.resnet.ResNet18AudioFeatures",
     tres.ResNet18AudioFeatures, dict(feat_type="melspec", max_spec_t=66)),
    ("synchformer_tpu.models.sparsesync.SparseSyncTransformer",
     "model.modules.transformer.Transformer", SparseSyncTransformer,
     sparsesync_cfg(60)["params"]),
    ("synchformer_tpu.models.bridges.Identity", "torch.nn.Identity", tbridges.DoNothingBridge,
     {}),
    ("synchformer_tpu.models.pos_emb.NoPosEncoding", "model.modules.transformer.NoPosEncoding",
     tpos.NoPosEncoding, {}),
    *[(f"synchformer_tpu.models.pos_emb.{n}", f"model.modules.transformer.{n}",
       getattr(tpos, n), POS_EMBS[n][0]) for n in sorted(POS_EMBS) if POS_EMBS[n][0]],
    *[(f"synchformer_tpu.models.bridges.{n}", f"model.modules.bridges.{n}",
       getattr(tbridges, n), BRIDGES[n][0]) for n in sorted(BRIDGES) if n != "Identity"],
]


@pytest.mark.parametrize("jax_name,ref_name,cls,params", LEGACY_TARGETS,
                         ids=[row[0].rsplit(".", 1)[1] for row in LEGACY_TARGETS])
def test_registry_builds_legacy_targets(jax_name, ref_name, cls, params, caplog):
    """Each new target builds from a JAX-named node and from a
    reference-named node, to the same class and state names; a legacy
    tower's ckpt_path is accepted with a warning that it is not read."""
    built = [instantiate_from_config({"target": name, "params": params}, device="meta")
             for name in (jax_name, ref_name)]
    assert all(type(m) is cls for m in built)
    assert list(built[0].state_dict()) == list(built[1].state_dict())
    if params.get("ckpt_path"):
        assert "ckpt_path is not read" in caplog.text


@pytest.mark.parametrize("pos", ["none", "ZeroInitPositionalEncoding"])
def test_global_transformer_pos_emb_options_match_jax(pos):
    """A GlobalTransformer with no pos_emb_cfg, and one with a
    ZeroInitPositionalEncoding, from the port's registry against the JAX
    module (the port refused both before)."""
    from synchformer_tpu.models.sync_model import GlobalTransformer as JGT

    d = 64
    params = dict(n_layer=2, n_head=4, n_embd=d, off_head_cfg={
        "target": "torch.nn.Linear", "params": {"in_features": d, "out_features": 21}})
    if pos != "none":
        params["pos_emb_cfg"] = {"target": f"model.modules.transformer.{pos}",
                                 "params": {"block_shape": [12], "n_embd": d}}
    v, a = rand((2, 4, d), 7), rand((2, 6, d), 8)
    jmod = JGT(**params)
    variables = jax_vars(jmod, jnp.asarray(v), jnp.asarray(a))
    want = jit_apply(jmod)(variables, jnp.asarray(v), jnp.asarray(a))
    mod = instantiate_from_config({"target": "model.sync_model.GlobalTransformer",
                                   "params": params})
    assert (mod.pos_emb_cfg is None) == (pos == "none")
    convert.load_numpy_state_dict(mod, convert.global_transformer_sd(variables["params"], ""))
    close(mod(t(v), t(a)), want)


# ---------------------------------------------------------------------------
# seeded weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tower", ["s3d", "resnet"])
def test_seeded_weights_keep_trunks_of_order_one(tower):
    """seeded_state_dict on a model with BatchNorms (He-scale convs, BN near
    the identity, running var in [0.5, 1.5]) keeps the trunk's output std
    within [0.1, 10] for an input of std 1 (16 frames of 64², one segment;
    the published 66 x 128 mel)."""
    if tower == "s3d":
        mod, x = ts3d.S3DVisualFeatures(factorize_space_time=False), rand((1, 1, 16, 64, 64, 3))
    else:
        mod, x = tres.ResNet18AudioFeatures(factorize_freq_time=False), rand((1, 1, 66, 128))
    sd = convert.seeded_state_dict(mod, seed=0)
    assert all(0.5 <= v.min() and v.max() <= 1.5 for k, v in sd.items() if "running_var" in k)
    convert.load_numpy_state_dict(mod, sd)
    with torch.no_grad():
        std = float(mod(t(x)).std())
    assert 0.1 <= std <= 10.0, std
