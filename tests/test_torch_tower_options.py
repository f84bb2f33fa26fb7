"""The tower options of the JAX package that the port builds from a config:
keep-masks, the joint-attention Motionformer, the AST classifier head, other
MLP ratios, unfactorized towers and other pools, 6-D frames, against the JAX
modules on the CPU; and the route each option takes on the card against the
route the JAX layers take.

Small sizes: D=128, 2 heads of 64 (they pair into 128 lanes, so the
Motionformer takes its split flow where JAX does), 2 layers, 4 frames of 32
px in 8 x 8 patches (2 x 16 tokens a segment), the real 128 x 66 mel
geometry, S=2. Inputs come from a numpy seed; JAX parameters are randomised
(tests/test_torch_models.py::randomize) from jax.eval_shape of the init and
carried to the port by utils/convert.py. Both sides run in f32; the JAX
modules on their XLA path (the default ``attn_impl``), the port on both its
routes (on the CPU every kernel wrapper runs its plain version). Tolerance:
max |port - JAX| <= 1e-5 x max |JAX| (the same math; f32 sums in another
order).

The routing test traces the JAX modules' init on ``attn_impl='pallas'``
under jax.eval_shape with counters on the Pallas entries (nothing is
compiled or run) and runs the port's kernel route on the CPU with counters on its
wrappers; each option's counts must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import randomize

from synchformer_tpu_torch.models import layers as tlayers
from synchformer_tpu_torch.models import motionformer as tmf
from synchformer_tpu_torch.models.ast_encoder import ASTEncoder
from synchformer_tpu_torch.models.motionformer import MotionFormerEncoder
from synchformer_tpu_torch.utils import convert

torch.set_num_threads(2)

D, HEADS, DEPTH, IMG, PATCH, FT = 128, 2, 2, 32, 8, 2
B, S = 1, 2
REL = 1e-5
VIS_SHAPE = (B, S, 2 * FT, IMG, IMG, 3)
AUD_SHAPE = (B, S, 66, 128)


def rel_close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (err, scale)


VIS_BASE = dict(embed_dim=D, depth=DEPTH, num_heads=HEADS, patch_size=PATCH,
                temporal_resolution=FT, img_size=IMG, drop_path_rate=0.0)
AUD_BASE = dict(hidden_size=D, depth=DEPTH, num_heads=HEADS)


def jax_vis(**kw) -> dict:
    return {**VIS_BASE, "z_block_size": 2, **kw}


def jax_aud(**kw) -> dict:
    return {**AUD_BASE, **kw}


def port_vis(**kw) -> MotionFormerEncoder:
    """The port tower of the JAX options ``kw``: JAX's 'xla' and 'pallas' are
    the port's 'pallas' (its kernels follow the caller's impl)."""
    fused = kw.pop("attn_impl", None) == "pallas_fused"
    return MotionFormerEncoder(**{**VIS_BASE, **kw},
                               attn_impl="pallas_fused" if fused else "pallas")


def port_aud(**kw) -> ASTEncoder:
    kw.pop("attn_impl", None)
    return ASTEncoder(**{**AUD_BASE, **kw})


def inputs(seed: int = 0):
    """Normalised 6-D frames and a log-mel."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, VIS_SHAPE, dtype=np.uint8)
    frames = (u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    return frames, rng.standard_normal(AUD_SHAPE).astype(np.float32)


def vis_mask(kind: str):
    """Content keep of the frames: all kept, or the last segment's final 2
    frames masked and a 12 x 12 corner of every frame masked (partial)."""
    keep = np.ones(VIS_SHAPE, np.float32)
    if kind == "partial":
        keep[:, -1, -2:] = 0.0
        keep[:, :, :, :12, :12] = 0.0
    return keep


def aud_mask(kind: str):
    """Content keep of the log-mel: all kept, or the last 20 time bins and
    the lowest 20 mel bins masked (partial)."""
    keep = np.ones(AUD_SHAPE, np.float32)
    if kind == "partial":
        keep[:, :, -20:] = 0.0
        keep[:, :, :, :20] = 0.0
    return keep


def jax_params(module, *args, **kw):
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw), *args)
    return randomize(shapes)


_JAX_TOWERS = {}


def jax_tower(kind: str, kw: dict, x, keep):
    """The JAX tower ('vis' or 'aud') of the options ``kw``, its randomised
    params and its jitted apply, made once per options and mask presence
    (the mask is an argument of the jitted apply, so an all-keep and a
    partial mask share one compile)."""
    key = (kind, tuple(sorted(kw.items())), keep is None)
    if key not in _JAX_TOWERS:
        if kind == "vis":
            from synchformer_tpu.models.motionformer import MotionFormerEncoder as JMF

            jmod = JMF(**jax_vis(**kw))
        else:
            from synchformer_tpu.models.ast_encoder import ASTEncoder as JAST

            jmod = JAST(**jax_aud(**kw))
        jkw = {} if keep is None else {"keep_mask": jnp.asarray(keep)}
        _JAX_TOWERS[key] = (jax_params(jmod, jnp.asarray(x), **jkw),
                            jax.jit(lambda p, a, **k: jmod.apply(p, a, **k)[0]))
    return _JAX_TOWERS[key]


VIS_OPTIONS = {
    "frames_6d": ({}, None),
    "mask_all_keep": ({}, "all"),
    "mask_partial": ({}, "partial"),
    "joint": (dict(attn_layer="joint"), None),
    "joint_mask": (dict(attn_layer="joint"), "partial"),
    "mlp_ratio_2": (dict(mlp_ratio=2.0), None),
    "mlp_ratio_3": (dict(mlp_ratio=3.0), "partial"),
    "unfactorized": (dict(factorize_space_time=False), None),
    "space_identity": (dict(agg_space_module="Identity"), None),
    "space_average_time_average": (dict(agg_space_module="AveragePooling",
                                        agg_time_module="AveragePooling"), "partial"),
    "extract_features_false": (dict(extract_features=False), None),
}


@pytest.mark.parametrize("option", sorted(VIS_OPTIONS))
def test_motionformer_option_matches_jax(option):
    """The Motionformer with each option, on 6-D frames (and the keep-mask
    where given), against the JAX tower on both port routes."""
    kw, mask = VIS_OPTIONS[option]
    frames, _ = inputs()
    keep = None if mask is None else vis_mask(mask)
    jkw = {} if keep is None else {"keep_mask": jnp.asarray(keep)}
    params, apply = jax_tower("vis", kw, frames, keep)
    want = apply(params, jnp.asarray(frames), **jkw)
    mod = port_vis(**kw)
    convert.load_numpy_state_dict(mod, convert.motionformer_sd(params["params"]))
    tkw = {} if keep is None else {"keep_mask": torch.from_numpy(keep)}
    for impl in ("plain", "kernel"):
        with torch.no_grad():
            rel_close(mod(torch.from_numpy(frames), impl, **tkw), want)


AUD_OPTIONS = {
    "mask_all_keep": ({}, "all"),
    "mask_partial": ({}, "partial"),
    "classifier": (dict(extract_features=False, num_labels=527), None),
    "classifier_mask": (dict(extract_features=False, num_labels=7), "partial"),
    "mlp_ratio_2": (dict(mlp_ratio=2.0), "partial"),
    "mlp_ratio_3": (dict(mlp_ratio=3.0), None),
    "unfactorized": (dict(factorize_freq_time=False), None),
    "freq_identity": (dict(agg_freq_module="Identity"), None),
    "freq_average_time_tel": (dict(agg_freq_module="AveragePooling",
                                   agg_time_module="TransformerEncoderLayer"), "partial"),
}


@pytest.mark.parametrize("option", sorted(AUD_OPTIONS))
def test_ast_option_matches_jax(option):
    """The AST with each option (and the keep-mask where given) against the
    JAX tower on both port routes."""
    kw, mask = AUD_OPTIONS[option]
    _, aud = inputs()
    keep = None if mask is None else aud_mask(mask)
    jkw = {} if keep is None else {"keep_mask": jnp.asarray(keep)}
    params, apply = jax_tower("aud", kw, aud, keep)
    want = apply(params, jnp.asarray(aud), **jkw)
    mod = port_aud(**kw)
    convert.load_numpy_state_dict(mod, convert.ast_sd(params["params"]))
    tkw = {} if keep is None else {"keep_mask": torch.from_numpy(keep)}
    for impl in ("plain", "kernel"):
        with torch.no_grad():
            rel_close(mod(torch.from_numpy(aud), impl, **tkw), want)


@pytest.mark.parametrize("which", ["spatial", "frequency"])
def test_aggregator_keep_mask_matches_jax(which):
    """The spatial and frequency aggregators under a partial keep-mask (the
    explicit [cls; x] concat with the CLS row kept), against JAX."""
    from synchformer_tpu.models import aggregators as jagg

    from synchformer_tpu_torch.models import aggregators as tagg

    rng = np.random.default_rng(5)
    if which == "spatial":
        x = rng.standard_normal((3, 2, 4, 4, D)).astype(np.float32)
        jmod, tmod = jagg.SpatialAggregator(num_heads=HEADS), tagg.SpatialAggregator(D, HEADS)
    else:
        x = rng.standard_normal((3, 12, 3, D)).astype(np.float32)
        jmod, tmod = jagg.FrequencyAggregator(num_heads=HEADS), tagg.FrequencyAggregator(D,
                                                                                         HEADS)
    keep = rng.random(x.shape[:-1]) > 0.4
    params = jax_params(jmod, jnp.asarray(x))
    want = jax.jit(lambda p, a, k: jmod.apply(p, a, keep_mask=k))(params, jnp.asarray(x),
                                                                  jnp.asarray(keep))
    sd = convert.cls_pool_layer_sd(params["params"]["cls_layer"], "agg")
    convert.load_numpy_state_dict(tmod, {k[4:]: v for k, v in sd.items()})
    for impl in ("plain", "kernel"):
        rel_close(tmod(torch.from_numpy(x), impl, keep_mask=torch.from_numpy(keep)), want)


@pytest.fixture(scope="module")
def jax_sync():
    """The JAX Synchformer (the towers at VIS_BASE / AUD_BASE, Linear
    projections, a 1-layer GlobalTransformer), its randomised params and its
    jitted masked logits, compiled once for both mask cases."""
    from synchformer_tpu.models.sync_model import Synchformer as JSync

    frames, aud = inputs(1)
    seq = 2 + S * (FT + 6)
    gt = dict(n_layer=1, n_head=HEADS, n_embd=D, tok_pdrop=0.0,
              pos_emb_cfg=dict(target="synchformer_tpu.models.pos_emb.RandInitPositionalEncoding",
                               params=dict(block_shape=[seq], n_embd=D)),
              off_head_cfg=dict(target="torch.nn.Linear",
                                params=dict(in_features=D, out_features=21)))
    lin = dict(target="torch.nn.Linear", params=dict(in_features=D, out_features=D))
    jmod = JSync(
        afeat_extractor=dict(target="synchformer_tpu.models.ast_encoder.ASTEncoder",
                             params=jax_aud()),
        vfeat_extractor=dict(target="synchformer_tpu.models.motionformer.MotionFormerEncoder",
                             params=jax_vis()),
        aproj=lin, vproj=lin,
        transformer=dict(target="synchformer_tpu.models.sync_model.GlobalTransformer",
                         params=gt))
    params = jax_params(jmod, jnp.asarray(frames), jnp.asarray(aud))
    return params, jax.jit(lambda p, v, a, vk, ak: jmod.apply(p, v, a, vis_mask=vk,
                                                              aud_mask=ak)[1])


@pytest.mark.parametrize("mask", ["all", "partial"])
def test_synchformer_masks_match_jax(jax_sync, mask):
    """Synchformer(vis, aud, vis_mask=..., aud_mask=...) on 6-D frames and
    the log-mel against the JAX model's logits; an all-keep mask gives the
    unmasked logits."""
    from synchformer_tpu_torch.models.sync_model import Synchformer

    params, run = jax_sync
    frames, aud = inputs(1)
    vm, am = vis_mask(mask), aud_mask(mask)
    want = run(params, jnp.asarray(frames), jnp.asarray(aud), jnp.asarray(vm), jnp.asarray(am))
    model = Synchformer(dict(depth=DEPTH, num_heads=HEADS, patch_size=PATCH, img_size=IMG,
                             temporal_resolution=FT, drop_path_rate=0.0),
                        dict(depth=DEPTH, num_heads=HEADS), d=D, n_segments=S, n_layer=1,
                        n_head=HEADS).eval()
    convert.load_numpy_state_dict(model, convert.state_dict_from_jax(params))
    v, a = torch.from_numpy(frames), torch.from_numpy(aud)
    for impl in ("plain", "kernel"):
        with torch.no_grad():
            _, got = model(v, a, impl=impl, vis_mask=torch.from_numpy(vm),
                           aud_mask=torch.from_numpy(am))
        rel_close(got, want)
    if mask == "all":
        with torch.no_grad():
            rel_close(model(v, a, impl="kernel")[1], want)


# --- routing: the port's kernel wrappers against the JAX Pallas entries -----

JAX_ENTRIES = {  # module path, attribute -> kernel
    ("synchformer_tpu.ops.pallas.standard_attention", "standard_attention"): "K3",
    ("synchformer_tpu.ops.pallas.cls_pool", "fused_cls_pool_tokens"): "K4",
    ("synchformer_tpu.ops.pallas.cls_pool", "fused_cls_pool"): "K4b",
    ("synchformer_tpu.ops.pallas.fused_rows", "fused_ln_mlp_residual"): "K2",
    ("synchformer_tpu.ops.pallas.fused_rows", "fused_ln_mlp_residual_stats"): "K2",
    ("synchformer_tpu.ops.pallas.divided_attention_bwd", "divided_attention_proj_split"): "K1",
    ("synchformer_tpu.ops.pallas.divided_attention_bwd", "divided_attention_split"): "K5",
    ("synchformer_tpu.ops.pallas.divided_attention_bwd", "divided_attention"): "K7",
    ("synchformer_tpu.ops.pallas.fused_block", "fused_divided_attention"): "K8a",
    ("synchformer_tpu.ops.pallas.fused_block", "fused_mlp_residual"): "K8b",
}
PORT_WRAPPERS = {  # port module, attribute -> kernel
    (tlayers, "standard_attention"): "K3",
    (tlayers, "fused_cls_pool_tokens"): "K4",
    (tlayers, "fused_cls_pool"): "K4b",
    (tlayers, "fused_ln_mlp_residual"): "K2",
    (tmf, "fused_ln_mlp_residual"): "K2",
    (tmf, "divided_attention_proj"): "K1",
    (tmf, "divided_attention_split"): "K5",
    (tmf, "packed_divided_attention"): "K7",
    (tmf, "fused_divided_attention"): "K8a",
    (tmf, "fused_mlp_residual"): "K8b",
}


def _counting(counts, key, fn):
    def wrapped(*a, **k):
        counts[key] = counts.get(key, 0) + 1
        return fn(*a, **k)

    return wrapped


ROUTE_CASES = {  # tower, options (JAX's names, the port's too), mask, training
    "ast_eval": ("aud", {}, None, False),
    "ast_mask": ("aud", {}, "partial", False),
    "ast_attn_dropout_train": ("aud", dict(attn_dropout=0.1), None, True),
    "ast_hidden_dropout_train": ("aud", dict(hidden_dropout=0.1), None, True),
    "ast_dropouts_eval": ("aud", dict(attn_dropout=0.1, hidden_dropout=0.1), None, False),
    "ast_rates_0_train": ("aud", {}, None, True),
    "ast_time_tel_dropout_train": ("aud", dict(agg_time_module="TransformerEncoderLayer",
                                               attn_dropout=0.1), None, True),
    "ast_classifier": ("aud", dict(extract_features=False), None, False),
    "ast_unfactorized": ("aud", dict(factorize_freq_time=False), None, False),
    "mf_eval": ("vis", {}, None, False),
    "mf_mask": ("vis", {}, "partial", False),
    "mf_mask_fused": ("vis", dict(attn_impl="pallas_fused"), "partial", False),
    "mf_drop_rate_train": ("vis", dict(drop_rate=0.1), None, True),
    "mf_drop_rate_eval": ("vis", dict(drop_rate=0.1), None, False),
    "mf_rates_0_train": ("vis", {}, None, True),
    # 2 heads of 96 do not pair into 128 lanes: the packed flow
    "mf_packed_drop_rate_train": ("vis", dict(embed_dim=192, drop_rate=0.1), None, True),
    "mf_joint": ("vis", dict(attn_layer="joint"), None, False),
    "mf_joint_mask": ("vis", dict(attn_layer="joint"), "partial", False),
    "mf_unfactorized": ("vis", dict(factorize_space_time=False), None, False),
    "mf_mlp_ratio_3": ("vis", dict(mlp_ratio=3.0), None, False),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_follows_jax(case, monkeypatch):
    """For each option the kernels the port's kernel route calls, and how
    often, are the Pallas entries the JAX module traces on
    attn_impl='pallas' (or 'pallas_fused'); options in training mode with
    their rates live."""
    import importlib

    from synchformer_tpu.models.ast_encoder import ASTEncoder as JAST
    from synchformer_tpu.models.motionformer import MotionFormerEncoder as JMF

    tower, kw, mask, train = ROUTE_CASES[case]
    kw = {"attn_impl": "pallas", **kw}
    jcounts, pcounts = {}, {}
    for (mod, attr), key in JAX_ENTRIES.items():
        m = importlib.import_module(mod)
        monkeypatch.setattr(m, attr, _counting(jcounts, key, getattr(m, attr)))
    for (m, attr), key in PORT_WRAPPERS.items():
        monkeypatch.setattr(m, attr, _counting(pcounts, key, getattr(m, attr)))
    frames, aud = inputs(2)
    if tower == "vis":
        jmod, port, x = JMF(**jax_vis(**kw)), port_vis(**kw), frames
        keep = None if mask is None else vis_mask(mask)
    else:
        jmod, port, x = JAST(**jax_aud(**kw)), port_aud(**kw), aud
        keep = None if mask is None else aud_mask(mask)
    jargs = {} if keep is None else {"keep_mask": jnp.asarray(keep)}
    rngs = {name: jax.random.PRNGKey(i) for i, name in enumerate(("params", "dropout",
                                                                   "droppath"))}
    # init traces the module's call once, in the mode asked for
    jax.eval_shape(lambda a: jmod.init(rngs, a, deterministic=not train, **jargs),
                   jnp.asarray(x))
    targs = {} if keep is None else {"keep_mask": torch.from_numpy(keep)}
    with torch.no_grad():
        port(torch.from_numpy(x), "kernel", not train,
             torch.Generator().manual_seed(0) if train else None, **targs)
    assert pcounts == jcounts, (pcounts, jcounts)


def test_route_predicates():
    """The predicates the routes read, as the JAX gates: K3 only with no
    keep-mask and no live attention dropout at groupable heads; K4 only for
    one query row of a 3-D x with no keep-mask and nothing stochastic; K2
    only with every row computed and neither residual dropout nor drop-path
    live, a keep-mask or not."""
    mask = torch.ones(2, 5, dtype=torch.bool)
    assert tlayers.k3_route("kernel", 12, 64, None, False)
    assert not tlayers.k3_route("plain", 12, 64, None, False)
    assert not tlayers.k3_route("kernel", 12, 64, mask, False)
    assert not tlayers.k3_route("kernel", 12, 64, None, True)
    assert not tlayers.k3_route("kernel", 8, 96, None, False)
    assert tlayers.k4_route("kernel", 1, 3, None, False)
    assert not tlayers.k4_route("kernel", 1, 3, mask, False)
    assert not tlayers.k4_route("kernel", 1, 3, None, True)
    assert not tlayers.k4_route("kernel", None, 3, None, False)
    assert not tlayers.k4_route("kernel", 1, 4, None, False)
    assert tlayers.k2_route("kernel", None, False)
    assert not tlayers.k2_route("kernel", 1, False)
    assert not tlayers.k2_route("kernel", None, True)
    assert not tlayers.k2_route("plain", None, False)
