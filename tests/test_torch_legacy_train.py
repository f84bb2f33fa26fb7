"""The legacy towers' training in the port against the JAX package on the CPU:
flax's BatchNorm in training mode (models/conv.py), the S3D and ResNet-18
towers whole with deterministic=False, one legacy Stage II step with
trainable towers, the AVCLIP step over S3D + ResNet-18 towers, the resume of
a trainer's running statistics and MoCo's refusal. (The global statistics at
world 2: tests/test_torch_distributed_legacy.py.)

The JAX side is each module applied with ``mutable=["batch_stats"]`` under
jax.jit, its gradients from jax.value_and_grad: the JAX trainers keep
``params`` alone (synchformer_tpu/train/stage_sync.py:204-207,
stage_clip.py:170) and cannot run a legacy model, so the tests compose the
JAX step from the JAX modules; no file of the JAX package changes. Inputs
and weights come from numpy seeds (test_torch_legacy_parts.fill: He-scale
convs, non-trivial running statistics); JAX trees are converted with
utils/convert.py (state_dict_from_jax also turns the updated batch_stats
into the port's buffers). Frames (1, 2, 16, 64, 64, 3), log-mel (1, 2, 66,
128), a transformer of 2 layers of 4 heads, 64 wide, every dropout 0.

Tolerances (the repo's, tests/test_torch_sync_train.py):
- f32: outputs, features and running statistics within 1e-5 of the largest
  |JAX| value of their tensor; losses rtol 1e-5; gradients within 2e-5 of
  each tensor's largest |JAX| gradient (+ 1e-8);
- bf16 compute (the BatchNorm alone): a bf16 tensor (the output, the input's
  gradient) within one bf16 ulp of its largest value (2^-7 of it): both
  sides compute the same f32 value up to the order of f32 sums, and a value
  within that of a rounding boundary rounds to either neighbour; the
  statistics and the weight and bias gradients, f32 on both sides, as above.
The BatchNorm case includes a near-constant channel, 8 + k / 16 with k in
{-1, 0, 1}: every sum there is exact in f32 on both sides, so that flax's
one-pass E[x^2] - E[x]^2 (the rounding of E[x]^2 alone) is reproduced bit for
bit, while a two-pass variance differs from it by up to about 1e-3 of it,
which the f32 output shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from test_torch_legacy_parts import (
    PERTURB,
    centred,
    closing_norms,
    gap,
    grad_scales,
    hold_family,
    jax_runs,
    jax_vars,
    rand,
    t,
    value_scales,
)
from test_torch_sync_train import PARAM_ATOL, SETTLED_GRAD, layer_scale

from synchformer_tpu_torch.models import conv as tconv
from synchformer_tpu_torch.models import resnet_audio as tres
from synchformer_tpu_torch.models import s3d as ts3d
from synchformer_tpu_torch.utils import convert

torch.set_num_threads(2)

REL, GRAD_REL, LOSS_TOL = 1e-5, 2e-5, dict(rtol=1e-5, atol=0)
BF16_ULP = 2.0 ** -7
# (eps, flax momentum) of each tower's BatchNorms (BN_KW of the JAX towers)
BN_KW = {"s3d": (1e-3, 0.999), "resnet": (1e-5, 0.9)}
C = 6  # the BatchNorm case's channels; the last one near-constant


def assert_rel(got, want, rel: float = REL, what: str = "") -> float:
    """max |got - want| <= rel * max |want| (+ 1e-8); returns the margin."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = rel * float(np.abs(want).max()) + 1e-8
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)
    return err / bound


def bn_case(dtype):
    """(x (2, 4, 4, 4, C) channels-last, params, batch_stats, cotangent):
    channels of spread 0.5-2 around offsets up to 3, the last one 8 + k / 16,
    k in {-1, 0, 1} summing to 4 (exact in bf16 too)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 4, 4, 4, C)) * rng.uniform(0.5, 2.0, C)
         + rng.uniform(-3.0, 3.0, C)).astype(np.float32)
    k = rng.integers(-1, 2, x.shape[:-1]).ravel()
    while k.sum() != 4:  # then E[x]^2 = 64 + 4 / 128 + 16 / 2^22 rounds by 2^-18 in f32
        i = int(np.argmax(k < 1) if k.sum() < 4 else np.argmax(k > -1))
        k[i] += 1 if k.sum() < 4 else -1
    k = k.reshape(x.shape[:-1])
    x[..., -1] = 8.0 + k / 16.0
    x = np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))
    params = {"scale": (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.standard_normal(C)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    cot = rng.standard_normal(x.shape).astype(np.float32)
    return x, params, stats, cot


def jax_bn(kind: str, dtype, x, params, stats, cot):
    """flax BatchNorm(use_running_average=False) applied with mutable
    batch_stats: the output, the new statistics and jax.grad of
    sum(y * cot) with respect to x, scale and bias."""
    eps, momentum = BN_KW[kind]
    mod = nn.BatchNorm(use_running_average=False, epsilon=eps, momentum=momentum, dtype=dtype)

    @jax.jit
    def run(x, params, stats, cot):
        def loss(x, params):
            y, new = mod.apply({"params": params, "batch_stats": stats}, x,
                               mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * cot), (y, new["batch_stats"])

        (_, (y, new)), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(x, params)
        return y, new, grads

    return run(jnp.asarray(x, dtype), params, stats, cot)


def port_bn(kind: str, dtype, x, params, stats, cot):
    eps, momentum = BN_KW[kind]
    bn = tconv.BatchNorm(C, eps, momentum=momentum)
    with torch.no_grad():
        bn.weight.copy_(t(params["scale"]))
        bn.bias.copy_(t(params["bias"]))
        bn.running_mean.copy_(t(stats["mean"]))
        bn.running_var.copy_(t(stats["var"]))
    xt = t(x).permute(0, 4, 1, 2, 3).to(dtype).requires_grad_()
    y = bn(xt, train=True)
    (y.float() * t(cot).permute(0, 4, 1, 2, 3)).sum().backward()
    return bn, y.permute(0, 2, 3, 4, 1), xt.grad.permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(BN_KW))
def test_batchnorm_train_matches_flax(kind, dtype):
    """BatchNorm(train=True) at each tower's eps and momentum, f32 and bf16
    compute, against flax: the output, the updated running mean and var
    (flax's momentum, the biased var), the gradients of x, weight and bias;
    the near-constant channel's new running var equal to flax's bit for bit,
    and off the two-pass variance's by more than the tolerance."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x, params, stats, cot = bn_case(jdt)
    y, new, (gx, gp) = jax_bn(kind, jdt, x, params, stats, cot)
    bn, got_y, got_gx = port_bn(kind, tdt, x, params, stats, cot)
    assert got_y.dtype == tdt
    rel_bf16 = REL if dtype == "float32" else BF16_ULP
    assert_rel(got_y, y, rel_bf16, "y")
    assert_rel(got_gx, gx, GRAD_REL if dtype == "float32" else BF16_ULP, "dx")
    assert_rel(bn.weight.grad, gp["scale"], GRAD_REL, "dweight")
    assert_rel(bn.bias.grad, gp["bias"], GRAD_REL, "dbias")
    assert_rel(bn.running_mean, new["mean"], REL, "running_mean")
    assert_rel(bn.running_var, new["var"], REL, "running_var")
    assert bn.running_var[-1].item() == float(new["var"][-1])
    if dtype == "float32":
        # the near-constant channel normalised with its two-pass variance, as
        # a port that took torch's var would: off flax's output by more than
        # the tolerance (its running var by about 1e-7 of it, which no f32
        # tolerance of the buffers sees)
        eps, _ = BN_KW[kind]
        last = t(x[..., -1]).double()
        two_pass = (last - last.mean()) / torch.sqrt(((last - last.mean()) ** 2).mean() + eps)
        two_pass = two_pass * float(params["scale"][-1]) + float(params["bias"][-1])
        err = float(np.abs(two_pass.numpy() - np.asarray(y[..., -1], np.float64)).max())
        assert err > REL * float(np.abs(y).max()), err


def running_stats(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def assert_step(params: dict, want: dict, g32: list, g64: dict, grad_norm: float, lr0: float):
    """tests/test_torch_train.py's bound on the parameters after one Adam
    step: within 2e-6 of JAX's where the clipped gradient exceeds 1e-5 and 2 x
    JAX's own f32 spread of its module's gradients (hold_family's, per
    top-level module, relative to the layer's scale), so that both sides
    take it the same way, else the step itself, 2 x lr + 2e-6 (the first
    Adam step's sign is set by rounding there)."""
    clip = max(grad_norm, 1.0)
    scales = grad_scales(g64)
    spread: dict = {}
    for name in g64:
        top = name.split(".", 1)[0]
        spread[top] = max(spread.get(top, 0.0),
                          max(gap(g[name], g64[name]) for g in g32) / scales[name])
    for name, p in params.items():
        noise = 2.0 * spread[name.split(".", 1)[0]] * scales[name]
        settled = np.abs(g64[name]) / clip > max(SETTLED_GRAD, noise / clip)
        atol = np.where(settled, PARAM_ATOL, 2 * lr0 + PARAM_ATOL)
        assert np.all(np.abs(p.numpy() - want[name]) <= atol), name


def legacy_cfg(n_segments: int = 2) -> dict:
    """presets.legacy_sync_model at the tests' widths, every dropout 0, no
    tower checkpoint (a trainer would load one)."""
    from synchformer_tpu_torch.models.presets import legacy_sync_model

    cfg = legacy_sync_model(n_segments, d=64, n_layer=2, n_head=4)
    cfg["params"]["vfeat_extractor"]["params"].pop("ckpt_path")
    cfg["params"]["transformer"]["params"].update(embd_pdrop=0.0, resid_pdrop=0.0,
                                                  attn_pdrop=0.0)
    return cfg


def with_dtype(node: dict, dtype) -> dict:
    """A JAX model config whose towers, projections and transformer compute
    in ``dtype``."""
    keys = ("vfeat_extractor", "afeat_extractor", "vproj", "aproj", "transformer")
    return {k: dict(v, params={**v["params"], "dtype": dtype}) if k in keys else v
            for k, v in node.items()}


TOWER_KEYS = {"vfeat_extractor": "v_encoder", "afeat_extractor": "a_encoder"}


def capture_towers(mdl, method_name) -> bool:
    return method_name == "__call__" and mdl.name in TOWER_KEYS.values()


def jax_legacy_stage2(variables, vis, aud, targets, dtype, perturb=(0,)) -> list:
    """jax.value_and_grad over the legacy Synchformer applied with
    deterministic=False, extractors_deterministic=False and mutable
    batch_stats (the JAX Stage II step's loss with is_trainable towers):
    loss, logits, new batch_stats, the towers' features, the params'
    gradients; one per perturbation (jax_runs)."""
    from synchformer_tpu.models.sync_model import Synchformer as JSynchformer

    def make_run():
        model = JSynchformer(**with_dtype(legacy_cfg()["params"], dtype))

        @jax.jit
        def run(params, stats, vis, aud):
            def loss_fn(params):
                (loss, logits), state = model.apply(
                    {"params": params, "batch_stats": stats}, vis, aud, targets,
                    deterministic=False, extractors_deterministic=False,
                    mutable=["batch_stats", "intermediates"], capture_intermediates=capture_towers)
                feats = {k: state["intermediates"][v]["__call__"][0][0]
                         for k, v in TOWER_KEYS.items()}
                return loss, (logits, state["batch_stats"], feats)

            (loss, (logits, new, feats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params)
            return dict(loss=loss, logits=logits, stats=new, feats=feats, grads=grads)

        return run

    return jax_runs(make_run, variables, (vis, aud), dtype, perturb)


def port_sd(variables, params=None, stats=None) -> dict:
    """The port's state dict of Synchformer ``variables``, with ``params``
    (e.g. gradients) and ``stats`` in place of its own where given."""
    return convert.state_dict_from_jax(
        {"params": variables["params"] if params is None else params,
         "batch_stats": variables["batch_stats"] if stats is None else stats})


@pytest.fixture(scope="module")
def stage2():
    """The legacy Synchformer (B=1, S=2, target 3) with centred seeded
    weights: JAX in f64 and, on PERTURB's inputs, in f32; one f32 step of
    JAX's optax Adam (constant_with_warmup, clip 1.0) over every parameter
    from the unperturbed f32 gradients."""
    from synchformer_tpu.models.sync_model import Synchformer as JSynchformer
    from test_torch_sync_train import jax_step_state

    from synchformer_tpu_torch.registry import instantiate_from_config

    rng = np.random.default_rng(11)
    vis = rng.standard_normal((1, 2, 16, 64, 64, 3)).astype(np.float32)
    aud = rng.standard_normal((1, 2, 66, 128)).astype(np.float32)
    targets = np.array([3])
    closing = closing_norms(instantiate_from_config(legacy_cfg(), device="meta"))
    jmod = JSynchformer(**legacy_cfg()["params"])
    variables = centred(jax_vars(jmod, jnp.asarray(vis), jnp.asarray(aud), closing=frozenset(
        f"{TOWER_KEYS[k.split('.')[0]]}.{k.split('.', 1)[1]}" for k in closing)))
    j32 = jax_legacy_stage2(variables, vis, aud, targets, jnp.float32, PERTURB)
    (j64,) = jax_legacy_stage2(variables, vis, aud, targets, jnp.float64)
    state = jax_step_state(variables["params"], tuple(variables["params"]))
    new_state, _ = jax.jit(lambda s, g: s.apply_gradients(g))(
        state, jax.tree_util.tree_map(jnp.float32, j32[0]["grads"]))
    return dict(vis=vis, aud=aud, targets=targets, variables=variables, j32=j32, j64=j64,
                new_params=port_sd(variables, new_state.params, j32[0]["stats"]))


def port_legacy_model(variables):
    from synchformer_tpu_torch.registry import instantiate_from_config
    from synchformer_tpu_torch.train import state as tstate

    model = instantiate_from_config(legacy_cfg())
    convert.load_numpy_state_dict(model, port_sd(variables))
    tstate.set_trainable(model, ("vfeat_extractor", "afeat_extractor",
                                 *tstate.SYNC_TRAINABLE_KEYS))
    return model


def grad_norm_of(j: dict) -> float:
    return float(np.sqrt(sum(float((g ** 2).sum()) for g in jax.tree_util.tree_leaves(
        j["grads"]))))


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_legacy_towers_train_as_jax(stage2, impl):
    """S3D (frames (1, 2, 16, 64, 64, 3), a (2, 2, 2) map) and ResNet-18
    (log-mel (1, 2, 66, 128), (4, 3)) whole in training inside the legacy
    Synchformer (extractors_deterministic=False), on both routes (the kernel
    route's K4 autograd Function runs its plain version on CPU tensors),
    against the JAX towers applied with deterministic=False and mutable
    batch_stats: each tower's features, its updated running statistics and
    the gradients of its parameters of the Stage II loss, each family held
    by hold_family."""
    model = port_legacy_model(stage2["variables"])
    feats = {}
    for key in TOWER_KEYS:
        getattr(model, key).register_forward_hook(
            lambda mod, args, out, key=key: feats.__setitem__(key, out))
    loss, _ = model(t(stage2["vis"]), t(stage2["aud"]), torch.from_numpy(stage2["targets"]),
                    impl, deterministic=False, generator=torch.Generator(),
                    extractors_deterministic=False)
    loss.backward()
    j32, j64, v = stage2["j32"], stage2["j64"], stage2["variables"]
    stats32 = [running_stats(port_sd(v, stats=j["stats"])) for j in j32]
    stats64 = running_stats(port_sd(v, stats=j64["stats"]))
    grads32 = [port_sd(v, j["grads"], j["stats"]) for j in j32]
    grads64 = port_sd(v, j64["grads"], j64["stats"])
    got_stats = running_stats(model.state_dict())
    assert sorted(got_stats) == sorted(stats64)
    for key in TOWER_KEYS:
        hold_family({key: feats[key]}, [{key: j["feats"][key]} for j in j32],
                    {key: j64["feats"][key]}, value_scales({key: j64["feats"][key]}), REL, key)

        def mine(d, key=key):
            return {k: x for k, x in d.items() if k.startswith(key + ".")}

        hold_family(mine(got_stats), [mine(s) for s in stats32], mine(stats64),
                    value_scales(mine(stats64)), REL, f"{key} running statistics")
        want = {k: x for k, x in mine(grads64).items() if k not in stats64}
        got = {n: p.grad for n, p in model.named_parameters() if n in want}
        hold_family(got, [mine(g) for g in grads32], want, grad_scales(want), GRAD_REL,
                    f"{key} gradients")


def test_legacy_stage2_step_matches_jax(stage2):
    """One sync_train_step with every parameter training (is_trainable
    towers, extractors_deterministic=False) against the JAX step composed
    from the JAX model (jax.value_and_grad over model.apply with mutable
    batch_stats, optax Adam): the loss and gradient norm (hold_family, rtol
    1e-5), every parameter after the step (assert_step) and the running
    statistics the step leaves (hold_family)."""
    from test_torch_sync_train import LR, WARMUP

    from synchformer_tpu_torch.train import state as tstate
    from synchformer_tpu_torch.train.step import sync_train_step

    model = port_legacy_model(stage2["variables"])
    opt = tstate.make_optimizer("adam", model.parameters(), eps=1e-8)
    m = sync_train_step(model, opt, tstate.make_lr_schedule("constant_with_warmup", LR, WARMUP),
                        0, t(stage2["vis"]), t(stage2["aud"]),
                        torch.from_numpy(stage2["targets"]), torch.Generator(), "kernel", 1.0,
                        extractors_deterministic=False)
    j32, j64, v = stage2["j32"], stage2["j64"], stage2["variables"]

    def scalars(j):
        return {"loss": float(j["loss"]), "grad_norm": grad_norm_of(j)}

    hold_family({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()},
                [scalars(j) for j in j32], scalars(j64), value_scales(scalars(j64)),
                LOSS_TOL["rtol"], "metrics")
    assert_step({n: p.detach() for n, p in model.named_parameters()}, stage2["new_params"],
                [port_sd(v, j["grads"], j["stats"]) for j in j32],
                port_sd(v, j64["grads"], j64["stats"]), grad_norm_of(j32[0]), LR / WARMUP)
    stats64 = running_stats(port_sd(v, stats=j64["stats"]))
    hold_family(running_stats(model.state_dict()),
                [running_stats(port_sd(v, stats=j["stats"])) for j in j32], stats64,
                value_scales(stats64), REL, "running statistics")


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
        "BasicBlock_stride2": (jres.BasicBlock(12, 2), tres.BasicBlock(8, 12, 2), (2, 9, 8, 8)),
    }


@pytest.mark.parametrize("name", ["BasicConv3d", "SepConv3d_stride2", "InceptionMixed",
                                  "BasicBlock_stride2"])
def test_legacy_block_trains_as_flax(name):
    """S3D's BasicConv3d, SepConv3d (stride 2), InceptionMixed (its -inf SAME
    pool, the deterministic max-pool backward) and ResNet's strided
    BasicBlock in training (train=True) against the flax blocks applied with
    train=True and mutable batch_stats, all f32 at the strict tolerances: the
    output, every updated running statistic and every gradient (of the
    input too) of sum(y * cotangent)."""
    jmod, mod, shape = _blocks()[name]
    x = rand(shape, 9)
    variables = jax_vars(jmod, jnp.asarray(x))
    out = jax.eval_shape(lambda v, x: jmod.apply(v, x), variables, jnp.asarray(x))
    cot = rand(out.shape, 10)

    @jax.jit
    def run(params, stats, x):
        def loss(params, x):
            y, new = jmod.apply({"params": params, "batch_stats": stats}, x, True,
                                mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, new["batch_stats"])

        (_, (y, new)), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
        return y, new, grads

    want, new, (gp, gx) = run(variables["params"], variables["batch_stats"], jnp.asarray(x))
    convert.load_numpy_state_dict(mod, convert.legacy_trunk_sd(variables["params"],
                                                               variables["batch_stats"]))
    perm = (0, x.ndim - 1, *range(1, x.ndim - 1))
    back = (0, *range(2, x.ndim), 1)
    xt = t(x).permute(*perm).requires_grad_()
    got = mod(xt, train=True)
    (got * t(cot).permute(*perm)).sum().backward()
    assert_rel(got.permute(*back), want, REL, "y")
    assert_rel(xt.grad.permute(*back), gx, GRAD_REL, "dx")
    stats = running_stats(convert.legacy_trunk_sd(variables["params"], new))
    assert sorted(running_stats(mod.state_dict())) == sorted(stats)
    for key, value in running_stats(mod.state_dict()).items():
        assert_rel(value, stats[key], REL, key)
    grads = {k: v for k, v in convert.legacy_trunk_sd(gp, new).items() if k not in stats}
    assert sorted(grads) == sorted(n for n, _ in mod.named_parameters())
    for n, p in mod.named_parameters():
        bound = GRAD_REL * layer_scale(grads, n) + 1e-8
        assert gap(p.grad, grads[n]) <= bound, (n, gap(p.grad, grads[n]), bound)


def legacy_trainer_cfg(trainable: bool) -> dict:
    """SyncTrainer's config over legacy_cfg: Stage II offsets, both towers
    ``is_trainable`` or frozen, f32, Adam, every randomness of the data
    prep live (the flip; colour jitter and grayscale at p 0.5)."""
    model = legacy_cfg()
    for key in TOWER_KEYS:
        model["params"][key]["is_trainable"] = trainable
    return {"action": "train_avsync_model", "model": model,
            "training": {"use_half_precision": False, "seed": 0, "base_learning_rate": 1e-3,
                         "lr_scheduler": {"name": "constant_with_warmup", "warmup": 2},
                         "optimizer": {"name": "adam"}},
            "data": {"n_segments": 2, "p_color_jitter": 0.5, "p_gray_scale": 0.5,
                     "p_horizontal_flip": 0.5}}


def legacy_loader_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"video": rng.integers(0, 256, (1, 2, 16, 64, 64, 3), dtype=np.uint8),
            "audio": (rng.standard_normal((1, 2, 10240)) * 0.1).astype(np.float32),
            "offset_target": np.array([5])}


def test_legacy_trainer_resume_restores_running_statistics(tmp_path):
    """SyncTrainer with is_trainable legacy towers on the CPU: prepare hands
    the S3D the normalised frames (B, S, T, H, W, C); its checkpoint payload
    after two steps holds the towers' running statistics; a new trainer
    restored from it through maybe_resume (CheckpointManager) holds them bit
    for bit, and its third step equals the first trainer's third step bit for
    bit: parameters, running statistics and metrics."""
    from synchformer_tpu_torch.train.stage_sync import SyncTrainer
    from synchformer_tpu_torch.utils.checkpoint import CheckpointManager
    from synchformer_tpu_torch.utils.logger import EarlyStopper

    cfg = legacy_trainer_cfg(True)
    tr = SyncTrainer(cfg, device="cpu")
    assert tr.towers_trainable
    vis, _ = tr.prepare(legacy_loader_batch(0), train=False)
    assert vis.shape == (1, 2, 16, 64, 64, 3)
    before = running_stats({k: v.clone() for k, v in tr.model.state_dict().items()})
    for i in range(2):
        tr.train_step(legacy_loader_batch(i))
    stopper = EarlyStopper(5, "max")
    payload = tr.payload(0, stopper)
    saved = {k: v.clone() for k, v in running_stats(payload["trainable"]).items()}
    assert sorted(saved) == sorted(before)
    assert all(not torch.equal(saved[k], before[k]) for k in saved)
    ckpt = CheckpointManager(str(tmp_path / "ckpts"))
    ckpt.save_latest(0, payload)
    m3 = tr.train_step(legacy_loader_batch(2))

    resumed = SyncTrainer({**cfg, "training": {**cfg["training"], "resume": True}}, device="cpu")
    resumed.ckpt = ckpt
    assert resumed.maybe_resume(EarlyStopper(5, "max")) == 1
    state = resumed.model.state_dict()
    assert all(torch.equal(state[k], v) for k, v in saved.items())
    r3 = resumed.train_step(legacy_loader_batch(2))
    assert r3 == m3
    for k, v in tr.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_frozen_legacy_towers_keep_their_statistics():
    """Frozen legacy towers (no is_trainable) run their eval path in a Stage
    II step: their running statistics and parameters stay as they were, the
    projections and the transformer train."""
    from synchformer_tpu_torch.train.stage_sync import SyncTrainer

    tr = SyncTrainer(legacy_trainer_cfg(False), device="cpu")
    assert not tr.towers_trainable
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    assert np.isfinite(tr.train_step(legacy_loader_batch(0))["loss"])
    after = tr.model.state_dict()
    for k, v in before.items():
        moved = not torch.equal(after[k], v)
        assert moved == (not k.startswith(tuple(TOWER_KEYS))
                         and k.endswith(("weight", "bias", "pos_emb", "tok"))), k


def test_moco_over_legacy_towers_is_refused():
    """MoCo over the legacy towers raises NotImplementedError with its reason
    (the JAX momentum update maps the parameters alone and the key towers
    are applied without batch_stats) and the ROADMAP item."""
    from synchformer_tpu_torch.registry import instantiate_from_config

    towers = {k: v for k, v in legacy_cfg()["params"].items() if k in TOWER_KEYS}
    for node in towers.values():
        node["params"]["agg_time_module"] = "AveragePooling"
    node = {"target": "synchformer_tpu.models.moco_clip.MultilevelMoCoCLIP", "params": {
        **towers, "queue_size": 8, "momentum": 0.99, "n_embd": 64,
        "aproj": {"target": "torch.nn.Linear", "params": {"in_features": 512,
                                                          "out_features": 64}},
        "vproj": {"target": "torch.nn.Linear", "params": {"in_features": 1024,
                                                          "out_features": 64}}}}
    with pytest.raises(NotImplementedError,
                       match=r"momentum model's BatchNorm statistics.*|ROADMAP §1 item 7\.5"):
        instantiate_from_config(node, device="meta")
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1 item 7\.5.*batch_stats"):
        instantiate_from_config(node, device="meta")


@pytest.mark.parametrize("pattern", [("bs t h w d -> bs t d", None),
                                     ("bs f t d -> bs t d", "bs t d -> t bs d"),
                                     ("b s t d -> b s d", None)])
def test_average_pooling_target_matches_jax(pattern):
    """synchformer_tpu.models.aggregators.AveragePooling built from a config
    node through the port's registry (its einops mean-reduce, then the
    optional rearrange) against the JAX module: within 1e-6."""
    from synchformer_tpu.models.aggregators import AveragePooling as JAveragePooling
    from synchformer_tpu.registry import instantiate_from_config as jax_instantiate

    from synchformer_tpu_torch.registry import instantiate_from_config

    avg, then = pattern
    node = {"target": "synchformer_tpu.models.aggregators.AveragePooling",
            "params": {"avg_pattern": avg, "then_permute_pattern": then}}
    x = rand((2, 3, 4, 5, 6)[:len(avg.split("->")[0].split())], 13)
    jmod = jax_instantiate(node)
    assert isinstance(jmod, JAveragePooling)
    want = jmod.apply({}, jnp.asarray(x))
    got = instantiate_from_config(node)(t(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_model", [2, 4])
def test_tensor_parallel_rule_keeps_batchnorms_whole(n_model):
    """parallel/tensor.py's sharding rule (JAX param_shardings' Dense
    kernels) shards none of the legacy towers' BatchNorm weights and biases,
    nor their convs: model peers hold them whole and replicated, as their
    statistics need (the rows of a data rank, summed over the data group
    alone)."""
    from synchformer_tpu_torch.parallel import tensor as ptensor
    from synchformer_tpu_torch.registry import instantiate_from_config

    model = instantiate_from_config(legacy_cfg(), device="meta")
    entries = ptensor.sharded_entries(model, n_model)
    assert entries  # the projections, aggregators and transformer are sharded
    norms = {id(m) for m in model.modules() if isinstance(m, (tconv.BatchNorm, tconv.Conv))}
    assert not [path for path, mod, _ in entries if id(mod) in norms]
