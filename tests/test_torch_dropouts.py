"""The towers' training dropouts and the Stage I projections against the JAX
package on the CPU.

- Rates at 0 in training mode: one AVCLIP and one MoCo Stage I step, both
  built through the port's registry from the JAX config nodes (towers of
  D=128, 2 heads of 64, 2 layers (the MoCo model's 1, as
  tests/test_torch_moco.py's), 4 frames of 32 px, the real 128 x 66 mel;
  ``hidden_dropout``, ``attn_dropout`` and ``drop_rate`` given as 0; Linear
  ``aproj`` / ``vproj``, the MoCo model's per level and their momentum
  copies), against make_avclip_train_step / make_moco_train_step on the JAX
  XLA path (the step's gradients read back from AdamW's first moment,
  exact to f32 rounding: no second JAX program to compile): losses rtol
  1e-5, each gradient within 2e-5 of its tensor's largest + 1e-8, the
  parameters after
  AdamW within 2e-6 where the clipped gradient exceeds 1e-5, the EMA
  parameters rtol 1e-6 (tests/test_torch_train.py's and
  tests/test_torch_moco.py's bounds).
- Rates above 0, held by their semantics as
  tests/test_torch_sync_train.py::test_token_dropout_semantics does: every
  element dropout of a block is recorded (its input and output); each keeps
  a share within 5 binomial standard deviations of 1 - p, kept values are
  scaled by exactly 1 / (1 - p) and the rest are 0; the draws repeat from
  the generator's seed, on the plain and the kernel route alike (the order
  of draws does not depend on the route); the stochastic block equals a
  plain composition that applies the recorded masks (rtol 1e-5 of the
  largest value); remat draws the forward's masks when it recomputes.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import randomize
from test_torch_train import GRAD_REL_TO_MAX, LOSS_TOL, PARAM_ATOL, SETTLED_GRAD

from synchformer_tpu_torch.models import aggregators as tagg
from synchformer_tpu_torch.models import layers as tlayers
from synchformer_tpu_torch.models import motionformer as tmf
from synchformer_tpu_torch.models.moco_clip import MoCoQueues
from synchformer_tpu_torch.registry import instantiate_from_config
from synchformer_tpu_torch.train import state as tstate
from synchformer_tpu_torch.train.step import avclip_train_step, moco_train_step
from synchformer_tpu_torch.utils import convert

torch.set_num_threads(2)

D, HEADS, DEPTH, IMG, PATCH, FT = 128, 2, 2, 32, 8, 2
B, S, Q = 2, 2, 4
LR, WARMUP, TOTAL, WD, MOMENTUM, ALPHA = 1e-3, 2, 20, 0.2, 0.9, 0.4
REL = 1e-5
LIN = dict(target="torch.nn.Linear", params=dict(in_features=D, out_features=D))


def tower_nodes(glob: dict, depth: int = DEPTH) -> tuple:
    """The AST and Motionformer nodes with every dropout given as 0."""
    aud = dict(hidden_size=D, depth=depth, num_heads=HEADS, agg_time_module="AveragePooling",
               hidden_dropout=0.0, attn_dropout=0.0, **glob)
    vis = dict(embed_dim=D, depth=depth, num_heads=HEADS, patch_size=PATCH, z_block_size=2,
               temporal_resolution=FT, img_size=IMG, drop_path_rate=0.0, drop_rate=0.0,
               pos_dropout=0.0, agg_time_module="AveragePooling", **glob)
    return (dict(target="synchformer_tpu.models.ast_encoder.ASTEncoder", params=aud),
            dict(target="synchformer_tpu.models.motionformer.MotionFormerEncoder", params=vis))


def model_node(moco: bool) -> dict:
    if moco:
        a, v = tower_nodes(dict(add_global_repr=True, max_segments=S), depth=1)
        return dict(target="synchformer_tpu.models.moco_clip.MultilevelMoCoCLIP",
                    params=dict(n_embd=D, queue_size=Q, momentum=MOMENTUM, afeat_extractor=a,
                                vfeat_extractor=v, aproj=LIN, vproj=LIN))
    a, v = tower_nodes({})
    return dict(target="synchformer_tpu.models.avclip.AVCLIP",
                params=dict(n_embd=D, afeat_extractor=a, vfeat_extractor=v, aproj=LIN,
                            vproj=LIN))


def batch_np(seed: int = 0):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (B, S, 2 * FT, IMG, IMG, 3), np.uint8)
    frames = (u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    return frames, rng.standard_normal((B, S, 66, 128)).astype(np.float32)


def jax_optimizer(params):
    from synchformer_tpu.train.state import SyncTrainState, make_lr_schedule, make_optimizer

    tx = make_optimizer("adamw", lr=make_lr_schedule("cosine", LR, WARMUP, TOTAL),
                        weight_decay=WD, max_clip_norm=1.0,
                        weight_decay_mask=jax.tree.map(lambda p: p.ndim >= 2, params))
    return SyncTrainState.create(params, tx, trainable_keys=tuple(params.keys()))


def step_grads(state, grad_norm: float, b1: float = 0.9, clip: float = 1.0):
    """The gradients of the step that made ``state``, from AdamW's first
    moment after its first step: mu = (1 - b1) * g * min(1, clip / |g|)."""
    import optax

    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1 and int(state.step) == 1
    return jax.tree.map(lambda m: m / (1.0 - b1) * max(1.0, grad_norm / clip), adam[0].mu)


@pytest.fixture(scope="module")
def avclip_case():
    """The JAX AVCLIP with Linear projections: randomised params, one
    make_avclip_train_step, its loss and gradients."""
    from synchformer_tpu.registry import instantiate_from_config as jax_instantiate
    from synchformer_tpu.train.step import make_avclip_train_step

    frames, aud = batch_np()
    model = jax_instantiate(copy.deepcopy(model_node(False)))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(frames),
                            jnp.asarray(aud))
    params = {**randomize(shapes)["params"], "logit_scale": jnp.asarray(0.07, jnp.float32)}
    new_state, metrics = make_avclip_train_step(model, donate=False)(
        jax_optimizer(params), {"vis": jnp.asarray(frames), "aud": jnp.asarray(aud)},
        jax.random.PRNGKey(0))
    metrics = {k: float(v) for k, v in metrics.items()}
    return dict(frames=frames, aud=aud, params=params, loss=metrics["loss"],
                grads=convert.avclip_state_dict_from_jax(step_grads(new_state,
                                                                    metrics["grad_norm"])),
                metrics=metrics,
                new_params=convert.avclip_state_dict_from_jax(new_state.trainable))


def check_params_after(model, case, grad_norm: float, lr0: float, settled_share: float):
    clip = max(grad_norm, 1.0)
    n_settled = n_all = 0
    for name, p in model.state_dict().items():
        settled = np.abs(case["grads"][name]) / clip > SETTLED_GRAD
        atol = np.where(settled, PARAM_ATOL, 2 * lr0 + PARAM_ATOL)
        assert np.all(np.abs(p.numpy() - case["new_params"][name]) <= atol), name
        n_settled, n_all = n_settled + int(settled.sum()), n_all + settled.size
    assert n_settled > settled_share * n_all


def check_grads(grads: dict, want: dict):
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        bound = GRAD_REL_TO_MAX * float(np.abs(want[name]).max()) + 1e-8
        assert float(np.abs(g - want[name]).max()) <= bound, name


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_avclip_step_with_projections_matches_jax(avclip_case, impl):
    """AVCLIP from its config node (Linear aproj / vproj, every rate 0) in
    training mode: loss and gradients against jax.value_and_grad, then one
    avclip_train_step against make_avclip_train_step."""
    case = avclip_case
    vis, aud = torch.from_numpy(case["frames"]), torch.from_numpy(case["aud"])
    model = instantiate_from_config(model_node(False))
    sd = convert.avclip_state_dict_from_jax(case["params"])
    assert {"vproj.weight", "vproj.bias", "aproj.weight", "aproj.bias"} <= set(sd)
    convert.load_numpy_state_dict(model, sd)
    loss, _, _ = model(vis, aud, impl, deterministic=False, generator=torch.Generator())
    loss.backward()
    np.testing.assert_allclose(loss.item(), case["loss"], **LOSS_TOL)
    check_grads({n: p.grad.numpy() for n, p in model.named_parameters()}, case["grads"])
    model = instantiate_from_config(model_node(False))
    convert.load_numpy_state_dict(model, sd)
    opt = tstate.make_adamw(model.named_parameters(), WD)
    sched = tstate.make_lr_schedule("cosine", LR, WARMUP, TOTAL)
    metrics = avclip_train_step(model, opt, sched, 0, vis, aud, torch.Generator(), impl, 1.0)
    for key in ("loss", "grad_norm", "logit_scale"):
        np.testing.assert_allclose(float(metrics[key]), case["metrics"][key], err_msg=key,
                                   **LOSS_TOL)
    check_params_after(model, case, case["metrics"]["grad_norm"], sched(0), 0.85)


@pytest.fixture(scope="module")
def moco_case():
    """The JAX MoCo model with Linear projections per level: randomised
    online and EMA params, queues, one make_moco_train_step and its
    gradients."""
    from synchformer_tpu.models.moco_clip import init_queues
    from synchformer_tpu.registry import instantiate_from_config as jax_instantiate
    from synchformer_tpu.train.step import make_moco_train_step

    frames, aud = batch_np(1)
    batch = {"vis": jnp.asarray(frames), "aud": jnp.asarray(aud)}
    model = jax_instantiate(copy.deepcopy(model_node(True)))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch["vis"], batch["aud"])
    scales = {k: jnp.asarray(0.07, jnp.float32)
              for k in ("segment_logit_scale", "global_logit_scale")}
    params = {**randomize(shapes)["params"], **scales}
    params_m = {**randomize(params, seed=2), **scales}
    queues = init_queues(jax.random.PRNGKey(1), D, Q * S, Q)
    new_state, new_moco, metrics = make_moco_train_step(model, donate=False)(
        jax_optimizer(params), {"params_m": params_m, "queues": queues}, batch,
        jax.random.PRNGKey(0), jnp.float32(ALPHA))
    metrics = {k: float(v) for k, v in metrics.items()}
    return dict(frames=frames, aud=aud, params=params, params_m=params_m,
                queues={k: np.asarray(getattr(queues, k)) for k in
                        ("segment_v", "segment_a", "global_v", "global_a")},
                grads=convert.moco_state_dict_from_jax(step_grads(new_state,
                                                                  metrics["grad_norm"])),
                metrics=metrics,
                new_params=convert.moco_state_dict_from_jax(new_state.trainable),
                new_params_m=convert.moco_state_dict_from_jax(new_moco["params_m"]))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_moco_step_with_projections_matches_jax(moco_case, impl):
    """MultilevelMoCoCLIP from its config node (Linear projections for both
    levels, every rate 0): one moco_train_step against make_moco_train_step:
    the losses, the gradients, the parameters after AdamW and the momentum
    copies of the projections among the EMA parameters."""
    case = moco_case
    model = instantiate_from_config(model_node(True))
    model_m = copy.deepcopy(model).requires_grad_(False)
    sd = convert.moco_state_dict_from_jax(case["params"])
    for level in ("segment", "global"):
        assert {f"{level}_vproj.weight", f"{level}_aproj.bias"} <= set(sd)
    convert.load_numpy_state_dict(model, sd)
    convert.load_numpy_state_dict(model_m, convert.moco_state_dict_from_jax(case["params_m"]))
    q = case["queues"]
    queues = MoCoQueues(torch.from_numpy(q["segment_v"].copy()),
                        torch.from_numpy(q["segment_a"].copy()), 0,
                        torch.from_numpy(q["global_v"].copy()),
                        torch.from_numpy(q["global_a"].copy()), 0)
    opt = tstate.make_adamw(model.named_parameters(), WD)
    sched = tstate.make_lr_schedule("cosine", LR, WARMUP, TOTAL)
    metrics = moco_train_step(model, model_m, queues, opt, sched, 0,
                              torch.from_numpy(case["frames"]), torch.from_numpy(case["aud"]),
                              torch.Generator(), ALPHA, impl, 1.0)
    for key in ("loss", "segment_contrastive_loss", "global_contrastive_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), case["metrics"][key], err_msg=key,
                                   **LOSS_TOL)
    check_params_after(model, case, case["metrics"]["grad_norm"], sched(0), 0.8)
    for name, p in model_m.state_dict().items():
        np.testing.assert_allclose(p.numpy(), case["new_params_m"][name], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert "global_aproj.weight" in dict(model_m.named_parameters())


# --- semantics at rates above 0 ----------------------------------------------

class Recorder:
    """Every element dropout (its rate, input and output) and every drop-path
    factor, in draw order, while installed on the port's modules."""

    def __init__(self, monkeypatch):
        self.drops, self.scales = [], []
        real, draw = tlayers.element_dropout, tlayers.drop_path_factors

        def element_dropout(x, rate, generator):
            out = real(x, rate, generator)
            if rate > 0.0:
                self.drops.append((rate, x.detach().clone(), out.detach().clone()))
            return out

        def draw_scale(n, rate, generator, device, dtype):
            scale = draw(n, rate, generator, device, dtype)
            if scale is not None:
                self.scales.append(scale)
            return scale

        for mod in (tlayers, tmf, tagg):
            monkeypatch.setattr(mod, "element_dropout", element_dropout)
        monkeypatch.setattr(tlayers, "drop_path_factors", draw_scale)

    def masks(self):
        """Each recorded dropout's keep mask, after checking its semantics:
        kept values x / (1 - p) exactly, the rest 0, the kept share of the
        nonzero inputs within 5 binomial standard deviations of 1 - p."""
        out = []
        for rate, x, y in self.drops:
            keep = y != 0
            torch.testing.assert_close(y[keep], x[keep] / (1.0 - rate), rtol=0, atol=0)
            n = int((x != 0).sum())
            share = float(keep.sum()) / n
            assert abs(share - (1.0 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5, (share, n)
            out.append((rate, keep))
        return out


def apply(mask, t):
    rate, keep = mask
    return torch.where(keep, t / (1.0 - rate), torch.zeros((), dtype=t.dtype))


def plain_block(x, p, heads, eps, masks, scales=(None, None), query_rows=None):
    """An independent pre-LN block (torch.nn.functional) applying recorded
    masks in the port's order: attention probabilities, projection, MLP
    hidden, MLP output; drop-path factors per branch."""
    it = iter(masks)
    d = x.shape[-1]
    dh = d // heads
    h = torch.nn.functional.layer_norm(x, (d,), p.ln1_w, p.ln1_b, eps)
    qkv = h @ p.wqkv.t() + p.bqkv
    q, k, v = (t.reshape(*x.shape[:-1], heads, dh).transpose(-3, -2) for t in qkv.split(d, -1))
    if query_rows is not None:
        q = q[..., :query_rows, :]
    probs = torch.softmax(q @ k.transpose(-1, -2) * dh ** -0.5, dim=-1)
    probs = apply(next(it), probs)
    a = (probs @ v).transpose(-3, -2).reshape(*q.shape[:-3], q.shape[-2], d)
    a = apply(next(it), a @ p.wproj.t() + p.bproj)
    if scales[0] is not None:
        a = a * scales[0].reshape(-1, *(1,) * (a.ndim - 1))
    x = (x if query_rows is None else x[..., :query_rows, :]) + a
    h = torch.nn.functional.layer_norm(x, (d,), p.ln2_w, p.ln2_b, eps)
    h = apply(next(it), torch.nn.functional.gelu(h @ p.w1.t() + p.b1))
    h = apply(next(it), h @ p.w2.t() + p.b2)
    if scales[1] is not None:
        h = h * scales[1].reshape(-1, *(1,) * (h.ndim - 1))
    return x + h


def seeded(module, seed: int = 0):
    convert.load_numpy_state_dict(module, convert.seeded_state_dict(module, seed))
    return module


def rel_close(got, want, rel=REL):
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("block", ["ast_layer", "joint_block"])
def test_preln_block_dropouts_semantics(monkeypatch, block):
    """An AST layer (attn_dropout 0.2, hidden_dropout 0.3) and a joint
    Motionformer block (drop_rate 0.3, drop-path 0.5) in training: the
    recorded masks hold the dropout semantics, the output equals the plain
    composition with them, the draws repeat from the seed on both routes."""
    rec = Recorder(monkeypatch)
    if block == "ast_layer":
        mod = seeded(tlayers.ASTLayer(D, HEADS, 1e-12, 4.0, 0.2, 0.3))
    else:
        mod = seeded(tlayers.ViTBlock(D, HEADS, 1e-6, 4.0, 0.3, 0.5))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((6, 40, D)).astype(np.float32))
    with torch.no_grad():
        outs = [mod(x, impl, generator=torch.Generator().manual_seed(7))
                for impl in ("plain", "kernel", "plain")]
        other = mod(x, "plain", generator=torch.Generator().manual_seed(8))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], other)
    n = 4 if block == "ast_layer" else 3  # attention probabilities: rate 0 in the joint block
    masks = rec.masks()[:n]
    scales = rec.scales[:2] if block == "joint_block" else (None, None)
    if block == "joint_block":
        masks = [(0.0, torch.ones((), dtype=torch.bool))] + masks
    with torch.no_grad():
        rel_close(outs[0], plain_block(x, mod.block_params(), HEADS, mod.eps, masks, scales))


def test_cls_pool_layer_dropout_semantics(monkeypatch):
    """The frequency aggregator's block with dropout 0.25 in training (the
    AST's attn_dropout): the CLS row pooled with the recorded masks equals
    the plain composition over [cls; x]; routes and seeds as above."""
    rec = Recorder(monkeypatch)
    mod = seeded(tagg.FrequencyAggregator(D, HEADS, dropout=0.25))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 12, 6, D)).astype(
        np.float32))
    with torch.no_grad():
        outs = [mod(x, impl, False, torch.Generator().manual_seed(2)) for impl in ("plain",
                                                                                     "kernel")]
    assert torch.equal(outs[0], outs[1])
    masks = rec.masks()[:4]
    flat = x.transpose(1, 2).reshape(24, 12, D)
    full = torch.cat([mod.cls_token.detach().expand(24, 1, D), flat], dim=1)
    with torch.no_grad():
        want = plain_block(full, mod.block_params(), HEADS, mod.eps, masks, query_rows=1)
    rel_close(outs[0], want[:, 0].reshape(4, 6, D))


@pytest.mark.parametrize("flow", ["split", "packed_masked"])
def test_divided_block_dropout_semantics(monkeypatch, flow):
    """A divided space-time block with drop_rate 0.3 and drop-path 0.4 in
    training: on the split flow (K5 on the kernel route) the projections of
    the CLS row and the patches are dropped apart, each MLP with both of its
    dropouts; on the packed flow under a keep-mask the same on [cls;
    patches]. The output equals the block's own deterministic pieces
    composed with the recorded masks and drop-path factors."""
    rec = Recorder(monkeypatch)
    blk = seeded(tmf.DividedSpaceTimeBlock(D, HEADS, 1e-6, 4.0, 0.4, "pallas", 0.3))
    rng = np.random.default_rng(5)
    f, n = 2, 16
    cls = torch.from_numpy(rng.standard_normal((3, 1, D)).astype(np.float32))
    patches = torch.from_numpy(rng.standard_normal((3, f, n, D)).astype(np.float32))
    scales = [torch.tensor([2.5, 0.0, 2.5]), torch.tensor([0.0, 2.5, 2.5])]
    keep = torch.from_numpy(rng.random((3, 1 + f * n)) > 0.3)
    keep[:, 0] = True
    with torch.no_grad():
        outs = []
        for impl in ("plain", "kernel"):
            g = torch.Generator().manual_seed(11)
            if flow == "split":
                outs.append(torch.cat([t.reshape(3, -1, D) for t in blk.forward_train(
                    cls, patches, impl, *scales, g)], dim=1))
            else:
                x = torch.cat([cls, patches.reshape(3, f * n, D)], dim=1)
                outs.append(blk.forward_packed(x, f, impl, *scales, g, keep))
    assert torch.equal(outs[0], outs[1])
    m = rec.masks()[:len(rec.masks()) // 2]
    drop = tlayers.DropPath.drop
    with torch.no_grad():
        if flow == "split":
            it = iter(m)
            t_c, t_p = blk.timeattn.attend(blk.norm3(cls), blk.norm3(patches), "time", "plain")
            c, p = cls + apply(next(it), t_c), patches + apply(next(it), t_p)
            s_c, s_p = blk.attn.attend(blk.norm1(c), blk.norm1(p), "space", "plain")
            c = c + drop(apply(next(it), s_c), scales[0])
            p = p + drop(apply(next(it), s_p), scales[0])

            def mlp_masked(t):
                h = tlayers.exact_gelu(tlayers.dense(blk.norm2(t), blk.mlp.fc1.weight,
                                                     blk.mlp.fc1.bias, t.dtype))
                h = apply(next(it), h)
                return apply(next(it), tlayers.dense(h, blk.mlp.fc2.weight, blk.mlp.fc2.bias,
                                                     t.dtype))

            c = c + drop(mlp_masked(c), scales[1])
            p = p + drop(mlp_masked(p), scales[1])
            want = torch.cat([c, p.reshape(3, -1, D)], dim=1)
        else:
            it = iter(m)
            x = torch.cat([cls, patches.reshape(3, f * n, D)], dim=1)
            x = x + apply(next(it), blk.timeattn.attend_packed(x, blk.norm3, f, "time", "plain",
                                                               "pallas", None, keep))
            x = x + drop(apply(next(it), blk.attn.attend_packed(
                x, blk.norm1, f, "space", "plain", "pallas", None, keep)), scales[0])
            h = tlayers.exact_gelu(tlayers.dense(blk.norm2(x), blk.mlp.fc1.weight,
                                                 blk.mlp.fc1.bias, x.dtype))
            h = tlayers.dense(apply(next(it), h), blk.mlp.fc2.weight, blk.mlp.fc2.bias, x.dtype)
            want = x + drop(apply(next(it), h), scales[1])
    rel_close(outs[0], want)


def test_tower_dropouts_repeat_and_remat(monkeypatch):
    """A tiny AVCLIP with every rate live (AST hidden 0.1 and attention 0.1,
    Motionformer drop_rate 0.1 and drop-path 0.2, so the aggregators' rates
    are live too): every recorded dropout holds its semantics (the tokens'
    hidden dropout among them); the loss repeats from the seed on both
    routes; remat (checkpoint_with_generator) gives the loss and gradients
    of no remat, and leaves the generator where the forward left it."""
    node = model_node(False)
    node["params"]["afeat_extractor"]["params"].update(hidden_dropout=0.1, attn_dropout=0.1)
    node["params"]["vfeat_extractor"]["params"].update(drop_rate=0.1, drop_path_rate=0.2)
    frames, aud = batch_np(2)
    vis, aud = torch.from_numpy(frames), torch.from_numpy(aud)
    sd = None
    results = []
    for impl, remat in (("plain", False), ("kernel", False), ("kernel", True)):
        for tower in ("afeat_extractor", "vfeat_extractor"):
            node["params"][tower]["params"]["remat"] = remat
        model = instantiate_from_config(copy.deepcopy(node))
        sd = sd or convert.seeded_state_dict(model, 0)
        convert.load_numpy_state_dict(model, sd)
        g = torch.Generator().manual_seed(5)
        rec = Recorder(monkeypatch) if not remat and impl == "plain" else None
        loss, _, _ = model(vis, aud, impl, deterministic=False, generator=g)
        loss.backward()
        after = torch.rand(4, generator=g)
        results.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()},
                        after))
        if rec is not None:
            masks = rec.masks()
            rates = sorted({r for r, _ in masks})
            assert rates == [0.1] and len(masks) > 20
            monkeypatch.undo()
    (l0, g0, a0), (l1, g1, a1), (l2, g2, a2) = results
    assert l0 == l1 and torch.equal(a0, a1)
    assert l2 == l1 and torch.equal(a2, a1)
    for name in g1:
        torch.testing.assert_close(g2[name], g1[name], rtol=1e-6, atol=1e-9)
