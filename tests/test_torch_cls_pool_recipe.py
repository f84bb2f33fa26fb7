"""K4 and K4b's recipe (csrc/cls_pool.cu) on the CPU, against the JAX
package's Pallas kernels in interpret mode and its reference compositions.
The kernels run only on the card (chip_smoke.py phase 2); here a torch
emulation of their arithmetic stands in for them:
- prep: LN1 of the query row (K4: the shared CLS row; K4b: each group's row
  0), q (K4: k_cls, v_cls) with f32 sums, the bias in f32 and one bf16
  rounding; U_h = Wk_h^T q_h in f32 (bf16 products are exact), entering the
  logits as bf16 hi + lo; c_h = bk_h . q_h and the CLS logit in f32;
- the pool pass: LN(x) rounded to bf16 once; logits LN(x) (U_hi + U_lo) + c,
  scaled in f32; the softmax's max and sum over every column (K4's CLS key
  included), taken in row parts and combined in order as the 2-block
  cluster's halves or the streamed chunks are, and only then p rounded to
  bf16; ptok the sum of the rounded p; Z = P^T LN(x) in f32;
- the Wv product per head, Z entering as bf16 hi + lo, + ptok bv (+ p_cls
  v_cls), one rounding;
- the tail: bf16(R + bf16(att Wp^T + bp)), LN2, bf16(GELU(. W1^T + b1)),
  bf16(y + bf16(. W2^T + b2)), f32 sums: the Hopper GEMM's epilogues, which
  the skinny product at a few groups repeats.
Then the pool pass's plan (_build.cls_pool_plan) against the constants and
the shared-memory formula of csrc/cls_pool.cu, and the shapes the wrappers
refuse before any launch.

Tolerances. In bf16 against the Pallas kernels, elementwise 2^-7 relative
plus 2^-7 of the output's largest value:
one bf16 step at the top of the output's range, since two bf16 paths may
round an output to neighbouring values (the recipe's K and V are not
rounded where the reference rounds both, its U and Z enter as hi + lo,
about 2^-16 relative, and its f32 sums run in another order). That is twice
tests/test_torch_ln_gemm.py's 2^-8 of the largest value: these layers end in
LN2 and an MLP after a peaked softmax, and the JAX package's own Pallas
kernel and reference composition differ by up to 0.0625 at a largest value
of 6.5 on these inputs (2^-6.7 of it), and at heads of 96 (d 192) by
0.068 at 3.56 (2^-5.7). Against the bf16 reference composition and the
port's plain version, the accuracy rule: the recipe's largest error against
the f32 reference at most theirs plus 2^-8 of the largest value (on the card
the kernel is held to 2 x the plain version's error + 1e-2 of the largest
value; the plain version and the recipe, both bf16 paths, differ by up to
0.055 at heads of 96, where the recipe is the nearer to f32). In f32
(every rounding an identity, U and Z exact), rtol = atol = 1e-5 against the
reference compositions (not against the Pallas kernels, whose tails take a
degree-9 erf polynomial GELU, |err| <= 3e-5, where the port takes the exact
erf: tests/test_torch_cls_pool_b.py holds that at 2e-4 / 3e-5).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from synchformer_tpu.ops.pallas import cls_pool as jcls
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels import cls_pool as tcls
from synchformer_tpu_torch.ops.numerics import exact_gelu_f32

torch.set_num_threads(2)

CSRC = _build.CSRC
bf = torch.bfloat16
EPS = 1e-6
BF16_TOL = dict(rtol=2.0 ** -7)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
MATS = (2, 4, 8, 10)  # of the layer: wqkv, wp, w1, w2; JAX (in, out), the port (out, in)
# (kind, d, heads, rows a group): every M of 1, 3, 12 and 37 at d 128 / 256
# (heads of 64), and heads of 96 (the 8-head video tower's width) at d 192
SHAPES = [(k, d, h, m) for k in ("K4", "K4b")
          for d, h, m in ((128, 2, 1), (128, 2, 12), (256, 4, 3), (256, 4, 37), (192, 2, 12))]


def _r(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _close_bf16(got, want):
    got, want = (np.asarray(t, np.float32) for t in (got, want))
    np.testing.assert_allclose(got, want, atol=np.abs(want).max() * 2.0 ** -7, **BF16_TOL)


def _no_less_accurate(got, ref, anchor):
    """max|got - anchor| <= max|ref - anchor| + 2^-8 max|anchor|."""
    got, ref, anchor = (np.asarray(t, np.float32) for t in (got, ref, anchor))
    err, err_ref = np.abs(got - anchor).max(), np.abs(ref - anchor).max()
    assert err <= err_ref + np.abs(anchor).max() * 2.0 ** -8, (err, err_ref)


def _layer(rng, d):
    """JAX-layout layer arguments after x: LN1, QKV, proj, LN2, MLP; the
    attention weights at std (2 / d)^0.5, so that the logits spread (std
    about 2) and the probabilities differ between rows."""
    w = (2.0 / d) ** 0.5
    return [1.0 + _r(rng, d, s=0.1), _r(rng, d, s=0.1), _r(rng, d, 3 * d, s=w),
            _r(rng, 3 * d, s=0.02), _r(rng, d, d, s=w), _r(rng, d, s=0.02),
            1.0 + _r(rng, d, s=0.1), _r(rng, d, s=0.1), _r(rng, d, 4 * d, s=d ** -0.5),
            _r(rng, 4 * d, s=0.02), _r(rng, 4 * d, d, s=(4 * d) ** -0.5), _r(rng, d, s=0.02)]


def _port(layer, dtype):
    """The port's layout and types: matrices (out, in) in ``dtype``, vectors f32."""
    out = []
    for i, a in enumerate(layer):
        t = torch.from_numpy(np.ascontiguousarray(a.T if i in MATS else a))
        out.append(t.to(dtype) if i in MATS else t)
    return out


def _ln(x, g, b, dtype):
    """ln_rows / the pool pass's LayerNorm: f32 mean and E[x^2], (x - mean) *
    rsqrt(max(E[x^2] - mean^2, 0) + eps) * g + b in f32, rounded once."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return ((x32 - mean) * torch.rsqrt(var + EPS) * g + b).to(dtype).float()


def recipe(x, cls, layer, heads, dtype=bf, parts=1):
    """csrc/cls_pool.cu on x (B, M, D) in ``dtype`` with the port's layer
    (matrices in ``dtype``); cls (D,) f32 for K4, None for K4b (row 0 of each
    group is its query row). ``parts``: the rows of a group taken in that
    many parts, their softmax max and sum combined in order and their Z
    summed (the 2-block cluster's halves, or the streamed chunks). In f32
    every rounding is an identity and the lo parts are zero."""
    def rnd(t):
        return t.to(dtype).float()

    g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, fb1, w2, fb2 = layer
    bsz, m, d = x.shape
    dh, scale = d // heads, (d // heads) ** -0.5
    wq = wqkv.float()
    qrow = (cls.to(dtype)[None] if cls is not None else x[:, 0]).float()
    qkv = rnd(_ln(qrow, g1, b1, dtype) @ wq.t() + bqkv)  # K4: [q | k_cls | v_cls]
    q = qkv[:, :d].reshape(-1, heads, dh)
    u = torch.einsum("bhe,hed->bhd", q, wq[d:2 * d].reshape(heads, dh, d))
    u_hi = rnd(u)
    u_lo = rnd(u - u_hi)
    c = (q * bqkv[d:2 * d].reshape(heads, dh)).sum(-1)
    lx = _ln(x, g1, b1, dtype)
    logits = (torch.einsum("bmd,bhd->bhm", lx, u_hi) + torch.einsum("bmd,bhd->bhm", lx, u_lo)
              + c[..., None]) * scale
    # the parts' max and sum, combined in order, then K4's CLS key
    mx, sm = None, None
    for rows in torch.tensor_split(torch.arange(m), parts):
        lp = logits[..., rows]
        m_p = lp.amax(-1)
        s_p = torch.exp(lp - m_p[..., None]).sum(-1)
        if mx is None:
            mx, sm = m_p, s_p
        else:
            mn = torch.maximum(mx, m_p)
            sm = sm * torch.exp(mx - mn) + s_p * torch.exp(m_p - mn)
            mx = mn
    if cls is not None:
        lc = (q * qkv[:, d:2 * d].reshape(-1, heads, dh)).sum(-1) * scale  # (1, heads)
        mn = torch.maximum(mx, lc)
        sm = sm * torch.exp(mx - mn) + torch.exp(lc - mn)
        mx = mn
        p_cls = rnd(torch.exp(lc - mx) * (1.0 / sm))
    p = rnd(torch.exp(logits - mx[..., None]) * (1.0 / sm)[..., None])
    ptok = p.sum(-1)
    z = sum(torch.einsum("bhm,bmd->bhd", p[..., rows], lx[:, rows])
            for rows in torch.tensor_split(torch.arange(m), parts))
    z_hi = rnd(z)
    z_lo = rnd(z - z_hi)
    wv = wq[2 * d:].reshape(heads, dh, d)
    att = (torch.einsum("bhd,hed->bhe", z_hi, wv) + torch.einsum("bhd,hed->bhe", z_lo, wv)
           + ptok[..., None] * bqkv[2 * d:].reshape(heads, dh))
    if cls is not None:
        att = att + p_cls[..., None] * qkv[:, 2 * d:].reshape(-1, heads, dh)
    att = rnd(att.reshape(bsz, d))
    res = qrow if cls is not None else x[:, 0].float()
    y = rnd(res + rnd(att @ wp.float().t() + bp))
    hid = rnd(exact_gelu_f32(_ln(y, g2, b2, dtype) @ w1.float().t() + fb1))
    return rnd(y + rnd(hid @ w2.float().t() + fb2))


def _jax_side(kind, fn, x, cls, layer, heads, dtype):
    args = [jnp.asarray(x, dtype)] + ([jnp.asarray(cls)] if kind == "K4" else [])
    args += [jnp.asarray(a, dtype) if i in MATS else jnp.asarray(a) for i, a in enumerate(layer)]
    return np.asarray(jax.jit(lambda *a: fn(*a, heads, EPS))(*args).astype(jnp.float32))


@pytest.mark.parametrize("kind,d,heads,m", SHAPES)
def test_recipe_against_the_pallas_kernels(kind, d, heads, m):
    """The recipe against _cls_pool_tokens_pallas / _cls_pool_pallas in
    interpret mode (B = 3 groups: the Pallas entries run their kernels, not
    their reference fallback) elementwise in bf16; no less accurate than the
    bf16 _ref and the port's plain version against the f32 _ref on the same
    bf16 x; and in f32 against the _refs (1e-5; the plain version against the Pallas
    kernels in f32: tests/test_torch_cls_pool_b.py)."""
    rng = np.random.default_rng(31 + d + m)
    bsz = 3
    x32, cls32, layer = _r(rng, bsz, m, d), _r(rng, d, s=0.5), _layer(rng, d)
    tokens = kind == "K4"
    pal, ref = ((jcls._cls_pool_tokens_pallas, jcls._cls_pool_tokens_ref) if tokens
                else (jcls._cls_pool_pallas, jcls._cls_pool_ref))
    assert jcls._seg_chunk(bsz, m + tokens) > 0
    x = torch.from_numpy(x32).to(bf)
    cls = torch.from_numpy(cls32) if tokens else None
    got = recipe(x, cls, _port(layer, bf), heads)
    xb = x.float().numpy()  # the bf16 inputs' values, for the f32 sides too
    with pltpu.force_tpu_interpret_mode():
        want_pal = _jax_side(kind, pal, xb, cls32, layer, heads, jnp.bfloat16)
    _close_bf16(got, want_pal)
    ref32 = _jax_side(kind, ref, xb, cls32, layer, heads, jnp.float32)
    _no_less_accurate(got, _jax_side(kind, ref, xb, cls32, layer, heads, jnp.bfloat16), ref32)
    got32 = recipe(torch.from_numpy(xb), cls, _port(layer, torch.float32), heads, torch.float32)
    np.testing.assert_allclose(got32.numpy(), ref32, **F32_TOL)
    # the port's plain version, which the kernel is held to on the card
    plain = (tcls.cls_pool_tokens_plain(x, cls, *_port(layer, bf), heads, EPS) if tokens
             else tcls.cls_pool_plain(x, *_port(layer, bf), heads, EPS))
    _no_less_accurate(got, plain.float(), ref32)


@pytest.mark.parametrize("kind", ["K4", "K4b"])
@pytest.mark.parametrize("parts", [2, 3])
def test_recipe_in_parts_is_one_softmax(kind, parts):
    """The softmax statistics taken in row parts and combined (the cluster's
    halves, the streamed chunks) give the one-part result: in f32 to f32
    rounding, in bf16 within the bf16 tolerance (a probability may round to
    its neighbour)."""
    rng = np.random.default_rng(7 + parts)
    d, heads, m = 128, 2, 37
    x32, layer = _r(rng, 2, m, d), _layer(rng, d)
    cls = torch.from_numpy(_r(rng, d, s=0.5)) if kind == "K4" else None
    for dtype, check in ((torch.float32, lambda a, b: np.testing.assert_allclose(
            a, b, rtol=1e-6, atol=1e-6)), (bf, _close_bf16)):
        x = torch.from_numpy(x32).to(dtype)
        one = recipe(x, cls, _port(layer, dtype), heads, dtype)
        split = recipe(x, cls, _port(layer, dtype), heads, dtype, parts=parts)
        check(split.numpy(), one.numpy())


def test_recipe_rounds_p_after_the_whole_softmax():
    """The probabilities are normalised over every column before their one
    bf16 rounding: at a group whose logits spread widely, rounding each part's
    probabilities against that part's own sum (an online softmax that
    rounds before the total is known) moves the output well past the
    tolerance."""
    rng = np.random.default_rng(3)
    d, heads, m = 128, 2, 37
    x = torch.from_numpy(_r(rng, 2, m, d, s=3.0)).to(bf)
    layer = _port(_layer(rng, d), bf)
    layer[2] = layer[2] * 3  # peaked attention
    good = recipe(x, None, layer, heads)
    halves = [recipe(x[:, rows], None, layer, heads) for rows in
              (slice(0, 19), slice(19, m))]
    assert not np.allclose(halves[0].numpy(), good.numpy(), rtol=2.0 ** -7,
                           atol=float(good.abs().max()) * 2.0 ** -8)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", (CSRC / "cls_pool.cu").read_text())
    assert m, f"{name} not found in cls_pool.cu"
    return int(m.group(1))


def test_plan_constants_are_the_kernels():
    assert _constant("MAXH") == _build.CLS_MAXH
    assert _constant("GMAX") == _build.CLS_GMAX
    assert _constant("MAX_SMEM") == _build.MAX_SMEM


@pytest.mark.parametrize("rows,d,heads", [(1, 64, 1), (15, 768, 12), (36, 768, 12),
                                          (98, 768, 12), (112, 768, 12), (96, 768, 16),
                                          (37, 256, 4)])
def test_pool_smem_is_the_kernels(rows, d, heads):
    """_build.cls_pool_smem against csrc/cls_pool.cu::pool_smem's own
    expression, evaluated here."""
    src = (CSRC / "cls_pool.cu").read_text()
    body = re.search(r"inline size_t pool_smem\(int rows, int D, int H\) \{(.*?)\n\}", src,
                     re.S).group(1)
    p_expr = re.search(r"const size_t p = ([^,]+),", body).group(1)
    ret = " ".join(re.search(r"return (.*?);", body, re.S).group(1).replace("(size_t)", "").split())
    env = {"rows": rows, "D": d, "H": heads, "GMAX": _build.CLS_GMAX,
           "MAXH": _build.CLS_MAXH}
    env["p"] = eval(p_expr, {}, env)
    env["t16"] = (rows + 15) // 16 * 16
    assert eval(ret, {}, env) == _build.cls_pool_smem(rows, d, heads)


def _cap(d, heads):
    """The most rows, a multiple of 16, whose pool_smem fits a block."""
    cap = 0
    while _build.cls_pool_smem(cap + 16, d, heads) <= _build.MAX_SMEM:
        cap += 16
    return cap


@pytest.mark.parametrize("b,m,d,heads,shared_u", [
    (896, 196, 768, 12, True), (672, 12, 768, 12, True), (700, 12, 768, 12, True),
    (2, 14, 768, 12, True), (2, 15, 768, 12, False), (224, 197, 768, 12, False),
    (4, 300, 768, 12, True), (4, 1, 768, 12, True), (5000, 3, 768, 16, True),
    (3, 37, 256, 4, False), (64, 2048, 1024, 16, False), (896, 196, 768, 8, True)])
def test_cls_pool_plan(b, m, d, heads, shared_u):
    """The plan fits a block's shared memory, covers every group, packs
    groups only with a shared U and within what a block holds, and splits a
    group over a 2-block cluster only where it is longer than that (then x
    is read once unless a half is longer still, which each block streams in
    passes of the rows it holds)."""
    plan = _build.cls_pool_plan(b, m, d, heads, shared_u)
    cap, g, cl, rows = _cap(d, heads), plan["groups"], plan["cluster"], plan["rows"]
    assert cap >= 16 and _build.cls_pool_smem(rows, d, heads) <= _build.MAX_SMEM
    assert 1 <= rows <= cap and 1 <= g <= _build.CLS_GMAX
    assert plan["blocks"] // cl * g >= b > (plan["blocks"] // cl - 1) * g
    assert g == 1 or (shared_u and g * m <= cap and cl == 1)
    assert cl == (2 if m > cap else 1)
    block_rows = -(-m // 2) if cl == 2 else g * m
    assert rows == min(block_rows, cap)
    assert (block_rows <= rows) == (block_rows <= cap)  # one pass over x where it fits


def test_cls_pool_plan_at_the_main_paths():
    """D = 768, 12 heads: 112 rows a block; the spatial aggregator's 196-row
    groups on 2-block clusters of 98 rows (x read once), K4b's 197 likewise,
    and so the 8-head tower's (8 heads of 96); the frequency aggregator's
    12-row groups three to a block (224 blocks, two an SM); the MoCo step's
    global aggregators one group a block."""
    assert _cap(768, 12) == 112
    for heads in (12, 8):
        spatial = _build.cls_pool_plan(896, 196, 768, heads, True)
        assert (spatial["cluster"], spatial["rows"], spatial["blocks"]) == (2, 98, 1792)
        assert 2 * _build.cls_pool_smem(98, 768, heads) > _build.MAX_SMEM
    freq = _build.cls_pool_plan(672, 12, 768, 12, True)
    assert (freq["groups"], freq["blocks"], freq["rows"]) == (3, 224, 36)
    assert 2 * _build.cls_pool_smem(36, 768, 12) <= _build.MAX_SMEM
    assert _build.cls_pool_plan(224, 197, 768, 12, False)["rows"] == 99
    for b, m, shared in ((2, 14, True), (2, 15, False)):
        plan = _build.cls_pool_plan(b, m, 768, 12, shared)
        assert plan["groups"] == 1 and plan["cluster"] == 1


def test_cls_pool_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError):
        _build.cls_pool_plan(2, 16, 4096, 16, True)


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


def _wrapper_args(d=128, heads=2, bsz=3, m=5, hidden=None):
    hidden = hidden or 4 * d
    x = torch.zeros(bsz, m, d, dtype=bf)
    layer = [torch.ones(d), torch.zeros(d), torch.zeros(3 * d, d, dtype=bf), torch.zeros(3 * d),
             torch.zeros(d, d, dtype=bf), torch.zeros(d), torch.ones(d), torch.zeros(d),
             torch.zeros(hidden, d, dtype=bf), torch.zeros(hidden),
             torch.zeros(d, hidden, dtype=bf), torch.zeros(d)]
    return x, layer, heads


@pytest.mark.parametrize("kind", ["K4", "K4b"])
@pytest.mark.parametrize("fault", [None, "d_ragged", "hidden_ragged", "heads_17", "x_f32",
                                   "x_strided", "wqkv_f32", "wp_shape", "bias_bf16"])
def test_wrappers_check_before_launch(as_if_on_card, kind, fault):
    x, layer, heads = _wrapper_args()
    if fault == "d_ragged":
        x, layer, heads = _wrapper_args(d=160)
    elif fault == "hidden_ragged":  # not 16-byte rows (hidden % 8 == 0 runs since the GEMM's tails)
        x, layer, heads = _wrapper_args(hidden=548)
    elif fault == "heads_17":
        x, layer, heads = _wrapper_args(d=17 * 64, heads=17)
    elif fault == "x_f32":
        x = x.float()
    elif fault == "x_strided":
        x = torch.zeros(3, 5, 2 * 128, dtype=bf)[..., ::2]
    elif fault == "wqkv_f32":
        layer[2] = layer[2].float()
    elif fault == "wp_shape":
        layer[4] = torch.zeros(128, 64, dtype=bf)
    elif fault == "bias_bf16":
        layer[3] = layer[3].to(bf)
    with pytest.raises(_Launched if fault is None else ValueError):
        if kind == "K4":
            tcls._cls_pool_tokens(x, torch.zeros(x.shape[-1]), *layer, heads, EPS)
        else:
            tcls._cls_pool(x, *layer, heads, EPS)
