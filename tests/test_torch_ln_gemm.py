"""The LayerNorm-fed products of the Hopper GEMM (csrc/wgmma_gemm.cuh) and
the three-launch K8b on the CPU, against the JAX package's Pallas kernels in
interpret mode. The kernels run only on the card (chip_smoke.py phase 2);
here a torch emulation of their recipe stands in for them:
- LN + GEMM (K8a's QKV, K8c): the LayerNorm of csrc/tile_gemm.cuh::ln_rows
  (f32 mean and E[x^2], rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps), (x -
  mean) * rstd * g + b per element in f32 rounded to bf16 once), then f32
  sums in 64-deep k-steps, the bias in f32, one rounding;
- EPI_BIAS_GELU_POLY: the TPU kernels' clamped degree-9 erf polynomial GELU
  in f32, rounded once (K8b's fc1);
- K8b: LN, fc1 with that GELU into a bf16 activation, fc2 with bf16(x +
  bf16(acc + b2)); K2 the same with the exact erf GELU.
Then the launch plan of the GEMM with its 64-wide last column tile and K %
32, its constants against the CUDA sources, and the shapes K8a, K8b and
K8c's wrappers take and refuse before any launch (and K1's and K2's D =
192).

Tolerances: in bf16, 2^-7 relative plus 2^-8 of the output's largest value:
two bf16 roundings (2^-8 relative each), for f32 sums taken in another order
that may round to the neighbouring bf16 value, and for the port's plain
versions, which round the product before the bias; the emulation in f32
against the Pallas kernel in f32, rtol = atol = 1e-5; the GELU polynomial
against _gelu_kernel_f32, rtol 1e-6, atol 1e-7 (the same f32 Horner steps,
fused multiply-adds included).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from synchformer_tpu.ops.pallas import fused_block as jfb
from synchformer_tpu.ops.pallas import fused_rows as jfr
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels import divided_attention as tda
from synchformer_tpu_torch.ops.kernels import fused_block as tfb
from synchformer_tpu_torch.ops.kernels import fused_rows as tfr
from synchformer_tpu_torch.ops.kernels.gemm import gelu_poly, gemm
from synchformer_tpu_torch.ops.numerics import exact_gelu_f32

torch.set_num_threads(2)

CSRC = _build.CSRC
bf = torch.bfloat16
EPS = 1e-6
BF16_TOL = dict(rtol=2.0 ** -7)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _r(rng, *shape, s=1.0, mean=0.0):
    return (mean + s * rng.standard_normal(shape)).astype(np.float32)


def _bf(a):
    """numpy f32 -> (bf16 torch tensor, the same values as a bf16 jax array)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(bf)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _close_bf16(got, want):
    got, want = (np.asarray(t, np.float32) for t in (got, want))
    atol = np.abs(want).max() * 2.0 ** -8
    np.testing.assert_allclose(got, want, atol=atol, **BF16_TOL)


def ln_rows_emulated(x, g, b, eps=EPS, dtype=bf):
    """ln_rows on x (rows, K): f32 mean and E[x^2], rstd = rsqrt(max(E[x^2]
    - mean^2, 0) + eps), (x - mean) * rstd * g + b in f32, rounded to
    ``dtype`` once."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt(torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
                       + eps)
    return ((x32 - mean) * rstd * g + b).to(dtype)


def ln_gemm_emulated(x, g, b, w, bias, eps=EPS, epilogue="bias", residual=None,
                     dtype=bf):
    """LN + GEMM on x (rows, K) and w (N, K): ln_rows, f32 sums over 64-deep
    k-steps, the bias in f32, the epilogue, one rounding (two with the
    residual: bf16(R + bf16(acc + bias)))."""
    a = ln_rows_emulated(x, g, b, eps, dtype)
    acc = torch.zeros(x.shape[0], w.shape[0])
    for k0 in range(0, x.shape[1], 64):
        acc += a[:, k0:k0 + 64].float() @ w[:, k0:k0 + 64].float().t()
    y = acc + bias
    if epilogue == "gelu_poly":
        y = gelu_poly(y)
    if epilogue == "gelu":
        y = exact_gelu_f32(y)
    if epilogue == "residual":
        return (residual.float() + y.to(dtype).float()).to(dtype)
    return y.to(dtype)


def ln_mlp_emulated(x, g, b, w1, b1, w2, b2, eps=EPS, dtype=bf, gelu="gelu_poly"):
    """K8b's three launches: LN, fc1 with the polynomial GELU into an
    activation of x's dtype, fc2 with the residual; with ``gelu`` = "gelu",
    K2's (the exact erf GELU)."""
    rows = x.reshape(-1, x.shape[-1])
    h = ln_gemm_emulated(rows, g, b, w1, b1, eps, gelu, dtype=dtype)
    acc = torch.zeros(rows.shape[0], w2.shape[0])
    for k0 in range(0, h.shape[1], 64):
        acc += h[:, k0:k0 + 64].float() @ w2[:, k0:k0 + 64].float().t()
    y = (acc + b2).to(dtype)
    return (rows.float() + y.float()).to(dtype).reshape(x.shape)


@pytest.mark.parametrize("d", [96, 256])
def test_ln_gemm_recipe_against_the_pallas_kernel(d):
    """K8c's TPU kernel (_ln_matmul_pallas, interpret mode) and the port's
    plain LN + QKV (_qkv_plain) against the emulated LN + GEMM, at d = 96
    (K % 64 == 32: a half-empty last k-step) and 256, N = 192 (a 64-wide
    last column tile), in bf16 and in f32."""
    rng = np.random.default_rng(21 + d)
    n, rows = 192, 48
    x32, g, b = _r(rng, rows, d, s=2.0, mean=0.5), 1 + _r(rng, d, s=0.1), _r(rng, d, s=0.1)
    w32, bias = _r(rng, n, d, s=d ** -0.5), _r(rng, n, s=0.1)
    (x, xj), (w, wj) = _bf(x32), _bf(w32)
    tg, tb, tbias = (torch.from_numpy(t) for t in (g, b, bias))
    got = ln_gemm_emulated(x, tg, tb, w, tbias)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda *a: jfr._ln_matmul_pallas(*a, EPS))(xj, g, b, wj.T, bias)
        want32 = jax.jit(lambda *a: jfr._ln_matmul_pallas(*a, EPS))(x32, g, b, w32.T, bias)
    _close_bf16(got.float(), np.asarray(want.astype(jnp.float32)))
    _close_bf16(got.float(), tfb._qkv_plain(x, tg, tb, w, tbias, EPS).float())
    got32 = ln_gemm_emulated(torch.from_numpy(x32), tg, tb, torch.from_numpy(w32), tbias,
                             dtype=torch.float32)
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32), **F32_TOL)
    # the GEMM entry's plain version on the LN output is this recipe with
    # the sums in one product
    _close_bf16(gemm(ln_rows_emulated(x, tg, tb), w, tbias).float(), got.float())


def test_gelu_poly_is_the_tpu_kernels():
    """EPI_BIAS_GELU_POLY's GELU: the torch emulation against
    _gelu_kernel_f32 over the clamp's range and past it, and the CUDA
    device function's coefficients against the JAX package's."""
    x = np.concatenate([np.linspace(-7, 7, 2801, dtype=np.float32),
                        _r(np.random.default_rng(3), 4096, s=3.0)])
    got = gelu_poly(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jfb._gelu_kernel_f32)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    body = re.search(r"float gelu_poly\(float x\) \{(.*?)\n\}",
                     (CSRC / "tile_gemm.cuh").read_text(), re.S).group(1)
    coeffs = [float(c) for c in re.findall(r"([-\d.e]+)f;", body)]
    assert coeffs == list(jfb._ERF_POLY[::-1])


@pytest.mark.parametrize("rows", [18, 64])
@pytest.mark.parametrize("kernel", ["K8b", "K2"])
def test_ln_mlp_pipeline_against_the_pallas_kernel(kernel, rows):
    """The launches of csrc/ln_mlp.cu's shared entry, emulated: K8b's against
    _fused_mlp_pallas (interpret mode) at D = 256, hidden 1024, a width the
    one-launch kernel refused; K2's (the exact GELU) against _ln_mlp_pallas
    (whose GELU is the polynomial, within 3e-5 of erf) at D = 128, hidden
    512; each also against the port's plain version (exact GELU, the product
    rounded before the bias) within the same tolerance."""
    d, h = (256, 1024) if kernel == "K8b" else (128, 512)
    rng = np.random.default_rng((31 if kernel == "K8b" else 41) + rows)
    x32, g, b = _r(rng, 2, rows // 2, d, s=2.0, mean=0.5), 1 + _r(rng, d, s=0.1), _r(rng, d, s=0.1)
    w1_32, b1 = _r(rng, h, d, s=d ** -0.5), _r(rng, h, s=0.1)
    w2_32, b2 = _r(rng, d, h, s=h ** -0.5), _r(rng, d, s=0.1)
    (x, xj), (w1, w1j), (w2, w2j) = _bf(x32), _bf(w1_32), _bf(w2_32)
    tg, tb, tb1, tb2 = (torch.from_numpy(t) for t in (g, b, b1, b2))
    got = ln_mlp_emulated(x, tg, tb, w1, tb1, w2, tb2,
                       gelu="gelu_poly" if kernel == "K8b" else "gelu")
    pallas = jfb._fused_mlp_pallas if kernel == "K8b" else jfr._ln_mlp_pallas
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda *a: pallas(*a, EPS))(xj, g, b, w1j.T, b1, w2j.T, b2)
    _close_bf16(got.float(), np.asarray(want.astype(jnp.float32)))
    _close_bf16(got.float(), tfr.ln_mlp_residual_plain(x, tg, tb, w1, tb1, w2, tb2,
                                                       EPS).float())


def _constant(source: str, pattern: str) -> int:
    m = re.search(pattern, (CSRC / source).read_text())
    assert m, f"{pattern} not found in {source}"
    return int(m.group(1))


def test_gemm_quanta_are_the_kernels():
    """The plan's quanta are the GEMM's own: A's and W's row strides a
    multiple of 8 (TMA), the tail epilogue where N % 128 != 0; K2's and K8b's
    entry picks the polynomial GELU's epilogue, whose enum value gemm.py
    names."""
    assert _constant("wgmma_gemm.cuh", r"lda % (\d+) != 0") == _build.WGMMA_LD_QUANTUM
    assert _constant("wgmma_gemm.cuh", r"ldw % (\d+) != 0") == _build.WGMMA_LD_QUANTUM
    assert _constant("wgmma_gemm.cuh", r"N % (\d+) != 0") == _build.WGMMA_TAIL_N
    assert _constant("tile_gemm.cuh", r"EPI_BIAS_GELU_POLY = (\d+)") == 3
    assert "wgmma_gemm_strided<sft::EPI_BIAS_GELU_POLY>" in (CSRC / "ln_mlp.cu").read_text()


@pytest.mark.parametrize("m", [1, 129, 175728])
@pytest.mark.parametrize("n", [192, 576, 2304, 3072])
@pytest.mark.parametrize("epilogue", ["bias", "gelu_poly"])
def test_gemm_plan_ragged_n_covers_every_tile_once(m, n, epilogue):
    """The plan at K8a's, K8b's and K8c's N and at N % 128 == 64: every
    output tile walked once by one consumer (ping-pong) or by both
    (cooperative: the polynomial GELU at N % 256 == 0), the tiles cover n,
    and where n % 128 == 64 the last column tile is 64 wide, the one the
    kernel's epilogue halves."""
    plan = _build.gemm_plan(m, n, 96, epilogue, sms=132)
    cooperative = epilogue == "gelu_poly" and n % 256 == 0
    assert plan["schedule"] == ("cooperative" if cooperative else "ping-pong")
    bn = plan["bn"]
    assert plan["tiles_n"] * bn - n == (64 if n % bn else 0)
    assert plan["tiles_m"] * _build.WGMMA_BM >= m > (plan["tiles_m"] - 1) * _build.WGMMA_BM
    seen = [t for blk in range(plan["grid"]) for c in (0, 1)
            for t in _build.gemm_block_tiles(plan, blk, c)]
    tiles = plan["tiles_m"] * plan["tiles_n"]
    assert len(seen) == tiles * (2 if cooperative else 1)
    assert set(seen) == {(i, j) for i in range(plan["tiles_m"]) for j in range(plan["tiles_n"])}


@pytest.mark.parametrize("m,n,k,ok", [
    (128, 768, 96, True), (128, 768, 32, True), (128, 768, 800, True), (128, 768, 16, True),
    (128, 768, 48, True), (128, 96, 768, True), (0, 768, 768, False),
    (2 ** 31 - 1, 64, 768, True), (128, 1996, 1000, True), (128, 768, 1996, True),
    (2 ** 31, 64, 768, False)])
def test_gemm_plan_k_quantum(m, n, k, ok):
    """Any K (TMA fills a half-empty last k-step with zeros: K8c's d = 96,
    fc2 over hidden 1996), any N (the tail epilogue where N % 128 != 0), 1 to
    2^31 - 1 rows."""
    if ok:
        plan = _build.gemm_plan(m, n, k)
        assert plan["tail"] == (n % _build.WGMMA_TAIL_N != 0)
    else:
        with pytest.raises(ValueError):
            _build.gemm_plan(m, n, k)


class _Launched(Exception):
    pass


@pytest.fixture
def as_if_on_card(monkeypatch):
    """The wrappers' kernel route on CPU (or meta) tensors, with the library
    load replaced by a sentinel: a call that passes every check raises
    _Launched, one that fails a check raises ValueError before it."""
    monkeypatch.setattr(_build, "use_kernel", lambda x, impl: impl == "kernel")

    def library(*args, **kwargs):
        raise _Launched

    monkeypatch.setattr(_build, "library", library)


def _k8b_args(d, hidden, device="cpu"):
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device=device)  # noqa: E731
    return [z(2, 9, d, dt=bf), z(d) + 1, z(d), z(hidden, d, dt=bf), z(hidden),
            z(d, hidden, dt=bf), z(d)]


@pytest.mark.parametrize("d,hidden,ok", [(768, 3072, True), (256, 1024, True),
                                         (512, 2048, True), (192, 768, True),
                                         (160, 640, True), (256, 1056, True),
                                         (768, 1996, True), (164, 656, False)])
def test_k8b_checks_before_launch(as_if_on_card, d, hidden, ok):
    """K8b takes any hidden and any D whose rows are 16 bytes (D % 8; it
    refused D != 768, then D or hidden % 64 != 0, before) and refuses the
    others before any launch."""
    with pytest.raises(_Launched if ok else ValueError):
        tfb._fused_mlp(*_k8b_args(d, hidden), EPS)


def test_k8b_refuses_misaligned_x(as_if_on_card):
    args = _k8b_args(256, 1024)
    args[0] = torch.zeros(2 * 9 * 256 + 1, dtype=bf)[1:].view(2, 9, 256)
    with pytest.raises(ValueError):
        tfb._fused_mlp(*args, EPS)


@pytest.mark.parametrize("bsz,d,heads,ok", [(2675, 64, 1, True), (2, 768, 8, True),
                                            (2, 96, 1, True), (2, 1280, 16, True),
                                            (2, 100, 1, False)])
def test_k8a_checks_before_launch(as_if_on_card, bsz, d, heads, ok):
    """K8a takes rows past the tile GEMM's 65535 x 64 (2675 segments of 1 +
    8 x 196 tokens: 4,197,075 rows, on meta tensors) and any head_dim that
    is a multiple of 8 (D = 96 at one head, which it refused while the GEMM
    took 3D % 64 only; 16 heads of 80); it refuses head_dim 100 before any
    launch."""
    assert bsz * 1569 > 65535 * 64 or bsz == 2
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")  # noqa: E731
    args = [z(bsz, 1569, d, dt=bf), z(d), z(d), z(3 * d, d, dt=bf), z(3 * d), heads, 8, "space",
            EPS]
    with pytest.raises(_Launched if ok else ValueError):
        tfb._fused_attention(*args)


@pytest.mark.parametrize("d,n_out,ok", [(96, 288 + 96, True), (96, 192, True), (32, 64, True),
                                        (80, 192, True), (96, 96, True), (1000, 1996, True),
                                        (84, 192, False)])
def test_k8c_checks_before_launch(as_if_on_card, d, n_out, ok):
    """K8c takes any out and any d whose rows are 16 bytes (it took d % 32
    and out % 64 only before) and refuses d = 84 before any launch."""
    args = [torch.zeros(40, d, dtype=bf), torch.ones(d), torch.zeros(d),
            torch.zeros(n_out, d, dtype=bf), torch.zeros(n_out)]
    with pytest.raises(_Launched if ok else ValueError):
        tfr._ln_matmul(*args, EPS)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_k1_k2_take_d_multiple_of_64(as_if_on_card, kernel):
    """With the GEMM's 64-wide last column tile K1 and K2 take D = 192 (3
    heads of 64; K2 hidden 768), which the 128-column GEMM refused."""
    d, f, n = 192, 8, 49
    if kernel == "K1":
        args = [torch.zeros(1, f, n, 3 * d, dtype=bf), torch.zeros(1, 1, 3 * d, dtype=bf),
                torch.zeros(1, f, n, d, dtype=bf), torch.zeros(d, d, dtype=bf), torch.zeros(d),
                3, "space"]
        call = tda._divided_attention_proj
    else:
        args = [torch.zeros(2, f, n, d, dtype=bf), torch.ones(d), torch.zeros(d),
                torch.zeros(4 * d, d, dtype=bf), torch.zeros(4 * d),
                torch.zeros(d, 4 * d, dtype=bf), torch.zeros(d), EPS, False]
        call = tfr._ln_mlp
    with pytest.raises(_Launched):
        call(*args)
