"""The two attentions that run on the tensor cores on the card (K3 and the
divided attention's space pass) at the ragged shapes chip_smoke.py holds the
kernels to, against the JAX package on the CPU, where every kernel wrapper
runs its plain PyTorch version.

- K3 at 17 and 197 tokens (16-row tiles leave a ragged last tile; 197 also
  spans three 80-key chunks on the card) against standard_attention_ref and
  the Pallas kernel in interpret mode;
- the space pass at 49 patches a frame for every head_dim the kernels take,
  on the packed layout, against the XLA composition and
  divided_attention_pallas in interpret mode (v1 body at non-groupable heads,
  v3 at groupable);
- chip_smoke.py's guard-band inputs: a prefix of a NaN-filled buffer, the
  same values, contiguous;
- the space kernel's softmax recipe (the TPU kernels'), emulated: no bias
  and no larger error than the plain versions' normalise-then-round.

Tolerances, as tests/test_torch_kernels.py and test_torch_packed.py: rtol =
atol = 1e-5 against the XLA compositions (the same math, f32 sums in another
order); rtol 2e-4 / atol 3e-5 against the Pallas kernels (their
unnormalised-softmax order).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_packed import jax_packed_xla

from synchformer_tpu.ops.pallas import standard_attention as jstd
from synchformer_tpu.ops.pallas.divided_attention import divided_attention_pallas
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.kernels.divided_attention import divided_attention_packed
from synchformer_tpu_torch.ops.kernels.standard_attention import standard_attention

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

# the head_dims the kernels run at their own width (the widths up to 128)
HEAD_DIMS = _build.ATTN_WIDTHS[:4]

REF = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(rtol=2e-4, atol=3e-5)


def _r(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **tol)


@pytest.mark.parametrize("n", [17, 197])
def test_standard_attention_ragged_matches_jax(n):
    rng = np.random.default_rng(n)
    heads = 2
    qkv = _r(rng, 2, n, 3 * heads * 64)
    _build.launches.clear()
    got = standard_attention(torch.from_numpy(qkv), heads)
    assert sum(_build.launches.values()) == 0
    _close(got, jstd.standard_attention_ref(jnp.asarray(qkv), heads), REF)
    with pltpu.force_tpu_interpret_mode():
        pal = jax.jit(jstd._standard_attention_pallas, static_argnums=(1,))(
            jnp.asarray(qkv), heads)
    _close(got, pal, PALLAS)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_space_ragged_matches_jax(dh):
    rng = np.random.default_rng(dh)
    heads, frames, n = 2, 2, 49
    qkv = _r(rng, 2, 1 + frames * n, 3 * heads * dh)
    got = divided_attention_packed(torch.from_numpy(qkv), heads, frames, "space")
    _close(got, jax_packed_xla(jnp.asarray(qkv), heads, frames, "space"), REF)
    with pltpu.force_tpu_interpret_mode():
        pal = jax.jit(divided_attention_pallas, static_argnums=(1, 2, 3))(
            jnp.asarray(qkv), heads, frames, "space")
    _close(got, pal, PALLAS)


def test_guard_band_input_is_a_prefix_of_a_nan_buffer():
    t = torch.randn(3, 5, 12)
    g = chip_smoke.guarded(torch, t)
    assert g.is_contiguous() and torch.equal(g, t)
    tail = g.untyped_storage()
    full = torch.empty(0).set_(tail, 0, (tail.nbytes() // 4,))
    assert full.numel() == t.numel() + chip_smoke.GUARD_ROWS * 12
    assert bool(full[t.numel():].isnan().all())


@pytest.mark.parametrize("logit_std", [0.02, 0.3, 2.0])
def test_space_recipe_has_no_bias(logit_std):
    """The space kernel's recipe, emulated in f32 with bf16 rounding (exp(s -
    m) rounded to bf16 unnormalised for P V, the CLS key's term in f32, one
    division by the f32 sum), against the f32 softmax at 4096 rows of 197
    keys: no bias (mean error below 1e-5 of values of std 0.5) and an rms
    error no larger than the normalise-then-round recipe's (the plain
    versions', and the kernel's before the tensor cores) plus 5%."""
    g = torch.Generator().manual_seed(0)
    s = torch.randn(4096, 197, generator=g) * logit_std  # key 0: the CLS row
    v = (torch.randn(197, 64, generator=g) * 0.5 + 0.1).to(torch.bfloat16).float()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    ref = (e / e.sum(-1, keepdim=True)) @ v
    rounded = e[:, 1:].to(torch.bfloat16).float()
    tpu = (rounded @ v[1:] + e[:, :1] * v[:1]) / e.sum(-1, keepdim=True)
    normalised = (e / e.sum(-1, keepdim=True)).to(torch.bfloat16).float() @ v
    assert abs(float((tpu - ref).mean())) < 1e-5
    rms = [float((o - ref).pow(2).mean().sqrt()) for o in (tpu, normalised)]
    assert rms[0] <= 1.05 * rms[1], rms
