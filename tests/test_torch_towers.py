"""The port's two towers against the JAX package's on the CPU, in f32 with
converted parameters (helpers and tolerances: tests/test_torch_models.py).

- ASTEncoder at the real mel geometry (128 x 66 -> 12 x 6 patches + 2 aux
  tokens), on the plain route and the kernel route (K3 + K2, then K4).
- MotionFormerEncoder on 5-D patch-major input: the port runs the split
  (CLS, patches) flow with the LN-statistics chain on both routes; it is held
  against the JAX tower's packed XLA flow, and the kernel route also against
  the JAX tower's own split flow (K1, K2 with stats, K4) in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_models import (
    D,
    HEADS,
    JAX_AUD,
    JAX_VIS,
    N_PATCH,
    PALLAS,
    PATCH_K,
    close,
    jit_apply,
    randomize,
)

from synchformer_tpu_torch.models.ast_encoder import ASTEncoder
from synchformer_tpu_torch.models.motionformer import MotionFormerEncoder
from synchformer_tpu_torch.models.presets import TINY
from synchformer_tpu_torch.utils import convert

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ast_case():
    from synchformer_tpu.models.ast_encoder import ASTEncoder as JAST

    x = np.random.default_rng(0).standard_normal((1, 2, 66, 128)).astype(np.float32)
    jmod = JAST(**JAX_AUD)
    params = randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want, _ = jit_apply(jmod)(params, jnp.asarray(x))
    mod = ASTEncoder(hidden_size=D, depth=TINY["depth"], num_heads=HEADS)
    convert.load_numpy_state_dict(mod, convert.ast_sd(params["params"]))
    return x, np.asarray(want), mod


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_ast_encoder_matches_jax(ast_case, impl):
    x, want, mod = ast_case
    got = mod(torch.from_numpy(x), impl)
    assert got.shape == (1, 2, 6, D)
    close(got, want)


@pytest.fixture(scope="module")
def motionformer_case():
    from synchformer_tpu.models.motionformer import MotionFormerEncoder as JMF

    x = np.random.default_rng(0).standard_normal(
        (1, 2, TINY["temporal_resolution"], N_PATCH, PATCH_K)).astype(np.float32)
    jmod = JMF(**JAX_VIS)
    params = randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    mod = MotionFormerEncoder(embed_dim=D, depth=TINY["depth"], num_heads=HEADS,
                              patch_size=TINY["patch_size"],
                              temporal_resolution=TINY["temporal_resolution"],
                              img_size=TINY["img_size"])
    convert.load_numpy_state_dict(mod, convert.motionformer_sd(params["params"]))
    want, _ = jit_apply(jmod)(params, jnp.asarray(x))
    return x, params, mod, np.asarray(want)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_motionformer_matches_jax(motionformer_case, impl):
    """Split flow with the LN-statistics chain against the JAX tower's packed
    XLA flow."""
    x, _, mod, want = motionformer_case
    got = mod(torch.from_numpy(x), impl)
    assert got.shape == (1, 2, TINY["temporal_resolution"], D)
    close(got, want)


def test_motionformer_matches_jax_pallas_split_flow(motionformer_case):
    """Against the JAX tower's own split flow (K1 + K2 with stats, K4) in
    interpret mode."""
    from synchformer_tpu.models.motionformer import MotionFormerEncoder as JMF

    x, params, mod, _ = motionformer_case
    with pltpu.force_tpu_interpret_mode():
        want, _ = jit_apply(JMF(**JAX_VIS, attn_impl="pallas"))(params, jnp.asarray(x))
    close(mod(torch.from_numpy(x), "kernel"), want, PALLAS)
