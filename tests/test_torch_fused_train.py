"""The tiny packed-flow AVCLIP (presets.TINY_PACKED: video tower 2 heads of
96, drop-path 0) on attn_impl='pallas_fused' against the JAX AVCLIP and
make_avclip_train_step with attn_impl='pallas_fused' on both towers, their
Pallas kernels in interpret mode (the video tower's K8a, K8b and K7c; the
AST's K2 / K3 / K4), on the CPU, where the port's kernel wrappers run their
plain versions.

Tolerances: tests/test_torch_train.py's check_* helpers and bounds (loss
rtol 1e-5, each gradient within 2e-5 of its tensor's largest, parameters
after AdamW within 2e-6 where the clipped gradient exceeds 1e-5). They hold
against the Pallas forward although its GELU is the degree-9 erf polynomial
(|err| <= 3e-5 on the erf; here it moves the loss and gradients by less than
half those bounds).
"""
import functools

import pytest
from test_torch_train import (
    check_eval_step,
    check_loss_and_grads,
    check_remat,
    check_train_step,
    make_case,
)

from synchformer_tpu_torch.models.presets import TINY_PACKED, build_tiny_avclip_packed


@pytest.fixture(scope="module")
def case():
    return make_case(TINY_PACKED,
                     functools.partial(build_tiny_avclip_packed, attn_impl="pallas_fused"),
                     "pallas_fused")


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_fused_avclip_loss_and_grads_match_jax(case, impl):
    """Loss, every gradient and the global norm against jax.value_and_grad of
    the JAX AVCLIP on 'pallas_fused' (K8a forward, K7c under its VJP)."""
    check_loss_and_grads(case, impl)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_fused_avclip_train_step_matches_jax(case, impl):
    """Parameters and metrics after one avclip_train_step against
    make_avclip_train_step."""
    check_train_step(case, impl)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_fused_avclip_eval_step_matches_jax(case, impl):
    """The eval step (K8a, K8b on the packed x, K3, K4 on impl='kernel')."""
    check_eval_step(case, impl)


def test_fused_avclip_remat_grads_equal_plain_grads(case):
    """remat=True recomputes FusedDividedAttentionFn's and FusedMlpFn's
    forwards under torch.utils.checkpoint and gives the same gradients."""
    check_remat(case)
