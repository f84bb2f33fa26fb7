"""The port's whole sync-inference slice against the JAX package on the CPU.

A tiny Synchformer (presets.TINY: D=256, 4 heads of 64, depth 2, 32 px
frames, the real 128 x 66 mel geometry, S=2) gets the JAX model's
parameters through state_dict_from_jax. Both sides take the same uint8
patch-major frames and PCM: JAX as bench.py's ``infer`` composes it
(fold_video_normalize on the params, log-mel, model.apply, f32 softmax), the
port through SyncPredictor, which folds the normalisation into its own
weights. Everything in f32. Tolerance atol = 1e-4 on logits and
probabilities: the log-mel front ends differ by up to 2e-4 absolute (f32 DFT
sums in another order, tests/test_torch_models.py::test_log_mel_matches_jax)
and the towers pass that on, damped (seen: 1.9e-6 on logits, 2.2e-7 on
probabilities).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import D, JAX_AUD, JAX_VIS, jax_gt_cfg, randomize

from synchformer_tpu_torch.infer import SyncPredictor
from synchformer_tpu_torch.models.presets import TINY, build_tiny_synchformer
from synchformer_tpu_torch.ops.kernels import _build
from synchformer_tpu_torch.ops.video import patchify_frames
from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, state_dict_from_jax

torch.set_num_threads(2)

B, S = 2, 2
SLICE_TOL = dict(rtol=0, atol=1e-4)


def jax_tiny_synchformer(n_segments: int):
    from synchformer_tpu.models.sync_model import Synchformer

    lin = dict(target="torch.nn.Linear", params=dict(in_features=D, out_features=D))
    return Synchformer(
        afeat_extractor=dict(target="synchformer_tpu.models.ast_encoder.ASTEncoder",
                             params=JAX_AUD),
        vfeat_extractor=dict(target="synchformer_tpu.models.motionformer.MotionFormerEncoder",
                             params=JAX_VIS),
        aproj=lin, vproj=lin,
        transformer=dict(target="synchformer_tpu.models.sync_model.GlobalTransformer",
                         params=jax_gt_cfg(n_segments)))


def jax_tiny_params(n_segments: int):
    """Randomised params of the tiny JAX Synchformer (numpy leaves)."""
    vis = jnp.zeros((1, n_segments, TINY["temporal_resolution"],
                     (TINY["img_size"] // TINY["patch_size"]) ** 2,
                     2 * TINY["patch_size"] ** 2 * 3))
    aud = jnp.zeros((1, n_segments, 66, 128))
    model = jax_tiny_synchformer(n_segments)
    return model, randomize(jax.jit(model.init)(jax.random.PRNGKey(0), vis, aud))


@pytest.fixture(scope="module")
def slice_case():
    from synchformer_tpu.ops.mel import log_mel_spectrogram
    from synchformer_tpu.ops.video import fold_video_normalize

    model, params = jax_tiny_params(S)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (B, S, 2 * TINY["temporal_resolution"], TINY["img_size"],
                                   TINY["img_size"], 3), dtype=np.uint8)
    video = patchify_frames(frames, 2, TINY["patch_size"])
    pcm = (rng.standard_normal((B, S, 10240)) * 0.1).astype(np.float32)

    @jax.jit
    def infer(params, video_u8_patches, pcm):
        mel = log_mel_spectrogram(pcm)
        aud = jnp.swapaxes(mel, -1, -2)
        _, logits = model.apply(params, video_u8_patches, aud)
        return logits, jax.nn.softmax(logits.astype(jnp.float32), -1)

    logits, probs = infer(fold_video_normalize(params), jnp.asarray(video), jnp.asarray(pcm))
    return params, video, pcm, np.asarray(logits), np.asarray(probs)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_sync_predictor_matches_jax_infer(slice_case, impl):
    """SyncPredictor on the CPU (impl='kernel' runs each wrapper's plain
    version there and launches nothing) against the JAX infer."""
    params, video, pcm, want_logits, want_probs = slice_case
    model = build_tiny_synchformer(S)
    load_numpy_state_dict(model, state_dict_from_jax(params))
    pred = SyncPredictor(model, "cpu", torch.float32, impl)
    _build.launches.clear()
    video_t, pcm_t = torch.from_numpy(np.ascontiguousarray(video)), torch.from_numpy(pcm)
    logits = pred.logits(video_t, pcm_t)
    probs = pred(video_t, pcm_t)
    assert sum(_build.launches.values()) == 0
    assert logits.shape == probs.shape == (B, 21)
    np.testing.assert_allclose(logits.numpy(), want_logits, **SLICE_TOL)
    np.testing.assert_allclose(probs.numpy(), want_probs, **SLICE_TOL)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)
