"""The legacy SparseSync slice as a whole against the JAX package on the CPU:
one legacy Synchformer (S3D + ResNet-18 towers, their spatial and frequency
CLS-pool aggregators, projections 1024 / 512 -> 64, a 2-layer
GlobalTransformer of 4 heads) from presets.legacy_sync_model's config
through the port's registry and through the JAX registry.

The JAX variable tree (params and batch_stats) comes from
jax.eval_shape(model.init, ...), filled from a numpy seed
(test_torch_legacy_parts.fill: He-scale convs, non-trivial running
statistics) and converted to the port by convert.state_dict_from_jax, so
JAX compiles one apply and no init. Frames (1, 2, 16, 64, 64, 3) give a (2,
2, 2) map per segment; log-mel (1, 2, 66, 128) a (4, 3) one. Both routes of
the port (on CPU tensors the kernel route runs the plain versions); the
logits within 1e-5 of their largest magnitude. Then SyncPredictor's frames
path on such a model, and its refusal to train.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_legacy_parts import jax_vars, rand, t
from test_torch_models import jit_apply

from synchformer_tpu_torch.models.presets import legacy_sync_model
from synchformer_tpu_torch.models.resnet_audio import ResNet18AudioFeatures
from synchformer_tpu_torch.models.s3d import S3DVisualFeatures
from synchformer_tpu_torch.models.sync_model import Synchformer
from synchformer_tpu_torch.registry import instantiate_from_config
from synchformer_tpu_torch.utils import convert

WIDTHS = {"d": 64, "n_layer": 2, "n_head": 4}


def test_legacy_synchformer_matches_jax():
    from synchformer_tpu.models.sync_model import Synchformer as JSynchformer

    cfg = legacy_sync_model(2, **WIDTHS)
    vis, aud = rand((1, 2, 16, 64, 64, 3), 1), rand((1, 2, 66, 128), 2)
    jmod = JSynchformer(**cfg["params"])
    variables = jax_vars(jmod, jnp.asarray(vis), jnp.asarray(aud))
    _, want = jit_apply(jmod)(variables, jnp.asarray(vis), jnp.asarray(aud))
    want = np.asarray(want)
    assert want.shape == (1, 21)

    model = instantiate_from_config(cfg)
    assert isinstance(model, Synchformer)
    assert isinstance(model.vfeat_extractor, S3DVisualFeatures)
    assert isinstance(model.afeat_extractor, ResNet18AudioFeatures)
    convert.load_numpy_state_dict(model, convert.state_dict_from_jax(variables))
    scale = float(np.abs(want).max())
    for impl in ("plain", "kernel"):
        with torch.no_grad():
            loss, got = model(t(vis), t(aud), impl=impl)
        assert loss is None
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)


def test_sync_predictor_feeds_s3d_normalised_frames():
    """SyncPredictor on a legacy model takes uint8 frames and normalises
    them on the device as the Motionformer's folded patch embed does
    ((x / 255 - 0.5) / 0.5): its logits equal the model's on frames
    normalised by hand; training raises, naming the ROADMAP item."""
    from synchformer_tpu_torch.infer import SyncPredictor
    from synchformer_tpu_torch.ops.mel import MelSpectrogramConfig, log_mel_spectrogram

    model = instantiate_from_config(legacy_sync_model(2, **WIDTHS))
    convert.load_numpy_state_dict(model, convert.seeded_state_dict(model, seed=0))
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.integers(0, 256, (1, 2, 16, 64, 64, 3), dtype=np.uint8))
    pcm = torch.from_numpy((rng.standard_normal((1, 2, 10240)) * 0.1).astype(np.float32))
    mel = log_mel_spectrogram(pcm, MelSpectrogramConfig()).transpose(-1, -2)
    with torch.no_grad():
        _, want = model(frames.float() / 127.5 - 1.0, mel)
    got = SyncPredictor(model, "cpu", torch.float32, "plain").logits(frames, pcm)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="item 7"):
        model(frames.float(), mel, deterministic=False, generator=torch.Generator(),
              extractors_deterministic=None)
