"""Stage I trainer entry point (synchformer_tpu/train/stage_clip.py::
AVCLIPTrainer), one step at a time.

    trainer = AVCLIPTrainer(cfg)                 # device="cuda" by default
    metrics = trainer.train_step(batch)          # batch["video"], batch["audio"]
    out = trainer.eval_step(batch)               # loss, zero-shot precision

``batch`` is the loader's layout: ``video`` uint8 (B, S, 16, 224, 224, 3),
``audio`` PCM (B, S, 10240). Device prep happens inside: frames normalised in
the compute dtype with the per-clip horizontal flip (train only) and
patchified on the device; PCM -> f32 log-mel -> (B, S, 66, 128) in the compute
dtype. ``precision: amp`` is bf16 compute over f32 master parameters.

Read from ``cfg``: training.{seed, precision, learning_rate, weight_decay,
warmup, total_steps, max_clip_norm, zero_shot_window}, data.p_horizontal_flip,
data.p_audio_aug. The audio augmentations (synchformer_tpu/ops/dsp.py) are
not ported: a p_audio_aug above 0 is refused rather than ignored. There is no
loader, checkpointing or logging here; those wait for data staging.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from synchformer_tpu_torch.models.avclip import AVCLIP
from synchformer_tpu_torch.models.presets import build_avclip
from synchformer_tpu_torch.ops.mel import log_mel_spectrogram
from synchformer_tpu_torch.ops.video import patchify_frames, prepare_video_batch
from synchformer_tpu_torch.train.state import make_adamw, make_lr_schedule
from synchformer_tpu_torch.train.step import avclip_eval_step, avclip_train_step
from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict


class AVCLIPTrainer:
    """AVCLIP Stage I training on one device. ``model`` defaults to the
    full-width ``build_avclip()`` with weights drawn from training.seed
    (seeded_state_dict); the trainer moves it to ``device``. ``impl`` picks the
    kernel route ('kernel') or the plain compositions ('plain')."""

    def __init__(self, cfg: Dict[str, Any], device="cuda", model: Optional[AVCLIP] = None,
                 impl: str = "kernel"):
        training = cfg.get("training", {})
        data = cfg.get("data", {})
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AVCLIPTrainer: CUDA is not available; pass device='cpu' "
                               "to train on the CPU")
        if float(data.get("p_audio_aug", 0.0)) > 0.0:
            raise NotImplementedError("the Stage I audio augmentations are not ported: "
                                      "set data.p_audio_aug to 0")
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.impl = impl
        self.seed = int(training.get("seed", 1337))
        self.dtype = (torch.bfloat16 if training.get("precision", "amp") == "amp"
                      else torch.float32)
        self.p_flip = float(data.get("p_horizontal_flip", 0.5))
        self.zero_shot_window = int(training.get("zero_shot_window", 8))
        self.max_clip_norm = float(training.get("max_clip_norm", 1.0))
        self.schedule = make_lr_schedule(
            "cosine", float(training.get("learning_rate", 1e-4)),
            int(training.get("warmup", 1000)), int(training.get("total_steps", 100_000)))
        if model is None:
            model = build_avclip(device=self.device)
            load_numpy_state_dict(model, seeded_state_dict(model, self.seed))
        self.model = model.to(self.device)
        self.optimizer = make_adamw(self.model.named_parameters(),
                                    float(training.get("weight_decay", 0.2)))
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.step = 0

    def prepare(self, batch: Dict[str, Any], train: bool):
        """Loader batch -> (patch-major normalised frames, log-mel), both in
        the compute dtype on the device."""
        video = torch.as_tensor(batch["video"]).to(self.device, non_blocking=True)
        pcm = torch.as_tensor(batch["audio"]).to(self.device, non_blocking=True)
        frames = prepare_video_batch(video, self.generator, train, self.p_flip, self.dtype)
        vfe = self.model.vfeat_extractor
        p = vfe.patch_embed_3d.proj.kernel_size
        vis = patchify_frames(frames, p[0], p[1])
        aud = log_mel_spectrogram(pcm).transpose(-1, -2).to(self.dtype)
        return vis, aud

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One update. Returns loss, grad_norm, logit_scale, loss_finite;
        raises on a non-finite loss, as the JAX trainer does."""
        self.model.train()
        vis, aud = self.prepare(batch, train=True)
        out = avclip_train_step(self.model, self.optimizer, self.schedule, self.step, vis, aud,
                                self.generator, self.impl, self.max_clip_norm)
        self.step += 1
        metrics = {k: v.item() for k, v in out.items()}
        if not metrics["loss_finite"]:
            raise RuntimeError(f"non-finite Stage I loss at step {self.step - 1}")
        return metrics

    def eval_step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Deterministic loss and zero-shot precision of one batch."""
        self.model.eval()
        vis, aud = self.prepare(batch, train=False)
        return avclip_eval_step(self.model, vis, aud, self.zero_shot_window, self.impl)
