"""Stage I trainer entry point (synchformer_tpu/train/stage_clip.py::
AVCLIPTrainer), one step at a time.

    trainer = AVCLIPTrainer(cfg)                 # device="cuda" by default
    metrics = trainer.train_step(batch)          # batch["video"], batch["audio"]
    out = trainer.eval_step(batch)               # loss, zero-shot precision

As in the JAX trainer (stage_clip.py:94-100), ``cfg.model.target`` selects
the model: one naming MoCoCLIP trains MultilevelMoCoCLIP with its momentum
model, a copy of the model at the start updated as an EMA each step, and its
feature queues (segment queue queue_size x max_segments, global queue
queue_size, as _init_moco_state, stage_clip.py:223-235); anything else
trains AVCLIP. Where ``cfg.model`` carries ``params``, the model is built
from them through the port's registry (synchformer_tpu_torch.registry);
without them, the preset (build_moco_avclip / build_avclip).

``batch`` is the loader's layout: ``video`` uint8 (B, S, 16, 224, 224, 3),
``audio`` PCM (B, S, 10240). Device prep happens inside: frames normalised in
the compute dtype with the per-clip horizontal flip (train only) and
patchified on the device; PCM -> f32 log-mel -> (B, S, 66, 128) in the compute
dtype. ``precision: amp`` is bf16 compute over f32 master parameters.

Read from ``cfg``: model.{target, params} (and the audio tower's
max_spec_t, the log-mel's length), training.{seed, precision, learning_rate,
weight_decay, warmup, total_steps, max_clip_norm, zero_shot_window, alpha},
data.{p_horizontal_flip, p_audio_aug, n_segments}. The audio augmentations
(synchformer_tpu/ops/dsp.py) are not ported: a p_audio_aug above 0 is
refused rather than ignored. There is no loader, checkpointing or logging
here; those wait for data staging.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Union

import torch

from synchformer_tpu_torch.models.avclip import AVCLIP
from synchformer_tpu_torch.models.moco_clip import MultilevelMoCoCLIP, init_queues
from synchformer_tpu_torch.models.presets import build_avclip, build_moco_avclip
from synchformer_tpu_torch.ops.mel import MelSpectrogramConfig, log_mel_spectrogram
from synchformer_tpu_torch.ops.video import patchify_frames, prepare_video_batch
from synchformer_tpu_torch.registry import instantiate_from_config
from synchformer_tpu_torch.train.state import make_adamw, make_lr_schedule
from synchformer_tpu_torch.train.step import (
    avclip_eval_step,
    avclip_train_step,
    moco_eval_step,
    moco_train_step,
)
from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict


class AVCLIPTrainer:
    """Stage I training on one device, of AVCLIP or, where cfg.model.target
    names MoCoCLIP, of MultilevelMoCoCLIP. ``model`` defaults to cfg.model
    built through the registry where it has params, else the full-width
    ``build_avclip()`` / ``build_moco_avclip()``, with weights drawn from
    training.seed (seeded_state_dict); the trainer moves it to
    ``device``. ``impl`` picks the kernel route ('kernel') or the plain
    compositions ('plain')."""

    def __init__(self, cfg: Dict[str, Any], device="cuda",
                 model: Optional[Union[AVCLIP, MultilevelMoCoCLIP]] = None,
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
        model_cfg = cfg.get("model", {})
        self.is_moco = "MoCoCLIP" in str(model_cfg.get("target", ""))
        self.alpha = float(training.get("alpha", 0.0))
        self.mel_cfg = MelSpectrogramConfig(max_spec_t=int(
            (model_cfg.get("params") or {}).get("afeat_extractor", {}).get("params", {})
            .get("max_spec_t", 66)))
        if model is None:
            if model_cfg.get("params"):
                model = instantiate_from_config(model_cfg, device=self.device)
            else:
                model = (build_moco_avclip if self.is_moco else build_avclip)(device=self.device)
            load_numpy_state_dict(model, seeded_state_dict(model, self.seed))
        if isinstance(model, MultilevelMoCoCLIP) != self.is_moco:
            raise TypeError(f"cfg.model.target {cfg.get('model', {}).get('target')!r} does not "
                            f"name the model given, a {type(model).__name__}")
        self.model = model.to(self.device)
        self.optimizer = make_adamw(self.model.named_parameters(),
                                    float(training.get("weight_decay", 0.2)))
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.step = 0
        if self.is_moco:
            self._init_moco_state(int(data.get("n_segments_train", data.get("n_segments", 14))))

    def _init_moco_state(self, n_segments: int) -> None:
        """The momentum model (a copy of the model in eval mode, no
        gradients) and the queues, drawn from training.seed + 1."""
        model = self.model
        max_segments = model.a_encoder.max_segments or n_segments
        self.model_m = copy.deepcopy(model).requires_grad_(False).eval()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self.queues = init_queues(gen, model.n_embd, model.queue_size * max_segments,
                                  model.queue_size if model.add_global_repr else None,
                                  device=self.device)

    def alpha_at(self, epoch: int, i: int, n_iters: int) -> float:
        """The ALBEF weight at iteration i of n_iters in epoch ``epoch``:
        ramped linearly from 0 over epoch 0 (ref: training/train.py:115)."""
        return self.alpha * min(1.0, i / n_iters) if epoch == 0 else self.alpha

    def prepare(self, batch: Dict[str, Any], train: bool):
        """Loader batch -> (patch-major normalised frames, log-mel), both in
        the compute dtype on the device."""
        video = torch.as_tensor(batch["video"]).to(self.device, non_blocking=True)
        pcm = torch.as_tensor(batch["audio"]).to(self.device, non_blocking=True)
        frames = prepare_video_batch(video, self.generator, train, self.p_flip, self.dtype)
        vfe = self.model.v_encoder if self.is_moco else self.model.vfeat_extractor
        p = vfe.patch_embed_3d.proj.kernel_size
        vis = patchify_frames(frames, p[0], p[1])
        aud = log_mel_spectrogram(pcm, self.mel_cfg).transpose(-1, -2).to(self.dtype)
        return vis, aud

    def train_step(self, batch: Dict[str, Any], alpha: Optional[float] = None) -> Dict[str, float]:
        """One update. Returns loss, grad_norm, loss_finite and, for AVCLIP,
        logit_scale, for MoCo each level's loss; raises on a non-finite loss,
        as the JAX trainer does. ``alpha`` (MoCo only) defaults to
        training.alpha."""
        self.model.train()
        vis, aud = self.prepare(batch, train=True)
        if self.is_moco:
            out = moco_train_step(self.model, self.model_m, self.queues, self.optimizer,
                                  self.schedule, self.step, vis, aud, self.generator,
                                  self.alpha if alpha is None else alpha, self.impl,
                                  self.max_clip_norm)
        else:
            out = avclip_train_step(self.model, self.optimizer, self.schedule, self.step, vis,
                                    aud, self.generator, self.impl, self.max_clip_norm)
        self.step += 1
        metrics = {k: v.item() for k, v in out.items()}
        if not metrics["loss_finite"]:
            raise RuntimeError(f"non-finite Stage I loss at step {self.step - 1}")
        return metrics

    def eval_step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Deterministic loss and zero-shot precision of one batch."""
        self.model.eval()
        vis, aud = self.prepare(batch, train=False)
        if self.is_moco:
            return moco_eval_step(self.model, self.model_m, self.queues, vis, aud,
                                  self.zero_shot_window, self.impl)
        return avclip_eval_step(self.model, vis, aud, self.zero_shot_window, self.impl)
