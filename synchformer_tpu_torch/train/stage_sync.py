"""Stage II/III trainer entry point (synchformer_tpu/train/stage_sync.py::
SyncTrainer.__init__, :86-194), one step at a time on one device.

    trainer = SyncTrainer(cfg)                  # device="cuda" by default
    metrics = trainer.train_step(batch)         # video, audio, offset_target
    out = trainer.eval_step(batch)              # f32 logits, loss_vec, targets

``cfg.action`` picks the workload: 'train_avsync_model' (Stage II: 21 offset
classes, targets ``offset_target``) or 'ft_avsync_model_for_syncability'
(Stage III: 2 classes, ``sync_target``). The model is ``cfg.model`` built
through the registry, or the preset ``build_synchformer(n_segments,
syncability)``, with weights drawn from training.seed; the towers named in
the config (``ckpt_path``) are then loaded from Stage I checkpoints. The
projections and the transformer train; a tower trains where its config node
says ``is_trainable``. Frozen towers run their eval path (K1-K4 on
impl='kernel') under no_grad, their matrices cast once to the compute dtype
(bf16 under ``use_half_precision``); trainable parameters stay f32 masters.

``batch`` is the loader's layout: ``video`` uint8 (B, S, 16, 224, 224, 3),
``audio`` PCM (B, S, 10240) and the target. Device prep (``_device_preprocess``,
stage_sync.py:49): frames normalised with the per-clip colour jitter,
grayscale and horizontal flip (train only), patchified on the device; PCM ->
f32 log-mel of the AST's max_spec_t frames -> (B, S, T, 128) in the compute
dtype. The audio augmentations are not ported (ROADMAP §1 item 3): a
p_audio_aug above 0 is refused.

Optimizer: training.optimizer (adam / adamw / sgd) at base_learning_rate x
1 device on training.lr_scheduler (constant / constant_with_warmup), eps
1e-7 under half precision, global-norm clipping at max_clip_norm. Resume and
the fit loop wait for data staging (ROADMAP §1 item 4).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import torch

from synchformer_tpu_torch.models.presets import build_synchformer
from synchformer_tpu_torch.models.sync_model import Synchformer
from synchformer_tpu_torch.ops.mel import MelSpectrogramConfig, log_mel_spectrogram
from synchformer_tpu_torch.ops.video import patchify_frames, prepare_video_batch
from synchformer_tpu_torch.registry import instantiate_from_config
from synchformer_tpu_torch.train.state import (
    SYNC_TRAINABLE_KEYS,
    make_lr_schedule,
    make_optimizer,
    set_trainable,
)
from synchformer_tpu_torch.train.step import sync_eval_step, sync_train_step
from synchformer_tpu_torch.utils.checkpoint import init_tower_from_stage1
from synchformer_tpu_torch.utils.convert import (
    SYNC_POS_EMB,
    load_numpy_state_dict,
    merge_state_dict_nonstrict,
    seeded_state_dict,
    trim_sync_pos_emb,
)

SYNCABILITY_ACTION = "ft_avsync_model_for_syncability"
TOWERS = {"afeat_extractor": "audio", "vfeat_extractor": "visual"}


class SyncTrainer:
    def __init__(self, cfg: Mapping[str, Any], device="cuda", model: Optional[Synchformer] = None,
                 impl: str = "kernel"):
        training = cfg.get("training", {})
        data = cfg.get("data", {})
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SyncTrainer: CUDA is not available; pass device='cpu' "
                               "to train on the CPU")
        if float(data.get("p_audio_aug") or 0.0) > 0.0:
            raise NotImplementedError("the audio augmentations are not ported (ROADMAP §1 "
                                      "item 3): set data.p_audio_aug to 0")
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.cfg = cfg
        self.impl = impl
        self.seed = int(training.get("seed", 1337))
        self.half = bool(training.get("use_half_precision", True))
        self.dtype = torch.bfloat16 if self.half else torch.float32
        syncability = cfg.get("action") == SYNCABILITY_ACTION
        self.target_key = "sync_target" if syncability else "offset_target"
        self.num_cls = 2 if syncability else int(data.get("num_off_cls", 21))

        model_cfg = cfg.get("model", {})
        self.model_params = model_cfg.get("params") or {}
        if model is None:
            if "target" in model_cfg:
                model = instantiate_from_config(model_cfg, device=self.device)
            else:
                model = build_synchformer(int(data.get("n_segments", 14)), syncability,
                                          device=self.device)
            load_numpy_state_dict(model, seeded_state_dict(model, self.seed))
        self.model = model.to(self.device).eval()
        self.init_towers_from_ckpts()

        keys = list(SYNC_TRAINABLE_KEYS)
        keys += [k for k in TOWERS if (self.model_params.get(k) or {}).get("is_trainable")]
        self.trainable_keys = tuple(keys)
        self.towers_trainable = any(k in keys for k in TOWERS)
        set_trainable(self.model, self.trainable_keys)
        self.model.cast_matrices_(self.dtype, [getattr(self.model, k) for k in TOWERS
                                               if k not in keys])

        max_spec_t = ((self.model_params.get("afeat_extractor") or {}).get("params") or {}).get(
            "max_spec_t", 66)
        self.mel_cfg = MelSpectrogramConfig(max_spec_t=int(max_spec_t))
        self.p_flip = float(data.get("p_horizontal_flip", 0.5))
        self.p_color_jitter = float(data.get("p_color_jitter", 0.0))
        self.p_gray_scale = float(data.get("p_gray_scale", 0.0))

        lr_cfg = training.get("lr_scheduler", {})
        self.schedule = make_lr_schedule(lr_cfg.get("name", "constant_with_warmup"),
                                         float(training.get("base_learning_rate", 2e-6)),
                                         int(lr_cfg.get("warmup", 1000)))
        clip = training.get("max_clip_norm", 1.0)
        self.max_clip_norm = None if clip is None else float(clip)
        self.optimizer = self._make_optimizer()
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.step = 0

    def _make_optimizer(self) -> torch.optim.Optimizer:
        opt = self.cfg.get("training", {}).get("optimizer", {})
        return make_optimizer(opt.get("name", "adam"), self.model.parameters(),
                              betas=tuple(opt.get("betas", (0.9, 0.999))),
                              momentum=float(opt.get("momentum", 0.9)),
                              weight_decay=float(opt.get("weight_decay", 0.0)),
                              eps=1e-7 if self.half else 1e-8)

    def init_towers_from_ckpts(self) -> Dict[str, dict]:
        """Load each tower whose config node names a ``ckpt_path`` from that
        Stage I checkpoint (non-strict; raises where the path is missing or
        matches nothing). Returns each loaded tower's merge report."""
        reports = {}
        for key, tower in TOWERS.items():
            path = ((self.model_params.get(key) or {}).get("params") or {}).get("ckpt_path")
            if path:
                reports[key] = init_tower_from_stage1(getattr(self.model, key), str(path), tower)
        return reports

    def finetune_from(self, source: Union[str, Path, Mapping[str, torch.Tensor]]) -> dict:
        """The fine-tune surgery (stage_sync.py:413-449): a Stage II state
        dict (or a ``.pt`` holding one, bare or under "model") merged
        non-strictly into this model, its sync pos-emb first trimmed to this
        model's length (a shorter one refused); fresh heads stay (``missing``),
        dropped ones are ``unexpected``. The step counter and the optimizer's
        state start again. Returns the merge report."""
        if isinstance(source, (str, Path)):
            ckpt = torch.load(source, map_location="cpu", weights_only=True)
            source = ckpt.get("model", ckpt)
        init = self.model.state_dict()
        loaded = trim_sync_pos_emb(source, init[SYNC_POS_EMB].shape[1])
        merged, report = merge_state_dict_nonstrict(init, loaded)
        self.model.load_state_dict(merged)
        for field in ("missing", "unexpected", "mismatched"):
            if report[field]:
                logging.warning(f"finetune load {field} ({len(report[field])}): "
                                f"{report[field][:8]}")
        self.optimizer = self._make_optimizer()
        self.step = 0
        return report

    def prepare(self, batch: Mapping[str, Any], train: bool):
        """Loader batch -> (patch-major normalised frames, log-mel), both in
        the compute dtype on the device."""
        video = torch.as_tensor(batch["video"]).to(self.device, non_blocking=True)
        pcm = torch.as_tensor(batch["audio"]).to(self.device, non_blocking=True)
        frames = prepare_video_batch(video, self.generator, train, self.p_flip, self.dtype,
                                     self.p_color_jitter, self.p_gray_scale)
        p = self.model.vfeat_extractor.patch_embed_3d.proj.kernel_size
        vis = patchify_frames(frames, p[0], p[1])
        aud = log_mel_spectrogram(pcm, self.mel_cfg).transpose(-1, -2).to(self.dtype)
        return vis, aud

    def _targets(self, batch: Mapping[str, Any]) -> torch.Tensor:
        return torch.as_tensor(batch[self.target_key]).to(self.device).long()

    def train_step(self, batch: Mapping[str, Any]) -> Dict[str, float]:
        """One update. Returns loss, grad_norm, accuracy_1 and loss_finite;
        raises on a non-finite loss (stage_sync.py:336)."""
        vis, aud = self.prepare(batch, train=True)
        out = sync_train_step(self.model, self.optimizer, self.schedule, self.step, vis, aud,
                              self._targets(batch), self.generator, self.impl,
                              self.max_clip_norm,
                              extractors_deterministic=not self.towers_trainable)
        self.step += 1
        metrics = {k: v.item() for k, v in out.items()}
        if not metrics["loss_finite"]:
            raise RuntimeError(f"non-finite loss at step {self.step - 1}")
        return metrics

    def eval_step(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The deterministic forward: f32 logits, per-example cross-entropy
        ``loss_vec`` and the targets, as device tensors."""
        vis, aud = self.prepare(batch, train=False)
        return sync_eval_step(self.model, vis, aud, self._targets(batch), self.impl)
