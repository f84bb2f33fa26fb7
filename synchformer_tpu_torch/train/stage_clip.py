"""Stage I trainer (synchformer_tpu/train/stage_clip.py::AVCLIPTrainer):
segment-level audio-visual contrastive pre-training on one device or over
ranks.

    trainer = AVCLIPTrainer(cfg)                 # device="cuda" by default
    results = trainer.fit(train_ds, valid_ds)    # epochs, checkpoints, logs
    metrics = trainer.train_step(batch)          # or one step at a time
    out = trainer.eval_step(batch)               # loss, zero-shot precision

As in the JAX trainer (stage_clip.py:94-100), ``cfg.model.target`` selects
the model: one naming MoCoCLIP trains MultilevelMoCoCLIP with its momentum
model, a copy of the model at the start updated as an EMA each step, and its
feature queues (segment queue queue_size x max_segments, global queue
queue_size, as _init_moco_state, stage_clip.py:223-235); anything else
trains AVCLIP. Where ``cfg.model`` carries ``params``, the model is built
from them through the port's registry (synchformer_tpu_torch.registry:
AVCLIP also over the legacy S3D and ResNet-18 towers, whose BatchNorms then
train with the batch's statistics; MoCo over them raises, as the JAX
package does not define its momentum model's statistics); without them, the
preset (build_moco_avclip / build_avclip).

``batch`` is the loader's layout: ``video`` uint8 (B, S, 16, 224, 224, 3),
``audio`` PCM (B, S, 10240), and, where the loader ships them (training with
p_audio_aug above 0), the contiguous crop ``audio_full`` (B, n) and the
segments' starts ``audio_seg_starts`` (B, S). Device prep happens inside:
frames normalised in the compute dtype with the per-clip horizontal flip
(train only) and patchified on the device for the Motionformer (the legacy
S3D takes the normalised frames); in training at p_audio_aug above
0 the five audio augmentations (ops/dsp.py: their row masks from a CPU
generator seeded training.seed + 7, the noise from the trainer's device
generator) on the crop before segmentation, or on the segments of a batch
without the crop; PCM -> f32 log-mel -> (B, S, 66, 128) in the compute
dtype. ``precision: amp`` is bf16 compute over f32 master parameters.
Every random draw of a step after the prep (drop-path, the towers'
dropouts, the positional dropout) comes from the trainer's device
generator, in an order that does not depend on ``impl``: the kernel and the
plain route of one seed draw the same masks (AVCLIP: the video tower, then
the audio tower; MoCo: the query pass).

Over ranks (a group joined by parallel/dist.py init_from_env, one process per
card) the trainer is the JAX trainer on a (n_data x training.model_parallel)
mesh: the ranks form that grid (pdist.init_grid; a world that does not split
into model_parallel is refused); ``base_batch_size`` is the global batch,
and each rank loads and steps batch_size / n_data rows of its data rank's
shard of the epoch; the model trains under DDP over the data group (``net``);
AVCLIP's InfoNCE and MoCo's keys span the global batch; the generators of
data rank r are seeded seed + RANK_STRIDE * r (data rank 0 draws the streams
of a run without a group; model peers draw alike), the MoCo queues from
training.seed + 1 on every rank (one shared state); under model_parallel
above 1 the parameters that the JAX param_shardings shards are stored as
this rank's blocks of rows (parallel/tensor.py shard_model_; the MoCo
momentum model, a copy, likewise), and checkpoints hold whole tensors; rank 0
alone logs, plots and writes checkpoints; the validation's metrics are
gathered over the data ranks (gather_dict) before they are logged and before
early stopping decides, so every rank stops at the same epoch.

``fit`` is the JAX fit loop (:238-395) on one process: the StagedLoader
feeds the card; per-step Data(t) / Batch(t) / samples/s / LR / loss at
logging.log_frequency into scalars.jsonl; the zero-shot probe and the
similarity heatmaps on the first train batch of each epoch; the zero-shot
shifted-window validation; ``<logdir>/<exp_name>/ckpts/latest`` every epoch
and ``best`` on a better precision, each holding the model, the optimizer,
step, epoch, the early stopper, the generators' states and, for MoCo, the
momentum model and queues, so that training.resume 'latest' continues bit
for bit; early stopping on training.patience.

Read from ``cfg``: model.{target, params} (and the audio tower's
max_spec_t, the log-mel's length), training.{seed, precision, learning_rate,
weight_decay, warmup, total_steps, max_clip_norm, zero_shot_window, alpha,
base_batch_size, num_epochs, patience, resume}, data.{p_horizontal_flip,
p_audio_aug, n_segments, crop_len_sec, step_size_seg, input_size,
segment_size_vframes, audio_jitter_sec, dataset, vids_path},
logging.{logdir, exp_name, log_code_state, use_wandb, log_frequency}.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from synchformer_tpu_torch.data.pipeline import StagedLoader, SyncDataLoader
from synchformer_tpu_torch.data.transforms import SyncPipelineConfig
from synchformer_tpu_torch.models.avclip import AVCLIP
from synchformer_tpu_torch.models.moco_clip import MultilevelMoCoCLIP, init_queues
from synchformer_tpu_torch.models.presets import build_avclip, build_moco_avclip
from synchformer_tpu_torch.ops.dsp import AUG_CHAIN, augment_batch_pcm
from synchformer_tpu_torch.ops.mel import MelSpectrogramConfig, log_mel_spectrogram
from synchformer_tpu_torch.ops.video import prepare_video_batch, tower_video_input
from synchformer_tpu_torch.parallel import dist as pdist
from synchformer_tpu_torch.parallel import tensor as ptensor
from synchformer_tpu_torch.registry import instantiate_from_config
from synchformer_tpu_torch.train.metrics import gather_dict
from synchformer_tpu_torch.train.state import make_adamw, make_lr_schedule
from synchformer_tpu_torch.train.step import (
    avclip_eval_step,
    avclip_train_step,
    moco_eval_step,
    moco_train_step,
)
from synchformer_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    generator_payload,
    restore_generators,
)
from synchformer_tpu_torch.utils.convert import load_numpy_state_dict, seeded_state_dict
from synchformer_tpu_torch.utils.logger import EarlyStopper, ExperimentLogger, Meter


class AVCLIPTrainer:
    """Stage I training on one device, of AVCLIP or, where cfg.model.target
    names MoCoCLIP, of MultilevelMoCoCLIP. ``model`` defaults to cfg.model
    built through the registry where it has params, else the full-width
    ``build_avclip()`` / ``build_moco_avclip()``, with weights drawn from
    training.seed (seeded_state_dict); the trainer moves it to
    ``device`` (a bare 'cuda' is this rank's card). ``impl`` picks the kernel
    route ('kernel') or the plain compositions ('plain')."""

    def __init__(self, cfg: Dict[str, Any], device="cuda",
                 model: Optional[Union[AVCLIP, MultilevelMoCoCLIP]] = None,
                 impl: str = "kernel"):
        training = cfg.get("training", {})
        data = cfg.get("data", {})
        self.device = pdist.local_device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AVCLIPTrainer: CUDA is not available; pass device='cpu' "
                               "to train on the CPU")
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.cfg = cfg
        self.impl = impl
        self.seed = int(training.get("seed", 1337))
        self.batch_size = int(training.get("base_batch_size", 2))
        pdist.init_grid(training.get("model_parallel", 1))
        self.local_batch = pdist.local_batch_size(self.batch_size, pdist.n_model())
        self.num_epochs = int(training.get("num_epochs", 100))
        self.patience = int(training.get("patience", 20))
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
        n_segments = int(data.get("n_segments_train", data.get("n_segments", 14)))
        self.pipe_cfg = SyncPipelineConfig(
            n_segments=n_segments,
            crop_len_sec=float(data.get("crop_len_sec", 5)),
            step_size_seg=float(data.get("step_size_seg", 0.5)),
            input_size=int(data.get("input_size", 224)),
            segment_size_vframes=int(data.get("segment_size_vframes", 16)),
            do_offset=False,  # Stage I trains on in-sync segments
            audio_jitter_sec=float(data.get("audio_jitter_sec", 0.0)),
            p_horizontal_flip=self.p_flip,
            p_audio_aug=float(data.get("p_audio_aug", 0.0)),
        )
        log_cfg = cfg.get("logging", {})
        self.log_frequency = int(log_cfg.get("log_frequency", 20))
        self.logger: Optional[ExperimentLogger] = None
        self.ckpt: Optional[CheckpointManager] = None
        if model is None:
            if model_cfg.get("params"):
                model = instantiate_from_config(model_cfg, device=self.device)
            else:
                model = (build_moco_avclip if self.is_moco else build_avclip)(device=self.device)
            load_numpy_state_dict(model, seeded_state_dict(model, self.seed))
        if isinstance(model, MultilevelMoCoCLIP) != self.is_moco:
            raise TypeError(f"cfg.model.target {cfg.get('model', {}).get('target')!r} does not "
                            f"name the model given, a {type(model).__name__}")
        self.model = ptensor.shard_model_(model.to(self.device))
        # the model under DDP where a group is joined: what the train step runs
        self.net = pdist.wrap_ddp(self.model, self.device)
        self.optimizer = make_adamw(self.model.named_parameters(),
                                    float(training.get("weight_decay", 0.2)))
        self.generator = torch.Generator(device=self.device).manual_seed(
            pdist.stream_seed(self.seed, pdist.data_rank()))
        # the audio augmentations' row masks, drawn on the host (ops/dsp.py)
        self.aug_generator = torch.Generator().manual_seed(
            pdist.stream_seed(self.seed + 7, pdist.data_rank()))
        # per transform, the train steps in which some clip drew it
        self.aug_drawn = {name: 0 for name in AUG_CHAIN}
        self.step = 0
        if self.is_moco:
            self._init_moco_state(n_segments)

    def _init_moco_state(self, n_segments: int) -> None:
        """The momentum model (a copy of the model in eval mode, no
        gradients) and the queues, drawn from training.seed + 1 (on every
        rank: the queues are one state, kept equal over ranks)."""
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
        """Loader batch -> (normalised frames in the video tower's layout:
        patch-major for the Motionformer, frames for the legacy S3D; log-mel),
        both in the compute dtype on the device."""
        video = torch.as_tensor(batch["video"]).to(self.device, non_blocking=True)
        pcm = torch.as_tensor(batch["audio"]).to(self.device, non_blocking=True)
        frames = prepare_video_batch(video, self.generator, train, self.p_flip, self.dtype)
        if train and self.pipe_cfg.p_audio_aug > 0:
            pcm = augment_batch_pcm(batch, pcm, self.pipe_cfg.p_audio_aug,
                                    int(self.pipe_cfg.afps), self.aug_generator,
                                    self.generator, self.aug_drawn)
        vfe = self.model.v_encoder if self.is_moco else self.model.vfeat_extractor
        vis = tower_video_input(frames, vfe)
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
            out = moco_train_step(self.net, self.model_m, self.queues, self.optimizer,
                                  self.schedule, self.step, vis, aud, self.generator,
                                  self.alpha if alpha is None else alpha, self.impl,
                                  self.max_clip_norm)
        else:
            out = avclip_train_step(self.net, self.optimizer, self.schedule, self.step, vis,
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

    # ------------------------------------------------------------------
    def payload(self, epoch: int, stopper: EarlyStopper) -> Dict[str, Any]:
        """A checkpoint's payload: what a resumed run needs to continue bit
        for bit (the JAX payload's trainable / opt_state / epoch / stopper /
        moco, and the step and every rank's generator states, which JAX
        derives from the step); whole tensors under tensor parallelism.
        Every rank calls it."""
        out = {"trainable": self.model.state_dict(),
               "opt_state": ptensor.optimizer_state_dict(self.optimizer, self.model),
               "step": self.step, "epoch": epoch, "stopper": stopper.state_dict(),
               **generator_payload({"device": self.generator, "aug": self.aug_generator})}
        if self.is_moco:
            out["moco"] = {"model_m": self.model_m.state_dict(),
                           "queues": dataclasses.asdict(self.queues)}
        return out

    @torch.no_grad()
    def load_payload(self, payload: Dict[str, Any]) -> None:
        """Restore the model, optimizer, step, generators and MoCo state of
        a payload (the stopper and epoch are the caller's). The generators
        continue where the payload was written at this number of data ranks;
        else they are re-seeded from the seed, the epoch after the payload's
        and the data rank (restore_generators)."""
        self.model.load_state_dict(payload["trainable"])
        ptensor.load_optimizer_state_dict(self.optimizer, self.model, payload["opt_state"])
        self.step = int(payload["step"])
        restore_generators({"device": self.generator, "aug": self.aug_generator},
                           payload, {"device": self.seed, "aug": self.seed + 7},
                           int(payload["epoch"]) + 1)
        if self.is_moco:
            self.model_m.load_state_dict(payload["moco"]["model_m"])
            for name, value in payload["moco"]["queues"].items():
                current = getattr(self.queues, name)
                if isinstance(current, torch.Tensor):
                    current.copy_(value)
                else:
                    setattr(self.queues, name, value)

    def open_run(self) -> None:
        """The experiment directory ``logdir`` (the logger: cfg.yaml,
        scalars.jsonl) and its checkpoint store ``ckpt``, opened by ``fit``
        where it is not open; ``fit`` closes the logger at its end."""
        if self.logger is not None:
            return
        log_cfg = self.cfg.get("logging", {})
        self.logger = ExperimentLogger(
            log_cfg.get("logdir", "./logs/avclip_models"), exp_name=log_cfg.get("exp_name"),
            cfg=self.cfg if isinstance(self.cfg, dict) else None,
            log_code_state=bool(log_cfg.get("log_code_state", False)),
            use_wandb=bool(log_cfg.get("use_wandb", False)))
        self.logdir = self.logger.logdir
        self.ckpt = CheckpointManager(str(self.logdir / "ckpts"))

    def resume(self, stopper: EarlyStopper) -> int:
        """Resume-latest discovery (ref: train_clip.py:126-159): with
        training.resume 'latest' and a latest checkpoint in this run's
        store, restore it; returns the first epoch to train."""
        if self.cfg.get("training", {}).get("resume") != "latest" \
                or self.ckpt.latest_step() is None:
            return 0
        payload = self.ckpt.restore_latest()
        self.load_payload(payload)
        stopper.load_state_dict(payload["stopper"])
        logging.info(f"Stage-I resumed from epoch {int(payload['epoch'])} (step {self.step})")
        return int(payload["epoch"]) + 1

    def log_similarity_matrices(self, out: Dict[str, Any], phase: str, epoch: int) -> None:
        """v2a/a2v/v2v/a2a heatmaps from one batch's segment features (ref:
        training/train.py:405-467). Observability only: never fatal. Rank 0
        only."""
        if not pdist.is_master():
            return
        try:
            from synchformer_tpu_torch.utils.viz import plot_similarity_matrices

            d = out["afeat"].shape[-1]
            a = out["afeat"].reshape(-1, d).cpu().numpy()
            v = out["vfeat"].reshape(-1, d).cpu().numpy()
            scale = self.model.segment_logit_scale if self.is_moco else self.model.logit_scale
            scale = float(np.clip(float(scale.detach()), self.model.clamp_scale_min,
                                  self.model.clamp_scale_max))
            sims = {"segment_sim_v2a": v @ a.T / scale, "segment_sim_a2v": a @ v.T / scale,
                    "segment_sim_v2v": v @ v.T / scale, "segment_sim_a2a": a @ a.T / scale}
            plot_similarity_matrices(
                sims, str(self.logdir / "sims" / f"{phase}_e{epoch}.png"))
        except Exception as e:
            logging.warning(f"similarity-matrix logging failed: {e}")

    def fit(self, train_ds, valid_ds, num_workers: int = 4, max_epochs: Optional[int] = None,
            decode_backend: Optional[str] = None) -> Dict[str, float]:
        """Train for training.num_epochs (or ``max_epochs``) epochs from the
        first epoch not yet trained (resume), validating and checkpointing
        after each; returns the last epoch's valid precision, loss and
        epoch."""
        self.open_run()
        loaders = {
            split: StagedLoader(SyncDataLoader(ds, self.pipe_cfg, self.local_batch, num_workers,
                                               self.seed, shuffle=split == "train",
                                               process_index=pdist.data_rank(),
                                               process_count=pdist.n_data(),
                                               decode_backend=decode_backend),
                                device=self.device)
            for split, ds in (("train", train_ds), ("valid", valid_ds))
        }
        stopper = EarlyStopper(self.patience, to_max=True)
        start_epoch = self.resume(stopper)
        epochs = max_epochs if max_epochs is not None else self.num_epochs
        results: Dict[str, float] = {}
        try:
            for epoch in range(start_epoch, epochs):
                self._train_epoch(loaders["train"], epoch)
                metrics = self._validate(loaders["valid"], epoch)
                improved = stopper.update(metrics["precision"])
                # epoch_latest every epoch, epoch_best on improvement
                # (ref: train_clip.py:396-441)
                payload = self.payload(epoch, stopper)
                self.ckpt.save_latest(epoch, payload)
                if improved:
                    self.ckpt.save_best(epoch, payload,
                                        metrics={"best_metric": float(metrics["precision"])})
                results = {**metrics, "epoch": epoch}
                if stopper.triggered:
                    logging.info(f"Stage-I early stop at epoch {epoch}")
                    break
        finally:
            self.logger.close()
            self.logger = None
        return results

    def _train_epoch(self, loader, epoch: int) -> None:
        loader.set_epoch(epoch)
        n_iters = max(len(loader), 1)
        loss_m = Meter()
        # per-iteration telemetry: data/batch time + samples/s, logged every
        # log_frequency steps (ref: training/train.py:195-213)
        data_m, batch_m = Meter(), Meter()
        drawn_before = dict(self.aug_drawn)
        t_prev = time.perf_counter()
        for i, batch in enumerate(loader):
            data_m.update(time.perf_counter() - t_prev)  # loader wait
            alpha = self.alpha_at(epoch, i, n_iters) if self.is_moco else None
            metrics = self.train_step(batch, alpha)
            loss_m.update(metrics["loss"])
            batch_m.update(time.perf_counter() - t_prev)  # full iteration
            t_prev = time.perf_counter()
            if (i + 1) % self.log_frequency == 0:
                samples_per_s = self.local_batch * pdist.n_data() / max(batch_m.avg, 1e-9)
                lr_now = float(self.schedule(self.step))
                logging.info(
                    f"Train Epoch: {epoch} [{(i + 1) * self.batch_size}"
                    f"/{n_iters * self.batch_size}] Data (t): {data_m.avg:.3f} "
                    f"Batch (t): {batch_m.avg:.3f}, {samples_per_s:#.4g}/s "
                    f"LR: {lr_now:.3g} Loss: {loss_m.avg:#.5g}")
                self.logger.log_dict(
                    {"data_time": data_m.avg, "batch_time": batch_m.avg,
                     "samples_per_s": samples_per_s, "lr": lr_now,
                     "loss_iter": metrics["loss"]}, self.step, prefix="train/")
                data_m, batch_m = Meter(), Meter()  # per-window meters
            if i == 0:
                # in-train eval-one-example: the zero-shot probe and the
                # similarity heatmaps on the first train batch of every
                # epoch (ref: training/train.py:168-232)
                one = self.eval_step(batch)
                self.logger.log_scalar("train/precision_one_batch",
                                       float(one["precision"]), epoch)
                self.log_similarity_matrices(one, "train", epoch)
                t_prev = time.perf_counter()
        self.logger.log_scalar("train/loss", loss_m.avg, epoch)
        for name in AUG_CHAIN:
            self.logger.log_scalar(f"train/aug_steps_{name}",
                                   self.aug_drawn[name] - drawn_before[name], epoch)

    def _validate(self, loader, epoch: int) -> Dict[str, float]:
        """The zero-shot shifted-window validation; the metrics averaged over
        the data ranks (gather_dict)."""
        loader.set_epoch(epoch)
        prec_m, vloss_m = Meter(), Meter()
        out = None
        for batch in loader:
            out = self.eval_step(batch)
            prec_m.update(float(out["precision"]))
            vloss_m.update(float(out["loss"]))
        if out is not None:
            self.log_similarity_matrices(out, "valid", epoch)
        metrics = gather_dict({"precision": prec_m.avg, "loss": vloss_m.avg})
        self.logger.log_dict(metrics, epoch, prefix="valid/")
        self.logger.append_results("valid", {"epoch": epoch, **metrics})
        return metrics


def train(cfg: Dict[str, Any], device="cuda", **fit_kwargs) -> Dict[str, float]:
    """Entry point mirroring ref train_clip.py:main(cfg): the trainer on
    ``device`` and the dataset named by data.dataset, its train and valid
    splits."""
    trainer = AVCLIPTrainer(cfg, device=device)
    data_cfg = cfg.get("data", {})
    ds_cfg = data_cfg.get("dataset", {})
    train_ds = instantiate_from_config(ds_cfg, split="train", vids_dir=data_cfg.get("vids_path"))
    valid_ds = instantiate_from_config(ds_cfg, split="valid", vids_dir=data_cfg.get("vids_path"))
    return trainer.fit(train_ds, valid_ds, **fit_kwargs)
