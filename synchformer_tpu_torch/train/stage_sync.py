"""Stage II/III trainer (synchformer_tpu/train/stage_sync.py::SyncTrainer) on
one device or over ranks: audio-visual offset training and the syncability
fine-tune.

    trainer = SyncTrainer(cfg)                  # device="cuda" by default
    results = trainer.fit(train_ds, valid_ds, test_ds)
    metrics = trainer.train_step(batch)         # or one step at a time
    out = trainer.eval_step(batch)              # f32 logits, loss_vec, targets

``cfg.action`` picks the workload: 'train_avsync_model' (Stage II: 21 offset
classes, targets ``offset_target``) or 'ft_avsync_model_for_syncability'
(Stage III: 2 classes, ``sync_target``). The model is ``cfg.model`` built
through the registry, or the preset ``build_synchformer(n_segments,
syncability)``, with weights drawn from training.seed; the towers named in
the config (``ckpt_path``: a Stage I ``.pt`` or a Stage I run of the port's
CheckpointManager) are then loaded from there. The projections and the
transformer train; a tower trains where its config node says
``is_trainable``. Frozen towers run their eval path (K1-K4 on impl='kernel')
under no_grad, their matrices cast once to the compute dtype (bf16 under
``use_half_precision``); trainable parameters stay f32 masters.

``batch`` is the loader's layout: ``video`` uint8 (B, S, 16, 224, 224, 3),
``audio`` PCM (B, S, 10240), the target and, in training at p_audio_aug
above 0, the contiguous crop ``audio_full`` and ``audio_seg_starts``. Device
prep (``_device_preprocess``, stage_sync.py:49): frames normalised with the
per-clip colour jitter, grayscale and horizontal flip (train only),
patchified on the device; in training at p_audio_aug above 0 the five audio
augmentations (ops/dsp.py; row masks from a CPU generator seeded
training.seed + 7, noise from the device generator); PCM -> f32 log-mel of
the AST's max_spec_t frames -> (B, S, T, 128) in the compute dtype.

Optimizer: training.optimizer (adam / adamw / sgd) at base_learning_rate x
the number of data ranks (the JAX trainer's n_data, stage_sync.py:161-165;
ref: train_utils.py:218) on training.lr_scheduler (constant /
constant_with_warmup), eps 1e-7 under half precision, global-norm clipping
at max_clip_norm.

Over ranks (a group joined by parallel/dist.py init_from_env) the trainer is
the JAX trainer on a (n_data x training.model_parallel) mesh: the ranks form
that grid (pdist.init_grid; a world that does not split into model_parallel
is refused); ``base_batch_size`` is the global batch, each rank steps
batch_size / n_data rows of its data rank's shard under DDP over its data
group (``net``); the generators of data rank r are seeded seed +
RANK_STRIDE * r, so that model peers draw alike; under model_parallel above
1 the parameters that the JAX param_shardings shards are stored as this
rank's blocks of rows (parallel/tensor.py shard_model_, after the towers are
loaded), and checkpoints hold whole tensors; the valid and test logits and
targets are gathered over the data ranks (gather_dict) before the metrics,
so every rank decides the same early stop; rank 0 alone logs, writes
checkpoints, the input reconstruction, the test plots and the profile.

``fit`` is the JAX loop (:487-593) on one process: train / valid phases
(run_phase) fed by the StagedLoader, per-step telemetry into scalars.jsonl
at logging.log_frequency, the input reconstruction at the first iteration,
the full metric suite on valid, early stopping on training.metric_name,
``ckpts/latest`` every epoch and ``ckpts/best`` on improvement (the
trainable parameters, optimizer, step, epoch, early stopper and the
generators' states), training.resume (maybe_resume: bit for bit) and
training.finetune from training.ckpt_path, run_test_only, the test phase
over iter_times passes with its plots. training.trace records the first
epoch with torch.profiler into ``<logdir>/profile`` (_maybe_profile).
"""
from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from synchformer_tpu_torch.data.pipeline import StagedLoader, SyncDataLoader
from synchformer_tpu_torch.data.transforms import SyncPipelineConfig
from synchformer_tpu_torch.models.presets import build_synchformer
from synchformer_tpu_torch.models.sync_model import Synchformer
from synchformer_tpu_torch.ops.dsp import AUG_CHAIN, augment_batch_pcm
from synchformer_tpu_torch.ops.mel import MelSpectrogramConfig, log_mel_spectrogram
from synchformer_tpu_torch.ops.video import prepare_video_batch, tower_video_input
from synchformer_tpu_torch.parallel import dist as pdist
from synchformer_tpu_torch.parallel import tensor as ptensor
from synchformer_tpu_torch.registry import instantiate_from_config
from synchformer_tpu_torch.train.state import (
    SYNC_TRAINABLE_KEYS,
    make_lr_schedule,
    make_optimizer,
    set_trainable,
)
from synchformer_tpu_torch.train.metrics import calc_cls_metrics, gather_dict, per_class_accuracy
from synchformer_tpu_torch.train.step import sync_eval_step, sync_train_step
from synchformer_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    generator_payload,
    init_tower_from_stage1,
    load_run_checkpoint,
    restore_generators,
)
from synchformer_tpu_torch.utils.convert import (
    SYNC_POS_EMB,
    load_numpy_state_dict,
    merge_state_dict_nonstrict,
    seeded_state_dict,
    trim_sync_pos_emb,
)
from synchformer_tpu_torch.utils.logger import EarlyStopper, ExperimentLogger, Meter

SYNCABILITY_ACTION = "ft_avsync_model_for_syncability"
TOWERS = {"afeat_extractor": "audio", "vfeat_extractor": "visual"}


class SyncTrainer:
    def __init__(self, cfg: Mapping[str, Any], device="cuda", model: Optional[Synchformer] = None,
                 impl: str = "kernel"):
        training = cfg.get("training", {})
        data = cfg.get("data", {})
        self.device = pdist.local_device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SyncTrainer: CUDA is not available; pass device='cpu' "
                               "to train on the CPU")
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
        self.num_epochs = int(training.get("num_epochs", 10000))
        self.batch_size = int(training.get("base_batch_size", 16))
        pdist.init_grid(training.get("model_parallel", 1))
        self.local_batch = pdist.local_batch_size(self.batch_size, pdist.n_model())
        self.metric_name = training.get("metric_name", "accuracy_1")
        self.patience = int(training.get("patience", 20))
        self.run_test_only = bool(training.get("run_test_only", False))
        n_segments = int(data.get("n_segments", 14))
        self.pipe_cfg = SyncPipelineConfig(
            n_segments=n_segments,
            num_off_cls=int(data.get("num_off_cls", 21)),
            crop_len_sec=float(data.get("crop_len_sec", 5)),
            max_off_sec=float(data.get("max_off_sec", 2)),
            step_size_seg=float(data.get("step_size_seg", 0.5)),
            input_size=int(data.get("input_size", 224)),
            segment_size_vframes=int(data.get("segment_size_vframes", 16)),
            audio_jitter_sec=float(data.get("audio_jitter_sec", 0.05)),
            sometimes_upscale_p=float(data.get("sometimes_upscale_p") or 0.0),
            p_audio_aug=float(data.get("p_audio_aug") or 0.0),
            p_horizontal_flip=float(data.get("p_horizontal_flip", 0.5)),
            p_color_jitter=float(data.get("p_color_jitter", 0.0)),
            p_gray_scale=float(data.get("p_gray_scale", 0.0)),
            for_syncability=syncability,
            offset_type=data.get("offset_type", "grid"),
        )
        self.log_frequency = int(cfg.get("logging", {}).get("log_frequency", 20))
        self.logger: Optional[ExperimentLogger] = None
        self.ckpt: Optional[CheckpointManager] = None

        model_cfg = cfg.get("model", {})
        self.model_params = model_cfg.get("params") or {}
        if model is None:
            if "target" in model_cfg:
                model = instantiate_from_config(model_cfg, device=self.device)
            else:
                model = build_synchformer(n_segments, syncability, device=self.device)
            load_numpy_state_dict(model, seeded_state_dict(model, self.seed))
        self.model = model.to(self.device).eval()
        self.tower_reports = self.init_towers_from_ckpts()
        ptensor.shard_model_(self.model)

        keys = list(SYNC_TRAINABLE_KEYS)
        keys += [k for k in TOWERS if (self.model_params.get(k) or {}).get("is_trainable")]
        self.trainable_keys = tuple(keys)
        self.towers_trainable = any(k in keys for k in TOWERS)
        set_trainable(self.model, self.trainable_keys)
        self.model.cast_matrices_(self.dtype, [getattr(self.model, k) for k in TOWERS
                                               if k not in keys])
        # the model under DDP where a group is joined (its trainable
        # parameters): what the train step runs
        self.net = pdist.wrap_ddp(self.model, self.device)

        max_spec_t = ((self.model_params.get("afeat_extractor") or {}).get("params") or {}).get(
            "max_spec_t", 66)
        self.mel_cfg = MelSpectrogramConfig(max_spec_t=int(max_spec_t))
        self.p_flip = float(data.get("p_horizontal_flip", 0.5))
        self.p_color_jitter = float(data.get("p_color_jitter", 0.0))
        self.p_gray_scale = float(data.get("p_gray_scale", 0.0))

        lr_cfg = training.get("lr_scheduler", {})
        self.schedule = make_lr_schedule(
            lr_cfg.get("name", "constant_with_warmup"),
            float(training.get("base_learning_rate", 2e-6)) * pdist.n_data(),
            int(lr_cfg.get("warmup", 1000)))
        clip = training.get("max_clip_norm", 1.0)
        self.max_clip_norm = None if clip is None else float(clip)
        self.optimizer = self._make_optimizer()
        self.generator = torch.Generator(device=self.device).manual_seed(
            pdist.stream_seed(self.seed, pdist.data_rank()))
        # the audio augmentations' row masks, drawn on the host (ops/dsp.py)
        self.aug_generator = torch.Generator().manual_seed(
            pdist.stream_seed(self.seed + 7, pdist.data_rank()))
        # per transform, the train steps in which some clip drew it
        self.aug_drawn = {name: 0 for name in AUG_CHAIN}
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
        dict (or a ``.pt`` holding one, bare, under "model", or a
        CheckpointManager payload's "trainable") merged
        non-strictly into this model, its sync pos-emb first trimmed to this
        model's length (a shorter one refused); fresh heads stay (``missing``),
        dropped ones are ``unexpected``. The step counter and the optimizer's
        state start again. Returns the merge report."""
        if isinstance(source, (str, Path)):
            ckpt = torch.load(source, map_location="cpu", weights_only=True)
            source = ckpt.get("trainable", ckpt.get("model", ckpt))
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
        """Loader batch -> (normalised frames in the video tower's layout:
        patch-major for the Motionformer, frames for the legacy S3D; log-mel),
        both in the compute dtype on the device."""
        video = torch.as_tensor(batch["video"]).to(self.device, non_blocking=True)
        pcm = torch.as_tensor(batch["audio"]).to(self.device, non_blocking=True)
        frames = prepare_video_batch(video, self.generator, train, self.p_flip, self.dtype,
                                     self.p_color_jitter, self.p_gray_scale)
        if train and self.pipe_cfg.p_audio_aug > 0:
            pcm = augment_batch_pcm(batch, pcm, self.pipe_cfg.p_audio_aug,
                                    int(self.pipe_cfg.afps), self.aug_generator,
                                    self.generator, self.aug_drawn)
        vis = tower_video_input(frames, self.model.vfeat_extractor)
        aud = log_mel_spectrogram(pcm, self.mel_cfg).transpose(-1, -2).to(self.dtype)
        return vis, aud

    def _targets(self, batch: Mapping[str, Any]) -> torch.Tensor:
        return torch.as_tensor(batch[self.target_key]).to(self.device).long()

    def train_step(self, batch: Mapping[str, Any]) -> Dict[str, float]:
        """One update. Returns loss, grad_norm, accuracy_1 and loss_finite;
        raises on a non-finite loss (stage_sync.py:336)."""
        vis, aud = self.prepare(batch, train=True)
        out = sync_train_step(self.net, self.optimizer, self.schedule, self.step, vis, aud,
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

    # ------------------------------------------------------------------
    def trainable_state_dict(self) -> Dict[str, torch.Tensor]:
        """The trainable modules' entries of the model's state dict (the
        JAX payload's ``trainable`` subtree), buffers included: a trainable
        legacy tower's BatchNorm running statistics, which its train steps
        update."""
        keys = self.trainable_keys
        return {k: v for k, v in self.model.state_dict().items() if k.split(".", 1)[0] in keys}

    def payload(self, epoch: int, stopper: EarlyStopper) -> Dict[str, Any]:
        """A checkpoint's payload for an exact resume: trainable parameters,
        optimizer state (whole tensors under tensor parallelism), step,
        epoch, early stopper (ref ckpt dict: utils/logger.py:139-160) and
        every data rank's generator states. Every rank calls it."""
        return {"trainable": self.trainable_state_dict(),
                "opt_state": ptensor.optimizer_state_dict(self.optimizer, self.model),
                "step": self.step, "epoch": epoch,
                "stopper": stopper.state_dict(),
                **generator_payload({"device": self.generator, "aug": self.aug_generator})}

    @torch.no_grad()
    def load_trainable(self, state: Mapping[str, torch.Tensor]) -> None:
        """Load the trainable modules' entries; anything else is an error."""
        missing, unexpected = self.model.load_state_dict(state, strict=False)
        own = set(self.trainable_state_dict())
        if unexpected or own & set(missing):
            raise KeyError(f"trainable state does not fit the model: missing "
                           f"{sorted(own & set(missing))[:4]}, unexpected {unexpected[:4]}")

    def open_run(self) -> None:
        """The experiment directory ``logdir`` (the logger: cfg.yaml,
        scalars.jsonl) and its checkpoint store ``ckpt``, opened by ``fit``
        where it is not open; ``fit`` closes the logger at its end. Pinning
        logging.exp_name reuses an existing directory, which resume needs
        (ref: train_utils.py:53-60)."""
        if self.logger is not None:
            return
        log_cfg = self.cfg.get("logging", {})
        self.logger = ExperimentLogger(
            log_cfg.get("logdir", "./logs/sync_models"), exp_name=log_cfg.get("exp_name"),
            cfg=self.cfg if isinstance(self.cfg, dict) else None,
            log_code_state=bool(log_cfg.get("log_code_state", False)),
            use_wandb=bool(log_cfg.get("use_wandb", False)))
        self.logdir = self.logger.logdir
        self.ckpt = CheckpointManager(str(self.logdir / "ckpts"))

    def dump_input_reconstruction(self, batch: Mapping[str, Any], tag: str) -> None:
        """Invert the pipeline for the first item and write what the model
        actually ingests (ref: train_sync.py:166-173, utils/logger.py:162-242).
        Observability only: never fatal. Rank 0 only."""
        if not pdist.is_master():
            return
        try:
            from synchformer_tpu_torch.utils.viz import save_input_reconstruction

            pcm = torch.as_tensor(batch["audio"][0]).float().cpu()
            spec = log_mel_spectrogram(pcm, self.mel_cfg).transpose(-1, -2).numpy()
            video = torch.as_tensor(batch["video"][0]).cpu().numpy()
            save_input_reconstruction(video, spec, str(self.logdir / "recon"), prefix=tag)
        except Exception as e:
            logging.warning(f"input reconstruction failed: {e}")

    def run_phase(self, loader, epoch: int, phase: str) -> Dict[str, Any]:
        """One pass over ``loader``: 'train' steps with telemetry, returning
        the mean loss, accuracy_1 and samples/s; otherwise the eval steps'
        logits and targets (the wrap-around items of the last batch
        dropped by pad_mask) through the full metric suite."""
        loader.set_epoch(epoch)
        if phase == "train":
            meters = {"loss": Meter(), "accuracy_1": Meter(), "samples_per_sec": Meter()}
            n_iters = max(len(loader), 1)
            # per-iteration Data(t)/Batch(t) telemetry at log_frequency
            # (ref: scripts/train_sync.py:219-228; the Stage I meter set)
            data_m, batch_m = Meter(), Meter()
            t0 = time.perf_counter()
            for i, batch in enumerate(loader):
                data_t = time.perf_counter() - t0
                if i == 0 and epoch == 0:
                    self.dump_input_reconstruction(batch, f"{phase}_e{epoch}")
                metrics = self.train_step(batch)
                n = len(batch["video"])
                dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                meters["loss"].update(metrics["loss"])
                meters["accuracy_1"].update(metrics["accuracy_1"])
                meters["samples_per_sec"].update(n * pdist.n_data() / dt)
                data_m.update(data_t)
                batch_m.update(dt)
                if self.step % self.log_frequency == 0:
                    samples_per_s = n * pdist.n_data() / max(batch_m.avg, 1e-9)
                    lr_now = float(self.schedule(self.step))
                    logging.info(
                        f"Train Epoch: {epoch} [{(i + 1) * n}/{n_iters * n}] "
                        f"Data (t): {data_m.avg:.3f} Batch (t): {batch_m.avg:.3f}, "
                        f"{samples_per_s:#.4g}/s LR: {lr_now:.3g} Loss: {metrics['loss']:#.5g}")
                    self.logger.log_dict(
                        {"data_time": data_m.avg, "batch_time": batch_m.avg,
                         "samples_per_s": samples_per_s, "lr": lr_now,
                         "loss_iter": metrics["loss"]}, self.step, prefix="train/")
                    data_m, batch_m = Meter(), Meter()  # per-window meters
            return {k: m.avg for k, m in meters.items()}
        logits, targets = self._eval_pass(loader)
        metrics = calc_cls_metrics(targets, logits, topk=(1, 5) if self.num_cls > 2 else (1,),
                                   calc_pr_rec_f1=self.num_cls == 2)
        metrics["per_class"] = per_class_accuracy(targets, logits)
        return metrics

    def _eval_pass(self, loader):
        """Every data rank's logits and targets over its shard of ``loader``
        (the wrap-around items dropped), concatenated in data order."""
        all_logits, all_targets = [], []
        for batch in loader:
            mask = np.asarray(batch.get("pad_mask", np.ones(len(batch["video"]), bool)))
            out = self.eval_step(batch)
            all_logits.append(out["logits"].cpu().numpy()[mask])
            all_targets.append(np.asarray(batch[self.target_key])[mask])
        gathered = gather_dict({"logits": np.concatenate(all_logits),
                                "targets": np.concatenate(all_targets)})
        return gathered["logits"], gathered["targets"]

    def maybe_resume(self, stopper: EarlyStopper) -> int:
        """Resume / fine-tune (ref: scripts/train_sync.py:68-99,
        train_utils.py:251-290). training.resume with a latest checkpoint in
        this run restores the trainable parameters, optimizer, step, the
        generators and the early stopper; training.finetune from
        training.ckpt_path (a ``.pt`` or a run of the port's
        CheckpointManager: a ``best`` / ``latest`` store, or an experiment or
        ``ckpts`` directory, whose latest is read) merges its trainable
        parameters non-strictly (finetune_from: fresh heads stay, the sync
        pos-emb trimmed) and resets the counters. Returns the first epoch."""
        training = self.cfg.get("training", {})
        ckpt_path = training.get("ckpt_path")
        if training.get("resume") and self.ckpt.latest_step() is not None:
            payload = self.ckpt.restore_latest()
            self.load_trainable(payload["trainable"])
            ptensor.load_optimizer_state_dict(self.optimizer, self.model, payload["opt_state"])
            self.step = int(payload["step"])
            restore_generators({"device": self.generator, "aug": self.aug_generator},
                               payload, {"device": self.seed, "aug": self.seed + 7},
                               int(payload["epoch"]) + 1)
            stopper.load_state_dict(payload["stopper"])
            logging.info(f"resumed from epoch {int(payload['epoch'])} "
                         "(params + optimizer + early-stopper state)")
            return int(payload["epoch"]) + 1
        if training.get("finetune") and ckpt_path:
            source = (load_run_checkpoint(ckpt_path)["trainable"] if Path(ckpt_path).is_dir()
                      else ckpt_path)
            self.finetune_from(source)
            logging.info(f"finetuning from {ckpt_path} (counters reset)")
            self._log_finetune_cfg_diff(ckpt_path)
        return 0

    def _log_finetune_cfg_diff(self, ckpt_path) -> None:
        """Diff the fine-tuning run's saved cfg against the current one into
        cfg_diffs.diff beside it (ref: scripts/train_sync.py:86): the first
        cfg.yaml in ckpt_path's parent or the two above (a checkpoint store
        sits two levels under its experiment directory)."""
        import yaml

        from synchformer_tpu_torch.utils.logger import show_cfg_diffs

        parents = Path(ckpt_path).absolute().parents
        found = [p for p in list(parents)[:3] if (p / "cfg.yaml").exists()]
        if not found or not isinstance(self.cfg, dict) or not pdist.is_master():
            return
        try:
            with open(found[0] / "cfg.yaml") as f:
                old_cfg = yaml.safe_load(f)
            show_cfg_diffs(old_cfg, self.cfg, str(found[0] / "cfg_diffs.diff"))
        except Exception as e:  # observability only
            logging.warning(f"could not write finetune cfg diff: {e}")

    def _maybe_profile(self, epoch: int):
        """torch.profiler over the first training epoch where training.trace
        is set (the JAX trainer's jax.profiler trace), its chrome trace
        written to ``<logdir>/profile/trace_e0.json``; rank 0 only."""
        if not (self.cfg.get("training", {}).get("trace") and epoch == 0
                and pdist.is_master()):
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        out = self.logdir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities, on_trace_ready=lambda p: p.export_chrome_trace(
            str(out / f"trace_e{epoch}.json")))

    def _loader(self, ds, num_workers: int, train: bool, decode_backend) -> StagedLoader:
        kwargs = {} if train else {"shuffle": False, "drop_last": False}
        return StagedLoader(SyncDataLoader(ds, self.pipe_cfg, self.local_batch, num_workers,
                                           self.seed, decode_backend=decode_backend,
                                           process_index=pdist.data_rank(),
                                           process_count=pdist.n_data(), **kwargs),
                            device=self.device)

    def fit(self, train_ds, valid_ds, test_ds=None, num_workers: int = 6, iter_times: int = 1,
            max_epochs: Optional[int] = None, decode_backend: Optional[str] = None
            ) -> Dict[str, Any]:
        """Train for training.num_epochs (or ``max_epochs``) epochs from the
        first not yet trained, each followed by validation, early stopping
        and checkpoints; then, with ``test_ds``, the test phase over
        ``iter_times`` passes. Returns {"best_valid": ..., "test": ...}."""
        self.open_run()
        loaders = {"train": self._loader(train_ds, num_workers, True, decode_backend),
                   "valid": self._loader(valid_ds, num_workers, False, decode_backend)}
        stopper = EarlyStopper(self.patience, to_max=True)
        start_epoch = self.maybe_resume(stopper)
        epochs = max_epochs if max_epochs is not None else self.num_epochs
        if self.run_test_only:
            # evaluation only (ref: cfg.training.run_test_only): the best
            # checkpoint's parameters where there is one, then the test
            epochs = 0
            if self.ckpt.best_step() is not None:
                self.load_trainable(self.ckpt.restore_best()["trainable"])
                logging.info(f"run_test_only: restored best ckpt (epoch {self.ckpt.best_step()})")
        best_metrics: Dict[str, Any] = {}
        try:
            for epoch in range(start_epoch, epochs):
                drawn_before = dict(self.aug_drawn)
                with self._maybe_profile(epoch):
                    train_metrics = self.run_phase(loaders["train"], epoch, "train")
                self.logger.log_dict(train_metrics, epoch, prefix="train/")
                for name in AUG_CHAIN:
                    self.logger.log_scalar(f"train/aug_steps_{name}",
                                           self.aug_drawn[name] - drawn_before[name], epoch)
                valid_metrics = self.run_phase(loaders["valid"], epoch, "valid")
                self.logger.log_dict(valid_metrics, epoch, prefix="valid/")
                self.logger.append_results("valid", {"epoch": epoch, **{
                    k: v for k, v in valid_metrics.items() if isinstance(v, float)}})
                monitored = valid_metrics[self.metric_name]
                improved = stopper.update(monitored)
                # latest after every epoch for crash-resume, best on
                # improvement (ref: train_sync.py:257-267)
                payload = self.payload(epoch, stopper)
                self.ckpt.save_latest(epoch, payload)
                if improved:
                    best_metrics = dict(valid_metrics)
                    self.ckpt.save_best(epoch, payload, metrics={"best_metric": float(monitored)})
                if stopper.triggered:
                    logging.info(f"early stop at epoch {epoch} "
                                 f"(best {self.metric_name}={stopper.best:.4f})")
                    break
            results: Dict[str, Any] = {"best_valid": best_metrics}
            if test_ds is not None:
                test_loader = self._loader(test_ds, num_workers, False, decode_backend)
                # iter_times: repeated passes over small eval sets
                # (ref: train_sync.py:291-395)
                passes = []
                for it in range(iter_times):
                    test_loader.set_epoch(it)
                    passes.append(self._eval_pass(test_loader))
                logits = np.concatenate([p[0] for p in passes])
                targets = np.concatenate([p[1] for p in passes])
                test_metrics = calc_cls_metrics(
                    targets, logits, topk=(1, 5) if self.num_cls > 2 else (1,),
                    calc_pr_rec_f1=self.num_cls == 2)
                self.logger.log_test_metrics(test_metrics)
                self._dump_test_plots(targets, logits)
                results["test"] = test_metrics
        finally:
            self.logger.close()
            self.logger = None
        return results

    def _dump_test_plots(self, targets: np.ndarray, logits: np.ndarray) -> None:
        """Per-class accuracy bars + pred/target histograms for the test
        phase (ref: scripts/train_utils.py:440-563). Observability only.
        Rank 0 only."""
        if not pdist.is_master():
            return
        try:
            from synchformer_tpu_torch.utils.viz import (
                plot_per_class_accuracy,
                plot_pred_target_hist,
            )

            plots = self.logdir / "plots"
            plot_per_class_accuracy(per_class_accuracy(targets, logits),
                                    str(plots / "test_per_class_accuracy.png"))
            plot_pred_target_hist(targets, np.argmax(logits, -1), self.num_cls,
                                  str(plots / "test_pred_target_hist.png"))
        except Exception as e:  # never kill a finished run over a plot
            logging.warning(f"test-phase plots failed: {e}")


def train(cfg: Mapping[str, Any], device="cuda", **fit_kwargs) -> Dict[str, Any]:
    """Entry point mirroring ref scripts/train_sync.py:train(cfg): the
    trainer on ``device`` and the train / valid / test splits of the dataset
    named by data.dataset."""
    trainer = SyncTrainer(cfg, device=device)
    data_cfg = cfg.get("data", {})
    ds_cfg = data_cfg.get("dataset", {})
    datasets = {split: instantiate_from_config(ds_cfg, split=split,
                                               vids_dir=data_cfg.get("vids_path"))
                for split in ("train", "valid", "test")}
    training = cfg.get("training", {})
    fit_kwargs.setdefault("iter_times", int(training.get("iter_times", 1)))
    fit_kwargs.setdefault("num_workers", int(training.get("num_workers", 6)))
    return trainer.fit(datasets["train"], datasets["valid"], datasets["test"], **fit_kwargs)
