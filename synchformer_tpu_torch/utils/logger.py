"""Experiment logging: TensorBoard, config backup, code snapshot, meters (the
port's copy of synchformer_tpu/utils/logger.py).

Capability parity with ref: utils/logger.py (LoggerWithTBoard) —
- experiment dir  logs/<logdir>/<start_time> where start_time is shifted by a
  random −60 s to avoid collisions (ref: scripts/train_utils.py:77-80)
- config backup + code-state snapshot with ignore patterns (ref:
  utils/logger.py:62-76)
- scalar/epoch logging to scalars.jsonl, with tensorboardX and wandb
  optional (imported where used; a missing one is logged and skipped), test
  metrics as hparams
- throughput meters (data-time / batch-time / samples-per-sec, ref:
  scripts/train_sync.py:219-228)
- over ranks, rank 0 alone writes (``is_master``), and the experiment
  directory's name is rank 0's on every rank (experiment_id is a timestamp,
  which can differ between ranks by a second)
"""
from __future__ import annotations

import json
import logging
import random
import shutil
import time
from datetime import datetime, timedelta
from pathlib import Path
from typing import Dict, Optional

import yaml

from synchformer_tpu_torch.parallel import dist as pdist


def show_cfg_diffs(old_cfg: Dict, new_cfg: Dict,
                   save_path: Optional[str] = None) -> list:
    """Unified diff of two config dicts rendered as YAML; printed, or written
    to `save_path` (the reference saves `cfg_diffs.diff` next to the ckpt when
    fine-tuning, ref: utils/utils.py:193-204 + scripts/train_sync.py:86)."""
    import difflib

    a = yaml.safe_dump(old_cfg, sort_keys=True).split("\n")
    b = yaml.safe_dump(new_cfg, sort_keys=True).split("\n")
    lines = list(difflib.unified_diff(a, b, fromfile="old", tofile="new",
                                      lineterm=""))
    if save_path is None:
        for line in lines:
            print(line)
    else:
        Path(save_path).write_text("\n".join(lines) + "\n")
        logging.info(f"Config diff (current vs fine-tuning ckpt) saved to "
                     f"{save_path}")
    return lines


def experiment_id(now: Optional[datetime] = None) -> str:
    """Timestamp id with a random backward shift (ref: train_utils.py:77-80)."""
    now = now or datetime.now()
    now -= timedelta(seconds=random.randint(0, 60))
    return now.strftime("%y-%m-%dT%H-%M-%S")


class Meter:
    """Running average meter (data/batch time, samples/sec)."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class ExperimentLogger:
    def __init__(self, logdir: str, exp_name: Optional[str] = None,
                 cfg: Optional[Dict] = None, log_code_state: bool = True,
                 is_master: Optional[bool] = None, use_wandb: bool = False,
                 patterns_to_ignore=("logs", ".git", "__pycache__", "data", "*.pt",
                                     "sbatch_logs", "*.mp4", "*.wav", "*.jpg",
                                     "*.gif", "misc*")):
        self.is_master = pdist.is_master() if is_master is None else is_master
        self.exp_name = pdist.broadcast_object(exp_name or experiment_id())
        self.logdir = Path(logdir) / self.exp_name
        self._writer = None
        self._wandb = None
        if not self.is_master:
            return
        self.logdir.mkdir(parents=True, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter

            self._writer = SummaryWriter(str(self.logdir))
        except ImportError:
            logging.warning("tensorboardX unavailable; scalar logs go to jsonl only")
        self._jsonl = open(self.logdir / "scalars.jsonl", "a")
        if cfg is not None:
            with open(self.logdir / "cfg.yaml", "w") as f:
                yaml.safe_dump(cfg, f)
        if log_code_state:
            self._snapshot_code(patterns_to_ignore)
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project="synchformer_tpu_torch", name=self.exp_name,
                           config=cfg, sync_tensorboard=True)
            except ImportError:
                logging.warning("wandb requested but not installed; skipping")

    def _snapshot_code(self, ignore_patterns):
        """Copy the repo state into the experiment dir (ref: logger.py:72-76)."""
        src = Path(__file__).resolve().parents[2]
        dst = self.logdir / "code"
        if dst.exists():
            return
        try:
            shutil.copytree(src, dst, ignore=shutil.ignore_patterns(*ignore_patterns))
        except OSError as e:
            logging.warning(f"code snapshot failed: {e}")

    def log_scalar(self, tag: str, value: float, step: int):
        if not self.is_master:
            return
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step)}) + "\n")
        self._jsonl.flush()

    def log_dict(self, metrics: Dict[str, float], step: int, prefix: str = ""):
        for key, value in metrics.items():
            if isinstance(value, (int, float)):
                self.log_scalar(f"{prefix}{key}", value, step)

    def log_test_metrics(self, metrics: Dict[str, float], hparams: Optional[Dict] = None):
        """Test metrics as hparams (ref: logger.py:127-137)."""
        if not self.is_master:
            return
        if self._writer is not None and hparams:
            flat = {k: v for k, v in hparams.items() if isinstance(v, (int, float, str))}
            numeric = {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
            self._writer.add_hparams(flat, numeric)
        with open(self.logdir / "test_results.json", "w") as f:
            json.dump(metrics, f, indent=2)

    def append_results(self, phase: str, payload: Dict):
        """results_{train,valid}.jsonl per-epoch appends (ref: train.py:250-252)."""
        if not self.is_master:
            return
        with open(self.logdir / f"results_{phase}.jsonl", "a") as f:
            f.write(json.dumps(payload) + "\n")

    def close(self):
        if self._writer is not None:
            self._writer.close()
        if self.is_master:
            self._jsonl.close()


class EarlyStopper:
    """Patience-based early stopping on a monitored metric
    (ref: scripts/train_utils.py:293-327)."""

    def __init__(self, patience: int, to_max: bool = True):
        self.patience = patience
        self.to_max = to_max
        # the reference starts to_max metrics at 0.0, NOT -inf — a first
        # epoch scoring exactly 0.0 counts against patience
        # (ref: train_utils.py:299)
        self.best = 0.0 if to_max else float("inf")
        self.count = 0
        self.triggered = False

    def update(self, metric: float) -> bool:
        """Returns True if this is a new best."""
        improved = metric > self.best if self.to_max else metric < self.best
        if improved:
            self.best = metric
            self.count = 0
        else:
            self.count += 1
            if self.count >= self.patience:
                self.triggered = True
        return improved

    def state_dict(self) -> Dict[str, float]:
        """Persisted in every latest-checkpoint so a crash-resume keeps both
        the best metric AND the patience counter (the reference stores only
        the best metrics, ref: train_sync.py:99 early_stopper.set_best_metrics)."""
        return {"best": float(self.best), "count": int(self.count)}

    def load_state_dict(self, sd: Dict[str, float]) -> None:
        self.best = float(sd["best"])
        self.count = int(sd["count"])
        self.triggered = self.count >= self.patience
