"""Syncability evaluation, optionally tiered with the offset model
(synchformer_tpu/train/syncability_eval.py), in numpy.

- ``roc_outputs``: the one-vs-rest mean ROC-AUC of the syncability logits and
  the binary ROC curve of the syncable class (sklearn's ``drop_intermediate``
  rule, train/metrics.py::roc_curve);
- ``tiered_offset_metrics``: for each confidence threshold, the offset
  metrics of the clips the syncability model calls syncable, with the
  target of each clip it wrongly calls syncable swapped to (pred + 5) % C so
  that even the one-class tolerance cannot score it;
- ``evaluate_syncability``: both over any iterable of batches, each a dict
  with ``video``, ``audio``, ``sync_target`` (and ``offset_target`` where
  tiered) and optionally ``pad_mask``; the syncability model sees the first
  ``n_segments_sync`` segments;
- ``filter_too_short_videos``: the reference protocol's exclusion of ten
  VGGSound test videos shorter than 9.6 s (JAX :32-57).
"""
from __future__ import annotations

import logging
import pickle
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from synchformer_tpu_torch.train.metrics import calc_cls_metrics, roc_auc, roc_curve

CONF_THRESHOLDS = (0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99)

# The reference's eval protocol hardcodes 10 VGGSound test videos shorter
# than 9.6 s and drops them before building the loader
# (ref: scripts/test_syncability.py:113-125, applied at :224-226).
VIDEO_IDS_SHORTER_THAN_9_6_SEC = frozenset({
    "-7tYmeOmsRg_180000_190000.mp4",
    "1_Q80fDGLRM_10000_20000.mp4",
    "8qsCZLEoA1Q_4000_14000.mp4",
    "F9bJVVYgFl4_73000_83000.mp4",
    "KQAR_64a35I_11000_21000.mp4",
    "TgJHM5oSWio_8000_18000.mp4",
    "U9PyY8Ldf9A_5000_15000.mp4",
    "aUfDxRelPHg_22000_32000.mp4",
    "cLpDBj--as0_8000_18000.mp4",
    "cRT5SWbyA54_4000_14000.mp4",
})


def filter_too_short_videos(dataset) -> int:
    """Drop the reference protocol's too-short-video exclusion list from a
    dataset's records in place; returns how many were removed
    (ref: scripts/test_syncability.py:224-226)."""
    before = len(dataset.records)
    dataset.records = [r for r in dataset.records
                       if Path(r.path).name not in VIDEO_IDS_SHORTER_THAN_9_6_SEC]
    removed = before - len(dataset.records)
    if removed:
        logging.info(f"filtered {removed} too-short (<9.6 s) videos from the eval set")
    return removed


def _softmax(x):
    z = x - x.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def roc_outputs(logits_sync: np.ndarray, targets_sync: np.ndarray,
                save_path: Optional[str] = None) -> Dict:
    """{'fpr', 'tpr', 'thresholds', 'roc_curve_sc'}; pickled to ``save_path``
    where given."""
    probs = _softmax(logits_sync)
    n, num_cls = logits_sync.shape
    onehot = np.zeros((n, num_cls))
    onehot[np.arange(n), targets_sync] = 1
    aucs = [roc_auc(onehot[:, c], probs[:, c]) for c in range(num_cls)]
    fpr, tpr, thresholds = roc_curve(targets_sync, probs[:, 1])
    out = {"fpr": fpr, "tpr": tpr, "thresholds": thresholds,
           "roc_curve_sc": float(np.mean(aucs))}
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        with open(save_path, "wb") as f:
            pickle.dump(out, f)
        logging.info(f"saved ROC curve to {save_path}")
    return out


def tiered_offset_metrics(logits_sync: np.ndarray, targets_sync: np.ndarray,
                          logits_off: np.ndarray, targets_off: np.ndarray,
                          conf_thresholds=CONF_THRESHOLDS) -> Dict[float, Optional[Dict]]:
    """Threshold -> the offset metrics (rounded to 4 places) of the clips
    whose syncable probability exceeds it, or None where no clip does."""
    probs_syncable = _softmax(logits_sync)[:, 1]
    num_cls = logits_off.shape[-1]
    out: Dict[float, Optional[Dict]] = {}
    for t in conf_thresholds:
        mask = probs_syncable > t
        if mask.sum() == 0:
            out[t] = None
            continue
        ls, ts = logits_sync[mask], targets_sync[mask]
        lo, to = logits_off[mask], targets_off[mask].copy()
        wrong_sync = ls.argmax(-1) != ts
        fake = (lo.argmax(-1) + 5) % num_cls
        to[wrong_sync] = fake[wrong_sync]
        out[t] = {k: round(v, 4) for k, v in calc_cls_metrics(to, lo, verbose=False).items()}
    return out


def evaluate_syncability(eval_sync: Callable, batches: Iterable[Dict],
                         eval_off: Optional[Callable] = None, iter_times: int = 1,
                         n_segments_sync: int = 13, logdir: Optional[str] = None,
                         phase: str = "test") -> Dict:
    """``eval_sync`` / ``eval_off``: batch dict (video, audio) -> (B, C)
    logits (array or tensor). ``iter_times`` passes over ``batches`` (its
    ``set_epoch(i)`` is called where it has one). Returns n_evaluated, roc,
    metrics_sync and, with ``eval_off``, the tiered metrics; with ``logdir``
    the ROC curve (and the tiered metrics) are pickled there. The evaluated
    rows' f32 logits and targets come back too (``logits_sync``,
    ``targets_sync``; with ``eval_off``, ``logits_off``, ``targets_off``)."""
    logits_s, targets_s, logits_o, targets_o = [], [], [], []
    for it in range(iter_times):
        if hasattr(batches, "set_epoch"):
            batches.set_epoch(it)
        for batch in batches:
            keep = np.asarray(batch.get("pad_mask", np.ones(len(batch["video"]), dtype=bool)),
                              dtype=bool)
            sync_batch = {"video": batch["video"][:, :n_segments_sync],
                          "audio": batch["audio"][:, :n_segments_sync]}
            logits_s.append(_numpy(eval_sync(sync_batch))[keep])
            targets_s.append(_numpy(batch["sync_target"])[keep])
            if eval_off is not None:
                logits_o.append(_numpy(eval_off({"video": batch["video"],
                                                 "audio": batch["audio"]}))[keep])
                targets_o.append(_numpy(batch["offset_target"])[keep])
    logits_sync = np.concatenate(logits_s)
    targets_sync = np.concatenate(targets_s)
    out: Dict = {"n_evaluated": int(len(targets_sync)), "logits_sync": logits_sync,
                 "targets_sync": targets_sync}
    out["roc"] = roc_outputs(logits_sync, targets_sync,
                             None if logdir is None else str(Path(logdir) / f"roc_{phase}.pkl"))
    out["metrics_sync"] = {k: round(v, 4) for k, v in calc_cls_metrics(
        targets_sync, logits_sync, topk=(1,), verbose=False).items()}
    if eval_off is not None:
        out["logits_off"], out["targets_off"] = np.concatenate(logits_o), np.concatenate(targets_o)
        out["tiered"] = tiered_offset_metrics(logits_sync, targets_sync, out["logits_off"],
                                              out["targets_off"])
        if logdir is not None:
            with open(Path(logdir) / f"metrics_{phase}.pkl", "wb") as f:
                pickle.dump(out["tiered"], f)
    return out


def _numpy(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu() if x.is_floating_point() else x.detach().cpu()
        return x.numpy()
    return np.asarray(x)
