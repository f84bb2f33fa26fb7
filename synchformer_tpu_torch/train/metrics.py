"""Classification metrics (synchformer_tpu/train/metrics.py::calc_cls_metrics,
:38, and per_class_accuracy, :123) in numpy and scipy alone.

The JAX package calls scikit-learn; the port's machine has none, so the
metrics it uses are written here with sklearn's rules:
- ``top_k_accuracy``: multiclass scores ranked by a stable ascending sort
  reversed, so that among tied scores the higher class index ranks first;
  binary (1-D scores of the positive class) predicts 1 where the score
  exceeds 0.5 for scores in [0, 1], else 0, and counts every sample a hit
  for k >= 2;
- ``average_precision``: the step-wise area under the precision-recall
  curve, one point per distinct score (ties form one threshold);
- ``roc_curve`` with ``drop_intermediate`` (points not on a corner of the
  curve dropped) and a first threshold of +inf; ``roc_auc`` the trapezoids
  under it;
- binary ``precision``, ``recall`` and ``f1`` of class 1, 0 where the
  denominator is 0 (zero_division=0).
Non-finite outputs are replaced with random values, as the JAX function
does. ``gather_dict`` is the evaluation's gather over ranks (JAX :135-156).
"""
from __future__ import annotations

import logging
from typing import Dict, Sequence

import numpy as np
from scipy import stats

from synchformer_tpu_torch.parallel import dist as pdist


def _softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def top_k_accuracy(targets: np.ndarray, scores: np.ndarray, k: int) -> float:
    """sklearn.metrics.top_k_accuracy_score with labels 0..C-1: ``scores``
    (N, C), or (N,) for the positive class of a binary problem."""
    targets = np.asarray(targets)
    scores = np.asarray(scores)
    if scores.ndim == 1:
        if k != 1:
            return 1.0
        threshold = 0.5 if scores.min() >= 0 and scores.max() <= 1 else 0
        return float(np.mean((scores > threshold).astype(np.int64) == targets))
    ranked = np.argsort(scores, axis=1, kind="mergesort")[:, ::-1]
    return float(np.mean((targets[None] == ranked[:, :k].T).any(axis=0)))


def _binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray):
    """False and true positives at each distinct score, highest first."""
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[order]
    y_true = (np.asarray(y_true) == 1)[order].astype(np.float64)
    distinct = np.where(np.diff(y_score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[idx]
    fps = 1 + idx - tps
    return fps, tps, y_score[idx]


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """sklearn.metrics.average_precision_score of a binary problem."""
    fps, tps, _ = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.hstack((precision[::-1], 1))
    recall = np.hstack((recall[::-1], 0))
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def roc_curve(y_true: np.ndarray, y_score: np.ndarray, drop_intermediate: bool = True):
    """sklearn.metrics.roc_curve with pos_label 1: (fpr, tpr, thresholds)."""
    fps, tps, thresholds = _binary_clf_curve(y_true, np.asarray(y_score))
    if drop_intermediate and len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0, tps], np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = np.repeat(np.nan, fps.shape) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.repeat(np.nan, tps.shape) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """sklearn.metrics.roc_auc_score of a binary problem; both classes must
    occur."""
    if len(np.unique(y_true)) != 2:
        raise ValueError("ROC AUC needs both classes in y_true")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def _binary_prf(targets: np.ndarray, preds: np.ndarray):
    """Precision, recall and F1 of class 1, 0 where undefined."""
    if not set(np.unique(targets).tolist()) | set(np.unique(preds).tolist()) <= {0, 1}:
        raise ValueError("precision / recall / f1 take a binary problem")
    tp = float(np.sum((preds == 1) & (targets == 1)))
    fp = float(np.sum((preds == 1) & (targets != 1)))
    fn = float(np.sum((preds != 1) & (targets == 1)))
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = 2 * tp / (2 * tp + fp + fn) if 2 * tp + fp + fn > 0 else 0.0
    return precision, recall, f1


def calc_cls_metrics(targets, outputs, topk: Sequence[int] = (1, 5),
                     only_accuracy: bool = False, prefix: str = "",
                     verbose: bool = True, add_doubt_cls: bool = False,
                     calc_tol_accuracy: bool = True,
                     softmaxed_outputs: bool = False,
                     calc_pr_rec_f1: bool = False) -> Dict[str, float]:
    """targets (N,) int; outputs (N, C) logits (or probabilities with
    ``softmaxed_outputs``) -> accuracy@k, accuracy@k within one class
    (``_tol1``; with ``add_doubt_cls`` the last class is left out), and
    unless ``only_accuracy`` one-vs-rest mAP, mROCAUC and d-prime (dummy
    values 0, 0.5, 0 where a class never occurs), with ``calc_pr_rec_f1``
    the binary precision, recall and F1 of the top-1 prediction."""
    if prefix and not prefix.endswith("_"):
        prefix = prefix + "_"
    targets = np.asarray(targets)
    outputs = np.asarray(outputs, dtype=np.float64)
    n, num_cls = outputs.shape
    topk = [min(k, num_cls) for k in topk]
    out: Dict[str, float] = {}

    if not np.isfinite(outputs).all():
        if verbose:
            logging.warning("non-finite logits; replacing with random values "
                            "(reference behavior, ref: train_utils.py:660-663)")
        outputs = np.random.default_rng(0).random(outputs.shape)

    scores = outputs if softmaxed_outputs else _softmax(outputs)
    preds = np.argsort(-outputs, axis=1)[:, : max(topk)]

    for k in topk:
        if num_cls == 2:
            if k == 2:
                continue
            out[f"{prefix}accuracy_{k}"] = top_k_accuracy(targets, scores[:, 1], k)
        else:
            out[f"{prefix}accuracy_{k}"] = top_k_accuracy(targets, scores, k)

    if calc_tol_accuracy:
        if add_doubt_cls:
            num_off_cls = num_cls - 1
            keep = targets != num_cls - 1
            t_tol, p_tol = targets[keep], preds[keep]
        else:
            num_off_cls = num_cls
            t_tol, p_tol = targets, preds
        t_exp = np.broadcast_to(t_tol[:, None], p_tol.shape)
        candidates = np.stack([np.clip(t_exp - 1, 0, num_off_cls - 1), t_exp,
                               np.clip(t_exp + 1, 0, num_off_cls - 1)])
        correct_w_tol = (p_tol[None] == candidates).any(axis=0)
        for k in topk:
            tps = correct_w_tol[:, :k].any(axis=1).sum()
            out[f"{prefix}accuracy_{k}_tol1"] = float(tps / (len(correct_w_tol) + 1e-7))

    if only_accuracy:
        return out

    unique_targets = sorted(set(targets.tolist()))
    if len(unique_targets) < num_cls:
        if verbose:
            logging.warning(f"some classes never occur in targets: {unique_targets}; "
                            "returning dummy mAP/mROCAUC/dprime (reference behavior)")
        out[f"{prefix}mAP"] = 0.0
        out[f"{prefix}mROCAUC"] = 0.5
        out[f"{prefix}dprime"] = 0.0
        return out

    onehot = np.zeros((n, num_cls))
    onehot[np.arange(n), targets] = 1.0
    out[f"{prefix}mAP"] = float(np.mean([average_precision(onehot[:, c], scores[:, c])
                                         for c in range(num_cls)]))
    out[f"{prefix}mROCAUC"] = float(np.mean([roc_auc(onehot[:, c], scores[:, c])
                                             for c in range(num_cls)]))
    out[f"{prefix}dprime"] = float(stats.norm.ppf(out[f"{prefix}mROCAUC"]) * np.sqrt(2))

    if calc_pr_rec_f1:
        p, r, f = _binary_prf(targets, preds[:, 0])
        out[f"{prefix}precision"], out[f"{prefix}recall"], out[f"{prefix}f1"] = p, r, f
    return out


def per_class_accuracy(targets, logits) -> Dict[object, float]:
    """Per-class accuracy of the arg-max prediction, and their median."""
    targets = np.asarray(targets)
    preds = np.asarray(logits).argmax(axis=1)
    accs: Dict[object, float] = {}
    for c in np.unique(targets):
        mask = targets == c
        accs[int(c)] = float((preds[mask] == c).mean())
    accs["median"] = float(np.median([v for k, v in accs.items() if k != "median"]))
    return accs


def gather_dict(results: Dict[str, object]) -> Dict[str, object]:
    """Gather over the data ranks with the reference's reduce semantics
    (ref: train_utils.py:615-629; JAX metrics.py:135-156): lists and arrays
    concatenate in data order along their first axis (ranks may hold
    different numbers of rows: the eval loaders keep their last, short
    shard), ints and floats average unweighted, anything else passes
    through. Model peers hold the same rows and are not counted again. At
    one data rank the identity."""
    if pdist.n_data() == 1:
        return results
    gathered = pdist.all_gather_object(results, pdist.data_group())
    out: Dict[str, object] = {}
    for key, value in results.items():
        values = [g[key] for g in gathered]
        if isinstance(value, (list, np.ndarray)):
            out[key] = np.concatenate([np.asarray(v) for v in values])
        elif isinstance(value, (int, float)):
            out[key] = float(np.mean(values))
        else:
            out[key] = value
    return out
