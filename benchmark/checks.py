"""The comparison that decides ``correct``: the numbers read from what the
timed path produced against the plain reference's, each against the limit
the cell's workload file sets (``limits``).

- Offline inference (``logit_rms``): every answer the window delivered is
  compared with the reference's answer to the same clips. Both sides'
  log-probabilities are centred per clip (the logits up to a constant);
  per pooled batch, the root mean square of the gap over its answers, over
  the norm of the reference's centred values; the reading is the widest
  batch. (The widest single gap, ``logit_gap``, swings too much from seed to
  seed to separate bf16 from float8: PERF.md.)
- Training (``loss_gap``, ``grad_gap``, ``grad_median_gap``,
  ``change_gap``): the program's first three steps against the reference's
  from the same weights, batches and draws: each step's loss (the widest
  gap over the reference's loss); the first gradient as the optimizer
  received it, per leaf; each leaf's change over the three steps. A leaf's
  gap is the gap between the two norms over the larger of the reference's
  norm of that leaf and of the median leaf; the readings are the worst
  leaf and, for the gradient, the median leaf (the worst is often one
  small leaf, the 0-d logit scale, whose bf16 rounding swings from seed to
  seed: PERF.md). Leaves whose reference gradient is under a thousandth of
  the median leaf's (moved by round-off alone, as a key's bias under
  softmax) are left out of the change.

The cell's workload file names the numbers it compares, each with its
limit.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

SMALL_GRADIENT = 1e-3  # of the median leaf's: left out of the change


def centred_logp(probs: torch.Tensor) -> torch.Tensor:
    lp = torch.log(probs.double().clamp(min=1e-300))
    return lp - lp.mean(dim=-1, keepdim=True)


def logit_gap(answers: List[torch.Tensor], ref_probs: torch.Tensor) -> float:
    """answers: the program's (B, C) probabilities for one batch, each
    delivered once; ref_probs: the reference's for that batch."""
    ref = centred_logp(ref_probs)
    scale = float(ref.std())
    gap = max(float((centred_logp(a) - ref).abs().max()) for a in answers)
    return gap / scale


def logit_rms(answers: List[torch.Tensor], ref_probs: torch.Tensor) -> float:
    """The relative L2 gap of the centred log-probabilities over every
    answer to one batch."""
    ref = centred_logp(ref_probs)
    sq = sum(float(((centred_logp(a) - ref) ** 2).sum()) for a in answers)
    return (sq / len(answers)) ** 0.5 / float(ref.norm())


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    return max(leaf_gaps(prog, ref, names).values())


def norms_rms(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    """The relative L2 gap of the vector of leaf norms."""
    num = sum((prog[k] - ref[k]) ** 2 for k in names)
    return (num / sum(ref[k] ** 2 for k in names)) ** 0.5


def _moved(ref: dict) -> tuple:
    names = sorted(ref["grad"])
    med = statistics.median(ref["grad"][k] for k in names)
    return names, [k for k in names if ref["grad"][k] >= SMALL_GRADIENT * med]


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    """prog / ref: {"losses": [...], "grad": {leaf: norm}, "change": {leaf:
    norm}}."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    names, moved = _moved(ref)
    grad = leaf_gaps(prog["grad"], ref["grad"], names)
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "grad_median_gap": statistics.median(grad.values()),
            "change_gap": leaf_gap(prog["change"], ref["change"], moved)}


def train_detail(prog: dict, ref: dict) -> dict:
    """What lies behind train_readings: each step's loss gap, the three
    worst leaves of the gradient and of the change, the median leaf's gap
    and the relative L2 gap of the leaf norms."""
    names, moved = _moved(ref)
    out = {"loss_gaps": [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]}
    for key, keys in (("grad", names), ("change", moved)):
        gaps = leaf_gaps(prog[key], ref[key], keys)
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        out[f"{key}_worst"] = worst
        out[f"{key}_median_gap"] = statistics.median(gaps.values())
        out[f"{key}_rms"] = norms_rms(prog[key], ref[key], keys)
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: each read and at or under its limit; a number not read, a
    limit not set, or a reading that is not finite fails."""
    out, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        ok = ok and limit is not None and value == value and value <= limit
        out[name] = {"value": value, "limit": limit}
    return ok, out
