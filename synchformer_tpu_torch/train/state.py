"""LR schedules, optimizers and the Stage II/III trainable split
(synchformer_tpu/train/state.py).

- ``make_lr_schedule``: Stage I's 'const' and 'cosine' with the reference's
  warm-up lr(s) = base * (s + 1) / warmup, and Stage II/III's 'constant' and
  'constant_with_warmup' (base / 100 rising linearly to base over the
  warm-up), plain ports of make_lr_schedule's optax schedules (state.py:40-93),
  step by step.
- ``make_adamw``: AdamW whose weight decay skips parameters with ndim < 2
  (gains, biases, the 0-d logit scale), as adamw_no_decay_mask. torch's
  AdamW decays p by lr * wd * p and steps by lr * m^ / (sqrt(v^) + eps), the
  update optax.adamw makes.
- ``make_optimizer``: Stage II/III's 'adam', 'adamw' (decay on every
  parameter, as the JAX trainer passes no mask) and 'sgd' with momentum
  (optax.sgd's trace: the first step moves by lr * g), over the parameters
  that need a gradient; the clip is ``clip_grads_by_global_norm_``.
- ``SYNC_TRAINABLE_KEYS`` / ``set_trainable``: the frozen / trainable split
  of state.py:24-37 as requires_grad flags on the port's module names.
- ``clip_grads_by_global_norm_``: optax.clip_by_global_norm, g * max / max(norm,
  max), not clip_grad_norm_'s max / (norm + 1e-6). Under tensor
  parallelism (parallel/tensor.py) the norm is the whole gradient's: a
  shard's squares are summed over its model group, a replicated leaf's
  counted once, so that every model peer clips alike.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence

import torch

from synchformer_tpu_torch.parallel import dist as pdist

Schedule = Callable[[int], float]


def _ref_warmup(base_lr: float, warmup_steps: int) -> Schedule:
    """optax.linear_schedule(base / warmup, base, max(warmup - 1, 1))."""
    init, span = base_lr / warmup_steps, max(warmup_steps - 1, 1)

    def lr(step: int) -> float:
        frac = min(max(step, 0), span) / span
        return init + (base_lr - init) * frac

    return lr


def _cosine(base_lr: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule(base, decay_steps) with alpha 0."""

    def lr(step: int) -> float:
        frac = min(max(step, 0), decay_steps) / decay_steps
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))

    return lr


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules: the second schedule restarts its count at the
    boundary."""
    return lambda step: first(step) if step < boundary else second(step - boundary)


def make_lr_schedule(name: str, base_lr: float, warmup_steps: int = 0,
                     total_steps: Optional[int] = None) -> Schedule:
    """step -> lr. Stage I: 'const' (warm-up, then flat) and 'cosine'
    (warm-up, then cosine decay to 0 over the remaining steps). Stage II/III:
    'constant' and 'constant_with_warmup' (optax.linear_schedule(base / 100,
    base, warmup), then flat)."""
    if name == "constant":
        return lambda step: base_lr
    if name == "constant_with_warmup":
        if warmup_steps <= 0:
            return lambda step: base_lr
        init = base_lr / 100.0

        def warm(step: int) -> float:
            frac = min(max(step, 0), warmup_steps) / warmup_steps
            return init + (base_lr - init) * frac

        return _join(warm, lambda step: base_lr, warmup_steps)
    if name == "const":
        if warmup_steps <= 0:
            return lambda step: base_lr
        return _join(_ref_warmup(base_lr, warmup_steps), lambda step: base_lr, warmup_steps)
    if name == "cosine":
        if total_steps is None:
            raise ValueError("the cosine schedule needs total_steps")
        cos = _cosine(base_lr, max(total_steps - warmup_steps, 1))
        if warmup_steps <= 0:
            return cos
        return _join(_ref_warmup(base_lr, warmup_steps), cos, warmup_steps)
    raise ValueError(f"unknown lr schedule {name!r}")


def make_adamw(named_params: Iterable, weight_decay: float,
               betas=(0.9, 0.999), eps: float = 1e-8) -> torch.optim.AdamW:
    """AdamW over two groups: ndim >= 2 decayed, the rest not. The learning
    rate is set per step by the caller (``set_lr``)."""
    decay, no_decay = [], []
    for _, p in named_params:
        if p.requires_grad:
            (decay if p.ndim >= 2 else no_decay).append(p)
    return torch.optim.AdamW([{"params": decay, "weight_decay": weight_decay},
                              {"params": no_decay, "weight_decay": 0.0}],
                             lr=0.0, betas=betas, eps=eps)


# Stage II/III: the modules that train (JAX a_proj, v_proj, sync_transformer;
# ref configs/sync.yaml: the extractors' is_trainable is false)
SYNC_TRAINABLE_KEYS = ("aproj", "vproj", "transformer")


def set_trainable(model: torch.nn.Module, keys: Sequence[str]) -> None:
    """requires_grad on the parameters of the top-level modules named in
    ``keys``, off everywhere else."""
    keys = tuple(keys)
    for name, p in model.named_parameters():
        p.requires_grad_(name.split(".", 1)[0] in keys)


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter], betas=(0.9, 0.999),
                   momentum: float = 0.9, weight_decay: float = 0.0,
                   eps: float = 1e-8) -> torch.optim.Optimizer:
    """Stage II/III's optimizers over ``params`` (those that need a
    gradient); the rate is set per step (``set_lr``)."""
    params = [p for p in params if p.requires_grad]
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=tuple(betas), eps=eps)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=tuple(betas), eps=eps,
                                 weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum)
    raise ValueError(f"unknown optimizer {name!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def global_norm(grads: Sequence[torch.Tensor],
                sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """sqrt(sum of squares) over every gradient, in f32 (optax.global_norm).
    ``sharded`` marks the gradients that are shards of the model group's
    whole gradient (parallel/tensor.py): each one's norm is the whole
    tensor's, its squares summed over the group in model order (the same sum
    on every peer)."""
    norms = [torch.linalg.vector_norm(g.float()) for g in grads]
    idx = [i for i, s in enumerate(sharded or ()) if s]
    if idx and pdist.n_model() > 1:
        squares = torch.stack([norms[i] for i in idx]).square()
        whole = pdist.gather_rows(squares[None], pdist.model_group()).sum(0).sqrt()
        for j, i in enumerate(idx):
            norms[i] = whole[j]
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def clip_grads_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                               sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Scale the gradients in place by max_norm / max(norm, max_norm);
    returns the norm before clipping (global_norm, ``sharded`` as there)."""
    norm = global_norm(grads, sharded)
    factor = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm
