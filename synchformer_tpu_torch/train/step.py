"""The Stage I train and eval steps of AVCLIP (synchformer_tpu/train/step.py::
make_avclip_train_step, make_avclip_eval_step) and of MultilevelMoCoCLIP
(make_moco_train_step, make_moco_eval_step), the zero-shot probe
(synchformer_tpu/train/stage_clip.py::shifted_window_predictions,
zero_shot_precision), and the Stage II/III steps of the Synchformer
(make_sync_train_step, make_sync_eval_step).

One Stage II/III train step: the towers on their eval path (K1-K4 on
impl='kernel', under no_grad where frozen) or, with
extractors_deterministic=False (towers that train), the Stage I training
route; the transformer in training mode (its dropouts drawn from the
generator); the mean f32 cross-entropy; backward into the parameters that
need a gradient; global-norm clipping; the optimizer at the schedule's rate.

One train step: forward with the towers in training mode (drop-path live,
K5 for every divided attention), the contrastive loss, backward (K6 for every
K5 call, the plain compositions for K2, K3 and K4, autograd for the rest),
global-norm clipping, AdamW at the schedule's rate for this step, then the
logit scale clamped in place. The eval step runs the towers deterministically,
so they take the sync-inference kernels K1-K4.

One MoCo step, in the JAX step's order (step.py:140-208): the momentum model's
EMA update first, from the online parameters before the step; the query pass
in training mode and the key pass (the momentum model, deterministic); the
two levels' losses summed; backward into the online parameters only; clip;
AdamW. Unlike the AVCLIP step, no scale is clamped after the update. Then the
keys are written into the queues.

Over ranks each train step takes its model under DDP (parallel/dist.py
wrap_ddp): every rank runs the step on its rows, DDP averages the gradients
over the data ranks during the backward, and then every rank clips and steps
the same averaged gradients, so the parameters stay equal. Under tensor
parallelism (parallel/tensor.py) a rank's sharded parameters are its blocks,
every model peer takes the same rows and draws the same numbers, and the
clip reads the whole gradient's norm. The loss, accuracy and gradient norm in
the metrics are the global batch's (the loss and accuracy averaged over the
data ranks), so that a non-finite loss stops every rank. The attributes (the
logit scale's clamp, MoCo's momentum) are read on the module under the
wrapper.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

import torch.nn.functional as F

from synchformer_tpu_torch.models.avclip import AVCLIP
from synchformer_tpu_torch.models.moco_clip import (
    MoCoQueues,
    MultilevelMoCoCLIP,
    moco_forward,
    momentum_update,
)
from synchformer_tpu_torch.models.sync_model import Synchformer
from synchformer_tpu_torch.parallel import dist as pdist
from synchformer_tpu_torch.parallel import tensor as ptensor
from synchformer_tpu_torch.train.state import (
    Schedule,
    clip_grads_by_global_norm_,
    global_norm,
    set_lr,
)


def avclip_train_step(model: AVCLIP, optimizer: torch.optim.Optimizer, schedule: Schedule,
                      step: int, vis: torch.Tensor, aud: torch.Tensor,
                      generator: torch.Generator, impl: str = "kernel",
                      max_clip_norm: float = 1.0) -> Dict[str, torch.Tensor]:
    """One update of every parameter of ``model`` from normalised patch-major
    frames ``vis`` (B, S, f, n, z*p*p*c) and log-mel ``aud`` (B, S, T, F), both
    in the compute dtype. ``step`` is the update's index (0 first), the
    schedule's argument. ``model`` may be under DDP. Returns loss, grad_norm
    (before clipping), logit_scale (after the clamp) and loss_finite, as
    device tensors."""
    module = pdist.unwrap(model)
    params = [p for p in module.parameters() if p.requires_grad]
    optimizer.zero_grad(set_to_none=True)
    loss, _, _ = model(vis, aud, impl, deterministic=False, generator=generator)
    loss.backward()
    grad_norm = _apply_update(module, params, optimizer, schedule, step, max_clip_norm)
    with torch.no_grad():
        module.logit_scale.clamp_(module.clamp_scale_min, module.clamp_scale_max)
    loss = pdist.all_reduce_mean(loss.detach())
    return {"loss": loss, "grad_norm": grad_norm,
            "logit_scale": module.logit_scale.detach().clone(),
            "loss_finite": torch.isfinite(loss)}


def _apply_update(module, params, optimizer, schedule: Schedule, step: int,
                  max_clip_norm: Optional[float]) -> torch.Tensor:
    """Zero gradients for unused parameters (optax gives them, and they
    decay), clip by global norm (no clip where max_clip_norm is None; the
    norm of the whole gradient where ``module``'s parameters are sharded),
    set the step's rate, step the optimizer; returns the norm before
    clipping."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    sharded = ptensor.sharded_mask(module, params)
    grad_norm = (global_norm(grads, sharded) if max_clip_norm is None
                 else clip_grads_by_global_norm_(grads, max_clip_norm, sharded))
    set_lr(optimizer, schedule(step))
    optimizer.step()
    return grad_norm


def moco_train_step(model: MultilevelMoCoCLIP, model_m: MultilevelMoCoCLIP,
                    queues: MoCoQueues, optimizer: torch.optim.Optimizer, schedule: Schedule,
                    step: int, vis: torch.Tensor, aud: torch.Tensor,
                    generator: torch.Generator, alpha: float, impl: str = "kernel",
                    max_clip_norm: float = 1.0) -> Dict[str, torch.Tensor]:
    """One MoCo update: ``model_m`` and ``queues`` change in place, AdamW
    steps ``model``. Inputs as avclip_train_step's; ``alpha`` is the ALBEF
    soft-target weight. ``model`` may be under DDP; ``model_m`` is not.
    Returns loss (the sum of the levels), each level's loss, grad_norm (before
    clipping) and loss_finite, as device tensors."""
    module = pdist.unwrap(model)
    momentum_update(module, model_m, module.momentum)
    params = [p for p in module.parameters() if p.requires_grad]
    optimizer.zero_grad(set_to_none=True)
    losses, _, _ = moco_forward(model, model_m, queues, vis, aud, impl, generator, alpha,
                                train=True)
    loss = sum(losses.values())
    loss.backward()
    grad_norm = _apply_update(module, params, optimizer, schedule, step, max_clip_norm)
    losses = {k: pdist.all_reduce_mean(v.detach()) for k, v in losses.items()}
    loss = pdist.all_reduce_mean(loss.detach())
    return {"loss": loss, **losses, "grad_norm": grad_norm,
            "loss_finite": torch.isfinite(loss)}


@torch.no_grad()
def moco_eval_step(model: MultilevelMoCoCLIP, model_m: MultilevelMoCoCLIP, queues: MoCoQueues,
                   vis: torch.Tensor, aud: torch.Tensor, window: int,
                   impl: str = "kernel") -> Dict[str, torch.Tensor]:
    """Both passes deterministic: the loss against the queues as they stand
    (no enqueue, alpha 0), the zero-shot precision of the query pass's
    segment features, and those (B, S, D) features in f32."""
    b, s = vis.shape[:2]
    losses, out, _ = moco_forward(model, model_m, queues, vis, aud, impl, train=False)
    vfeat = out["segment_vfeat"].reshape(b, s, -1).float()
    afeat = out["segment_afeat"].reshape(b, s, -1).float()
    return {"loss": sum(losses.values()), "precision": zero_shot_precision(afeat, vfeat, window),
            "afeat": afeat, "vfeat": vfeat}


def shifted_window_predictions(afeat: torch.Tensor, vfeat: torch.Tensor, window: int):
    """Windows of ``window`` segments slid over S; for each audio window the
    most similar video window and vice versa. (B, S, D) each -> two
    (B, S - window + 1) index tensors."""
    b, s, d = afeat.shape
    n_shifts = s - window + 1
    idx = (torch.arange(n_shifts)[:, None] + torch.arange(window)[None, :]).to(afeat.device)
    a_folds = afeat[:, idx].reshape(b, n_shifts, window * d)
    v_folds = vfeat[:, idx].reshape(b, n_shifts, window * d)
    sim = torch.einsum("bnd,bmd->bnm", a_folds, v_folds)
    return sim.argmax(dim=-2), sim.argmax(dim=-1)


def zero_shot_precision(afeat: torch.Tensor, vfeat: torch.Tensor, window: int) -> torch.Tensor:
    """Fraction of windows matched to the in-sync (diagonal) shift, averaged
    over both directions."""
    preds_a, preds_v = shifted_window_predictions(afeat, vfeat, window)
    gt = torch.arange(preds_a.shape[1], device=preds_a.device)[None]
    return ((preds_a == gt).float().mean() + (preds_v == gt).float().mean()) / 2.0


@torch.no_grad()
def avclip_eval_step(model: AVCLIP, vis: torch.Tensor, aud: torch.Tensor, window: int,
                     impl: str = "kernel") -> Dict[str, torch.Tensor]:
    """Deterministic forward: the contrastive loss, the zero-shot precision
    over windows of ``window`` segments, and the f32 (B, S, D) features."""
    b = vis.shape[0]
    loss, vfeat, afeat = model(vis, aud, impl, deterministic=True)
    vfeat = vfeat.reshape(b, -1, vfeat.shape[-1]).float()
    afeat = afeat.reshape(b, -1, afeat.shape[-1]).float()
    return {"loss": loss, "precision": zero_shot_precision(afeat, vfeat, window),
            "afeat": afeat, "vfeat": vfeat}


def sync_train_step(model: Synchformer, optimizer: torch.optim.Optimizer, schedule: Schedule,
                    step: int, vis: torch.Tensor, aud: torch.Tensor, targets: torch.Tensor,
                    generator: torch.Generator, impl: str = "kernel",
                    max_clip_norm: Optional[float] = 1.0,
                    extractors_deterministic: bool = True) -> Dict[str, torch.Tensor]:
    """One Stage II/III update of the parameters of ``model`` that need a
    gradient, from normalised patch-major frames ``vis``, log-mel ``aud``
    (both in the compute dtype) and integer ``targets`` (B,). ``model`` may be
    under DDP. Returns loss, grad_norm (before clipping), accuracy_1 and
    loss_finite, as device tensors."""
    module = pdist.unwrap(model)
    params = [p for p in module.parameters() if p.requires_grad]
    optimizer.zero_grad(set_to_none=True)
    loss, logits = model(vis, aud, targets, impl, deterministic=False, generator=generator,
                         extractors_deterministic=extractors_deterministic)
    loss.backward()
    grad_norm = _apply_update(module, params, optimizer, schedule, step, max_clip_norm)
    with torch.no_grad():
        accuracy = pdist.all_reduce_mean((logits.argmax(-1) == targets).float().mean())
    loss = pdist.all_reduce_mean(loss.detach())
    return {"loss": loss, "grad_norm": grad_norm, "accuracy_1": accuracy,
            "loss_finite": torch.isfinite(loss)}


@torch.no_grad()
def sync_eval_step(model: Synchformer, vis: torch.Tensor, aud: torch.Tensor,
                   targets: torch.Tensor, impl: str = "kernel") -> Dict[str, torch.Tensor]:
    """Deterministic forward: f32 logits, the per-example cross-entropy
    ``loss_vec`` and the targets."""
    _, logits = model(vis, aud, impl=impl)
    logits = logits.float()
    return {"logits": logits, "loss_vec": F.cross_entropy(logits, targets.long(),
                                                          reduction="none"),
            "targets": targets}
