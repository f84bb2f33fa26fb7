"""MultilevelMoCoCLIP, the MoCo Stage I model (synchformer_tpu/models/
moco_clip.py), and its functional machinery.

The model: the two towers with the AveragePooling time tail and, with
``add_global_repr``, their global segment aggregators; the projections
per level, each its own module built by ``make_vproj`` / ``make_aproj``
(DoNothingBridge by default; the registry builds each from the config's aproj / vproj node, as
the JAX setup instantiates the node once per level); L2-normalised segment (B*S, D) and global (B, D)
features; one 0-d f32 temperature per level, clamped to [clamp_scale_min,
clamp_scale_max] where it is used (``scales``) and never after an update.
State names: ``v_encoder.*`` and ``a_encoder.*`` (the Stage I checkpoint's
prefixes, synchformer_tpu/utils/checkpoint.py:280-310), then the JAX
attribute names: segment_logit_scale, global_logit_scale.

The machinery (model.py:585-883 of the reference, JAX moco_clip.py):
- ``init_queues``: (D, Q) feature queues from a seeded torch.Generator,
  L2-normalised along D (its numbers are not jax.random's);
- ``momentum_update``: the EMA of every parameter, in place over the f32
  masters with torch._foreach_*;
- ``dequeue_and_enqueue``: write a batch of keys at the pointer, in place;
- ``moco_contrastive_loss``: the symmetric InfoNCE against [keys | queue],
  the temperature dividing, with ALBEF soft targets from the momentum
  features;
- ``moco_forward``: one step's query pass, key pass (the momentum model, a
  second copy of the model kept in eval mode, under no_grad), losses and
  queue roll.
The JAX package threads this state through a jitted step; here the queues are
a small mutable record and the momentum model a module, updated in place.

Over ranks (parallel/dist.py) the step is the JAX step over the global batch
(moco_clip.py:17-18, :192-194 there): the momentum keys of every level are
gathered from every data rank in data order; they are both the in-batch
negatives and what goes into the queues, so that every rank's queues stay
identical; the targets sit on the data-rank-offset diagonal of [global keys |
queue]. The query pass (``model``, possibly under DDP) sees this rank's rows
only. Under tensor parallelism the momentum model is sharded as the online
one, and its EMA runs on the shards.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from synchformer_tpu_torch.models.ast_encoder import ASTEncoder
from synchformer_tpu_torch.models.bridges import DoNothingBridge
from synchformer_tpu_torch.models.motionformer import MotionFormerEncoder
from synchformer_tpu_torch.parallel import dist as pdist


# MoCo over the legacy towers, refused where a config names one (registry.py)
LEGACY_MOMENTUM_STATS = (
    "MoCo over the legacy S3D / ResNet-18 towers is not ported (ROADMAP §1 item 7.5): the "
    "JAX momentum_update maps the parameters alone and applies the key towers with "
    "{'params': params_m}, which holds no batch_stats, so the JAX package does not define the "
    "momentum model's BatchNorm statistics")


def l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / max(||x||, 1e-12), the norm in f32, the result in x's dtype."""
    n = torch.linalg.vector_norm(x.float(), dim=dim, keepdim=True)
    return x / n.clamp(min=1e-12).to(x.dtype)


class MultilevelMoCoCLIP(nn.Module):
    def __init__(self, vfeat_extractor: dict, afeat_extractor: dict, d: int = 768,
                 queue_size: int = 1024, momentum: float = 0.995, init_scale: float = 0.07,
                 clamp_scale_min: float = 0.001, clamp_scale_max: float = 0.5,
                 make_vproj: Optional[Callable[[], nn.Module]] = None,
                 make_aproj: Optional[Callable[[], nn.Module]] = None, device=None):
        super().__init__()
        make_vproj = make_vproj or DoNothingBridge
        make_aproj = make_aproj or DoNothingBridge
        self.n_embd = d
        self.queue_size = queue_size
        self.momentum = momentum
        self.init_scale = init_scale
        self.clamp_scale_min = clamp_scale_min
        self.clamp_scale_max = clamp_scale_max
        # each tower d wide unless its keywords name its own width (projected
        # to d by the projections, as the JAX module builds them)
        self.v_encoder = MotionFormerEncoder(**{"embed_dim": d, **vfeat_extractor},
                                             agg_time_module="AveragePooling", device=device)
        self.a_encoder = ASTEncoder(**{"hidden_size": d, **afeat_extractor},
                                    agg_time_module="AveragePooling", device=device)
        self.add_global_repr = self.a_encoder.global_attn_agg is not None
        if self.add_global_repr != (self.v_encoder.global_attn_agg is not None):
            raise ValueError("add_global_repr differs between the towers")
        if self.a_encoder.max_segments != self.v_encoder.max_segments:
            raise ValueError("max_segments differs between the towers")
        self.segment_vproj = make_vproj()
        self.segment_aproj = make_aproj()
        self.segment_logit_scale = nn.Parameter(
            torch.tensor(init_scale, dtype=torch.float32, device=device))
        if self.add_global_repr:
            self.global_vproj = make_vproj()
            self.global_aproj = make_aproj()
            self.global_logit_scale = nn.Parameter(
                torch.tensor(init_scale, dtype=torch.float32, device=device))

    def scales(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        clamp = (self.clamp_scale_min, self.clamp_scale_max)
        glob = self.global_logit_scale.clamp(*clamp) if self.add_global_repr else None
        return self.segment_logit_scale.clamp(*clamp), glob

    def forward(self, vis, aud, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, Optional[torch.Tensor]]:
        """Patch-major frames (B, S, f, n, z*p*p*c) and log-mel (B, S, T, F) ->
        normalised segment (B*S, D) and global (B, D) features (None without
        add_global_repr)."""
        seg_v, glob_v = self.v_encoder.forward_with_global(vis, impl, deterministic, generator)
        seg_a, glob_a = self.a_encoder.forward_with_global(aud, impl, deterministic, generator)
        b, s, d = seg_v.shape
        out = {"segment_vfeat": l2norm(self.segment_vproj(seg_v.reshape(b * s, d))),
               "segment_afeat": l2norm(self.segment_aproj(seg_a.reshape(b * s, d))),
               "global_vfeat": None, "global_afeat": None}
        if self.add_global_repr:
            out["global_vfeat"] = l2norm(self.global_vproj(glob_v))
            out["global_afeat"] = l2norm(self.global_aproj(glob_a))
        return out


@dataclasses.dataclass
class MoCoQueues:
    """(D, Q) f32 feature queues and their write pointers."""
    segment_v: torch.Tensor
    segment_a: torch.Tensor
    segment_ptr: int = 0
    global_v: Optional[torch.Tensor] = None
    global_a: Optional[torch.Tensor] = None
    global_ptr: int = 0


def init_queues(generator: torch.Generator, n_embd: int, segment_queue_size: int,
                global_queue_size: Optional[int] = None, device=None) -> MoCoQueues:
    """Normal draws, L2-normalised along D (ref: model.py:862-871)."""
    def draw(q):
        return l2norm(torch.randn(n_embd, q, generator=generator, device=device), dim=0)

    queues = MoCoQueues(draw(segment_queue_size), draw(segment_queue_size))
    if global_queue_size:
        queues.global_v, queues.global_a = draw(global_queue_size), draw(global_queue_size)
    return queues


@torch.no_grad()
def momentum_update(model: nn.Module, model_m: nn.Module, momentum: float) -> None:
    """model_m <- model_m * momentum + model * (1 - momentum), every
    parameter (ref: model.py:824-828)."""
    params_m = list(model_m.parameters())
    torch._foreach_mul_(params_m, momentum)
    torch._foreach_add_(params_m, list(model.parameters()), alpha=1.0 - momentum)


@torch.no_grad()
def dequeue_and_enqueue(queue: torch.Tensor, ptr: int, feats: torch.Tensor) -> int:
    """Write the (B, D) keys into columns ptr..ptr+B of the (D, Q) queue;
    returns the next pointer (ref: model.py:839-857). Q must be a multiple of
    B, as in the reference (the JAX dynamic_update_slice would clamp); over
    ranks B is the global key count."""
    batch, q_size = feats.shape[0], queue.shape[1]
    if q_size % batch:
        raise ValueError(f"queue size {q_size} is not a multiple of the batch {batch}")
    queue[:, ptr:ptr + batch] = feats.t().to(queue.dtype)
    return (ptr + batch) % q_size


def moco_contrastive_loss(vfeat, afeat, vfeat_all, afeat_all, scale, alpha: float = 0.0,
                          vfeat_m=None, afeat_m=None, offset: int = 0) -> torch.Tensor:
    """Symmetric InfoNCE against [momentum keys | queue] (D, K + Q), the
    temperature dividing, in f32 (the f32 queue promotes the product); ALBEF
    soft targets alpha * softmax(momentum similarity) + (1 - alpha) * I where
    the momentum features are given (ref: model.py:694-721). Row i's positive
    is column offset + i (over ranks: the keys are the global batch's, and
    offset is the data rank * B)."""
    sim_v2a = (vfeat.float() @ afeat_all.float()) / scale
    sim_a2v = (afeat.float() @ vfeat_all.float()) / scale
    n, m = sim_v2a.shape
    eye = torch.eye(n, m, dtype=torch.float32, device=sim_v2a.device)
    if offset:
        eye = eye.roll(offset, dims=1)
    if vfeat_m is not None and afeat_m is not None:
        with torch.no_grad():
            sim_v2a_m = (vfeat_m.float() @ afeat_all.float()) / scale
            sim_a2v_m = (afeat_m.float() @ vfeat_all.float()) / scale
            t_v2a = alpha * torch.softmax(sim_v2a_m, -1) + (1 - alpha) * eye
            t_a2v = alpha * torch.softmax(sim_a2v_m, -1) + (1 - alpha) * eye
    else:
        t_v2a = t_a2v = eye

    def xent(sim, target):
        return -(target * torch.log_softmax(sim, -1)).sum(-1).mean()

    return (xent(sim_v2a, t_v2a) + xent(sim_a2v, t_a2v)) / 2.0


def moco_forward(model: MultilevelMoCoCLIP, model_m: MultilevelMoCoCLIP, queues: MoCoQueues,
                 vis, aud, impl: str, generator: Optional[torch.Generator] = None,
                 alpha: float = 0.0, train: bool = True):
    """One step's forward: the query pass (training when ``train``, its
    dropout and drop-path from ``generator``), the key pass (``model_m``,
    deterministic, no_grad), the loss per level against [keys of every rank |
    queue] and, when ``train``, those keys written into the queues. ``model``
    may be under DDP. Returns (losses, out, out_m); out_m holds this rank's
    keys."""
    module = pdist.unwrap(model)
    out = model(vis, aud, impl, deterministic=not train, generator=generator)
    with torch.no_grad():
        out_m = model_m(vis, aud, impl, deterministic=True)
    seg_scale, glob_scale = module.scales()
    levels = [("segment", seg_scale, queues.segment_v, queues.segment_a)]
    if module.add_global_repr:
        levels.append(("global", glob_scale, queues.global_v, queues.global_a))
    losses, keys = {}, {}
    for level, scale, qv, qa in levels:
        v_m, a_m = out_m[f"{level}_vfeat"], out_m[f"{level}_afeat"]
        keys[level] = (pdist.all_gather_no_grad(v_m), pdist.all_gather_no_grad(a_m))
        v_all = torch.cat([keys[level][0].t().float(), qv], dim=1)
        a_all = torch.cat([keys[level][1].t().float(), qa], dim=1)
        losses[f"{level}_contrastive_loss"] = moco_contrastive_loss(
            out[f"{level}_vfeat"], out[f"{level}_afeat"], v_all, a_all, scale, alpha, v_m, a_m,
            offset=pdist.data_rank() * v_m.shape[0])
    if train:
        for level, _, qv, qa in levels:
            ptr = getattr(queues, f"{level}_ptr")
            if qv.shape[1] > 0:
                dequeue_and_enqueue(qa, ptr, keys[level][1])
                setattr(queues, f"{level}_ptr", dequeue_and_enqueue(qv, ptr, keys[level][0]))
    return losses, out, out_m
