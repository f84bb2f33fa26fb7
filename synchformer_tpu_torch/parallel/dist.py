"""Data parallelism over ranks, one process per card (the counterpart of
synchformer_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a ('data', 'model') mesh: the
jitted step sees the global batch, and XLA inserts the gradient psum. Here
each rank is a process that holds the whole model and its share of the
global batch, and the collectives are torch.distributed's:

- ``init_from_env`` joins the group that ``python -m torch.distributed.run``
  (torchrun) describes in RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
  MASTER_PORT: NCCL on ``cuda`` (the rank's card is cuda:LOCAL_RANK), gloo on
  ``cpu``. Without that environment it does nothing and the program runs as
  one process with no group (world 1);
- ``wrap_ddp``: DistributedDataParallel, whose all-reduce averages the
  gradients over ranks during the backward (the mesh's psum);
- ``all_gather_with_grad``: the rows of every rank in rank order, with a
  backward that sums the incoming gradient over ranks and keeps this rank's
  rows (the InfoNCE's negatives over the global batch);
- ``all_gather_no_grad``: the reference's concat_all_gather (MoCo's keys);
- ``all_gather_object`` / ``broadcast_object``: host objects (evaluation
  gathers, generator states, the run directory's name).

The mesh's ``data_sharded_kernel`` (mesh.py:87-129) has no counterpart: XLA
needs it to run a Pallas call per shard, while here each rank launches its
own kernels on its own rows. Tensor parallelism (the 'model' axis,
``param_shardings``, mesh.py:132-165) is not ported: the trainers refuse
``training.model_parallel`` above 1.

Every function here is the identity, or does nothing, at world 1.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

# the process group's timeout where SFT_DIST_TIMEOUT_S gives none
DEFAULT_TIMEOUT_S = 1800.0
# the streams of rank r (and, after a resume at another world size, of an
# epoch) are seeded seed + RANK_STRIDE * r + EPOCH_STRIDE * epoch: rank 0 at
# epoch 0 draws exactly the streams of a run without a group
RANK_STRIDE, EPOCH_STRIDE = 1_000_003, 7_919


def init_from_env(device="cuda", backend: Optional[str] = None) -> torch.device:
    """Join the process group described by torchrun's environment; returns
    this rank's device (cuda:LOCAL_RANK for ``cuda``). ``backend`` defaults to
    'nccl' on ``cuda`` and 'gloo' on ``cpu``; the group's timeout is
    SFT_DIST_TIMEOUT_S seconds, else DEFAULT_TIMEOUT_S. Without the
    environment (RANK and WORLD_SIZE), or with a group already joined,
    nothing happens."""
    dev = torch.device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return local_device(dev)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_from_env: CUDA is not available; pass device='cpu' to "
                               "train on the CPU over gloo")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    timeout = float(os.environ.get("SFT_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S))
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


def local_device(device) -> torch.device:
    """``device``, with a bare 'cuda' resolved to this process's current card
    where a group is joined (the card init_from_env set)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_master() -> bool:
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def destroy() -> None:
    """Leave the group, where one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def stream_seed(seed: int, rank_: int = 0, epoch: int = 0) -> int:
    """The seed of a rank's generator stream (RANK_STRIDE, EPOCH_STRIDE)."""
    return int(seed) + RANK_STRIDE * int(rank_) + EPOCH_STRIDE * int(epoch)


def local_batch_size(batch_size: int, model_parallel=1) -> int:
    """This rank's rows of a global batch of ``batch_size`` (the trainers'
    base_batch_size, as in the JAX trainers, stage_clip.py:87,
    stage_sync.py:106); raises where it does not divide over the ranks, and
    refuses ``training.model_parallel`` above 1."""
    if int(model_parallel or 1) > 1:
        raise NotImplementedError(
            f"training.model_parallel {model_parallel}: tensor parallelism (the JAX mesh's "
            "'model' axis) is not ported (ROADMAP §1 item 8); data parallelism over ranks "
            "takes model_parallel 1")
    if batch_size % world():
        raise ValueError(f"batch_size {batch_size} must divide over the {world()} ranks")
    return batch_size // world()


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order."""
    if world() == 1:
        return [obj]
    out: List[Any] = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over ranks (a new tensor; ``x`` itself at world 1)."""
    if world() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out / world()


def _gather_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


class _AllGatherWithGrad(torch.autograd.Function):
    """Forward: every rank's (n, ...) rows concatenated in rank order. Backward:
    the incoming gradient summed over ranks (each rank's loss reads every
    rank's rows), then this rank's n rows."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[0]
        return _gather_rows(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[rank() * ctx.n:(rank() + 1) * ctx.n]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """(n, ...) rows of every rank -> (world * n, ...), differentiable; every
    rank gives the same n. ``x`` itself at world 1."""
    if world() == 1:
        return x
    return _AllGatherWithGrad.apply(x)


@torch.no_grad()
def all_gather_no_grad(x: torch.Tensor) -> torch.Tensor:
    """(n, ...) rows of every rank -> (world * n, ...), outside autograd; ``x``
    itself at world 1."""
    if world() == 1:
        return x
    return _gather_rows(x)


def wrap_ddp(module: torch.nn.Module, device) -> torch.nn.Module:
    """``module`` under DistributedDataParallel where a group is joined (at
    any world size), else ``module`` itself. DDP broadcasts rank 0's
    parameters and buffers at construction; the buffers are not broadcast
    again before each forward (the models' buffers are constants).
    static_graph: every step runs the same graph, so DDP learns in the first
    backward which parameters get a gradient and in what order; a parameter
    read outside the forward (MoCo's temperatures, read by the loss) or by no
    step at all is then handled without find_unused_parameters' traversal of
    the graph on every step."""
    if not dist.is_initialized():
        return module
    from torch.nn.parallel import DistributedDataParallel

    dev = torch.device(device)
    ids = dict(device_ids=[dev.index], output_device=dev.index) if dev.type == "cuda" else {}
    return DistributedDataParallel(module, broadcast_buffers=False, static_graph=True, **ids)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module under a DDP wrapper, or ``model`` itself."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) else model
