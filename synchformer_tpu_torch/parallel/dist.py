"""Data and tensor parallelism over ranks, one process per card (the
counterpart of synchformer_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a ('data', 'model') mesh: the
jitted step sees the global batch, and XLA inserts the gradient psum. Here
each rank is a process, and the collectives are torch.distributed's:

- ``init_from_env`` joins the group that ``python -m torch.distributed.run``
  (torchrun) describes in RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
  MASTER_PORT: NCCL on ``cuda`` (the rank's card is cuda:LOCAL_RANK), gloo on
  ``cpu``. Without that environment it does nothing and the program runs as
  one process with no group (world 1);
- ``init_grid``: the (data x model) grid of ``training.model_parallel`` m:
  world = n_data x m ranks, rank r at data index r // m and model index
  r % m (the mesh's layout, create_device_mesh((n_data, n_model)), model
  axis fastest); the data group of r holds the ranks of its model index, its
  model group those of its data index. A world that does not split into m
  is refused (JAX leaves the leftover devices idle, mesh.py:39-41; an idle
  rank here would hang the collectives). At m = 1 the data group is the
  whole world and nothing else changes;
- ``wrap_ddp``: DistributedDataParallel over the data group, whose
  all-reduce averages the gradients over the data ranks during the backward
  (the mesh's psum);
- ``all_gather_with_grad``: the rows of every data rank in data order, with
  a backward that sums the incoming gradient over the data group and keeps
  this rank's rows (the InfoNCE's negatives over the global batch);
- ``all_gather_no_grad``: the reference's concat_all_gather (MoCo's keys),
  over the data group; ``all_reduce_mean``: a metric's mean over it;
- ``all_gather_object`` / ``broadcast_object``: host objects (evaluation
  gathers and generator states over the data group, the run directory's
  name over the world).

The model axis itself, the parameters stored as shards of their output
features (``param_shardings``, mesh.py:132-165), is parallel/tensor.py's.
Model peers (the ranks of one model group) take the same rows and draw the
same random numbers, so that they stay replicas of one another. The mesh's
``data_sharded_kernel`` (mesh.py:87-129) has no counterpart: each rank
launches its own kernels on its own rows, with whole weights.

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
# the streams of data rank r (and, after a resume at another number of data
# ranks, of an epoch) are seeded seed + RANK_STRIDE * r + EPOCH_STRIDE *
# epoch: data rank 0 at epoch 0 draws exactly the streams of a run without a
# group, and model peers draw the same streams
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


# the grid of init_grid: the model axis' size and this rank's two groups
# (None: the whole world, or no collective at all at size 1)
_GRID: dict = {"m": 1, "data": None, "model": None}


def check_split(model_parallel) -> int:
    """``model_parallel`` as an int, refused where it is not at least 1 or
    the world does not split into it."""
    m = int(model_parallel or 1)
    if m < 1 or world() % m:
        raise ValueError(f"training.model_parallel {model_parallel}: world {world()} does not "
                         f"split into model_parallel {m} (world = n_data x model_parallel "
                         "ranks)")
    return m


def init_grid(model_parallel=1) -> None:
    """Lay the ranks out as the (n_data x ``model_parallel``) grid and make
    its data and model groups (every rank calls it, with the same value).
    Raises where the world does not split into ``model_parallel``."""
    m = check_split(model_parallel)
    if m == _GRID["m"]:
        return
    _GRID.update(m=m, data=None, model=None)
    if m == 1:
        return
    n = world() // m
    for j in range(m):  # every rank makes every group, in one order
        group = dist.new_group([i * m + j for i in range(n)])
        if j == model_rank():
            _GRID["data"] = group
    for i in range(n):
        group = dist.new_group([i * m + j for j in range(m)])
        if i == data_rank():
            _GRID["model"] = group


def n_model() -> int:
    return _GRID["m"]


def model_rank() -> int:
    return rank() % _GRID["m"]


def n_data() -> int:
    return world() // _GRID["m"]


def data_rank() -> int:
    return rank() // _GRID["m"]


def data_group():
    """This rank's data group (None: the whole world)."""
    return _GRID["data"]


def model_group():
    """This rank's model group (None where the model axis is 1)."""
    return _GRID["model"]


def is_master() -> bool:
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def destroy() -> None:
    """Leave the group, where one was joined, and forget the grid."""
    _GRID.update(m=1, data=None, model=None)
    if dist.is_initialized():
        dist.destroy_process_group()


def stream_seed(seed: int, rank_: int = 0, epoch: int = 0) -> int:
    """The seed of a data rank's generator stream (RANK_STRIDE, EPOCH_STRIDE)."""
    return int(seed) + RANK_STRIDE * int(rank_) + EPOCH_STRIDE * int(epoch)


def local_batch_size(batch_size: int, model_parallel=1) -> int:
    """This rank's rows of a global batch of ``batch_size`` (the trainers'
    base_batch_size, as in the JAX trainers, stage_clip.py:87,
    stage_sync.py:106) on the grid of ``model_parallel``: the batch divides
    over the n_data = world / model_parallel data ranks, and model peers
    take the same rows. Raises where the world does not split into
    ``model_parallel`` or the batch does not divide."""
    n = world() // check_split(model_parallel)
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} must divide over the {n} ranks of the data "
                         "axis")
    return batch_size // n


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj: Any, group=None) -> List[Any]:
    """Every rank's ``obj`` in rank order: of the world, or of ``group``
    (e.g. data_group(), in data order)."""
    size = world() if group is None else dist.get_world_size(group)
    if size == 1:
        return [obj]
    out: List[Any] = [None] * size
    dist.all_gather_object(out, obj, group=group)
    return out


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data ranks (a new tensor; ``x`` itself at
    one data rank); model peers hold the same value."""
    if n_data() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=data_group())
    return out / n_data()


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, ...) rows of every rank of ``group`` (None: the world) ->
    (size * n, ...), in the group's rank order; every rank gives the same
    shape."""
    x = x.contiguous()
    size = world() if group is None else dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


class _AllGatherWithGrad(torch.autograd.Function):
    """Forward: every data rank's (n, ...) rows concatenated in data order.
    Backward: the incoming gradient summed over the data group (each rank's
    loss reads every data rank's rows), then this rank's n rows."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[0]
        return gather_rows(x, data_group())

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=data_group())
        return grad[data_rank() * ctx.n:(data_rank() + 1) * ctx.n]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """(n, ...) rows of every data rank -> (n_data * n, ...), differentiable;
    every rank gives the same n. ``x`` itself at one data rank."""
    if n_data() == 1:
        return x
    return _AllGatherWithGrad.apply(x)


@torch.no_grad()
def all_gather_no_grad(x: torch.Tensor) -> torch.Tensor:
    """(n, ...) rows of every data rank -> (n_data * n, ...), outside
    autograd; ``x`` itself at one data rank."""
    if n_data() == 1:
        return x
    return gather_rows(x, data_group())


def wrap_ddp(module: torch.nn.Module, device) -> torch.nn.Module:
    """``module`` under DistributedDataParallel over the data group where a
    group is joined (at any world size), else ``module`` itself. DDP
    broadcasts the data group's first rank's parameters and buffers (a model
    index's shards, under tensor parallelism) at construction; the buffers
    are not broadcast again before each forward: the only buffers that
    change, the legacy towers' BatchNorm running statistics, are updated
    from the data group's global statistics (models/conv.py), so every rank
    keeps the same values.
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
    return DistributedDataParallel(module, process_group=data_group(), broadcast_buffers=False,
                                   static_graph=True, **ids)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module under a DDP wrapper, or ``model`` itself."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) else model
