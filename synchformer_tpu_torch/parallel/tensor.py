"""Tensor parallelism: the JAX mesh's 'model' axis (synchformer_tpu/parallel/
mesh.py:132-165, ``param_shardings``) on the grid of parallel/dist.py.

JAX shards each Dense kernel and bias whose module is named qkv / proj / fc1
/ fc2 / linear / dense on its output features where they divide by the model
axis, and keeps every other leaf replicated. Every Pallas entry reads the
weights as replicated arguments (data_sharded_kernel's P(), mesh.py:87-129),
that is all-gathered: a step computes what data parallelism at n_data
computes, and only where the parameters and the optimizer's moments live
changes. Here:

- ``sharded_entries`` names the port's counterparts of those leaves. The
  port keeps the reference's torch names (utils/convert.py holds the map):
  JAX's fused qkv is the AST's and the sync transformer's separate query /
  key / value, and the CLS-pool layers' ``self_attn.in_proj_*``; a
  LinearBridge's weight is JAX's ``linear``. A weight or bias is sharded
  where its dim 0, a torch weight's output features, divides by the model
  axis;
- ``shard_model_`` stores each such parameter on each rank as its model
  index's contiguous block of rows in place of the whole tensor. The module
  keeps the parameter under its name, so that named_parameters, DDP, the
  optimizer and its moments see the shard, and reading the attribute
  (``module.weight``, wherever a layer or a kernel wrapper's argument reads
  it) returns the whole tensor, all-gathered over the model group: the
  kernels see whole weights, as the JAX kernels do. The gather's backward
  keeps this rank's block of the gradient: every model peer computes the
  same whole gradient, so none is reduced;
- ``state_dict()`` of a sharded module holds the whole tensors and
  ``load_state_dict`` takes whole tensors and keeps this rank's block, so a
  checkpoint has a model_parallel 1 run's names and shapes and loads on any
  grid; ``optimizer_state_dict`` / ``load_optimizer_state_dict`` do the
  same for the optimizer's moments;
- ``sharded_mask`` tells the global-norm clip (train/state.py) which
  gradients are shards.

Each gather is a collective of the model group: model peers read the same
weights in the same order, and every rank of a group calls state_dict. At
model_parallel 1 nothing is sharded and nothing here does anything.
"""
from __future__ import annotations

import functools
import re
from typing import Dict, List, Mapping, Sequence, Set, Tuple

import torch
from torch import nn

from synchformer_tpu_torch.models.bridges import LinearBridge
from synchformer_tpu_torch.models.layers import Linear
from synchformer_tpu_torch.parallel import dist as pdist

# the module paths of the Linears whose JAX Dense param_shardings shards:
# the divided and ViT blocks' attn / timeattn qkv and proj and mlp fc1 / fc2;
# the sync transformer's attn query / key / value / proj and mlp.0 / mlp.2;
# the AST layers' query / key / value, attention.output.dense,
# intermediate.dense and output.dense, and its classifier.dense; the
# CLS-pool layers' out_proj, linear1 and linear2; the projections
# (LinearBridges, JAX ``linear``)
SHARDED_LINEARS = re.compile(
    r"(?:^|\.)(?:(?:attn|timeattn)\.(?:qkv|proj|query|key|value)|mlp\.(?:fc1|fc2|0|2)"
    r"|attention\.attention\.(?:query|key|value)|(?:attention\.)?output\.dense"
    r"|intermediate\.dense|classifier\.dense|self_attn\.out_proj|linear1|linear2"
    r"|(?:segment_|global_)?[va]proj)$")
# the offset head is JAX's LinearBridge (``off_head/linear``) in the
# GlobalTransformer and a bare Dense in the SparseSync transformer
OFF_HEAD = re.compile(r"(?:^|\.)off_head$")
# the CLS-pool layers' packed in-projection (JAX ``attn/qkv``)
IN_PROJ = re.compile(r"(?:^|\.)self_attn$")


def _rule(path: str, mod: nn.Module) -> Tuple[str, ...]:
    """The names of ``mod``'s own parameters whose JAX counterparts
    param_shardings shards (before divisibility)."""
    if isinstance(mod, Linear) and (SHARDED_LINEARS.search(path) or (
            isinstance(mod, LinearBridge) and OFF_HEAD.search(path))):
        return ("weight", "bias")
    if IN_PROJ.search(path):
        return ("in_proj_weight", "in_proj_bias")
    return ()


def sharded_entries(model: nn.Module, n_model: int) -> List[Tuple[str, nn.Module, str]]:
    """(module path, module, parameter name) of every parameter the rule
    shards at model axis ``n_model``: a counterpart of a JAX leaf that
    param_shardings shards, whose dim 0 divides by ``n_model`` (none at 1)."""
    if n_model == 1:
        return []
    out = []
    for path, mod in model.named_modules():
        for name in _rule(path, mod):
            p = mod._parameters.get(name)
            if p is not None and p.ndim in (1, 2) and p.shape[0] % n_model == 0:
                out.append((path, mod, name))
    return out


def sharded_names(model: nn.Module) -> Set[str]:
    """The state-dict names of ``model``'s sharded parameters."""
    return {f"{path}.{name}" if path else name for path, mod in model.named_modules()
            for name in getattr(type(mod), "_tp_names", ())}


def sharded_params(model: nn.Module) -> Set[int]:
    """The ids of ``model``'s sharded parameters (the shards)."""
    return {id(mod._parameters[name]) for mod in model.modules()
            for name in getattr(type(mod), "_tp_names", ())}


def sharded_mask(model: nn.Module, params: Sequence[torch.Tensor]) -> List[bool]:
    """For each of ``params`` (parameters of ``model``), whether it is a
    shard."""
    ids = sharded_params(model)
    return [id(p) in ids for p in params]


class _GatherRows(torch.autograd.Function):
    """Forward: the model group's blocks of rows, concatenated in model
    order (the whole tensor). Backward: this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, shard):
        ctx.rows = shard.shape[0]
        return pdist.gather_rows(shard, pdist.model_group())

    @staticmethod
    def backward(ctx, grad):
        r = pdist.model_rank()
        return grad[r * ctx.rows:(r + 1) * ctx.rows].contiguous()


def gather_shards(shard: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a parameter shard (differentiable)."""
    return _GatherRows.apply(shard)


def _whole(mod: nn.Module, name: str) -> torch.Tensor:
    return gather_shards(mod._parameters[name])


_CLASSES: Dict[Tuple[type, Tuple[str, ...]], type] = {}


def _sharded_class(cls: type, names: Tuple[str, ...]) -> type:
    """``cls`` with a property per sharded name that reads the whole tensor
    (the parameter itself stays in ``_parameters``)."""
    key = (cls, names)
    if key not in _CLASSES:
        attrs = {"_tp_names": names}
        attrs.update({n: property(functools.partial(_whole, name=n)) for n in names})
        _CLASSES[key] = type(cls.__name__, (cls,), attrs)
    return _CLASSES[key]


def _whole_state(mod, state_dict, prefix, local_metadata) -> None:
    """state_dict hook: the whole tensors in place of the shards."""
    for name in type(mod)._tp_names:
        if prefix + name in state_dict:
            with torch.no_grad():
                state_dict[prefix + name] = gather_shards(mod._parameters[name].detach())


def _shard_state(mod, state_dict, prefix, *args) -> None:
    """load_state_dict pre-hook: this rank's block of each whole tensor."""
    m, r = pdist.n_model(), pdist.model_rank()
    for name in type(mod)._tp_names:
        val, rows = state_dict.get(prefix + name), mod._parameters[name].shape[0]
        if val is not None and val.ndim > 0 and val.shape[0] == rows * m:
            state_dict[prefix + name] = val[r * rows:(r + 1) * rows]


def shard_model_(model: nn.Module) -> nn.Module:
    """Store ``model``'s sharded parameters (sharded_entries at this grid's
    model axis) as this rank's blocks of rows, in place; a model already
    sharded, and any model at model_parallel 1, is left as it is. Call it
    before the optimizer and DDP take the parameters."""
    m = pdist.n_model()
    by_module: Dict[int, Tuple[nn.Module, List[str]]] = {}
    for _, mod, name in sharded_entries(model, m):
        if not hasattr(type(mod), "_tp_names"):
            by_module.setdefault(id(mod), (mod, []))[1].append(name)
    r = pdist.model_rank()
    for mod, names in by_module.values():
        for name in names:
            p = mod._parameters[name]
            rows = p.shape[0] // m
            mod._parameters[name] = nn.Parameter(p.detach()[r * rows:(r + 1) * rows].clone(),
                                                 requires_grad=p.requires_grad)
        mod.__class__ = _sharded_class(type(mod), tuple(names))
        mod._register_state_dict_hook(_whole_state)
        mod._register_load_state_dict_pre_hook(_shard_state, with_module=True)
    return model


def whole_tensors(model: nn.Module, named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``named`` (parameter name -> a tensor shaped as that parameter: the
    parameter, its gradient, a moment), detached, with every shard's entry
    gathered to the whole tensor."""
    names = sharded_names(model)
    with torch.no_grad():
        return {k: gather_shards(v.detach()) if k in names else v.detach()
                for k, v in named.items()}


def _optimizer_params(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The parameters in the order of the optimizer's state-dict indices."""
    return [p for group in optimizer.param_groups for p in group["params"]]


def optimizer_state_dict(optimizer: torch.optim.Optimizer, model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with each shard's moments (every state
    tensor of the parameter's shape) gathered to the whole tensor: the
    state a model_parallel 1 run writes. Every rank of a model group calls
    it."""
    sd = optimizer.state_dict()
    ids = sharded_params(model)
    params = _optimizer_params(optimizer)
    state = {}
    for i, st in sd["state"].items():
        p = params[i]
        state[i] = {k: (gather_shards(v.detach()) if id(p) in ids and torch.is_tensor(v)
                        and v.shape == p.shape else v) for k, v in st.items()}
    return {**sd, "state": state}


def load_optimizer_state_dict(optimizer: torch.optim.Optimizer, model: nn.Module,
                              sd: Mapping) -> None:
    """Load a state dict of whole moments (optimizer_state_dict's, or a
    model_parallel 1 run's), keeping this rank's block of each shard's."""
    ids = sharded_params(model)
    params = _optimizer_params(optimizer)
    m, r = pdist.n_model(), pdist.model_rank()
    state = {}
    for i, st in sd["state"].items():
        p = params[int(i)]
        rows = p.shape[0] if p.ndim else 0

        def block(v):
            if (id(p) in ids and torch.is_tensor(v) and v.ndim == p.ndim
                    and v.shape[0] == rows * m):
                return v[r * rows:(r + 1) * rows]
            return v

        state[i] = {k: block(v) for k, v in st.items()}
    optimizer.load_state_dict({**sd, "state": state})
