"""Reference-style checkpoint files written from the port's own state dicts,
for the tests and chip_smoke.py: the layout of a published Synchformer
``.pt`` without its weights.

A reference checkpoint keeps its weights under "model" (Stage II / III) or
"state_dict" (Stage I), their names prefixed ``module.`` by
DistributedDataParallel, and its training config under "args" as a pickled
omegaconf DictConfig. omegaconf need not be installed: ``fake_omegaconf``
gives stand-in classes with the same module paths and state layout
(``_content`` of a DictConfig / ListConfig, ``_val`` of a value node), so
that utils/checkpoint.py::load_torch_checkpoint takes the same stub path it
takes on a reference file.
"""
from __future__ import annotations

import sys
import types
from typing import Any, Mapping, Optional

import numpy as np
import torch


def fake_omegaconf() -> dict:
    """Module name -> module: stand-ins for omegaconf, omegaconf.dictconfig
    (DictConfig), omegaconf.listconfig (ListConfig) and omegaconf.nodes
    (AnyNode)."""
    base = types.ModuleType("omegaconf")
    dictconfig = types.ModuleType("omegaconf.dictconfig")
    listconfig = types.ModuleType("omegaconf.listconfig")
    nodes = types.ModuleType("omegaconf.nodes")

    class DictConfig:
        def __init__(self, content):
            self._content = content
            self._metadata = {"object_type": dict}

    class ListConfig:
        def __init__(self, content):
            self._content = content

    class AnyNode:
        def __init__(self, val):
            self._val = val

    for cls, mod in ((DictConfig, dictconfig), (ListConfig, listconfig), (AnyNode, nodes)):
        cls.__module__ = mod.__name__
        cls.__qualname__ = cls.__name__
        setattr(mod, cls.__name__, cls)
    base.dictconfig, base.listconfig, base.nodes = dictconfig, listconfig, nodes
    return {"omegaconf": base, "omegaconf.dictconfig": dictconfig,
            "omegaconf.listconfig": listconfig, "omegaconf.nodes": nodes}


def as_omegaconf(obj, mods: Mapping[str, types.ModuleType]):
    """A plain config tree as fake_omegaconf's containers: dicts as
    DictConfig, lists as ListConfig, every other value (an interpolation
    string too) as an AnyNode."""
    if isinstance(obj, Mapping):
        return mods["omegaconf.dictconfig"].DictConfig(
            {k: as_omegaconf(v, mods) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return mods["omegaconf.listconfig"].ListConfig([as_omegaconf(v, mods) for v in obj])
    return mods["omegaconf.nodes"].AnyNode(obj)


def save_with_fake_omegaconf(payload_fn, path: str) -> None:
    """torch.save ``payload_fn(mods)`` to ``path`` with fake_omegaconf's
    modules in sys.modules, which pickling needs to find the classes; the
    modules are taken out again afterwards (and any that were there
    before put back), so that reading the file finds no omegaconf."""
    mods = fake_omegaconf()
    saved = {name: sys.modules.get(name) for name in mods}
    sys.modules.update(mods)
    try:
        torch.save(payload_fn(mods), path)
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def save_reference_ckpt(path: str, state_dict: Mapping[str, Any], args: Optional[dict] = None,
                        weights_key: str = "model", prefix: str = "module.",
                        extra: Optional[Mapping[str, Any]] = None) -> str:
    """Write a reference-style checkpoint: ``state_dict`` (tensors or numpy
    arrays) under ``weights_key`` with each name prefixed by ``prefix``,
    ``args`` (a plain config tree) pickled as an omegaconf DictConfig, and
    the ``extra`` entries (an epoch, a metric) beside them."""
    weights = {prefix + k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
               for k, v in state_dict.items()}

    def payload(mods):
        out = {weights_key: weights, **(extra or {})}
        if args is not None:
            out["args"] = as_omegaconf(args, mods)
        return out

    save_with_fake_omegaconf(payload, path)
    return path
