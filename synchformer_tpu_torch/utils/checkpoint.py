"""Checkpoint files: the reference's ``.pt`` files, Stage I -> Stage II tower
initialisation, and the trainers' own store.

``load_torch_checkpoint`` and ``plain_from_ckpt_args`` are the port's copies
of synchformer_tpu/utils/checkpoint.py:444-520: a reference checkpoint keeps
its training config under ``ckpt['args']`` as a pickled omegaconf
DictConfig; where omegaconf cannot be imported, its classes unpickle into
inert stubs (``_make_stub``), and plain_from_ckpt_args reads the config out
of them as plain dicts and lists.

Stage I towers (load_stage1_tower, :327, and
SyncTrainer._maybe_init_towers_from_ckpts, train/stage_sync.py:215): a Stage
I checkpoint is a ``.pt`` file holding a state dict (under "state_dict", as
the reference writes it, under "model", as the port writes it, or bare;
``module.`` prefixes stripped) of an AVCLIP (towers under
``vfeat_extractor.`` / ``afeat_extractor.``, or the reference's ``v_encoder.``
/ ``a_encoder.``) or a MultilevelMoCoCLIP, or a Stage I run of the port's
CheckpointManager. The port keeps the reference's names inside each tower,
so extracting one strips a prefix; the AST's position embedding is cut to
the tower's tokens (convert.trim_ast_pos_emb). The merge into a sync
model's tower is non-strict on names (the Stage I towers' parameters that
the sync towers lack, a global aggregator, are reported as unexpected) and
strict on shapes: a tensor of the tower whose shape differs raises, as does
a tower that matches nothing.

``CheckpointManager`` is the trainers' store (JAX :523-581 on orbax, here
on ``torch.save``): ``<dir>/latest`` after every epoch, ``<dir>/best`` on
improvement of ``best_metric``; over ranks rank 0 writes and every rank
waits for the write, and every rank reads. Under tensor parallelism the
payload's state dicts hold whole tensors (parallel/tensor.py gathers them
in state_dict), so that a file has a model_parallel 1 run's names and shapes
and loads on any grid. ``generator_payload`` / ``restore_generators`` keep
each data rank's generator states in a payload. A
run directory of it is also a Stage I source (``load_stage1_tower``) and a
fine-tune source (``load_run_checkpoint``).
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import tempfile
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from synchformer_tpu_torch.parallel import dist as pdist
from synchformer_tpu_torch.utils.convert import (
    AST_POS_EMB,
    merge_state_dict_nonstrict,
    strip_module_prefix,
    trim_ast_pos_emb,
)

TOWER_PREFIXES = {"audio": ("afeat_extractor.", "a_encoder."),
                  "visual": ("vfeat_extractor.", "v_encoder.")}
# the AST's tokens at the published mel geometry (128 x 66 -> 12 x 6 + 2),
# JAX convert_ast's max_patches
AST_TOKENS = 74

_STUB_CACHE: Dict = {}


def _make_stub(module: str, name: str):
    """A shape-only stand-in for an unimportable pickled class: captures the
    pickled state so plain_from_ckpt_args can walk it."""
    cls = _STUB_CACHE.get((module, name))
    if cls is None:
        def _setstate(self, state):
            self.__dict__.update(state if isinstance(state, dict) else {"_state": state})

        cls = type(name, (), {"__module__": module, "__setstate__": _setstate})
        _STUB_CACHE[(module, name)] = cls
    return cls


class _StubUnpickler(pickle.Unpickler):
    """pickle.Unpickler that turns unimportable ``omegaconf.*`` classes into
    stubs and refuses every other unimportable class."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            if module.split(".")[0] == "omegaconf":
                return _make_stub(module, name)
            raise


class _StubPickleModule:
    Unpickler = _StubUnpickler
    load = staticmethod(pickle.load)


def load_torch_checkpoint(path: str) -> Dict:
    """torch.load a reference .pt / .pyth file onto the CPU: weights only
    where that reads it, else with the omegaconf stubs (a reference
    checkpoint's ``args``, ref: train_utils.py:253)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        pass
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_StubPickleModule)


def plain_from_ckpt_args(obj) -> Any:
    """``ckpt['args']`` -> plain Python containers: plain dicts as they are,
    pickled omegaconf DictConfig / ListConfig / value nodes (stubs or the
    real classes) by their ``_content`` / ``_val``; omegaconf's
    mandatory-missing marker '???' becomes None."""
    if isinstance(obj, Mapping):
        return {k: plain_from_ckpt_args(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain_from_ckpt_args(v) for v in obj]
    d = getattr(obj, "__dict__", None)
    if isinstance(d, dict):
        if "_content" in d:
            return plain_from_ckpt_args(d["_content"])
        if "_val" in d:
            return plain_from_ckpt_args(d["_val"])
    if isinstance(obj, str) and obj == "???":
        return None
    return obj


def load_stage1_tower(ckpt_path: str, tower: str,
                      max_patches: Optional[int] = AST_TOKENS) -> Dict[str, torch.Tensor]:
    """One tower's parameters, named inside the tower, from a Stage I
    checkpoint: a ``.pt`` file (read by load_torch_checkpoint) holding a
    state dict under "state_dict", under "model" or bare, ``module.``
    stripped; or a Stage I run of the port's CheckpointManager (the
    experiment directory, its ``ckpts`` directory, or its ``best`` /
    ``latest`` store; best where it has one, else latest, as
    synchformer_tpu/utils/checkpoint.py:327 does for orbax runs). The audio
    tower's position embedding is cut to ``max_patches`` tokens
    (trim_ast_pos_emb; a shorter one raises; None: left as it is). Raises
    on a path that does not exist, on a file that is not a torch checkpoint,
    and where no entry belongs to the tower."""
    if tower not in TOWER_PREFIXES:
        raise ValueError(f"tower must be 'audio' or 'visual', got {tower!r}")
    path = Path(ckpt_path)
    if not path.exists():
        raise FileNotFoundError(f"{tower} tower ckpt_path does not exist: {ckpt_path}")
    if path.is_dir():
        sd = load_run_checkpoint(path, ("best", "latest"))["trainable"]
    else:
        if path.suffix not in (".pt", ".pth", ".pyth"):
            raise ValueError(f"{tower} tower ckpt_path is not a torch checkpoint file: "
                             f"{ckpt_path}")
        ckpt = load_torch_checkpoint(str(path))
        if not isinstance(ckpt, Mapping):
            raise ValueError(f"{ckpt_path} holds a {type(ckpt).__name__}, not a state dict")
        sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    sd = strip_module_prefix(sd)
    out = {}
    for prefix in TOWER_PREFIXES[tower]:
        out.update({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    if not out:
        raise ValueError(f"{ckpt_path} holds no {tower} tower: no entry starts with "
                         f"{' or '.join(TOWER_PREFIXES[tower])}")
    return trim_ast_pos_emb(out, max_patches) if tower == "audio" else out


@torch.no_grad()
def init_tower_from_stage1(module: nn.Module, ckpt_path: str, tower: str) -> dict:
    """Load ``module`` (a sync model's tower) from a Stage I checkpoint,
    each tensor converted to its parameter's dtype and device, the AST's
    position embedding cut to the tower's own tokens; returns
    merge_state_dict_nonstrict's report. Raises where a tensor of the tower
    has another shape in the checkpoint, and where no parameter matched."""
    init = module.state_dict()
    n_tokens = init[AST_POS_EMB].shape[1] if AST_POS_EMB in init else None
    merged, report = merge_state_dict_nonstrict(
        init, load_stage1_tower(ckpt_path, tower, max_patches=n_tokens))
    if report["mismatched"]:
        raise ValueError(f"{tower} tower: Stage I ckpt {ckpt_path} has tensors of other "
                         f"shapes: {report['mismatched'][:6]}")
    n_loaded = len(init) - len(report["missing"])
    if n_loaded == 0:
        raise ValueError(f"{tower} tower: Stage I ckpt {ckpt_path} matched no parameter "
                         f"(missing {len(report['missing'])})")
    module.load_state_dict(merged)
    for field in ("missing", "unexpected"):
        if report[field]:
            logging.warning(f"{tower} tower <- {ckpt_path}: {field} ({len(report[field])}): "
                            f"{report[field][:6]}")
    logging.info(f"initialised the {tower} tower ({n_loaded} tensors) from {ckpt_path}")
    return report


class CheckpointManager:
    """best + latest checkpoints on ``torch.save`` (synchformer_tpu/utils/
    checkpoint.py:523-581, on orbax there).

    The reference's two-file cadence (ref: utils/logger.py:139-160,
    scripts/train_sync.py:257-267): ``save_latest`` after every training
    epoch for crash-resume, ``save_best`` when the early-stop metric
    improves. Two stores, ``<dir>/latest`` and ``<dir>/best``; each keeps
    ``max_to_keep`` checkpoints: latest the newest steps, best the highest
    ``best_metric``. A checkpoint is ``<step>.pt`` (the payload) and
    ``<step>.json`` (its metrics), each written to a temporary file and moved
    into place with ``os.replace``; the ``.json`` goes last and marks the
    checkpoint complete, so an interrupted save leaves the previous ones
    readable (the reference hand-rolls tmp -> os.replace, ref:
    train_clip.py:425-441). Payloads are nested dicts of tensors, numbers
    and strings (state dicts, optimizer state, generator states); they are
    read back with ``weights_only=True`` onto the CPU.
    """

    def __init__(self, directory: str, max_to_keep: int = 2):
        self._dir = Path(directory).absolute()
        self.max_to_keep = max_to_keep

    def _steps(self, name: str) -> Dict[int, Dict[str, float]]:
        """The complete checkpoints of a store: step -> metrics."""
        store = self._dir / name
        out = {}
        if store.is_dir():
            for meta in store.glob("*.json"):
                if meta.stem.isdigit() and meta.with_suffix(".pt").exists():
                    out[int(meta.stem)] = json.loads(meta.read_text())
        return out

    @staticmethod
    def _write_atomic(path: Path, write) -> None:
        fd, tmp = tempfile.mkstemp(prefix=f".{path.name}.", dir=path.parent)
        os.close(fd)
        try:
            write(tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def _save(self, name: str, step: int, payload: Dict[str, Any],
              metrics: Optional[Dict[str, float]]) -> None:
        if pdist.is_master():
            self._write(name, step, payload, metrics)
        pdist.barrier()

    def _write(self, name: str, step: int, payload: Dict[str, Any],
               metrics: Optional[Dict[str, float]]) -> None:
        store = self._dir / name
        store.mkdir(parents=True, exist_ok=True)
        self._write_atomic(store / f"{step}.pt", lambda tmp: torch.save(payload, tmp))
        meta = json.dumps({k: float(v) for k, v in (metrics or {}).items()})
        self._write_atomic(store / f"{step}.json", lambda tmp: Path(tmp).write_text(meta))
        steps = self._steps(name)
        if name == "best":
            keep = sorted(steps, key=lambda s: (steps[s].get("best_metric", 0.0), s))
        else:
            keep = sorted(steps)
        for old in keep[:-self.max_to_keep]:
            (store / f"{old}.json").unlink()   # uncommit first
            (store / f"{old}.pt").unlink()

    def save_latest(self, step: int, payload: Dict[str, Any],
                    metrics: Optional[Dict[str, float]] = None) -> None:
        self._save("latest", step, payload, metrics)

    def save_best(self, step: int, payload: Dict[str, Any],
                  metrics: Optional[Dict[str, float]] = None) -> None:
        self._save("best", step, payload, metrics)

    def _restore(self, name: str, step: Optional[int]) -> Dict[str, Any]:
        if step is None:
            step = self.latest_step() if name == "latest" else self.best_step()
        if step is None or step not in self._steps(name):
            raise FileNotFoundError(f"no {name} checkpoint {'' if step is None else step} "
                                    f"in {self._dir}")
        return torch.load(self._dir / name / f"{step}.pt", map_location="cpu",
                          weights_only=True)

    def restore_latest(self, step: Optional[int] = None) -> Dict[str, Any]:
        return self._restore("latest", step)

    def restore_best(self, step: Optional[int] = None) -> Dict[str, Any]:
        return self._restore("best", step)

    def latest_step(self) -> Optional[int]:
        return max(self._steps("latest"), default=None)

    def best_step(self) -> Optional[int]:
        """The step of the highest best_metric (orbax's best_fn)."""
        steps = self._steps("best")
        if not steps:
            return None
        return max(steps, key=lambda s: (steps[s].get("best_metric", 0.0), s))


def generator_payload(generators: Mapping[str, torch.Generator]) -> Dict[str, Any]:
    """A payload's generator entries: ``generators``, this rank's states by
    name (rank 0's in the file, as a run without a group writes them), and,
    gathered from every data rank (model peers draw the same streams),
    ``generators_by_rank`` in data order and ``world``, the number of data
    ranks, so that a resume at the same number of data ranks, at any
    model_parallel, continues every rank's streams. Every rank calls it."""
    states = {name: g.get_state() for name, g in generators.items()}
    return {"generators": states,
            "generators_by_rank": pdist.all_gather_object(states, pdist.data_group()),
            "world": pdist.n_data()}


def restore_generators(generators: Mapping[str, torch.Generator], payload: Mapping[str, Any],
                       seeds: Mapping[str, int], epoch: int) -> bool:
    """Set each generator from a payload's generator entries: this data
    rank's states where the payload was written at this number of data ranks
    (``world``; a payload without it is world 1's); else each generator
    re-seeded pdist.stream_seed(seeds[name], data rank, epoch), with a
    warning. Returns True where the states were restored."""
    saved_world = int(payload.get("world", 1))
    if saved_world == pdist.n_data():
        mine = payload.get("generators_by_rank", [payload["generators"]])[pdist.data_rank()]
        for name, g in generators.items():
            g.set_state(mine[name])
        return True
    for name, g in generators.items():
        g.manual_seed(pdist.stream_seed(seeds[name], pdist.data_rank(), epoch))
    logging.warning(f"checkpoint written at {saved_world} data ranks, resumed at "
                    f"{pdist.n_data()}: generators re-seeded from the seed, epoch {epoch} and "
                    f"data rank {pdist.data_rank()}")
    return False


def load_run_checkpoint(path, stores: Sequence[str] = ("latest",)) -> Dict[str, Any]:
    """The payload of a CheckpointManager run: ``path`` is a ``best`` or
    ``latest`` store (that store), or an experiment or ``ckpts`` directory
    (the first of ``stores`` holding a checkpoint; the JAX trainer's
    fine-tune restores latest, its tower loader best, else latest)."""
    path = Path(path)
    if path.name in ("best", "latest") and path.is_dir():
        ckpts_dir, stores = path.parent, (path.name,)
    else:
        for ckpts_dir in (path, path / "ckpts"):
            if (ckpts_dir / "best").is_dir() or (ckpts_dir / "latest").is_dir():
                break
        else:
            raise FileNotFoundError(f"{path} holds no 'best' / 'latest' checkpoint store")
    mngr = CheckpointManager(str(ckpts_dir))
    for store in stores:
        step = mngr.best_step() if store == "best" else mngr.latest_step()
        if step is not None:
            return mngr.restore_best(step) if store == "best" else mngr.restore_latest(step)
    raise FileNotFoundError(f"no checkpoint under {ckpts_dir} in {list(stores)}")
