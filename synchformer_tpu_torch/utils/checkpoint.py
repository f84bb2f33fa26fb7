"""Stage I -> Stage II tower initialisation from the port's own checkpoints
(synchformer_tpu/utils/checkpoint.py::load_stage1_tower, :327, and
SyncTrainer._maybe_init_towers_from_ckpts, train/stage_sync.py:215).

A Stage I checkpoint here is a ``.pt`` file that ``torch.save`` wrote from a
port AVCLIP (towers under ``vfeat_extractor.`` / ``afeat_extractor.``) or
MultilevelMoCoCLIP (``v_encoder.`` / ``a_encoder.``) state dict, bare or
under ``"model"``. The port keeps the reference's names inside each tower,
so extracting one strips a prefix. The merge into a sync model's tower is
non-strict: the Stage I
towers' parameters that the sync towers lack (a global aggregator) are
reported as unexpected; a tower that matches nothing raises. Reference
pickles that need stub classes wait for their loader (ROADMAP §1 item 6).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Mapping

import torch
from torch import nn

from synchformer_tpu_torch.utils.convert import merge_state_dict_nonstrict

TOWER_PREFIXES = {"audio": ("afeat_extractor.", "a_encoder."),
                  "visual": ("vfeat_extractor.", "v_encoder.")}


def load_stage1_tower(ckpt_path: str, tower: str) -> Dict[str, torch.Tensor]:
    """One tower's parameters, named inside the tower, from a Stage I
    ``.pt`` checkpoint. Raises on a path that does not exist, on a file
    that is not a torch checkpoint, and where no entry belongs to the tower."""
    if tower not in TOWER_PREFIXES:
        raise ValueError(f"tower must be 'audio' or 'visual', got {tower!r}")
    path = Path(ckpt_path)
    if not path.exists():
        raise FileNotFoundError(f"{tower} tower ckpt_path does not exist: {ckpt_path}")
    if not path.is_file() or path.suffix not in (".pt", ".pth", ".pyth"):
        raise ValueError(f"{tower} tower ckpt_path is not a torch checkpoint file: {ckpt_path}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, Mapping):
        raise ValueError(f"{ckpt_path} holds a {type(ckpt).__name__}, not a state dict")
    sd = ckpt.get("model", ckpt)
    out = {}
    for prefix in TOWER_PREFIXES[tower]:
        out.update({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    if not out:
        raise ValueError(f"{ckpt_path} holds no {tower} tower: no entry starts with "
                         f"{' or '.join(TOWER_PREFIXES[tower])}")
    return out


@torch.no_grad()
def init_tower_from_stage1(module: nn.Module, ckpt_path: str, tower: str) -> dict:
    """Load ``module`` (a sync model's tower) from a Stage I checkpoint,
    non-strictly, each tensor converted to its parameter's dtype and device;
    returns merge_state_dict_nonstrict's report. Raises where no parameter
    of the tower matched."""
    init = module.state_dict()
    merged, report = merge_state_dict_nonstrict(init, load_stage1_tower(ckpt_path, tower))
    n_loaded = len(init) - len(report["missing"]) - len(report["mismatched"])
    if n_loaded == 0:
        raise ValueError(f"{tower} tower: Stage I ckpt {ckpt_path} matched no parameter "
                         f"(missing {len(report['missing'])}, mismatched "
                         f"{report['mismatched'][:3]})")
    module.load_state_dict(merged)
    for field in ("missing", "unexpected", "mismatched"):
        if report[field]:
            logging.warning(f"{tower} tower <- {ckpt_path}: {field} ({len(report[field])}): "
                            f"{report[field][:6]}")
    logging.info(f"initialised the {tower} tower ({n_loaded} tensors) from {ckpt_path}")
    return report
