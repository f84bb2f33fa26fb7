"""Tiny cells for the benchmark's CPU tests: the shipped configurations and
traffic mixes with their widths, depths and sizes cut so that a whole run
(set-up, window, the check against the reference) takes seconds on the
CPU, the kernel wrappers running their plain versions there."""
from __future__ import annotations

import copy

from benchmark import harness

D, HEADS = 128, 2  # heads of 64: the split flow, as at full width


def _cut_model(node: dict) -> dict:
    node = copy.deepcopy(node)
    p = node["params"]
    v, a = p["vfeat_extractor"]["params"], p["afeat_extractor"]["params"]
    v.update(embed_dim=D, depth=2, num_heads=HEADS, patch_size=8, img_size=32,
             temporal_resolution=2)
    a.update(hidden_size=D, depth=1, num_heads=HEADS)
    if "transformer" in p:
        t = p["transformer"]["params"]
        t.update(n_layer=2, n_head=HEADS, n_embd=D)
        t["pos_emb_cfg"]["params"].update(block_shape=[2 + 2 * (2 + 6)], n_embd=D)
        t["off_head_cfg"]["params"]["in_features"] = D
        for proj in ("vproj", "aproj"):
            p[proj]["params"].update(in_features=D, out_features=D)
    else:
        p["n_embd"] = D
    return node


def _cut_sizes(s: dict) -> dict:
    s = copy.deepcopy(s)
    s.update(d=D, segments=2)
    s["video"].update(depth=2, heads=HEADS, patch=8, img=32, frames=4)
    s["audio"].update(depth=1, heads=HEADS)
    if "transformer" in s:
        s["transformer"].update(n_layer=2, n_head=HEADS)
    return s


def tiny_cell(name: str, batch: int = 2, pool: int = 4) -> dict:
    """The shipped cell ``name`` cut to tiny sizes, with the manifest it is
    judged under and limits that pass a sound tiny run."""
    cell = harness.load_cell(name)
    cell["config"]["model"] = _cut_model(cell["config"]["model"])
    cell["sizes"] = cell["config"]["sizes"] = _cut_sizes(cell["sizes"])
    trainer = cell["config"].get("trainer")
    if trainer:
        trainer["training"]["base_batch_size"] = batch
        trainer["data"]["n_segments"] = 2
    cell["traffic"] = dict(cell["traffic"], batch=batch, pool=pool)
    cell["manifest"] = harness.manifest()
    return cell
