"""Analytic model FLOPs of the Synchformer family from a configuration's
sizes (2 FLOPs a multiply-add; matrix products and attention only, as a
model-FLOPs utilisation counts them).

- Video tower, per segment of T = 1 + f*n tokens: the patch embed, then
  per block 32 T D^2 (two QKV, two projections, the MLP at ratio 4) and
  the divided attention's time and space products; the spatial CLS pool
  per frame.
- Audio tower, per segment of N = 2 + f*t tokens: the patch embed, per
  layer 24 N D^2 and 4 N^2 D, the frequency CLS pool per time step.
- The offset transformer per clip over its sequence, and the projections.

A step that trains counts the forward and twice it for the backward of
what trains (3x), the forward alone of what is frozen; recomputed work is
not counted, and the first layer's input gradient (of the frames and the
log-mel) is not needed.
"""
from __future__ import annotations

from benchmark.flops.kernels import attention_flops


def _mlp_hidden(d: int, ratio: float) -> int:
    return int(d * ratio)


def cls_pool_flops(groups: int, m: int, d: int, hid: int) -> float:
    """One CLS-pool layer over ``groups`` groups of m rows: K and V of the
    m + 1 rows, the CLS query, its attention, projection and MLP."""
    per = (2.0 * (m + 1) * d * 2 * d + 2.0 * d * d + 4.0 * (m + 1) * d + 2.0 * d * d
           + 4.0 * d * hid)
    return groups * per


def video_tower_flops(s: dict) -> float:
    """One segment through the video tower."""
    v, d = s["video"], s["d"]
    f, n = v["frames"] // v["z"], (v["img"] // v["patch"]) ** 2
    hid = _mlp_hidden(d, v["mlp_ratio"])
    t = 1 + f * n
    pk = v["z"] * v["patch"] * v["patch"] * 3
    per_block = (2.0 * t * d * 3 * d * 2 + 2.0 * t * d * d * 2 + 4.0 * t * d * hid
                 + attention_flops(1, "time", 2, v["heads"], d // v["heads"], f, n)
                 + attention_flops(1, "space", 2, v["heads"], d // v["heads"], f, n))
    return 2.0 * f * n * pk * d + v["depth"] * per_block + cls_pool_flops(f, n, d, hid)


def video_embed_flops(s: dict) -> float:
    v, d = s["video"], s["d"]
    f, n = v["frames"] // v["z"], (v["img"] // v["patch"]) ** 2
    return 2.0 * f * n * v["z"] * v["patch"] * v["patch"] * 3 * d


def _ast_grid(a: dict):
    return ((a["n_mels"] - a["patch"]) // a["stride"] + 1,
            (a["max_spec_t"] - a["patch"]) // a["stride"] + 1)


def audio_tower_flops(s: dict) -> float:
    """One segment through the audio tower."""
    a, d = s["audio"], s["d"]
    fd, td = _ast_grid(a)
    hid = _mlp_hidden(d, a["mlp_ratio"])
    n = 2 + fd * td
    per_layer = 2.0 * n * d * 3 * d + 2.0 * n * d * d + 4.0 * n * d * hid + 4.0 * n * n * d
    return audio_embed_flops(s) + a["depth"] * per_layer + cls_pool_flops(td, fd, d, hid)


def audio_embed_flops(s: dict) -> float:
    a, d = s["audio"], s["d"]
    fd, td = _ast_grid(a)
    return 2.0 * fd * td * a["patch"] * a["patch"] * d


def head_flops(s: dict) -> float:
    """One clip through the projections and the offset transformer."""
    t, d = s["transformer"], s["d"]
    v, a = s["video"], s["audio"]
    seg = s["segments"]
    nv, na = seg * (v["frames"] // v["z"]), seg * _ast_grid(a)[1]
    n = 2 + nv + na
    hid = _mlp_hidden(d, t["mlp_ratio"])
    per_layer = 2.0 * n * d * 4 * d + 4.0 * n * d * hid + 4.0 * n * n * d
    return 2.0 * (nv + na) * d * d + t["n_layer"] * per_layer + 2.0 * d * t["num_cls"]


def towers_flops(s: dict) -> float:
    """One clip through both towers."""
    return s["segments"] * (video_tower_flops(s) + audio_tower_flops(s))


def sync_forward_flops(s: dict) -> float:
    """Sync inference of one clip."""
    return towers_flops(s) + head_flops(s)


def avclip_step_flops(s: dict, batch: int) -> float:
    """One Stage I step over ``batch`` clips: every parameter trains."""
    per_clip = towers_flops(s)
    embeds = s["segments"] * (video_embed_flops(s) + audio_embed_flops(s))
    feats = batch * s["segments"]
    loss = 2 * 2.0 * feats * feats * s["d"]
    return batch * (3.0 * per_clip - embeds) + 3.0 * loss


def sync_step_flops(s: dict, batch: int) -> float:
    """One Stage II step over ``batch`` clips: the frozen towers forward,
    the projections and the offset transformer trained."""
    return batch * (towers_flops(s) + 3.0 * head_flops(s))
