"""Model presets: the full-width sync model (configs/sync.yaml model section,
as synchformer_tpu/models/presets.py::build_synchformer) and a tiny one for
the CPU tests. Both come in f32; SyncPredictor casts the matrices to the
compute dtype."""
from __future__ import annotations

from synchformer_tpu_torch.models.sync_model import Synchformer

D = 768
N_OFFSET_CLS = 21

# tiny widths for the CPU parity tests: 4 heads of 64 (the JAX split path's
# 128-lane grouping holds), depth 2, 32 px frames in 8 px patches, 4 frames
# -> 2 temporal tokens; the real mel geometry (128 x 66 -> 74 AST tokens)
TINY = dict(d=256, heads=4, depth=2, img_size=32, patch_size=8,
            temporal_resolution=2, n_layer=2)


def build_synchformer(n_segments: int = 14, device=None) -> Synchformer:
    """ViT-B towers (D=768, 12 layers of 12 heads of 64) and a 3-layer,
    8-head GlobalTransformer."""
    return Synchformer(
        vfeat_extractor=dict(depth=12, num_heads=12),
        afeat_extractor=dict(depth=12, num_heads=12),
        d=D, n_segments=n_segments, n_layer=3, n_head=8, num_cls=N_OFFSET_CLS,
        device=device).eval()


def build_tiny_synchformer(n_segments: int = 2, device=None) -> Synchformer:
    t = TINY
    return Synchformer(
        vfeat_extractor=dict(depth=t["depth"], num_heads=t["heads"],
                             patch_size=t["patch_size"], img_size=t["img_size"],
                             temporal_resolution=t["temporal_resolution"]),
        afeat_extractor=dict(depth=t["depth"], num_heads=t["heads"]),
        d=t["d"], n_segments=n_segments, n_layer=t["n_layer"], n_head=t["heads"],
        num_cls=N_OFFSET_CLS, device=device).eval()
