"""Model presets: the full-width sync model (configs/sync.yaml model section,
as synchformer_tpu/models/presets.py::build_synchformer), the full-width
Stage I AVCLIP (configs/segment_avclip.yaml, as build_avclip), and tiny ones
for the CPU tests. All come in f32: SyncPredictor casts the sync model's
matrices to the compute dtype once; AVCLIP trains f32 master parameters under
the activations' compute dtype."""
from __future__ import annotations

from synchformer_tpu_torch.models.avclip import AVCLIP
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


def build_avclip(remat: bool = False, device=None) -> AVCLIP:
    """ViT-B Motionformer and AST towers (D=768, 12 layers of 12 heads of 64)
    with the AveragePooling time tail, DoNothingBridge projections,
    init_scale 0.07 clamped to [0.001, 0.5]; Motionformer drop-path 0.2 (its
    default, which configs/segment_avclip.yaml keeps), every dropout 0."""
    return AVCLIP(vfeat_extractor=dict(depth=12, num_heads=12, remat=remat,
                                       drop_path_rate=0.2),
                  afeat_extractor=dict(depth=12, num_heads=12, remat=remat),
                  d=D, device=device)


def build_tiny_avclip(remat: bool = False, drop_path_rate: float = 0.0,
                      device=None) -> AVCLIP:
    t = TINY
    return AVCLIP(vfeat_extractor=dict(depth=t["depth"], num_heads=t["heads"],
                                       patch_size=t["patch_size"], img_size=t["img_size"],
                                       temporal_resolution=t["temporal_resolution"],
                                       remat=remat, drop_path_rate=drop_path_rate),
                  afeat_extractor=dict(depth=t["depth"], num_heads=t["heads"], remat=remat),
                  d=t["d"], device=device)
