"""Model presets: the full-width sync model (configs/sync.yaml model section,
as synchformer_tpu/models/presets.py::build_synchformer; with
``syncability``, configs/ft_synchability.yaml's) and its 8-head
video-tower variant (build_synchformer_8head), the full-width Stage I AVCLIP
(configs/segment_avclip.yaml, as build_avclip), its 8-head variant
(build_avclip_8head), the MoCo Stage I model at the same widths with global
representations (build_moco_avclip), and tiny ones for the CPU tests. The
8-head towers run the packed flow and take ``attn_impl`` ('pallas' or
'pallas_fused', the JAX option). All come in f32: SyncPredictor casts the
sync model's matrices to the compute dtype once; AVCLIP and MoCo train f32
master parameters under the activations' compute dtype."""
from __future__ import annotations

from synchformer_tpu_torch.models.avclip import AVCLIP
from synchformer_tpu_torch.models.moco_clip import MultilevelMoCoCLIP
from synchformer_tpu_torch.models.sync_model import Synchformer

D = 768
N_OFFSET_CLS = 21

# tiny widths for the CPU parity tests: 4 heads of 64 (the JAX split path's
# 128-lane grouping holds), depth 2, 32 px frames in 8 px patches, 4 frames
# -> 2 temporal tokens; the real mel geometry (128 x 66 -> 74 AST tokens)
TINY = dict(d=256, heads=4, audio_heads=4, depth=2, img_size=32, patch_size=8,
            temporal_resolution=2, n_layer=2)
# the packed-flow counterpart: a video tower of 2 heads of 96, which do not
# pair into 128 lanes, so the JAX Motionformer takes its packed flow
# (motionformer.py:554-559); the AST keeps heads of 64, as build_avclip_8head
TINY_PACKED = dict(TINY, d=192, heads=2, audio_heads=3)


def build_synchformer(n_segments: int = 14, syncability: bool = False,
                      device=None) -> Synchformer:
    """ViT-B towers (D=768, 12 layers of 12 heads of 64) and a 3-layer,
    8-head GlobalTransformer over 2 + 14 n_segments tokens with the
    configs' dropouts (tok 0, embd / resid / attn 0.1): 21 offset logits
    (configs/sync.yaml), or with ``syncability`` 2 syncability logits
    (configs/ft_synchability.yaml, n_segments 13, pos-emb 184)."""
    return Synchformer(
        vfeat_extractor=dict(depth=12, num_heads=12),
        afeat_extractor=dict(depth=12, num_heads=12),
        d=D, n_segments=n_segments, n_layer=3, n_head=8, num_cls=N_OFFSET_CLS,
        syncability=syncability, device=device).eval()


def build_synchformer_8head(n_segments: int = 14, attn_impl: str = "pallas",
                            device=None) -> Synchformer:
    """build_synchformer with the video tower at 8 heads of 96, which runs the
    packed flow (as build_avclip_8head does for Stage I)."""
    return Synchformer(
        vfeat_extractor=dict(depth=12, num_heads=8, attn_impl=attn_impl),
        afeat_extractor=dict(depth=12, num_heads=12),
        d=D, n_segments=n_segments, n_layer=3, n_head=8, num_cls=N_OFFSET_CLS,
        device=device).eval()


def build_tiny_synchformer(n_segments: int = 2, device=None, t: dict = TINY,
                           attn_impl: str = "pallas", syncability: bool = False,
                           dropout: float = 0.1, drop_path_rate: float = 0.2) -> Synchformer:
    """Towers and transformer at the tiny widths ``t`` (TINY or TINY_PACKED);
    ``dropout`` is the transformer's embd / resid / attn rate,
    ``drop_path_rate`` the video tower's (live only where it trains)."""
    return Synchformer(
        vfeat_extractor=dict(depth=t["depth"], num_heads=t["heads"],
                             patch_size=t["patch_size"], img_size=t["img_size"],
                             temporal_resolution=t["temporal_resolution"],
                             attn_impl=attn_impl, drop_path_rate=drop_path_rate),
        afeat_extractor=dict(depth=t["depth"], num_heads=t["audio_heads"]),
        d=t["d"], n_segments=n_segments, n_layer=t["n_layer"], n_head=t["heads"],
        num_cls=N_OFFSET_CLS, syncability=syncability, embd_pdrop=dropout,
        resid_pdrop=dropout, attn_pdrop=dropout, device=device).eval()


def build_avclip(remat: bool = False, device=None) -> AVCLIP:
    """ViT-B Motionformer and AST towers (D=768, 12 layers of 12 heads of 64)
    with the AveragePooling time tail, DoNothingBridge projections,
    init_scale 0.07 clamped to [0.001, 0.5]; Motionformer drop-path 0.2 (its
    default, which configs/segment_avclip.yaml keeps), every dropout 0."""
    return AVCLIP(vfeat_extractor=dict(depth=12, num_heads=12, remat=remat,
                                       drop_path_rate=0.2),
                  afeat_extractor=dict(depth=12, num_heads=12, remat=remat),
                  d=D, device=device)


def build_avclip_8head(remat: bool = False, device=None, attn_impl: str = "pallas") -> AVCLIP:
    """build_avclip with an 8-head video tower: 8 heads of 96, the head layout
    of configs/sync.yaml's GlobalTransformer (n_head 8, n_embd 768). Heads of
    96 do not pair into 128 TPU lanes, so the JAX Motionformer runs its packed
    flow (motionformer.py:554-559), which reaches K7a and K7c; this is the
    widest such shape, at the published width and depth, and it puts them
    under the same Stage I step as build_avclip. No published checkpoint has
    an 8-head Motionformer: the JAX package runs it through its config
    (vfeat_extractor.params.num_heads: 8)."""
    return AVCLIP(vfeat_extractor=dict(depth=12, num_heads=8, remat=remat,
                                       drop_path_rate=0.2, attn_impl=attn_impl),
                  afeat_extractor=dict(depth=12, num_heads=12, remat=remat),
                  d=D, device=device)


def build_moco_avclip(remat: bool = False, device=None) -> MultilevelMoCoCLIP:
    """build_avclip's towers and scales as MultilevelMoCoCLIP with global
    representations: both towers add_global_repr with a
    TransformerEncoderLayer segment aggregator over 14 segments (the towers
    must agree, config/sanity.py:25); the Motionformer's pos_dropout 0.1
    (drop_rate 0), which puts the query pass's video global aggregator on
    K4b; the AST's dropouts 0. queue_size 1024 (a segment queue of 1024 x 14
    and a global queue of 1024) and momentum 0.995 are chosen, not taken from
    a shipped config."""
    glob = dict(add_global_repr=True, max_segments=14, remat=remat)
    return MultilevelMoCoCLIP(
        vfeat_extractor=dict(depth=12, num_heads=12, drop_path_rate=0.2, pos_dropout=0.1,
                             **glob),
        afeat_extractor=dict(depth=12, num_heads=12, **glob),
        d=D, queue_size=1024, momentum=0.995, device=device)


def build_tiny_moco_avclip(remat: bool = False, drop_path_rate: float = 0.0,
                           pos_dropout: float = 0.1, device=None) -> MultilevelMoCoCLIP:
    """build_moco_avclip at the TINY widths and depth 1, max_segments 2,
    queue_size 4 (queues of 8 and 4), momentum 0.9."""
    t = TINY
    glob = dict(add_global_repr=True, max_segments=2, remat=remat)
    return MultilevelMoCoCLIP(
        vfeat_extractor=dict(depth=1, num_heads=t["heads"], patch_size=t["patch_size"],
                             img_size=t["img_size"],
                             temporal_resolution=t["temporal_resolution"],
                             drop_path_rate=drop_path_rate, pos_dropout=pos_dropout, **glob),
        afeat_extractor=dict(depth=1, num_heads=t["audio_heads"], **glob),
        d=t["d"], queue_size=4, momentum=0.9, device=device)


def build_tiny_avclip(remat: bool = False, drop_path_rate: float = 0.0,
                      device=None) -> AVCLIP:
    return _tiny_avclip(TINY, remat, drop_path_rate, device)


def build_tiny_avclip_packed(remat: bool = False, drop_path_rate: float = 0.0,
                             device=None, attn_impl: str = "pallas") -> AVCLIP:
    """TINY_PACKED towers: the video tower runs the packed flow."""
    return _tiny_avclip(TINY_PACKED, remat, drop_path_rate, device, attn_impl)


def _tiny_avclip(t: dict, remat: bool, drop_path_rate: float, device,
                 attn_impl: str = "pallas") -> AVCLIP:
    return AVCLIP(vfeat_extractor=dict(depth=t["depth"], num_heads=t["heads"],
                                       patch_size=t["patch_size"], img_size=t["img_size"],
                                       temporal_resolution=t["temporal_resolution"],
                                       remat=remat, drop_path_rate=drop_path_rate,
                                       attn_impl=attn_impl),
                  afeat_extractor=dict(depth=t["depth"], num_heads=t["audio_heads"],
                                       remat=remat),
                  d=t["d"], device=device)
