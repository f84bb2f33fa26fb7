"""Host-side geometry transforms: offset sampling, cropping, segmentation
(the port's copy of synchformer_tpu/data/transforms.py).

The reference implements ~25 torch nn.Modules composed per dataloader worker
(ref: dataset/transforms.py, configs/sync.yaml:120-252). Here the pipeline is
re-designed for a device feed:

- HOST (this module, pure numpy): the *geometry* — label-making offset
  sampling (TemporalCropAndOffset, ref: transforms.py:255-399), sliding-window
  segmentation (GenerateMultipleSegments, ref: transforms.py:402-499), spatial
  crop index selection, syncability offset sampling (ref: transforms.py:502-634).
  These are cheap index computations producing fixed-shape uint8/f32 arrays.
- DEVICE (ops/mel.py + ops/video.py + ops/dsp.py): everything that touches
  pixels/samples per-element — normalization, flip, color jitter, mel
  front-end, audio augmentations — runs on the card, batched over (B, S).

Randomness: every sampling function takes a numpy Generator — the equivalent
of the reference's per-worker `random` module usage, but explicit and
reproducible (fold the rank/epoch/index into the seed).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np


def sec2frames(sec: float, fps: float) -> int:
    return int(sec * fps)


def frames2sec(frames: int, fps: float) -> float:
    return frames / fps


def make_class_grid(leftmost_val: float, rightmost_val: float, grid_size: int,
                    add_extreme_offset: bool = False,
                    seg_size_vframes: Optional[int] = None,
                    nseg: Optional[int] = None,
                    step_size_seg: Optional[float] = None,
                    vfps: Optional[float] = None) -> np.ndarray:
    """21-point offset grid over [-2, 2] (ref: transforms.py:221-232).
    With add_extreme_offset, appends the out-of-sync extreme class at
    trim_len * seg_size seconds."""
    assert grid_size >= 3, f"grid_size {grid_size} makes no sense"
    grid = np.linspace(leftmost_val, rightmost_val, grid_size).astype(np.float32)
    if add_extreme_offset:
        assert all(v is not None for v in (seg_size_vframes, nseg, step_size_seg))
        seg_size_sec = seg_size_vframes / vfps
        trim_size_in_seg = nseg - (1 - step_size_seg) * (nseg - 1)
        grid = np.concatenate([grid, [trim_size_in_seg * seg_size_sec]]).astype(np.float32)
    return grid


def quantize_offset(grid: np.ndarray, off_sec: float) -> Tuple[float, int]:
    """Snap an offset to the nearest grid element -> (grid value, class index)
    (ref: transforms.py:235-239)."""
    idx = int(np.abs(grid - off_sec).argmin())
    return float(grid[idx]), idx


def grid_step_sec(grid: np.ndarray) -> float:
    return float(grid[1] - grid[0])


def equalify_from_right(v_len: int, a_len: int, v_fps: float, a_fps: float,
                        clip_max_len_sec: float = 10.0) -> Tuple[int, int]:
    """Trim stream lengths to a common duration from the right
    (ref: transforms.py:19-56). Returns (v_len_frames, a_len_frames)."""
    min_len = min(clip_max_len_sec, a_len / a_fps, v_len / v_fps)
    a_per_v = a_fps // v_fps
    v_frames = int(v_fps * min_len)
    a_frames = int(a_per_v * v_frames)
    assert a_frames <= a_len and v_frames <= v_len
    return v_frames, a_frames


def spatial_crop_indices(h: int, w: int, target: Tuple[int, int], is_random: bool,
                         rng: Optional[np.random.Generator] = None) -> Tuple[int, int]:
    """Top-left corner for a (th, tw) crop (ref: transforms.py:59-98)."""
    th, tw = target
    if h == th and w == tw:
        return 0, 0
    if is_random:
        return int(rng.integers(0, h - th + 1)), int(rng.integers(0, w - tw + 1))
    return int(round((h - th) / 2.0)), int(round((w - tw) / 2.0))


def apply_audio_jitter(a_start_i: int, a_len: int, a_crop_len: int, a_fps: float,
                       max_jitter_sec: float, rng: np.random.Generator) -> Tuple[int, int]:
    """±jitter on the audio start, clamped to valid range
    (ref: transforms.py:241-252)."""
    max_start = a_len - a_crop_len
    max_j = sec2frames(max_jitter_sec, a_fps)
    left = min(a_start_i, max_j)
    right = min(max_start - a_start_i, max_j)
    j = int(rng.integers(-left, right + 1))
    a_start_i += j
    assert 0 <= a_start_i <= max_start
    return a_start_i, j


@dataclasses.dataclass
class TemporalCrop:
    """Result of offset sampling: crop indices + label."""

    v_start_i: int
    v_len: int
    a_start_i: int
    a_len: int
    offset_sec: float
    v_start_i_sec: float
    offset_label: Optional[float] = None
    offset_target: Optional[int] = None
    sync_target: Optional[int] = None
    oos_target: Optional[int] = None


ITU_T_RANGE = (-0.125, 0.045)  # in-sync range for uniform_binary offsets


def sample_temporal_crop_and_offset(
    v_len: int, a_len: int, v_fps: float, a_fps: float,
    crop_len_sec: float, grid: Optional[np.ndarray],
    rng: np.random.Generator,
    *,
    offset_type: str = "grid",
    do_offset: bool = True,
    max_off_sec: float = 2.0,
    max_a_jitter_sec: float = 0.0,
    prob_oos: Optional[float] = None,
    fixed_offset_sec: Optional[float] = None,
    fixed_v_start_sec: Optional[float] = None,
    is_random_crop: bool = True,
) -> TemporalCrop:
    """The label-maker (ref: transforms.py:255-399): samples (or applies a
    fixed) temporal offset, crops video at v_start and audio at
    v_start + offset, optional audio jitter, quantizes the offset to a class.
    """
    v_crop = sec2frames(crop_len_sec, v_fps)
    a_crop = sec2frames(crop_len_sec, a_fps)
    oos = None

    if do_offset:
        if fixed_offset_sec is None and fixed_v_start_sec is None:
            if offset_type == "grid":
                offset_sec = float(rng.choice(grid))
            elif offset_type == "uniform":
                offset_sec = float(rng.uniform(-max_off_sec, max_off_sec))
            elif offset_type == "uniform_binary":
                oos = bool(rng.random() < prob_oos)
                if oos:
                    offset_sec = float(rng.uniform(-max_off_sec, max_off_sec))
                    while ITU_T_RANGE[0] <= offset_sec <= ITU_T_RANGE[1]:
                        offset_sec = float(rng.uniform(-max_off_sec, max_off_sec))
                else:
                    offset_sec = float(rng.uniform(*ITU_T_RANGE))
            else:
                raise NotImplementedError(offset_type)
            offset_sec = round(offset_sec, 2)
            v_start_max_sec = frames2sec(v_len - v_crop, v_fps)
            assert v_start_max_sec > 0, (v_len, v_crop, v_fps)
            v_start_sec = rng.uniform(max(0, -offset_sec),
                                      min(v_start_max_sec, v_start_max_sec - offset_sec))
            v_start_i = sec2frames(v_start_sec, v_fps)
            v_start_i_sec = frames2sec(v_start_i, v_fps)
        else:
            offset_sec = round(float(fixed_offset_sec), 2)
            v_start_i_sec = float(fixed_v_start_sec)
            v_start_i = sec2frames(v_start_i_sec, v_fps)
        a_start_i = sec2frames(v_start_i_sec + offset_sec, a_fps)
    else:
        offset_sec = 0.0
        if v_len == v_crop:
            v_start_i = 0
        elif is_random_crop:
            v_start_i = int(rng.integers(0, v_len - v_crop + 1))
        else:
            v_start_i = int(round((v_len - v_crop) / 2.0))
        v_start_i_sec = frames2sec(v_start_i, v_fps)
        a_start_i = sec2frames(v_start_i_sec, a_fps)

    # fix the rounding-error negative audio start (ref: transforms.py:346-355)
    if a_start_i < 0:
        if abs(a_start_i) <= a_fps / v_fps:
            a_start_i = 0
        else:
            raise ValueError(f"audio start too negative: {a_start_i}")

    if max_a_jitter_sec and max_a_jitter_sec > 0:
        a_start_i, _ = apply_audio_jitter(a_start_i, a_len, a_crop, a_fps,
                                          max_a_jitter_sec, rng)

    assert a_len >= a_start_i + a_crop and v_len >= v_start_i + v_crop

    crop = TemporalCrop(v_start_i=v_start_i, v_len=v_crop,
                        a_start_i=a_start_i, a_len=a_crop,
                        offset_sec=offset_sec, v_start_i_sec=v_start_i_sec)
    if do_offset:
        if offset_type == "grid":
            crop.offset_label, crop.offset_target = quantize_offset(grid, offset_sec)
        elif offset_type == "uniform":
            crop.offset_label = offset_sec
        elif offset_type == "uniform_binary":
            crop.offset_label = offset_sec
            crop.oos_target = int(oos) if oos is not None else None
    return crop


def sample_syncability_crop(
    v_len: int, a_len: int, v_fps: float, a_fps: float,
    grid: np.ndarray, rng: np.random.Generator,
    *,
    segment_size_vframes: int = 16,
    n_segments: int = 13,
    step_size_seg: float = 0.5,
    max_a_jitter_sec: float = 0.0,
    prob_syncable: float = 0.5,
    fixed_offset_sec: Optional[float] = None,
    fixed_v_start_sec: Optional[float] = None,
) -> TemporalCrop:
    """Stage III label-maker (ref: transforms.py:502-634): with prob 0.5 the
    clip gets a grid offset (syncable) or a ±crop_len offset (non-syncable).
    The crop length derives from the segment layout."""
    seg_size_sec = segment_size_vframes / v_fps
    trim_size_in_seg = n_segments - (1 - step_size_seg) * (n_segments - 1)
    crop_len_sec = round(trim_size_in_seg * seg_size_sec, 2)
    v_crop = sec2frames(crop_len_sec, v_fps)
    a_crop = sec2frames(crop_len_sec, a_fps)

    if fixed_offset_sec is None and fixed_v_start_sec is None:
        syncable = bool(rng.random() < prob_syncable)
        if syncable:
            offset_sec = float(rng.choice(grid))
        else:
            offset_sec = float(rng.choice([-crop_len_sec, crop_len_sec]))
        offset_sec = round(offset_sec, 2)
        v_start_max_sec = frames2sec(v_len - v_crop, v_fps)
        assert v_start_max_sec > 0
        v_start_sec = rng.uniform(max(0, -offset_sec),
                                  min(v_start_max_sec, v_start_max_sec - offset_sec))
        v_start_i = sec2frames(v_start_sec, v_fps)
        v_start_i_sec = frames2sec(v_start_i, v_fps)
    else:
        offset_sec = round(float(fixed_offset_sec), 2)
        v_start_i_sec = float(fixed_v_start_sec)
        v_start_i = sec2frames(v_start_i_sec, v_fps)
        syncable = bool(-2.0 <= offset_sec <= 2.0)

    a_start_i = sec2frames(v_start_i_sec + offset_sec, a_fps)
    if a_start_i < 0:
        if abs(a_start_i) <= a_fps / v_fps:
            a_start_i = 0
        else:
            raise ValueError(f"audio start too negative: {a_start_i}")
    if max_a_jitter_sec and max_a_jitter_sec > 0:
        a_start_i, _ = apply_audio_jitter(a_start_i, a_len, a_crop, a_fps,
                                          max_a_jitter_sec, rng)

    label, target = quantize_offset(grid, offset_sec)
    return TemporalCrop(v_start_i=v_start_i, v_len=v_crop,
                        a_start_i=a_start_i, a_len=a_crop,
                        offset_sec=offset_sec, v_start_i_sec=v_start_i_sec,
                        offset_label=label, offset_target=target,
                        sync_target=int(syncable))


def segment_ranges(v_len: int, a_len: int, v_fps: float, a_fps: float,
                   segment_size_vframes: int, n_segments: Optional[int],
                   step_size_seg: float, is_start_random: bool,
                   rng: Optional[np.random.Generator] = None,
                   audio_jitter_sec: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding-window segment (start, end) index ranges for both streams
    (ref: transforms.py:402-499). Returns (v_ranges, a_ranges), each (S, 2)."""
    seg_v = segment_size_vframes
    seg_a = sec2frames(frames2sec(seg_v, v_fps), a_fps)
    step_v = int(step_size_seg * seg_v)
    step_a = int(step_size_seg * seg_a)
    n_max_v = math.floor((v_len - seg_v) / step_v) + 1
    n_max_a = math.floor((a_len - seg_a) / step_a) + 1
    n_max = min(n_max_v, n_max_a)
    n_seg = n_max if n_segments is None else n_segments
    assert n_seg <= n_max, f"cannot fit {n_seg} segments (max {n_max})"

    seq_len_in_seg = n_seg * step_size_seg + (1 - step_size_seg)
    v_seq_len = int(seq_len_in_seg * seg_v)
    a_seq_len = int(seq_len_in_seg * seg_a)

    max_v_start = v_len - v_seq_len
    if is_start_random:
        v_start = int(rng.integers(0, max_v_start + 1))
    else:
        v_start = max_v_start // 2
    a_start = sec2frames(frames2sec(v_start, v_fps), a_fps)

    v_starts = v_start + np.arange(n_seg) * step_v
    a_starts = a_start + np.arange(n_seg) * step_a

    if audio_jitter_sec > 0:
        j = sec2frames(audio_jitter_sec, a_fps)
        j = min(j, a_start, a_len - a_start - a_seq_len)
        a_starts = a_starts + int(rng.integers(-j, j + 1))

    v_ranges = np.stack([v_starts, v_starts + seg_v], axis=1)
    a_ranges = np.stack([a_starts, a_starts + seg_a], axis=1)
    assert (a_ranges >= 0).all() and (a_ranges <= a_len).all()
    assert (v_ranges <= v_len).all()
    return v_ranges.astype(np.int64), a_ranges.astype(np.int64)


def gather_segments(video: np.ndarray, audio: np.ndarray,
                    v_ranges: np.ndarray, a_ranges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(Tv, H, W, C), (Ta,) -> (S, seg_v, H, W, C), (S, seg_a) via one gather."""
    seg_v = int(v_ranges[0, 1] - v_ranges[0, 0])
    seg_a = int(a_ranges[0, 1] - a_ranges[0, 0])
    v_idx = v_ranges[:, :1] + np.arange(seg_v)[None, :]
    a_idx = a_ranges[:, :1] + np.arange(seg_a)[None, :]
    return video[v_idx], audio[a_idx]


def bilinear_resize_u8(frames: np.ndarray, out_hw) -> np.ndarray:
    """Vectorized bilinear resize of (T, H, W, C) uint8 frames (host-side;
    used by the sometimes-smaller-crop-then-upscale aug,
    ref: transforms.py:110-137)."""
    t, h, w, c = frames.shape
    oh, ow = out_hw
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1).astype(np.float32)[None, :, None, None]
    wx = np.clip(xs - x0, 0, 1).astype(np.float32)[None, None, :, None]
    f = frames.astype(np.float32)
    top = f[:, y0][:, :, x0] * (1 - wx) + f[:, y0][:, :, x1] * wx
    bot = f[:, y1][:, :, x0] * (1 - wx) + f[:, y1][:, :, x1] * wx
    return np.clip(top * (1 - wy) + bot * wy, 0, 255).astype(np.uint8)


@dataclasses.dataclass
class SyncPipelineConfig:
    """Knobs of the sync data pipeline (ref: configs/sync.yaml data section)."""

    vfps: float = 25.0
    afps: float = 16_000.0
    input_size: int = 224
    size_before_crop: int = 256
    crop_len_sec: float = 5.0
    max_off_sec: float = 2.0
    num_off_cls: int = 21
    offset_type: str = "grid"
    prob_oos: Optional[float] = None
    segment_size_vframes: int = 16
    n_segments: int = 14
    step_size_seg: float = 0.5
    audio_jitter_sec: float = 0.05
    sometimes_upscale_p: float = 0.0
    smaller_input_size: int = 192
    p_horizontal_flip: float = 0.5
    p_gray_scale: float = 0.0
    p_color_jitter: float = 0.0
    p_audio_aug: float = 0.0
    clip_max_len_sec: float = 10.0
    is_spatial_crop_random: bool = True
    is_temporal_crop_random: bool = True
    do_offset: bool = True
    for_syncability: bool = False

    def class_grid(self) -> np.ndarray:
        return make_class_grid(-self.max_off_sec, self.max_off_sec, self.num_off_cls)


def prepare_item(video: np.ndarray, audio: np.ndarray, cfg: SyncPipelineConfig,
                 rng: np.random.Generator, split: str = "train",
                 fixed_offset_sec: Optional[float] = None,
                 fixed_v_start_sec: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Full host-side geometry pipeline for one clip.

    video: (Tv, H, W, C) uint8 at vfps; audio: (Ta,) float32 at afps.
    Returns fixed-shape arrays ready for device staging:
      video (S, 16, input, input, C) uint8, audio (S, seg_a) f32, plus targets.
    Pixel-level work (normalize/flip/jitter/mel) happens on device.
    """
    from synchformer_tpu_torch.data import avstage

    is_train = split == "train"
    v_len, h, w, c = video.shape
    a_len = audio.shape[0]

    # 1) trim to equal duration (EqualifyFromRight)
    v_len, a_len = equalify_from_right(v_len, a_len, cfg.vfps, cfg.afps,
                                       cfg.clip_max_len_sec)

    # 2) spatial crop indices (applied inside the fused native gather below);
    # with prob sometimes_upscale_p a smaller crop is taken and upscaled back
    # to input_size (RGBSpatialCropSometimesUpscale, ref: transforms.py:110-137)
    crop_size = cfg.input_size
    if is_train and cfg.sometimes_upscale_p and rng.random() < cfg.sometimes_upscale_p:
        crop_size = cfg.smaller_input_size
    ci, cj = spatial_crop_indices(h, w, (crop_size, crop_size),
                                  cfg.is_spatial_crop_random and is_train, rng)

    # 3) temporal crop + offset label
    grid = cfg.class_grid()
    if cfg.for_syncability:
        crop = sample_syncability_crop(
            v_len, a_len, cfg.vfps, cfg.afps, grid, rng,
            segment_size_vframes=cfg.segment_size_vframes,
            n_segments=cfg.n_segments, step_size_seg=cfg.step_size_seg,
            max_a_jitter_sec=cfg.audio_jitter_sec if is_train else 0.0,
            fixed_offset_sec=fixed_offset_sec, fixed_v_start_sec=fixed_v_start_sec)
    else:
        crop = sample_temporal_crop_and_offset(
            v_len, a_len, cfg.vfps, cfg.afps, cfg.crop_len_sec, grid, rng,
            offset_type=cfg.offset_type, do_offset=cfg.do_offset,
            max_off_sec=cfg.max_off_sec,
            max_a_jitter_sec=cfg.audio_jitter_sec if is_train else 0.0,
            prob_oos=cfg.prob_oos,
            fixed_offset_sec=fixed_offset_sec, fixed_v_start_sec=fixed_v_start_sec,
            is_random_crop=is_train)

    # 4) sliding-window segmentation; the actual pixel/PCM copies run as ONE
    # fused crop+gather in the native avstage runtime (numpy fallback inside)
    v_ranges, a_ranges = segment_ranges(
        crop.v_len, crop.a_len, cfg.vfps, cfg.afps, cfg.segment_size_vframes,
        cfg.n_segments, cfg.step_size_seg,
        is_start_random=cfg.is_temporal_crop_random and is_train, rng=rng)
    seg_a = int(a_ranges[0, 1] - a_ranges[0, 0])
    video_seg = avstage.gather_video_segments(
        video, crop.v_start_i + v_ranges[:, 0], cfg.segment_size_vframes,
        (ci, cj), (crop_size, crop_size))
    if crop_size != cfg.input_size:
        sshape = video_seg.shape
        video_seg = bilinear_resize_u8(
            video_seg.reshape(-1, crop_size, crop_size, sshape[-1]),
            (cfg.input_size, cfg.input_size)).reshape(
            sshape[0], sshape[1], cfg.input_size, cfg.input_size, sshape[-1])
    audio_seg = avstage.gather_audio_segments(
        np.ascontiguousarray(audio, dtype=np.float32),
        crop.a_start_i + a_ranges[:, 0], seg_a)

    out = {
        "video": video_seg,                             # (S, 16, H', W', C) u8
        "audio": audio_seg,                             # (S, seg_a) f32
        "offset_sec": np.float32(crop.offset_sec),
        "v_start_i_sec": np.float32(crop.v_start_i_sec),
    }
    if is_train and cfg.p_audio_aug > 0:
        # audio augs apply to the contiguous cropped waveform BEFORE
        # segmentation (ref: configs/sync.yaml:151-171, AudioRandom* precede
        # GenerateMultipleSegments): ship the full crop + per-segment start
        # indices so the device can aug-then-gather (ops/dsp.aug_then_segment)
        out["audio_full"] = np.ascontiguousarray(
            audio[crop.a_start_i:crop.a_start_i + crop.a_len], dtype=np.float32)
        out["audio_seg_starts"] = a_ranges[:, 0].astype(np.int32)
    if crop.offset_target is not None:
        out["offset_target"] = np.int32(crop.offset_target)
    if crop.sync_target is not None:
        out["sync_target"] = np.int32(crop.sync_target)
    if crop.oos_target is not None:
        out["oos_target"] = np.int32(crop.oos_target)
    return out


# ---------------------------------------------------------------------------
# ingest-path transforms for non-canonical media
# (ref: transforms.py:892-966 — ResampleAudio/ResampleRGB/ResizeAndLetterboxPad)
# ---------------------------------------------------------------------------

def resample_rgb_by_index(video: np.ndarray, orig_fps: float, new_fps: float) -> np.ndarray:
    """Frame-index resampling (nearest frame on the new grid,
    ref: transforms.py:906-922)."""
    if orig_fps == new_fps:
        return video
    duration_sec = video.shape[0] / orig_fps
    indices = np.arange(0, orig_fps * duration_sec - 1e-9,
                        orig_fps / new_fps).astype(np.int64)
    return video[indices]


def resize_and_letterbox_pad(video: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Aspect-preserving resize + zero letterbox padding
    (ref: transforms.py:924-952). video: (T, H, W, C) uint8."""
    t, h, w, c = video.shape
    target_ar = new_w / new_h
    current_ar = w / h
    if current_ar > target_ar:
        scaled_h = round(new_w / current_ar)
        resized = bilinear_resize_u8(video, (scaled_h, new_w))
        top = (new_h - scaled_h) // 2
        out = np.zeros((t, new_h, new_w, c), dtype=np.uint8)
        out[:, top:top + scaled_h] = resized
    elif current_ar < target_ar:
        scaled_w = round(new_h * current_ar)
        resized = bilinear_resize_u8(video, (new_h, scaled_w))
        left = (new_w - scaled_w) // 2
        out = np.zeros((t, new_h, new_w, c), dtype=np.uint8)
        out[:, :, left:left + scaled_w] = resized
    else:
        out = bilinear_resize_u8(video, (new_h, new_w))
    return out


def ingest_noncanonical(video: np.ndarray, audio: np.ndarray, v_fps: float,
                        a_rate: float, *, target_vfps: float = 25.0,
                        target_afps: int = 16_000, new_h: int = 256,
                        new_w: int = 256):
    """ResampleResizeLetterboxPad equivalent (ref: transforms.py:955-966):
    bring arbitrary media to the canonical 25 fps / 16 kHz / letterboxed
    resolution. Audio resampling runs through ops/dsp.resample on CPU tensors."""
    video = resample_rgb_by_index(video, v_fps, target_vfps)
    video = resize_and_letterbox_pad(video, new_h, new_w)
    if a_rate != target_afps:
        import torch

        from synchformer_tpu_torch.ops.dsp import resample

        audio = resample(torch.as_tensor(np.asarray(audio, np.float32)), int(a_rate),
                         target_afps).numpy()
    return video, audio
