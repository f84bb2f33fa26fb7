"""Video front end.

Eval (synchformer_tpu/ops/video.py::patchify_frames, fold_video_normalize):
frames arrive as uint8 patch-major tokens, and the affine x / 255 / 0.5 - 1 is
folded into the patch-embed weights, so the 3-D patch conv becomes one dense
matmul on raw bytes.

Training (prepare_video_batch): the fold cannot apply to an embed that
trains, so uint8 frames are normalised on the device in the compute dtype,
with the per-clip colour jitter and grayscale (random_color_jitter, each split
into a draw and an apply) and horizontal flip, and then patchified there
(patchify_frames takes torch tensors on any device).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def patchify_frames(x, z_block: int = 2, patch: int = 16):
    """(..., T, H, W, C) -> (..., T // z, (H // p) * (W // p), z * p * p * C),
    each patch vector flattened in (z, ph, pw, c) order. numpy or torch."""
    *lead, t, h, w, c = x.shape
    f, gh, gw = t // z_block, h // patch, w // patch
    if (t, h, w) != (f * z_block, gh * patch, gw * patch):
        raise ValueError(f"frames {x.shape} do not tile into {z_block}x{patch}x{patch}")
    x = x.reshape(*lead, f, z_block, gh, patch, gw, patch, c)
    k = len(lead)
    perm = tuple(range(k)) + tuple(i + k for i in (0, 2, 4, 1, 3, 5, 6))
    x = x.transpose(perm) if isinstance(x, np.ndarray) else x.permute(perm)
    return x.reshape(*lead, f, gh * gw, z_block * patch * patch * c)


# the towers' frame normalisation: (x / 255 - mean) / std
VIDEO_MEAN, VIDEO_STD = 0.5, 0.5


@torch.no_grad()
def fold_video_normalize(weight: torch.Tensor, bias: torch.Tensor):
    """Conv3d patch-embed (D, C, z, p, p) weight and bias of the normalised
    input -> (weight, bias) of the same conv applied to raw [0, 255] input:
    conv(x * s - m / std) = s * conv(x) - m / std * sum(kernel) + bias."""
    scale = 1.0 / (255.0 * VIDEO_STD)
    shift = VIDEO_MEAN / VIDEO_STD
    w32 = weight.float()
    new_b = bias.float() - w32.sum(dim=(1, 2, 3, 4)) * shift
    return (w32 * scale).to(weight.dtype), new_b.to(bias.dtype)


def normalize_frames(video_u8: torch.Tensor) -> torch.Tensor:
    """uint8 frames in [0, 255] -> (x / 255 - mean) / std in f32, the
    normalisation fold_video_normalize folds into a patch embed."""
    return (video_u8.float() / 255.0 - VIDEO_MEAN) / VIDEO_STD


def patch_embed_matrix(weight: torch.Tensor) -> torch.Tensor:
    """Conv3d weight (D, C, z, p, p) -> Linear weight (D, z * p * p * C) in
    patchify_frames' (z, ph, pw, c) order."""
    return weight.permute(0, 2, 3, 4, 1).reshape(weight.shape[0], -1)


# ITU-R 601 luma weights (torchvision rgb_to_grayscale) and the YIQ basis of
# the hue rotation (synchformer_tpu/ops/video.py:25, :51-55)
_LUMA = (0.299, 0.587, 0.114)
_YIQ_FROM_RGB = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322), (0.211, -0.523, 0.312))


def _luma(x: torch.Tensor) -> torch.Tensor:
    return x.new_tensor(_LUMA)


def adjust_brightness(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return x * factor


def adjust_contrast(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Blend with each frame's mean luma (over H, W and C, times 3)."""
    mean = (x * _luma(x)).mean(dim=(-3, -2, -1), keepdim=True) * 3.0
    return (x - mean) * factor + mean


def adjust_saturation(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    gray = (x * _luma(x)).sum(-1, keepdim=True)
    return (x - gray) * factor + gray


def adjust_hue(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The JAX package's approximate hue rotation by 2 pi delta in YIQ space
    (``delta`` broadcasts against x[..., 0])."""
    yiq_from_rgb = x.new_tensor(_YIQ_FROM_RGB)
    rgb_from_yiq = torch.linalg.inv(yiq_from_rgb.float()).to(x.dtype)
    yiq = x @ yiq_from_rgb.t()
    angle = 2.0 * torch.pi * delta
    cos, sin = torch.cos(angle), torch.sin(angle)
    rot = torch.stack([yiq[..., 0], yiq[..., 1] * cos - yiq[..., 2] * sin,
                       yiq[..., 1] * sin + yiq[..., 2] * cos], dim=-1)
    return rot @ rgb_from_yiq.t()


def to_grayscale(x: torch.Tensor) -> torch.Tensor:
    return (x * _luma(x)).sum(-1, keepdim=True).expand(x.shape)


def draw_color_jitter(b: int, generator: torch.Generator, p_color_jitter: float,
                      p_gray_scale: float, s: float = 1.0,
                      device=None) -> Optional[Dict[str, torch.Tensor]]:
    """The per-clip draws of random_color_jitter (synchformer_tpu/ops/video.py
    :69): whether to jitter, whether to gray, f32 brightness / contrast /
    saturation factors in [max(0, 1 - 0.8 s), 1 + 0.8 s] and a hue shift in
    [-0.2 s, 0.2 s], each (b,), drawn in that order. None where both
    probabilities are 0: nothing is drawn."""
    if p_color_jitter == 0.0 and p_gray_scale == 0.0:
        return None

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=generator, device=device)

    apply_jitter = torch.rand(b, generator=generator, device=device) < p_color_jitter
    apply_gray = torch.rand(b, generator=generator, device=device) < p_gray_scale
    lo, hi = max(0.0, 1.0 - 0.8 * s), 1.0 + 0.8 * s
    return {"apply_jitter": apply_jitter, "apply_gray": apply_gray,
            "brightness": uniform(lo, hi), "contrast": uniform(lo, hi),
            "saturation": uniform(lo, hi), "hue": uniform(-0.2 * s, 0.2 * s)}


def apply_color_jitter(x: torch.Tensor, draws: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """[0, 1] video (B, S, T, H, W, C) -> brightness, contrast, saturation,
    hue, clipped to [0, 1], on the clips drawn to jitter; then grayscale on
    those drawn to gray. Computed in f32, returned in x's dtype."""
    if draws is None:
        return x
    x32 = x.float()

    def clip(t):
        return t.reshape(-1, *(1,) * (x.ndim - 1))

    jit = adjust_brightness(x32, clip(draws["brightness"]))
    jit = adjust_contrast(jit, clip(draws["contrast"]))
    jit = adjust_saturation(jit, clip(draws["saturation"]))
    jit = adjust_hue(jit, draws["hue"].reshape(-1, *(1,) * (x.ndim - 2)))
    x32 = torch.where(clip(draws["apply_jitter"]), jit.clamp(0.0, 1.0), x32)
    x32 = torch.where(clip(draws["apply_gray"]), to_grayscale(x32), x32)
    return x32.to(x.dtype)


def prepare_video_batch(video_u8: torch.Tensor, generator: Optional[torch.Generator] = None,
                        train: bool = False, p_horizontal_flip: float = 0.5,
                        dtype: torch.dtype = torch.float32, p_color_jitter: float = 0.0,
                        p_gray_scale: float = 0.0) -> torch.Tensor:
    """uint8 (B, S, T, H, W, C) -> (x / 255 - 0.5) / 0.5 in ``dtype``
    (synchformer_tpu/ops/video.py::prepare_video_batch). With ``train``, each
    clip (all of its segments) is colour-jittered and grayed with their
    probabilities (draw_color_jitter; nothing drawn where both are 0), then
    flipped along W with probability ``p_horizontal_flip``, one draw per clip
    from ``generator``."""
    x = video_u8.to(dtype) / 255.0
    if train:
        if generator is None:
            raise ValueError("the training augmentations need a generator")
        x = apply_color_jitter(x, draw_color_jitter(x.shape[0], generator, p_color_jitter,
                                                    p_gray_scale, device=x.device))
        flip = torch.rand(x.shape[0], generator=generator, device=x.device) < p_horizontal_flip
        x = torch.where(flip.reshape(-1, *(1,) * (x.ndim - 1)), x.flip(-2), x)
    return (x - 0.5) / 0.5
