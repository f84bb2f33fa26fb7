"""Video front end.

Eval (synchformer_tpu/ops/video.py::patchify_frames, fold_video_normalize):
frames arrive as uint8 patch-major tokens, and the affine x / 255 / 0.5 - 1 is
folded into the patch-embed weights, so the 3-D patch conv becomes one dense
matmul on raw bytes.

Training (prepare_video_batch): the fold cannot apply to an embed that
trains, so uint8 frames are normalised on the device in the compute dtype,
with the per-clip horizontal flip, and then patchified there (patchify_frames
takes torch tensors on any device).
"""
from __future__ import annotations

from typing import Optional

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


@torch.no_grad()
def fold_video_normalize(weight: torch.Tensor, bias: torch.Tensor,
                         mean: float = 0.5, std: float = 0.5):
    """Conv3d patch-embed (D, C, z, p, p) weight and bias of the normalised
    input -> (weight, bias) of the same conv applied to raw [0, 255] input:
    conv(x * s - m / std) = s * conv(x) - m / std * sum(kernel) + bias."""
    scale = 1.0 / (255.0 * std)
    shift = mean / std
    w32 = weight.float()
    new_b = bias.float() - w32.sum(dim=(1, 2, 3, 4)) * shift
    return (w32 * scale).to(weight.dtype), new_b.to(bias.dtype)


def patch_embed_matrix(weight: torch.Tensor) -> torch.Tensor:
    """Conv3d weight (D, C, z, p, p) -> Linear weight (D, z * p * p * C) in
    patchify_frames' (z, ph, pw, c) order."""
    return weight.permute(0, 2, 3, 4, 1).reshape(weight.shape[0], -1)


def prepare_video_batch(video_u8: torch.Tensor, generator: Optional[torch.Generator] = None,
                        train: bool = False, p_horizontal_flip: float = 0.5,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B, S, T, H, W, C) -> (x / 255 - 0.5) / 0.5 in ``dtype``
    (synchformer_tpu/ops/video.py::prepare_video_batch without colour
    jitter, whose probabilities are 0 in the Stage I configuration). With
    ``train``, each clip (all of its segments) is flipped along W with
    probability ``p_horizontal_flip``, one draw per clip from ``generator``."""
    x = video_u8.to(dtype) / 255.0
    if train:
        if generator is None:
            raise ValueError("the training flip needs a generator")
        flip = torch.rand(x.shape[0], generator=generator, device=x.device) < p_horizontal_flip
        x = torch.where(flip.reshape(-1, *(1,) * (x.ndim - 1)), x.flip(-2), x)
    return (x - 0.5) / 0.5
