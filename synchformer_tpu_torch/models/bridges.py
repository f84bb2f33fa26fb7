"""Projection bridges (synchformer_tpu/models/bridges.py): LinearBridge, which
the reference configs name ``torch.nn.Linear`` (the sync model's 768 -> 768
audio and video projections and the offset head), and DoNothingBridge, the
identity of the Stage I configuration."""
from __future__ import annotations

import torch
from torch import nn

from synchformer_tpu_torch.models.layers import Linear


class LinearBridge(Linear):
    """Plain Linear projection with flax Dense numerics; state names
    ``weight``, ``bias``."""


class DoNothingBridge(nn.Module):
    """Identity (configs/segment_avclip.yaml's aproj / vproj); no parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x
