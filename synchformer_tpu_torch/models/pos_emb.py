"""Positional encodings (synchformer_tpu/models/pos_emb.py; ref:
model/modules/transformer.py:100-237): the learned sequence encodings
``RandInitPositionalEncoding`` / ``ZeroInitPositionalEncoding`` (the same
computation; they differ in the JAX initialiser only), ``NoPosEncoding``,
the factorized learned encodings of the legacy SparseSync transformer,
``PositionEmbeddingLearnedVisual`` (t, h, w) and
``PositionEmbeddingLearnedAudio`` (f, t), and ``L2Normalize``. State names as
the JAX parameters: ``pos_emb``; ``time_embed``, ``height_embed``,
``width_embed``; ``freq_embed``, ``time_embed``.
"""
from __future__ import annotations

import torch
from torch import nn


class NoPosEncoding(nn.Module):
    """The identity; no parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class RandInitPositionalEncoding(nn.Module):
    """x + pos_emb[:, :N]; state name ``pos_emb`` of shape (1, *block_shape, D)."""

    def __init__(self, block_shape, n_embd: int, device=None):
        super().__init__()
        self.pos_emb = nn.Parameter(torch.zeros(1, *block_shape, n_embd, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sl = tuple(slice(0, s) for s in x.shape[1:-1])
        return x + self.pos_emb[(slice(None), *sl, slice(None))].to(x.dtype)


class ZeroInitPositionalEncoding(RandInitPositionalEncoding):
    """RandInitPositionalEncoding's computation (JAX: zero-initialised)."""


class PositionEmbeddingLearnedVisual(nn.Module):
    """x (B, t, h, w, D) + a factorized learned embedding over
    ``block_shape`` (max_t, max_h, max_w): D splits into D // 3 per axis with
    the remainder to time, concatenated [time | width | height]."""

    def __init__(self, block_shape, n_embd: int, device=None):
        super().__init__()
        max_t, max_h, max_w = block_shape
        n_each = n_embd // 3
        self.time_embed = nn.Parameter(torch.zeros(max_t, n_each + n_embd % 3, device=device))
        self.height_embed = nn.Parameter(torch.zeros(max_h, n_each, device=device))
        self.width_embed = nn.Parameter(torch.zeros(max_w, n_each, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, t, h, w, _ = x.shape
        te, he, we = self.time_embed[:t], self.height_embed[:h], self.width_embed[:w]
        pos = torch.cat([te[:, None, None, :].expand(t, h, w, -1),
                         we[None, None, :, :].expand(t, h, w, -1),
                         he[None, :, None, :].expand(t, h, w, -1)], dim=-1)
        return x + pos[None].to(x.dtype)


class PositionEmbeddingLearnedAudio(nn.Module):
    """x (B, f, t, D) + a factorized learned embedding over ``block_shape``
    (max_f, max_t): D // 2 for frequency, the rest for time, concatenated
    [freq | time]."""

    def __init__(self, block_shape, n_embd: int, device=None):
        super().__init__()
        max_f, max_t = block_shape
        n_f = n_embd // 2
        self.freq_embed = nn.Parameter(torch.zeros(max_f, n_f, device=device))
        self.time_embed = nn.Parameter(torch.zeros(max_t, n_f + n_embd % 2, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, f, t, _ = x.shape
        fe, te = self.freq_embed[:f], self.time_embed[:t]
        pos = torch.cat([fe[:, None, :].expand(f, t, -1), te[None, :, :].expand(f, t, -1)],
                        dim=-1)
        return x + pos[None].to(x.dtype)


class L2Normalize(nn.Module):
    """x / max(||x||_2, eps) over the last axis, the norm in f32."""

    def __init__(self, eps: float = 1e-12):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = x.float().square().sum(-1, keepdim=True).sqrt()
        return (x / norm.clamp_min(self.eps).to(x.dtype)).to(x.dtype)
