"""Learned sequence positional encoding (synchformer_tpu/models/pos_emb.py::
RandInitPositionalEncoding; ref: model/modules/transformer.py:120-130)."""
from __future__ import annotations

import torch
from torch import nn


class RandInitPositionalEncoding(nn.Module):
    """x + pos_emb[:, :N]; state name ``pos_emb`` of shape (1, *block_shape, D)."""

    def __init__(self, block_shape, n_embd: int, device=None):
        super().__init__()
        self.pos_emb = nn.Parameter(torch.zeros(1, *block_shape, n_embd, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sl = tuple(slice(0, s) for s in x.shape[1:-1])
        return x + self.pos_emb[(slice(None), *sl, slice(None))].to(x.dtype)
