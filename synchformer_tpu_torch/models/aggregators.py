"""CLS-pooling aggregators (synchformer_tpu/models/aggregators.py).

The reference's BaseEncoderLayer (ref: visual/motionformer.py:275-347,
audio/ast.py:253-279): a learned CLS row plus one norm-first
nn.TransformerEncoderLayer, of which only the CLS row is kept. State names:
cls_token, norm1, norm2, self_attn.{in_proj_weight, in_proj_bias, out_proj},
linear1, linear2. The CLS row goes in as the block's shared ``cls_row``, so on
the kernel route the whole layer is K4. ``AveragePooling`` is the towers' time
tail in the Stage I configuration (configs/segment_avclip.yaml).
"""
from __future__ import annotations

import torch
from torch import nn

from synchformer_tpu_torch.models.layers import (
    BlockParams,
    Container,
    LayerNorm,
    Linear,
    PreLNBlock,
)


class CLSPoolEncoderLayer(PreLNBlock):
    """(B, N, D) -> (B, D): the CLS row of one pre-LN encoder layer over
    [cls; x]. LN eps 1e-6, MLP 4D, exact GELU."""

    def __init__(self, d: int, num_heads: int, eps: float = 1e-6, mlp_ratio: float = 4.0,
                 device=None):
        super().__init__(num_heads, eps)
        hidden = int(d * mlp_ratio)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.norm1 = LayerNorm(d, eps, device)
        self.norm2 = LayerNorm(d, eps, device)
        self.self_attn = Container(out_proj=Linear(d, d, device=device))
        self.self_attn.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d, device=device))
        self.self_attn.in_proj_bias = nn.Parameter(torch.zeros(3 * d, device=device))
        self.linear1 = Linear(d, hidden, device=device)
        self.linear2 = Linear(hidden, d, device=device)

    def block_params(self) -> BlockParams:
        sa = self.self_attn
        return BlockParams(
            self.norm1.weight, self.norm1.bias, sa.in_proj_weight, sa.in_proj_bias,
            sa.out_proj.weight, sa.out_proj.bias, self.norm2.weight, self.norm2.bias,
            self.linear1.weight, self.linear1.bias, self.linear2.weight, self.linear2.bias)

    def pool(self, x: torch.Tensor, impl: str) -> torch.Tensor:
        return super().forward(x, impl, query_rows=1, cls_row=self.cls_token[0])[:, 0, :]


class SpatialAggregator(CLSPoolEncoderLayer):
    """(BS, t, h, w, D) -> (BS, t, D): per-frame CLS attention over h*w tokens."""

    def forward(self, x: torch.Tensor, impl: str = "plain") -> torch.Tensor:
        bs, t, h, w, d = x.shape
        return self.pool(x.reshape(bs * t, h * w, d), impl).reshape(bs, t, d)


class FrequencyAggregator(CLSPoolEncoderLayer):
    """(BS, f, t, D) -> (BS, t, D): per-timestep CLS attention over f tokens."""

    def forward(self, x: torch.Tensor, impl: str = "plain") -> torch.Tensor:
        bs, f, t, d = x.shape
        flat = x.transpose(1, 2).reshape(bs * t, f, d)
        return self.pool(flat, impl).reshape(bs, t, d)


class AveragePooling(nn.Module):
    """Mean over one axis (synchformer_tpu/models/aggregators.py::
    AveragePooling with ``bs t d -> bs d``): (BS, t, D) -> (BS, D). No
    parameters."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=self.dim)
