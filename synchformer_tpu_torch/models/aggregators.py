"""CLS-pooling aggregators (synchformer_tpu/models/aggregators.py).

The reference's BaseEncoderLayer (ref: visual/motionformer.py:275-347,
audio/ast.py:253-279): a learned CLS row plus one norm-first
nn.TransformerEncoderLayer, of which only the CLS row is kept, with an
optional learned positional embedding and its dropout (the global segment
aggregator, ``TemporalAggregator``). State names: cls_token, pos_emb, norm1,
norm2, self_attn.{in_proj_weight, in_proj_bias, out_proj}, linear1, linear2.
As in the JAX layer (aggregators.py:52-86), the CLS row goes in as the
block's shared ``cls_row`` (on the kernel route the whole layer is K4) unless
a keep-mask is given or the positional dropout is live; then [cls; x] is
formed, the embedding added and dropped, and the block runs with the CLS row
inside x (K4b where nothing else is stochastic and no keep-mask is given).
The block's own dropout (the tower's drop_rate or attn_dropout) is live in
training; the block then takes the plain composition, as the JAX block.
The spatial and frequency aggregators take the tower's token keep-mask.
``AveragePooling`` is the towers' time tail in the Stage I configuration
(configs/segment_avclip.yaml), and where a config names it, their frequency
or spatial pool. ``time_tail`` builds a tower's time tail from the JAX
option ``agg_time_module``. Each CLS-pool layer's call is a ``pool`` span of
the port's recorder (utils/trace.py).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from synchformer_tpu_torch.models.layers import (
    BlockParams,
    Container,
    LayerNorm,
    Linear,
    PreLNBlock,
    element_dropout,
)
from synchformer_tpu_torch.utils import trace


class CLSPoolEncoderLayer(PreLNBlock):
    """(B, N, D) -> (B, D): the CLS row of one pre-LN encoder layer over
    [cls; x]. LN eps 1e-6, MLP 4D, exact GELU. ``dropout`` is the block's
    attention and residual dropout, live in training. ``add_pos_emb`` adds a
    learned (1, 1 + pos_max_len, D) embedding to [cls; x], dropped at
    ``pos_emb_drop`` in training. ``keep_mask`` (B, N) masks keys; the CLS
    row is always kept."""

    def __init__(self, d: int, num_heads: int, eps: float = 1e-6, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, add_pos_emb: bool = False,
                 pos_max_len: Optional[int] = None, pos_emb_drop: float = 0.0, device=None):
        super().__init__(num_heads, eps, dropout, dropout)
        hidden = int(d * mlp_ratio)
        self.dropout = float(dropout)
        self.pos_emb_drop = float(pos_emb_drop)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        if add_pos_emb:
            if pos_max_len is None:
                raise ValueError("add_pos_emb needs pos_max_len")
            self.pos_emb = nn.Parameter(torch.zeros(1, 1 + pos_max_len, d, device=device))
        else:
            self.pos_emb = None
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

    def pool(self, x: torch.Tensor, impl: str, deterministic: bool = True,
             generator: Optional[torch.Generator] = None,
             keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """As the JAX layer (aggregators.py:49-87): the CLS row as the block's
        shared ``cls_row`` (split_cls) unless a keep-mask is given or the
        positional dropout is live; then [cls; x] explicitly, the keep-mask
        with the CLS row kept, the embedding added and dropped."""
        if not deterministic and generator is None:
            raise ValueError("training (deterministic=False) needs a generator")
        gen = None if deterministic else generator
        with trace.span("pool"):
            b, n, d = x.shape
            cls, pos = self.cls_token[0], self.pos_emb
            if keep_mask is None and (deterministic or self.pos_emb_drop == 0.0):  # split_cls
                if pos is not None:
                    cls = cls + pos[0, :1]
                    x = x + pos[:, 1:1 + n].to(x.dtype)
                return super().forward(x, impl, query_rows=1, cls_row=cls,
                                       generator=gen)[:, 0, :]
            x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, d), x], dim=1)
            if keep_mask is not None:
                keep_mask = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=x.device),
                                       keep_mask.bool()], dim=1)
            if pos is not None:
                x = x + pos[:, :1 + n].to(x.dtype)
                if gen is not None:
                    x = element_dropout(x, self.pos_emb_drop, gen)
            return super().forward(x, impl, query_rows=1, generator=gen,
                                   keep_mask=keep_mask)[:, 0, :]


class SpatialAggregator(CLSPoolEncoderLayer):
    """(BS, t, h, w, D) -> (BS, t, D): per-frame CLS attention over h*w
    tokens; ``keep_mask`` (BS, t, h, w)."""

    def forward(self, x: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bs, t, h, w, d = x.shape
        mask = None if keep_mask is None else keep_mask.reshape(bs * t, h * w)
        return self.pool(x.reshape(bs * t, h * w, d), impl, deterministic, generator,
                         mask).reshape(bs, t, d)


class FrequencyAggregator(CLSPoolEncoderLayer):
    """(BS, f, t, D) -> (BS, t, D): per-timestep CLS attention over f
    tokens; ``keep_mask`` (BS, f, t)."""

    def forward(self, x: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bs, f, t, d = x.shape
        flat = x.transpose(1, 2).reshape(bs * t, f, d)
        mask = None if keep_mask is None else keep_mask.transpose(1, 2).reshape(bs * t, f)
        return self.pool(flat, impl, deterministic, generator, mask).reshape(bs, t, d)


class TemporalAggregator(CLSPoolEncoderLayer):
    """(B, t, D) -> (B, D). With add_pos_emb=True this is the towers' global
    segment aggregator (ref: TemporalTransformerEncoderLayer,
    motionformer.py:378-393)."""

    def forward(self, x: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.pool(x, impl, deterministic, generator)


class AveragePooling(nn.Module):
    """Mean over ``dim`` (an axis or a tuple of axes;
    synchformer_tpu/models/aggregators.py::AveragePooling with ``bs t d -> bs
    d``, ``bs f t d -> bs t d`` or ``bs t h w d -> bs t d``), or, where the
    registry builds the JAX module from its config node, its einops
    ``avg_pattern`` mean-reduce and then the optional ``then_permute_pattern``
    rearrange. No parameters; the other arguments of a CLS-pool aggregator
    are accepted and, as in the JAX module, a keep-mask is ignored."""

    def __init__(self, dim=1, avg_pattern: Optional[str] = None,
                 then_permute_pattern: Optional[str] = None):
        super().__init__()
        self.dim = dim
        self.avg_pattern = avg_pattern
        self.then_permute_pattern = then_permute_pattern

    def forward(self, x: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None, keep_mask=None) -> torch.Tensor:
        if self.avg_pattern is None:
            return x.mean(dim=self.dim)
        import einops

        x = einops.reduce(x, self.avg_pattern, "mean")
        if self.then_permute_pattern is not None:
            x = einops.rearrange(x, self.then_permute_pattern)
        return x


def time_tail(agg_time_module: str, d: int, num_heads: int, device=None,
              dropout: float = 0.0) -> Optional[nn.Module]:
    """A tower's time tail, (BS, t, D) -> (BS, D), as the JAX towers read
    ``agg_time_module`` (ast_encoder.py:164-172, motionformer.py:684-692):
    'TransformerEncoderLayer' a TemporalAggregator without a positional
    embedding (K4 on the kernel route; ``dropout`` is its block's),
    'AveragePooling' the mean; any other string (the reference configs'
    'torch.nn.Identity', 'Identity') keeps the (BS, t, D) features: None."""
    if agg_time_module == "TransformerEncoderLayer":
        return TemporalAggregator(d, num_heads, dropout=dropout, device=device)
    if agg_time_module == "AveragePooling":
        return AveragePooling(1)
    return None
