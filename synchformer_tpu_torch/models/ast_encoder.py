"""AST audio tower (synchformer_tpu/models/ast_encoder.py): features of 6 time
steps per segment through the frequency aggregator, then the time tail that
``agg_time_module`` names, as the JAX tower reads it (aggregators.time_tail):
'AveragePooling' (the Stage I configuration) their mean,
'TransformerEncoderLayer' a TemporalAggregator (K4), any other string (the
sync configs' 'Identity', the reference's 'torch.nn.Identity') none.
``agg_freq_module`` 'AveragePooling' takes the mean over frequency in place
of the FrequencyAggregator.

Patch conv 16x16, stride (10, 10) over the (F=128, T=66) log-mel, scanned
frequency-major (12 x 6 = 72 tokens) and run as one matmul on unfolded
patches; CLS and distillation tokens; 12 HF AST layers (LN eps 1e-12) on K3 +
K2; final LayerNorm; FrequencyAggregator on K4. Its dropouts are not
ported: ``hidden_dropout`` and ``attn_dropout`` above 0 are refused, so
training runs the same route (the kernels' autograd Functions carry the
backward); ``remat=True`` wraps each layer in torch.utils.checkpoint. With
``add_global_repr`` a TemporalAggregator with a positional embedding over
``max_segments`` pools the (B, S, D) segment features into one global feature
per clip (ast_encoder.py:177-186); its positional dropout is hidden_dropout,
0, so it runs on K4. ``forward`` returns the segment features,
``forward_with_global`` them and the global feature. State names follow the
reference (``ast.embeddings.*``, ``ast.encoder.layer.{i}.*``,
``ast.layernorm``, ``freq_attn_agg.*``, ``temp_attn_agg.*``,
``global_attn_agg.*``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from synchformer_tpu_torch.models.aggregators import (
    AveragePooling,
    FrequencyAggregator,
    TemporalAggregator,
    time_tail,
)
from synchformer_tpu_torch.models.layers import ASTLayer, Container, LayerNorm
from synchformer_tpu_torch.ops.numerics import dense


class ASTEncoder(nn.Module):
    def __init__(self, hidden_size: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, frequency_stride: int = 10, time_stride: int = 10,
                 num_mel_bins: int = 128, max_spec_t: int = 66, ln_eps: float = 1e-12,
                 agg_freq_module: str = "TransformerEncoderLayer",
                 agg_time_module: str = "Identity", remat: bool = False,
                 hidden_dropout: float = 0.0, attn_dropout: float = 0.0,
                 add_global_repr: bool = False, max_segments: Optional[int] = None,
                 device=None):
        super().__init__()
        if agg_freq_module not in ("TransformerEncoderLayer", "AveragePooling"):
            raise ValueError(f"agg_freq_module must be 'TransformerEncoderLayer' or "
                             f"'AveragePooling', got {agg_freq_module!r}")
        if hidden_dropout > 0.0 or attn_dropout > 0.0:
            raise NotImplementedError("the AST's dropouts are not ported: set hidden_dropout "
                                      "and attn_dropout to 0")
        d = hidden_size
        tail = time_tail(agg_time_module, d, num_heads, device)
        if add_global_repr and tail is None:
            raise ValueError("add_global_repr pools (B, S, D) segment features: it needs "
                             "agg_time_module 'AveragePooling' or 'TransformerEncoderLayer'")
        self.patch_size = patch_size
        self.strides = (frequency_stride, time_stride)
        self.remat = remat
        self.grid_ft = ((num_mel_bins - patch_size) // frequency_stride + 1,
                        (max_spec_t - patch_size) // time_stride + 1)
        n_tok = 2 + self.grid_ft[0] * self.grid_ft[1]
        proj = nn.Conv2d(1, d, patch_size, stride=self.strides, device=device)
        embeddings = Container(patch_embeddings=Container(projection=proj))
        embeddings.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        embeddings.distillation_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        embeddings.position_embeddings = nn.Parameter(torch.zeros(1, n_tok, d, device=device))
        self.ast = Container(
            embeddings=embeddings,
            encoder=Container(layer=nn.ModuleList(
                [ASTLayer(d, num_heads, ln_eps, device=device) for _ in range(depth)])),
            layernorm=LayerNorm(d, ln_eps, device))
        self.freq_attn_agg = (FrequencyAggregator(d, num_heads, device=device)
                              if agg_freq_module == "TransformerEncoderLayer"
                              else AveragePooling(1))
        self.temp_attn_agg = tail
        self.max_segments = max_segments
        self.global_attn_agg = (
            TemporalAggregator(d, num_heads, add_pos_emb=True,
                               pos_max_len=max_segments if max_segments is not None else 16,
                               device=device)
            if add_global_repr else None)

    def forward(self, x: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, S, T, F) log-mel in the compute dtype -> (B, S, t, D), or
        (B, S, D) with a time tail. ``deterministic`` and ``generator`` are
        unused: no dropout is live, so training and eval are one computation."""
        return self.forward_with_global(x, impl)[0]

    def forward_with_global(self, x: torch.Tensor, impl: str = "plain"):
        """forward's features and, with add_global_repr, the (B, D) global
        feature (else None). No dropout is live, so training and eval are
        one computation."""
        b, s, t_spec, f_spec = x.shape
        emb = self.ast.embeddings
        w = emb.patch_embeddings.projection.weight
        dtype = x.dtype
        d = w.shape[0]
        fdim, tdim = self.grid_ft
        img = x.reshape(b * s, t_spec, f_spec).transpose(1, 2).unsqueeze(1)
        # (BS, 1, F, T) -> (BS, p*p, F'*T') with positions frequency-major
        cols = F.unfold(img, self.patch_size, stride=self.strides)
        tokens = dense(cols.transpose(1, 2), w.reshape(d, -1),
                       emb.patch_embeddings.projection.bias, dtype)
        aux = torch.cat([emb.cls_token, emb.distillation_token], dim=1).to(dtype)
        tokens = torch.cat([aux.expand(b * s, 2, d), tokens], dim=1)
        tokens = tokens + emb.position_embeddings.to(dtype)
        for layer in self.ast.encoder.layer:
            if self.remat:
                tokens = checkpoint(layer, tokens, impl, use_reentrant=False)
            else:
                tokens = layer(tokens, impl)
        tokens = self.ast.layernorm(tokens)
        feats = tokens[:, 2:, :].reshape(b * s, fdim, tdim, d)
        feats = self.freq_attn_agg(feats, impl)
        if self.temp_attn_agg is None:
            return feats.reshape(b, s, tdim, d), None
        feats = self.temp_attn_agg(feats, impl).reshape(b, s, d)
        if self.global_attn_agg is None:
            return feats, None
        return feats, self.global_attn_agg(feats, impl)
