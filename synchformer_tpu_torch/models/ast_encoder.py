"""AST audio tower (synchformer_tpu/models/ast_encoder.py): features of 6 time
steps per segment through the frequency aggregator, then the time tail that
``agg_time_module`` names, as the JAX tower reads it (aggregators.time_tail):
'AveragePooling' (the Stage I configuration) their mean,
'TransformerEncoderLayer' a TemporalAggregator (K4), any other string (the
sync configs' 'Identity', the reference's 'torch.nn.Identity') none.
``agg_freq_module`` 'AveragePooling' takes the mean over frequency in place
of the FrequencyAggregator; any other string (not a pool) keeps the (f, t)
grid, as the JAX tower does. ``factorize_freq_time=False`` keeps the f * t
tokens of a segment, (B, S, f * t, D), with neither pool.

Patch conv 16x16, stride (10, 10) over the (F=128, T=66) log-mel, scanned
frequency-major (12 x 6 = 72 tokens) and run as one matmul on unfolded
patches; CLS and distillation tokens; 12 HF AST layers (LN eps 1e-12) on K3 +
K2; final LayerNorm; FrequencyAggregator on K4. ``remat=True`` wraps each
layer in torch.utils.checkpoint (checkpoint_with_generator: a recompute
draws the forward's dropouts). With ``add_global_repr`` a TemporalAggregator
with a positional embedding over ``max_segments`` pools the (B, S, D)
segment features into one global feature per clip (ast_encoder.py:177-186).

Training dropouts (JAX ast_encoder.py:124, :133-134, :158, :166, :182-184),
drawn from the caller's generator: ``hidden_dropout`` on the tokens after
their positional embedding, as each layer's residual dropout and as the
global aggregator's positional dropout; ``attn_dropout`` on each layer's
attention probabilities and as every aggregator's block dropout. Where a
rate is live the JAX layers leave their kernels (layers.preln_block).

``keep_mask`` (B, S, T, F), the content keep of the log-mel, becomes a token
keep: the minimum of the content over each patch's 16 x 16 window (JAX
:106-113), the CLS and distillation tokens kept; the layers and the
frequency aggregator mask their keys with it.

``extract_features=False`` is the AudioSet classifier (JAX :140-147): the
mean of the final CLS and distillation rows, a LayerNorm
(``classifier.layernorm``) and a Linear to ``num_labels``
(``classifier.dense``, the names of HF's ASTMLPHead); no aggregator is
built, and ``forward`` returns (B, S, num_labels) logits.

``forward`` returns the segment features, ``forward_with_global`` them and
the global feature. State names follow the reference (``ast.embeddings.*``,
``ast.encoder.layer.{i}.*``, ``ast.layernorm``, ``freq_attn_agg.*``,
``temp_attn_agg.*``, ``global_attn_agg.*``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from synchformer_tpu_torch.models.aggregators import (
    AveragePooling,
    FrequencyAggregator,
    TemporalAggregator,
    time_tail,
)
from synchformer_tpu_torch.models.layers import (
    ASTLayer,
    Container,
    LayerNorm,
    Linear,
    checkpoint_with_generator,
    element_dropout,
)
from synchformer_tpu_torch.ops.numerics import dense


class ASTEncoder(nn.Module):
    def __init__(self, hidden_size: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, frequency_stride: int = 10, time_stride: int = 10,
                 num_mel_bins: int = 128, max_spec_t: int = 66, ln_eps: float = 1e-12,
                 agg_freq_module: str = "TransformerEncoderLayer",
                 agg_time_module: str = "Identity", remat: bool = False,
                 hidden_dropout: float = 0.0, attn_dropout: float = 0.0,
                 add_global_repr: bool = False, max_segments: Optional[int] = None,
                 mlp_ratio: float = 4.0, extract_features: bool = True,
                 factorize_freq_time: bool = True, num_labels: int = 527, device=None):
        super().__init__()
        d = hidden_size
        self.extract_features = extract_features
        self.factorize = factorize_freq_time
        self.hidden_dropout = float(hidden_dropout)
        pools = extract_features and factorize_freq_time
        freq_pools = agg_freq_module in ("TransformerEncoderLayer", "AveragePooling")
        tail = time_tail(agg_time_module, d, num_heads, device, attn_dropout) if pools else None
        if tail is not None and not freq_pools:
            raise ValueError(f"the time tail {agg_time_module!r} takes (BS, t, D) features: "
                             f"agg_freq_module {agg_freq_module!r} pools no frequency")
        if add_global_repr and tail is None:
            raise ValueError("add_global_repr pools (B, S, D) segment features: it needs "
                             "agg_time_module 'AveragePooling' or 'TransformerEncoderLayer' "
                             "on a factorized feature tower")
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
                [ASTLayer(d, num_heads, ln_eps, mlp_ratio, attn_dropout, hidden_dropout,
                          device=device) for _ in range(depth)])),
            layernorm=LayerNorm(d, ln_eps, device))
        if not extract_features:
            self.classifier = Container(layernorm=LayerNorm(d, ln_eps, device),
                                        dense=Linear(d, num_labels, device=device))
        self.freq_attn_agg = None
        if pools and agg_freq_module == "TransformerEncoderLayer":
            self.freq_attn_agg = FrequencyAggregator(d, num_heads, dropout=attn_dropout,
                                                     device=device)
        elif pools and agg_freq_module == "AveragePooling":
            self.freq_attn_agg = AveragePooling(1)
        self.temp_attn_agg = tail
        self.max_segments = max_segments
        self.global_attn_agg = (
            TemporalAggregator(d, num_heads, dropout=attn_dropout, add_pos_emb=True,
                               pos_max_len=max_segments if max_segments is not None else 16,
                               pos_emb_drop=hidden_dropout, device=device)
            if add_global_repr else None)

    def forward(self, x: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, S, T, F) log-mel in the compute dtype -> (B, S, t, D), or
        (B, S, D) with a time tail ((B, S, num_labels) logits in
        classification mode). ``deterministic=False`` trains: the live
        dropouts are drawn from ``generator``."""
        return self.forward_with_global(x, impl, deterministic, generator, keep_mask)[0]

    def token_keep(self, keep_mask: torch.Tensor) -> torch.Tensor:
        """(B, S, T, F) content keep -> (B*S, 2 + f*t) token keep: the minimum
        over each patch window, frequency-major, above 0.5; CLS and
        distillation kept."""
        b, s, t_spec, f_spec = keep_mask.shape
        km = keep_mask.reshape(b * s, t_spec, f_spec).transpose(1, 2).unsqueeze(1).float()
        pooled = -F.max_pool2d(-km, self.patch_size, stride=self.strides)
        tok = pooled.reshape(b * s, -1) > 0.5
        return torch.cat([torch.ones(b * s, 2, dtype=torch.bool, device=tok.device), tok], 1)

    def forward_with_global(self, x: torch.Tensor, impl: str = "plain",
                            deterministic: bool = True,
                            generator: Optional[torch.Generator] = None,
                            keep_mask: Optional[torch.Tensor] = None):
        """forward's features and, with add_global_repr, the (B, D) global
        feature (else None)."""
        if not deterministic and generator is None:
            raise ValueError("training (deterministic=False) needs a generator")
        gen = None if deterministic else generator
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
        tok_keep = None if keep_mask is None else self.token_keep(keep_mask)
        aux = torch.cat([emb.cls_token, emb.distillation_token], dim=1).to(dtype)
        tokens = torch.cat([aux.expand(b * s, 2, d), tokens], dim=1)
        tokens = tokens + emb.position_embeddings.to(dtype)
        if gen is not None:
            tokens = element_dropout(tokens, self.hidden_dropout, gen)
        for layer in self.ast.encoder.layer:
            if self.remat:
                tokens = checkpoint_with_generator(
                    lambda t, g, layer=layer: layer(t, impl, generator=g, keep_mask=tok_keep),
                    gen, tokens)
            else:
                tokens = layer(tokens, impl, generator=gen, keep_mask=tok_keep)
        tokens = self.ast.layernorm(tokens)
        if not self.extract_features:
            pooled = (tokens[:, 0] + tokens[:, 1]) / 2.0
            logits = self.classifier.dense(self.classifier.layernorm(pooled))
            return logits.reshape(b, s, -1), None
        if not self.factorize:
            return tokens[:, 2:, :].reshape(b, s, fdim * tdim, d), None
        feats = tokens[:, 2:, :].reshape(b * s, fdim, tdim, d)
        if self.freq_attn_agg is None:
            return feats.reshape(b, s, fdim, tdim, d), None
        feat_keep = None if tok_keep is None else tok_keep[:, 2:].reshape(b * s, fdim, tdim)
        feats = self.freq_attn_agg(feats, impl, deterministic, generator, feat_keep)
        if self.temp_attn_agg is None:
            return feats.reshape(b, s, tdim, d), None
        feats = self.temp_attn_agg(feats, impl, deterministic, generator).reshape(b, s, d)
        if self.global_attn_agg is None:
            return feats, None
        return feats, self.global_attn_agg(feats, impl, deterministic, generator)
