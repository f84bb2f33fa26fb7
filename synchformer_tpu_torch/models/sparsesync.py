"""The legacy SparseSync cross-modal transformer
(synchformer_tpu/models/sparsesync.py; ref:
model/modules/transformer.py:240-319): dense feature maps in, the visual
(B, t, h, w, D) and the audio (B, f, t, D), each through its pre-norm and
its factorized positional embedding, flattened, whole-token dropout, the
sequence [OFF | visual tokens | MOD | audio tokens], embedding dropout,
``n_layer`` pre-LN blocks (LN eps 1e-5, MLP 4D, exact GELU), ln_f, and a
bias-free offset head on the OFF token. A plain composition on every route,
as the GlobalTransformer's. Training (``deterministic=False`` with a
generator) draws the token dropouts (visual, then audio), the embedding
dropout, then each block's, as GlobalTransformer.encode does.

The pre-norms and the positional embeddings are modules built from their
config nodes by the registry (registry.build_sparsesync_transformer). State
names as the JAX parameters: ``OFF_tok``, ``MOD_tok``, ``pre_lnorm_vis``,
``pre_lnorm_aud``, ``vis_pos_emb``, ``aud_pos_emb``, ``blocks.{i}`` (the
sync transformer's minGPT names), ``ln_f``, ``off_head``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from synchformer_tpu_torch.models.layers import LayerNorm, Linear, MinGPTBlock, element_dropout
from synchformer_tpu_torch.models.sync_model import GlobalTransformer, token_dropout


class SparseSyncTransformer(nn.Module):
    def __init__(self, num_offset_cls: int, vis_pos_emb: nn.Module, aud_pos_emb: nn.Module,
                 pre_lnorm_vis: nn.Module, pre_lnorm_aud: nn.Module, n_layer: int = 12,
                 n_head: int = 8, n_embd: int = 256, tok_pdrop: float = 0.0,
                 embd_pdrop: float = 0.0, resid_pdrop: float = 0.0, attn_pdrop: float = 0.0,
                 device=None):
        super().__init__()
        d = n_embd
        self.n_embd = d
        self.tok_pdrop = float(tok_pdrop)
        self.embd_pdrop = float(embd_pdrop)
        self.OFF_tok = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.MOD_tok = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pre_lnorm_vis = pre_lnorm_vis
        self.pre_lnorm_aud = pre_lnorm_aud
        self.vis_pos_emb = vis_pos_emb
        self.aud_pos_emb = aud_pos_emb
        self.blocks = nn.ModuleList([MinGPTBlock(d, n_head, 1e-5, attn_dropout=attn_pdrop,
                                                 resid_dropout=resid_pdrop, device=device)
                                     for _ in range(n_layer)])
        self.ln_f = LayerNorm(d, 1e-5, device)
        self.off_head = Linear(d, num_offset_cls, bias=False, device=device)

    def forward(self, vis: torch.Tensor, aud: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """vis (B, t, h, w, D), aud (B, f, t, D) -> (B, num_offset_cls)."""
        generator = GlobalTransformer._generator(deterministic, generator)
        b, d = vis.shape[0], self.n_embd
        if vis.shape[-1] != d or aud.shape[-1] != d:
            raise ValueError(f"feature widths {vis.shape[-1]} / {aud.shape[-1]} are not n_embd "
                             f"{d}: define a bridge")
        vis = self.vis_pos_emb(self.pre_lnorm_vis(vis)).reshape(b, -1, d)
        aud = self.aud_pos_emb(self.pre_lnorm_aud(aud)).reshape(b, -1, d)
        if generator is not None:
            vis = token_dropout(vis, self.tok_pdrop, generator)
            aud = token_dropout(aud, self.tok_pdrop, generator)
        off = self.OFF_tok.to(vis.dtype).expand(b, 1, d)
        mod = self.MOD_tok.to(vis.dtype).expand(b, 1, d)
        x = torch.cat([off, vis, mod, aud], dim=1)
        if generator is not None:
            x = element_dropout(x, self.embd_pdrop, generator)
        for blk in self.blocks:
            x = blk(x, "plain", generator=generator)
        return self.off_head(self.ln_f(x)[:, 0, :])
