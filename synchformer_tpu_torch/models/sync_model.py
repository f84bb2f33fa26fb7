"""Synchformer offset model (synchformer_tpu/models/sync_model.py), inference.

Two towers -> per-modality Linear projections -> segment-flattened tokens ->
GlobalTransformer -> 21 offset logits. The GlobalTransformer (8 heads of 96)
has no TPU kernel in the JAX package; its attention stays the plain matmul +
f32-softmax composition on every route.
"""
from __future__ import annotations

import torch
from torch import nn

from synchformer_tpu_torch.models.ast_encoder import ASTEncoder
from synchformer_tpu_torch.models.bridges import LinearBridge
from synchformer_tpu_torch.models.layers import LayerNorm, MinGPTBlock
from synchformer_tpu_torch.models.motionformer import MotionFormerEncoder
from synchformer_tpu_torch.models.pos_emb import RandInitPositionalEncoding


class GlobalTransformer(nn.Module):
    """[OFF, v..., MOD, a...] -> pos-emb -> pre-LN blocks -> ln_f -> offset
    head on the OFF token. State names as the reference's ``transformer.*``."""

    def __init__(self, n_layer: int = 3, n_head: int = 8, n_embd: int = 768,
                 seq_len: int = 198, num_cls: int = 21, device=None):
        super().__init__()
        d = n_embd
        self.vis_in_lnorm = LayerNorm(d, 1e-5, device)
        self.aud_in_lnorm = LayerNorm(d, 1e-5, device)
        self.OFF_tok = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.MOD_tok = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_emb_cfg = RandInitPositionalEncoding([seq_len], d, device)
        self.blocks = nn.ModuleList([MinGPTBlock(d, n_head, 1e-5, device=device)
                                     for _ in range(n_layer)])
        self.ln_f = LayerNorm(d, 1e-5, device)
        self.off_head = LinearBridge(d, num_cls, device=device)

    def forward(self, v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        b, _, d = v.shape
        v = self.vis_in_lnorm(v)
        a = self.aud_in_lnorm(a)
        off = self.OFF_tok.to(v.dtype).expand(b, 1, d)
        mod = self.MOD_tok.to(v.dtype).expand(b, 1, d)
        x = self.pos_emb_cfg(torch.cat([off, v, mod, a], dim=1))
        for blk in self.blocks:
            x = blk(x, "plain")
        return self.off_head(self.ln_f(x)[:, 0, :])


class Synchformer(nn.Module):
    """Stage II offset model. ``forward(vis, aud)`` takes patch-major video
    (B, S, f, n, z*p*p*c) and log-mel (B, S, T, F) and returns (B, num_cls)
    logits."""

    def __init__(self, vfeat_extractor: dict, afeat_extractor: dict, d: int = 768,
                 n_segments: int = 14, n_layer: int = 3, n_head: int = 8,
                 num_cls: int = 21, device=None):
        super().__init__()
        self.vfeat_extractor = MotionFormerEncoder(embed_dim=d, device=device,
                                                   **vfeat_extractor)
        self.afeat_extractor = ASTEncoder(hidden_size=d, device=device, **afeat_extractor)
        tv = self.vfeat_extractor.f
        ta = self.afeat_extractor.grid_ft[1]
        self.vproj = LinearBridge(d, d, device=device)
        self.aproj = LinearBridge(d, d, device=device)
        self.transformer = GlobalTransformer(n_layer, n_head, d,
                                             seq_len=2 + n_segments * (tv + ta),
                                             num_cls=num_cls, device=device)

    def forward(self, vis: torch.Tensor, aud: torch.Tensor,
                impl: str = "plain") -> torch.Tensor:
        v = self.vproj(self.vfeat_extractor(vis, impl))
        a = self.aproj(self.afeat_extractor(aud, impl))
        b, s, tv, d = v.shape
        return self.transformer(v.reshape(b, s * tv, d), a.reshape(b, s * a.shape[2], d))

    @torch.no_grad()
    def cast_matrices_(self, dtype: torch.dtype) -> "Synchformer":
        """Matrices (Linear, conv and packed in-projection weights) to the
        compute dtype, once; LN parameters, biases, tokens and positional
        embeddings stay f32 and are cast where they are used."""
        for mod in self.modules():
            for name, p in mod.named_parameters(recurse=False):
                if name.endswith("weight") and p.ndim >= 2:
                    p.data = p.data.to(dtype)
        return self
