"""Synchformer offset model (synchformer_tpu/models/sync_model.py): inference
and the Stage II/III training forward.

Two towers -> per-modality Linear projections -> segment-flattened tokens ->
GlobalTransformer -> 21 offset logits (``GlobalTransformerWithSyncabilityHead``:
2 syncability logits from the OFF token instead). The GlobalTransformer (8
heads of 96) has no TPU kernel in the JAX package; its attention stays the
plain matmul + f32-softmax composition on every route.

Training (``deterministic=False`` with a generator): the transformer's
dropouts are live, drawn from the generator in this order: whole-token
dropout of the video tokens, then of the audio tokens (``tok_pdrop``), the
embedding dropout after the positional embedding (``embd_pdrop``), then each
block's (``attn_pdrop`` on the probabilities, ``resid_pdrop`` after the
projection and in the MLP). With ``extractors_deterministic`` the towers run
their eval path (K1-K4 on impl='kernel'), and where none of a tower's
parameters needs a gradient, under torch.no_grad(): no backward kernel runs
and no activation is kept. Otherwise they take the Stage I training route.

The towers may also be the legacy SparseSync ones (models/s3d.py,
models/resnet_audio.py), built from a config through the registry: S3D
takes frames. With extractors_deterministic False they train as the JAX
towers applied with mutable=["batch_stats"]: their BatchNorms normalise with
the batch's statistics (over the data ranks) and update their running
statistics, their aggregators' dropout is live; frozen, they run their eval
path under no_grad and their statistics stay as they are.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from synchformer_tpu_torch.models.ast_encoder import ASTEncoder
from synchformer_tpu_torch.models.bridges import LinearBridge
from synchformer_tpu_torch.models.layers import LayerNorm, MinGPTBlock, element_dropout
from synchformer_tpu_torch.models.motionformer import MotionFormerEncoder
from synchformer_tpu_torch.models.pos_emb import RandInitPositionalEncoding
from synchformer_tpu_torch.ops.kernels.fused_rows import pitched


def token_dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Whole-token dropout of (B, N, D) tokens (JAX _TokenDropout, torch
    Dropout1d): one draw per token, survivors scaled by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape[:-1] + (1,), generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class GlobalTransformer(nn.Module):
    """[OFF, v..., MOD, a...] -> pos-emb -> pre-LN blocks -> ln_f -> offset
    head on the OFF token. State names as the reference's ``transformer.*``.
    ``num_cls=None`` builds no head: forward then returns the sequence.
    ``pos_emb_cfg`` is the positional embedding, a RandInitPositionalEncoding
    over ``seq_len`` tokens here; the registry sets the module a config names
    (any of models/pos_emb.py), or None where the config names none, as the
    JAX module skips it."""

    def __init__(self, n_layer: int = 3, n_head: int = 8, n_embd: int = 768,
                 seq_len: int = 198, num_cls: Optional[int] = 21, tok_pdrop: float = 0.0,
                 embd_pdrop: float = 0.1, resid_pdrop: float = 0.1, attn_pdrop: float = 0.1,
                 device=None):
        super().__init__()
        d = n_embd
        self.tok_pdrop = float(tok_pdrop)
        self.embd_pdrop = float(embd_pdrop)
        self.vis_in_lnorm = LayerNorm(d, 1e-5, device)
        self.aud_in_lnorm = LayerNorm(d, 1e-5, device)
        self.OFF_tok = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.MOD_tok = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_emb_cfg = RandInitPositionalEncoding([seq_len], d, device)
        self.blocks = nn.ModuleList([MinGPTBlock(d, n_head, 1e-5, attn_dropout=attn_pdrop,
                                                 resid_dropout=resid_pdrop, device=device)
                                     for _ in range(n_layer)])
        self.ln_f = LayerNorm(d, 1e-5, device)
        self.off_head = None if num_cls is None else LinearBridge(d, num_cls, device=device)

    def encode(self, v: torch.Tensor, a: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The shared stem: the (B, 2 + Nv + Na, D) sequence after ln_f;
        ``generator`` makes the dropouts live."""
        b, _, d = v.shape
        v = self.vis_in_lnorm(v)
        a = self.aud_in_lnorm(a)
        if generator is not None:
            v = token_dropout(v, self.tok_pdrop, generator)
            a = token_dropout(a, self.tok_pdrop, generator)
        off = self.OFF_tok.to(v.dtype).expand(b, 1, d)
        mod = self.MOD_tok.to(v.dtype).expand(b, 1, d)
        x = torch.cat([off, v, mod, a], dim=1)
        if self.pos_emb_cfg is not None:
            x = self.pos_emb_cfg(x)
        if generator is not None:
            x = element_dropout(x, self.embd_pdrop, generator)
        for blk in self.blocks:
            x = blk(x, "plain", generator=generator)
        return self.ln_f(x)

    @staticmethod
    def _generator(deterministic: bool, generator: Optional[torch.Generator]):
        if deterministic:
            return None
        if generator is None:
            raise ValueError("training (deterministic=False) needs a generator")
        return generator

    def forward(self, v: torch.Tensor, a: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.encode(v, a, self._generator(deterministic, generator))
        return x if self.off_head is None else self.off_head(x[:, 0, :])


class GlobalTransformerWithSyncabilityHead(GlobalTransformer):
    """The Stage III transformer: 2-class syncability logits from the OFF
    token (``sync_head``); no offset head, as in the JAX module, whose
    off_head is never called and so holds no parameters."""

    def __init__(self, n_layer: int = 3, n_head: int = 8, n_embd: int = 768,
                 seq_len: int = 184, tok_pdrop: float = 0.0, embd_pdrop: float = 0.1,
                 resid_pdrop: float = 0.1, attn_pdrop: float = 0.1, device=None):
        super().__init__(n_layer, n_head, n_embd, seq_len, None, tok_pdrop, embd_pdrop,
                         resid_pdrop, attn_pdrop, device)
        self.sync_head = LinearBridge(n_embd, 2, device=device)

    def forward(self, v: torch.Tensor, a: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.sync_head(self.encode(v, a, self._generator(deterministic, generator))[:, 0, :])


class Synchformer(nn.Module):
    """Stage II offset model (or, with ``syncability``, the Stage III model).
    ``forward(vis, aud, targets)`` takes the video in its tower's layout
    (the Motionformer's patch-major (B, S, f, n, z*p*p*c); the legacy S3D's
    normalised frames (B, S, T, H, W, C)) and log-mel (B, S, T, F), and
    returns (loss, logits); the loss is None without targets.
    ``from_modules`` assembles one from built parts (the registry's route
    from a config; the legacy towers come only that way)."""

    def __init__(self, vfeat_extractor: dict, afeat_extractor: dict, d: int = 768,
                 n_segments: int = 14, n_layer: int = 3, n_head: int = 8,
                 num_cls: int = 21, syncability: bool = False, tok_pdrop: float = 0.0,
                 embd_pdrop: float = 0.1, resid_pdrop: float = 0.1, attn_pdrop: float = 0.1,
                 device=None):
        super().__init__()
        vfe = MotionFormerEncoder(embed_dim=d, device=device, **vfeat_extractor)
        afe = ASTEncoder(hidden_size=d, device=device, **afeat_extractor)
        seq_len = 2 + n_segments * (vfe.f + afe.grid_ft[1])
        drops = dict(tok_pdrop=tok_pdrop, embd_pdrop=embd_pdrop, resid_pdrop=resid_pdrop,
                     attn_pdrop=attn_pdrop, device=device)
        transformer = (GlobalTransformerWithSyncabilityHead(n_layer, n_head, d, seq_len, **drops)
                       if syncability else
                       GlobalTransformer(n_layer, n_head, d, seq_len, num_cls, **drops))
        self._assemble(vfe, afe, LinearBridge(d, d, device=device),
                       LinearBridge(d, d, device=device), transformer)

    def _assemble(self, vfe, afe, vproj, aproj, transformer) -> None:
        self.vfeat_extractor = vfe
        self.afeat_extractor = afe
        self.vproj = vproj
        self.aproj = aproj
        self.transformer = transformer

    @classmethod
    def from_modules(cls, vfeat_extractor: nn.Module, afeat_extractor: nn.Module,
                     vproj: nn.Module, aproj: nn.Module, transformer: nn.Module) -> "Synchformer":
        model = cls.__new__(cls)
        nn.Module.__init__(model)
        model._assemble(vfeat_extractor, afeat_extractor, vproj, aproj, transformer)
        return model

    def _features(self, tower: nn.Module, x: torch.Tensor, impl: str, deterministic: bool,
                  generator: Optional[torch.Generator],
                  keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A tower's features; a deterministic tower none of whose parameters
        needs a gradient runs under no_grad. ``keep_mask`` is passed only
        where given (the legacy towers take none)."""
        frozen = deterministic and not any(p.requires_grad for p in tower.parameters())
        masks = {} if keep_mask is None else {"keep_mask": keep_mask}
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            return tower(x, impl, deterministic, generator, **masks)

    def extract_vfeats(self, vis: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                       generator: Optional[torch.Generator] = None,
                       vis_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The video tower's (B, S, tv, D) features (JAX extract_vfeats);
        ``vis_mask`` the content keep of 6-D frames."""
        return self._features(self.vfeat_extractor, vis, impl, deterministic, generator,
                              vis_mask)

    def extract_afeats(self, aud: torch.Tensor, impl: str = "plain", deterministic: bool = True,
                       generator: Optional[torch.Generator] = None,
                       aud_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The audio tower's (B, S, ta, D) features (JAX extract_afeats);
        ``aud_mask`` the content keep of the (B, S, T, F) log-mel."""
        return self._features(self.afeat_extractor, aud, impl, deterministic, generator,
                              aud_mask)

    def forward(self, vis: torch.Tensor, aud: torch.Tensor,
                targets: Optional[torch.Tensor] = None, impl: str = "plain",
                deterministic: bool = True, generator: Optional[torch.Generator] = None,
                extractors_deterministic: Optional[bool] = True,
                vis_mask: Optional[torch.Tensor] = None,
                aud_mask: Optional[torch.Tensor] = None):
        """(loss, logits). ``extractors_deterministic`` True keeps the towers
        on their eval path while the transformer trains (Stage II's frozen
        towers); None follows ``deterministic``. ``vis_mask`` / ``aud_mask``:
        the towers' content keep-masks (JAX sync_model.py:154-172)."""
        if extractors_deterministic is None:
            extractors_deterministic = deterministic
        v = self.vproj(self.extract_vfeats(vis, impl, extractors_deterministic, generator,
                                           vis_mask))
        a = self.aproj(self.extract_afeats(aud, impl, extractors_deterministic, generator,
                                           aud_mask))
        b, s, tv, d = v.shape
        logits = self.transformer(v.reshape(b, s * tv, d), a.reshape(b, s * a.shape[2], d),
                                  deterministic, generator)
        return self.compute_loss(logits, targets), logits

    @staticmethod
    def compute_loss(logits: torch.Tensor, targets: Optional[torch.Tensor]):
        """The mean cross-entropy in f32 (JAX compute_loss), None without
        targets."""
        if targets is None:
            return None
        return F.cross_entropy(logits.float(), targets.long())

    @torch.no_grad()
    def cast_matrices_(self, dtype: torch.dtype, modules=None) -> "Synchformer":
        """Matrices (Linear, conv and packed in-projection weights) of
        ``modules`` (default: the whole model) to the compute dtype, once,
        a matrix with rows that are not 16 bytes at a 16-byte pitch
        (``pitched``: fc2 at a hidden width such as 1996, as K2 reads it);
        LN parameters, biases, tokens and positional embeddings stay f32 and
        are cast where they are used. A tensor-parallel shard
        (parallel/tensor.py) is only cast: the whole weight, gathered where
        it is read, is contiguous."""
        for root in (self,) if modules is None else modules:
            for mod in root.modules():
                shards = getattr(type(mod), "_tp_names", ())
                for name, p in mod.named_parameters(recurse=False):
                    if name.endswith("weight") and p.ndim == 2:
                        p.data = p.data.to(dtype) if name in shards else pitched(p.data, dtype)
                    elif name.endswith("weight") and p.ndim > 2:
                        p.data = p.data.to(dtype)
        return self
