"""AVCLIP, the Stage I segment-level audio-visual contrastive model
(synchformer_tpu/models/avclip.py).

Two towers with the AveragePooling time tail give one feature per segment,
(B, S, D): the Motionformer and the AST built from their keyword dicts, or
towers built elsewhere and handed over as modules (the registry builds the
legacy S3D and ResNet-18 towers from their config nodes so, as the JAX
module instantiates any tower its config names); the projections ``vproj``
/ ``aproj`` (modules built from the config's nodes: DoNothingBridge by default, a LinearBridge for
``torch.nn.Linear``); the (B*S, D) features are
L2-normalised; the loss is the symmetric cross-entropy of
``sim = v @ a.T / clamp(logit_scale)`` in f32 (the temperature divides, as in
the reference). ``logit_scale`` is a 0-d f32 parameter, clamped to
[clamp_scale_min, clamp_scale_max] where it is used and after every update.

Over ranks (parallel/dist.py) the loss is the JAX step's over the global
batch: this rank's (n, D) rows are scored against every data rank's
(n_data * n, D) columns, gathered with a backward that sums over the data
group, and the positives sit on the data-rank-offset diagonal (labels
arange(n) + data_rank * n; model peers hold the same rows); the gathered
products run in f32, so that a column's gradient is rounded to the compute
dtype once, after the sum over ranks. The JAX trainer
passes no axis_name, so its InfoNCE spans the global batch whether
``gather_for_loss`` is set or not (synchformer_tpu/models/avclip.py:71-80);
the port does the same. At world 1 the gather is the identity.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from synchformer_tpu_torch.models.ast_encoder import ASTEncoder
from synchformer_tpu_torch.models.bridges import DoNothingBridge
from synchformer_tpu_torch.models.motionformer import MotionFormerEncoder
from synchformer_tpu_torch.parallel import dist as pdist
from synchformer_tpu_torch.utils import trace


class AVCLIP(nn.Module):
    def __init__(self, vfeat_extractor, afeat_extractor, d: int = 768,
                 init_scale: float = 0.07, clamp_scale_min: float = 0.001,
                 clamp_scale_max: float = 0.5, vproj: Optional[nn.Module] = None,
                 aproj: Optional[nn.Module] = None, device=None):
        super().__init__()
        self.init_scale = init_scale
        self.clamp_scale_min = clamp_scale_min
        self.clamp_scale_max = clamp_scale_max
        # each tower d wide unless its keywords name its own width (projected
        # to d by vproj / aproj, as the JAX module builds them); a module is
        # a tower built elsewhere, with its own time tail
        self.vfeat_extractor = (
            vfeat_extractor if isinstance(vfeat_extractor, nn.Module) else
            MotionFormerEncoder(**{"embed_dim": d, **vfeat_extractor},
                                agg_time_module="AveragePooling", device=device))
        self.afeat_extractor = (
            afeat_extractor if isinstance(afeat_extractor, nn.Module) else
            ASTEncoder(**{"hidden_size": d, **afeat_extractor},
                       agg_time_module="AveragePooling", device=device))
        self.vproj = vproj if vproj is not None else DoNothingBridge()
        self.aproj = aproj if aproj is not None else DoNothingBridge()
        self.logit_scale = nn.Parameter(torch.tensor(init_scale, dtype=torch.float32,
                                                     device=device))

    def scale(self) -> torch.Tensor:
        return self.logit_scale.clamp(self.clamp_scale_min, self.clamp_scale_max)

    @staticmethod
    def _normalise(feats: torch.Tensor, proj: nn.Module) -> torch.Tensor:
        b, s, d = feats.shape
        feats = proj(feats.reshape(b * s, d))
        norm = torch.linalg.vector_norm(feats.float(), dim=-1, keepdim=True)
        return feats / norm.clamp(min=1e-12).to(feats.dtype)

    def encode_video(self, vis, impl: str, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Frames in the video tower's layout (the Motionformer's patch-major
        (B, S, f, n, z*p*p*c), the S3D's (B, S, T, H, W, C)) -> L2-normalised
        (B*S, D)."""
        with trace.span("model.video_tower"):
            feats = self.vfeat_extractor(vis, impl, deterministic, generator)
        return self._normalise(feats, self.vproj)

    def encode_audio(self, aud, impl: str, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S, T, F) log-mel -> L2-normalised (B*S, D)."""
        with trace.span("model.audio_tower"):
            feats = self.afeat_extractor(aud, impl, deterministic, generator)
        return self._normalise(feats, self.aproj)

    def contrastive_loss(self, vfeat: torch.Tensor, afeat: torch.Tensor) -> torch.Tensor:
        """Symmetric InfoNCE with the temperature dividing the similarity: this
        rank's rows against the columns of every data rank, the positives on
        the data-rank-offset diagonal (model peers hold the same rows)."""
        scale = self.scale()
        n = vfeat.shape[0]
        labels = torch.arange(n, device=vfeat.device) + pdist.data_rank() * n
        if pdist.n_data() == 1:
            vfeat_all, afeat_all = vfeat, afeat
        else:
            # in f32 over data ranks: each rank's part of a column's gradient
            # is summed over them by the gather's backward, and rounded to the
            # compute dtype only after that sum, as world 1's one product
            # over the global batch accumulates it (bf16 parts that nearly
            # cancel would each be rounded first)
            vfeat, afeat = vfeat.float(), afeat.float()
            vfeat_all = pdist.all_gather_with_grad(vfeat)
            afeat_all = pdist.all_gather_with_grad(afeat)
        sim_v2a = (vfeat @ afeat_all.t()).float() / scale
        sim_a2v = (afeat @ vfeat_all.t()).float() / scale
        return (F.cross_entropy(sim_v2a, labels) + F.cross_entropy(sim_a2v, labels)) / 2.0

    def forward(self, vis, aud, impl: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Returns (loss, vfeat (B*S, D), afeat (B*S, D)). In training the
        video tower draws from ``generator`` first, then the audio tower."""
        vfeat = self.encode_video(vis, impl, deterministic, generator)
        afeat = self.encode_audio(aud, impl, deterministic, generator)
        with trace.span("model.head"):
            loss = self.contrastive_loss(vfeat, afeat)
        return loss, vfeat, afeat
