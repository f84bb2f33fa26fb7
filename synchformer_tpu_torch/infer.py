"""Sync inference entry point (the port of bench.py::infer).

    predictor = SyncPredictor(model)   # device="cuda", dtype=torch.bfloat16
    probs = predictor(video_u8_patches, pcm)   # (B, 21) offset probabilities

Input: patch-major uint8 video (B, S, 8, 196, 1536) from ``patchify_frames``
(or the uint8 frames (B, S, 16, 224, 224, 3), patchified on the device, with
which the content keep-masks ``vis_mask`` / ``aud_mask`` may be given)
and PCM (B, S, 10240); for a model whose video tower is the legacy S3D,
uint8 frames (B, S, T, H, W, C), normalised on the device as the patch embed
folds them for the Motionformer (mean 0.5, std 0.5 of [0, 1]: S3D pads its
convs, so the normalisation cannot fold into its first one). The log-mel front end runs on the device in f32, at
the AST's geometry (``max_spec_t`` frames of ``n_mels`` bins, 66 x 128 by
default; a model built from a checkpoint's config takes them from its
``info``); the towers and the transformer run in ``dtype``. ``impl='kernel'`` is the main
path (K1-K4 on CUDA tensors); ``impl='plain'`` is the reference composition.
"""
from __future__ import annotations

import torch

from synchformer_tpu_torch.models.motionformer import MotionFormerEncoder
from synchformer_tpu_torch.models.sync_model import Synchformer
from synchformer_tpu_torch.ops.mel import MelSpectrogramConfig, log_mel_spectrogram
from synchformer_tpu_torch.ops.video import fold_video_normalize, normalize_frames


class SyncPredictor:
    """Wraps a Synchformer whose weights take normalised frames: folds the
    video normalisation into its patch embed (in place; a Motionformer), moves
    it to ``device`` (the card unless the caller asks for the CPU) and casts
    its matrices to ``dtype`` once."""

    def __init__(self, model: Synchformer, device="cuda", dtype: torch.dtype = torch.bfloat16,
                 impl: str = "kernel", max_spec_t: int = 66, n_mels: int = 128):
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.device = torch.device(device)
        self.dtype = dtype
        self.impl = impl
        self.mel_cfg = MelSpectrogramConfig(max_spec_t=max_spec_t, n_mels=n_mels)
        self.folded = isinstance(model.vfeat_extractor, MotionFormerEncoder)
        if self.folded:
            conv = model.vfeat_extractor.patch_embed_3d.proj
            with torch.no_grad():
                w, b = fold_video_normalize(conv.weight.float(), conv.bias.float())
                conv.weight.data = w
                conv.bias.data = b
        self.model = model.to(self.device).cast_matrices_(dtype).eval()

    @torch.no_grad()
    def logits(self, video_u8_patches: torch.Tensor, pcm: torch.Tensor,
               vis_mask: torch.Tensor | None = None,
               aud_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Offset logits. ``vis_mask`` (B, S, T, H, W, C), with uint8 frames
        of that shape in place of patches, and ``aud_mask`` (B, S,
        max_spec_t, n_mels) are the towers' content keep-masks
        (Synchformer.forward)."""
        video = video_u8_patches.to(self.device, non_blocking=True)
        if not self.folded:
            video = normalize_frames(video).to(self.dtype)
        mel = log_mel_spectrogram(pcm.to(self.device, non_blocking=True),
                                  self.mel_cfg)  # (B, S, n_mels, max_spec_t)
        aud = mel.transpose(-1, -2).to(self.dtype)
        masks = {name: m.to(self.device, non_blocking=True)
                 for name, m in (("vis_mask", vis_mask), ("aud_mask", aud_mask))
                 if m is not None}
        return self.model(video, aud, impl=self.impl, **masks)[1]

    def __call__(self, video_u8_patches: torch.Tensor, pcm: torch.Tensor,
                 vis_mask: torch.Tensor | None = None,
                 aud_mask: torch.Tensor | None = None) -> torch.Tensor:
        return torch.softmax(self.logits(video_u8_patches, pcm, vis_mask, aud_mask).float(),
                             dim=-1)
