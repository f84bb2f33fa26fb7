"""Sync inference entry point (the port of bench.py::infer).

    predictor = SyncPredictor(model)   # device="cuda", dtype=torch.bfloat16
    probs = predictor(video_u8_patches, pcm)   # (B, 21) offset probabilities

Input: patch-major uint8 video (B, S, 8, 196, 1536) from ``patchify_frames``
and PCM (B, S, 10240). The log-mel front end runs on the device in f32, at
the AST's geometry (``max_spec_t`` frames of ``n_mels`` bins, 66 x 128 by
default; a model built from a checkpoint's config takes them from its
``info``); the towers and the transformer run in ``dtype``. ``impl='kernel'`` is the main
path (K1-K4 on CUDA tensors); ``impl='plain'`` is the reference composition.
"""
from __future__ import annotations

import torch

from synchformer_tpu_torch.models.sync_model import Synchformer
from synchformer_tpu_torch.ops.mel import MelSpectrogramConfig, log_mel_spectrogram
from synchformer_tpu_torch.ops.video import fold_video_normalize


class SyncPredictor:
    """Wraps a Synchformer whose weights take normalised frames: folds the
    video normalisation into its patch embed (in place), moves it to
    ``device`` (the card unless the caller asks for the CPU) and casts its
    matrices to ``dtype`` once."""

    def __init__(self, model: Synchformer, device="cuda", dtype: torch.dtype = torch.bfloat16,
                 impl: str = "kernel", max_spec_t: int = 66, n_mels: int = 128):
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.device = torch.device(device)
        self.dtype = dtype
        self.impl = impl
        self.mel_cfg = MelSpectrogramConfig(max_spec_t=max_spec_t, n_mels=n_mels)
        conv = model.vfeat_extractor.patch_embed_3d.proj
        with torch.no_grad():
            w, b = fold_video_normalize(conv.weight.float(), conv.bias.float())
            conv.weight.data = w
            conv.bias.data = b
        self.model = model.to(self.device).cast_matrices_(dtype).eval()

    @torch.no_grad()
    def logits(self, video_u8_patches: torch.Tensor, pcm: torch.Tensor) -> torch.Tensor:
        video = video_u8_patches.to(self.device, non_blocking=True)
        mel = log_mel_spectrogram(pcm.to(self.device, non_blocking=True),
                                  self.mel_cfg)  # (B, S, n_mels, max_spec_t)
        aud = mel.transpose(-1, -2).to(self.dtype)
        return self.model(video, aud, impl=self.impl)[1]

    def __call__(self, video_u8_patches: torch.Tensor, pcm: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.logits(video_u8_patches, pcm).float(), dim=-1)
