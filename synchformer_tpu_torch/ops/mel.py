"""Log-mel front end on the device, as synchformer_tpu/ops/mel.py computes it.

torchaudio MelSpectrogram(16 kHz, win 400, hop 160, n_fft 1024, 128 HTK mels,
power 2, center + reflect pad), log(mel + 1e-6), pad/truncate to 66 frames,
AST normalisation (x - mean) / (2 std). The DFT is two f32 matmuls against
window-folded cosine/sine matrices (the same constants as the JAX package),
not torch.stft, so the numerics follow the reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MelSpectrogramConfig:
    sample_rate: int = 16_000
    n_fft: int = 1024
    win_length: int = 400
    hop_length: int = 160
    n_mels: int = 128
    f_min: float = 0.0
    f_max: Optional[float] = None
    log_eps: float = 1e-6
    norm_mean: float = -4.2677393
    norm_std: float = 4.5689974
    max_spec_t: Optional[int] = 66

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(cfg: MelSpectrogramConfig) -> np.ndarray:
    """HTK triangular filterbank (n_freqs, n_mels), norm=None."""
    f_max = cfg.f_max if cfg.f_max is not None else cfg.sample_rate / 2.0
    all_freqs = np.linspace(0.0, cfg.sample_rate / 2.0, cfg.n_freqs, dtype=np.float64)
    m_min, m_max = _hz_to_mel_htk(np.array([cfg.f_min, f_max]))
    f_pts = _mel_to_hz_htk(np.linspace(m_min, m_max, cfg.n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def dft_constants(cfg: MelSpectrogramConfig):
    """Window-folded real-DFT matrices (n_fft, n_freqs) and the filterbank."""
    n, k = cfg.n_fft, cfg.n_freqs
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(cfg.win_length) / cfg.win_length))
    window = np.zeros(n, dtype=np.float64)
    pad_left = (n - cfg.win_length) // 2
    window[pad_left:pad_left + cfg.win_length] = win
    angle = 2.0 * np.pi * np.outer(np.arange(n), np.arange(k)) / n
    cos_m = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_m = (-np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_m, sin_m, mel_filterbank(cfg)


def _frames(x: torch.Tensor, cfg: MelSpectrogramConfig) -> torch.Tensor:
    """(..., L) -> (..., 1 + L // hop, n_fft), centered with reflect padding."""
    lead = x.shape[:-1]
    pad = cfg.n_fft // 2
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    fr = xp[:, 0].unfold(-1, cfg.n_fft, cfg.hop_length)
    return fr.reshape(*lead, fr.shape[-2], cfg.n_fft)


def log_mel_spectrogram(waveform: torch.Tensor,
                        cfg: MelSpectrogramConfig = MelSpectrogramConfig()) -> torch.Tensor:
    """Waveform (..., L) -> normalised log-mel (..., n_mels, T), in f32."""
    # full-f32 products, as Precision.HIGHEST in the JAX package
    torch.backends.cuda.matmul.allow_tf32 = False
    cos_m, sin_m, fb = (torch.from_numpy(a).to(waveform.device) for a in dft_constants(cfg))
    frames = _frames(waveform.float(), cfg)
    re = torch.matmul(frames, cos_m)
    im = torch.matmul(frames, sin_m)
    mel = torch.matmul(re * re + im * im, fb).transpose(-1, -2)
    mel = torch.log(mel + cfg.log_eps)
    if cfg.max_spec_t is not None:
        t = mel.shape[-1]
        if t < cfg.max_spec_t:
            mel = F.pad(mel, (0, cfg.max_spec_t - t))
        else:
            mel = mel[..., :cfg.max_spec_t]
    return (mel - cfg.norm_mean) / (2.0 * cfg.norm_std)
