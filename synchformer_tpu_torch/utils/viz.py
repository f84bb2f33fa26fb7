"""Observability: input-reconstruction sanity viz, per-class plots, heatmaps
(the port's copy of synchformer_tpu/utils/viz.py).

Capability parity with ref: utils/logger.py:162-280 and
scripts/train_utils.py:440-563 —

- **input reconstruction**: invert the whole audio pipeline (AST-denormalize
  -> exp -> inverse mel scale -> Griffin-Lim) and dump what the model actually
  ingests; the reference calls this its de-facto data-pipeline integration
  test ("detects bugs", ref: scripts/train_sync.py:166-173). Video frames are
  denormalized and written as image grids (no mp4 encoder is assumed).
- per-class accuracy bar plots + prediction/target histograms (matplotlib)
- segment-similarity heatmaps (v2a/a2v/v2v/a2a, ref: training/train.py:446-467)

Everything here is host-side numpy/scipy (observability only — the reference
keeps this off the hot path too).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from synchformer_tpu_torch.ops.mel import MelSpectrogramConfig, mel_filterbank


def denormalize_ast(spec: np.ndarray, cfg: MelSpectrogramConfig = MelSpectrogramConfig()) -> np.ndarray:
    """Undo AudioNormalizeAST: x * 2*std + mean (ref: logger.py:197-205)."""
    return spec * (2.0 * cfg.norm_std) + cfg.norm_mean


def inverse_mel(mel_power: np.ndarray, cfg: MelSpectrogramConfig = MelSpectrogramConfig()) -> np.ndarray:
    """(n_mels, T) mel power -> (n_freqs, T) linear power via fbank pinv
    (torchaudio InverseMelScale equivalent)."""
    fb = mel_filterbank(cfg)  # (n_freqs, n_mels)
    pinv = np.linalg.pinv(fb.astype(np.float64))  # (n_mels, n_freqs)
    linear = np.maximum(mel_power.T @ pinv, 0.0).T  # (n_freqs, T)
    return linear.astype(np.float32)


def griffin_lim(power_spec: np.ndarray, cfg: MelSpectrogramConfig = MelSpectrogramConfig(),
                n_iter: int = 32, seed: int = 0) -> np.ndarray:
    """Griffin-Lim phase reconstruction from a (n_freqs, T) power spectrogram
    (torchaudio GriffinLim equivalent; scipy STFT backend)."""
    from scipy.signal import ShortTimeFFT
    from scipy.signal.windows import hann

    mag = np.sqrt(np.maximum(power_spec, 0.0))
    win = hann(cfg.win_length, sym=False)
    win_padded = np.zeros(cfg.n_fft)
    pad = (cfg.n_fft - cfg.win_length) // 2
    win_padded[pad:pad + cfg.win_length] = win
    stft = ShortTimeFFT(win_padded, hop=cfg.hop_length, fs=cfg.sample_rate,
                        mfft=cfg.n_fft)
    rng = np.random.default_rng(seed)
    angles = np.exp(2j * np.pi * rng.random(mag.shape))
    n_samples = (mag.shape[1] - 1) * cfg.hop_length
    for _ in range(n_iter):
        wave = stft.istft(mag * angles, k1=n_samples)
        rebuilt = stft.stft(wave)[:, : mag.shape[1]]
        angles = np.exp(1j * np.angle(rebuilt))
    wave = stft.istft(mag * angles, k1=n_samples)
    peak = np.abs(wave).max()
    return (wave / peak if peak > 0 else wave).astype(np.float32)


def reconstruct_audio_from_batch(aud_spec: np.ndarray,
                                 cfg: MelSpectrogramConfig = MelSpectrogramConfig(),
                                 n_iter: int = 16) -> np.ndarray:
    """Normalized log-mel segments (S, T, F) -> waveform per segment (S, L).
    The full inversion chain of the reference's vizualize_input."""
    waves = []
    for seg in aud_spec:
        mel_log = denormalize_ast(seg.T)  # (F=128, T)
        mel_power = np.exp(mel_log) - cfg.log_eps
        linear = inverse_mel(np.maximum(mel_power, 0.0), cfg)
        waves.append(griffin_lim(linear, cfg, n_iter=n_iter))
    return np.stack(waves)


def save_input_reconstruction(video_u8: np.ndarray, aud_spec: np.ndarray,
                              out_dir: str, prefix: str = "recon",
                              max_frames: int = 8) -> Dict[str, str]:
    """Write a frame grid (png) + reconstructed waveform (npy/wav) for one clip
    (ref: utils/logger.py:162-242 writes mp4+jpg; we write png+wav)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = {}

    s, t = video_u8.shape[:2]
    fig, axes = plt.subplots(1, min(max_frames, s), figsize=(2 * max_frames, 2.4))
    for i, ax in enumerate(np.atleast_1d(axes)):
        ax.imshow(video_u8[i, t // 2])
        ax.set_title(f"seg {i}", fontsize=8)
        ax.axis("off")
    frame_path = str(out / f"{prefix}_frames.png")
    fig.savefig(frame_path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    paths["frames"] = frame_path

    waves = reconstruct_audio_from_batch(aud_spec)
    wav_path = str(out / f"{prefix}_audio.wav")
    _write_wav(wav_path, np.concatenate(list(waves)), 16_000)
    paths["audio"] = wav_path

    fig, ax = plt.subplots(figsize=(8, 3))
    ax.imshow(aud_spec[0].T, aspect="auto", origin="lower")
    ax.set_title("log-mel (segment 0, as the model sees it)")
    spec_path = str(out / f"{prefix}_spec.png")
    fig.savefig(spec_path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    paths["spec"] = spec_path
    return paths


def _write_wav(path: str, wave: np.ndarray, rate: int):
    from scipy.io import wavfile

    wavfile.write(path, rate, (np.clip(wave, -1, 1) * 32767).astype(np.int16))


def plot_per_class_accuracy(per_class: Dict, out_path: str, target2label=None):
    """Per-class accuracy bar plot (ref: train_utils.py:440-563)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    items = [(k, v) for k, v in per_class.items() if k != "median"]
    labels = [str(target2label.get(k, k)) if target2label else str(k)
              for k, _ in items]
    fig, ax = plt.subplots(figsize=(max(6, len(items) * 0.4), 4))
    ax.bar(range(len(items)), [v for _, v in items])
    ax.set_xticks(range(len(items)))
    ax.set_xticklabels(labels, rotation=90, fontsize=6)
    ax.set_ylabel("accuracy@1")
    ax.axhline(per_class.get("median", 0), color="r", ls="--",
               label=f"median {per_class.get('median', 0):.3f}")
    ax.legend()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def plot_pred_target_hist(targets: np.ndarray, preds: np.ndarray, num_cls: int,
                          out_path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 3))
    axes[0].hist(targets, bins=num_cls)
    axes[0].set_title("targets")
    axes[1].hist(preds, bins=num_cls)
    axes[1].set_title("predictions")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def plot_similarity_matrices(sims: Dict[str, np.ndarray], out_path: str):
    """v2a/a2v/v2v/a2a heatmaps (ref: training/train.py:446-467)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = list(sims.keys())
    fig, axes = plt.subplots(1, len(keys), figsize=(4 * len(keys), 3.6))
    for ax, key in zip(np.atleast_1d(axes), keys):
        im = ax.imshow(np.asarray(sims[key]), aspect="auto")
        ax.set_title(key, fontsize=9)
        fig.colorbar(im, ax=ax, fraction=0.046)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
