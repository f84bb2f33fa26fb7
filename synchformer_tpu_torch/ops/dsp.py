"""Audio DSP on the device: the training-time audio augmentations and the
resampler (synchformer_tpu/ops/dsp.py).

- volume / gaussian noise: elementwise.
- lowpass biquad and the sox ``reverb`` (freeverb: 8 lowpass-feedback combs
  and 4 series allpasses per stereo channel, sox reverb.c's tunings) are
  linear time-invariant filters. Over a signal of n samples each equals a
  causal convolution with the first n taps of its impulse response, so both
  run as one FFT convolution (``lti_filter``). The impulse responses are
  computed once per (parameters, sample rate, n) on the host in float64 and
  their spectra cached per device. The JAX package restructures the same
  recurrences into scans for the TPU; here a scan would cost tens of
  thousands of launches a call.
- resample: the Kaiser-windowed-sinc polyphase bank of
  torchaudio.functional.resample as one matmul of the framed signal.
- pitch shift: sox ``pitch`` = WSOLA tempo stretch (a Python loop over the
  static segment positions; each step one batched correlation, argmin and
  gather) followed by a static windowed-sinc rate conversion (one gather and
  a weighted sum).

Each random wrapper is split into a draw and an apply. The row masks (one
Bernoulli draw per clip, the reference's RandomApply) come from a CPU
generator, so the batch-level gate (skip a transform that no row drew) reads
them without waiting for the device; the Gaussian noise comes from the
device generator. ``apply_*`` is deterministic given the draws.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the five AudioRandom* transforms in the reference's config order
# (configs/sync.yaml:151-169 == configs/segment_avclip.yaml)
AUG_CHAIN = ("reverb", "volume", "pitch", "lowpass", "noise")


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (B,) row mask on x's device, broadcastable against x."""
    return mask.to(x.device, non_blocking=True).reshape((-1,) + (1,) * (x.ndim - 1))


# ---------------------------------------------------------------------------
# LTI filters as one FFT convolution
# ---------------------------------------------------------------------------

def _fft_len(n: int) -> int:
    """The smallest 2^a 3^b 5^c >= 2n - 1: a linear (not circular)
    convolution of two length-n signals, on a size cuFFT / pocketfft like."""
    need = 2 * n - 1
    best = 1 << (need - 1).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            m = p35
            while m < need:
                m *= 2
            best = min(best, m)
            p35 *= 3
        p5 *= 5
    return best


@functools.lru_cache(maxsize=32)
def _spectrum(h_key: tuple, n: int, nfft: int, device: str) -> torch.Tensor:
    """f64 rfft of the first n taps of the impulse response named by
    ``h_key`` (see _impulse_response), on ``device``."""
    h = torch.from_numpy(_impulse_response(h_key, n)).to(device)
    return torch.fft.rfft(h, n=nfft)


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """float64 for a float64 input (the references run so), else float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def lti_filter(x: torch.Tensor, h_key: tuple) -> torch.Tensor:
    """Causal convolution of x (..., n) with the first n taps of the impulse
    response ``h_key`` names, truncated to n: exactly the filter's output
    from a zero state. Computed in f64, so that only the f32 output rounds
    (an f32 FFT read 2.9e-7 of the largest value at 80,000 samples; the f64
    one costs about 0.25 ms there on an H100), returned in f32 (f64 for an
    f64 input)."""
    n = x.shape[-1]
    nfft = _fft_len(n)
    spec = _spectrum(h_key, n, nfft, str(x.device))
    y = torch.fft.irfft(torch.fft.rfft(x.double(), n=nfft) * spec, n=nfft)
    return y[..., :n].to(_work_dtype(x))


def _impulse_response(h_key: tuple, n: int) -> np.ndarray:
    """The first n taps (float64) of a filter: ('biquad', b, a) or
    ('reverb', sample_rate, reverberance, hf_damping, room_scale,
    stereo_depth, wet_gain_db)."""
    kind, *params = h_key
    if kind == "biquad":
        from scipy.signal import lfilter

        b, a = params
        impulse = np.zeros(n)
        impulse[0] = 1.0
        return lfilter(np.asarray(b), np.asarray(a), impulse)
    if kind == "reverb":
        return _reverb_impulse_response(n, *params)
    raise ValueError(f"unknown filter {kind!r}")


# ---------------------------------------------------------------------------
# trivial augs
# ---------------------------------------------------------------------------

def volume_factor(gain: float = 2.0, gain_type: str = "amplitude") -> float:
    """torchaudio.transforms.Vol's amplitude factor."""
    if gain_type == "amplitude":
        return gain
    if gain_type == "db":
        return 10.0 ** (gain / 20.0)
    if gain_type == "power":
        return math.sqrt(gain)
    raise ValueError(gain_type)


def draw_rows(b: int, p: float, generator: torch.Generator) -> torch.Tensor:
    """RandomApply(p) per row: (b,) bool on the generator's (CPU) device."""
    return torch.rand(b, generator=generator, device=generator.device) < p


def apply_volume(x: torch.Tensor, rows: torch.Tensor, gain: float = 2.0,
                 gain_type: str = "amplitude") -> torch.Tensor:
    """Vol(gain) clipped to [-1, 1] on the rows drawn (ref: transforms.py:672-694)."""
    if not bool(rows.any()):
        return x
    scaled = torch.clamp(x * volume_factor(gain, gain_type), -1.0, 1.0)
    return torch.where(_rows(rows, x), scaled, x)


def apply_gauss_noise(x: torch.Tensor, rows: torch.Tensor, noise: Optional[torch.Tensor],
                      amplitude: float = 0.01) -> torch.Tensor:
    """x + amplitude * noise on the rows drawn (ref: transforms.py:787-812);
    ``noise`` is a standard normal draw of x's shape (None where no row
    drew the transform)."""
    if not bool(rows.any()):
        return x
    return torch.where(_rows(rows, x), x + noise.to(x.dtype) * amplitude, x)


# ---------------------------------------------------------------------------
# lowpass biquad
# ---------------------------------------------------------------------------

def biquad_coeffs_lowpass(sample_rate: float, cutoff_freq: float,
                          q: float = 0.707) -> Tuple[np.ndarray, np.ndarray]:
    """RBJ cookbook lowpass biquad (torchaudio lowpass_biquad coefficients)."""
    w0 = 2.0 * math.pi * cutoff_freq / sample_rate
    alpha = math.sin(w0) / (2.0 * q)
    cos_w0 = math.cos(w0)
    b = np.array([(1 - cos_w0) / 2, 1 - cos_w0, (1 - cos_w0) / 2])
    a = np.array([1 + alpha, -2 * cos_w0, 1 - alpha])
    return (b / a[0]).astype(np.float64), (a / a[0]).astype(np.float64)


def biquad(x: torch.Tensor, b: Sequence[float], a: Sequence[float]) -> torch.Tensor:
    """A normalised biquad along the last axis from a zero state, as one FFT
    convolution with its impulse response; in x's dtype."""
    key = ("biquad", tuple(float(v) for v in b), tuple(float(v) for v in a))
    return lti_filter(x, key).to(x.dtype)


def lowpass_biquad(x: torch.Tensor, sample_rate: float, cutoff_freq: float,
                   q: float = 0.707) -> torch.Tensor:
    b, a = biquad_coeffs_lowpass(sample_rate, cutoff_freq, q)
    return biquad(x, b, a)


def apply_lowpass(x: torch.Tensor, rows: torch.Tensor, sample_rate: float,
                  cutoff_freq: float = 100.0, q: float = 0.707) -> torch.Tensor:
    if not bool(rows.any()):
        return x
    return torch.where(_rows(rows, x), lowpass_biquad(x, sample_rate, cutoff_freq, q), x)


# ---------------------------------------------------------------------------
# sinc resampling as a matmul
# ---------------------------------------------------------------------------

def _resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                     rolloff: float = 0.99, beta: float = 14.769656459379492):
    """Kaiser-windowed sinc kernel, torchaudio.functional.resample semantics.
    Returns (kernels (new/gcd, width), width, gcd-reduced freqs)."""
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = orig_freq // g, new_freq // g
    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig  # (1, K)
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx  # (new, K)
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.i0(beta * np.sqrt(1 - (t / lowpass_filter_width) ** 2)) / np.i0(beta)
    t = t * math.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * base_freq / orig
    return kernel.astype(np.float32), width, orig, new


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """Polyphase sinc resample along the last axis: pad, frame into hop=orig
    windows, one f32 matmul with the (new, K) kernel bank, interleave the
    phases."""
    if orig_freq == new_freq:
        return x
    kernel, width, orig, new = _resample_kernel(orig_freq, new_freq,
                                                lowpass_filter_width, rolloff)
    length = x.shape[-1]
    target_len = int(math.ceil(new_freq * length / orig_freq))
    k = kernel.shape[1]
    num_frames = length // orig + 1
    pad_right = num_frames * orig + k - length
    xp = F.pad(x.float(), (width, max(pad_right, 0)))
    frames = xp.unfold(-1, k, orig)[..., :num_frames, :]  # (..., n_frames, K)
    # full-f32 products, as Precision.HIGHEST in the JAX package
    torch.backends.cuda.matmul.allow_tf32 = False
    phases = torch.matmul(frames, torch.from_numpy(kernel).to(x.device).t())
    out = phases.reshape(*x.shape[:-1], num_frames * new)
    return out[..., :target_len].to(x.dtype)


# ---------------------------------------------------------------------------
# sox tempo (WSOLA) + pitch
# ---------------------------------------------------------------------------

def tempo_wsola(x: torch.Tensor, factor: float, sample_rate: int,
                segment_ms: float = 82.0, search_ms: float = 14.68,
                overlap_ms: float = 12.0, offsets: Optional[list] = None) -> torch.Tensor:
    """sox 'tempo' (WSOLA): change speed, keep pitch. factor > 1 speeds up
    (shorter output); output length is round(n / factor).

    Per output segment: search the ``search`` window at the nominal input
    position for the offset whose overlap region best matches the previous
    output tail (least squares, every offset in [0, search)), then linearly
    cross-fade over ``overlap`` samples. The positions are static, so this is
    a loop of (search, overlap) correlations, each one batched over the
    rows; ``offsets``, where given, collects each step's chosen offsets.
    In f32 (f64 for an f64 input)."""
    x32 = x.to(_work_dtype(x))
    n = x.shape[-1]
    seg = max(int(sample_rate * segment_ms / 1000 + 0.5), 2)
    ov = max(min(int(sample_rate * overlap_ms / 1000 + 0.5), seg - 1), 1)
    search = max(int(sample_rate * search_ms / 1000 + 0.5), 1)
    hop = seg - ov
    if hop <= ov:
        raise ValueError(f"overlap ({ov}) must be < segment - overlap ({hop}): chunk "
                         "assembly emits exactly `hop` samples per iteration")
    n_out = int(round(n / factor))
    if n_out <= ov:
        return x32[..., :n_out]
    k_iters = -(-(n_out - ov) // hop)
    base = (np.arange(k_iters, dtype=np.float64) * hop * factor + 0.5).astype(np.int64)
    need = int(base[-1]) + search + seg
    xp = F.pad(x32, (0, max(0, need - n)))
    w = torch.arange(ov, dtype=x32.dtype, device=x.device) / ov       # fade-in ramp
    seg_ar = torch.arange(seg, device=x.device)
    tail = xp[..., :ov]   # primed with the true start: step 0 matches at offset 0
    chunks = []
    for bk in base.tolist():
        region = xp[..., bk:bk + search + seg]
        fr = region.unfold(-1, ov, 1)[..., :search, :]          # (..., search, ov)
        # ||tail - fr||^2 = ||tail||^2 - 2 corr + ||fr||^2; the first term
        # does not depend on the offset
        corr = torch.einsum("...so,...o->...s", fr, tail)
        energy = torch.sum(fr * fr, dim=-1)
        o = torch.argmin(energy - 2.0 * corr, dim=-1)          # (...,)
        if offsets is not None:
            offsets.append(o)
        seg_k = torch.take_along_dim(region, o[..., None] + seg_ar, dim=-1)
        head = tail * (1.0 - w) + seg_k[..., :ov] * w
        chunks.append(torch.cat([head, seg_k[..., ov:hop]], dim=-1))
        tail = seg_k[..., hop:]
    out = torch.cat(chunks + [tail], dim=-1)
    return out[..., :n_out]


@functools.lru_cache(maxsize=8)
def _pitch_table(n: int, ns: int, d: float, device: str):
    """The static windowed-sinc interpolation of the rate step: positions
    m * d of a length-ns signal for m < n -> (gather idx (n, K), weights
    (n, K) f64, cast to the signal's dtype where used), on ``device``."""
    width, rolloff, beta = 6, 0.99, 14.769656459379492
    fc = min(1.0, 1.0 / d) * rolloff
    half = int(math.ceil(width / fc))
    pos = np.arange(n, dtype=np.float64) * d                # (n,)
    lo = np.floor(pos).astype(np.int64) - half
    taps = np.arange(2 * half + 2)                          # (K,)
    idx = lo[:, None] + taps[None, :]                       # (n, K)
    t = (idx - pos[:, None]) * fc                           # in cutoff periods
    tcl = np.clip(t / width, -1.0, 1.0)
    window = np.i0(beta * np.sqrt(1.0 - tcl ** 2)) / np.i0(beta)
    kern = np.sinc(t) * window * fc
    kern[np.abs(t) > width] = 0.0
    kern[(idx < 0) | (idx >= ns)] = 0.0                     # zero-padded edges
    idx = np.clip(idx, 0, ns - 1)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(kern).to(device))


def pitch_shift(x: torch.Tensor, sample_rate: int, shift_cents: float) -> torch.Tensor:
    """sox 'pitch <cents>' + 'rate <sr>' (ref: transforms.py:734-739): tempo
    (WSOLA) by 1 / 2^(cents/1200), then a windowed-sinc rate conversion back
    to the original duration, evaluated at the static positions
    m * 2^(cents/1200): one gather and one weighted sum."""
    d = 2.0 ** (shift_cents / 1200.0)
    if d == 1.0:
        return x
    stretched = tempo_wsola(x, 1.0 / d, sample_rate)
    idx, kern = _pitch_table(x.shape[-1], stretched.shape[-1], d, str(x.device))
    out = torch.sum(stretched[..., idx] * kern.to(stretched.dtype), dim=-1)
    return out.to(x.dtype)


def apply_pitch_shift(x: torch.Tensor, rows: torch.Tensor, sample_rate: int,
                      shift: float = 1000.0) -> torch.Tensor:
    """The pitch shift on the rows drawn; skipped whole where none drew it
    (ref per-clip gating: dataset/transforms.py:727-785)."""
    if not bool(rows.any()):
        return x
    return torch.where(_rows(rows, x), pitch_shift(x, sample_rate, shift), x)


# ---------------------------------------------------------------------------
# sox reverb (freeverb)
# ---------------------------------------------------------------------------

# sox reverb.c tunings: filter delay lengths in samples at 44100 Hz.
_SOX_COMB_LENGTHS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
_SOX_ALLPASS_LENGTHS = (225, 341, 441, 556)
_SOX_STEREO_ADJUST = 12


def sox_reverb_geometry(sample_rate: float, reverberance: float = 50.0,
                        hf_damping: float = 50.0, room_scale: float = 100.0,
                        stereo_depth: float = 100.0, wet_gain_db: float = 0.0):
    """Per-channel comb/allpass delay lengths + scalar filter constants,
    exactly as sox reverb.c derives them (reverb_create /
    filter_array_create). A mono input with stereo_depth > 0 yields two
    channels whose delays are spread by ±12 samples with alternating sign."""
    r = sample_rate / 44100.0
    scale = room_scale / 100.0 * 0.9 + 0.1
    depth = stereo_depth / 100.0
    a = -1.0 / math.log(1.0 - 0.3)                 # minimum feedback
    b = 100.0 / (math.log(1.0 - 0.98) * a + 1.0)   # maximum feedback
    feedback = 1.0 - math.exp((reverberance - b) / (a * b))
    damping = hf_damping / 100.0 * 0.3 + 0.2
    gain = 10.0 ** (wet_gain_db / 20.0) * 0.015
    channels = []
    for c in range(2 if depth > 0 else 1):
        offset = c * depth
        combs, allpasses = [], []
        # sox filter_array_create applies the stereo-spread offset to the
        # 44.1 kHz BASE length, before the rate/room scaling:
        #   comb:    len = r * scale * (length + stereo_adjust * offset) + .5
        #   allpass: len = r *         (length + stereo_adjust * offset) + .5
        for length in _SOX_COMB_LENGTHS:
            combs.append(int(r * scale * (length + _SOX_STEREO_ADJUST * offset) + 0.5))
            offset = -offset
        for length in _SOX_ALLPASS_LENGTHS:
            allpasses.append(int(r * (length + _SOX_STEREO_ADJUST * offset) + 0.5))
            offset = -offset
        channels.append((combs, allpasses))
    return channels, feedback, damping, gain


def _comb_impulse(n: int, d: int, feedback: float, damping: float) -> np.ndarray:
    """First n taps of one freeverb comb (sox comb_process):
        out[n] = buf[n-d]; store[n] = (1-δ) out[n] + δ store[n-1];
        buf[n] = in[n] + f store[n],
    i.e. z^-d (1 - δ z^-1) / (1 - δ z^-1 - f (1-δ) z^-d), for a unit
    impulse. The recurrence's d-delayed term only reads the previous block
    of d samples, so each block is one first-order lfilter (the δ term)."""
    from scipy.signal import lfilter

    g = feedback * (1.0 - damping)
    nb = -(-n // d)
    buf = np.zeros(nb * d)
    drive = np.zeros(nb * d)          # x[n] - δ x[n-1] for x a unit impulse
    drive[0] = 1.0
    if nb * d > 1:
        drive[1] = -damping
    state = np.zeros(1)
    prev = np.zeros(d)
    for j in range(nb):
        blk, state = lfilter([1.0], [1.0, -damping], drive[j * d:(j + 1) * d] + g * prev,
                             zi=state)
        buf[j * d:(j + 1) * d] = blk
        prev = blk
    out = np.zeros(n)
    out[d:] = buf[:n - d]             # out[n] = buf[n - d]
    return out


def _allpass(y: np.ndarray, d: int) -> np.ndarray:
    """One freeverb allpass (sox allpass_process) over y:
        out[n] = buf[n-d] - in[n]; buf[n] = in[n] + 0.5 buf[n-d],
    i.e. z^-d / (1 - 0.5 z^-d) - 1: blocks of d samples, one first-order
    recurrence across blocks (lfilter along the block axis)."""
    from scipy.signal import lfilter

    n = y.shape[-1]
    nb = -(-n // d)
    blocks = np.zeros(nb * d)
    blocks[:n] = y
    buf = lfilter([1.0], [1.0, -0.5], blocks.reshape(nb, d), axis=0).reshape(-1)[:n]
    out = -y.copy()
    out[d:] += buf[:n - d]
    return out


@functools.lru_cache(maxsize=8)
def _reverb_impulse_response(n: int, sample_rate: float, reverberance: float,
                             hf_damping: float, room_scale: float, stereo_depth: float,
                             wet_gain_db: float) -> np.ndarray:
    """The wet response of sox reverb to a unit impulse, first n taps in
    float64: per channel the sum of its combs through its allpass chain, the
    channels averaged and scaled by the wet gain (JAX reverb :454)."""
    channels, feedback, damping, gain = sox_reverb_geometry(
        sample_rate, reverberance, hf_damping, room_scale, stereo_depth, wet_gain_db)
    wet = np.zeros(n)
    for combs, allpasses in channels:
        y = sum(_comb_impulse(n, d, feedback, damping) for d in combs)
        for d in allpasses:
            y = _allpass(y, d)
        wet += y
    return wet * (gain / len(channels))


def reverb(x: torch.Tensor, sample_rate: int, reverberance: float = 50.0,
           hf_damping: float = 50.0, room_scale: float = 100.0,
           stereo_depth: float = 100.0, pre_delay_ms: float = 0.0,
           wet_gain_db: float = 0.0, wet_only: bool = True) -> torch.Tensor:
    """sox 'reverb' on a mono signal (freeverb; sox reverb.c semantics and
    defaults). With stereo_depth > 0, the mono input drives sox's two
    spread-delay filter arrays and the two wet channels are averaged, which
    is what the reference computes via `apply_effects_tensor(..., [['reverb',
    '-w']])` then `wave.mean(dim=0)` (ref: transforms.py:758-785). Both
    channels' responses are one impulse response, so the whole effect is one
    FFT convolution. wet_only=True is sox's `-w`. Returns f32 (f64 for an
    f64 input)."""
    x32 = x.to(_work_dtype(x))
    n = x.shape[-1]
    if pre_delay_ms > 0:
        dpre = int(sample_rate * pre_delay_ms / 1000.0 + 0.5)
        x32 = F.pad(x32, (dpre, 0))[..., :n]
    key = ("reverb", float(sample_rate), float(reverberance), float(hf_damping),
           float(room_scale), float(stereo_depth), float(wet_gain_db))
    wet = lti_filter(x32, key)
    return wet if wet_only else x32 + wet


def apply_reverb(x: torch.Tensor, rows: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """AudioRandomReverb (ref: transforms.py:758-785) on the rows drawn: sox
    `reverb -w` defaults, stereo wet pair averaged back to mono; skipped
    whole where no row drew it."""
    if not bool(rows.any()):
        return x
    return torch.where(_rows(rows, x), reverb(x, sample_rate).to(x.dtype), x)


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def draw_audio_aug_chain(x: torch.Tensor, p: float, rows_generator: torch.Generator,
                         noise_generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The chain's draws for pcm ``x`` (B, ...): each transform's (B,) row
    mask from ``rows_generator`` (a CPU generator), in chain order, then,
    where a row drew the noise, a standard normal of x's shape from
    ``noise_generator`` (on x's device) under "noise_values"."""
    draws = {name: draw_rows(x.shape[0], p, rows_generator) for name in AUG_CHAIN}
    draws["noise_values"] = (torch.randn(x.shape, generator=noise_generator, device=x.device)
                             if bool(draws["noise"].any()) else None)
    return draws


def apply_audio_aug_chain(pcm: torch.Tensor, draws: Dict[str, torch.Tensor],
                          sample_rate: int) -> torch.Tensor:
    """The reference's five AudioRandom* transforms in their config order
    (ref: configs/sync.yaml:151-169, all at p=${data.p_audio_aug}): reverb,
    volume (gain 2.0), pitch shift (1000 cents), lowpass (100 Hz), gaussian
    noise (0.01), each on the rows ``draws`` selects."""
    pcm = apply_reverb(pcm, draws["reverb"], sample_rate)
    pcm = apply_volume(pcm, draws["volume"], gain=2.0)
    pcm = apply_pitch_shift(pcm, draws["pitch"], sample_rate, shift=1000.0)
    pcm = apply_lowpass(pcm, draws["lowpass"], sample_rate, cutoff_freq=100.0)
    return apply_gauss_noise(pcm, draws["noise"], draws["noise_values"], amplitude=0.01)


def random_audio_aug_chain(pcm: torch.Tensor, p: float, sample_rate: int,
                           rows_generator: torch.Generator,
                           noise_generator: torch.Generator) -> torch.Tensor:
    """Draw, then apply, the augmentation chain on pcm (B, ..., n)."""
    draws = draw_audio_aug_chain(pcm, p, rows_generator, noise_generator)
    return apply_audio_aug_chain(pcm, draws, sample_rate)


def segment_pcm(pcm_full: torch.Tensor, seg_starts: torch.Tensor, seg_len: int) -> torch.Tensor:
    """Sliding-window segments from a contiguous per-clip waveform on the
    device: (..., n) + (..., S) integer starts -> (..., S, seg_len)."""
    idx = seg_starts.long()[..., None] + torch.arange(seg_len, device=pcm_full.device)
    src = pcm_full[..., None, :].expand(*idx.shape[:-1], pcm_full.shape[-1])
    return torch.gather(src, -1, idx)


def aug_then_segment(pcm_full: torch.Tensor, seg_starts: torch.Tensor, seg_len: int,
                     p: float, sample_rate: int, rows_generator: torch.Generator,
                     noise_generator: torch.Generator) -> torch.Tensor:
    """Reference aug placement: the five AudioRandom* effects run on the
    contiguous temporally-cropped waveform BEFORE GenerateMultipleSegments
    (ref: configs/sync.yaml:151-171), so overlapping segments share
    identical augmented samples; then the segments are gathered."""
    aug = random_audio_aug_chain(pcm_full, p, sample_rate, rows_generator, noise_generator)
    return segment_pcm(aug, seg_starts, seg_len)


def augment_batch_pcm(batch, pcm: torch.Tensor, p: float, sample_rate: int,
                      rows_generator: torch.Generator, noise_generator: torch.Generator,
                      drawn: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The trainers' training-time audio hook (synchformer_tpu/train/
    stage_clip.py:156-176, stage_sync.py:61-80): where the loader ships the
    contiguous crop (``batch["audio_full"]``, ``batch["audio_seg_starts"]``),
    the chain runs on it and the segments of ``pcm``'s length are gathered
    afterwards (aug_then_segment); otherwise the chain runs on the segments
    ``pcm`` (B, S, n) with one draw per clip. ``drawn``, where given, counts
    for each transform the calls in which some clip drew it."""
    full = "audio_full" in batch
    src = (torch.as_tensor(batch["audio_full"]).to(pcm.device, non_blocking=True)
           if full else pcm)
    draws = draw_audio_aug_chain(src, p, rows_generator, noise_generator)
    if drawn is not None:
        for name in AUG_CHAIN:
            drawn[name] = drawn.get(name, 0) + int(bool(draws[name].any()))
    aug = apply_audio_aug_chain(src, draws, sample_rate)
    if not full:
        return aug
    starts = torch.as_tensor(batch["audio_seg_starts"]).to(pcm.device, non_blocking=True)
    return segment_pcm(aug, starts, pcm.shape[-1])
