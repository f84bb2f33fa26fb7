"""The port's audio DSP (synchformer_tpu_torch/ops/dsp.py) against the JAX
package's (synchformer_tpu/ops/dsp.py) on the CPU, on numpy inputs from a
seed, and the reverb against a float64 per-sample transliteration of sox
reverb.c.

Tolerances, each relative to the largest |value| of the reference output:
- biquad / lowpass: against scipy's float64 lfilter 1e-6 (the port's FFT
  convolution runs in float64 with the float64 impulse response; seen
  4e-8); against JAX 2e-4, which is the JAX scan's own error against lfilter
  (seen 1.1e-4: tests/test_dsp.py holds it at atol 1e-4), not the port's;
- reverb, batched and per clip: 1e-5 against JAX (seen 1.6e-7); against the
  sox spec tests/test_dsp.py's rtol 1e-3, atol 2e-5 elementwise;
- resample, tempo_wsola, pitch_shift: 1e-6 against JAX (f32 sums in another
  order; seen 1.2e-7 to 2.4e-7), with WSOLA's offsets equal at every step;
- the random wrappers' apply given JAX's own draws: 1e-6 (volume, noise:
  exact arithmetic; the others as above), the chain 2e-4 (its lowpass).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from synchformer_tpu.ops import dsp as jdsp
from synchformer_tpu_torch.ops import dsp

torch.set_num_threads(2)
SR = 16_000


def jit(fn, *args, **static):
    """A JAX dsp function under jax.jit with its non-array arguments bound
    (op by op, its scans take seconds to dispatch)."""
    return jax.jit(functools.partial(fn, **static))(*args)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def multitone(n: int, rows: int = 1, sr: int = SR) -> np.ndarray:
    """Tones with a clear best WSOLA match at every step (no argmin tie)."""
    t = np.arange(n) / sr
    out = [0.5 * np.sin(2 * np.pi * (440 + 37 * r) * t) + 0.3 * np.sin(2 * np.pi * 1234 * t)
           + 0.2 * np.sin(2 * np.pi * (97 + 5 * r) * t) for r in range(rows)]
    return np.stack(out).astype(np.float32)


def test_biquad_and_lowpass_match_lfilter_and_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4_000)).astype(np.float32)
    b, a = dsp.biquad_coeffs_lowpass(SR, 100.0, 0.707)
    jb, ja = jdsp.biquad_coeffs_lowpass(SR, 100.0, 0.707)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(a, ja)
    golden = lfilter(b, a, x.astype(np.float64), axis=-1)
    got = dsp.biquad(torch.from_numpy(x), b, a).numpy()
    assert got.dtype == np.float32
    assert rel_err(got, golden) < 1e-6
    assert rel_err(got, np.asarray(jit(jdsp.biquad, jnp.asarray(x), b=b, a=a))) < 2e-4
    low = dsp.lowpass_biquad(torch.from_numpy(x), SR, 100.0).numpy()
    assert rel_err(low, np.asarray(jit(jdsp.lowpass_biquad, jnp.asarray(x),
                                          sample_rate=SR, cutoff_freq=100.0))) < 2e-4
    assert rel_err(low, golden) < 1e-6


def test_lti_filter_is_the_truncated_linear_convolution():
    """lti_filter against np.convolve of the impulse response, and its FFT
    length: 2^a 3^b 5^c, at least 2n - 1, the smallest such."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 777))
    key = ("biquad", (0.2, 0.3, 0.1), (1.0, -0.5, 0.2))
    h = dsp._impulse_response(key, 777)
    want = np.stack([np.convolve(r, h)[:777] for r in x])
    assert rel_err(dsp.lti_filter(torch.from_numpy(x), key), want) < 1e-6

    def smooth(c):
        for p in (2, 3, 5):
            while c % p == 0:
                c //= p
        return c == 1

    for n in (1, 2, 777, 1_600, 80_000):
        m = dsp._fft_len(n)
        assert smooth(m) and m >= 2 * n - 1
        assert not any(smooth(c) for c in range(2 * n - 1, m))


@pytest.mark.parametrize("orig,new", [(48_000, 16_000), (44_100, 16_000), (16_000, 8_000),
                                      (22_050, 16_000), (16_000, 22_050), (9, 5), (3, 1),
                                      (5, 7)])
def test_resample_matches_jax(orig, new):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3_000)).astype(np.float32)
    want = np.asarray(jdsp.resample(jnp.asarray(x), orig, new))
    got = dsp.resample(torch.from_numpy(x), orig, new).numpy()
    assert got.shape == want.shape == (2, math.ceil(new * 3_000 / orig))
    assert rel_err(got, want) < 1e-6


def jax_wsola_offsets(x: np.ndarray, y: np.ndarray, factor: float, sr: int = SR) -> list:
    """The offsets JAX can have chosen at each WSOLA step, read back from its
    output: step k writes x[base_k + o + ov : base_k + o + hop] at
    y[k hop + ov : (k + 1) hop]; the candidates o that reproduce it (one,
    except where the step reads only the zero padding past the signal)."""
    seg, ov, search = round(sr * 0.082), round(sr * 0.012), round(sr * 0.01468)
    hop = seg - ov
    n_out = round(x.shape[-1] / factor)
    k_iters = -(-(n_out - ov) // hop)
    base = (np.arange(k_iters) * hop * factor + 0.5).astype(np.int64)
    xp = np.pad(x, (0, base[-1] + search + seg))
    out = []
    for k, bk in enumerate(base):
        piece = y[k * hop + ov:(k + 1) * hop]
        errs = np.array([np.abs(piece - xp[bk + o + ov:bk + o + ov + len(piece)]).max()
                         for o in range(search)])
        out.append(set(np.flatnonzero(errs < 1e-6).tolist()))
        assert out[-1], f"step {k}: no offset reproduces JAX's output"
    return out


@pytest.mark.parametrize("factor", [0.561231, 1.25])
def test_tempo_wsola_matches_jax(factor):
    x = multitone(10_240, rows=2)
    want = np.asarray(jdsp.tempo_wsola(jnp.asarray(x), factor, SR))
    offsets = []
    got = dsp.tempo_wsola(torch.from_numpy(x), factor, SR, offsets=offsets).numpy()
    assert got.shape == want.shape == (2, round(10_240 / factor))
    port_offsets = torch.stack(offsets).T.tolist()
    for row in range(2):
        jax_offsets = jax_wsola_offsets(x[row], want[row], factor)
        unique = [o for o in jax_offsets if len(o) == 1]
        assert len(unique) >= 0.8 * len(jax_offsets)  # the signal, not its padding
        assert all(o in c for o, c in zip(port_offsets[row], jax_offsets))
    assert rel_err(got, want) < 1e-6


@pytest.mark.parametrize("cents", [1000.0, -1000.0])
def test_pitch_shift_matches_jax(cents):
    x = multitone(8_000, rows=2)
    want = np.asarray(jdsp.pitch_shift(jnp.asarray(x), SR, cents))
    got = dsp.pitch_shift(torch.from_numpy(x), SR, cents).numpy()
    assert got.shape == x.shape
    assert rel_err(got, want) < 1e-6
    assert dsp.pitch_shift(torch.from_numpy(x), SR, 0.0) is not None


def test_reverb_matches_jax_batched_and_per_clip():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 1_600)) * 0.2).astype(np.float32)
    batched = dsp.reverb(torch.from_numpy(x), SR).numpy()
    assert rel_err(batched, np.asarray(jdsp.reverb(jnp.asarray(x), SR))) < 1e-5
    for i in range(3):
        single = dsp.reverb(torch.from_numpy(x[i]), SR).numpy()
        np.testing.assert_allclose(batched[i], single, rtol=1e-5, atol=1e-7)
    # sox's options: pre-delay, wet + dry, another room
    kw = dict(pre_delay_ms=5.0, wet_only=False, reverberance=70.0, room_scale=60.0)
    got = dsp.reverb(torch.from_numpy(x), SR, **kw).numpy()
    assert rel_err(got, np.asarray(jdsp.reverb(jnp.asarray(x), SR, **kw))) < 1e-5


def sox_reverb_scalar(x, sr, reverberance=50.0, hf_damping=50.0, room_scale=100.0,
                      stereo_depth=100.0, wet_gain_db=0.0):
    """Float64 sample-loop transliteration of sox reverb.c (reverb_create /
    filter_array_create / comb_process / allpass_process), wet-only, mono
    input -> mean of the two spread channels (tests/test_dsp.py's spec)."""
    r = sr / 44100.0
    scale = room_scale / 100.0 * 0.9 + 0.1
    depth = stereo_depth / 100.0
    a = -1.0 / math.log(1.0 - 0.3)
    b = 100.0 / (math.log(1.0 - 0.98) * a + 1.0)
    feedback = 1.0 - math.exp((reverberance - b) / (a * b))
    damping = hf_damping / 100.0 * 0.3 + 0.2
    gain = 10.0 ** (wet_gain_db / 20.0) * 0.015
    comb_l = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
    ap_l = (225, 341, 441, 556)
    n = len(x)
    outs = []
    for c in range(2):
        offset = c * depth
        combs, aps = [], []
        # the stereo-spread offset is added to the 44.1 kHz base length
        # BEFORE the rate/room scaling
        for length in comb_l:
            combs.append(int(r * scale * (length + 12 * offset) + 0.5))
            offset = -offset
        for length in ap_l:
            aps.append(int(r * (length + 12 * offset) + 0.5))
            offset = -offset
        bufs = [np.zeros(d) for d in combs]
        stores = [0.0] * len(combs)
        ptrs = [0] * len(combs)
        abufs = [np.zeros(d) for d in aps]
        aptrs = [0] * len(aps)
        y = np.zeros(n)
        for i in range(n):
            out = 0.0
            for k, d in enumerate(combs):
                o = bufs[k][ptrs[k]]
                stores[k] = o + (stores[k] - o) * damping
                bufs[k][ptrs[k]] = x[i] + stores[k] * feedback
                ptrs[k] = (ptrs[k] + 1) % d
                out += o
            for k, d in enumerate(aps):
                o = abufs[k][aptrs[k]]
                abufs[k][aptrs[k]] = out + o * 0.5
                aptrs[k] = (aptrs[k] + 1) % d
                out = o - out
            y[i] = out * gain
        outs.append(y)
    return (outs[0] + outs[1]) / 2.0


def test_reverb_matches_sox_scalar_spec():
    """0.15 s of noise: about 6 round trips of the shortest comb."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(2_400) * 0.3).astype(np.float32)
    golden = sox_reverb_scalar(x.astype(np.float64), SR)
    got = dsp.reverb(torch.from_numpy(x), SR).numpy()
    np.testing.assert_allclose(got, golden, rtol=1e-3, atol=2e-5)


def jax_rows(key, p: float, b: int) -> torch.Tensor:
    return torch.from_numpy(np.array(jax.random.bernoulli(key, p, (b,))))


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_random_wrappers_apply_jax_draws(p):
    """Each wrapper's apply, given the draws the JAX wrapper makes from its
    key, equals the JAX wrapper; at p=0 each is the identity."""
    rng = np.random.default_rng(5)
    x_np = (rng.standard_normal((4, 2_000)) * 0.3).astype(np.float32)
    x, xj = torch.from_numpy(x_np), jnp.asarray(x_np)
    key = jax.random.PRNGKey(11)
    rows = jax_rows(key, p, 4)
    if p < 1.0:
        assert 0 < int(rows.sum()) < 4
    checks = {
        "volume": (dsp.apply_volume(x, rows, 2.0),
                   jit(jdsp.random_volume, xj, key, p=p, gain=2.0), 1e-6),
        "lowpass": (dsp.apply_lowpass(x, rows, SR, 100.0),
                    jit(jdsp.random_lowpass, xj, key, p=p, sample_rate=SR,
                        cutoff_freq=100.0), 2e-4),
        "pitch": (dsp.apply_pitch_shift(x, rows, SR, 1000.0),
                  jit(jdsp.random_pitch_shift, xj, key, p=p, sample_rate=SR, shift=1000.0),
                  1e-6),
        "reverb": (dsp.apply_reverb(x, rows, SR),
                   jit(jdsp.random_reverb, xj, key, p=p, sample_rate=SR), 1e-5),
    }
    k1, k2 = jax.random.split(key)
    noise = torch.from_numpy(np.array(jax.random.normal(k2, x_np.shape, jnp.float32)))
    checks["noise"] = (dsp.apply_gauss_noise(x, jax_rows(k1, p, 4), noise, 0.01),
                       jit(jdsp.random_gauss_noise, xj, key, p=p, amplitude=0.01), 1e-6)
    for name, (got, want, tol) in checks.items():
        assert rel_err(got.numpy(), np.asarray(want)) < tol, name
    none = torch.zeros(4, dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    assert not bool(dsp.draw_rows(4, 0.0, gen).any())
    for got in (dsp.apply_volume(x, none), dsp.apply_lowpass(x, none, SR),
                dsp.apply_pitch_shift(x, none, SR), dsp.apply_reverb(x, none, SR),
                dsp.apply_gauss_noise(x, none, None)):
        assert got is x


def test_chain_applies_jax_draws():
    """apply_audio_aug_chain given random_audio_aug_chain's draws (its five
    key splits, the noise's split inside) equals the JAX chain, on
    (B, S, n) segments with one draw per clip."""
    rng = np.random.default_rng(6)
    x_np = (rng.standard_normal((3, 2, 1_600)) * 0.2).astype(np.float32)
    key = jax.random.PRNGKey(4)  # every transform draws some rows, not all
    p = 0.6
    want = np.asarray(jit(jdsp.random_audio_aug_chain, jnp.asarray(x_np), key, p=p,
                          sample_rate=SR))
    ks = jax.random.split(key, 5)
    ka, kb = jax.random.split(ks[4])
    draws = {name: jax_rows(k, p, 3) for name, k in zip(dsp.AUG_CHAIN[:4], ks[:4])}
    draws["noise"] = jax_rows(ka, p, 3)
    draws["noise_values"] = torch.from_numpy(np.array(jax.random.normal(kb, x_np.shape)))
    assert all(0 < int(draws[k].sum()) < 3 for k in dsp.AUG_CHAIN), draws
    got = dsp.apply_audio_aug_chain(torch.from_numpy(x_np), draws, SR).numpy()
    assert rel_err(got, want) < 2e-4


def test_chain_draws_from_the_generators():
    """The row masks come from the CPU generator in chain order, the noise
    from the other generator only where some row drew it; the same states
    give the same draws."""
    x = torch.zeros(5, 100)
    rows_gen, noise_gen = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    a = dsp.draw_audio_aug_chain(x, 0.5, rows_gen, noise_gen)
    rows_gen.manual_seed(1)
    want = torch.rand(5, generator=rows_gen)
    assert torch.equal(a["reverb"], want < 0.5)
    rows_gen.manual_seed(1)
    noise_gen.manual_seed(2)
    b = dsp.draw_audio_aug_chain(x, 0.5, rows_gen, noise_gen)
    for k in dsp.AUG_CHAIN:
        assert torch.equal(a[k], b[k])
    assert torch.equal(a["noise_values"], b["noise_values"])
    c = dsp.draw_audio_aug_chain(x, 0.0, rows_gen, noise_gen)
    assert c["noise_values"] is None and not any(bool(c[k].any()) for k in dsp.AUG_CHAIN)


def test_aug_then_segment_overlap_consistency():
    """At p=1 the 50%-overlap region of segment k equals the head of segment
    k+1 bit for bit (augmentations before segmentation); at p=0 it is the
    plain gather; augment_batch_pcm takes the same route from a batch."""
    rng = np.random.default_rng(8)
    seg_len, hop, n_seg = 512, 256, 6
    n = hop * (n_seg - 1) + seg_len + 64
    pcm = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32) * 0.1)
    starts = torch.from_numpy(np.tile(np.arange(n_seg, dtype=np.int32) * hop, (2, 1)))

    def gens():
        return torch.Generator().manual_seed(3), torch.Generator().manual_seed(4)

    out = dsp.aug_then_segment(pcm, starts, seg_len, 1.0, SR, *gens())
    assert out.shape == (2, n_seg, seg_len)
    for k in range(n_seg - 1):
        assert torch.equal(out[:, k, hop:], out[:, k + 1, :hop])
    host = np.stack([pcm.numpy()[b, starts.numpy()[b, :, None] + np.arange(seg_len)]
                     for b in range(2)])
    np.testing.assert_array_equal(dsp.aug_then_segment(pcm, starts, seg_len, 0.0, SR,
                                                       *gens()).numpy(), host)
    np.testing.assert_array_equal(dsp.segment_pcm(pcm, starts, seg_len).numpy(), host)
    drawn = {}
    batch = {"audio_full": pcm.numpy(), "audio_seg_starts": starts.numpy()}
    got = dsp.augment_batch_pcm(batch, torch.from_numpy(host), 1.0, SR, *gens(), drawn)
    assert torch.equal(got, out)
    assert drawn == {name: 1 for name in dsp.AUG_CHAIN}
