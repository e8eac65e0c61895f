"""Parity of the port's ops with no recurrence of their own (masking,
deltas and emphasis, spectral descriptors, effects, convolution, metrics,
chroma, CQT, pitch detection, DSP synthesis, beamforming) with the JAX
package, on the CPU.

Each case feeds the same numpy input (from the per-test ``rng``) to the JAX
function and to its port and compares.  Tolerances, relative to the
reference's peak: ``F32`` (1e-5) for plain float32 ops, ``SCAN`` (1e-4) for
scans, reductions of many terms and ``torch.linalg`` solves and
eigendecompositions.  The random ops (masks, dither) draw from a
``torch.Generator`` where the JAX ops take a key, so their draws differ:
they are held to their semantics and to the JAX op where the draw is fixed.
"""
import math

import numpy as np
import pytest
import scipy.signal
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu import ops as jops
from torchaudio_contrib_tpu_torch import ops as tops

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

F32 = 1e-5
SCAN = 1e-4


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _pair(rng, *shape, scale=1.0, positive=False, dtype=np.float32):
    x = rng.standard_normal(shape) * scale
    if positive:
        x = np.abs(x)
    x = x.astype(dtype)
    return torch.from_numpy(x.copy()), jnp.asarray(x)


def _cpair(rng, *shape):
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return torch.from_numpy(x.copy()), jnp.asarray(x)


# ---- features ----------------------------------------------------------------

@pytest.mark.parametrize("win,mode", [(5, "replicate"), (3, "zeros"),
                                      (7, "reflect")])
def test_compute_deltas(rng, win, mode):
    t, j = _pair(rng, 2, 13, 40)
    assert _rel(tops.compute_deltas(t, win, mode),
                jops.compute_deltas(j, win, mode)) <= F32
    with pytest.raises(ValueError, match="odd"):
        tops.compute_deltas(t, 4)


def test_preemphasis(rng):
    t, j = _pair(rng, 3, 1000)
    assert _rel(tops.preemphasis(t, 0.95), jops.preemphasis(j, 0.95)) <= F32


def test_deemphasis_matches_jax_and_a_float64_recurrence(rng):
    """The log-depth scan against the JAX package's associative scan at a
    short length, and against ``scipy.signal.lfilter`` in float64 on a 10 s
    clip at 16 kHz (the scan's f32 error does not grow with the length:
    each output sums ~1/(1 − coeff) terms)."""
    t, j = _pair(rng, 2, 601)
    assert _rel(tops.deemphasis(t), jax.jit(jops.deemphasis)(j)) <= SCAN
    x = rng.standard_normal((2, 160000)).astype(np.float32)
    want = scipy.signal.lfilter([1.0], [1.0, -0.97], x.astype(np.float64))
    got = tops.deemphasis(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= SCAN
    back = tops.preemphasis(got)
    assert _rel(back, x) <= SCAN


# ---- augment -------------------------------------------------------------

def _bands(spec, out, axis, value):
    """The masked positions along ``axis`` (must be whole bands)."""
    diff = (out != spec) | (out == value)
    other = tuple(d for d in range(spec.ndim) if d != axis % spec.ndim)
    hit = diff.all(dim=other)
    assert torch.equal(diff.any(dim=other), hit)     # whole slices only
    return hit


@pytest.mark.parametrize("axis,param,masks", [(-1, 10, 1), (-2, 5, 3)])
def test_masks(rng, axis, param, masks):
    """Bands of width at most ``param`` filled with the value, nothing else
    changed; the same generator state gives the same masks; the JAX op
    with no width is the identity, as the port's."""
    spec, jspec = _pair(rng, 2, 24, 50)
    g = torch.Generator().manual_seed(3)
    fn = tops.time_mask if axis == -1 else tops.freq_mask
    out = fn(g, spec, param, num_masks=masks, mask_value=-7.0)
    hit = _bands(spec, out, axis, -7.0)
    assert 0 < int(hit.sum()) <= masks * param
    assert torch.equal(out[..., ~hit] if axis == -1 else out[:, ~hit],
                       spec[..., ~hit] if axis == -1 else spec[:, ~hit])
    again = fn(torch.Generator().manual_seed(3), spec, param,
               num_masks=masks, mask_value=-7.0)
    assert torch.equal(out, again)
    assert torch.equal(tops.mask_along_axis(g, spec, 0, axis), spec)
    ident = jops.mask_along_axis(jax.random.PRNGKey(0), jspec, 0, axis)
    assert _rel(spec, ident) == 0.0


def test_mask_along_axis_iid(rng):
    spec, _ = _pair(rng, 6, 16, 40)
    out = tops.mask_along_axis_iid(torch.Generator().manual_seed(0), spec,
                                   20, 2)
    bands = [_bands(spec[i], out[i], 1, 0.0) for i in range(6)]
    assert len({tuple(b.tolist()) for b in bands}) > 1   # independent
    with pytest.raises(ValueError, match="batch axis"):
        tops.mask_along_axis_iid(None, spec, 5, 0)


# ---- spectral ------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("spectral_centroid", {"sample_rate": 16000}),
    ("spectral_bandwidth", {"sample_rate": 16000, "p": 1.5}),
    ("spectral_rolloff", {"sample_rate": 16000, "roll_percent": 0.7}),
    ("spectral_flatness", {}),
])
def test_spectral_descriptors(rng, name, kw):
    t, j = _pair(rng, 2, 129, 30, positive=True)
    t[0, :, 3] = 0.0                                 # a silent frame
    j = jnp.asarray(t.numpy())
    assert _rel(getattr(tops, name)(t, **kw),
                getattr(jops, name)(j, **kw)) <= F32


@pytest.mark.parametrize("center", [True, False])
def test_zero_crossing_rate(rng, center):
    t, j = _pair(rng, 2, 5000)
    assert _rel(tops.zero_crossing_rate(t, 512, 128, center),
                jops.zero_crossing_rate(j, 512, 128, center)) == 0.0


# ---- effects -------------------------------------------------------------

@pytest.mark.parametrize("shape", ["linear", "exponential", "logarithmic",
                                   "quarter_sine", "half_sine", "parabola"])
def test_fade(rng, shape):
    t, j = _pair(rng, 2, 800)
    assert _rel(tops.fade(t, 100, 250, shape),
                jops.fade(j, 100, 250, shape)) <= F32


def test_gain_and_dcshift(rng):
    t, j = _pair(rng, 2, 500, scale=0.5)
    assert _rel(tops.gain(t, -6.0), jops.gain(j, -6.0)) <= F32
    for shift, lim in ((0.3, None), (0.4, 0.05), (-0.4, 0.05)):
        assert _rel(tops.dcshift(t, shift, lim),
                    jops.dcshift(j, shift, lim)) <= F32


@pytest.mark.parametrize("df,bound", [("TPDF", 1.0), ("RPDF", 0.5),
                                      ("GPDF", None)])
def test_dither(rng, df, bound):
    """The noise sits at the LSB with the density's support; the JAX op's
    with its own key obeys the same bound."""
    t, j = _pair(rng, 2, 4000, scale=0.3)
    lsb = 2.0 ** -15
    out = tops.dither(torch.Generator().manual_seed(1), t, df)
    jout = np.asarray(jops.dither(jax.random.PRNGKey(1), j, df))
    for noise in ((out - t).numpy(), jout - t.numpy()):
        assert np.abs(noise).max() > 0
        if bound is not None:
            assert np.abs(noise).max() <= bound * lsb * (1 + 1e-3)
        assert abs(noise.std() / lsb - {"TPDF": math.sqrt(1 / 6),
                                        "RPDF": math.sqrt(1 / 12),
                                        "GPDF": 0.5}[df]) < 0.05
    assert torch.equal(out, tops.dither(torch.Generator().manual_seed(1), t,
                                        df))


def test_add_noise(rng):
    t, j = _pair(rng, 3, 600)
    n, jn = _pair(rng, 3, 600)
    snr = np.array([0.0, 10.0, 20.0], np.float32)
    assert _rel(tops.add_noise(t, n, torch.from_numpy(snr)),
                jops.add_noise(j, jn, jnp.asarray(snr))) <= F32
    lengths = np.array([600, 400, 100])
    assert _rel(tops.add_noise(t, n, torch.from_numpy(snr),
                               torch.from_numpy(lengths)),
                jops.add_noise(j, jn, jnp.asarray(snr),
                               jnp.asarray(lengths))) <= F32


@pytest.mark.parametrize("factor", [0.9, 1.1])
def test_speed(rng, factor):
    t, j = _pair(rng, 2, 1600)
    got, lens = tops.speed(t, 8000, factor, torch.tensor([1600, 1000]))
    want, jlens = jops.speed(j, 8000, factor, jnp.asarray([1600, 1000]))
    assert _rel(got, want) <= F32
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


@pytest.mark.parametrize("center,norm_vars", [(False, False), (True, True)])
def test_sliding_window_cmn(rng, center, norm_vars):
    t, j = _pair(rng, 2, 13, 90)
    assert _rel(tops.sliding_window_cmn(t, 40, 10, center, norm_vars),
                jops.sliding_window_cmn(j, 40, 10, center, norm_vars)) <= SCAN


@pytest.mark.parametrize("enc,bits", [(None, None), ("PCM_S", 8),
                                      ("PCM_U", None), ("ULAW", None),
                                      ("ALAW", None)])
def test_apply_codec(rng, enc, bits):
    t, j = _pair(rng, 2, 2000, scale=0.4)
    assert _rel(tops.apply_codec(t, 8000, "wav", enc, bits),
                jops.apply_codec(j, 8000, "wav", enc, bits)) <= F32
    with pytest.raises(ValueError, match="wav"):
        tops.apply_codec(t, 8000, "mp3")


# ---- convolve --------------------------------------------------------------

@pytest.mark.parametrize("fn", ["convolve", "fftconvolve"])
@pytest.mark.parametrize("mode", ["full", "valid", "same"])
def test_convolve(rng, fn, mode):
    x, jx = _pair(rng, 3, 1, 300)
    y, jy = _pair(rng, 2, 41)
    assert _rel(getattr(tops, fn)(x, y, mode),
                getattr(jops, fn)(jx, jy, mode)) <= F32


# ---- metrics -----------------------------------------------------------------

def test_snr_and_si_snr(rng):
    est, jest = _pair(rng, 3, 1000)
    ref, jref = _pair(rng, 3, 1000)
    assert _rel(tops.snr(est, ref), jops.snr(jest, jref)) <= F32
    for zm in (True, False):
        assert _rel(tops.si_snr(est, ref, zm),
                    jops.si_snr(jest, jref, zm)) <= F32


def test_frechet_distance(rng):
    d = 6
    a, b = rng.standard_normal((2, 40, d))
    sx, sy = (np.cov(v.T).astype(np.float32) for v in (a, b))
    mx, my = (rng.standard_normal(d).astype(np.float32) for _ in range(2))
    got = tops.frechet_distance(*(torch.from_numpy(v) for v in
                                  (mx, sx, my, sy)))
    want = jops.frechet_distance(*(jnp.asarray(v) for v in
                                   (mx, sx, my, sy)))
    assert _rel(got, want) <= SCAN
    assert float(tops.frechet_distance(torch.from_numpy(mx),
                                       torch.from_numpy(sx),
                                       torch.from_numpy(mx),
                                       torch.from_numpy(sx))) < 1e-4


# ---- chroma, cqt, pitch detection --------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"tuning": 0.3, "base_c": False,
                                     "octwidth": None, "norm": 1}])
def test_chroma_filter(kw):
    got = tops.create_chroma_filter(12, 22050, 513, **kw)
    want = jops.create_chroma_filter(12, 22050, 513, **kw)
    assert got.dtype == torch.float32 and _rel(got, want) == 0.0
    assert _rel(tops.chroma_filterbank(16000, 201, 24),
                jops.chroma_filterbank(16000, 201, 24)) == 0.0


def test_cqt_and_pseudo_cqt(rng):
    kw = dict(sample_rate=8000, hop_length=128, n_bins=24, f_min=110.0)
    t, j = _pair(rng, 2, 4000)
    assert _rel(tops.cqt(t, **kw), jops.cqt(j, **kw)) <= F32
    np.testing.assert_array_equal(tops.cqt_frequencies(24, 110.0),
                                  jops.cqt_frequencies(24, 110.0))
    k1, k2 = tops.create_cqt_kernel(24, 110.0, 12, 8000, 2048)
    j1, j2 = jops.create_cqt_kernel(24, 110.0, 12, 8000, 2048)
    assert _rel(k1, j1) == 0.0 and _rel(k2, j2) == 0.0
    mag, jmag = _pair(rng, 2, 1025, 9, positive=True)
    assert _rel(tops.pseudo_cqt(mag, 8000, 24, 110.0),
                jops.pseudo_cqt(jmag, 8000, 24, 110.0)) <= F32
    with pytest.raises(ValueError, match="shorter than the lowest-bin"):
        tops.cqt(t, 8000, 128, 24, 110.0, fft_length=256)


def test_detect_pitch_frequency(rng):
    sr = 8000
    n = np.arange(sr // 2)
    x = np.stack([np.sin(2 * np.pi * 220.0 * n / sr),
                  np.sin(2 * np.pi * 330.0 * n / sr)
                  + 0.1 * rng.standard_normal(n.size)]).astype(np.float32)
    got = tops.detect_pitch_frequency(torch.from_numpy(x), sr)
    want = jax.jit(lambda v: jops.detect_pitch_frequency(v, sr))(
        jnp.asarray(x))
    assert _rel(got, want) <= F32


# ---- dsp ---------------------------------------------------------------------

def test_oscillator_bank_phase():
    """The port accumulates the phase in float64 where the JAX package
    sums three exact float32 streams modulo 1: on 0.5 s at 8 kHz of gliding
    partials both stay within 1e-5 of the amplitude (2π times ~1e-7 cycles
    plus the f32 sine), and partials at or above Nyquist are muted (with a
    warning)."""
    sr, t = 8000, 4000
    f0 = np.linspace(200.0, 260.0, t, dtype=np.float32)[:, None]
    freqs = np.concatenate([f0, 3.0 * f0, np.full_like(f0, 4100.0)], axis=1)
    amps = np.tile(np.array([1.0, 0.5, 1.0], np.float32), (t, 1))
    with pytest.warns(UserWarning, match="Nyquist"):
        got = tops.oscillator_bank(torch.from_numpy(freqs),
                                   torch.from_numpy(amps), sr, "none")
    want = jax.jit(lambda f, a: jops.oscillator_bank(f, a, sr, "none"))(
        jnp.asarray(freqs), jnp.asarray(amps))
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 1e-5
    assert not got[:, 2].any()


def test_envelopes_and_helpers(rng):
    kw = dict(attack=0.1, hold=0.1, decay=0.2, sustain=0.6, release=0.2)
    assert _rel(tops.adsr_envelope(300, **kw),
                jops.adsr_envelope(300, **kw)) == 0.0
    base, jbase = _pair(rng, 2, 50, 1, positive=True)
    for pattern in (4, [1.0, 2.5, 3.0]):
        assert _rel(tops.extend_pitch(base, pattern),
                    jops.extend_pitch(jbase, pattern)) == 0.0
    x, jx = _pair(rng, 3, 7)
    assert _rel(tops.exp_sigmoid(x), jops.exp_sigmoid(jx)) <= F32


@pytest.mark.parametrize("high_pass", [False, True])
def test_fir_design(rng, high_pass):
    c = np.array([0.1, 0.35, 0.8], np.float32)
    assert _rel(tops.sinc_impulse_response(torch.from_numpy(c), 101,
                                           high_pass),
                jops.sinc_impulse_response(jnp.asarray(c), 101,
                                           high_pass)) <= F32
    mag, jmag = _pair(rng, 2, 65, positive=True)
    assert _rel(tops.frequency_impulse_response(mag),
                jops.frequency_impulse_response(jmag)) <= F32


@pytest.mark.parametrize("delay", [None, 0])
def test_filter_waveform(rng, delay):
    x, jx = _pair(rng, 2, 1000)
    k, jk = _pair(rng, 2, 6, 33, scale=0.2)
    jfilter = jax.jit(lambda a, b: jops.filter_waveform(a, b, delay))
    assert _rel(tops.filter_waveform(x, k, delay), jfilter(jx, jk)) <= F32
    assert _rel(tops.filter_waveform(x[0], k[0], delay),
                jfilter(jx[0], jk[0])) <= F32


# ---- beamform ------------------------------------------------------------------

def _multichannel(rng, c=4, f=33, t=60):
    spec, jspec = _cpair(rng, 2, c, f, t)
    m = rng.random((2, f, t)).astype(np.float32)
    return spec, jspec, torch.from_numpy(m), jnp.asarray(m)


@pytest.mark.parametrize("masked,normalize", [(False, True), (True, True),
                                              (True, False)])
def test_psd(rng, masked, normalize):
    spec, jspec, m, jm = _multichannel(rng)
    got = tops.psd(spec, m if masked else None, normalize)
    want = jops.psd(jspec, jm if masked else None, normalize)
    assert got.shape == (2, 33, 4, 4) and _rel(got, want) <= SCAN


@pytest.mark.parametrize("solver", ["souden", "rtf_evd", "rtf_power"])
def test_mvdr_weights(rng, solver):
    spec, jspec, m, jm = _multichannel(rng)
    ps, pn = tops.psd(spec, m), tops.psd(spec, 1.0 - m)
    jps, jpn = jops.psd(jspec, jm), jops.psd(jspec, 1.0 - jm)
    if solver == "souden":
        w = tops.mvdr_weights_souden(ps, pn, 1)
        jw = jops.mvdr_weights_souden(jps, jpn, 1)
    else:
        if solver == "rtf_evd":
            rtf, jrtf = tops.rtf_evd(ps, 1), jops.rtf_evd(jps, 1)
        else:
            rtf = tops.rtf_power(ps, pn, 1)
            jrtf = jax.jit(lambda a, b: jops.rtf_power(a, b, 1))(jps, jpn)
        assert _rel(rtf, jrtf) <= SCAN
        w = tops.mvdr_weights_rtf(rtf, pn, 1)
        jw = jops.mvdr_weights_rtf(jrtf, jpn, 1)
    assert w.dtype == torch.complex64 and _rel(w, jw) <= SCAN
    assert _rel(tops.apply_beamforming(w, spec),
                jops.apply_beamforming(jw, jspec)) <= SCAN
