"""Parity of the port's IIR family (``ops/iir.py``: ``lfilter``,
``filtfilt``, the biquads) with the JAX package and with
``scipy.signal.lfilter`` in float64, on the CPU.

The same numpy input (from the per-test ``rng``) goes through the JAX
function under ``jax.jit`` (at most 16 384 samples) and through the port.
``lfilter`` is held to ``SCAN`` (1e-4 of the reference's peak) against the
JAX package's float32 scan and to 1e-5 against float64 scipy; gradients to
``SCAN`` against ``jax.grad``.  Each JAX scan costs about half a second to
compile, so the scans compile once, in a module fixture.  The designs and
``filtfilt`` run the JAX package's own code with its ``lfilter`` swapped for
float64 scipy (``exact_jiir``): its coefficients and compositions, held to
``F32`` (1e-5 of peak).  With poles near the unit circle the JAX package's
float32 scan is the less exact of the two (the port scans in float64,
``ops/iir.py``).  Long signals run on the port's side only, against scipy.
"""
import math

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.ops import iir as jiir
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import iir as tiir

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

SCAN = 1e-4
F32 = 1e-5


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _noise(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x, torch.from_numpy(x.copy()), jnp.asarray(x)


# name, (b, a): every order the JAX package has a path for, an
# unnormalised a0, a pure FIR, a FIR longer than 16 taps (the conv path)
FILTERS = [
    ("rbj_lowpass", jiir._rbj("lowpass", 16000, 2000, 0.707)),
    ("butter4", sps.butter(4, 0.2)),
    ("butter10", sps.butter(10, 0.3)),
    ("unnormalised_a0", ((0.4, 0.2, 0.1), (2.0, 0.6, 0.2))),
    ("pure_fir", ((0.5, 0.25, 0.125), (1.0,))),
    ("fir33_with_pole", (sps.firwin(33, 0.3), (1.0, -0.5))),
    ("one_pole", ((1.0, -1.0), (1.0, -0.995))),
]
GRAD_FILTERS = ["rbj_lowpass", "butter10"]
FILTFILT = sps.butter(3, 0.1)

DESIGNS = [
    ("lowpass_biquad", (16000, 1000.0)),
    ("highpass_biquad", (16000, 1000.0, 0.9)),
    ("bandpass_biquad", (16000, 2000.0)),
    ("bandreject_biquad", (16000, 2000.0, 1.5)),
    ("allpass_biquad", (16000, 700.0)),
    ("equalizer_biquad", (16000, 1000.0, 6.0)),
    ("bass_biquad", (16000, 6.0)),
    ("treble_biquad", (16000, -4.0, 2500.0)),
    ("band_biquad", (16000, 1500.0, 2.0)),
    ("deemph_biquad", (44100,)),
    ("riaa_biquad", (44100,)),
    ("riaa_biquad", (96000,)),
]
DESIGN_IDS = [f"{d[0]}_{d[1][0]}" for d in DESIGNS]
BIQUAD = (0.2, 0.1, 0.05, 1.0, -0.5, 0.2)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's scans on the same inputs, compiled once (each
    scan costs its compile): the filters on ``x`` (2, 3, 2048) and the
    gradients of ``Σ lfilter(xg)·g``."""
    rng = np.random.default_rng(70)
    x = rng.standard_normal((2, 3, 2048)).astype(np.float32)
    xg = rng.standard_normal((2, 700)).astype(np.float32)
    g = rng.standard_normal((2, 700)).astype(np.float32)
    filt = dict(FILTERS)
    b3, a3 = FILTFILT

    def refs(v):
        return {name: jiir.lfilter(v, a, b) for name, (b, a) in FILTERS}

    def grads(vg):
        out = {}
        for name in GRAD_FILTERS:
            b, a = filt[name]
            out[name] = jax.grad(
                lambda w: jnp.sum(jiir.lfilter(w, a, b) * g))(vg)
        return out

    return (x, xg, g, jax.jit(refs)(jnp.asarray(x)),
            jax.jit(grads)(jnp.asarray(xg)))


@pytest.fixture()
def exact_jiir(monkeypatch):
    """The JAX module with its ``lfilter`` replaced by float64
    ``scipy.signal.lfilter``: what the JAX package's designs and
    compositions compute, without the rounding of its float32 scan."""
    def lfilter64(w, a, b, *, clamp=False):
        y = sps.lfilter(np.asarray(b, np.float64), np.asarray(a, np.float64),
                        np.asarray(w, np.float64), axis=-1)
        return np.clip(y, -1.0, 1.0) if clamp else y

    monkeypatch.setattr(jiir, "lfilter", lfilter64)
    return jiir


@pytest.mark.parametrize("name,ba", FILTERS, ids=[f[0] for f in FILTERS])
def test_lfilter_matches_jax_and_scipy(jax_refs, name, ba):
    b, a = ba
    x, _, _, want, _ = jax_refs
    got = tops.lfilter(torch.from_numpy(x), a, b)
    assert got.dtype == torch.float32
    assert _rel(got, want[name]) <= SCAN
    ref = sps.lfilter(np.asarray(b, np.float64), np.asarray(a, np.float64),
                      x.astype(np.float64), axis=-1)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("order,wn", [(2, 0.25), (4, 0.25), (10, 0.25),
                                      (10, 0.1), (8, 0.05), (5, 0.02)])
def test_long_signal_matches_scipy(rng, order, wn):
    """Orders 2 to 10 on 5 s at 16 kHz, 17 doubling steps a section,
    against float64 scipy (the JAX tests' bars: 1e-5 at order 2, 5e-5 at
    4, 5e-4 at 10).  Narrow high orders are where the powers of a tenth-
    order companion matrix overflow float64 (Butterworth at 0.1 of
    Nyquist) and where the JAX package's float32 scans give NaN or 0.33 of
    peak; the port's second-order sections hold 1e-5 of peak."""
    b, a = sps.butter(order, wn)
    x = rng.standard_normal((1, 80000)).astype(np.float32)
    got = tops.lfilter(torch.from_numpy(x), a, b).numpy()
    ref = sps.lfilter(b, a, x.astype(np.float64), axis=-1)
    assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("a", [sps.butter(10, 0.1)[1], sps.cheby1(7, 1, 0.3)[1],
                               np.array([1.0, 0.5, 0.0, 0.0]),
                               np.array([1.0, -0.9]), np.array([1.0, 0.2, 0.3])])
def test_sections_rebuild_the_denominator(a):
    """The cascade's sections multiply back to the denominator: pairs of
    complex or of real roots, an odd real root alone; orders 1 and 2 are
    their own section."""
    secs = tiir._sections(np.asarray(a[1:], np.float64))
    assert all(s.shape[0] in (1, 2) for s in secs)
    assert len(secs) == (len(a) - 1 + 1) // 2
    prod = np.array([1.0])
    for sec in secs:
        prod = np.convolve(prod, np.concatenate([[1.0], sec]))
    np.testing.assert_allclose(prod, a, atol=1e-12)


def test_near_unit_poles_match_scipy(rng):
    """The BS.1770 high-pass (b = [1, -2, 1], a double pole at 0.995) on
    5 s at 48 kHz: its recursive half's DC gain is 4e4, which amplifies
    float32 rounding of the FIR half (0.12 of a 2.6 peak measured for a
    float32 chain on 10 s); the float64 scan holds it to float32
    rounding of the output."""
    import importlib
    jl = importlib.import_module("torchaudio_contrib_tpu.ops.loudness")
    (b1, a1), (b2, a2) = jl._k_weighting_coeffs(48000)
    x = (0.3 * rng.standard_normal((1, 240000))).astype(np.float32)
    got = tops.lfilter(tops.lfilter(torch.from_numpy(x), a1, b1), a2, b2)
    ref = sps.lfilter(b2, a2, sps.lfilter(b1, a1, x.astype(np.float64)))
    assert _rel(got, ref) <= F32


def test_doubling_steps():
    assert [tiir._doubling_steps(t) for t in (1, 2, 3, 4, 5, 661500)] == \
        [0, 1, 2, 2, 3, 20]


@pytest.mark.parametrize("i", range(len(DESIGNS)), ids=DESIGN_IDS)
def test_designs_match_jax(exact_jiir, rng, i):
    name, args = DESIGNS[i]
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    got = getattr(tops, name)(torch.from_numpy(x), *args)
    assert _rel(got, getattr(exact_jiir, name)(x, *args)) <= F32


def test_band_biquad_noise_and_biquad_match_jax(exact_jiir, rng):
    x = rng.standard_normal((3, 2000)).astype(np.float32)
    t = torch.from_numpy(x)
    assert _rel(tops.band_biquad(t, 16000, 1500.0, 2.0, noise=True),
                exact_jiir.band_biquad(x, 16000, 1500.0, 2.0,
                                       noise=True)) <= F32
    assert _rel(tops.biquad(t, *BIQUAD), exact_jiir.biquad(x, *BIQUAD)) \
        <= F32


@pytest.mark.parametrize("clamp", [False, True])
def test_filtfilt_matches_jax(exact_jiir, rng, clamp):
    b, a = FILTFILT
    x = 2.0 * rng.standard_normal((2, 3000)).astype(np.float32)
    got = tops.filtfilt(torch.from_numpy(x), a, b, clamp=clamp)
    assert _rel(got, exact_jiir.filtfilt(x, a, b, clamp=clamp)) <= F32
    if clamp:
        assert float(got.abs().max()) <= 1.0


def test_clamp():
    y = tops.lfilter(torch.tensor([0.0, 10.0, -10.0]), (1.0,), (1.0,),
                     clamp=True)
    assert y.tolist() == [0.0, 1.0, -1.0]


@pytest.mark.parametrize("name", GRAD_FILTERS)
def test_lfilter_gradient_matches_jax(jax_refs, name):
    b, a = dict(FILTERS)[name]
    _, xg, g, _, want = jax_refs
    t = torch.from_numpy(xg.copy()).requires_grad_()
    (tops.lfilter(t, a, b) * torch.from_numpy(g)).sum().backward()
    assert _rel(t.grad, want[name]) <= SCAN


def test_filtfilt_gradient_matches_jax(exact_jiir, rng):
    """``filtfilt`` is its own adjoint (flip · lfilter · flip · lfilter),
    so the gradient of ``Σ filtfilt(x)²`` is ``2·filtfilt(filtfilt(x))``:
    the JAX package's composition in float64 gives it exactly."""
    b, a = FILTFILT
    x = rng.standard_normal(600).astype(np.float32)
    t = torch.from_numpy(x.copy()).requires_grad_()
    (tops.filtfilt(t, a, b) ** 2).sum().backward()
    want = 2.0 * exact_jiir.filtfilt(exact_jiir.filtfilt(x, a, b), a, b)
    assert _rel(t.grad, want) <= SCAN


@pytest.mark.parametrize("design,kwargs,lo_gain,hi_gain", [
    ("lowpass_biquad", {"cutoff_freq": 1000}, (0.9, 1.1), (0.0, 0.1)),
    ("highpass_biquad", {"cutoff_freq": 1000}, (0.0, 0.1), (0.9, 1.1)),
])
def test_design_passbands(design, kwargs, lo_gain, hi_gain):
    sr = 16000
    t = np.arange(sr) / sr
    lo = np.sin(2 * np.pi * 100 * t).astype(np.float32)
    hi = np.sin(2 * np.pi * 6000 * t).astype(np.float32)
    fn = getattr(tops, design)
    gl = float(np.std(fn(torch.from_numpy(lo), sr, **kwargs).numpy()
                      [sr // 4:]) / np.std(lo))
    gh = float(np.std(fn(torch.from_numpy(hi), sr, **kwargs).numpy()
                      [sr // 4:]) / np.std(hi))
    assert lo_gain[0] <= gl <= lo_gain[1]
    assert hi_gain[0] <= gh <= hi_gain[1]


def test_riaa_and_deemph_validate_and_respond():
    sr = 44100
    t = np.arange(sr // 2) / sr

    def gain(fn, freq):
        x = torch.from_numpy(np.sin(2 * np.pi * freq * t).astype(np.float32))
        y = fn(x, sr).numpy()
        return np.sqrt(np.mean(y[y.size // 2:] ** 2)) / np.sqrt(0.5)

    assert abs(gain(tops.riaa_biquad, 1000.0) - 1.0) < 0.05
    assert gain(tops.riaa_biquad, 100.0) > 2.0
    assert abs(20 * math.log10(gain(tops.deemph_biquad, 100.0))) < 0.2
    for rate in (48000, 88200, 96000):
        assert tops.riaa_biquad(torch.ones(64), rate).shape == (64,)
    tops.deemph_biquad(torch.zeros(64), 48000)
    with pytest.raises(ValueError, match="supports"):
        tops.riaa_biquad(torch.ones(8), 16000)
    with pytest.raises(ValueError, match="supports"):
        tops.deemph_biquad(torch.zeros(64), 22050)


def test_bad_coeffs_raise():
    x = torch.zeros(16)
    with pytest.raises(ValueError, match="nonzero"):
        tops.lfilter(x, (0.0, 1.0), (1.0,))
    with pytest.raises(ValueError, match="1-D"):
        tops.lfilter(x, np.zeros((2, 2)), (1.0,))


def test_float64_input_stays_float64(rng):
    x = rng.standard_normal(500)
    b, a = sps.butter(2, 0.1)
    got = tops.lfilter(torch.from_numpy(x), a, b)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - sps.lfilter(b, a, x)).max() <= 1e-12
