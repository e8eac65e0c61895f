"""Parity of the PyTorch port's functional ops with the JAX package.

Each test feeds the same NumPy input (from the per-test ``rng``) to a JAX
function and to its counterpart in ``torchaudio_contrib_tpu_torch`` and
compares on the CPU.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from torchaudio_contrib_tpu import ops as jops
from torchaudio_contrib_tpu.ops import windows as jwin
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import windows as twin

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

ATOL = 1e-4   # BASELINE.json's parity bar (float32 chains)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---- windows (the same float64 NumPy construction: exact) ----------------

@pytest.mark.parametrize("name", sorted(jwin._WINDOWS))
@pytest.mark.parametrize("periodic", [True, False])
def test_windows_match(name, periodic):
    for n in (1, 7, 64, 400):
        np.testing.assert_array_equal(
            twin.get_window(name, n, periodic),
            jwin.get_window(name, n, periodic))


def test_get_window_specs():
    w = np.linspace(0.0, 1.0, 16)
    np.testing.assert_array_equal(twin.get_window(w, 16), w)
    np.testing.assert_array_equal(twin.get_window(None, 5), np.ones(5))
    np.testing.assert_array_equal(
        twin.get_window(lambda n: np.arange(n), 4), np.arange(4.0))
    with pytest.raises(ValueError, match="length"):
        twin.get_window(w, 15)
    with pytest.raises(ValueError, match="unknown window"):
        twin.get_window("nope", 8)


@pytest.mark.parametrize("hop", [64, 100, 256])
def test_cola_and_nola(hop):
    w = twin.hann_window(256)
    env_t = twin.cola_window_sum(w, hop, 20, 256 + 19 * hop)
    env_j = jwin.cola_window_sum(w, hop, 20, 256 + 19 * hop)
    np.testing.assert_array_equal(env_t, env_j)
    assert twin.check_nola(w, hop, 20, 256 + 19 * hop) == \
        jwin.check_nola(w, hop, 20, 256 + 19 * hop)


# ---- mel scale and filterbank ----------------------------------------------

@pytest.mark.parametrize("scale", ["htk", "slaney"])
def test_mel_scale(scale):
    f = np.array([0.0, 100.0, 999.0, 1000.0, 4000.0, 11025.0])
    want = np.asarray(jops.hertz_to_mel(f, scale))
    np.testing.assert_allclose(tops.hertz_to_mel(f, scale), want,
                               rtol=1e-12)
    np.testing.assert_allclose(
        _np(tops.hertz_to_mel(torch.from_numpy(f), scale)), want,
        rtol=1e-12)
    m = np.linspace(0.0, 40.0, 9)
    np.testing.assert_allclose(tops.mel_to_hertz(m, scale),
                               np.asarray(jops.mel_to_hertz(m, scale)),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="mel_scale"):
        tops.hertz_to_mel(f, "bark")


@pytest.mark.parametrize("num_mels,sr,bins,scale,norm", [
    (128, 22050, 1025, "htk", None),
    (80, 16000, 201, "slaney", "slaney"),
    (40, 16000, 257, "htk", "slaney"),
    (16, 8000, 129, "slaney", None),
])
def test_mel_filter(num_mels, sr, bins, scale, norm):
    t = tops.create_mel_filter(num_mels, sr, 0.0, None, bins,
                               mel_scale=scale, norm=norm)
    j = jops.create_mel_filter(num_mels, sr, 0.0, None, bins,
                               mel_scale=scale, norm=norm)
    assert t.dtype == torch.float32 and tuple(t.shape) == (bins, num_mels)
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-6, rtol=0)


def test_apply_filterbank(rng):
    spec = rng.random((2, 3, 65, 11)).astype(np.float32)
    fb = rng.random((65, 9)).astype(np.float32)
    got = tops.apply_filterbank(_t(spec), _t(fb))
    want = jops.apply_filterbank(jnp.asarray(spec), jnp.asarray(fb))
    assert tuple(got.shape) == (2, 3, 9, 11)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=1e-6)


# ---- stft ---------------------------------------------------------------

@pytest.mark.parametrize("method", ["fft", "matmul", "gemm"])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("shape,fft,hop,win", [
    ((3, 2000), 256, 64, None),
    ((2, 2, 1500), 200, 80, 160),      # (B, C, T), win_length < fft
    ((1500,), 128, 128, 100),
])
def test_stft(rng, method, center, shape, fft, hop, win):
    x = rng.standard_normal(shape).astype(np.float32)
    got = tops.stft(_t(x), fft, hop, win, window="hann", center=center,
                    method=method)
    want = jops.stft(jnp.asarray(x), fft, hop, win, window="hann",
                     center=center, method="fft")
    want = np.asarray(want)
    assert got.is_complex() and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got.real), want.real, atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(got.imag), want.imag, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pad_mode", ["reflect", "constant", "replicate",
                                      "circular"])
def test_stft_options(rng, pad_mode):
    x = rng.standard_normal((2, 900)).astype(np.float32)
    kw = dict(window="hamming", pad_mode=pad_mode, normalized=True,
              onesided=False)
    got = _np(tops.stft(_t(x), 128, 50, **kw))
    want = np.asarray(jops.stft(jnp.asarray(x), 128, 50, **kw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_stft_errors(rng):
    x = _t(rng.standard_normal((1, 100)).astype(np.float32))
    with pytest.raises(ValueError, match="unknown stft method"):
        tops.stft(x, 64, method="bogus")
    with pytest.raises(ValueError, match="too short"):
        tops.stft(x, 256, center=False)
    with pytest.raises(ValueError, match="pad_mode"):
        tops.stft(x, 64, pad_mode="mirror")
    with pytest.raises(ValueError, match="win_length"):
        tops.stft(x, 64, win_length=80)


@pytest.mark.parametrize("t,fft,hop", [(1000, 256, 64), (1000, 256, 300),
                                       (256, 256, 1), (999, 100, 100)])
def test_frame_signal(rng, t, fft, hop):
    x = rng.standard_normal((2, t)).astype(np.float32)
    got = _np(tops.frame_signal(_t(x), fft, hop))
    want = np.asarray(jops.frame_signal(jnp.asarray(x), fft, hop))
    np.testing.assert_array_equal(got, want)
    for center in (True, False):
        assert tops.num_frames(t, fft, hop, center) == \
            jops.num_frames(t, fft, hop, center)


# ---- complex ops, dB -----------------------------------------------------

@pytest.mark.parametrize("power", [1.0, 2.0, 0.5])
def test_complex_norm(rng, power):
    c = (rng.standard_normal((3, 5, 7))
         + 1j * rng.standard_normal((3, 5, 7))).astype(np.complex64)
    want = np.asarray(jops.complex_norm(jnp.asarray(c), power))
    np.testing.assert_allclose(_np(tops.complex_norm(_t(c), power)), want,
                               rtol=1e-6, atol=1e-6)
    legacy = np.stack([c.real, c.imag], axis=-1)        # trailing-(re, im)
    np.testing.assert_allclose(_np(tops.complex_norm(_t(legacy), power)),
                               want, rtol=1e-6, atol=1e-6)


def test_angle_magphase(rng):
    c = (rng.standard_normal((4, 6))
         + 1j * rng.standard_normal((4, 6))).astype(np.complex64)
    np.testing.assert_allclose(_np(tops.angle(_t(c))),
                               np.asarray(jops.angle(jnp.asarray(c))),
                               atol=1e-6)
    mag, ph = tops.magphase(_t(c), 2.0)
    jmag, jph = jops.magphase(jnp.asarray(c), 2.0)
    np.testing.assert_allclose(_np(mag), np.asarray(jmag), rtol=1e-6)
    np.testing.assert_allclose(_np(ph), np.asarray(jph), atol=1e-6)
    with pytest.raises(ValueError, match="trailing dim 2"):
        tops.complex_norm(torch.zeros(3, 4))


@pytest.mark.parametrize("top_db", [None, 40.0])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_amplitude_to_db(rng, top_db, power):
    x = (rng.random((2, 3, 16, 20)) ** 6).astype(np.float32)
    x[0, 0, :4] = 0.0                                 # below amin
    got = _np(tops.amplitude_to_db(_t(x), ref=0.5, power=power,
                                   top_db=top_db))
    want = np.asarray(jops.amplitude_to_db(jnp.asarray(x), ref=0.5,
                                           power=power, top_db=top_db))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)
    back = _np(tops.db_to_amplitude(_t(want), ref=0.5, power=power))
    np.testing.assert_allclose(
        back, np.asarray(jops.db_to_amplitude(jnp.asarray(want), ref=0.5,
                                              power=power)), rtol=1e-5)


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_torchaudio_db_adapters(rng, ndim):
    x = (rng.random((2, 3, 8, 10)[-ndim:]) ** 4).astype(np.float32)
    kw = dict(multiplier=10.0, amin=1e-10, db_multiplier=0.3, top_db=30.0)
    got = _np(tops.amplitude_to_DB(_t(x), **kw))
    want = np.asarray(jops.amplitude_to_DB(jnp.asarray(x), **kw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(
        _np(tops.DB_to_amplitude(_t(want), 2.0, 0.5)),
        np.asarray(jops.DB_to_amplitude(jnp.asarray(want), 2.0, 0.5)),
        rtol=1e-5)


def test_db_errors():
    with pytest.raises(ValueError, match="amin"):
        tops.amplitude_to_db(torch.ones(3), amin=0.0)
    with pytest.raises(ValueError, match="top_db"):
        tops.amplitude_to_db(torch.ones(2, 3), top_db=-1.0)


# ---- one-call spectrogram / melspectrogram -----------------------------------

@pytest.mark.parametrize("power", [1.0, 2.0])
def test_spectrogram(rng, power):
    x = rng.standard_normal((2, 1, 3000)).astype(np.float32)
    got = _np(tops.spectrogram(_t(x), 512, 128, power=power))
    want = np.asarray(jops.spectrogram(jnp.asarray(x), 512, 128,
                                       power=power))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(num_mels=40, sample_rate=16000, fft_length=512, hop_length=160),
    dict(num_mels=32, sample_rate=22050, fft_length=256, hop_length=64,
         mel_scale="slaney", norm="slaney", center=False),
])
def test_melspectrogram(rng, kw):
    x = rng.standard_normal((2, 4000)).astype(np.float32) * 0.1
    got = _np(tops.melspectrogram(_t(x), **kw))
    want = np.asarray(jops.melspectrogram(jnp.asarray(x), **kw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_melspectrogram_errors(rng):
    x = _t(rng.standard_normal((1, 2000)).astype(np.float32))
    with pytest.raises(ValueError, match="onesided"):
        tops.melspectrogram(x, fft_length=256, onesided=False)
    with pytest.raises(ValueError, match="filterbank rows"):
        tops.melspectrogram(x, fft_length=256,
                            filterbank=torch.zeros(100, 8))
