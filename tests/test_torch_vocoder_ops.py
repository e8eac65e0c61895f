"""The port's vocoder-side ops vs the JAX package (CPU): phase vocoder,
resample, pitch shift, μ-law, the bark filterbank and the torchaudio-named
filterbank factories, and their layers.

Tolerances: filters come from the same float64 NumPy construction (1e-6 of
peak).  The resampler is one float32 convolution of either side (1e-5 of
peak).  The phase vocoder accumulates float32 phases along time with a
cumulative sum whose order differs between XLA and PyTorch.  A bin's
phase advances by up to ``2π·hop/2`` radians a frame, so after a few
hundred frames the sum is of order 1e4 radians and one float32 rounding of
it is 1e-3 radians: 1e-2 of peak (measured up to 2.6e-3), and the pitch
shifter (stft → vocoder → istft → resample) inherits that bar.  (The port
sums in float64 since fault C4; the JAX package's float32 sum keeps the
bar.)
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import torchaudio_contrib_tpu as jat
from torchaudio_contrib_tpu import ops as jops
from torchaudio_contrib_tpu_torch import ops as tops
import torchaudio_contrib_tpu_torch as tat

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

VOCODER = 1e-2


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _spec(rng, shape, fft, hop):
    x = rng.standard_normal(shape).astype(np.float32)
    return x, np.array(jops.stft(jnp.asarray(x), fft, hop))


# ---- phase vocoder -----------------------------------------------------------

@pytest.mark.parametrize("rate", [0.8, 1.0, 1.3, 2.0])
def test_phase_vocoder_matches_jax(rng, rate):
    _, spec = _spec(rng, (2, 8000), 256, 64)
    adv_t = tops.compute_phase_advance(129, 64)
    adv_j = jops.compute_phase_advance(129, 64)
    np.testing.assert_array_equal(adv_t.numpy(), np.asarray(adv_j))
    got = tops.phase_vocoder(torch.from_numpy(spec), rate, adv_t).numpy()
    want = np.asarray(jops.phase_vocoder(jnp.asarray(spec), rate, adv_j))
    assert got.shape == want.shape
    assert got.shape[-1] == int(np.ceil(spec.shape[-1] / rate))
    # magnitudes are interpolated, not accumulated: tight
    np.testing.assert_allclose(np.abs(got), np.abs(want),
                               atol=1e-5 * np.abs(want).max())
    assert _rel(got, want) <= VOCODER


def test_stretch_layer(rng):
    _, spec = _spec(rng, (2, 4000), 256, 64)
    s = torch.from_numpy(spec)
    layer = tat.StretchSpecTime(1.25, hop_length=64, num_freqs=129)
    assert not layer.state_dict()
    assert torch.equal(layer(s), tops.phase_vocoder(
        s, 1.25, tops.compute_phase_advance(129, 64)))
    assert layer(s, rate=0.5).shape[-1] == 2 * spec.shape[-1]
    want = np.asarray(jat.StretchSpecTime(1.25, hop_length=64,
                                          num_freqs=129)(jnp.asarray(spec)))
    assert _rel(layer(s).numpy(), want) <= VOCODER


def test_phase_vocoder_amplifies_its_input_rounding():
    """Why the card is held to its CPU copy at 1e-2 through the vocoder
    (chip_smoke.py phases 18 and 25, ``tests/test_torch_cuda.py``): a
    perturbation of a 10 s spectrogram at the size of float32 FFT rounding
    (5e-7 of peak) moves the output 1e-4 to 1e-2 of peak, because a bin's
    phase integrates the angle errors of its weak frames."""
    g = torch.Generator().manual_seed(2)
    spec = tops.stft(torch.randn(2, 160000, generator=g), 1024, 256)
    adv = tops.compute_phase_advance(513, 256, 1024)
    noise = torch.complex(torch.randn(spec.shape, generator=g),
                          torch.randn(spec.shape, generator=g))
    moved = spec + 1e-7 * spec.abs().max() * noise
    base = torch.view_as_real(tops.phase_vocoder(spec, 1.1, adv)).numpy()
    out = torch.view_as_real(tops.phase_vocoder(moved, 1.1, adv)).numpy()
    assert _rel(torch.view_as_real(moved).numpy(),
                torch.view_as_real(spec).numpy()) <= 1e-6
    assert 1e-4 <= _rel(out, base) <= VOCODER


# ---- resample ----------------------------------------------------------------

@pytest.mark.parametrize("orig,new,shape", [
    (16000, 22050, (2, 3000)), (22050, 16000, (2, 2, 3000)),
    (8000, 16000, (1, 1000)), (48000, 16000, (3, 4001)),
    (16000, 16000, (2, 100)),
])
def test_resample_matches_jax(rng, orig, new, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    got = tops.resample(torch.from_numpy(x), orig, new).numpy()
    want = np.asarray(jops.resample(jnp.asarray(x), orig, new))
    assert got.shape == want.shape
    assert got.shape[-1] == -(-shape[-1] * new // orig)
    assert _rel(got, want) <= 1e-5
    layer = tat.Resample(orig, new)
    assert torch.equal(layer(torch.from_numpy(x)),
                       tops.resample(torch.from_numpy(x), orig, new))


def test_resample_errors_and_options(rng):
    x = torch.from_numpy(rng.standard_normal((1, 500)).astype(np.float32))
    with pytest.raises(ValueError, match="positive"):
        tops.resample(x, 0, 16000)
    got = tops.resample(x, 3, 2, zeros=8, beta=6.0).numpy()
    want = np.asarray(jops.resample(jnp.asarray(x.numpy()), 3, 2, zeros=8,
                                    beta=6.0))
    assert _rel(got, want) <= 1e-5


# ---- pitch shift -------------------------------------------------------------

@pytest.mark.parametrize("n_steps", [3.0, -2.0, 0.5, 0])
def test_pitch_shift_matches_jax(rng, n_steps):
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    got = tops.pitch_shift(torch.from_numpy(x), 16000, n_steps).numpy()
    want = np.asarray(jops.pitch_shift(jnp.asarray(x), 16000, n_steps))
    assert got.shape == want.shape == x.shape
    assert _rel(got, want) <= VOCODER


# ---- μ-law -------------------------------------------------------------------

@pytest.mark.parametrize("n_quantize", [256, 64])
def test_mulaw_matches_jax(rng, n_quantize):
    x = (rng.random((3, 1000)).astype(np.float32) * 2.4 - 1.2)
    got = tops.mu_law_encoding(torch.from_numpy(x), n_quantize)
    want = np.asarray(jops.mu_law_encoding(jnp.asarray(x), n_quantize))
    assert got.dtype == torch.int32
    assert got.min() >= 0 and got.max() <= n_quantize - 1
    # a code may flip where the companded value lands on a rounding edge
    assert np.abs(got.numpy() - want).max() <= 1
    assert (got.numpy() != want).mean() <= 1e-3
    codes = np.arange(n_quantize, dtype=np.int32)
    dec = tops.mu_law_decoding(torch.from_numpy(codes), n_quantize).numpy()
    np.testing.assert_allclose(
        dec, np.asarray(jops.mu_law_decoding(jnp.asarray(codes), n_quantize)),
        atol=1e-6)
    # decode(encode(x)) within one quantisation step (steps are widest, about
    # 2·ln(1+mu)/mu, at |x| = 1)
    x_in = np.clip(x, -1, 1)
    back = tat.MuLawDecoding(n_quantize)(
        tat.MuLawEncoding(n_quantize)(torch.from_numpy(x))).numpy()
    mu = n_quantize - 1
    assert np.abs(back - x_in).max() <= 2 * np.log1p(mu) / mu


# ---- bark filters and the torchaudio-named factories -------------------------

@pytest.mark.parametrize("scale", ["traunmuller", "schroeder", "wang"])
def test_bark_scale_and_filter_match_jax(scale):
    f = np.linspace(0.0, 11025.0, 50)
    np.testing.assert_allclose(tops.hertz_to_bark(f, scale),
                               jops.hertz_to_bark(f, scale), rtol=1e-12)
    b = np.linspace(0.5, 24.0, 50)
    np.testing.assert_allclose(tops.bark_to_hertz(b, scale),
                               jops.bark_to_hertz(b, scale), rtol=1e-12)
    ft = torch.from_numpy(f.astype(np.float32))
    np.testing.assert_allclose(
        tops.hertz_to_bark(ft, scale).numpy(),
        np.asarray(jops.hertz_to_bark(jnp.asarray(f, jnp.float32), scale)),
        rtol=1e-5, atol=1e-5)
    back = tops.bark_to_hertz(tops.hertz_to_bark(f, scale), scale)
    np.testing.assert_allclose(back, f, atol=1e-6 * 11025)
    got = tops.create_bark_filter(40, 22050, 0.0, None, 257,
                                  bark_scale=scale).numpy()
    want = np.asarray(jops.create_bark_filter(40, 22050, 0.0, None, 257,
                                              bark_scale=scale))
    assert got.shape == want.shape == (257, 40)
    assert _rel(got, want) <= 1e-6
    with pytest.raises(ValueError, match="bark_scale"):
        tops.hertz_to_bark(f, "zwicker")


def test_fbanks_factories_match_jax():
    pairs = [
        (tops.melscale_fbanks(201, 0.0, 8000.0, 40, 16000),
         jops.melscale_fbanks(201, 0.0, 8000.0, 40, 16000)),
        (tops.melscale_fbanks(201, 20.0, 8000.0, 40, 16000, norm="slaney",
                              mel_scale="slaney"),
         jops.melscale_fbanks(201, 20.0, 8000.0, 40, 16000, norm="slaney",
                              mel_scale="slaney")),
        (tops.linear_fbanks(201, 0.0, 8000.0, 30, 16000),
         jops.linear_fbanks(201, 0.0, 8000.0, 30, 16000)),
        (tops.barkscale_fbanks(201, 0.0, 8000.0, 24, 16000, "wang"),
         jops.barkscale_fbanks(201, 0.0, 8000.0, 24, 16000, "wang")),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        assert _rel(got.numpy(), want) <= 1e-6


def test_bark_layers_match_jax(rng):
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    fb = tat.BarkFilterbank(n_barks=24, sample_rate=16000, num_bins=129)
    assert not fb.state_dict()
    want_fb = np.asarray(jat.BarkFilterbank(
        n_barks=24, sample_rate=16000, num_bins=129).get_filterbank())
    assert _rel(fb.get_filterbank().numpy(), want_fb) <= 1e-6
    kw = dict(n_barks=24, sample_rate=16000, fft_length=256, hop_length=64)
    got = tat.Barkspectrogram(**kw)(torch.from_numpy(x)).numpy()
    want = np.asarray(jat.Barkspectrogram(**kw)(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 24, 63)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    trainable = tat.Barkspectrogram(trainable=True, **kw)
    assert list(trainable.state_dict()) == ["2.filterbank"]
