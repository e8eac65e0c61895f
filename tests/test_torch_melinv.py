"""The port's mel inversion vs the JAX package (CPU).

The inverse filters come from the same float64 ridge solve on both sides
and are cast to float32 at the edge: they agree to 1e-6 of their peak.
``mel_to_linear`` is one float32 product of either side; ``mel_to_audio``
adds a few Griffin-Lim iterations from zero phase.  Inverted magnitudes
hold many bins clipped to 0 or near it, where the projection's division by
|update| amplifies rounding, so it is held to 5e-4 of peak (measured up to
1.2e-4) where the loops on measured magnitudes hold 1e-4.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from torchaudio_contrib_tpu import ops as jops
from torchaudio_contrib_tpu_torch import ops as tops

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("kw", [
    {"num_mels": 40, "sample_rate": 16000, "num_bins": 129},
    {"num_mels": 80, "sample_rate": 22050, "f_max": 8000.0,
     "num_bins": 513},
    {"num_mels": 64, "sample_rate": 16000, "f_min": 50.0, "num_bins": 257,
     "ridge": 1e-4},
])
def test_inverse_mel_filter_matches_jax(kw):
    got = tops.create_inverse_mel_filter(**kw).numpy()
    want = np.asarray(jops.create_inverse_mel_filter(**kw))
    assert got.shape == want.shape == (kw["num_mels"], kw["num_bins"])
    assert _rel(got, want) <= 1e-6
    assert tops.create_inverse_mel_filter(
        **kw, dtype=torch.float64).dtype == torch.float64


@pytest.mark.parametrize("kw", [
    {"n_barks": 30, "sample_rate": 16000, "num_bins": 129},
    {"n_barks": 40, "sample_rate": 22050, "num_bins": 257,
     "bark_scale": "schroeder"},
    {"n_barks": 24, "sample_rate": 16000, "num_bins": 201,
     "bark_scale": "wang", "f_max": 7000.0},
])
def test_inverse_bark_filter_matches_jax(kw):
    got = tops.create_inverse_bark_filter(**kw).numpy()
    want = np.asarray(jops.create_inverse_bark_filter(**kw))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("shape", [(40, 30), (2, 40, 30), (2, 2, 40, 7)])
def test_mel_to_linear_matches_jax(rng, shape):
    mel = rng.random(shape).astype(np.float32)
    inv = tops.create_inverse_mel_filter(40, 16000, num_bins=129)
    got = tops.mel_to_linear(torch.from_numpy(mel), inv).numpy()
    want = np.asarray(jops.mel_to_linear(jnp.asarray(mel),
                                         jnp.asarray(inv.numpy())))
    assert got.shape == want.shape == shape[:-2] + (129, shape[-1])
    assert got.min() >= 0.0
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def _mel(rng, power, to_db):
    x = torch.from_numpy(rng.standard_normal((2, 4000)).astype(np.float32))
    mel = tops.melspectrogram(x, num_mels=40, sample_rate=16000,
                              fft_length=256, hop_length=64, power=power)
    if to_db:
        mel = tops.amplitude_to_db(mel, power=power)
    return mel


@pytest.mark.parametrize("power,from_db,method,n_iter", [
    (2.0, False, "matmul", 3), (2.0, True, "matmul", 2),
    (1.0, False, "fft", 3), (1.0, True, "fft", 2)])
def test_mel_to_audio_matches_jax(rng, power, from_db, method, n_iter):
    mel = _mel(rng, power, from_db)
    kw = dict(sample_rate=16000, fft_length=256, hop_length=64, power=power,
              from_db=from_db, n_iter=n_iter, method=method, length=4000)
    got = tops.mel_to_audio(mel, **kw).numpy()
    want = np.asarray(jops.mel_to_audio(jnp.asarray(mel.numpy()), **kw))
    assert got.shape == want.shape == (2, 4000)
    assert _rel(got, want) <= 5e-4


def test_mel_to_audio_fused_method(rng):
    """``method="pallas"`` on the CPU runs the fused solve's plain version;
    it inverts the vocoder's settings to a finite waveform of the right
    length that carries the mel's energy."""
    mel = _mel(rng, 1.0, False)
    y = tops.mel_to_audio(mel, num_mels=40, sample_rate=16000,
                          fft_length=256, hop_length=64, power=1.0, n_iter=8,
                          method="pallas")
    assert y.shape == (2, (mel.shape[-1] - 1) * 64)
    assert bool(torch.isfinite(y).all())
    back = tops.melspectrogram(y, num_mels=40, sample_rate=16000,
                               fft_length=256, hop_length=64, power=1.0)
    err = ((back - mel[..., :back.shape[-1]]).norm() / mel.norm()).item()
    assert err <= 0.5, err
    y_mm = tops.mel_to_audio(mel, sample_rate=16000, fft_length=256,
                             hop_length=64, power=1.0, n_iter=8)
    assert y_mm.shape == y.shape                       # matmul by default
