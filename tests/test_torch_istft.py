"""The port's ISTFT, conv STFT and ``inverse_spectrogram`` vs the JAX
package, on the same NumPy inputs (CPU).

Tolerances: both sides are float32 chains of the same arithmetic (inverse
DFT, window, overlap-add, envelope division) on unit-variance input, so
they agree to 1e-5 absolute; a forward + inverse round trip recovers the
waveform to 1e-4 (BASELINE config 4's bar).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from torchaudio_contrib_tpu import ops as jops
from torchaudio_contrib_tpu_torch import ops as tops
import torchaudio_contrib_tpu_torch as tat

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

ATOL = 1e-5
ROUND_TRIP = 1e-4


def _spec(rng, shape, fft, hop, **kw):
    """A complex spectrogram of unit-variance noise, as NumPy (the JAX
    forward's, so both inverses start from the same numbers)."""
    x = rng.standard_normal(shape).astype(np.float32)
    return x, np.array(jops.stft(jnp.asarray(x), fft, hop, **kw))


@pytest.mark.parametrize("method", ["fft", "matmul"])
@pytest.mark.parametrize("shape,fft,hop,kw", [
    ((2, 4000), 256, 64, {}),
    ((2, 2, 3000), 400, 160, {"window": "hamming"}),
    ((3, 2048), 128, 128, {"window": "rectangular"}),
    ((2, 4000), 256, 64, {"center": False, "window": "hamming"}),
    ((2, 4000), 256, 64, {"win_length": 200}),
    ((2, 4000), 256, 64, {"normalized": True}),
])
def test_istft_matches_jax(rng, method, shape, fft, hop, kw):
    _, spec = _spec(rng, shape, fft, hop, **kw)
    got = tops.istft(torch.from_numpy(spec), hop, fft_length=fft,
                     method=method, **kw)
    want = np.asarray(jops.istft(jnp.asarray(spec), hop, fft_length=fft,
                                 method=method, **kw))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,fft,hop", [
    ((2, 2, 8192), 1024, 256),      # BASELINE config 4, cut to 8192 samples
    ((2, 5000), 512, 128),
    ((1, 4001), 400, 100),
])
@pytest.mark.parametrize("method", ["fft", "matmul"])
def test_round_trip(rng, shape, fft, hop, method):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    y = tops.istft(tops.stft(x, fft, hop, method=method), hop,
                   length=shape[-1], method=method)
    assert y.shape == x.shape
    assert (y - x).abs().max().item() <= ROUND_TRIP


@pytest.mark.parametrize("length", [3000, 4000, 4500, 6000])
def test_length_crops_and_zero_pads(rng, length):
    x, spec = _spec(rng, (2, 4000), 256, 64)
    got = tops.istft(torch.from_numpy(spec), 64, length=length).numpy()
    want = np.asarray(jops.istft(jnp.asarray(spec), 64, length=length))
    assert got.shape == (2, length)
    keep = min(length, 4000)
    np.testing.assert_allclose(got[:, :keep], want[:, :keep], atol=ATOL,
                               rtol=0)
    # past the waveform's end the frames hold reflect padding divided by
    # an envelope that falls towards 0: rounding is amplified there
    np.testing.assert_allclose(got[:, keep:], want[:, keep:], atol=1e-2,
                               rtol=0)
    np.testing.assert_allclose(got[:, :keep], x[:, :keep], atol=ROUND_TRIP)
    if length > 4000 + 128:
        assert not got[:, 4000 + 128:].any()       # past the last frame


def test_twosided(rng):
    x, spec = _spec(rng, (2, 3000), 128, 32, onesided=False)
    assert spec.shape[-2] == 128
    got = tops.istft(torch.from_numpy(spec), 32, onesided=False,
                     length=3000).numpy()
    want = np.asarray(jops.istft(jnp.asarray(spec), 32, onesided=False,
                                 length=3000))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, x, atol=ROUND_TRIP)
    with pytest.raises(ValueError, match="onesided only"):
        tops.istft(torch.from_numpy(spec), 32, onesided=False,
                   method="matmul")


def test_istft_errors(rng):
    _, spec = _spec(rng, (1, 2000), 128, 128)
    s = torch.from_numpy(spec)
    # hann at hop == fft: the envelope touches zero inside the output
    with pytest.raises(ValueError, match="NOLA"):
        tops.istft(s, 128, window="hann")
    with pytest.raises(ValueError, match="NOLA"):
        jops.istft(jnp.asarray(spec), 128, window="hann")
    with pytest.raises(ValueError, match="unknown istft method"):
        tops.istft(s, 128, method="gemm")
    with pytest.raises(ValueError, match="win_length"):
        tops.istft(s, 128, win_length=200)


@pytest.mark.parametrize("n_frames,fft,hop,center,length", [
    (10, 256, 64, True, None), (10, 256, 64, False, None),
    (7, 400, 160, True, None), (7, 400, 160, True, 1234),
])
def test_stft_output_length(n_frames, fft, hop, center, length):
    assert (tops.stft_output_length(n_frames, fft, hop, center, length)
            == jops.stft_output_length(n_frames, fft, hop, center, length))


@pytest.mark.parametrize("shape,fft,hop,kw", [
    ((2, 4000), 256, 64, {}),
    ((2, 2, 3000), 400, 160, {"window": "hamming", "center": False}),
    ((2, 3000), 128, 50, {"onesided": False, "normalized": True}),
    ((2, 3000), 256, 64, {"win_length": 200}),
])
def test_stft_conv_matches_jax(rng, shape, fft, hop, kw):
    x = rng.standard_normal(shape).astype(np.float32)
    got = tops.stft(torch.from_numpy(x), fft, hop, method="conv", **kw)
    want = np.asarray(jops.stft(jnp.asarray(x), fft, hop, method="conv",
                                **kw))
    assert tuple(got.shape) == want.shape
    # sums of fft terms of unit-variance samples in f32, another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    ref = tops.stft(torch.from_numpy(x), fft, hop, **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kw", [
    {}, {"normalized": True}, {"normalized": "window"},
    {"normalized": "frame_length", "win_length": 200},
    {"pad": 100, "length": 3000},
    {"length": 2500, "center": False, "window": "hamming"},
    {"window": "hamming", "hop_length": 50},
])
def test_inverse_spectrogram_matches_jax(rng, kw):
    x, spec = _spec(rng, (2, 3200), 256, kw.get("hop_length", 64),
                    win_length=kw.get("win_length"),
                    window=kw.get("window"),
                    center=kw.get("center", True))
    kw = {"n_fft": 256, "hop_length": 64, **kw}
    got = tops.inverse_spectrogram(torch.from_numpy(spec), **kw).numpy()
    want = np.asarray(jops.inverse_spectrogram(jnp.asarray(spec), **kw))
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=ATOL * scale, rtol=0)


def test_inverse_spectrogram_window_norm_is_torchaudios(rng):
    """``normalized=True`` undoes a forward division by
    ``sqrt(sum(window**2))`` (torchaudio's convention), not by
    ``sqrt(n_fft)``."""
    x = torch.from_numpy(rng.standard_normal((2, 3200)).astype(np.float32))
    w = tops.get_window("hann", 256)
    spec = tops.stft(x, 256, 64, window="hann") / float((w ** 2).sum()) ** 0.5
    y = tops.inverse_spectrogram(spec, length=3200, window="hann", n_fft=256,
                                 hop_length=64, normalized=True)
    assert (y - x).abs().max().item() <= ROUND_TRIP
    with pytest.raises(ValueError, match="complex"):
        tops.inverse_spectrogram(spec.abs(), n_fft=256)
    with pytest.raises(ValueError, match="normalized"):
        tops.inverse_spectrogram(spec, n_fft=256, normalized="bogus")


def test_istft_layers(rng):
    x, spec = _spec(rng, (2, 3000), 256, 64)
    s = torch.from_numpy(spec)
    want = tops.istft(s, 64, length=3000)
    for cls in (tat.ISTFT, tat.InverseSpectrogram):
        layer = cls(fft_length=256, hop_length=64, length=3000)
        assert torch.equal(layer(s), want)
        assert not layer.state_dict()
    pipe = tat.Pipeline(tat.STFT(256, 64), tat.ISTFT(256, 64, length=3000))
    np.testing.assert_allclose(pipe(torch.from_numpy(x)).numpy(), x,
                               atol=ROUND_TRIP)
