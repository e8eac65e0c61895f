"""The port's layer API vs the JAX package's: pipelines, the state_dict
contract, the factories, and a trainable-filterbank gradient."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torchaudio_contrib_tpu as jt
import torchaudio_contrib_tpu_torch as tt

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

ATOL = 1e-4


def _x(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_pipeline_indexing_and_slicing():
    pipe = tt.Melspectrogram(num_mels=16, sample_rate=16000, fft_length=256,
                             hop_length=64)
    assert len(pipe) == 3
    assert [type(t).__name__ for t in pipe] == ["STFT", "ComplexNorm",
                                                "ApplyFilterbank"]
    assert isinstance(pipe[0], tt.STFT) and isinstance(pipe[-1],
                                                       tt.ApplyFilterbank)
    head = pipe[:2]
    assert isinstance(head, tt.Pipeline) and len(head) == 2
    assert isinstance(pipe[1:], tt.Pipeline)
    # splice: spectrogram stages + a custom filterbank stage
    fb = tt.ApplyFilterbank(torch.ones(129, 4), trainable=True)
    spliced = tt.Pipeline(*pipe[:2], fb)
    out = spliced(torch.zeros(1, 1000))
    assert tuple(out.shape) == (1, 4, 1 + 1000 // 64)
    assert list(spliced.state_dict()) == ["2.filterbank"]


def test_state_dict_holds_only_trainable_parameters():
    kw = dict(num_mels=16, sample_rate=16000, fft_length=256, hop_length=64)
    assert tt.Melspectrogram(**kw).state_dict() == {}
    assert tt.Spectrogram(fft_length=256).state_dict() == {}
    assert tt.FusedMelspectrogram(**kw).state_dict() == {}
    assert tt.MelFilterbank(16, num_bins=129).state_dict() == {}
    sd = tt.Melspectrogram(trainable=True, **kw).state_dict()
    assert list(sd) == ["2.filterbank"] and tuple(sd["2.filterbank"].shape) \
        == (129, 16)
    sd = tt.FusedMelspectrogram(trainable=True, **kw).state_dict()
    assert list(sd) == ["filterbank"]
    # derived buffers still follow the module (dtype moves them here)
    stft = tt.STFT(256, 64).double()
    assert stft.window.dtype == torch.float64
    assert "window" in dict(stft.named_buffers())


@pytest.mark.parametrize("kw", [
    dict(num_mels=32, sample_rate=16000, fft_length=512, hop_length=128),
    dict(num_mels=40, sample_rate=16000, fft_length=400, hop_length=160,
         win_length=300, center=False),
])
def test_melspectrogram_pipeline_matches_jax(rng, kw):
    x = _x(rng, (2, 1, 6000))
    got = tt.Melspectrogram(**kw)(torch.from_numpy(x)).numpy()
    want = np.asarray(jt.Melspectrogram(**kw)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("center", [True, False])
def test_fused_factory_matches_pipeline(rng, center):
    kw = dict(num_mels=32, sample_rate=16000, fft_length=512,
              hop_length=128, center=center)
    x = torch.from_numpy(_x(rng, (2, 2, 8000)))
    fused = tt.Melspectrogram(fused=True, **kw)
    assert len(fused) == 1 and isinstance(fused[0], tt.FusedMelspectrogram)
    np.testing.assert_allclose(fused(x).numpy(),
                               tt.Melspectrogram(**kw)(x).numpy(),
                               atol=ATOL, rtol=1e-5)
    want = np.asarray(jt.Melspectrogram(fused=True, **kw)(
        jnp.asarray(x.numpy())))
    np.testing.assert_allclose(fused(x).numpy(), want, atol=ATOL, rtol=1e-5)


def test_fused_layer_matches_jax(rng):
    kw = dict(num_mels=40, sample_rate=22050, fft_length=512,
              hop_length=200, precision="split3")
    x = _x(rng, (3, 9000))
    got = tt.FusedMelspectrogram(**kw)(torch.from_numpy(x)).numpy()
    want = np.asarray(jt.FusedMelspectrogram(**kw)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_single_layers_match_jax(rng):
    x = _x(rng, (2, 3000))
    spec_t = tt.STFT(256, 100, win_length=200, window="blackman")(
        torch.from_numpy(x))
    spec_j = jt.STFT(256, 100, win_length=200, window="blackman")(
        jnp.asarray(x))
    np.testing.assert_allclose(spec_t.numpy(), np.asarray(spec_j),
                               atol=ATOL)
    mag_t = tt.ComplexNorm(1.0)(spec_t)
    mag_j = jt.ComplexNorm(1.0)(spec_j)
    np.testing.assert_allclose(mag_t.numpy(), np.asarray(mag_j), atol=ATOL)
    mel_t = tt.MelFilterbank(24, 16000, num_bins=129)(mag_t)
    mel_j = jt.MelFilterbank(24, 16000, num_bins=129)(mag_j)
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), atol=ATOL,
                               rtol=1e-5)
    db_t = tt.AmplitudeToDb(ref=2.0)(mel_t)
    db_j = jt.AmplitudeToDb(ref=2.0)(mel_j)
    np.testing.assert_allclose(db_t.numpy(), np.asarray(db_j), atol=ATOL)
    np.testing.assert_allclose(
        tt.DbToAmplitude(ref=2.0)(db_t).numpy(),
        np.asarray(jt.DbToAmplitude(ref=2.0)(db_j)), rtol=1e-4, atol=1e-6)


def test_factory_errors():
    with pytest.raises(ValueError, match="num_bins"):
        tt.Melspectrogram(fft_length=512, num_bins=100)
    with pytest.raises(ValueError, match="power=2"):
        tt.Melspectrogram(fused=True, power=1.0)
    with pytest.raises(ValueError, match="normalized"):
        tt.Melspectrogram(fused=True, normalized=True)
    with pytest.raises(ValueError, match="onesided"):
        tt.Melspectrogram(fused=True, onesided=False)
    with pytest.raises(ValueError, match="built-in mel"):
        tt.Melspectrogram(fused=True,
                          filterbank=tt.MelFilterbank(num_bins=1025))
    spec = tt.Spectrogram(power=2.0, fft_length=256, hop_length=64)
    assert isinstance(spec, tt.Pipeline) and spec[1].power == 2.0


@pytest.mark.parametrize("fused", [False, True])
def test_trainable_filterbank_gradient_matches_jax(rng, fused):
    """d(mean(log-mel · r)) / d(filterbank): the port's autograd (plain
    version on the CPU) vs ``jax.grad`` of the JAX layer."""
    kw = dict(num_mels=32, sample_rate=16000, fft_length=512,
              hop_length=128, trainable=True)
    x = _x(rng, (2, 1, 4000))
    if fused:
        jp = jt.Pipeline(jt.FusedMelspectrogram(**kw))
        tp = tt.Pipeline(tt.FusedMelspectrogram(**kw))
        stage = 0
    else:
        jp = jt.Pipeline(*jt.Melspectrogram(**kw).transforms,
                         jt.AmplitudeToDb(power=2.0))
        tp = tt.Pipeline(*tt.Melspectrogram(**kw), tt.AmplitudeToDb(power=2.0))
        stage = 2
    params = list(jp.init_params())
    r = rng.standard_normal(np.asarray(jp(jnp.asarray(x))).shape)
    r = r.astype(np.float32)

    def loss(fb):
        ps = tuple(fb if i == stage else p for i, p in enumerate(params))
        return jnp.mean(jp(jnp.asarray(x), params=ps) * r)

    g_j = np.asarray(jax.grad(loss)(params[stage]))
    (tp(torch.from_numpy(x)) * torch.from_numpy(r)).mean().backward()
    g_t = tp[stage].filterbank.grad.numpy()
    np.testing.assert_allclose(g_t, g_j, atol=ATOL, rtol=0)
    assert np.max(np.abs(g_t - g_j)) <= 1e-5 * np.max(np.abs(g_j))

