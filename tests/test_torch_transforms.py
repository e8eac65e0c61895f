"""Parity of the port's torchaudio-named transforms (``models/transforms.py``)
and chroma layers with the JAX package's, on the CPU.

One case per layer: the JAX layer and its port are built with the same
arguments and fed the same numpy input (from the per-test ``rng``).
Tolerances, relative to the reference's peak: ``F32`` (1e-5) for layers
over plain float32 ops, ``SCAN`` (1e-4) for the log-domain, scan and
``torch.linalg`` layers.  The random layers draw from a ``torch.Generator``
where the JAX layers take a key: they are held to the op they wrap.
The phase-vocoder layers (``TimeStretch``, ``PitchShift``) take
``VOCODER`` (1e-2 of peak), the bar of ``tests/test_torch_vocoder_ops.py``:
the two packages sum float32 phases along time in different orders, and a
sum of order 1e4 radians rounds to 1e-3 radians.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.models import layers as jlayers
from torchaudio_contrib_tpu.models import transforms as jtr
from torchaudio_contrib_tpu_torch import models as tmodels
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.models import transforms as ttr

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

F32 = 1e-5
SCAN = 1e-4
VOCODER = 1e-2


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _pair(rng, *shape, positive=False, complex_=False):
    x = rng.standard_normal(shape)
    if complex_:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    else:
        x = (np.abs(x) if positive else x).astype(np.float32)
    return torch.from_numpy(x.copy()), jnp.asarray(x)


def _hann(n):
    return np.hanning(n + 1)[:-1]


# name, constructor args, input shape, input kind, tolerance
CASES = [
    ("MFCC", dict(sample_rate=16000, n_mfcc=13, num_mels=40, fft_length=512,
                  hop_length=128), (2, 4000), "wave", SCAN),
    ("LFCC", dict(sample_rate=16000, n_lfcc=13, n_filter=40, fft_length=512,
                  hop_length=128), (2, 4000), "wave", SCAN),
    ("PitchShift", dict(sample_rate=8000, n_steps=2.0, fft_length=256,
                        hop_length=64), (1, 2000), "wave", VOCODER),
    ("MelScale", dict(num_mels=32, sample_rate=16000, num_bins=129),
     (2, 129, 20), "mag", F32),
    ("InverseMelScale", dict(num_bins=129, num_mels=32, sample_rate=16000),
     (2, 32, 20), "mag", SCAN),
    ("AmplitudeToDB", dict(stype="magnitude", top_db=60.0), (2, 65, 20),
     "mag", F32),
    ("MelSpectrogram", dict(sample_rate=16000, n_fft=256, n_mels=32, pad=8,
                            window_fn=_hann), (2, 3000), "wave", F32),
    ("TimeStretch", dict(hop_length=64, n_freq=129, fixed_rate=1.3),
     (2, 129, 30), "complex", VOCODER),
    ("BarkScale", dict(n_stft=129, n_barks=24, sample_rate=16000),
     (2, 129, 20), "mag", F32),
    ("InverseBarkScale", dict(n_stft=129, n_barks=24, sample_rate=16000),
     (2, 24, 20), "mag", SCAN),
    ("BarkSpectrogram", dict(sample_rate=16000, n_fft=256, n_barks=24,
                             hop_length=100), (2, 3000), "wave", F32),
    ("ChromaScale", dict(sample_rate=16000, n_freqs=129), (2, 129, 20),
     "mag", F32),
    ("ChromaSpectrogram", dict(sample_rate=16000, n_fft=256, pad=4),
     (2, 3000), "wave", F32),
    ("Speed", dict(orig_freq=8000, factor=1.25), (2, 1600), "wave", F32),
    ("Fade", dict(fade_in_len=100, fade_out_len=300,
                  fade_shape="half_sine"), (2, 1000), "wave", F32),
    ("Vol", dict(gain=3.0, gain_type="amplitude"), (2, 500), "wave", F32),
    ("Preemphasis", dict(coeff=0.9), (2, 500), "wave", F32),
    ("Deemphasis", dict(coeff=0.9), (2, 300), "wave", SCAN),
    ("ComputeDeltas", dict(win_length=7), (2, 13, 40), "wave", F32),
    ("SlidingWindowCmn", dict(cmn_window=30, min_cmn_window=5,
                              norm_vars=True), (2, 13, 60), "wave", SCAN),
    ("SpectralCentroid", dict(sample_rate=16000, fft_length=256,
                              hop_length=128), (2, 3000), "wave", F32),
]


@pytest.mark.parametrize("name,kw,shape,kind,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_layer_matches_jax(rng, name, kw, shape, kind, tol):
    x, jx = _pair(rng, *shape, positive=kind == "mag",
                  complex_=kind == "complex")
    layer = getattr(ttr, name)(**kw)
    assert isinstance(layer, torch.nn.Module)
    assert not layer.state_dict()          # derived buffers only
    # one compiled JAX program is quicker than the layer's ops one by one;
    # a window_fn array is not traceable, so that layer runs as it is
    jlayer = getattr(jtr, name)(**kw)
    want = jlayer(jx) if "window_fn" in kw else jax.jit(jlayer)(jx)
    assert _rel(layer(x), want) <= tol
    assert getattr(tmodels, name) is getattr(ttr, name)


@pytest.mark.parametrize("name,second", [("Convolve", (2, 31)),
                                         ("FFTConvolve", (1, 31)),
                                         ("AddNoise", None)])
def test_two_input_layers(rng, name, second):
    x, jx = _pair(rng, 2, 400)
    if name == "AddNoise":
        n, jn = _pair(rng, 2, 400)
        snr = np.array([5.0, 15.0], np.float32)
        got = ttr.AddNoise()(x, noise=n, snr=torch.from_numpy(snr))
        want = jtr.AddNoise()(jx, noise=jn, snr=jnp.asarray(snr))
        with pytest.raises(TypeError, match="noise"):
            ttr.AddNoise()(x)
    else:
        y, jy = _pair(rng, *second)
        got = getattr(ttr, name)("same")(x, y)
        want = getattr(jtr, name)("same")(jx, jy)
    assert _rel(got, want) <= F32


def _mc(rng):
    spec, jspec = _pair(rng, 2, 4, 33, 50, complex_=True)
    m = rng.random((2, 33, 50)).astype(np.float32)
    return spec, jspec, torch.from_numpy(m), jnp.asarray(m)


@pytest.mark.parametrize("solution", ["ref_channel", "stv_evd", "stv_power"])
def test_mvdr(rng, solution):
    spec, jspec, m, jm = _mc(rng)
    got = ttr.MVDR(1, solution)(spec, mask_s=m, mask_n=1.0 - m)
    want = jax.jit(lambda s, a: jtr.MVDR(1, solution)(s, mask_s=a,
                                                      mask_n=1.0 - a))(
        jspec, jm)
    assert got.shape == (2, 33, 50) and _rel(got, want) <= SCAN
    with pytest.raises(NotImplementedError, match="online"):
        ttr.MVDR(online=True)


def test_psd_souden_rtf_layers(rng):
    spec, jspec, m, jm = _mc(rng)
    ps, pn = ttr.PSD()(spec, mask=m), ttr.PSD()(spec, mask=1.0 - m)
    jps, jpn = jtr.PSD()(jspec, mask=jm), jtr.PSD()(jspec, mask=1.0 - jm)
    assert _rel(ps, jps) <= SCAN
    assert _rel(ttr.SoudenMVDR(2)(spec, psd_s=ps, psd_n=pn),
                jtr.SoudenMVDR(2)(jspec, psd_s=jps, psd_n=jpn)) <= SCAN
    rtf = tops.rtf_evd(ps)
    assert _rel(ttr.RTFMVDR()(spec, rtf=rtf, psd_n=pn),
                jtr.RTFMVDR()(jspec, rtf=jnp.asarray(rtf.numpy()),
                              psd_n=jpn)) <= SCAN


def test_random_layers(rng):
    """The masks and the speed draw come from the generator: the same seed
    gives the same output, and each layer equals the op it wraps with the
    same generator state."""
    spec, _ = _pair(rng, 3, 20, 60)
    for layer, op in ((ttr.FrequencyMasking(6, -1.0),
                       lambda g, s: tops.freq_mask(g, s, 6, mask_value=-1.0)),
                      (ttr.TimeMasking(9),
                       lambda g, s: tops.time_mask(g, s, 9))):
        got = layer(spec, generator=torch.Generator().manual_seed(5))
        assert torch.equal(got, op(torch.Generator().manual_seed(5), spec))
    aug = ttr.SpecAugment(2, 10, 2, 5, iid_masks=True, zero_masking=False)
    out = aug(spec, generator=torch.Generator().manual_seed(1))
    assert torch.equal(out, aug(spec,
                                generator=torch.Generator().manual_seed(1)))
    masked = out != spec
    assert masked.any() and torch.allclose(out[masked],
                                           spec.mean().expand_as(out[masked]))
    x, jx = _pair(rng, 2, 1600)
    sp = ttr.SpeedPerturbation(8000, [0.9, 1.0, 1.1])
    got, lens = sp(x, torch.Generator().manual_seed(2),
                   lengths=torch.tensor([1600, 800]))
    i = int(torch.randint(0, 3, (), generator=torch.Generator().manual_seed(2)))
    want, jlens = jtr.Speed(8000, sp.factors[i])(jx), None
    assert _rel(got, want) <= F32
    assert lens.tolist() == tops.speed(x, 8000, sp.factors[i],
                                       torch.tensor([1600, 800]))[1].tolist()


def test_chroma_layers(rng):
    fb = tmodels.ChromaFilterbank(n_chroma=12, sample_rate=16000,
                                  num_bins=129, tuning=0.2)
    jfb = jlayers.ChromaFilterbank(n_chroma=12, sample_rate=16000,
                                   num_bins=129, tuning=0.2)
    assert _rel(fb.get_filterbank(), jfb.get_filterbank()) == 0.0
    x, jx = _pair(rng, 2, 3000)
    kw = dict(n_chroma=12, sample_rate=16000, fft_length=256,
              hop_length=64)
    got = tmodels.Chromagram(**kw)(x)
    want = jlayers.Chromagram(**kw)(jx)
    assert _rel(got, want) <= F32
    trainable = tmodels.Chromagram(**kw, trainable=True)
    assert list(trainable.state_dict()) == ["2.filterbank"]


# ---- the layers over the IIR family ---------------------------------------

# name, constructor args, input shape: waveforms at 16 kHz
IIR_LAYERS = [
    ("Overdrive", dict(gain=15.0, colour=10.0), (2, 3000)),
    ("Phaser", dict(sample_rate=16000, decay=0.5), (2, 3000)),
    ("Flanger", dict(sample_rate=16000, phase=50.0), (2, 2, 1500)),
    ("Contrast", dict(enhancement_amount=40.0), (2, 3000)),
    ("Lowpass", dict(sample_rate=16000, cutoff_freq=3000.0), (2, 3000)),
    ("Highpass", dict(sample_rate=16000, cutoff_freq=200.0, Q=0.9),
     (2, 3000)),
    ("Equalizer", dict(sample_rate=16000, center_freq=1000.0, gain_db=4.0),
     (2, 3000)),
]


@pytest.mark.parametrize("name,kw,shape", IIR_LAYERS,
                         ids=[c[0] for c in IIR_LAYERS])
def test_iir_layer_matches_jax(rng, monkeypatch, name, kw, shape):
    """The JAX layer with its package's ``lfilter`` swapped for float64
    ``scipy.signal.lfilter``: the layer's own code, without the rounding
    of a float32 scan (whose compile would cost half a second a case;
    ``tests/test_torch_iir.py`` holds the scans to each other)."""
    import scipy.signal as sps
    from torchaudio_contrib_tpu.ops import iir as jiir

    def lfilter64(w, a, b, *, clamp=False):
        y = sps.lfilter(np.asarray(b, np.float64), np.asarray(a, np.float64),
                        np.asarray(w, np.float64), axis=-1)
        return np.clip(y, -1.0, 1.0) if clamp else y

    monkeypatch.setattr(jiir, "lfilter", lfilter64)
    x, jx = _pair(rng, *shape)
    layer = getattr(ttr, name)(**kw)
    assert isinstance(layer, torch.nn.Module)
    assert not layer.state_dict()
    assert getattr(tmodels, name) is getattr(ttr, name)
    assert _rel(layer(0.3 * x), getattr(jtr, name)(**kw)(0.3 * jx)) <= SCAN


def test_loudness_and_vad_layers_wrap_their_ops(rng):
    """``Loudness`` and ``Vad`` (both modes) are their ops; the ops and
    both layers are held to the JAX package's in
    ``tests/test_torch_loudness_vad.py``."""
    x, _ = _pair(rng, 2, 2, 8000)
    assert torch.equal(ttr.Loudness(16000)(x), tops.loudness(x, 16000))
    assert torch.equal(ttr.Vad(16000)(x), tops.vad_onset(x, 16000))
    trimmed, valid = ttr.Vad(16000, mode="trim", trigger_level=5.0)(x[0])
    want = tops.vad_trim(x[0], 16000, trigger_level=5.0)
    assert torch.equal(trimmed, want[0]) and torch.equal(valid, want[1])
    for name in ("Loudness", "Vad"):
        assert getattr(tmodels, name) is getattr(ttr, name)
        assert not getattr(ttr, name)(16000).state_dict()
    with pytest.raises(ValueError, match="mode"):
        ttr.Vad(16000, mode="bogus")
