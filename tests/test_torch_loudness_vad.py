"""Parity of the port's BS.1770 loudness (``ops/loudness.py``) and voice
activity detection (``ops/vad.py``) with the JAX package, on the CPU.

The JAX references run under one ``jax.jit`` on 1 s clips at 16 kHz (at
most 16 384 samples: each scan costs its compile, and the JAX package's
own eager tests of these modules take minutes).  Loudness is held to
``LU`` (1e-3 LU) against the JAX package and against a float64
NumPy/SciPy BS.1770 chain; its gradient to ``SCAN`` (1e-4 of peak) of
the JAX package's gradient taken in float64 (``jax.enable_x64``); the
VAD's measures to ``SCAN`` of their peak, its onsets and valid lengths
exactly.  The properties of ``tests/test_loudness.py`` and
``tests/test_vad.py`` (the −3 LKFS full-scale sine, gating,
multichannel; onsets after silence and noise, rejection, trimming) run at
their own lengths on the port's side only.
"""
import importlib

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.models import transforms as jtr
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.models import transforms as ttr

# the packages' ops namespaces export functions named like these modules
jl = importlib.import_module("torchaudio_contrib_tpu.ops.loudness")
tl = importlib.import_module("torchaudio_contrib_tpu_torch.ops.loudness")
jvad = importlib.import_module("torchaudio_contrib_tpu.ops.vad")
tvad = importlib.import_module("torchaudio_contrib_tpu_torch.ops.vad")

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

SR = 16000
LU = 1e-3
SCAN = 1e-4


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _sine(freq, sr, seconds, amp=1.0):
    t = np.arange(int(sr * seconds)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _speechy(dur, amp=0.3, f0=120.0):
    t = np.arange(int(dur * SR)) / SR
    sig = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 9))
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2))
    return (amp * env * sig).astype(np.float32)


def _noise(dur, amp=0.01, seed=0):
    rng = np.random.default_rng(seed)
    return (amp * rng.standard_normal(int(dur * SR))).astype(np.float32)


def bs1770_f64(x: np.ndarray, sr: float) -> np.ndarray:
    """BS.1770-4 integrated loudness of ``x (..., ch, t)`` in float64:
    SciPy's ``lfilter`` for the K-weighting, NumPy for the gates."""
    (b1, a1), (b2, a2) = jl._k_weighting_coeffs(sr)
    y = sps.lfilter(b2, a2, sps.lfilter(b1, a1, np.asarray(x, np.float64)))
    block = int(round(0.4 * sr))
    hop = block // 4
    n = 1 + (y.shape[-1] - block) // hop
    z = np.stack([np.mean(y[..., i * hop:i * hop + block] ** 2, -1)
                  for i in range(n)], -1)              # (..., ch, n)
    g = np.ones(z.shape[-2])
    g[3:] = 1.41
    zw = np.einsum("c,...cn->...n", g, z)
    lb = -0.691 + 10 * np.log10(np.maximum(zw, 1e-30))
    gated = lb > -70.0
    mean = (zw * gated).sum(-1) / np.maximum(gated.sum(-1), 1)
    rel = -0.691 + 10 * np.log10(np.maximum(mean, 1e-30)) - 10.0
    gated = gated & (lb > rel[..., None])
    mean = (zw * gated).sum(-1) / np.maximum(gated.sum(-1), 1)
    return -0.691 + 10 * np.log10(np.maximum(mean, 1e-30))


def _clips():
    """1 s clips at 16 kHz: loudness (2, 3, T) with a quiet gated tail
    and 5 channels (surround weights); VAD (6, T) onsets of every kind."""
    rng = np.random.default_rng(71)
    loud = (0.2 * rng.standard_normal((2, 5, SR))).astype(np.float32)
    loud[0, :, SR // 2:] *= 1e-4                  # gated by −70 LKFS
    loud[1, :, :SR // 4] *= 0.1                   # by the relative gate
    vad = np.stack([
        np.concatenate([np.zeros(SR // 2, np.float32), _speechy(0.5)]),
        np.concatenate([_noise(0.45, 0.02), _speechy(0.55, 0.4)]),
        _speechy(1.0),
        _noise(1.0, 0.05, seed=3),
        np.zeros(SR, np.float32),
        np.concatenate([_speechy(0.3), np.zeros(SR // 2, np.float32),
                        _speechy(0.2)]),
    ])
    return loud, vad


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX references in one compiled program.  The VAD's measures
    (two scans and the noise-floor scan) are traced once: the JAX onset,
    trim and layer calls that follow read them through a stand-in for
    ``_vad_measures`` (every call here uses the default measure
    parameters on the same clips), so what they add is the JAX package's
    trigger logic on its own measures."""
    loud, vad = _clips()
    g = np.random.default_rng(72).standard_normal(2).astype(np.float32)

    def refs(lj, vj):
        meas = jvad._vad_measures(vj, SR, 0.35, 0.1, 0.01, 1.35, 20.0, None,
                                  0.4, 50.0, 6000.0)
        measures = jvad._vad_measures
        jvad._vad_measures = lambda w, *a: meas[:w.shape[0]]
        lk = jl.loudness(lj, SR)
        try:
            return {
                "loudness": lk,
                "measures": meas,
                "onset": jvad.vad_onset(vj, SR),
                "onset_gap0": jvad.vad_onset(vj, SR, allowed_gap=0.0,
                                             trigger_time=0.1),
                "onset_pre": jvad.vad_onset(vj, SR, pre_trigger_time=0.2,
                                            trigger_level=5.0),
                "trim": jvad.vad_trim(vj, SR),
                "trim_2ch": jvad.vad_trim(vj[:2], SR),
                "layer_trim": jtr.Vad(SR, mode="trim")(vj),
            }
        finally:
            jvad._vad_measures = measures

    out = jax.jit(refs)(jnp.asarray(loud), jnp.asarray(vad))
    # the gradient in float64: the JAX package's float32 scan puts its own
    # gradient 2.5e-3 of peak from this one on these clips
    with jax.enable_x64(True):
        out["loudness_grad"] = np.asarray(jax.jit(jax.grad(
            lambda w: jnp.sum(jl.loudness(w, SR) * g)))(
                jnp.asarray(loud, jnp.float64)))
    return loud, vad, g, out


# ---- loudness ----------------------------------------------------------------

def test_k_weighting_coeffs_match_jax():
    for sr in (16000, 44100, 48000):
        assert tl._k_weighting_coeffs(sr) == jl._k_weighting_coeffs(sr)


def test_loudness_matches_jax_and_float64(jax_refs):
    loud, _, _, want = jax_refs
    got = tops.loudness(torch.from_numpy(loud), SR)
    assert got.shape == (2,)
    assert np.abs(got.numpy() - np.asarray(want["loudness"])).max() <= LU
    assert np.abs(got.numpy() - bs1770_f64(loud, SR)).max() <= LU


def test_loudness_layer_and_gradient_match_jax(jax_refs):
    """The layer's gradient against the JAX package's float64 gradient."""
    loud, _, g, want = jax_refs

    t = torch.from_numpy(loud.copy()).requires_grad_()
    (ttr.Loudness(SR)(t) * torch.from_numpy(g)).sum().backward()
    assert t.grad.dtype == torch.float32
    assert not ttr.Loudness(SR).state_dict()
    assert _rel(t.grad, want["loudness_grad"]) <= SCAN


def test_full_scale_sine_is_minus_3_lkfs():
    x = torch.from_numpy(_sine(997.0, 48000, 3.0))[None, None, :]
    assert abs(float(tops.loudness(x, 48000)[0]) - (-3.01)) < 0.05
    x44 = torch.from_numpy(_sine(997.0, 44100, 3.0))[None, None, :]
    assert abs(float(tops.loudness(x44, 44100)[0]) - (-3.01)) < 0.1


def test_loudness_long_clip_matches_float64(rng):
    """10 s of noise at 48 kHz, where the float32 K-weighting chain was 5e-3
    dB off (``ops/iir.py``): within 1e-3 LU of the float64 chain."""
    x = (0.3 * rng.standard_normal((1, 2, 480000))).astype(np.float32)
    got = float(tops.loudness(torch.from_numpy(x), 48000)[0])
    assert abs(got - float(bs1770_f64(x, 48000)[0])) <= LU


def test_gain_linearity_gating_and_multichannel():
    sr = 48000
    x = _sine(997.0, sr, 2.0, amp=0.1)

    def lk(a):
        return float(tops.loudness(torch.from_numpy(a), sr)[0])

    mono = lk(x[None, None])
    assert abs((lk(10 * x[None, None]) - mono) - 20.0) < 0.01
    padded = np.concatenate([x, np.zeros(6 * sr, np.float32)])
    assert abs(lk(padded[None, None]) - mono) < 0.5
    assert abs((lk(np.stack([x, x])[None]) - mono) - 3.01) < 0.05


def test_loudness_validates():
    with pytest.raises(ValueError, match="too short"):
        tops.loudness(torch.zeros((1, 1, 1000)), 48000)
    with pytest.raises(ValueError, match="channel"):
        tops.loudness(torch.zeros(1000), 48000)


def test_a_weighting_matches_jax():
    f = np.array([1.0, 5.0, 20.0, 100.0, 1000.0, 10000.0, 20000.0])
    refs = jax.jit(lambda v: [jl.a_weighting(v, min_db=m)
                              for m in (-80.0, None)])(f)
    for min_db, want in zip((-80.0, None), refs):
        assert _rel(tops.a_weighting(torch.from_numpy(f), min_db=min_db),
                    want) <= 1e-6


# ---- VAD ---------------------------------------------------------------------

def test_vad_measures_match_jax(jax_refs):
    _, vad, _, want = jax_refs
    got = tvad._vad_measures(torch.from_numpy(vad), SR, 0.35, 0.1, 0.01,
                             1.35, 20.0, None, 0.4, 50.0, 6000.0)
    assert _rel(got, want["measures"]) <= SCAN


@pytest.mark.parametrize("key,kw", [
    ("onset", {}),
    ("onset_gap0", dict(allowed_gap=0.0, trigger_time=0.1)),
    ("onset_pre", dict(pre_trigger_time=0.2, trigger_level=5.0)),
])
def test_vad_onsets_equal_jax(jax_refs, key, kw):
    _, vad, _, want = jax_refs
    got = tops.vad_onset(torch.from_numpy(vad), SR, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want[key]))


def test_vad_onsets_cover_every_kind(jax_refs):
    """The fixture's clips: speech after silence and after noise, speech
    from the start, noise only and zeros (no onset: the clip length)."""
    on = np.asarray(jax_refs[3]["onset"])
    assert 0.3 * SR <= on[0] <= 0.8 * SR and 0.3 * SR <= on[1] <= 0.8 * SR
    assert on[2] < SR and on[3] == SR and on[4] == SR


def test_vad_trim_and_layer_equal_jax(jax_refs):
    _, vad, _, want = jax_refs
    t = torch.from_numpy(vad)
    for got, key in ((tops.vad_trim(t, SR), "trim"),
                     (tops.vad_trim(t[:2], SR), "trim_2ch"),
                     (ttr.Vad(SR, mode="trim")(t), "layer_trim")):
        np.testing.assert_array_equal(got[1].numpy(),
                                      np.asarray(want[key][1]))
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(want[key][0]))
    np.testing.assert_array_equal(ttr.Vad(SR)(t).numpy(),
                                  np.asarray(want["onset"]))
    with pytest.raises(ValueError):
        ttr.Vad(SR, mode="bogus")


def test_onset_after_silence_and_noise():
    for lead in (np.zeros(SR, np.float32), _noise(1.0, 0.005),
                 _noise(1.0, 0.05), _noise(1.0, 0.1)):
        amp = max(5 * float(np.abs(lead).max()) / 3, 0.3)
        x = torch.from_numpy(np.concatenate([lead, _speechy(1.5, amp)]))
        on = int(tops.vad_onset(x, SR))
        assert 0.9 * SR <= on <= 1.45 * SR, on / SR


def test_sustained_speech_not_absorbed_into_floor():
    t = np.arange(int(1.5 * SR)) / SR
    sustained = (0.3 * sum(np.sin(2 * np.pi * 120.0 * k * t) / k
                           for k in range(1, 9))).astype(np.float32)
    for lead in (np.zeros(SR, np.float32), _noise(1.0)):
        x = torch.from_numpy(np.concatenate([lead, sustained]))
        assert 0.8 * SR <= int(tops.vad_onset(x, SR)) <= 1.45 * SR


def test_no_speech_and_speech_from_start():
    rng = np.random.default_rng(5)
    loud = torch.from_numpy((0.2 * rng.standard_normal(int(2.5 * SR)))
                            .astype(np.float32))
    assert int(tops.vad_onset(loud, SR)) == loud.shape[-1]
    assert int(tops.vad_onset(torch.zeros(2 * SR), SR)) == 2 * SR
    assert int(tops.vad_onset(torch.from_numpy(_speechy(2.0)), SR)) \
        <= 0.7 * SR


def test_vad_trims_and_validates():
    x = torch.from_numpy(np.concatenate([np.zeros(SR, np.float32),
                                         _speechy(1.5)]))
    y = tops.vad(x, SR)
    assert 1.05 * SR <= y.shape[-1] < x.shape[-1]
    on = int(tops.vad_onset(x, SR))
    on_pre = int(tops.vad_onset(x, SR, pre_trigger_time=0.3))
    assert on_pre <= on - int(0.25 * SR)
    two = torch.stack([x, torch.cat([torch.zeros(SR // 2), x[:-SR // 2]])])
    trimmed, valid = tops.vad_trim(two, SR)
    assert valid[0] == valid[1]
    assert torch.equal(trimmed[0, :int(valid[0])], tops.vad(two, SR)[0])
    assert not trimmed[:, int(valid[0]):].any()
    with pytest.raises(ValueError):
        tops.vad(torch.zeros((2, 2, SR)), SR)
    with pytest.raises(ValueError, match="too short"):
        tops.vad_onset(torch.zeros(10), SR)
    with pytest.raises(NotImplementedError):
        tops.vad_onset(torch.zeros(SR), SR, hp_lifter_freq=100.0)
    with pytest.raises(NotImplementedError):
        tops.vad_onset(torch.zeros(SR), SR, lp_lifter_freq=1000.0)
