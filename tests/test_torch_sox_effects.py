"""Parity of the port's ``sox_effects`` with the JAX package's chains, on
the CPU: every effect name of ``effect_names()``, the layouts, the file
path and the errors.

The same seeded numpy clip goes through both packages' chains.  Values are
held to ``F32`` (1e-5 of the JAX result's peak); the chains through the
phase vocoder (``tempo``, ``pitch``) to ``VOCODER``, the bar at which
``tests/test_torch_vocoder_ops.py`` holds ``pitch_shift`` to the JAX
package (the float32 phases are summed along time in another order).  The biquad chains run the JAX package's own designs and
compositions with its ``lfilter`` swapped for float64 scipy
(``exact_jiir``, as ``tests/test_torch_iir.py`` does): the port's
``lfilter`` scans in float64, the JAX package's in float32.  The chains
with a ``lax.scan`` of their own (``phaser``, ``flanger``) run the JAX
package's chain under ``jax.jit``; ``vad`` is held to the JAX package's
``vad_onset`` under ``jax.jit`` (its eager trim cannot be compiled).
"""
import importlib

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu import sox_effects as jse
from torchaudio_contrib_tpu import io as jio
from torchaudio_contrib_tpu.ops import iir as jiir
from torchaudio_contrib_tpu_torch import sox_effects as tse

# the module, not the function ``ops.vad`` that the package re-exports
jvad = importlib.import_module("torchaudio_contrib_tpu.ops.vad")

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

F32 = 1e-5
VOCODER = 1e-2
SR = 16000

# name: (chain, sample rate, how the JAX chain runs: "eager" or "jit")
CASES = {
    "allpass": ([["allpass", "1k", "2q"]], SR, "eager"),
    "band": ([["band", "-n", "1200", "300h"]], SR, "eager"),
    "bandpass": ([["bandpass", "-c", "440", "220h"]], SR, "eager"),
    "bandreject": ([["bandreject", "2k", "1.5q"]], SR, "eager"),
    "bass": ([["bass", "6", "150"]], SR, "eager"),
    "channels": ([["channels", "1"]], SR, "eager"),
    "contrast": ([["contrast", "60"]], SR, "eager"),
    "dcshift": ([["dcshift", "0.1"]], SR, "eager"),
    "deemph": ([["deemph"]], 44100, "eager"),
    "equalizer": ([["equalizer", "440", "2q", "6"]], SR, "eager"),
    "fade": ([["fade", "q", "0.05", "0.2", "0.03"]], SR, "eager"),
    "flanger": ([["flanger", "1", "2", "0", "71", "0.5", "triangle", "25",
                  "quadratic"]], SR, "jit"),
    "gain": ([["gain", "-n", "-3"]], SR, "eager"),
    "highpass": ([["highpass", "-1", "80"]], SR, "eager"),
    "lowpass": ([["lowpass", "-2", "1k", "0.9q"]], SR, "eager"),
    "norm": ([["norm", "-1"]], SR, "eager"),
    "overdrive": ([["overdrive", "25", "30"]], SR, "eager"),
    "pad": ([["pad", "0.01", "0.02"]], SR, "eager"),
    "phaser": ([["phaser", "0.4", "0.74", "3", "0.4", "0.5", "-t"]], SR,
               "jit"),
    "pitch": ([["pitch", "300"]], SR, "eager"),
    "rate": ([["rate", "-v", "8k"]], SR, "eager"),
    "reverse": ([["reverse"]], SR, "eager"),
    "riaa": ([["riaa"]], 44100, "eager"),
    "speed": ([["speed", "1.1"]], SR, "eager"),
    "tempo": ([["tempo", "1.25"]], SR, "eager"),
    "treble": ([["treble", "-4", "3k"]], SR, "eager"),
    "trim": ([["trim", "0.05", "0.1"]], SR, "eager"),
    "vol": ([["vol", "0.5"], ["vol", "-6", "dB"], ["vol", "0.25", "power"]],
            SR, "eager"),
    # the smoke script's chain (phase 25 (c))
    "chain": ([["speed", "1.1"], ["rate", "16000"], ["gain", "-n", "-3"],
               ["highpass", "80"], ["lowpass", "7000"],
               ["fade", "0.1", "10", "0.1"]], SR, "eager"),
}


def _rel(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _clip(seed=5, ch=2, n=4000, sr=SR):
    """A 440 Hz tone with harmonics under noise, ``(ch, n)`` float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 1300 * t)
         + 0.05 * rng.standard_normal((ch, n)))
    return x.astype(np.float32)


@pytest.fixture()
def exact_jiir(monkeypatch):
    """The JAX package's ``iir`` with its ``lfilter`` replaced by float64
    ``scipy.signal.lfilter`` (what its designs compute, without the
    rounding of its float32 scan)."""
    def lfilter64(w, a, b, *, clamp=False):
        y = sps.lfilter(np.asarray(b, np.float64), np.asarray(a, np.float64),
                        np.asarray(w, np.float64), axis=-1)
        return np.clip(y, -1.0, 1.0) if clamp else y

    monkeypatch.setattr(jiir, "lfilter", lfilter64)


def _jax_chain(x, sr, chain, how):
    if how == "eager":
        out, new_sr = jse.apply_effects_tensor(jnp.asarray(x), sr, chain)
        return np.asarray(out, np.float32), new_sr
    box = {}

    def run(w):
        out, box["sr"] = jse.apply_effects_tensor(w, sr, chain)
        return out

    return np.asarray(jax.jit(run)(jnp.asarray(x))), box["sr"]


def test_effect_names_are_the_jax_packages():
    assert tse.effect_names() == jse.effect_names()
    assert len(tse.effect_names()) == 30
    covered = {eff[0] for chain, _, _ in CASES.values() for eff in chain}
    assert covered | {"dither", "vad"} == set(tse.effect_names())


@pytest.mark.parametrize("name", sorted(CASES))
def test_effect_matches_the_jax_chain(name, exact_jiir):
    chain, sr, how = CASES[name]
    x = _clip(sr=sr)
    want, want_sr = _jax_chain(x, sr, chain, how)
    got, got_sr = tse.apply_effects_tensor(torch.from_numpy(x), sr, chain)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got_sr == want_sr
    bar = VOCODER if name in ("tempo", "pitch") else F32
    assert _rel(got, want) <= bar


def test_vad_matches_the_jax_onset():
    # 0.4 s of faint noise, then a voiced, speech-like second
    rng = np.random.default_rng(9)
    t = np.arange(SR) / SR
    voiced = sum(np.sin(2 * np.pi * 120 * k * t) / k for k in range(1, 9))
    voiced *= 0.15 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2))
    x = np.concatenate([0.01 * rng.standard_normal((2, 6400)),
                        np.stack([voiced, voiced])], axis=1)
    x = x.astype(np.float32)
    onset = jax.jit(lambda w: jvad.vad_onset(w, SR))(jnp.asarray(x))
    start = int(np.min(np.asarray(onset)))
    got, sr = tse.apply_effects_tensor(torch.from_numpy(x), SR, [["vad"]])
    assert sr == SR and 0 < start < x.shape[-1]
    np.testing.assert_array_equal(got.numpy(), x[:, start:])


def test_dither_takes_a_generator():
    x = _clip()
    out, _ = tse.apply_effects_tensor(
        torch.from_numpy(x), SR, [["dither"]],
        generator=torch.Generator().manual_seed(3))
    again, _ = tse.apply_effects_tensor(
        torch.from_numpy(x), SR, [["dither"]],
        generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    lsb = 2.0 ** -15
    noise = (out - torch.from_numpy(x)).abs()
    assert 0 < float(noise.max()) <= 1.0001 * lsb
    for mod, kw in ((tse, {}), (jse, {})):
        with pytest.raises(ValueError, match="dither needs randomness"):
            mod.apply_effects_tensor(x, SR, [["dither"]], **kw)


def test_layouts_match_the_jax_package(exact_jiir):
    chain = [["lowpass", "2k"], ["gain", "-2"]]
    x = _clip()
    for wave, kw in ((x.T.copy(), dict(channels_first=False)),
                     (x[0], {}), (x[0], dict(channels_first=False))):
        want, _ = jse.apply_effects_tensor(jnp.asarray(wave), SR, chain, **kw)
        got, _ = tse.apply_effects_tensor(torch.from_numpy(wave), SR, chain,
                                          **kw)
        assert _rel(got, want) <= F32
    # a channel-expanding effect on 1-D input keeps its channels
    got, _ = tse.apply_effects_tensor(x[0], SR, [["channels", "2"]])
    want, _ = jse.apply_effects_tensor(jnp.asarray(x[0]), SR,
                                       [["channels", "2"]])
    assert got.shape == (2, 4000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_effects_file_matches_the_jax_package(tmp_path, exact_jiir):
    x = _clip()
    path = str(tmp_path / "c.wav")
    jio.write_wav(path, x, SR)
    chain = CASES["chain"][0]
    for channels_first in (True, False):
        want, want_sr = jse.apply_effects_file(path, chain,
                                               channels_first=channels_first)
        got, got_sr = tse.apply_effects_file(path, chain,
                                             channels_first=channels_first,
                                             device="cpu")
        assert got.device.type == "cpu" and got_sr == want_sr
        assert _rel(got, want) <= F32


@pytest.mark.parametrize("chain", [
    [["chorus", "0.5"]], [["lowpass", "1k", "2o"]], [["gain", "-l", "3"]],
    [["gain"]], [["vol", "2", "volts"]], [["vol", "-1", "power"]],
    [["tempo", "1.1", "20"]], [["bass", "3", "100", "0.5s"]],
    [["flanger", "0", "2", "0", "71", "0.5", "square"]],
    [["flanger", "0", "2", "0", "71", "0.5", "sine", "25", "cubic"]],
    [["phaser", "1", "1", "1", "1", "1", "1"]], [["deemph", "1"]],
    [["riaa", "1"]], [["rate", "-v"]], [["fade"]], [["channels", "3"]],
    [[]], [["speed", "x1"]],
])
def test_errors_are_the_jax_packages(chain):
    x = _clip()
    with pytest.raises(ValueError) as want:
        jse.apply_effects_tensor(jnp.asarray(x), SR, chain)
    with pytest.raises(ValueError) as got:
        tse.apply_effects_tensor(torch.from_numpy(x), SR, chain)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="1-D or 2-D"):
        tse.apply_effects_tensor(torch.zeros(1, 2, 3), SR, [["reverse"]])
