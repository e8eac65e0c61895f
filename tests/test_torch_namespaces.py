"""The port's torchaudio-named namespaces (``functional``, ``transforms``,
``prototype.*``), its root names, ``utils.view_as_real``/
``view_as_complex`` and ``kaldi_io``, against the JAX package's, on the
CPU.

- Name lists: each namespace's ``__all__`` equals the JAX module's, its
  names are the port's objects, and the root has every name of the JAX
  root's ``__all__``.
- The five argument adapters of ``functional`` against the JAX package's
  on the same seeded input: the plain ops at ``F32`` (1e-5 of peak), the
  Griffin-Lim loop at ``LOOP_PARITY`` (1e-4, as
  ``tests/test_torch_griffinlim.py``), ``pitch_shift`` at ``VOCODER``
  (1e-2, as ``tests/test_torch_vocoder_ops.py``), ``lfilter`` against the
  JAX package's float32 scan at ``SCAN`` (1e-4, as
  ``tests/test_torch_iir.py``).  ``spectrogram(normalized=True|"window")``
  is held to a NumPy oracle of torchaudio's formula instead (the JAX
  package scales by ``1/sqrt(n_fft)`` there).
- ``kaldi_io``: archives written by either package are byte-equal, and
  each reads the other's.
"""
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torchaudio_contrib_tpu as jtac
import torchaudio_contrib_tpu_torch as ttac
from torchaudio_contrib_tpu import kaldi_io as jk
from torchaudio_contrib_tpu_torch import kaldi_io as tk

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

F32 = 1e-5
SCAN = 1e-4
LOOP_PARITY = 1e-4
VOCODER = 1e-2
ADAPTED = {"spectrogram", "griffinlim", "pitch_shift", "spectral_centroid",
           "lfilter"}
NAMESPACES = ["functional", "transforms", "prototype",
              "prototype.functional", "prototype.models",
              "prototype.pipelines", "prototype.transforms"]


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


# ---- name lists -------------------------------------------------------------

@pytest.mark.parametrize("name", NAMESPACES)
def test_namespace_all_equals_the_jax_packages(name):
    t = importlib.import_module(f"torchaudio_contrib_tpu_torch.{name}")
    j = importlib.import_module(f"torchaudio_contrib_tpu.{name}")
    assert t.__all__ == j.__all__
    for n in t.__all__:
        assert hasattr(t, n), n


def test_namespace_objects_are_the_ports():
    F, T, P = ttac.functional, ttac.transforms, ttac.prototype
    for n in F.__all__:
        if n in ADAPTED:
            assert getattr(F, n) is not getattr(ttac.ops, n), n
        else:
            assert getattr(F, n) is getattr(ttac.ops, n), n
    for n in T.__all__:
        assert getattr(T, n) is getattr(ttac.models, n), n
    for sub, home in (("functional", ttac.ops), ("transforms", ttac.models),
                      ("models", ttac.models),
                      ("pipelines", ttac.pipelines)):
        mod = getattr(P, sub)
        for n in mod.__all__:
            assert getattr(mod, n) is getattr(home, n), f"{sub}.{n}"


def test_root_has_every_jax_root_name():
    missing = [n for n in jtac.__all__ if not hasattr(ttac, n)]
    assert missing == []
    assert set(jtac.__all__) <= set(ttac.__all__)
    for n in ("io", "datasets", "kaldi_io", "sox_effects", "functional",
              "transforms", "prototype"):
        assert getattr(ttac, n) is importlib.import_module(
            f"torchaudio_contrib_tpu_torch.{n}")
    assert ttac.view_as_real is ttac.utils.view_as_real


# ---- the adapters -----------------------------------------------------------

def _noise(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("pad,power,normalized,win", [
    (0, 2.0, False, "hann"), (64, 1.0, False, "hann"),
    (0, None, False, "hann"), (0, 2.0, "frame_length", "hann"),
    (16, 1.0, "frame_length", "hamming"), (0, 2.0, False, None),
])
def test_spectrogram_adapter_matches_the_jax_package(pad, power, normalized,
                                                     win):
    x = _noise(1, 2, 3000)
    kw = dict(pad=pad, window=win, n_fft=256, hop_length=100, win_length=256,
              power=power, normalized=normalized)
    got = ttac.functional.spectrogram(torch.from_numpy(x), **kw)
    want = jtac.functional.spectrogram(jnp.asarray(x), **kw)
    if power is None:
        assert torch.is_complex(got)
        got, want = torch.view_as_real(got), np.stack(
            [np.real(want), np.imag(want)], -1)
    assert _rel(got, want) <= F32


def _torchaudio_spectrogram(x, n_fft, hop, win_length, window):
    """NumPy oracle of torchaudio's ``spectrogram(normalized="window")``
    (centred, reflect-padded, power 2): the STFT divided by the window's
    L2 norm."""
    pad = n_fft // 2
    xp = np.pad(x.astype(np.float64), [(0, 0), (pad, pad)], mode="reflect")
    n_frames = 1 + (xp.shape[-1] - n_fft) // hop
    left = (n_fft - win_length) // 2
    w = np.zeros(n_fft)
    w[left:left + win_length] = window
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    spec = np.fft.rfft(xp[:, idx] * w, axis=-1) / np.sqrt(np.sum(window ** 2))
    return np.abs(np.swapaxes(spec, -1, -2)) ** 2


@pytest.mark.parametrize("normalized", [True, "window"])
@pytest.mark.parametrize("win_length", [256, 200])
def test_spectrogram_normalized_follows_torchaudio(normalized, win_length):
    x = _noise(2, 2, 2500)
    n = np.arange(win_length)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)
    got = ttac.functional.spectrogram(
        torch.from_numpy(x), pad=0, window=torch.from_numpy(hann),
        n_fft=256, hop_length=64, win_length=win_length, power=2.0,
        normalized=normalized)
    want = _torchaudio_spectrogram(x, 256, 64, win_length, hann)
    assert _rel(got, want) <= F32
    with pytest.raises(ValueError, match="normalized must be"):
        ttac.functional.spectrogram(
            torch.from_numpy(x), pad=0, window=None, n_fft=256,
            hop_length=64, win_length=256, power=2.0, normalized="peak")


def test_griffinlim_adapter_matches_the_jax_package():
    x = _noise(3, 1, 4000)
    kw = dict(window="hann", n_fft=256, hop_length=64, win_length=256,
              power=2.0, n_iter=4, momentum=0.9, length=4000)
    spec = ttac.functional.spectrogram(
        torch.from_numpy(x), pad=0, window="hann", n_fft=256, hop_length=64,
        win_length=256, power=2.0, normalized=False)
    got = ttac.functional.griffinlim(spec, rand_init=False, **kw)
    want = jtac.functional.griffinlim(jnp.asarray(spec.numpy()),
                                      rand_init=False, **kw)
    assert got.shape == (1, 4000)
    assert _rel(got, want) <= LOOP_PARITY
    # rand_init: a generator seeded 0 unless one is given
    a = ttac.functional.griffinlim(spec, rand_init=True, **kw)
    b = ttac.functional.griffinlim(
        spec, rand_init=True, generator=torch.Generator().manual_seed(0),
        **kw)
    c = ttac.functional.griffinlim(
        spec, rand_init=True, generator=torch.Generator().manual_seed(1),
        **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, got)
    with pytest.raises(NotImplementedError, match="win_length"):
        ttac.functional.griffinlim(spec, rand_init=False,
                                   **dict(kw, win_length=200))


def test_pitch_shift_and_centroid_adapters_match_the_jax_package():
    x = _noise(4, 2, 4000)
    got = ttac.functional.pitch_shift(torch.from_numpy(x), 16000, 2.0)
    want = jtac.functional.pitch_shift(jnp.asarray(x), 16000, 2.0)
    assert _rel(got, want) <= VOCODER
    kw = dict(pad=8, window="hann", n_fft=256, hop_length=128,
              win_length=256)
    got = ttac.functional.spectral_centroid(torch.from_numpy(x), 16000, **kw)
    want = jtac.functional.spectral_centroid(jnp.asarray(x), 16000, **kw)
    assert _rel(got, want) <= F32


@pytest.mark.parametrize("clamp", [None, False])
def test_lfilter_adapter_matches_the_jax_package(clamp):
    x = 3.0 * _noise(5, 2, 1500)            # clamping matters
    a, b = [1.0, -0.5, 0.2], [0.4, 0.3, 0.1]
    kw = {} if clamp is None else dict(clamp=clamp)
    got = ttac.functional.lfilter(torch.from_numpy(x), torch.tensor(a),
                                  torch.tensor(b), **kw)
    want = jax.jit(lambda w: jtac.functional.lfilter(w, a, b, **kw))(
        jnp.asarray(x))
    assert _rel(got, want) <= SCAN
    assert (float(got.abs().max()) <= 1.0) == (clamp is None)


# ---- view_as_real / view_as_complex -----------------------------------------

def test_view_as_real_and_complex_match_the_jax_package():
    z = (_noise(6, 3, 5) + 1j * _noise(7, 3, 5)).astype(np.complex64)
    got = ttac.view_as_real(torch.from_numpy(z))
    want = jtac.view_as_real(jnp.asarray(z))
    assert got.shape == (3, 5, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = ttac.view_as_complex(got)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jtac.view_as_complex(want)))
    zt = torch.from_numpy(z)
    assert ttac.view_as_complex(zt) is zt             # complex passes
    with pytest.raises(ValueError, match="expected complex"):
        ttac.view_as_real(torch.zeros(3))
    with pytest.raises(ValueError, match="trailing dim 2"):
        ttac.view_as_complex(torch.zeros(3, 3))


# ---- kaldi_io -----------------------------------------------------------------

def test_kaldi_io_round_trip_bytes_equal_the_jax_packages(tmp_path):
    rng = np.random.default_rng(8)
    mats = [("utt1", rng.standard_normal((7, 5)).astype(np.float32)),
            ("utt2", rng.standard_normal((3, 5))),              # float64
            ("utt3", rng.standard_normal((1, 4)).astype(np.float32))]
    vecs = [("a", rng.standard_normal(6).astype(np.float32)),
            ("b", rng.standard_normal(2))]
    ints = [("x", np.array([3, 1, 4, 1, 5], np.int32)),
            ("y", np.array([], np.int32))]
    for kind, items in (("mat", mats), ("vec_flt", vecs), ("vec_int", ints)):
        paths = {}
        for name, mod, conv in (("t", tk, torch.from_numpy),
                                ("j", jk, np.asarray)):
            ark = str(tmp_path / f"{name}_{kind}.ark")
            scp = str(tmp_path / f"{name}_{kind}.scp")
            getattr(mod, f"write_{kind}_ark")(
                ark, [(k, conv(v)) for k, v in items], scp_path=scp)
            paths[name] = (ark, scp)
        assert open(paths["t"][0], "rb").read() \
            == open(paths["j"][0], "rb").read()
        readers = [f"read_{kind}_ark"] + (
            [f"read_{kind}_scp"] if kind != "vec_int" else [])
        for reader in readers:
            idx = 0 if reader.endswith("ark") else 1
            got = list(getattr(tk, reader)(paths["j"][idx]))
            want = list(getattr(jk, reader)(paths["t"][idx]))
            assert [k for k, _ in got] == [k for k, _ in want]
            for (_, g), (_, w) in zip(got, want):
                assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
                assert g.numpy().dtype == w.dtype
                np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="bad Kaldi key"):
        tk.write_mat_ark(str(tmp_path / "bad.ark"),
                         [("two words", torch.zeros(2, 2))])
