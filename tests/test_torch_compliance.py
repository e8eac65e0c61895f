"""Parity of the port's Kaldi feature extractors (``compliance/kaldi.py``:
``spectrogram``, ``fbank``, ``mfcc``) with the JAX package, on the CPU.

Every configuration below goes through the JAX function (all of them in
one compiled program) and through the port on the same numpy clips.
Log-domain features are held to ``SCAN`` (1e-4 of the reference's peak);
gradients of ``fbank`` and ``mfcc`` to ``SCAN``.  Dither draws from a
``torch.Generator`` where the JAX package takes a key, so its draws differ:
it is held to its statistics, and both packages raise without a source of
randomness.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.compliance import kaldi as jk
from torchaudio_contrib_tpu_torch import compliance
from torchaudio_contrib_tpu_torch.compliance import kaldi as tk

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

SCAN = 1e-4

# name, function, keyword arguments
CASES = [
    ("spectrogram", "spectrogram", {}),
    ("spectrogram_hamming_no_pow2", "spectrogram",
     dict(window_type="hamming", round_to_power_of_two=False)),
    ("spectrogram_no_snip", "spectrogram", dict(snip_edges=False)),
    ("spectrogram_blackman_mean", "spectrogram",
     dict(window_type="blackman", subtract_mean=True, raw_energy=False)),
    ("fbank", "fbank", {}),
    ("fbank_energy_htk", "fbank",
     dict(use_energy=True, htk_compat=True, num_mel_bins=40)),
    ("fbank_energy_magnitude", "fbank",
     dict(use_energy=True, use_power=False, use_log_fbank=False,
          window_type="hanning")),
    ("fbank_vtln", "fbank", dict(vtln_warp=0.9, low_freq=60.0,
                                 high_freq=-400.0)),
    ("fbank_rect_no_dc", "fbank",
     dict(window_type="rectangular", remove_dc_offset=False,
          preemphasis_coefficient=0.0, energy_floor=0.0)),
    ("mfcc", "mfcc", {}),
    ("mfcc_htk_energy", "mfcc", dict(htk_compat=True, use_energy=True)),
    ("mfcc_htk_c0", "mfcc", dict(htk_compat=True, cepstral_lifter=0.0,
                                 num_ceps=20, num_mel_bins=30)),
    ("mfcc_no_snip_mean", "mfcc", dict(snip_edges=False, subtract_mean=True,
                                       frame_shift=12.5, vtln_warp=1.1)),
]


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


@pytest.fixture(scope="module")
def jax_refs():
    rng = np.random.default_rng(74)
    x = (0.3 * rng.standard_normal((2, 6000))).astype(np.float32)
    g = {n: rng.standard_normal((2, 36, 23 if n == "fbank" else 13))
         .astype(np.float32) for n in ("fbank", "mfcc")}

    def refs(xj):
        out = {name: getattr(jk, fn)(xj, **kw) for name, fn, kw in CASES}
        for n in ("fbank", "mfcc"):
            out["grad_" + n] = jax.grad(
                lambda w: jnp.sum(getattr(jk, n)(w) * g[n]))(xj)
        return out

    return x, g, jax.jit(refs)(jnp.asarray(x))


@pytest.mark.parametrize("name,fn,kw", CASES, ids=[c[0] for c in CASES])
def test_matches_jax(jax_refs, name, fn, kw):
    x, _, want = jax_refs
    got = getattr(tk, fn)(torch.from_numpy(x), **kw)
    assert got.dtype == torch.float32
    assert _rel(got, want[name]) <= SCAN


@pytest.mark.parametrize("fn", ["fbank", "mfcc"])
def test_gradient_matches_jax(jax_refs, fn):
    x, g, want = jax_refs
    t = torch.from_numpy(x.copy()).requires_grad_()
    (getattr(tk, fn)(t) * torch.from_numpy(g[fn])).sum().backward()
    assert _rel(t.grad, want["grad_" + fn]) <= SCAN


def test_helpers_match_jax():
    for wt in ("hanning", "hamming", "povey", "rectangular", "blackman"):
        np.testing.assert_array_equal(tk._window_vec(wt, 400, 0.42),
                                      jk._window_vec(wt, 400, 0.42))
    for n, snip in ((6000, True), (6000, False), (150, False)):
        m, idx = tk._frame_indices(n, 400, 160, snip)
        jm, jidx = jk._frame_indices(n, 400, 160, snip)
        assert m == jm
        np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(
        tk._mel_banks(23, 512, 16000.0, 20.0, 0.0, 100.0, -500.0, 0.9),
        jk._mel_banks(23, 512, 16000.0, 20.0, 0.0, 100.0, -500.0, 0.9))
    np.testing.assert_array_equal(tk._dct_matrix(13, 23),
                                  jk._dct_matrix(13, 23))


def test_short_clips_give_zero_frames():
    for fn, dim in (("spectrogram", 257), ("fbank", 24), ("mfcc", 13)):
        kw = {"use_energy": True} if fn == "fbank" else {}
        out = getattr(tk, fn)(torch.zeros(2, 100), **kw)
        assert out.shape == (2, 0, dim)
        want = getattr(jk, fn)(np.zeros((2, 100), np.float32), **kw)
        assert out.shape == want.shape
    assert tk.fbank(torch.zeros(8000), min_duration=1.0).shape == (0, 23)
    with pytest.raises(ValueError, match="frame_length"):
        tk.fbank(torch.zeros(10), frame_length=0.01)
    with pytest.raises(ValueError, match="num_ceps"):
        tk.mfcc(torch.zeros(8000), num_ceps=30)


def test_dither_takes_a_generator():
    """``dither`` draws from ``generator`` (the JAX package's ``key``): a
    seed repeats, and no generator raises, as no key does in JAX."""
    x = torch.zeros(1, 8000)
    a = tk.fbank(x, dither=1.0, generator=torch.Generator().manual_seed(3),
                 use_log_fbank=False)
    b = tk.fbank(x, dither=1.0, generator=torch.Generator().manual_seed(3),
                 use_log_fbank=False)
    assert torch.equal(a, b) and float(a.mean()) > 0
    with pytest.raises(ValueError, match="Generator"):
        tk.spectrogram(x, dither=1.0)
    with pytest.raises(ValueError, match="key"):
        jk.spectrogram(np.zeros((1, 8000), np.float32), dither=1.0)
    assert compliance.kaldi is tk
