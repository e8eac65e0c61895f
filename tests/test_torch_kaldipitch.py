"""Parity of the port's Kaldi pitch tracker (``ops/kaldipitch.py``) with the
JAX package, on the CPU.

The JAX references compile once (a module fixture) on 1 s clips at 16 kHz:
the NCCF column and its gradient are held to ``SCAN`` (1e-4 of the
reference's peak), the pitch column (the Viterbi states) exactly.  The
Viterbi itself is held to the float64 DP of ``tests/test_kaldi_pitch.py``
and to the JAX ``_viterbi``, ties included (both take the first index).
The properties of ``tests/test_kaldi_pitch.py`` (tone accuracy, voicing,
scale invariance, frame alignment, validation) run on the port's side.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.ops import kaldipitch as jkp
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import kaldipitch as tkp

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

SR = 16000
SCAN = 1e-4


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _tone(freq, seconds=1.0, sr=SR, amp=0.3):
    t = np.arange(int(sr * seconds)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _clips():
    """(3, 16000): a tone, a harmonic-rich tone, a 150 → 300 Hz switch."""
    t = np.arange(SR) / SR
    rich = sum((0.5 / k) * np.sin(2 * np.pi * k * 150.0 * t)
               for k in range(1, 5)).astype(np.float32)
    switch = np.concatenate([_tone(150.0, 0.5), _tone(300.0, 0.5)])
    return np.stack([_tone(220.0), rich, switch])


def _states(pitch):
    """The Viterbi state of each frame: the default lag grid's index of
    ``4000 / pitch`` (the two packages may round that quotient apart by
    one float32 ulp, so states are compared, not the quotients)."""
    hz = 4000.0 / jkp._lag_grid(10, 80, 0.005)
    return np.abs(np.asarray(pitch)[..., None] - hz).argmin(-1)


@pytest.fixture(scope="module")
def jax_refs():
    x = _clips()
    g = np.random.default_rng(73).standard_normal((3, 98)).astype(np.float32)

    def refs(xj):
        def nccf(w):
            out = jkp.compute_kaldi_pitch(w, SR)
            return jnp.sum(out[..., 0] * g), out

        (_, out), grad = jax.value_and_grad(nccf, has_aux=True)(xj)
        return {"out": out, "grad": grad,
                "no_snip": jkp.compute_kaldi_pitch(xj[:1], SR,
                                                   snip_edges=False)}

    return x, g, jax.jit(refs)(jnp.asarray(x))


def test_pitch_matches_jax(jax_refs):
    x, _, want = jax_refs
    got = tops.compute_kaldi_pitch(torch.from_numpy(x), SR)
    assert got.shape == (3, 98, 2) and got.dtype == torch.float32
    np.testing.assert_array_equal(_states(got[..., 1]),
                                  _states(want["out"][..., 1]))
    assert _rel(got[..., 1], want["out"][..., 1]) <= 1e-6
    assert _rel(got[..., 0], np.asarray(want["out"])[..., 0]) <= SCAN


def test_no_snip_edges_matches_jax(jax_refs):
    x, _, want = jax_refs
    got = tops.compute_kaldi_pitch(torch.from_numpy(x[:1]), SR,
                                   snip_edges=False)
    assert got.shape == (1, 100, 2)
    np.testing.assert_array_equal(_states(got[..., 1]),
                                  _states(want["no_snip"][..., 1]))
    assert _rel(got[..., 0], np.asarray(want["no_snip"])[..., 0]) <= SCAN


def test_nccf_gradient_matches_jax(jax_refs):
    x, g, want = jax_refs
    t = torch.from_numpy(x.copy()).requires_grad_()
    out = tops.compute_kaldi_pitch(t, SR)
    (out[..., 0] * torch.from_numpy(g)).sum().backward()
    assert _rel(t.grad, want["grad"]) <= SCAN


def _viterbi_oracle(local, trans):
    """The float64 DP of ``tests/test_kaldi_pitch.py::test_viterbi_oracle``
    (first index on ties, as ``argmin``)."""
    b_, t_, _ = local.shape
    out = np.zeros((b_, t_), np.int64)
    for b in range(b_):
        cost = local[b, 0].copy()
        bps = np.zeros(local.shape[1:], np.int64)
        for t in range(1, t_):
            total = cost[:, None] + trans
            bps[t] = total.argmin(axis=0)
            cost = total.min(axis=0) + local[b, t]
        out[b, -1] = cost.argmin()
        for t in range(t_ - 1, 0, -1):
            out[b, t - 1] = bps[t][out[b, t]]
    return out


@pytest.mark.parametrize("ties", [False, True])
def test_viterbi_matches_oracle_and_jax(ties):
    """Random costs make every frame's state distinct (a traceback off by
    one frame fails); small integer costs make ties everywhere, where both
    packages take the first index."""
    rng = np.random.default_rng(7)
    b, t, s = 3, 11, 6
    if ties:
        local = rng.integers(0, 3, (b, t, s)).astype(np.float64)
        trans = rng.integers(0, 2, (s, s)).astype(np.float64)
    else:
        local = rng.normal(size=(b, t, s))
        trans = np.abs(rng.normal(size=(s, s)))
    got = tkp._viterbi(torch.tensor(local, dtype=torch.float32),
                       torch.tensor(trans, dtype=torch.float32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _viterbi_oracle(local, trans))
    want = jax.jit(jkp._viterbi)(jnp.asarray(local, jnp.float32),
                                 jnp.asarray(trans, jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grid_and_matrices_match_jax():
    np.testing.assert_array_equal(tkp._lag_grid(10, 80, 0.005),
                                  jkp._lag_grid(10, 80, 0.005))
    grid = tkp._lag_grid(10, 80, 0.005)
    np.testing.assert_array_equal(tkp._interp_matrix(grid, 10, 80),
                                  jkp._interp_matrix(grid, 10, 80))
    np.testing.assert_array_equal(tkp._lowpass_taps(1000.0, 4000.0),
                                  jkp._lowpass_taps(1000.0, 4000.0))


@pytest.mark.parametrize("freq", [80.0, 120.0, 220.0, 330.0])
def test_tone_pitch_accuracy(freq):
    out = tops.compute_kaldi_pitch(torch.from_numpy(_tone(freq)), SR)
    interior = out[10:-10].numpy()
    assert abs(float(np.median(interior[:, 1])) - freq) / freq < 0.02
    assert float(np.median(interior[:, 0])) > 0.8


def test_voicing_scale_invariance_and_switch():
    x = _tone(180.0)
    a = tops.compute_kaldi_pitch(torch.from_numpy(x), SR).numpy()
    for scale in (1000.0, 1e-3):
        b = tops.compute_kaldi_pitch(torch.from_numpy(x * scale), SR)
        np.testing.assert_allclose(a, b.numpy(), atol=1e-4)
    noise = np.random.default_rng(0).normal(size=SR).astype(np.float32)
    n_nccf = np.median(tops.compute_kaldi_pitch(
        torch.from_numpy(noise), SR).numpy()[5:-5, 0])
    assert n_nccf < 0.5 and np.median(a[5:-5, 0]) > 0.9
    pitch = tops.compute_kaldi_pitch(torch.from_numpy(_clips()[2]),
                                     SR).numpy()[:, 1]
    switch = int(np.argmax(pitch > 220.0))
    assert 46 <= switch <= 52, switch


def test_pure_tone_track_moves_under_rounding():
    """Why pitch tracks are compared exactly only on harmonic clips across
    devices: a pure tone's NCCF peak is flat, so neighbouring lags of the
    grid nearly tie, and 1e-6 of noise moves some of its frames' states on
    the CPU alone.  Harmonics up to 900 Hz of an f0 on the grid sharpen the
    peak: the same noise moves none."""
    t = np.arange(4 * SR) / SR
    grid_hz = 4000.0 / tkp._lag_grid(10, 80, 0.005)
    f0 = grid_hz[np.abs(grid_hz - 190.0).argmin()]
    harm = sum(np.sin(2 * np.pi * k * f0 * t + 0.7 * k)
               for k in range(1, int(900 // f0) + 1))
    noise = np.stack([1e-3 * np.random.default_rng(s).standard_normal(t.size)
                      for s in range(2)])
    x = np.concatenate([0.3 * np.sin(2 * np.pi * 190.0 * t) + noise,
                        0.3 * harm / np.abs(harm).max() + noise])
    nudge = 1e-6 * np.random.default_rng(100).standard_normal(x.shape)
    a, b = (tops.compute_kaldi_pitch(torch.from_numpy(v.astype(np.float32)),
                                     SR)[..., 1] for v in (x, x + nudge))
    moved = (a != b).sum(dim=-1).tolist()
    assert moved[0] >= 1 and moved[1] >= 1, moved       # pure tones
    assert moved[2] == 0 and moved[3] == 0, moved       # harmonic clips


def test_validation_raises():
    x = torch.from_numpy(_tone(200.0))
    with pytest.raises(ValueError, match="min_f0"):
        tops.compute_kaldi_pitch(x, SR, min_f0=400.0, max_f0=100.0)
    with pytest.raises(ValueError, match="lowpass_cutoff"):
        tops.compute_kaldi_pitch(x, SR, lowpass_cutoff=3000.0)
    with pytest.raises(ValueError, match="lowpass_cutoff"):
        tops.compute_kaldi_pitch(x, SR, max_f0=1200.0)
    with pytest.raises(ValueError, match="too short"):
        tops.compute_kaldi_pitch(x[:64], SR)
