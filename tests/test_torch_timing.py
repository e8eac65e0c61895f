"""The port's ``utils.timing`` against the JAX package's, on the CPU.

The same numpy input goes through the JAX ``device_loop(f, k=3)`` (under
``jax.jit``, at toy widths, no Pallas kernel) and the port's, whose CPU
path runs the ``k`` applications eagerly: the mel chain (the JAX
``melspectrogram`` + dB against the port's fused op, which takes its plain
chain on a CPU tensor) and ``ctc_beam_decode`` on (2, 20, 8), values to
1e-5 relative.  The timers return positive seconds; an input that is not a
CPU tensor asks for the card, and without one the call raises before
``f`` runs.  The launch counters' helper (``ops._launches``) moves them by
exactly the recorded delta.  The capture itself needs the card:
``tests/test_torch_cuda.py -k device_loop``.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from torchaudio_contrib_tpu import ops as jops
from torchaudio_contrib_tpu.utils import timing as jtiming
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import _launches
from torchaudio_contrib_tpu_torch.utils import (device_loop,
                                                time_device_loop,
                                                time_device_loop_p)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

REL = 1e-5
K = 3


def _loops(jf, tf, x):
    """(JAX loop value, the port's) of ``k = 3`` applications."""
    want = float(jtiming.device_loop(jf, K)(jnp.asarray(x)))
    got = device_loop(tf, K)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ()
    return float(got), want


def test_mel_chain_loop_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 2000)).astype(
        np.float32)
    fb = jops.create_mel_filter(16, 8000, 0.0, None, 129)
    tfb = torch.tensor(np.asarray(fb))

    def jf(v):
        mel = jops.melspectrogram(v, filterbank=fb, fft_length=256,
                                  hop_length=64, window="hann",
                                  center=False)
        return jops.amplitude_to_db(mel, power=2.0)

    got, want = _loops(jf, lambda v: tops.fused_melspectrogram(v, tfb, 256,
                                                               64), x)
    assert abs(got - want) <= REL * abs(want), (got, want)


def test_ctc_beam_loop_matches_jax():
    z = np.random.default_rng(1).standard_normal((2, 20, 8))
    lp = (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(np.float32)

    def jf(v):
        scores = jops.ctc_beam_decode(v, beam_width=4)[2]
        return jnp.where(jnp.isfinite(scores), scores, 0.0)

    def tf(v):
        scores = tops.ctc_beam_decode(v, beam_width=4)[2]
        return torch.where(torch.isfinite(scores), scores, 0.0)

    got, want = _loops(jf, tf, lp)
    assert abs(got - want) <= REL * abs(want), (got, want)


@pytest.mark.parametrize("with_params", [False, True])
def test_timers_return_positive_seconds(with_params):
    x = torch.ones(64)
    if with_params:
        s = time_device_loop_p(lambda p, v: v * p["w"],
                               {"w": torch.full((64,), 2.0)}, x, k=2, reps=2)
    else:
        s = time_device_loop(lambda v: v * 2.0, x, k=2, reps=2)
    assert isinstance(s, float) and s > 0.0


def test_input_off_the_cpu_without_a_card_raises():
    """A NumPy input asks for the card (the port's entry points run there
    unless the caller passes a CPU tensor): without one the call raises
    and ``f`` never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    calls = []

    def f(v):
        calls.append(1)
        return v

    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_loop(f, K)(np.ones(4, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        time_device_loop(f, np.ones(4, np.float32), k=K)
    assert not calls
    with pytest.raises(ValueError, match="k must be"):
        device_loop(f, 0)


def test_launch_counter_helper_adds_the_recorded_delta(monkeypatch):
    from torchaudio_contrib_tpu_torch.ops import fused, fused_griffinlim
    for module, names in _launches._COUNTERS.items():
        for name in names:          # restored after the test
            monkeypatch.setattr(module, name, getattr(module, name))
    before = _launches.counts()
    assert len(before) == 14    # 12 host counters, the card's 2
    fused.KERNEL_LAUNCHES += 2
    fused.BWD_FFT_LAUNCHES += 1
    fused_griffinlim.GL_FFT_LAUNCHES += 5
    moves = _launches.delta(before)
    assert moves == {k: {"fused.KERNEL_LAUNCHES": 2,
                         "fused.BWD_FFT_LAUNCHES": 1,
                         "fused_griffinlim.GL_FFT_LAUNCHES": 5}.get(k, 0)
                     for k in before}
    _launches.add(moves, -1)
    assert _launches.counts() == before
    _launches.add(moves, 3)
    assert _launches.delta(before) == {k: 3 * v for k, v in moves.items()}
