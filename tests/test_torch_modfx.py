"""Parity of the port's modulation effects (``ops/modfx.py``: overdrive,
contrast, phaser, flanger) with the JAX package and with the float64 loop
oracles of ``tests/test_modfx.py``, on the CPU.

The same numpy input goes through the JAX effects, compiled once in a
module fixture (each scan costs its compile), and through the port;
values to ``F32`` (1e-5 of the reference's peak), gradients to ``SCAN``
(1e-4).  The loop oracles pin both paths the port adds: pointer jumping
for the phaser's strong decay and the blocks of the flanger's feedback.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.ops import modfx as jfx
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import modfx as tfx
from test_modfx import (_flanger_oracle, _overdrive_oracle, _phaser_oracle,
                        _sig)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

F32 = 1e-5
SCAN = 1e-4
SR = 8000


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


# name, function of (module, x), input shape: both packages' effects
CASES = [
    ("overdrive", lambda m, x: m.overdrive(x, 25.0, 30.0), (2, 3000)),
    ("contrast", lambda m, x: m.contrast(x, 75.0), (2, 2048)),
    ("contrast_0", lambda m, x: m.contrast(x, 0.0), (2048,)),
    ("phaser_sine", lambda m, x: m.phaser(x, SR), (2, 6000)),
    ("phaser_triangle", lambda m, x: m.phaser(x, SR, sinusoidal=False),
     (2, 6000)),
    ("phaser_decay_0.8", lambda m, x: m.phaser(x, SR, decay=0.8),
     (1, 4000)),
    ("phaser_decay_0.99", lambda m, x: m.phaser(x, SR, decay=0.99),
     (3, 2, 2000)),
    ("flanger_linear", lambda m, x: m.flanger(x, SR, delay=1.0, depth=2.0),
     (2, 5000)),
    ("flanger_quadratic", lambda m, x: m.flanger(
        x, SR, delay=1.0, depth=2.0, interpolation="quadratic"), (2, 5000)),
    ("flanger_mono", lambda m, x: m.flanger(x, SR, depth=2.0), (5000,)),
    ("flanger_feedback", lambda m, x: m.flanger(
        x, SR, delay=0.0, depth=2.0, regen=40.0, modulation="triangular"),
     (2, 3000)),
    ("flanger_feedback_quadratic", lambda m, x: m.flanger(
        x, SR, regen=-60.0, phase=50.0, interpolation="quadratic"),
     (2, 2, 2500)),
    ("flanger_feedback_95", lambda m, x: m.flanger(
        x, SR, delay=1.0, depth=2.0, regen=95.0), (2, 2500)),
    ("flanger_feedback_mono", lambda m, x: m.flanger(x, SR, regen=30.0),
     (2000,)),
]
GRADS = ["overdrive", "phaser_decay_0.99", "flanger_feedback"]


def _input(i, shape):
    return _sig(shape, seed=100 + i)


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX effect of CASES on its input, and the gradients of
    ``Σ effect(x)²`` for GRADS, from one compiled program."""
    cases = dict((n, (f, s)) for n, f, s in CASES)
    xs = {n: _input(i, s) for i, (n, _, s) in enumerate(CASES)}

    def refs(xj):
        out = {n: f(jfx, xj[n]) for n, f, _ in CASES}
        for n in GRADS:
            out["grad_" + n] = jax.grad(
                lambda w: jnp.sum(cases[n][0](jfx, w) ** 2))(xj[n])
        return out

    return xs, jax.jit(refs)({n: jnp.asarray(x) for n, x in xs.items()})


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_effect_matches_jax(jax_refs, name):
    fn = dict((n, f) for n, f, _ in CASES)[name]
    xs, want = jax_refs
    got = fn(tops, torch.from_numpy(xs[name]))
    assert got.dtype == torch.float32
    assert _rel(got, want[name]) <= F32


@pytest.mark.parametrize("name", GRADS)
def test_gradient_matches_jax(jax_refs, name):
    fn = dict((n, f) for n, f, _ in CASES)[name]
    xs, want = jax_refs
    t = torch.from_numpy(xs[name].copy()).requires_grad_()
    (fn(tops, t) ** 2).sum().backward()
    assert _rel(t.grad, want["grad_" + name]) <= SCAN


# ---- the float64 loop oracles, including the paths the port adds ----------

def test_overdrive_matches_loop_oracle():
    x = _sig((2, 3000), seed=1)
    got = tops.overdrive(torch.from_numpy(x), 25.0, 30.0).numpy()
    assert np.max(np.abs(got - _overdrive_oracle(x, 25.0, 30.0))) <= 2e-4


@pytest.mark.parametrize("decay,sinusoidal",
                         [(0.4, True), (0.4, False), (0.8, True),
                          (0.9, True), (0.99, True), (0.99, False)])
def test_phaser_matches_loop_oracle(decay, sinusoidal):
    """0.4 runs the unrolled gathers; 0.8 and up pointer jumping
    (``k_exact`` > 64), exact at decay 0.99 (~1600 feedback terms)."""
    x = _sig((2, 4000), seed=3)
    got = tops.phaser(torch.from_numpy(x), SR, decay=decay,
                      sinusoidal=sinusoidal).numpy()
    ref = _phaser_oracle(x, SR, 0.4, 0.74, 3.0, decay, 0.5, sinusoidal)
    assert np.max(np.abs(got - ref)) <= 1e-5


@pytest.mark.parametrize("regen,interpolation,modulation,delay", [
    (0.0, "linear", "sinusoidal", 1.0),
    (0.0, "quadratic", "sinusoidal", 1.0),
    (40.0, "linear", "triangular", 0.0),
    (40.0, "quadratic", "sinusoidal", 0.0),
    (-70.0, "linear", "sinusoidal", 0.5),
    (95.0, "linear", "sinusoidal", 1.0),
])
def test_flanger_matches_loop_oracle(regen, interpolation, modulation,
                                     delay):
    x = _sig((2, 3000), seed=6)
    got = tops.flanger(torch.from_numpy(x), SR, delay=delay, depth=2.0,
                       regen=regen, modulation=modulation,
                       interpolation=interpolation).numpy()
    ref = _flanger_oracle(x, SR, delay, 2.0, regen, 71.0, 0.5, modulation,
                          interpolation)
    assert np.max(np.abs(got - ref)) <= 1e-5


def test_pointer_jumping_rounds_are_log_depth():
    t = 44100
    lag = np.ones(t, np.int64)              # one chain through every sample
    rounds = tfx._pointer_jumps(lag, 0.9)
    assert len(rounds) == math.ceil(math.log2(t))


def test_flanger_blocks_read_only_earlier_blocks():
    """Every tap of every sample in a block reads a sample written before
    the block starts, and the blocks tile time."""
    taps, _, buf_len = tfx._flanger_taps(2, 20000, 8000, 0.0, 2.0, 71.0,
                                         0.5, 25.0, "sinusoidal",
                                         "quadratic")
    starts = tfx._flanger_blocks(taps, buf_len)
    assert starts[0] == 0 and starts[-1] == 20000
    assert (np.diff(starts) >= 1).all()
    eff = taps % buf_len
    eff = np.where(eff == 0, buf_len, eff)
    block_start = starts[np.searchsorted(starts, np.arange(20000),
                                         "right") - 1]
    assert (np.arange(20000) - eff < block_start).all()
    # and each block is as long as that allows: the next sample reads
    # into the block
    nxt = starts[1:-1]
    assert (nxt - eff.reshape(-1, 20000).min(0)[nxt]
            >= starts[:-2]).all()


def test_wave_table_matches_jax():
    for kind in ("sine", "triangle"):
        for as_int in (True, False):
            np.testing.assert_array_equal(
                tfx._wave_table(kind, 100, 1.0, 64.0, math.pi / 2, as_int),
                jfx._wave_table(kind, 100, 1.0, 64.0, math.pi / 2, as_int))
    with pytest.raises(ValueError):
        tfx._wave_table("square", 10, 0, 1, 0.0, as_int=False)


def test_effects_validate():
    x = torch.zeros((1, 100))
    with pytest.raises(ValueError):
        tops.contrast(x, 150.0)
    with pytest.raises(ValueError):
        tops.phaser(x, SR, decay=0.0)
    with pytest.raises(ValueError):
        tops.phaser(x, SR, delay_ms=0.0)
    for kw in (dict(delay=40.0), dict(regen=99.0), dict(depth=11.0),
               dict(width=101.0), dict(phase=150.0),
               dict(modulation="square"), dict(interpolation="cubic")):
        with pytest.raises(ValueError):
            tops.flanger(x, SR, **kw)


def test_flanger_channel_phase():
    """phase=0 keeps the channels' LFOs identical (and equal to mono);
    phase=50 decorrelates them."""
    x1 = _sig((5000,), seed=9)
    x = torch.from_numpy(np.stack([x1, x1]))
    same = tops.flanger(x, SR, depth=2.0, phase=0.0)
    assert torch.equal(same[0], same[1])
    mono = tops.flanger(torch.from_numpy(x1), SR, depth=2.0)
    assert (same[0] - mono).abs().max() <= 1e-7
    shifted = tops.flanger(x, SR, depth=2.0, phase=50.0)
    assert (shifted[0] - shifted[1]).abs().max() > 1e-4
