"""Nonlinear and modulation effects: overdrive, contrast, phaser, flanger.

Port of ``torchaudio_contrib_tpu/ops/modfx.py`` (the SoX-derived effects
torchaudio ships).  Every lag these effects read is fixed by their
parameters, never by the data, so the index arithmetic is done once on the
host in NumPy and the card runs gathers and multiply-adds:

* ``overdrive``: an elementwise waveshaper, then the DC blocker ``y[n] =
  x[n] − x[n−1] + 0.995·y[n−1]``, an order-1 :func:`~.iir.lfilter`.
* ``contrast``: one elementwise expression.
* ``phaser``: ``temp[i] = g_in·x[i] + decay·temp[i − lag[i]]``.  For weak
  feedback the series is unrolled into at most 64 gathers along host-built
  index chains (the JAX package's formulation).  For strong feedback
  (``decay`` ≳ 0.78) the JAX package runs a per-sample ``lax.scan``; here
  each sample depends on exactly one earlier sample, so the recurrence is
  a forest and pointer jumping solves it exactly: ``val += w·val[ptr]``,
  ``w ← w·w[ptr]``, ``ptr ← ptr[ptr]``, ``⌈log2 T⌉`` rounds of one gather
  (``ptr`` and ``w`` hang on the lags only, so they are host arrays).
* ``flanger``: without feedback, two or three gathers blended by the
  fractional delay.  With feedback the interpolated taps make the
  recurrence a DAG, and the shortest lag is 1 at the LFO's trough, so time
  is split on the host into blocks ``[s, e)`` in which every tap of every
  channel reads only samples before ``s``; each block is one gather and a
  multiply-add over ``(B, C, block)``, with the taps summed in the
  per-sample loop's order.  :func:`_flanger_blocks` gives their count.

Semantics are those of the float64 loop oracles in ``tests/test_modfx.py``.
Time is last, with any leading dims; everything is differentiable.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import iir
from .features import _float
from .stft import _on

__all__ = ["overdrive", "contrast", "phaser", "flanger"]


def overdrive(waveform: torch.Tensor, gain: float = 20.0,
              colour: float = 20.0) -> torch.Tensor:
    """SoX-style overdrive: cubic soft clip + DC-blocking filter.

    ``gain`` is the drive in dB; ``colour`` adds an asymmetric offset
    (even harmonics).  Output mixes dry and shaped signal 0.5/0.75 and
    clips to [-1, 1], per the SoX definition.
    """
    waveform = _float(waveform)
    g = 10.0 ** (gain / 20.0)
    c = colour / 200.0
    temp = waveform * g + c
    shaped = torch.where(
        temp < -1.0, -2.0 / 3.0,
        torch.where(temp > 1.0, 2.0 / 3.0, temp - temp ** 3 / 3.0))
    # y[n] = x[n] - x[n-1] + 0.995 y[n-1]  (zero initial state)
    blocked = iir.lfilter(shaped, (1.0, -0.995), (1.0, -1.0))
    return torch.clamp(waveform * 0.5 + blocked * 0.75, -1.0, 1.0)


def contrast(waveform: torch.Tensor,
             enhancement_amount: float = 75.0) -> torch.Tensor:
    """SoX contrast enhancement (a compressed-sounding waveshape).

    ``enhancement_amount`` ∈ [0, 100]; 0 still applies a plain
    ``sin(x·π/2)`` shape, matching SoX.
    """
    if not 0.0 <= enhancement_amount <= 100.0:
        raise ValueError("enhancement_amount must be in [0, 100]")
    waveform = _float(waveform)
    amount = enhancement_amount / 750.0
    t1 = waveform * (math.pi / 2.0)
    return torch.sin(t1 + amount * torch.sin(t1 * 4.0))


def _wave_table(wave_type: str, table_size: int, lo: float, hi: float,
                phase: float, as_int: bool) -> np.ndarray:
    """SoX periodic modulation table (float64 NumPy, built once).

    ``phase`` is in radians of the table period.  ``as_int`` rounds to
    nearest integer (SoX's INT tables, used for integer delay taps).
    """
    offset = int(phase / (2.0 * math.pi) * table_size + 0.5)
    point = (np.arange(table_size) + offset) % table_size
    p = point.astype(np.float64) / table_size
    if wave_type == "sine":
        d = (np.sin(p * 2.0 * math.pi) + 1.0) / 2.0
    elif wave_type == "triangle":
        # starts at 0.5 rising: /\ over one period
        d = np.where(p < 0.25, 0.5 + 2.0 * p,
                     np.where(p < 0.75, 1.5 - 2.0 * p, 2.0 * p - 1.5))
    else:
        raise ValueError(
            f"unknown wave type {wave_type!r}; expected sine|triangle")
    d = d * (hi - lo) + lo
    if as_int:
        d = np.floor(d + 0.5)
    return d


def _phaser_lags(t: int, sample_rate: float, delay_ms: float,
                 mod_speed: float, sinusoidal: bool) -> np.ndarray:
    """The lag each of ``t`` samples reads back (``[1, d]``)."""
    d = int(delay_ms * 0.001 * sample_rate + 0.5)
    if d < 1:
        raise ValueError("delay_ms too small: delay buffer is empty")
    m = int(sample_rate / mod_speed + 0.5)
    mod = _wave_table("sine" if sinusoidal else "triangle", m,
                      1.0, float(d), math.pi / 2.0, as_int=True)
    # write pos advances 1/step, read pos = write-1 + mod  ⇒  the read
    # tap is the value written lag = d + 1 - mod[i % m] steps earlier
    return (d + 1 - mod[np.arange(t) % m]).astype(np.int64)


def _pointer_jumps(lag: np.ndarray, decay: float):
    """Host plan of the pointer jumping that solves ``temp[i] = val[i] +
    decay·temp[i − lag[i]]``: per round, the pointer (``t`` = the zero
    sentinel) and the weight of what it points at.  The rounds stop when
    every chain has reached the sentinel: ``⌈log2 T⌉`` at most."""
    t = lag.shape[0]
    src = np.arange(t) - lag
    ptr = np.append(np.where(src >= 0, src, t), t)
    w = np.append(np.where(src >= 0, decay, 0.0), 0.0)
    rounds = []
    while (ptr[:t] != t).any():
        rounds.append((ptr.copy(), w.copy()))
        w = w * w[ptr]
        ptr = ptr[ptr]
    return rounds


@functools.lru_cache(maxsize=8)
def _phaser_plan(t: int, sample_rate: float, delay_ms: float,
                 mod_speed: float, sinusoidal: bool, decay: float,
                 gain_in: float):
    """``(jump, index (R, ·), weight (R, ·))``, built once per setting:
    the pointer-jumping rounds (``jump``; ``t + 1`` wide, the last the
    zero sentinel), or the unrolled chain's gathers, their weight
    ``gain_in·decay^k`` where the chain is alive and 0 where it fell
    off."""
    lag = _phaser_lags(t, sample_rate, delay_ms, mod_speed, sinusoidal)
    k_exact = max(int(math.ceil(math.log(1e-7) / math.log(decay))), 1)
    if k_exact > 64:
        rounds = _pointer_jumps(lag, decay)
        return (True, np.stack([p for p, _ in rounds]).reshape(-1, t + 1),
                np.stack([w for _, w in rounds]).reshape(-1, t + 1))
    # follow the index chains on host: chain_0 = identity,
    # chain_{k+1}[i] = chain_k[i] - lag[chain_k[i]]  (−1 = fell off)
    idx = np.arange(t)
    alive = np.ones(t, bool)
    w = gain_in
    index, weight = [], []
    for _ in range(1, k_exact):
        nxt = idx - lag[np.clip(idx, 0, t - 1)]
        alive = alive & (nxt >= 0)
        if not alive.any():
            break
        idx = np.where(alive, nxt, 0)
        w *= decay
        index.append(idx)
        weight.append(np.where(alive, w, 0.0))
    return (False, np.asarray(index, np.int64).reshape(-1, t),
            np.asarray(weight, np.float64).reshape(-1, t))


def _phaser_index(*key) -> np.ndarray:
    return _phaser_plan(*key)[1]


def _phaser_weight(*key) -> np.ndarray:
    return _phaser_plan(*key)[2]


def phaser(waveform: torch.Tensor, sample_rate: float,
           gain_in: float = 0.4, gain_out: float = 0.74,
           delay_ms: float = 3.0, decay: float = 0.4,
           mod_speed: float = 0.5,
           sinusoidal: bool = True) -> torch.Tensor:
    """SoX phaser: modulated feedback delay line, fully parallelized.

    The recurrence ``temp[i] = gain_in·x[i] + decay·temp[i − lag[i]]``
    has data-independent lags (the modulation table is periodic), so it
    is unrolled into ``K = ⌈log(1e-7)/log(decay)⌉`` exact gather terms
    (module docstring) — the truncated tail is below float32
    resolution.  For strong feedback (``decay`` ≳ 0.78) K exceeds 64, and
    the recurrence is solved instead by pointer jumping, ``⌈log2 T⌉``
    rounds of one gather — exact at every permitted ``decay``.
    ``decay`` must be in (0, 0.99].  The host plan and its tensors on the
    device are built once per setting and length (``stft._on``).
    """
    if not 0.0 < decay <= 0.99:
        raise ValueError("decay must be in (0, 0.99]")
    waveform = _float(waveform)
    t = waveform.shape[-1]
    key = (t, float(sample_rate), float(delay_ms), float(mod_speed),
           bool(sinusoidal), float(decay), float(gain_in))
    jump = _phaser_plan(*key)[0]
    dev = waveform.device
    index = _on(dev, torch.int32, _phaser_index, *key)
    weight = _on(dev, waveform.dtype, _phaser_weight, *key)

    if jump:
        # strong decay: pointer jumping over a zero sentinel at index t
        val = torch.cat([waveform * gain_in,
                         waveform.new_zeros(waveform.shape[:-1] + (1,))],
                        dim=-1)
        for ptr, w in zip(index, weight):
            val = val + w * val.index_select(-1, ptr)
        return val[..., :t] * gain_out

    out = waveform * gain_in
    for idx, w in zip(index, weight):
        out = out + w * waveform.index_select(-1, idx)
    return out * gain_out


def _flanger_taps(n_ch: int, t: int, sample_rate: float, delay: float,
                  depth: float, width: float, speed: float, phase: float,
                  modulation: str, interpolation: str):
    """Host tap plan: lags ``(taps, C, t)`` (lag 0 already replaced by
    ``buf_len``), their weights and the ring buffer's length."""
    buf_len = int((delay + depth) * 0.001 * sample_rate + 0.5) + 2
    lfo_len = max(int(sample_rate / speed + 0.5), 1)
    lo = math.floor(delay * 0.001 * sample_rate + 0.5)
    hi = buf_len - 2.0
    lfo = _wave_table(
        "sine" if modulation == "sinusoidal" else "triangle",
        lfo_len, lo, hi, 3.0 * math.pi / 2.0, as_int=False)
    offs = np.round(phase / 100.0 * lfo_len
                    * np.arange(n_ch) / n_ch).astype(np.int64)
    dly = lfo[(np.arange(t)[None, :] + offs[:, None]) % lfo_len]
    int_d = np.floor(dly).astype(np.int64)     # (C, t)
    frac = dly - int_d

    # read taps are the buffer slots written int_d (+1) steps earlier;
    # a lag beyond the write history wraps to the stale slot (zero for
    # the first buf_len steps — matches the zero-initialized SoX buffer)
    if interpolation == "linear":
        tap_lags = np.stack([int_d, int_d + 1])           # (2, C, t)
        tap_w = np.stack([1.0 - frac, frac])
    else:
        # SoX quadratic: Lagrange-style 3-tap around the integer delay
        tap_lags = np.stack([int_d, int_d + 1, int_d + 2])
        w0 = (frac - 1.0) * (frac - 2.0) / 2.0
        w1 = -frac * (frac - 2.0)
        w2 = frac * (frac - 1.0) / 2.0
        tap_w = np.stack([w0, w1, w2])
    # a lag of 0 reads the slot about to be overwritten → stale value
    # written buf_len steps ago (SoX ring-buffer wrap)
    tap_lags = np.where(tap_lags == 0, buf_len, tap_lags)
    return tap_lags, tap_w, buf_len


def _flanger_blocks(tap_lags: np.ndarray, buf_len: int) -> np.ndarray:
    """Block starts (and the end) of the feedback path: a block ``[s, e)``
    holds samples whose every tap, in every channel, reads a sample
    written before ``s``.  The lags read are ``lag % buf_len`` with 0 →
    ``buf_len`` (the ring's wrap), so the shortest is at least 1.

    ``reach[i] = i − (shortest lag at i)`` is the latest sample ``i``
    reads; ``reach[j] < s`` for every ``j ≤ s``, so the first sample after
    ``s`` that reads ``s`` or later is where the running maximum of
    ``reach`` first reaches ``s``: one binary search a block."""
    t = tap_lags.shape[-1]
    eff = tap_lags % buf_len
    eff = np.where(eff == 0, buf_len, eff)
    reach = np.maximum.accumulate(
        np.arange(t) - eff.reshape(-1, t).min(0))
    starts = [0]
    while starts[-1] < t:
        starts.append(int(np.searchsorted(reach, starts[-1], "left")))
    return np.asarray(starts, np.int64)


@functools.lru_cache(maxsize=8)
def _flanger_plan(n_ch: int, t: int, sample_rate: float, delay: float,
                  depth: float, width: float, speed: float, phase: float,
                  modulation: str, interpolation: str, feedback: bool):
    """Host plan, built once per setting and shape: ``(index, weight,
    blocks)``.  Without feedback, each tap's source sample ``(taps, C,
    t)`` and its weight (0 before the signal starts).  With feedback, the
    flat indices into the written signal ``(B, C·(t + 1))`` (slot ``t`` of
    a row is a zero) and their weights, laid out block after block as
    ``(taps, C, block)`` runs, and per block ``(start, end, offset,
    length)`` of its run."""
    tap_lags, tap_w, buf_len = _flanger_taps(
        n_ch, t, sample_rate, delay, depth, width, speed, phase,
        modulation, interpolation)
    steps = np.arange(t)
    if not feedback:
        src = steps - tap_lags
        valid = src >= 0
        return np.where(valid, src, 0), tap_w * valid, ()
    n_taps = tap_lags.shape[0]
    eff = tap_lags % buf_len
    eff = np.where(eff == 0, buf_len, eff)
    src = steps - eff                               # (taps, C, t)
    row = np.arange(n_ch)[None, :, None] * (t + 1)
    gidx = np.where(src >= 0, src, t) + row
    starts = _flanger_blocks(tap_lags, buf_len)
    blk = np.searchsorted(starts, steps, "right") - 1
    s_b, n_b = starts[blk], starts[blk + 1] - starts[blk]
    lane = np.arange(n_taps * n_ch).reshape(n_taps, n_ch, 1)
    pos = (n_taps * n_ch * s_b + lane * n_b + (steps - s_b)).reshape(-1)
    index = np.empty(gidx.size, np.int64)
    weight = np.empty(gidx.size, np.float64)
    index[pos] = gidx.reshape(-1)
    weight[pos] = tap_w.reshape(-1)
    blocks = tuple((int(s), int(e), n_taps * n_ch * int(s),
                    n_taps * n_ch * int(e - s))
                   for s, e in zip(starts[:-1], starts[1:]))
    return index, weight, blocks


def _flanger_index(*key) -> np.ndarray:
    return _flanger_plan(*key)[0]


def _flanger_weight(*key) -> np.ndarray:
    return _flanger_plan(*key)[1]


def flanger(waveform: torch.Tensor, sample_rate: float,
            delay: float = 0.0, depth: float = 2.0, regen: float = 0.0,
            width: float = 71.0, speed: float = 0.5,
            phase: float = 25.0,
            modulation: str = "sinusoidal",
            interpolation: str = "linear") -> torch.Tensor:
    """SoX flanger: time-varying fractional delay with optional feedback.

    ``delay``/``depth`` in ms (ranges [0, 30]/[0, 10]), ``regen`` is
    feedback % in [-95, 95], ``width`` the wet mix %, ``speed`` the
    modulation rate in Hz, ``phase`` the per-channel LFO phase shift %
    in [0, 100] (channel ``c`` of ``C`` — the second-to-last axis —
    gets an LFO offset of ``phase/100 · lfo_len · c/C``; SoX man-page
    convention).  ``interpolation`` ∈ linear|quadratic.

    Gain balance follows SoX: ``in = 1/(1+w)``, ``wet = w/(1+w) ·
    (1 − |regen/100|)`` with the RAW ``regen/100`` as the feedback
    coefficient (the loop-balance step scales only the wet mix).

    ``regen == 0`` (default) runs the parallel gather path; feedback runs
    one gather and multiply-add per host-computed block (module
    docstring).
    """
    if not 0.0 <= delay <= 30.0:
        raise ValueError("delay must be in [0, 30] ms")
    if not 0.0 <= depth <= 10.0:
        raise ValueError("depth must be in [0, 10] ms")
    if not -95.0 <= regen <= 95.0:
        raise ValueError("regen must be in [-95, 95]")
    if not 0.0 <= width <= 100.0:
        raise ValueError("width must be in [0, 100]")
    if not 0.0 <= phase <= 100.0:
        raise ValueError("phase must be in [0, 100]")
    if modulation not in ("sinusoidal", "triangular"):
        raise ValueError("modulation must be sinusoidal|triangular")
    if interpolation not in ("linear", "quadratic"):
        raise ValueError("interpolation must be linear|quadratic")
    waveform = _float(waveform)
    t = waveform.shape[-1]
    n_ch = waveform.shape[-2] if waveform.ndim >= 2 else 1
    dev, dt = waveform.device, waveform.dtype

    delay_gain = width / 100.0
    in_gain = 1.0 / (1.0 + delay_gain)
    delay_gain = delay_gain / (1.0 + delay_gain)
    fb_gain = regen / 100.0
    delay_gain *= 1.0 - abs(fb_gain)       # SoX feedback-loop balance

    key = (n_ch, t, float(sample_rate), float(delay), float(depth),
           float(width), float(speed), float(phase), modulation,
           interpolation, fb_gain != 0.0)
    index = _on(dev, torch.int64, _flanger_index, *key)
    weight = _on(dev, dt, _flanger_weight, *key)

    if fb_gain == 0.0:
        out = waveform * in_gain
        wet = torch.zeros_like(waveform)
        for idx, wv in zip(index, weight):     # (C, t) each
            if waveform.ndim == 1:
                gathered = waveform.index_select(-1, idx[0])
                wet = wet + wv[0] * gathered
            else:
                gathered = torch.gather(waveform, -1,
                                        idx.expand(waveform.shape))
                wet = wet + wv * gathered
        return out + delay_gain * wet

    # feedback path: written[i] = x[i] + fb·wet[i], wet[i] = Σ_tap
    # w·written[i − lag], blocks of samples that read only earlier blocks
    lead = waveform.shape[:-1]
    flat = waveform.reshape((-1, n_ch, t))
    b = flat.shape[0]
    n_taps = index.shape[0] // (n_ch * t)
    written = flat.new_zeros((b, n_ch, t + 1))
    rows = written.view(b, -1)
    wets = []
    for s, e, off, n in _flanger_plan(*key)[2]:
        taps = rows.index_select(1, index[off:off + n]).view(
            b, n_taps, n_ch, e - s) * weight[off:off + n].view(
                n_taps, n_ch, e - s)
        wet = taps[:, 0]
        for k in range(1, n_taps):
            wet = wet + taps[:, k]
        written[..., s:e] = flat[..., s:e] + wet * fb_gain
        wets.append(wet)
    wet = torch.cat(wets, dim=-1)
    return (flat * in_gain + wet * delay_gain).reshape(lead + (t,))
