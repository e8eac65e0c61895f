"""DSP synthesis and filter-design primitives: oscillators, envelopes,
windowed-sinc and arbitrary-response FIRs, time-varying filtering.

Port of ``torchaudio_contrib_tpu/ops/dsp.py`` (torchaudio's
``prototype.functional`` DSP surface).  Everything is batched tensor
math; the time-varying filter is one grouped ``conv1d`` over the chunks
and an overlap-add of their tails.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from .stft import _overlap_add

__all__ = [
    "oscillator_bank", "adsr_envelope", "extend_pitch",
    "sinc_impulse_response", "frequency_impulse_response",
    "filter_waveform", "exp_sigmoid",
]


def exp_sigmoid(x: torch.Tensor, exponent: float = 10.0,
                max_value: float = 2.0,
                threshold: float = 1e-7) -> torch.Tensor:
    """``max_value · sigmoid(x)^log(exponent) + threshold``: the DDSP
    amplitude nonlinearity (smooth, positive, saturating)."""
    x = torch.as_tensor(x)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    return max_value * torch.sigmoid(x) ** math.log(exponent) + threshold


def oscillator_bank(frequencies: torch.Tensor, amplitudes: torch.Tensor,
                    sample_rate: float,
                    reduction: str = "sum") -> torch.Tensor:
    """Additive synthesis from instantaneous frequencies and amplitudes,
    both ``(..., time, n_oscillators)`` in Hz and linear gain.

    The phase is the running integral of ``f/sr`` in cycles, accumulated
    in float64 (``cumsum``) and wrapped to ``[0, 1)`` before the sine, as
    torchaudio does.  (The JAX package has no float64 on the TPU and
    instead sums three exactly representable component streams modulo 1;
    both stay within ~1e-7 cycles of the exact phase, so the two agree to
    about 1e-6 of the amplitude on clips of 10⁵ samples.)  Oscillators at
    or above Nyquist are muted, with a warning.  ``reduction`` is
    ``"sum"``, ``"mean"`` or ``"none"``.
    """
    frequencies = torch.as_tensor(frequencies)
    amplitudes = torch.as_tensor(amplitudes)
    if frequencies.shape != amplitudes.shape:
        raise ValueError("frequencies and amplitudes must match "
                         f"({tuple(frequencies.shape)} vs "
                         f"{tuple(amplitudes.shape)})")
    invalid = torch.abs(frequencies) >= sample_rate / 2.0
    if bool(invalid.any()):
        warnings.warn("oscillator frequencies at or above Nyquist are "
                      "muted", UserWarning, stacklevel=2)
    amplitudes = torch.where(invalid, torch.zeros_like(amplitudes),
                             amplitudes)
    cycles = torch.cumsum(frequencies.to(torch.float64) / sample_rate,
                          dim=-2)
    wrapped = cycles - torch.floor(cycles)
    out = amplitudes * torch.sin(2.0 * math.pi * wrapped).to(
        amplitudes.dtype)
    if reduction == "sum":
        return out.sum(dim=-1)
    if reduction == "mean":
        return out.mean(dim=-1)
    if reduction == "none":
        return out
    raise ValueError("reduction must be 'sum', 'mean' or 'none'")


def adsr_envelope(num_frames: int, attack: float = 0.0, hold: float = 0.0,
                  decay: float = 0.0, sustain: float = 1.0,
                  release: float = 0.0, n_decay: int = 2,
                  dtype: torch.dtype = torch.float32,
                  device=None) -> torch.Tensor:
    """Attack-hold-decay-sustain-release envelope over ``num_frames``:
    phase lengths are fractions of the whole (their sum at most 1), the
    decay leg a polynomial of order ``n_decay``, the rest at
    ``sustain``."""
    for name, v in (("attack", attack), ("hold", hold),
                    ("decay", decay), ("release", release)):
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"{name} must be in [0, 1]")
    if attack + hold + decay + release > 1.0 + 1e-9:
        raise ValueError("attack+hold+decay+release must be <= 1")
    t = np.linspace(0.0, 1.0, num_frames, dtype=np.float64)
    env = np.full(num_frames, float(sustain), np.float64)
    h_end = attack + hold
    d_end = h_end + decay
    if attack > 0:
        m = t < attack
        env[m] = t[m] / attack
    env[(t >= attack) & (t < h_end)] = 1.0
    if decay > 0:
        m = (t >= h_end) & (t < d_end)
        frac = (t[m] - h_end) / decay
        env[m] = sustain + (1.0 - sustain) * (1.0 - frac) ** n_decay
    if release > 0:
        m = t >= 1.0 - release
        env[m] = sustain * (1.0 - t[m]) / release
    return torch.as_tensor(env, dtype=dtype, device=device)


def extend_pitch(base: torch.Tensor,
                 pattern: Union[int, Sequence[float]]) -> torch.Tensor:
    """A fundamental series ``(..., time, 1)`` extended to harmonics
    ``(..., time, n)``: multiples ``1..n`` for an int, else the given
    multipliers."""
    base = torch.as_tensor(base)
    if isinstance(pattern, int):
        mult = torch.arange(1, pattern + 1, dtype=base.dtype,
                            device=base.device)
    else:
        mult = torch.as_tensor(pattern, dtype=base.dtype, device=base.device)
        if mult.ndim != 1:
            raise ValueError("pattern must be an int or 1-D")
    return base * mult


def sinc_impulse_response(cutoff: torch.Tensor, window_size: int = 513,
                          high_pass: bool = False) -> torch.Tensor:
    """Windowed-sinc FIR kernels ``(..., window_size)`` for cutoffs
    ``(...,)`` in [0, 1] of Nyquist: Hamming window, unit DC gain;
    ``high_pass=True`` inverts the spectrum (``window_size`` odd, so the
    delta lands on the centre tap)."""
    if window_size % 2 != 1:
        raise ValueError("window_size must be odd")
    cutoff = torch.as_tensor(cutoff)
    half = window_size // 2
    n = torch.arange(-half, half + 1, dtype=torch.float32,
                     device=cutoff.device)
    c = cutoff[..., None]
    ir = c * torch.sinc(c * n)
    ir = ir * torch.as_tensor(np.hamming(window_size), dtype=torch.float32,
                              device=cutoff.device)
    ir = ir / torch.clamp(ir.sum(-1, keepdim=True), min=1e-12)
    if high_pass:
        delta = torch.zeros(window_size, dtype=ir.dtype, device=ir.device)
        delta[half] = 1.0
        ir = delta - ir
    return ir


def frequency_impulse_response(magnitudes: torch.Tensor) -> torch.Tensor:
    """Linear-phase FIR for a onesided magnitude response ``(...,
    n_freqs)`` (bins ``linspace(0, Nyquist)``) → ``(..., 2·(n_freqs−1))``:
    zero-phase irFFT, rotated to causal, Hann-windowed."""
    mag = torch.as_tensor(magnitudes)
    if mag.ndim < 1 or mag.shape[-1] < 2:
        raise ValueError("magnitudes must have >= 2 frequency bins")
    ir = torch.fft.fftshift(torch.fft.irfft(mag.to(torch.float32), dim=-1),
                            dim=-1)
    return ir * torch.as_tensor(np.hanning(ir.shape[-1]), dtype=ir.dtype,
                                device=ir.device)


def filter_waveform(waveform: torch.Tensor, kernels: torch.Tensor,
                    delay_compensation: Optional[int] = None
                    ) -> torch.Tensor:
    """Time-varying FIR filtering: the clip ``(..., time)`` is cut into
    ``num_filters`` equal chunks (zero-padded up), each filtered by its own
    kernel of ``kernels (..., num_filters, K)`` (leading dims broadcast),
    the ``K − 1``-sample tails overlap-added into the next chunk.  The
    output is cropped to ``time`` after dropping ``K//2`` leading samples
    (or ``delay_compensation``)."""
    waveform = torch.as_tensor(waveform)
    kernels = torch.as_tensor(kernels)
    if kernels.ndim < 2:
        raise ValueError("kernels must be (..., num_filters, K)")
    t = waveform.shape[-1]
    f, k = kernels.shape[-2], kernels.shape[-1]
    chunk = -(-t // f)
    batch_shape = torch.broadcast_shapes(waveform.shape[:-1],
                                         kernels.shape[:-2])
    b = math.prod(batch_shape)
    x = waveform.expand(batch_shape + (t,)).reshape(b, t)
    x = F.pad(x.to(torch.float32), (0, chunk * f - t))
    kn = kernels.expand(batch_shape + (f, k)).reshape(b * f, 1, k)
    # every chunk's full convolution as one grouped conv: the (B·F) chunks
    # are channels, each with its own (flipped) kernel
    with torch.backends.cudnn.flags(allow_tf32=False):
        y = F.conv1d(x.reshape(1, b * f, chunk), kn.flip(-1).to(torch.float32),
                     padding=k - 1, groups=b * f)
    y = y.reshape(b, f, chunk + k - 1)
    # the tails carried into the next chunks: an overlap-add at hop chunk
    out = _overlap_add(y, chunk + k - 1, chunk, chunk * f + k - 1)
    delay = k // 2 if delay_compensation is None else int(delay_compensation)
    out = out[:, delay:delay + t]
    return out.reshape(batch_shape + (t,)) if batch_shape else out[0]
