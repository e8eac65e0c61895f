"""Perceptual loudness: ITU-R BS.1770-4 integrated loudness + A-weighting.

Port of ``torchaudio_contrib_tpu/ops/loudness.py`` (torchaudio's
``loudness``; librosa's ``A_weighting``).  The K-weighting pre-filter
(high-shelf + high-pass) is two :func:`~.iir.lfilter` biquads, the
doubling scan; gating blocks (400 ms, 75 % overlap) are framed by
:func:`~.stft.frame_signal` and reduced with one mean; the BS.1770 gates
(absolute −70 LKFS, relative −10 LU) are masked means, so the shapes do
not depend on the data.

Coefficient formulas for arbitrary sample rates follow the standard
bilinear-transform re-derivation of the 48 kHz reference filters
(the pyloudnorm/Brecht-De-Man parameterization).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .features import _float
from .iir import lfilter
from .stft import frame_signal

__all__ = ["loudness", "a_weighting"]


def _k_weighting_coeffs(sample_rate: float):
    """(b, a) for the two BS.1770 pre-filter stages at ``sample_rate``."""
    # stage 1: spherical-head high shelf (+~4 dB above ~1.5 kHz)
    f0, G, Q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    K = math.tan(math.pi * f0 / sample_rate)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    d = 1.0 + K / Q + K * K
    b1 = ((Vh + Vb * K / Q + K * K) / d,
          2.0 * (K * K - Vh) / d,
          (Vh - Vb * K / Q + K * K) / d)
    a1 = (1.0, 2.0 * (K * K - 1.0) / d, (1.0 - K / Q + K * K) / d)

    # stage 2: high-pass (rolls off below ~38 Hz)
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = math.tan(math.pi * f0 / sample_rate)
    d = 1.0 + K / Q + K * K
    # the ITU table publishes b UNNORMALIZED ([1, −2, 1] with a already
    # divided by d) — the stage has a deliberate ~d gain at Nyquist;
    # keep that to match the standard's coefficients exactly
    b2 = (1.0, -2.0, 1.0)
    a2 = (1.0, 2.0 * (K * K - 1.0) / d, (1.0 - K / Q + K * K) / d)
    return (b1, a1), (b2, a2)


def loudness(waveform: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Integrated (gated) loudness in LKFS per BS.1770-4.

    ``waveform`` is ``(..., channel, time)``; returns ``(...,)`` — one
    loudness per item, summing channel energies with the standard
    G weights (1.0 for the first three channels, 1.41 for surrounds).
    Clips shorter than one 400 ms gating block raise.
    """
    if waveform.ndim < 2:
        raise ValueError("loudness expects (..., channel, time)")
    waveform = _float(waveform)
    (b1, a1), (b2, a2) = _k_weighting_coeffs(sample_rate)
    y = lfilter(lfilter(waveform, a1, b1), a2, b2)

    block = int(round(0.4 * sample_rate))         # 400 ms
    hop = block // 4                              # 75 % overlap
    t = y.shape[-1]
    if t < block:
        raise ValueError(
            f"clip too short for loudness: {t} samples < one 400 ms "
            f"gating block ({block})")
    frames = frame_signal(y, block, hop)          # (…, ch, n_blocks, block)
    z = torch.mean(frames * frames, dim=-1)

    nch = z.shape[-2]
    g = np.ones(nch)
    g[3:] = 1.41                                  # surround weighting
    zw = (z * torch.tensor(g, dtype=z.dtype, device=z.device)[:, None]
          ).sum(dim=-2)

    # block loudness, absolute gate at −70 LKFS
    lb = -0.691 + 10.0 * torch.log10(torch.clamp(zw, min=1e-30))
    m_abs = lb > -70.0

    def _gated_mean(z_, m):
        cnt = torch.clamp(m.sum(dim=-1), min=1)
        return torch.where(m, z_, 0.0).sum(dim=-1) / cnt

    # relative gate: −10 LU under the abs-gated mean loudness
    rel_thresh = (-0.691 + 10.0 * torch.log10(
        torch.clamp(_gated_mean(zw, m_abs), min=1e-30))) - 10.0
    m_rel = m_abs & (lb > rel_thresh[..., None])
    return -0.691 + 10.0 * torch.log10(
        torch.clamp(_gated_mean(zw, m_rel), min=1e-30))


def a_weighting(frequencies, min_db: float | None = -80.0) -> torch.Tensor:
    """IEC 61672:2003 A-weighting of ``frequencies`` (Hz), in dB.

    Returns the gain to ADD to a dB-scaled spectrogram (0 dB at 1 kHz).
    ``min_db`` clamps the low-frequency tail (None = no clamp) —
    librosa-compatible semantics.  Use with the bin frequencies of an
    STFT (``linspace(0, sr/2, n_freqs)``) to perceptually weight
    spectrogram bins.  A tensor input keeps its device; other input goes
    to the card (``"cuda"``).
    """
    if isinstance(frequencies, torch.Tensor):
        f = frequencies.to(torch.float32)
    else:
        f = torch.as_tensor(np.asarray(frequencies, np.float32),
                            device="cuda")
    f2 = f * f
    const = torch.tensor([12194.217, 20.598997, 107.65265, 737.86223],
                         dtype=torch.float32, device=f.device) ** 2.0
    num = const[0] * f2 * f2
    den = ((f2 + const[0]) * (f2 + const[1])
           * torch.sqrt((f2 + const[2]) * (f2 + const[3])))
    w = 2.0 + 20.0 * torch.log10(torch.clamp(
        num / torch.clamp(den, min=1e-30), min=1e-30))
    if min_db is not None:
        w = torch.clamp(w, min=min_db)
    return w
