"""Kaldi-compatible feature extraction (spectrogram / fbank / mfcc).

Port of ``torchaudio_contrib_tpu/compliance/kaldi.py`` (torchaudio's
``compliance.kaldi``): features with the semantics of Kaldi's
``compute-spectrogram-feats`` / ``compute-fbank-feats`` /
``compute-mfcc-feats`` (povey window, snip_edges framing, per-frame DC
removal + pre-emphasis, raw log-energy, power-of-two FFT padding,
Kaldi-style mel banks built in the MEL domain, orthonormal DCT + cepstral
liftering).

One tensor pipeline over a ``(num_frames, window)`` frame matrix: a
gather with host-built indices, per-frame elementwise preprocessing, one
batched ``rfft``, one filterbank product and one DCT product (both in full
float32, TF32 off); no per-frame loop.  Batched over leading dims.
Dither draws from an explicit ``generator`` (a ``torch.Generator``) where
the JAX package takes a PRNG ``key``, and raises without one;
``dither=0.0`` by default.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.features import _float
from ..ops.metrics import full_f32_matmul

__all__ = ["spectrogram", "fbank", "mfcc"]

_EPS = float(np.finfo(np.float32).eps)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _window_vec(window_type: str, n: int, blackman_coeff: float):
    """Kaldi feature-window: periodic-in-(N-1) windows, float64."""
    a = 2 * np.pi / (n - 1)
    k = np.arange(n, dtype=np.float64)
    if window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * k)
    elif window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * k)
    elif window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * k)) ** 0.85
    elif window_type == "rectangular":
        w = np.ones(n)
    elif window_type == "blackman":
        w = (blackman_coeff - 0.5 * np.cos(a * k)
             + (0.5 - blackman_coeff) * np.cos(2 * a * k))
    else:
        raise ValueError(f"unknown window_type {window_type!r}")
    return w


def _frame_indices(n: int, window: int, shift: int, snip_edges: bool):
    """Static (num_frames, window) sample indices (reflect-padded when
    ``snip_edges=False``, Kaldi's symmetric mirroring)."""
    if snip_edges:
        m = 1 + (n - window) // shift if n >= window else 0
        starts = np.arange(m) * shift
        idx = starts[:, None] + np.arange(window)[None, :]
    else:
        m = (n + shift // 2) // shift
        starts = np.arange(m) * shift + shift // 2 - window // 2
        idx = starts[:, None] + np.arange(window)[None, :]
        # Kaldi reflects REPEATEDLY until in range; the iterated boundary
        # reflection has period 2n, giving the closed form below
        p = np.mod(idx, 2 * n)
        idx = np.where(p >= n, 2 * n - 1 - p, p)
    return m, idx.astype(np.int64)


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def _vtln_warp(freq, low, high, vtln_low, vtln_high, warp):
    """Kaldi's piecewise-linear VTLN warp (float64, Hz domain)."""
    l = vtln_low * max(1.0, warp)
    h = vtln_high * min(1.0, warp)
    scale = 1.0 / warp
    fl = scale * l
    fh = scale * h
    out = np.asarray(freq, np.float64).copy()
    lo = freq < l
    hi = freq > h
    mid = ~(lo | hi)
    out[mid] = scale * freq[mid]
    lo_scale = (fl - low) / (l - low)
    hi_scale = (high - fh) / (high - h)
    out[lo] = low + lo_scale * (freq[lo] - low)
    out[hi] = high - hi_scale * (high - freq[hi])
    return out


def _mel_banks(num_bins: int, padded_window: int, sample_freq: float,
               low_freq: float, high_freq: float,
               vtln_low: float, vtln_high: float, vtln_warp: float):
    """Kaldi MelBanks: triangles linear in MEL over fft bins
    0..N/2-1 (nyquist bin excluded), float64 construction."""
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    if not (0.0 <= low_freq < high_freq <= nyquist):
        raise ValueError(
            f"bad frequency range [{low_freq}, {high_freq}] for "
            f"nyquist {nyquist}")
    n_fft_bins = padded_window // 2
    mel_low = _mel(low_freq)
    mel_high = _mel(high_freq)
    delta = (mel_high - mel_low) / (num_bins + 1)
    vl = vtln_low if vtln_low >= 0 else nyquist + vtln_low
    vh = vtln_high if vtln_high >= 0 else nyquist + vtln_high

    edges_mel = mel_low + np.arange(num_bins + 2) * delta
    if vtln_warp != 1.0:
        hz = 700.0 * (np.exp(edges_mel / 1127.0) - 1.0)
        hz = _vtln_warp(hz, low_freq, high_freq, vl, vh, vtln_warp)
        edges_mel = _mel(hz)
    left = edges_mel[:-2][:, None]
    center = edges_mel[1:-1][:, None]
    right = edges_mel[2:][:, None]

    bin_mel = _mel(np.arange(n_fft_bins, dtype=np.float64)
                   * (sample_freq / padded_window))[None, :]
    up = (bin_mel - left) / (center - left)
    down = (right - bin_mel) / (right - center)
    return np.maximum(0.0, np.minimum(up, down))     # (num_bins, N/2)


def _dct_matrix(num_ceps: int, num_bins: int):
    """Orthonormal DCT-II rows 0..num_ceps-1 (Kaldi ComputeDctMatrix)."""
    j = np.arange(num_bins, dtype=np.float64)
    i = np.arange(num_ceps, dtype=np.float64)[:, None]
    m = np.cos(np.pi / num_bins * i * (j + 0.5)) * math.sqrt(2.0 / num_bins)
    m[0] = math.sqrt(1.0 / num_bins)
    return m


def _tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A float64 host array in ``like``'s dtype, on its device."""
    return torch.tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def _preprocess(waveform, *, sample_frequency, frame_length, frame_shift,
                round_to_power_of_two, snip_edges, dither, generator,
                remove_dc_offset, preemphasis_coefficient, raw_energy,
                energy_floor, window_type, blackman_coeff, min_duration):
    """Shared front half: frames → (power_spectrum (m, N/2+1),
    log_energy (m,)).  Returns (None, None, 0) for too-short input."""
    x = _float(torch.as_tensor(waveform))
    n = x.shape[-1]
    window = int(sample_frequency * frame_length / 1000.0)
    shift = int(sample_frequency * frame_shift / 1000.0)
    if window < 2 or shift < 1:
        # degenerate parameters raise regardless of clip length — a
        # short clip must not swallow the bad-parameter error
        raise ValueError(f"bad frame_length/frame_shift "
                         f"({frame_length}, {frame_shift})")
    if window > n and snip_edges:
        return None, None, 0
    if n < min_duration * sample_frequency:
        return None, None, 0
    padded = _next_pow2(window) if round_to_power_of_two else window
    m, idx = _frame_indices(n, window, shift, snip_edges)
    if m == 0:
        return None, None, 0

    frames = x[..., torch.from_numpy(idx).to(x.device)]  # (..., m, window)
    if dither != 0.0:
        if generator is None:
            raise ValueError(
                "dither != 0 requires an explicit torch.Generator")
        noise = torch.randn(frames.shape, generator=generator,
                            dtype=frames.dtype, device=generator.device)
        frames = frames + dither * noise.to(frames.device)
    if remove_dc_offset:
        frames = frames - torch.mean(frames, -1, keepdim=True)

    def _log_energy(fr):
        return torch.log(torch.clamp(torch.sum(fr * fr, -1), min=_EPS))

    log_e = _log_energy(frames) if raw_energy else None

    c = preemphasis_coefficient
    if c != 0.0:
        first = frames[..., :1] * (1.0 - c)
        rest = frames[..., 1:] - c * frames[..., :-1]
        frames = torch.cat([first, rest], -1)
    frames = frames * _tensor(
        _window_vec(window_type, window, blackman_coeff), frames)
    if not raw_energy:
        log_e = _log_energy(frames)
    if energy_floor > 0.0:
        log_e = torch.clamp(log_e, min=math.log(energy_floor))

    if padded > window:
        frames = F.pad(frames, (0, padded - window))
    spec = torch.fft.rfft(frames)
    power = spec.real ** 2 + spec.imag ** 2          # (..., m, N/2+1)
    return power, log_e, padded


def _empty_dim(frame_length, sample_frequency,
               round_to_power_of_two) -> int:
    """Spectrogram feature dim for the zero-frame result (the output
    contract must hold even when the clip is too short to frame)."""
    window = int(sample_frequency * frame_length / 1000.0)
    padded = _next_pow2(window) if round_to_power_of_two else window
    return padded // 2 + 1


def _empty(waveform, dim: int) -> torch.Tensor:
    x = torch.as_tensor(waveform)
    return x.new_zeros(x.shape[:-1] + (0, dim),
                       dtype=torch.promote_types(x.dtype, torch.float32))


def _mel_energies(power, padded, num_mel_bins, sample_frequency,
                  low_freq, high_freq, vtln_low, vtln_high, vtln_warp,
                  use_power=True):
    """Mel filterbank energies of ``power`` (Kaldi drops the nyquist
    bin), one product in full float32."""
    banks = _tensor(
        _mel_banks(num_mel_bins, padded, sample_frequency, low_freq,
                   high_freq, vtln_low, vtln_high, vtln_warp), power)
    spec = power[..., :padded // 2]
    if not use_power:
        spec = torch.sqrt(spec)
    with full_f32_matmul():
        return spec @ banks.T


def spectrogram(waveform, blackman_coeff: float = 0.42,
                dither: float = 0.0, energy_floor: float = 1.0,
                frame_length: float = 25.0, frame_shift: float = 10.0,
                min_duration: float = 0.0,
                preemphasis_coefficient: float = 0.97,
                raw_energy: bool = True, remove_dc_offset: bool = True,
                round_to_power_of_two: bool = True,
                sample_frequency: float = 16000.0,
                snip_edges: bool = True, subtract_mean: bool = False,
                window_type: str = "povey",
                generator: Optional[torch.Generator] = None):
    """Kaldi ``compute-spectrogram-feats``: log power spectrum with the
    DC bin replaced by the frame log-energy.  ``(..., time)`` →
    ``(..., num_frames, padded_window/2 + 1)``."""
    power, log_e, _ = _preprocess(
        waveform, sample_frequency=sample_frequency,
        frame_length=frame_length, frame_shift=frame_shift,
        round_to_power_of_two=round_to_power_of_two,
        snip_edges=snip_edges, dither=dither, generator=generator,
        remove_dc_offset=remove_dc_offset,
        preemphasis_coefficient=preemphasis_coefficient,
        raw_energy=raw_energy, energy_floor=energy_floor,
        window_type=window_type, blackman_coeff=blackman_coeff,
        min_duration=min_duration)
    if power is None:
        return _empty(waveform, _empty_dim(frame_length, sample_frequency,
                                           round_to_power_of_two))
    feats = torch.log(torch.clamp(power, min=_EPS))
    feats = torch.cat([log_e[..., None], feats[..., 1:]], -1)
    if subtract_mean:
        feats = feats - torch.mean(feats, -2, keepdim=True)
    return feats


def fbank(waveform, blackman_coeff: float = 0.42, dither: float = 0.0,
          energy_floor: float = 1.0, frame_length: float = 25.0,
          frame_shift: float = 10.0, high_freq: float = 0.0,
          htk_compat: bool = False, low_freq: float = 20.0,
          min_duration: float = 0.0, num_mel_bins: int = 23,
          preemphasis_coefficient: float = 0.97, raw_energy: bool = True,
          remove_dc_offset: bool = True,
          round_to_power_of_two: bool = True,
          sample_frequency: float = 16000.0, snip_edges: bool = True,
          subtract_mean: bool = False, use_energy: bool = False,
          use_log_fbank: bool = True, use_power: bool = True,
          vtln_high: float = -500.0, vtln_low: float = 100.0,
          vtln_warp: float = 1.0, window_type: str = "povey",
          generator: Optional[torch.Generator] = None):
    """Kaldi ``compute-fbank-feats``: (log-)mel filterbank energies,
    optionally with an energy column.  ``(..., time)`` →
    ``(..., num_frames, num_mel_bins [+1])``."""
    power, log_e, padded = _preprocess(
        waveform, sample_frequency=sample_frequency,
        frame_length=frame_length, frame_shift=frame_shift,
        round_to_power_of_two=round_to_power_of_two,
        snip_edges=snip_edges, dither=dither, generator=generator,
        remove_dc_offset=remove_dc_offset,
        preemphasis_coefficient=preemphasis_coefficient,
        raw_energy=raw_energy, energy_floor=energy_floor,
        window_type=window_type, blackman_coeff=blackman_coeff,
        min_duration=min_duration)
    if power is None:
        return _empty(waveform, num_mel_bins + int(use_energy))
    mel = _mel_energies(power, padded, num_mel_bins, sample_frequency,
                        low_freq, high_freq, vtln_low, vtln_high,
                        vtln_warp, use_power)
    if use_log_fbank:
        mel = torch.log(torch.clamp(mel, min=_EPS))
    if use_energy:
        e = log_e[..., None]
        mel = (torch.cat([mel, e], -1) if htk_compat
               else torch.cat([e, mel], -1))
    if subtract_mean:
        mel = mel - torch.mean(mel, -2, keepdim=True)
    return mel


def mfcc(waveform, blackman_coeff: float = 0.42,
         cepstral_lifter: float = 22.0, dither: float = 0.0,
         energy_floor: float = 1.0, frame_length: float = 25.0,
         frame_shift: float = 10.0, high_freq: float = 0.0,
         htk_compat: bool = False, low_freq: float = 20.0,
         min_duration: float = 0.0, num_ceps: int = 13,
         num_mel_bins: int = 23, preemphasis_coefficient: float = 0.97,
         raw_energy: bool = True, remove_dc_offset: bool = True,
         round_to_power_of_two: bool = True,
         sample_frequency: float = 16000.0, snip_edges: bool = True,
         subtract_mean: bool = False, use_energy: bool = False,
         vtln_high: float = -500.0, vtln_low: float = 100.0,
         vtln_warp: float = 1.0, window_type: str = "povey",
         generator: Optional[torch.Generator] = None):
    """Kaldi ``compute-mfcc-feats``: liftered DCT of log-mel energies.
    ``(..., time)`` → ``(..., num_frames, num_ceps)``."""
    if not 0 < num_ceps <= num_mel_bins:
        raise ValueError("need 0 < num_ceps <= num_mel_bins")
    power, log_e, padded = _preprocess(
        waveform, sample_frequency=sample_frequency,
        frame_length=frame_length, frame_shift=frame_shift,
        round_to_power_of_two=round_to_power_of_two,
        snip_edges=snip_edges, dither=dither, generator=generator,
        remove_dc_offset=remove_dc_offset,
        preemphasis_coefficient=preemphasis_coefficient,
        raw_energy=raw_energy, energy_floor=energy_floor,
        window_type=window_type, blackman_coeff=blackman_coeff,
        min_duration=min_duration)
    if power is None:
        return _empty(waveform, num_ceps)
    mel = torch.log(torch.clamp(
        _mel_energies(power, padded, num_mel_bins, sample_frequency,
                      low_freq, high_freq, vtln_low, vtln_high,
                      vtln_warp), min=_EPS))
    dct = _tensor(_dct_matrix(num_ceps, num_mel_bins), mel)
    with full_f32_matmul():
        ceps = mel @ dct.T
    if cepstral_lifter != 0.0:
        q = cepstral_lifter
        lift = 1.0 + 0.5 * q * np.sin(np.pi * np.arange(num_ceps) / q)
        ceps = ceps * _tensor(lift, ceps)
    if use_energy:
        ceps = torch.cat([log_e[..., None], ceps[..., 1:]], -1)
    if htk_compat:
        # energy/C0 moves last; HTK scales C0 by sqrt(2) when it is a
        # true cepstral coefficient rather than log-energy
        first = ceps[..., :1]
        if not use_energy:
            first = first * math.sqrt(2.0)
        ceps = torch.cat([ceps[..., 1:], first], -1)
    if subtract_mean:
        ceps = ceps - torch.mean(ceps, -2, keepdim=True)
    return ceps
