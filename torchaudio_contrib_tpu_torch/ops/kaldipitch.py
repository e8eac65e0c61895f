"""Kaldi-style pitch + voicing features (``compute_kaldi_pitch``).

Port of ``torchaudio_contrib_tpu/ops/kaldipitch.py``: the algorithm of
Kaldi's pitch tracker (Ghahremani et al., ICASSP 2014) as the JAX package
implements it.  Output layout follows the Kaldi feature matrix:
``(..., frames, 2)`` with ``[..., 0] = NCCF`` and ``[..., 1] = pitch in
Hz``.

1. Resample to ``resample_frequency`` (the port's polyphase resampler),
   then a zero-phase windowed-sinc low-pass at ``lowpass_cutoff`` (one
   ``conv1d`` with TF32 off).
2. Normalise to unit average power (scale invariance).
3. NCCF per frame over every integer lag in ``[rf/max_f0, rf/min_f0]``,
   all lags of all frames as one batched ``rfft`` cross-correlation plus
   one ``cumsum`` for the sliding energies; with and without the ballast.
4. Interpolate onto a geometric lag grid (ratio ``1 + delta_pitch``) with
   one windowed-sinc matrix, in full float32 (TF32 off).
5. Viterbi over the lag grid: a loop of tensor ops over frames, ``(B, S,
   S)`` min and argmin each (ties to the first index, as in JAX), then the
   backpointers go to the host once for the traceback.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .features import _float
from .metrics import full_f32_matmul
from .resample import resample
from .stft import frame_signal

__all__ = ["compute_kaldi_pitch"]


def _lowpass_taps(cutoff: float, sr: float, half_zeros: int = 16):
    """Zero-phase windowed-sinc low-pass (odd length, unit DC gain)."""
    n = np.arange(-half_zeros, half_zeros + 1, dtype=np.float64)
    fc = cutoff / sr                       # cycles per sample
    taps = 2.0 * fc * np.sinc(2.0 * fc * n)
    taps *= np.hanning(n.size + 2)[1:-1]
    return taps / taps.sum()


def _lag_grid(min_lag: int, max_lag: int, delta_pitch: float):
    """Geometric lag grid covering [min_lag, max_lag] with ratio
    ``1 + delta_pitch`` (matching Kaldi's relative pitch resolution)."""
    ratio = math.log1p(delta_pitch)
    count = int(math.floor(math.log(max_lag / min_lag) / ratio)) + 1
    lags = min_lag * np.exp(ratio * np.arange(count, dtype=np.float64))
    return np.minimum(lags, float(max_lag))


def _interp_matrix(grid: np.ndarray, min_lag: int, max_lag: int,
                   half_width: int = 2):
    """(S, L) windowed-sinc interpolation from integer lags
    ``min_lag..max_lag`` onto the fractional ``grid`` lags."""
    ints = np.arange(min_lag, max_lag + 1, dtype=np.float64)
    d = grid[:, None] - ints[None, :]            # (S, L)
    w = np.sinc(d) * (np.cos(np.pi * d / (2 * half_width + 1)) ** 2)
    w[np.abs(d) > half_width + 0.5] = 0.0
    # exact on constants (renormalize rows; edge rows lose taps)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w


def _viterbi(local: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Min-cost path through ``local (B, T, S)`` with pairwise
    ``trans (S_prev, S_next)`` costs → states ``(B, T)`` int32.

    Forward: one step of tensor ops per frame (``(B, S, S)`` min with its
    argmin, ties to the first index).  The int32 backpointers then move to
    the host once and the traceback follows them there."""
    b, t, s = local.shape
    cost = local[:, 0]
    bps = []
    for i in range(1, t):
        # cost (B, S); choose best predecessor per next-state
        total = cost[:, :, None] + trans[None]     # (B, Sp, Sn)
        best, bp = torch.min(total, dim=1)
        bps.append(bp.to(torch.int32))
        cost = best + local[:, i]
    states = np.zeros((b, t), np.int32)
    states[:, -1] = torch.argmin(cost, dim=-1).cpu().numpy()
    if t > 1:
        bp_host = torch.stack(bps).cpu().numpy()    # (T-1, B, S)
        rows = np.arange(b)
        for i in range(t - 2, -1, -1):
            # bp[i][j]: best frame-i state given frame i+1 is in state j
            states[:, i] = bp_host[i, rows, states[:, i + 1]]
    return torch.from_numpy(states).to(local.device)


def compute_kaldi_pitch(waveform: torch.Tensor, sample_rate: float,
                        frame_length: float = 25.0,
                        frame_shift: float = 10.0,
                        min_f0: float = 50.0, max_f0: float = 400.0,
                        soft_min_f0: float = 10.0,
                        penalty_factor: float = 0.1,
                        lowpass_cutoff: float = 1000.0,
                        resample_frequency: float = 4000.0,
                        delta_pitch: float = 0.005,
                        nccf_ballast: float = 7000.0,
                        snip_edges: bool = True) -> torch.Tensor:
    """Kaldi pitch features for ``waveform (..., time)``.

    Returns ``(..., num_frames, 2)`` float32 with ``[..., 0]`` the
    NCCF at the chosen lag (voicing evidence, roughly ``[-1, 1]``) and
    ``[..., 1]`` the pitch track in Hz (always within
    ``[min_f0, max_f0]`` — Kaldi emits a pitch for every frame and
    leaves voicing decisions to the NCCF/POV column).

    ``num_frames = 1 + (T_rs - window) // shift`` at the resampled
    rate when ``snip_edges`` (Kaldi's convention), else
    ``ceil(T_rs / shift)`` with symmetric reflection padding.
    """
    if not (0 < min_f0 < max_f0):
        raise ValueError("need 0 < min_f0 < max_f0")
    if max_f0 >= lowpass_cutoff:
        raise ValueError("max_f0 must sit below lowpass_cutoff")
    if lowpass_cutoff > resample_frequency / 2:
        raise ValueError(
            "lowpass_cutoff must be <= resample_frequency / 2")
    rf = float(resample_frequency)
    sample_rate = float(sample_rate)

    waveform = _float(torch.as_tensor(waveform))
    lead = waveform.shape[:-1]
    x = waveform.reshape((-1, waveform.shape[-1]))
    dev, dt = x.device, x.dtype

    if sample_rate != rf:
        if int(sample_rate) != sample_rate or int(rf) != rf:
            raise ValueError("sample rates must be integral to "
                             "resample (rational polyphase)")
        x = resample(x, int(sample_rate), int(rf))
    if lowpass_cutoff < 0.49 * rf:
        taps = torch.tensor(_lowpass_taps(lowpass_cutoff, rf)[::-1].copy(),
                            dtype=torch.float32, device=dev).to(dt)
        half = (taps.shape[0] - 1) // 2
        with torch.backends.cudnn.flags(allow_tf32=False):
            x = F.conv1d(x[:, None, :], taps.view(1, 1, -1),
                         padding=half)[:, 0, :]

    # unit average power (per batch element) — scale invariance
    power = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(torch.clamp(power, min=1e-20))

    window = max(int(round(rf * frame_length / 1000.0)), 2)
    shift = max(int(round(rf * frame_shift / 1000.0)), 1)
    min_lag = max(int(math.floor(rf / max_f0)), 1)
    max_lag = int(math.ceil(rf / min_f0))
    t_rs = x.shape[-1]

    if snip_edges:
        n_frames = 1 + (t_rs - window) // shift
        if n_frames < 1:
            raise ValueError(
                f"waveform too short: {t_rs} resampled samples < "
                f"one {window}-sample frame")
    else:
        n_frames = -(-t_rs // shift)
        pad_left = (window - shift) // 2
        if pad_left > 0:
            x = torch.cat([x[:, 1:pad_left + 1].flip(-1), x], dim=-1)
    # zero tail so every frame has its full window + lag reach
    need = (n_frames - 1) * shift + window + max_lag
    x = F.pad(x, (0, max(0, need - x.shape[-1])))

    ext = window + max_lag
    u = frame_signal(x, ext, shift)[:, :n_frames]  # (B, T, ext)
    w = u[..., :window]

    # all-lag correlation via one rfft product
    nfft = 1 << int(np.ceil(np.log2(ext + window)))
    uf = torch.fft.rfft(u, n=nfft, dim=-1)
    wf = torch.fft.rfft(w, n=nfft, dim=-1)
    corr = torch.fft.irfft(torch.conj(wf) * uf, n=nfft,
                           dim=-1)[..., :max_lag + 1]

    c2 = torch.cumsum(u * u, dim=-1)
    c2 = F.pad(c2, (1, 0))
    e_lag = c2[..., window:window + max_lag + 1] - c2[..., :max_lag + 1]
    e_w = e_lag[..., :1]

    corr = corr[..., min_lag:]                     # (B, T, L)
    e2 = e_lag[..., min_lag:]
    ballast = float(nccf_ballast) * (window / 100.0) ** 2
    nccf_pitch = corr * torch.rsqrt(torch.clamp(e_w * e2 + ballast,
                                                min=1e-12))
    nccf_pov = corr * torch.rsqrt(torch.clamp(e_w * e2, min=1e-12))

    # integer lags -> geometric grid, one product each, full float32
    grid = _lag_grid(min_lag, max_lag, delta_pitch)
    interp = torch.tensor(_interp_matrix(grid, min_lag, max_lag),
                          dtype=torch.float32, device=dev).to(dt)
    with full_f32_matmul():
        phi = nccf_pitch @ interp.T
        pov = nccf_pov @ interp.T

    # Viterbi over lag states
    lag_s = torch.tensor(grid, dtype=torch.float32, device=dev)
    soft = 1.0 - float(soft_min_f0) * lag_s / rf   # (S,)
    local = 1.0 - phi * soft                       # (B, T, S)
    log_lag = np.log(grid)
    trans = torch.tensor(
        float(penalty_factor)
        * (log_lag[:, None] - log_lag[None, :]) ** 2,
        dtype=torch.float32, device=dev)
    states = _viterbi(local, trans).long()          # (B, T)

    pitch = rf / lag_s[states]
    nccf = torch.gather(pov, -1, states[..., None])[..., 0]
    out = torch.stack([nccf, pitch.to(nccf.dtype)], dim=-1) \
        .to(torch.float32)
    return out.reshape(lead + (n_frames, 2))
