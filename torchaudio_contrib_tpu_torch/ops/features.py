"""Speech front-end companions: delta features, pre- and de-emphasis.

Port of ``torchaudio_contrib_tpu/ops/features.py``.

* :func:`compute_deltas`: the regression-formula delta, a small FIR along
  time, as one ``conv1d`` over the flattened leading dims.
* :func:`preemphasis`: ``y[n] = x[n] − a·x[n−1]``, a shift and a subtract.
* :func:`deemphasis`: the inverse IIR ``y[n] = x[n] + a·y[n−1]``, a
  first-order linear recurrence.  The JAX package runs it as an
  ``associative_scan`` of ``(A, B)`` pairs; here the same scan is written
  with tensor ops (:func:`_linear_recurrence`): ``log2 T`` doubling steps
  over time, each one elementwise multiply-add over the whole signal, in
  float32.  No loop over samples, and no ``cumsum`` divided by powers of the
  coefficient (which overflows on long clips).

All differentiable; time is the last axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["compute_deltas", "preemphasis", "deemphasis"]

_PAD_MODES = {"replicate": "replicate", "edge": "replicate",
              "reflect": "reflect", "zeros": "constant",
              "constant": "constant"}


def _float(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def compute_deltas(specgram: torch.Tensor, win_length: int = 5,
                   mode: str = "replicate") -> torch.Tensor:
    """Delta coefficients of ``specgram (..., freq, time)``.

    ``d[t] = Σ_{k=1..n} k·(x[t+k] − x[t−k]) / (2·Σ k²)`` with half-window
    ``n = (win_length − 1)//2``; ``win_length`` odd and at least 3; edges
    take ``mode`` padding (``"replicate"`` by default).
    """
    if win_length < 3 or win_length % 2 == 0:
        raise ValueError("win_length must be odd and >= 3, got "
                         f"{win_length}")
    pad_mode = _PAD_MODES.get(mode)
    if pad_mode is None:
        raise ValueError(f"unsupported mode {mode!r}")
    specgram = _float(specgram)
    n = (win_length - 1) // 2
    denom = 2.0 * sum(k * k for k in range(1, n + 1))
    kernel = torch.tensor([k / denom for k in range(-n, n + 1)],
                          dtype=specgram.dtype, device=specgram.device)
    lead, t = specgram.shape[:-1], specgram.shape[-1]
    x = F.pad(specgram.reshape(-1, 1, t), (n, n), mode=pad_mode)
    return F.conv1d(x, kernel.view(1, 1, win_length)).reshape(lead + (t,))


def preemphasis(waveform: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """``y[n] = x[n] − coeff·x[n−1]`` (``y[0] = x[0]``), time last."""
    waveform = _float(waveform)
    return waveform - coeff * F.pad(waveform[..., :-1], (1, 0))


def _linear_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y[n] = a[n]·y[n−1] + b[n]`` along the last axis (``y[−1] = 0``),
    as a Hillis-Steele scan: after the step of shift ``s`` each ``(a, b)``
    holds the composition of the maps of its ``2s`` last samples, so
    ``ceil(log2 T)`` steps of tensor ops finish the scan.  Each step is
    one elementwise multiply-add in the input's precision."""
    t = a.shape[-1]
    s = 1
    while s < t:
        a_prev = F.pad(a[..., :-s], (s, 0), value=1.0)
        b_prev = F.pad(b[..., :-s], (s, 0))
        a, b = a * a_prev, a * b_prev + b
        s *= 2
    return b


def deemphasis(waveform: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """Exact inverse of :func:`preemphasis`: ``y[n] = x[n] +
    coeff·y[n−1]``, by a log-depth scan (:func:`_linear_recurrence`)."""
    waveform = _float(waveform)
    return _linear_recurrence(torch.full_like(waveform, coeff), waveform)
