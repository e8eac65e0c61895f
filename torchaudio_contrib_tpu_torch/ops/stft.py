"""Short-time Fourier transform.

Port of ``torchaudio_contrib_tpu/ops/stft.py`` (the forward transform and
the overlap-add adjoint of framing).  Layouts
match the JAX package: ``(..., time)`` in, complex ``(..., freq, frames)``
out, any leading dims.  Semantics match ``torch.stft``: reflect center
padding, a window shorter than ``fft_length`` zero-padded and centred,
``normalized`` scaling by ``fft_length**-0.5``.

Two paths:

* ``method="fft"`` (default): pad → ``torch.stft`` (cuFFT on the card).
* ``method="matmul"``: frames (``Tensor.unfold``) times the windowed DFT
  folded into one real matrix per part.  ``"gemm"`` is accepted as an
  alias of ``"matmul"``: in the JAX package it is a four-step rDFT built
  for the TPU's matrix unit, with the same result.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .windows import get_window

__all__ = ["stft", "frame_signal", "num_frames"]

_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "zeros": "constant", "replicate": "replicate",
              "edge": "replicate", "circular": "circular",
              "wrap": "circular"}


def num_frames(n_samples: int, fft_length: int, hop_length: int,
               center: bool = True) -> int:
    """Number of STFT frames ``torch.stft`` produces for this config."""
    if center:
        n_samples = n_samples + 2 * (fft_length // 2)
    if n_samples < fft_length:
        raise ValueError(
            f"input too short: {n_samples} samples < fft_length={fft_length}")
    return 1 + (n_samples - fft_length) // hop_length


def frame_signal(x: torch.Tensor, frame_length: int,
                 hop_length: int) -> torch.Tensor:
    """Slice ``x (..., T)`` into overlapping frames
    ``(..., n_frames, frame_length)`` (a strided view, no copy)."""
    if x.shape[-1] < frame_length:
        raise ValueError(f"input too short: {x.shape[-1]} samples < "
                         f"frame_length={frame_length}")
    return x.unfold(-1, frame_length, hop_length)


def _overlap_add(frames: torch.Tensor, fft_length: int, hop_length: int,
                 full_length: int) -> torch.Tensor:
    """Overlap-add ``frames (..., n_frames, fft_length)`` into
    ``(..., full_length)``: the exact adjoint of :func:`frame_signal`.

    As in the JAX package, frames of one phase (``r = ceil(fft/hop)``
    phases) do not overlap, so the sum is ``r`` dense shifted adds of
    contiguous rows, each zero-padded from ``fft`` to ``r·hop``, for any
    hop."""
    n_frames = frames.shape[-2]
    lead = frames.shape[:-2]
    r = -(-fft_length // hop_length)
    row = r * hop_length
    k = -(-n_frames // r)
    # (..., k, r, row): phase p holds frames q·r + p
    fr = F.pad(frames, (0, row - fft_length, 0, k * r - n_frames))
    fr = fr.reshape(lead + (k, r, row))
    out = frames.new_zeros(lead + (max((r - 1) * hop_length + k * row,
                                       full_length),))
    for p in range(r):
        out[..., p * hop_length:p * hop_length + k * row] += \
            fr[..., :, p, :].reshape(lead + (k * row,))
    return out[..., :full_length]


def _pad_center(x: torch.Tensor, pad: int, pad_mode: str) -> torch.Tensor:
    try:
        mode = _PAD_MODES[pad_mode]
    except KeyError:
        raise ValueError(f"unsupported pad_mode {pad_mode!r}") from None
    lead, t = x.shape[:-1], x.shape[-1]
    # reflect/replicate/circular pad the last dim of a (C, T) input
    y = F.pad(x.reshape(-1, t), (pad, pad), mode=mode)
    return y.reshape(lead + (t + 2 * pad,))


def _resolve_window(window, win_length: int, fft_length: int) -> np.ndarray:
    """Window as float64 NumPy, zero-padded to ``fft_length`` and centred
    (matching ``torch.stft`` when ``win_length < n_fft``)."""
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().double().numpy()
    w = get_window(window if window is not None else "hann", win_length)
    if win_length < fft_length:
        left = (fft_length - win_length) // 2
        w = np.pad(w, (left, fft_length - win_length - left))
    elif win_length > fft_length:
        raise ValueError(
            f"win_length={win_length} > fft_length={fft_length}")
    return w


def _window_tensor(window, win_length: int, fft_length: int,
                   device, dtype) -> torch.Tensor:
    """The ``fft_length`` window as a tensor on ``device``.  A tensor of
    length ``fft_length`` is taken as already padded and stays where it
    is (no host round trip)."""
    if isinstance(window, torch.Tensor) and window.shape == (fft_length,):
        return window.to(device=device, dtype=dtype)
    return torch.as_tensor(_resolve_window(window, win_length, fft_length),
                           dtype=dtype, device=device)


@functools.lru_cache(maxsize=32)
def _dft_matrices(fft_length: int, onesided: bool):
    """Real/imag DFT analysis matrices ``(fft_length, n_freqs)`` in float64:
    ``X[f] = sum_k x[k]·(cos - i·sin)(2πfk/N)``."""
    n_freqs = fft_length // 2 + 1 if onesided else fft_length
    k = np.arange(fft_length, dtype=np.float64)[:, None]
    f = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * f / fft_length
    return np.cos(ang), -np.sin(ang)


def stft(waveform: torch.Tensor,
         fft_length: int,
         hop_length: Optional[int] = None,
         win_length: Optional[int] = None,
         window=None,
         center: bool = True,
         pad_mode: str = "reflect",
         normalized: bool = False,
         onesided: bool = True,
         method: str = "fft") -> torch.Tensor:
    """Short-time Fourier transform of ``waveform (..., time)``.

    Returns complex ``(..., n_freqs, n_frames)`` with
    ``n_freqs = fft_length//2 + 1`` when ``onesided``.  ``window`` is a
    name, a callable, an array or tensor of ``win_length`` samples, a
    tensor of ``fft_length`` samples (taken as already padded), or None
    (Hann, as in the JAX package).
    """
    if hop_length is None:
        hop_length = fft_length // 4
    if win_length is None:
        win_length = fft_length
    if method == "gemm":
        method = "matmul"
    if method not in ("fft", "matmul"):
        raise ValueError(f"unknown stft method {method!r}")

    x = waveform
    if center:
        x = _pad_center(x, fft_length // 2, pad_mode)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    w = _window_tensor(window, win_length, fft_length, x.device, x.dtype)

    if method == "fft":
        lead, t = x.shape[:-1], x.shape[-1]
        if t < fft_length:
            raise ValueError(f"input too short: {t} samples < "
                             f"fft_length={fft_length}")
        spec = torch.stft(x.reshape(-1, t), fft_length, hop_length,
                          win_length=fft_length, window=w, center=False,
                          normalized=False, onesided=onesided,
                          return_complex=True)
        spec = spec.reshape(lead + spec.shape[-2:])
    else:
        frames = frame_signal(x, fft_length, hop_length)   # (..., n, N)
        cos_m, msin_m = _dft_matrices(fft_length, onesided)
        wr = w[:, None] * torch.as_tensor(cos_m, dtype=x.dtype,
                                          device=x.device)
        wi = w[:, None] * torch.as_tensor(msin_m, dtype=x.dtype,
                                          device=x.device)
        spec = torch.complex(frames @ wr, frames @ wi).transpose(-1, -2)

    if normalized:
        spec = spec * (fft_length ** -0.5)
    return spec
