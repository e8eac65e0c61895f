"""Batched 1-D convolution along time: direct and FFT-based.

Port of ``torchaudio_contrib_tpu/ops/convolve.py`` (torchaudio's
``convolve``/``fftconvolve``).  :func:`convolve` is one grouped ``conv1d``
(a per-example kernel is a group), run with TF32 off so that it stays full
float32 on the card; :func:`fftconvolve` multiplies one-sided FFTs at the
next power of two.  Leading dims broadcast NumPy-style; ``mode`` is
``full``, ``valid`` or ``same`` with ``scipy.signal`` semantics; both are
differentiable in both inputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["convolve", "fftconvolve"]


def _broadcast_lead(x: torch.Tensor, y: torch.Tensor):
    lead = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    return (x.expand(lead + x.shape[-1:]), y.expand(lead + y.shape[-1:]),
            tuple(lead))


def _trim(full: torch.Tensor, n: int, m: int, mode: str) -> torch.Tensor:
    if mode == "full":
        return full
    if mode == "valid":
        start = min(n, m) - 1
        return full[..., start:start + max(n, m) - min(n, m) + 1]
    if mode == "same":
        start = (min(n, m) - 1) // 2
        return full[..., start:start + max(n, m)]
    raise ValueError(f"mode must be full|valid|same, got {mode!r}")


def _prepare(x: torch.Tensor, y: torch.Tensor, name: str):
    if x.ndim == 0 or y.ndim == 0:
        raise ValueError(f"{name} needs at least 1-D inputs")
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    return x, y.to(x.dtype)


def convolve(x: torch.Tensor, y: torch.Tensor,
             mode: str = "full") -> torch.Tensor:
    """Direct linear convolution of ``x`` and ``y`` along the last axis;
    each broadcast element convolves its own pair.  Matches
    ``np.convolve`` / ``scipy.signal.convolve`` for every ``mode``."""
    x, y = _prepare(x, y, "convolve")
    n, m = x.shape[-1], y.shape[-1]
    x, y, lead = _broadcast_lead(x, y)
    g = math.prod(lead)
    rhs = y.flip(-1).reshape(g, 1, m)
    with torch.backends.cudnn.flags(allow_tf32=False):
        full = F.conv1d(x.reshape(1, g, n), rhs, padding=m - 1, groups=g)
    return _trim(full.reshape(lead + (n + m - 1,)), n, m, mode)


def fftconvolve(x: torch.Tensor, y: torch.Tensor,
                mode: str = "full") -> torch.Tensor:
    """FFT-based linear convolution with :func:`convolve`'s semantics:
    zero-padded to the next power of two at or above ``n + m − 1``; the
    engine for kernels of a few hundred taps and more (room responses)."""
    x, y = _prepare(x, y, "fftconvolve")
    n, m = x.shape[-1], y.shape[-1]
    x, y, _ = _broadcast_lead(x, y)
    size = n + m - 1
    nfft = 1 << max(int(math.ceil(math.log2(size))), 1)
    full = torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(y, nfft),
                           nfft)[..., :size]
    return _trim(full, n, m, mode)
