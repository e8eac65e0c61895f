"""Window functions and COLA/NOLA checks.

Port of ``torchaudio_contrib_tpu/ops/windows.py``.  Windows are tiny 1-D
constants built in float64 NumPy and cast to the compute dtype where they
are used, so every caller (torch.stft, the DFT bases, the fused kernel's
basis) starts from the same float64 values.

All windows default to *periodic* (fftbins=True) to match
``torch.hann_window(periodic=True)``.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "hann_window",
    "hamming_window",
    "blackman_window",
    "bartlett_window",
    "kaiser_window",
    "nuttall_window",
    "rectangular_window",
    "get_window",
    "cola_window_sum",
    "check_nola",
]


def _raised_cosine(win_length: int, coeffs, periodic: bool) -> np.ndarray:
    if win_length == 1:
        return np.ones(1, dtype=np.float64)
    denom = win_length if periodic else win_length - 1
    n = np.arange(win_length, dtype=np.float64)
    w = np.zeros(win_length, dtype=np.float64)
    for k, a in enumerate(coeffs):
        w += a * np.cos(2.0 * np.pi * k * n / denom) * (-1.0) ** k
    return w


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Periodic Hann window, bit-matching ``torch.hann_window`` semantics."""
    return _raised_cosine(win_length, (0.5, 0.5), periodic)


def hamming_window(win_length: int, periodic: bool = True,
                   alpha: float = 0.54, beta: float = 0.46) -> np.ndarray:
    return _raised_cosine(win_length, (alpha, beta), periodic)


def blackman_window(win_length: int, periodic: bool = True) -> np.ndarray:
    return _raised_cosine(win_length, (0.42, 0.5, 0.08), periodic)


def rectangular_window(win_length: int, periodic: bool = True) -> np.ndarray:
    del periodic
    return np.ones(win_length, dtype=np.float64)


def bartlett_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Triangular window, matching ``torch.bartlett_window`` semantics."""
    if win_length == 1:
        return np.ones(1, dtype=np.float64)
    denom = win_length if periodic else win_length - 1
    n = np.arange(win_length, dtype=np.float64)
    return 1.0 - np.abs(2.0 * n / denom - 1.0)


def kaiser_window(win_length: int, periodic: bool = True,
                  beta: float = 12.0) -> np.ndarray:
    """Kaiser window, matching ``torch.kaiser_window`` semantics."""
    if win_length == 1:
        return np.ones(1, dtype=np.float64)
    n = win_length + 1 if periodic else win_length
    w = np.kaiser(n, beta)
    return w[:-1] if periodic else w


def nuttall_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Nuttall 4-term window (very low sidelobes)."""
    return _raised_cosine(
        win_length, (0.3635819, 0.4891775, 0.1365995, 0.0106411), periodic)


_WINDOWS = {
    "hann": hann_window,
    "hamming": hamming_window,
    "blackman": blackman_window,
    "bartlett": bartlett_window,
    "triangular": bartlett_window,
    "kaiser": kaiser_window,
    "nuttall": nuttall_window,
    "rectangular": rectangular_window,
    "ones": rectangular_window,
    "boxcar": rectangular_window,
}


def get_window(window, win_length: int, periodic: bool = True) -> np.ndarray:
    """Resolve a window spec to a float64 NumPy array of length ``win_length``.

    ``window`` may be: a name string, a callable ``f(win_length) -> array``,
    an array of length ``win_length``, or ``None`` (rectangular).
    """
    if window is None:
        return rectangular_window(win_length)
    if isinstance(window, str):
        try:
            fn = _WINDOWS[window.lower()]
        except KeyError:
            raise ValueError(
                f"unknown window {window!r}; known: {sorted(_WINDOWS)}")
        return fn(win_length, periodic)
    if callable(window):
        w = np.asarray(window(win_length), dtype=np.float64)
    else:
        w = np.asarray(window, dtype=np.float64)
    if w.ndim != 1 or w.shape[0] != win_length:
        raise ValueError(
            f"window must be 1-D of length {win_length}, got shape {w.shape}")
    return w


def cola_window_sum(window: np.ndarray, hop_length: int, n_frames: int,
                    output_length: int) -> np.ndarray:
    """Sum of squared, hop-shifted windows (the ISTFT normalization envelope).

    Equivalent to the overlap-add of ``window**2`` used by ``torch.istft``
    for its least-squares inverse.  Computed in NumPy float64 when shapes
    are static (the common case) so it constant-folds under ``jit``.
    """
    wsq = np.asarray(window, dtype=np.float64) ** 2
    env = np.zeros(output_length, dtype=np.float64)
    n = wsq.shape[0]
    for m in range(n_frames):
        start = m * hop_length
        stop = min(start + n, output_length)
        if start >= output_length:
            break
        env[start:stop] += wsq[: stop - start]
    return env


def check_nola(window: np.ndarray, hop_length: int, n_frames: int,
               output_length: int, eps: float = 1e-11) -> bool:
    """True iff the window/hop pair satisfies NOLA over the interior samples."""
    env = cola_window_sum(window, hop_length, n_frames, output_length)
    return bool(np.min(env) > eps)
