"""Short-time Fourier transform.

Port of ``torchaudio_contrib_tpu/ops/stft.py``: the forward transform,
its least-squares inverse and the overlap-add adjoint of framing.  Layouts
match the JAX package: ``(..., time)`` in, complex ``(..., freq, frames)``
out, any leading dims.  Semantics match ``torch.stft`` / ``torch.istft``:
reflect center padding, a window shorter than ``fft_length`` zero-padded
and centred, ``normalized`` scaling by ``fft_length**-0.5``, the inverse
divided by the summed squared window (NOLA checked on the kept samples).

Forward paths:

* ``method="fft"`` (default): pad → ``torch.stft`` (cuFFT on the card).
* ``method="matmul"``: frames (``Tensor.unfold``) times the windowed DFT
  folded into one real matrix per part.  ``"gemm"`` is accepted as an
  alias of ``"matmul"``: in the JAX package it is a four-step rDFT built
  for the TPU's matrix unit, with the same result.
* ``method="conv"``: framing and the windowed DFT as one strided
  ``conv1d`` whose kernel is the basis and whose stride is the hop, with
  TF32 switched off for the call: full float32 on the card as well.

:func:`istft` has ``method="fft"`` (``torch.fft.irfft`` / ``ifft``) and
``method="matmul"`` (the onesided inverse real DFT as one matrix product).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .windows import get_window, cola_window_sum

__all__ = ["stft", "istft", "frame_signal", "num_frames",
           "stft_output_length"]

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


def stft_output_length(n_frames: int, fft_length: int, hop_length: int,
                       center: bool = True,
                       length: Optional[int] = None) -> int:
    """Waveform length an ISTFT of ``n_frames`` frames reconstructs."""
    full = fft_length + hop_length * (n_frames - 1)
    if length is not None:
        return length
    if center:
        return full - 2 * (fft_length // 2)
    return full


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


def _from_bytes(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.float64).copy()


@functools.lru_cache(maxsize=16)
def _cached_on(device: torch.device, dtype: torch.dtype, make, key):
    made = make(*key)
    # never inference tensors, whatever mode the first caller was in
    with torch.inference_mode(False):
        if isinstance(made, tuple):
            return tuple(torch.as_tensor(m, dtype=dtype, device=device)
                         for m in made)
        return torch.as_tensor(made, dtype=dtype, device=device)


def _on(device, dtype: torch.dtype, make, *key):
    """``make(*key)`` (a NumPy array or a tuple of them, from hashable
    arguments) as tensors on ``device``: the one cache of constants on a
    device, so that a loop of transforms (Griffin-Lim) or a server's
    requests do not pay a host-to-device copy per call.  The least recently
    used entries are dropped.  A CUDA device is keyed with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _cached_on(device, dtype, make, key)


def _window_tensor(window, win_length: int, fft_length: int,
                   device, dtype) -> torch.Tensor:
    """The ``fft_length`` window as a tensor on ``device``.  A tensor of
    length ``fft_length`` is taken as already padded and stays where it
    is (no host round trip)."""
    if isinstance(window, torch.Tensor) and window.shape == (fft_length,):
        return window.to(device=device, dtype=dtype)
    w64 = _resolve_window(window, win_length, fft_length)
    return _on(device, dtype, _from_bytes,
               np.ascontiguousarray(w64).tobytes())


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
    if method not in ("fft", "matmul", "conv"):
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
    elif method == "conv":
        lead, t = x.shape[:-1], x.shape[-1]
        if t < fft_length:
            raise ValueError(f"input too short: {t} samples < "
                             f"fft_length={fft_length}")
        cos_m, msin_m = _on(x.device, x.dtype, _dft_matrices, fft_length,
                            onesided)
        n_freqs = cos_m.shape[1]
        basis = torch.cat([cos_m, msin_m], dim=1).T        # (2F, N)
        kern = (basis * w[None, :])[:, None, :]            # (2F, 1, N)
        # full float32 on the card too, as every other method
        with torch.backends.cudnn.flags(allow_tf32=False):
            out = F.conv1d(x.reshape(-1, 1, t), kern, stride=hop_length)
        out = out.reshape(lead + out.shape[1:])            # (..., 2F, n)
        spec = torch.complex(out[..., :n_freqs, :], out[..., n_freqs:, :])
    else:
        frames = frame_signal(x, fft_length, hop_length)   # (..., n, N)
        cos_m, msin_m = _on(x.device, x.dtype, _dft_matrices, fft_length,
                            onesided)
        spec = torch.complex(frames @ (w[:, None] * cos_m),
                             frames @ (w[:, None] * msin_m)).transpose(-1, -2)

    if normalized:
        spec = spec * (fft_length ** -0.5)
    return spec


@functools.lru_cache(maxsize=32)
def _idft_matrices(fft_length: int):
    """Real inverse-DFT basis ``(n_freqs, fft_length)`` pair for the
    onesided inverse as a matrix product: ``frames = Re(X)@ICr + Im(X)@ICi``
    with the conjugate-symmetry weights and ``1/N`` folded in (float64)."""
    n_freqs = fft_length // 2 + 1
    k = np.arange(n_freqs, dtype=np.float64)[:, None]
    n = np.arange(fft_length, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / fft_length
    w = np.full((n_freqs, 1), 2.0 / fft_length)
    w[0] = 1.0 / fft_length
    if fft_length % 2 == 0:
        w[-1] = 1.0 / fft_length
    return w * np.cos(ang), -w * np.sin(ang)


def _envelope(window_bytes: bytes, hop_length: int, n_frames: int,
              full_length: int, start: int, stop: int) -> np.ndarray:
    """Samples ``start:stop`` of :func:`~.windows.cola_window_sum` of a
    float64 window given as its bytes.  Raises when the window/hop pair
    violates NOLA on that range."""
    env = cola_window_sum(_from_bytes(window_bytes), hop_length, n_frames,
                          full_length)[start:stop]
    if env.size and np.min(env) < 1e-11:
        raise ValueError(
            "window/hop pair violates NOLA on the output range; "
            "istft is not invertible for this configuration")
    return env


def _real_edges(spec: torch.Tensor, fft_length: int) -> torch.Tensor:
    """``spec (..., n_freqs)`` with the imaginary parts of the DC bin and
    (``fft_length`` even, when present) the Nyquist bin set to 0: a real
    inverse has no use for them.  The CPU's ``irfft`` ignores them, cuFFT's
    does not (a spectrum a model writes need not have them 0)."""
    imag = spec.imag.clone()
    imag[..., 0] = 0
    if fft_length % 2 == 0 and spec.shape[-1] == fft_length // 2 + 1:
        imag[..., -1] = 0
    return torch.complex(spec.real, imag)


def istft(stft_matrix: torch.Tensor,
          hop_length: Optional[int] = None,
          win_length: Optional[int] = None,
          window=None,
          center: bool = True,
          normalized: bool = False,
          onesided: bool = True,
          length: Optional[int] = None,
          fft_length: Optional[int] = None,
          method: str = "fft") -> torch.Tensor:
    """Inverse STFT of complex ``stft_matrix (..., n_freqs, n_frames)``.

    The least-squares inverse of ``torch.istft``: per-frame inverse DFT →
    synthesis window → overlap-add → division by the summed squared window.
    Raises ``ValueError`` when the window/hop pair violates NOLA on the
    samples that are kept.  A ``length`` past the reconstructable range is
    zero-padded.  ``method="matmul"`` computes the per-frame inverse as one
    matrix product against the inverse real basis (onesided only), the
    mirror of ``stft(method="matmul")``.
    """
    n_freqs, n_frames = stft_matrix.shape[-2:]
    if fft_length is None:
        fft_length = 2 * (n_freqs - 1) if onesided else n_freqs
    if hop_length is None:
        hop_length = fft_length // 4
    if win_length is None:
        win_length = fft_length

    w64 = _resolve_window(window, win_length, fft_length)
    spec = stft_matrix.transpose(-1, -2)        # (..., n_frames, n_freqs)
    if normalized:
        spec = spec * (fft_length ** 0.5)

    if method == "matmul":
        if not onesided:
            raise ValueError("istft method='matmul' supports onesided only")
        dtype = torch.promote_types(spec.real.dtype, torch.float32)
        icr, ici = _on(spec.device, dtype, _idft_matrices, fft_length)
        frames = spec.real.to(dtype) @ icr + spec.imag.to(dtype) @ ici
    elif method == "fft":
        if onesided:
            frames = torch.fft.irfft(_real_edges(spec, fft_length),
                                     n=fft_length, dim=-1)
        else:
            frames = torch.fft.ifft(spec, n=fft_length, dim=-1).real
    else:
        raise ValueError(f"unknown istft method {method!r}")

    w_bytes = np.ascontiguousarray(w64).tobytes()
    frames = frames * _on(frames.device, frames.dtype, _from_bytes, w_bytes)
    full_length = fft_length + hop_length * (n_frames - 1)
    out = _overlap_add(frames, fft_length, hop_length, full_length)

    start = fft_length // 2 if center else 0
    if length is not None:
        stop = min(start + length, full_length)
    else:
        stop = full_length - start
    out = out[..., start:stop] / _on(
        out.device, out.dtype, _envelope, w_bytes, hop_length, n_frames,
        full_length, start, stop)
    if length is not None and out.shape[-1] < length:
        out = F.pad(out, (0, length - out.shape[-1]))
    return out
