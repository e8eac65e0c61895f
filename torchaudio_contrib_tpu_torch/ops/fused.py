"""Fused (log-)mel spectrogram: one CUDA kernel from waveform to log-mel.

Port of ``torchaudio_contrib_tpu/ops/fused.py`` (forward).  On a CUDA
tensor, :func:`fused_melspectrogram` launches the hand-written Hopper
kernel ``csrc/fused_mel_fwd.cu`` (built by :mod:`._cuda` on first use),
which frames the waveform, multiplies by the windowed DFT basis, forms the
power, applies the filterbank and the dB epilogue without writing the
spectrum to device memory.  On a CPU tensor it runs :func:`_reference`,
the plain PyTorch chain the kernel computes.  There is no other fallback:
a CUDA tensor the kernel cannot take raises.

``KERNEL_LAUNCHES`` counts the kernel's launches (and nothing else), so a
run can show that it went through the kernel.

The backward kernel is not ported yet (ROADMAP A2): on CUDA, a call that
would need gradients raises ``NotImplementedError``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _cuda
from .complexops import complex_norm
from .db import amplitude_to_db
from .filters import apply_filterbank
from .stft import stft, _dft_matrices, _pad_center, _resolve_window

__all__ = ["fused_melspectrogram", "fused_mel_supported",
           "resolve_precision"]

KERNEL_LAUNCHES = 0

_PRECISIONS = ("fast", "split3", "split6")

# Tile constants of csrc/fused_mel_fwd.cu; the basis and the filterbank are
# laid out for them here, and they are checked against the built library.
_FRAME_TILE = 64    # frames per thread block
_FREQ_TILE = 64     # onesided bins per frequency tile
_K_TILE = 16        # fft samples per K step (basis rows pad to this)
_MEL_TILE = 64      # mel columns per step (filterbank columns pad to this)
_MAX_MELS = 704     # the (frames, mels) accumulator must fit shared memory
_MAX_STREAMS = 65535  # grid.y

_LN10_INV_10 = 10.0 / math.log(10.0)


def resolve_precision(precision: str, fft_length: int,
                      num_mels: int) -> str:
    """Resolve ``"auto"`` to a concrete tier for this config, as the JAX
    package does: ``split6`` when mel bands average fewer than 8 linear
    bins, else ``split3``; an explicit tier passes through; anything else
    raises.  On the GPU every tier runs the same FP32 kernel (see
    :func:`fused_melspectrogram`)."""
    if precision == "auto":
        return ("split6" if (fft_length // 2 + 1) < 8 * num_mels
                else "split3")
    if precision not in _PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}: expected 'auto', "
            f"'split6', 'split3', or 'fast'")
    return precision


def fused_mel_supported(fft_length: int, hop_length: int) -> bool:
    """True when the kernel covers this config: any ``fft_length >= 2``
    and any positive hop (frames are read from the waveform at any
    stride; ragged edges are masked in the kernel)."""
    return fft_length >= 2 and hop_length > 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def _hashable_window(window):
    if window is None or isinstance(window, str):
        return window
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().double().numpy()
    return tuple(np.asarray(window, dtype=np.float64).ravel().tolist())


@functools.lru_cache(maxsize=16)
def _basis_np(fft_length: int, win_key, win_length):
    """Windowed onesided DFT basis, built in float64 and cast to float32:
    ``(round_up(fft, K_TILE), FT·2·FREQ_TILE)`` with tile ``t`` columns
    ``[w·cos_t | −w·sin_t]``.  ``win_length < fft_length`` zero-pads and
    centres the window; bins past ``fft//2+1`` and rows past ``fft`` are
    zero, so the kernel's padded lanes contribute nothing."""
    n_freqs = fft_length // 2 + 1
    ft_count = _cdiv(n_freqs, _FREQ_TILE)
    f_pad = ft_count * _FREQ_TILE
    if win_length is None:
        win_length = fft_length
    w = _resolve_window(win_key, win_length, fft_length)[:, None]
    cos_m, msin_m = _dft_matrices(fft_length, True)
    pad = ((0, _round_up(fft_length, _K_TILE) - fft_length),
           (0, f_pad - n_freqs))
    wr = np.pad(w * cos_m, pad)
    wi = np.pad(w * msin_m, pad)
    tiles = []
    for t in range(ft_count):
        s = slice(t * _FREQ_TILE, (t + 1) * _FREQ_TILE)
        tiles.append(np.concatenate([wr[:, s], wi[:, s]], axis=1))
    basis = np.concatenate(tiles, axis=1).astype(np.float32)
    return basis, n_freqs, ft_count


@functools.lru_cache(maxsize=16)
def _basis_on(device: torch.device, fft_length: int, win_key, win_length):
    """:func:`_basis_np` copied to ``device`` once per config."""
    basis, n_freqs, ft_count = _basis_np(fft_length, win_key, win_length)
    return torch.from_numpy(basis).to(device), n_freqs, ft_count


@functools.lru_cache(maxsize=1)
def _kernel_lib():
    lib = _cuda.load()
    tiles = tuple(lib.tac_fused_mel_fwd_tile(i) for i in range(4))
    if tiles != (_FRAME_TILE, _FREQ_TILE, _K_TILE, _MEL_TILE):
        raise RuntimeError(f"kernel tiles {tiles} do not match the host "
                           f"layout {(_FRAME_TILE, _FREQ_TILE, _K_TILE, _MEL_TILE)}")
    return lib


def _reference(waveform, filterbank, fft_length, hop_length, window, power,
               to_db, db_ref, amin, win_length=None):
    """The plain PyTorch version of the kernel: stft(center=False) →
    |·|^power → mel → dB, as the JAX package's ``_jnp_reference``."""
    spec = stft(waveform, fft_length, hop_length, win_length=win_length,
                window=window, center=False)
    mel = apply_filterbank(complex_norm(spec, power), filterbank)
    if to_db:
        mel = amplitude_to_db(mel, ref=db_ref, amin=amin, power=power)
    return mel


def _fused_mel_fwd_cuda(x2, filterbank, fft_length, hop_length, window,
                        win_length, to_db, db_ref, amin):
    """Launch the kernel on ``x2 (streams, T)``; returns
    ``(streams, num_mels, n_frames)``.  Raises on any input it does not
    take; never computes the result another way."""
    global KERNEL_LAUNCHES
    if not (x2.is_cuda and x2.dtype == torch.float32 and x2.ndim == 2
            and x2.is_contiguous()):
        raise ValueError("kernel input must be a contiguous float32 CUDA "
                         f"tensor (streams, T); got {x2.dtype} "
                         f"{tuple(x2.shape)} on {x2.device}")
    if not (filterbank.device == x2.device
            and filterbank.dtype == torch.float32 and filterbank.ndim == 2):
        raise ValueError("filterbank must be a float32 (bins, mels) tensor "
                         f"on {x2.device}; got {filterbank.dtype} "
                         f"{tuple(filterbank.shape)} on {filterbank.device}")
    streams, n_samples = x2.shape
    num_mels = filterbank.shape[1]
    if num_mels > _MAX_MELS:
        raise ValueError(f"num_mels={num_mels} exceeds the kernel's "
                         f"{_MAX_MELS}")
    if streams > _MAX_STREAMS or n_samples >= 2 ** 31:
        raise ValueError(f"input {tuple(x2.shape)} exceeds the kernel's "
                         f"grid ({_MAX_STREAMS} streams, 2**31 samples)")
    n_frames = 1 + (n_samples - fft_length) // hop_length
    basis, n_freqs, ft_count = _basis_on(
        x2.device, fft_length, _hashable_window(window), win_length)
    m_pad = _round_up(num_mels, _MEL_TILE)
    fbp = torch.zeros((ft_count * _FREQ_TILE, m_pad), dtype=torch.float32,
                      device=x2.device)
    fbp[:n_freqs, :num_mels] = filterbank
    out = torch.empty((streams, num_mels, n_frames), dtype=torch.float32,
                      device=x2.device)
    db_off = _LN10_INV_10 * math.log(max(amin, db_ref)) if to_db else 0.0
    lib = _kernel_lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.tac_fused_mel_fwd(
            x2.data_ptr(), basis.data_ptr(), fbp.data_ptr(), out.data_ptr(),
            streams, n_samples, fft_length, hop_length, n_frames, ft_count,
            num_mels, m_pad, int(to_db), float(amin), float(db_off), stream)
    if rc != 0:
        raise RuntimeError("fused mel forward kernel failed to launch: "
                           f"{lib.tac_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    KERNEL_LAUNCHES += 1
    return out


def fused_melspectrogram(waveform: torch.Tensor,
                         filterbank: torch.Tensor,
                         fft_length: int = 2048,
                         hop_length: int = 512,
                         window="hann",
                         power: float = 2.0,
                         to_db: bool = True,
                         db_ref: float = 1.0,
                         amin: float = 1e-7,
                         precision: str = "auto",
                         win_length=None,
                         center: bool = False,
                         pad_mode: str = "reflect") -> torch.Tensor:
    """Mel (or log-mel) spectrogram of ``waveform (..., T)`` as one fused
    kernel.

    ``filterbank`` is ``(fft_length//2+1, num_mels)`` (e.g. from
    :func:`~torchaudio_contrib_tpu_torch.ops.create_mel_filter`).  Returns
    ``(..., num_mels, n_frames)`` with ``n_frames = 1 + (T − fft)//hop``
    (trailing samples that fill no frame are dropped).

    ``precision`` is resolved and validated as in the JAX package
    (:func:`resolve_precision`), but every tier runs the same kernel, whose
    products are FP32 FMAs: ``split3``, ``split6`` and ``auto`` get at
    least the accuracy they promise, and ``fast`` gets f32-grade output
    rather than bf16-grade.

    ``center=True`` reflect-pads (``pad_mode``) by ``fft_length//2`` on
    both sides before the kernel, for frame-for-frame parity with the
    ``Melspectrogram()`` pipeline.

    On a CPU tensor this runs the plain chain (:func:`_reference`), with
    autograd.  On a CUDA tensor it launches the kernel: ``power`` must be
    2, and gradients are not available yet (the backward kernel is ROADMAP
    A2), so run it under ``torch.inference_mode()`` or ``torch.no_grad()``.
    """
    precision = resolve_precision(precision, fft_length,
                                  filterbank.shape[-1])
    if not fused_mel_supported(fft_length, hop_length):
        raise ValueError(f"unsupported fft_length={fft_length} / "
                         f"hop_length={hop_length}")
    n_freqs = fft_length // 2 + 1
    if filterbank.ndim != 2 or filterbank.shape[0] != n_freqs:
        raise ValueError(f"filterbank must have {n_freqs} rows, got "
                         f"{tuple(filterbank.shape)}")
    if waveform.device != filterbank.device:
        raise ValueError(f"waveform on {waveform.device} but filterbank on "
                         f"{filterbank.device}")
    if center:
        waveform = _pad_center(waveform, fft_length // 2, pad_mode)
    n_samples = waveform.shape[-1]
    if n_samples < fft_length:
        raise ValueError(f"input too short: {n_samples} < "
                         f"fft_length={fft_length}")
    if waveform.device.type == "cpu":
        return _reference(waveform, filterbank, fft_length, hop_length,
                          window, power, to_db, db_ref, amin, win_length)
    if waveform.device.type != "cuda":
        raise ValueError(f"unsupported device {waveform.device}")
    if power != 2.0:
        raise ValueError("the fused kernel computes power=2 only; use "
                         "melspectrogram() for other powers")
    if torch.is_grad_enabled() and (waveform.requires_grad
                                    or filterbank.requires_grad):
        raise NotImplementedError(
            "gradients through fused_melspectrogram on CUDA need the "
            "backward kernel, which is not ported yet (ROADMAP A2); run "
            "the forward under torch.inference_mode() or use the "
            "Melspectrogram() pipeline for training")
    lead = waveform.shape[:-1]
    x2 = waveform.reshape(-1, n_samples).to(torch.float32).contiguous()
    out = _fused_mel_fwd_cuda(x2, filterbank.to(torch.float32), fft_length,
                              hop_length, window, win_length, to_db,
                              db_ref, amin)
    return out.reshape(lead + out.shape[1:])
