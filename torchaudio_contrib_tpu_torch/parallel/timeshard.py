"""Time-sharded STFT and mel: the time axis of one long recording split over
a mesh axis.

Port of ``torchaudio_contrib_tpu/parallel/timeshard.py``.  Each rank
computes the frames that start in its chunk of the recording; a frame that
straddles the boundary needs the right neighbour's leading ``fft − hop``
samples, one halo exchange per call (:func:`._comm.halo_from_right`, zeros
on the last rank).  Window, transform, mel product and dB are frame-local.
``center=False`` framing; the recording must split into hop-aligned shards
(pad the tail), and the last rank drops the trailing frames that used its
zero halo, exactly the frames a one-shot ``stft(center=False)`` does not
produce.

``waveform`` is either the whole recording (each rank takes its chunk) or a
DTensor sharded on its last dim (each rank's local chunk).  The result is
this rank's frames as a plain tensor ``(..., F or mels, frames_here)``:
the shards are uneven (the last is shorter), which a DTensor's even split
cannot state.  ``use_fused=True`` runs the fused log-mel kernel (B1) on
the haloed shard, which is its ``center=False`` input; a CUDA tensor
launches the kernel or raises, and never takes the chain in its place.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from ..ops.complexops import complex_norm
from ..ops.db import amplitude_to_db
from ..ops.filters import apply_filterbank, create_mel_filter
from ..ops.fused import fused_melspectrogram
from ..ops.stft import stft as _stft
from ._comm import axis_group, halo_from_right

__all__ = ["time_sharded_stft", "time_sharded_melspectrogram"]


def _shard_frames(xl, group, fft_length, hop_length, window, win_length, fb,
                  to_db, power, use_fused=False, precision="auto"):
    halo = halo_from_right(xl, fft_length - hop_length, group)
    xbuf = torch.cat([xl, halo], dim=-1)
    if fb is not None and use_fused:
        return fused_melspectrogram(xbuf, fb, fft_length, hop_length,
                                    window, power, to_db,
                                    precision=precision,
                                    win_length=win_length)
    spec = _stft(xbuf, fft_length, hop_length, win_length=win_length,
                 window=window, center=False)
    if fb is None:
        return spec
    mel = apply_filterbank(complex_norm(spec, power), fb)
    if to_db:
        mel = amplitude_to_db(mel, power=power)
    return mel


def _run(waveform, mesh, axis, fft_length, hop_length, window, win_length,
         fb, to_db, power, use_fused=False, precision="auto"):
    group, r, S = axis_group(mesh, axis)
    T = waveform.shape[-1]
    if T % (S * hop_length) != 0:
        raise ValueError(
            f"time length {T} must divide into {S} hop-aligned shards "
            f"(multiple of {S * hop_length}); zero-pad the tail")
    if T // S < fft_length - hop_length:
        raise ValueError(
            f"per-shard length {T // S} is shorter than the halo "
            f"(fft_length - hop_length = {fft_length - hop_length}); "
            f"use fewer shards or longer clips — frames spanning "
            "more than two shards are not representable")
    n_frames = 1 + (T - fft_length) // hop_length
    if isinstance(waveform, DTensor):
        xl = waveform.to_local()
    else:
        xl = waveform[..., r * (T // S):(r + 1) * (T // S)]
    out = _shard_frames(xl, group, fft_length, hop_length, window,
                        win_length, fb, to_db, power, use_fused, precision)
    per = T // S // hop_length
    keep = max(min(n_frames - r * per, per), 0)
    return out[..., :keep]


def time_sharded_stft(waveform: torch.Tensor, mesh, axis: str = "data",
                      fft_length: int = 2048, hop_length: int = 512,
                      window="hann",
                      win_length: Optional[int] = None) -> torch.Tensor:
    """STFT of ``waveform (..., T)`` with time split over ``mesh[axis]``:
    this rank's complex frames ``(..., n_freqs, frames_here)``; one halo
    exchange is the only collective.  ``center=False``."""
    return _run(waveform, mesh, axis, fft_length, hop_length, window,
                win_length, None, False, 2.0)


def time_sharded_melspectrogram(waveform: torch.Tensor, mesh,
                                axis: str = "data",
                                num_mels: int = 128,
                                sample_rate: float = 22050,
                                f_min: float = 0.0,
                                f_max: Optional[float] = None,
                                fft_length: int = 2048,
                                hop_length: int = 512,
                                window="hann",
                                to_db: bool = True,
                                power: float = 2.0,
                                use_fused: bool = False,
                                precision: str = "auto") -> torch.Tensor:
    """(Log-)mel of a long ``(..., T)`` recording with time split over
    ``mesh[axis]``: halo → frames → transform → mel → dB on each rank.
    ``use_fused=True`` runs each shard through the fused kernel
    (``precision`` as in :func:`~..ops.fused.fused_melspectrogram`)."""
    device = (waveform.to_local() if isinstance(waveform, DTensor)
              else waveform).device
    fb = create_mel_filter(num_mels, sample_rate, f_min, f_max,
                           fft_length // 2 + 1, device=device)
    return _run(waveform, mesh, axis, fft_length, hop_length, window,
                None, fb, to_db, power, use_fused, precision)
