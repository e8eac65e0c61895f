"""``torchaudio.functional``-shaped namespace.

The port of the JAX package's ``functional``: a migration alias so code
written as ``import torchaudio.functional as F`` ports by changing only the
package name.  It has the JAX module's ``__all__``.  Most names are the
same objects as the flat package exports; semantics live with the
implementations in :mod:`.ops`.  Five functions whose house signatures
diverge from torchaudio's get thin argument adapters below
(``spectrogram``, ``griffinlim``, ``pitch_shift``, ``spectral_centroid``,
``lfilter``).  RNG-consuming functions (``mask_along_axis``,
``mask_along_axis_iid``, ``dither``) keep the port's generator-first
signatures: pass a ``torch.Generator`` (or None for the global one) where
the JAX package takes a key.  ``spectrogram``'s ``normalized`` follows
torchaudio, not the JAX package (which scales ``True``/``"window"`` by
``1/sqrt(n_fft)``): ``True``/``"window"`` divides by the window's L2 norm.
"""

from typing import Optional

import numpy as np
import torch

from .ops import (
    # spectral
    inverse_spectrogram, phase_vocoder,
    melscale_fbanks, linear_fbanks, barkscale_fbanks, chroma_filterbank,
    create_dct, amplitude_to_DB, DB_to_amplitude,
    mask_along_axis, mask_along_axis_iid,
    # codecs / companding
    mu_law_encoding, mu_law_decoding, apply_codec,
    # resampling / time
    resample, speed,
    # features
    compute_deltas, detect_pitch_frequency,
    sliding_window_cmn, compute_kaldi_pitch, loudness,
    # waveform utilities
    preemphasis, deemphasis, gain, dither, dcshift, add_noise,
    convolve, fftconvolve, vad,
    # filtering
    filtfilt, biquad, allpass_biquad, band_biquad,
    bandpass_biquad, bandreject_biquad, bass_biquad, deemph_biquad,
    equalizer_biquad, highpass_biquad, lowpass_biquad, riaa_biquad,
    treble_biquad,
    # effects
    overdrive, contrast, phaser, flanger,
    # metrics / losses / alignment
    edit_distance, rnnt_loss, forced_align, merge_tokens, TokenSpan,
    # multichannel
    psd, mvdr_weights_souden, mvdr_weights_rtf, rtf_evd, rtf_power,
    apply_beamforming,
    # room acoustics
    simulate_rir_ism, ray_tracing,
)

from . import ops as _ops
from .ops.stft import _resolve_window


def spectrogram(waveform, pad: int, window, n_fft: int,
                hop_length: int, win_length: int, power,
                normalized, center: bool = True,
                pad_mode: str = "reflect", onesided: bool = True):
    """torchaudio ``functional.spectrogram`` signature adapter over
    :func:`..ops.stft` / :func:`..ops.complex_norm`: ``pad`` zero-pads the
    waveform two-sided, ``power=None`` returns the complex STFT,
    ``normalized`` takes torchaudio's forms: ``True``/``"window"`` divide
    by the window's L2 norm ``sqrt(sum(window**2))``, ``"frame_length"``
    by ``sqrt(win_length)``."""
    if pad:
        waveform = torch.nn.functional.pad(waveform, (pad, pad))
    win_length = win_length or n_fft
    spec = _ops.stft(waveform, n_fft, hop_length, win_length,
                     window=window, center=center, pad_mode=pad_mode,
                     normalized=False, onesided=onesided)
    if normalized is True or normalized == "window":
        w = _resolve_window(window, win_length, n_fft)
        spec = spec / float(np.sqrt(np.sum(w ** 2)))
    elif normalized == "frame_length":
        spec = spec / float(np.sqrt(win_length))
    elif normalized not in (False, None):
        raise ValueError(
            f"normalized must be bool|'window'|'frame_length', "
            f"got {normalized!r}")
    if power is None:
        return spec
    return _ops.complex_norm(spec, power)


def griffinlim(specgram, window, n_fft: int, hop_length: int,
               win_length: int, power: float, n_iter: int,
               momentum: float, length, rand_init: bool, *,
               generator: Optional[torch.Generator] = None):
    """torchaudio ``functional.griffinlim`` signature adapter over
    :func:`..ops.griffin_lim`.  ``specgram`` is a power-``power``
    spectrogram (mapped back to magnitude here).  ``rand_init=True`` draws
    the initial phases from ``generator`` (keyword extension), or from a
    generator seeded 0 when none is given (the JAX package's fixed
    ``PRNGKey(0)``): deterministic by design."""
    if win_length not in (None, n_fft):
        raise NotImplementedError(
            "griffinlim: win_length != n_fft is not supported by the "
            "house kernel path; pass win_length=n_fft")
    if not rand_init:
        generator = None
    elif generator is None:
        generator = torch.Generator().manual_seed(0)
    mag = specgram if power == 1 else specgram ** (1.0 / power)
    return _ops.griffin_lim(mag, n_fft, hop_length, window=window,
                            n_iter=n_iter, momentum=momentum,
                            length=length, generator=generator)


def pitch_shift(waveform, sample_rate: int, n_steps: float,
                bins_per_octave: int = 12, n_fft: int = 512,
                win_length=None, hop_length=None, window=None):
    """torchaudio ``functional.pitch_shift`` signature adapter over
    :func:`..ops.pitch_shift`."""
    if win_length not in (None, n_fft):
        raise NotImplementedError(
            "pitch_shift: win_length != n_fft is not supported; pass "
            "win_length=n_fft")
    hop = hop_length if hop_length is not None else n_fft // 4
    win = window if window is not None else "hann"
    return _ops.pitch_shift(waveform, sample_rate, n_steps,
                            bins_per_octave, n_fft, hop, win)


def spectral_centroid(waveform, sample_rate: float, pad: int, window,
                      n_fft: int, hop_length: int, win_length: int):
    """torchaudio ``functional.spectral_centroid`` signature adapter
    (waveform-in, magnitude STFT inside) over
    :func:`..ops.spectral_centroid`."""
    mag = spectrogram(waveform, pad, window, n_fft, hop_length,
                      win_length, power=1.0, normalized=False)
    return _ops.spectral_centroid(mag, sample_rate)


def lfilter(waveform, a_coeffs, b_coeffs, clamp: bool = True,
            batching: bool = True):
    """torchaudio ``functional.lfilter`` signature adapter over
    :func:`..ops.lfilter` (torchaudio's ``clamp=True`` default; the
    house default is False).  ``batching`` is accepted for signature
    parity; coefficient broadcasting is shape-driven here."""
    del batching
    return _ops.lfilter(waveform, a_coeffs, b_coeffs, clamp=clamp)


__all__ = [
    "spectrogram", "inverse_spectrogram", "griffinlim", "phase_vocoder",
    "melscale_fbanks", "linear_fbanks", "barkscale_fbanks",
    "chroma_filterbank", "create_dct", "amplitude_to_DB",
    "DB_to_amplitude", "mask_along_axis", "mask_along_axis_iid",
    "mu_law_encoding", "mu_law_decoding", "apply_codec",
    "resample", "speed", "pitch_shift",
    "compute_deltas", "detect_pitch_frequency", "spectral_centroid",
    "sliding_window_cmn", "compute_kaldi_pitch", "loudness",
    "preemphasis", "deemphasis", "gain", "dither", "dcshift",
    "add_noise", "convolve", "fftconvolve", "vad",
    "lfilter", "filtfilt", "biquad", "allpass_biquad", "band_biquad",
    "bandpass_biquad", "bandreject_biquad", "bass_biquad",
    "deemph_biquad", "equalizer_biquad", "highpass_biquad",
    "lowpass_biquad", "riaa_biquad", "treble_biquad",
    "overdrive", "contrast", "phaser", "flanger",
    "edit_distance", "rnnt_loss", "forced_align", "merge_tokens",
    "TokenSpan",
    "psd", "mvdr_weights_souden", "mvdr_weights_rtf", "rtf_evd",
    "rtf_power", "apply_beamforming",
    "simulate_rir_ism", "ray_tracing",
]
