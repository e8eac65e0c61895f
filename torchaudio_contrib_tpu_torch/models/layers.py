"""Layer API: composable transform modules + pipeline factories.

Port of ``torchaudio_contrib_tpu/models/layers.py`` (the mel front end's
layers and the inverse path's: ISTFT, Griffin-Lim, time stretch, resample,
μ-law, bark; the chroma filterbank and chromagram).  Every transform is an ``nn.Module``.  Derived arrays (windows,
filterbanks) are built from the layer's config and held as non-persistent
buffers: they follow ``.to(device)`` but stay out of ``state_dict()``, so
a checkpoint holds only trainable leaves — the JAX package's
``state_dict()`` contract.  A trainable filterbank is an ``nn.Parameter``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.complexops import complex_norm as _complex_norm
from ..ops.db import (amplitude_to_db as _amplitude_to_db,
                      db_to_amplitude as _db_to_amplitude)
from ..ops.filters import apply_filterbank as _apply_filterbank
from ..ops.chroma import create_chroma_filter
from ..ops.filters import create_bark_filter, create_mel_filter
from ..ops.fused import fused_melspectrogram as _fused_mel
from ..ops.griffinlim import griffin_lim as _griffin_lim
from ..ops.mulaw import (mu_law_encoding as _mu_law_encoding,
                         mu_law_decoding as _mu_law_decoding)
from ..ops.phase_vocoder import (phase_vocoder as _phase_vocoder,
                                 compute_phase_advance)
from ..ops.resample import resample as _resample
from ..ops.stft import stft as _stft_fn, istft as _istft_fn, _resolve_window

__all__ = [
    "Transform", "Pipeline",
    "STFT", "ISTFT", "InverseSpectrogram", "ComplexNorm",
    "Filterbank", "MelFilterbank", "BarkFilterbank", "ChromaFilterbank",
    "ApplyFilterbank",
    "AmplitudeToDb", "DbToAmplitude",
    "MuLawEncoding", "MuLawDecoding",
    "Resample", "StretchSpecTime", "GriffinLim",
    "Spectrogram", "Melspectrogram", "Barkspectrogram", "Chromagram",
    "FusedMelspectrogram",
]


class Transform(nn.Module):
    """Base of every transform: an ``nn.Module`` whose derived arrays are
    non-persistent buffers (see :meth:`_derived`)."""

    def _derived(self, name: str, value: torch.Tensor) -> None:
        """Hold ``value`` as a buffer that moves with the module but is not
        serialized."""
        self.register_buffer(name, value, persistent=False)


class STFT(Transform):
    """Short-time Fourier transform layer; the window (padded to
    ``fft_length``) is a derived buffer."""

    def __init__(self, fft_length: int, hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window="hann",
                 center: bool = True, pad_mode: str = "reflect",
                 normalized: bool = False, onesided: bool = True,
                 method: str = "fft"):
        super().__init__()
        self.fft_length = fft_length
        self.hop_length = (hop_length if hop_length is not None
                           else fft_length // 4)
        self.win_length = win_length if win_length is not None else fft_length
        self.window_spec = window
        self.center = center
        self.pad_mode = pad_mode
        self.normalized = normalized
        self.onesided = onesided
        self.method = method
        self._derived("window", torch.as_tensor(
            _resolve_window(window, self.win_length, fft_length),
            dtype=torch.float32))

    @property
    def num_freqs(self) -> int:
        return self.fft_length // 2 + 1 if self.onesided else self.fft_length

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        return _stft_fn(waveform, self.fft_length, self.hop_length,
                        self.win_length, self.window, self.center,
                        self.pad_mode, self.normalized, self.onesided,
                        method=self.method)


class ISTFT(Transform):
    """Inverse STFT layer over :func:`~..ops.stft.istft`."""

    def __init__(self, fft_length: Optional[int] = None,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window="hann",
                 center: bool = True, normalized: bool = False,
                 onesided: bool = True, length: Optional[int] = None):
        super().__init__()
        self.fft_length = fft_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.window = window
        self.center = center
        self.normalized = normalized
        self.onesided = onesided
        self.length = length

    def forward(self, stft_matrix: torch.Tensor) -> torch.Tensor:
        return _istft_fn(stft_matrix, self.hop_length, self.win_length,
                         self.window, self.center, self.normalized,
                         self.onesided, self.length, self.fft_length)


class InverseSpectrogram(ISTFT):
    """torchaudio-named alias of :class:`ISTFT` (complex spectrogram →
    waveform; ``transforms.InverseSpectrogram``)."""


class ComplexNorm(Transform):
    """Magnitude/power of a complex spectrogram."""

    def __init__(self, power: float = 1.0):
        super().__init__()
        self.power = power

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        return _complex_norm(spec, self.power)


class Filterbank(Transform):
    """Filterbank provider: subclasses build a ``(num_bins, num_banks)``
    matrix into the derived buffer ``filterbank``; calling the layer
    applies it."""

    def get_filterbank(self) -> torch.Tensor:
        return self.filterbank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _apply_filterbank(x, self.filterbank)


class MelFilterbank(Filterbank):
    """Triangular mel filterbank, built in float64 from config (HTK scale,
    no normalization by default; ``mel_scale="slaney"``/``norm="slaney"``
    select the librosa-default variant)."""

    def __init__(self, num_mels: int = 128, sample_rate: float = 22050,
                 f_min: float = 0.0, f_max: Optional[float] = None,
                 num_bins: int = 1025, mel_scale: str = "htk",
                 norm: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_mels = num_mels
        self.sample_rate = sample_rate
        self.f_min = f_min
        self.f_max = f_max if f_max is not None else sample_rate / 2.0
        self.num_bins = num_bins
        self.mel_scale = mel_scale
        self.norm = norm
        self._derived("filterbank", create_mel_filter(
            num_mels, sample_rate, f_min, self.f_max, num_bins,
            mel_scale=mel_scale, norm=norm, dtype=dtype))


class BarkFilterbank(Filterbank):
    """Triangular Bark-scale filterbank (torchaudio's ``barkscale_fbanks``
    capability), with the same splice points as :class:`MelFilterbank`."""

    def __init__(self, n_barks: int = 128, sample_rate: float = 22050,
                 f_min: float = 0.0, f_max: Optional[float] = None,
                 num_bins: int = 1025, bark_scale: str = "traunmuller",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_barks = n_barks
        self.sample_rate = sample_rate
        self.f_min = f_min
        self.f_max = f_max if f_max is not None else sample_rate / 2.0
        self.num_bins = num_bins
        self.bark_scale = bark_scale
        self._derived("filterbank", create_bark_filter(
            n_barks, sample_rate, f_min, self.f_max, num_bins,
            bark_scale=bark_scale, dtype=dtype))


class ChromaFilterbank(Filterbank):
    """Gaussian pitch-class filterbank (librosa's design,
    :func:`~..ops.chroma.create_chroma_filter`), with the same splice
    points as :class:`MelFilterbank`: into a :func:`Spectrogram` pipeline
    through :class:`ApplyFilterbank` (trainable too) for a chromagram."""

    def __init__(self, n_chroma: int = 12, sample_rate: float = 22050,
                 num_bins: int = 1025, tuning: float = 0.0,
                 base_c: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_chroma = n_chroma
        self.sample_rate = sample_rate
        self.num_bins = num_bins
        self.tuning = tuning
        self.base_c = base_c
        self._derived("filterbank", create_chroma_filter(
            n_chroma, sample_rate, num_bins, tuning=tuning, base_c=base_c,
            dtype=dtype))


class ApplyFilterbank(Transform):
    """Project ``(..., freq, time)`` through a filterbank matrix.

    ``filterbank`` is a :class:`Filterbank` or a ``(freq, banks)`` array.
    ``trainable=True`` makes the matrix an ``nn.Parameter`` (the only
    entry of this layer's ``state_dict()``); otherwise it is a derived
    buffer."""

    def __init__(self, filterbank, trainable: bool = False):
        super().__init__()
        if isinstance(filterbank, Filterbank):
            fb = filterbank.get_filterbank()
        else:
            fb = torch.as_tensor(filterbank)
        fb = fb.detach().clone()
        self.trainable = trainable
        if trainable:
            self.filterbank = nn.Parameter(fb)
        else:
            self._derived("filterbank", fb)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _apply_filterbank(x, self.filterbank)


class AmplitudeToDb(Transform):
    def __init__(self, ref: float = 1.0, amin: float = 1e-7,
                 power: float = 1.0):
        super().__init__()
        self.ref, self.amin, self.power = ref, amin, power

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _amplitude_to_db(x, self.ref, self.amin, self.power)


class DbToAmplitude(Transform):
    def __init__(self, ref: float = 1.0, power: float = 1.0):
        super().__init__()
        self.ref, self.power = ref, power

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _db_to_amplitude(x, self.ref, self.power)


class MuLawEncoding(Transform):
    def __init__(self, n_quantize: int = 256):
        super().__init__()
        self.n_quantize = n_quantize

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _mu_law_encoding(x, self.n_quantize)


class MuLawDecoding(Transform):
    def __init__(self, n_quantize: int = 256):
        super().__init__()
        self.n_quantize = n_quantize

    def forward(self, x_mu: torch.Tensor) -> torch.Tensor:
        return _mu_law_decoding(x_mu, self.n_quantize)


class Resample(Transform):
    """Rational-ratio polyphase resampler layer
    (:func:`~..ops.resample.resample`)."""

    def __init__(self, orig_freq: int, new_freq: int, zeros: int = 24,
                 beta: float = 14.769656459379492):
        super().__init__()
        self.orig_freq = orig_freq
        self.new_freq = new_freq
        self.zeros = zeros
        self.beta = beta

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        return _resample(waveform, self.orig_freq, self.new_freq,
                         self.zeros, self.beta)


class StretchSpecTime(Transform):
    """Phase-vocoder time stretch; the phase advance derives from config.
    ``rate=`` at call time overrides the layer's."""

    def __init__(self, rate: float, hop_length: int = 512,
                 num_freqs: int = 1025):
        super().__init__()
        self.rate = rate
        self.hop_length = hop_length
        self.num_freqs = num_freqs
        self._derived("phase_advance",
                      compute_phase_advance(num_freqs, hop_length))

    def forward(self, spec: torch.Tensor,
                rate: Optional[float] = None) -> torch.Tensor:
        return _phase_vocoder(spec, rate if rate is not None else self.rate,
                              self.phase_advance)


class GriffinLim(Transform):
    """Griffin-Lim phase-reconstruction layer
    (:func:`~..ops.griffinlim.griffin_lim`).  The call takes a magnitude
    spectrogram ``(..., freq, time)`` and an optional ``generator=`` for a
    random initial phase, where the JAX package's layer takes ``key=``."""

    def __init__(self, fft_length: Optional[int] = None,
                 hop_length: Optional[int] = None, window="hann",
                 n_iter: int = 32, momentum: float = 0.99,
                 length: Optional[int] = None, center: bool = True,
                 method: str = "fft"):
        super().__init__()
        self.fft_length = fft_length
        self.hop_length = hop_length
        self.window = window
        self.n_iter = n_iter
        self.momentum = momentum
        self.length = length
        self.center = center
        self.method = method

    def forward(self, mag_specgrams: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return _griffin_lim(mag_specgrams, self.fft_length, self.hop_length,
                            self.window, self.n_iter, self.momentum,
                            self.length, self.center, generator, self.method)


class Pipeline(nn.Sequential, Transform):
    """Sequential composition.  Indexing gives a stage, iteration walks the
    stages, and slicing gives a ``Pipeline`` of the selected stages, so a
    custom stage (e.g. a trainable filterbank) can be spliced in.  Stage
    ``i``'s parameters appear in ``state_dict()`` under ``"{i}."``."""


class FusedMelspectrogram(Transform):
    """Single-kernel log-mel transform: the same STFT→|·|²→mel[→dB] chain
    as ``Melspectrogram(...)`` + ``AmplitudeToDb`` as one CUDA kernel on
    the GPU (:func:`~..ops.fused.fused_melspectrogram`; its plain version
    on the CPU).  Default ``center=False`` frame semantics;
    ``center=True`` pads for frame-for-frame parity with the
    ``Melspectrogram()`` pipeline.  ``trainable=True`` makes the
    filterbank an ``nn.Parameter``; its gradient (and the waveform's, when
    that requires grad) runs through the backward kernel on the GPU and
    through autograd of the plain version on the CPU.  ``power`` other
    than 2 computes the plain chain on the input's device, the GPU
    included, and launches no kernel (the JAX package's rule)."""

    def __init__(self, num_mels: int = 128, sample_rate: float = 22050,
                 f_min: float = 0.0, f_max: Optional[float] = None,
                 fft_length: int = 2048, hop_length: int = 512,
                 window="hann", power: float = 2.0, to_db: bool = True,
                 db_ref: float = 1.0, amin: float = 1e-7,
                 precision: str = "auto", trainable: bool = False,
                 win_length: Optional[int] = None, center: bool = False,
                 pad_mode: str = "reflect"):
        super().__init__()
        self.num_mels = num_mels
        self.sample_rate = sample_rate
        self.f_min = f_min
        self.f_max = f_max if f_max is not None else sample_rate / 2.0
        self.fft_length = fft_length
        self.hop_length = hop_length
        self.window = window
        self.power = power
        self.to_db = to_db
        self.db_ref = db_ref
        self.amin = amin
        self.precision = precision
        self.trainable = trainable
        self.win_length = win_length
        self.center = center
        self.pad_mode = pad_mode
        fb = create_mel_filter(num_mels, sample_rate, f_min, self.f_max,
                               fft_length // 2 + 1)
        if trainable:
            self.filterbank = nn.Parameter(fb)
        else:
            self._derived("filterbank", fb)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        return _fused_mel(waveform, self.filterbank, self.fft_length,
                          self.hop_length, self.window, self.power,
                          self.to_db, self.db_ref, self.amin,
                          self.precision, self.win_length,
                          center=self.center, pad_mode=self.pad_mode)


def Spectrogram(power: float = 1.0, **stft_kwargs) -> Pipeline:
    """``Pipeline(STFT, ComplexNorm(power))`` factory."""
    fft_length = stft_kwargs.pop("fft_length", 2048)
    return Pipeline(STFT(fft_length, **stft_kwargs), ComplexNorm(power))


def Melspectrogram(num_mels: int = 128,
                   sample_rate: float = 22050,
                   f_min: float = 0.0,
                   f_max: Optional[float] = None,
                   num_bins: Optional[int] = None,
                   filterbank: Optional[Filterbank] = None,
                   trainable: bool = False,
                   fused: bool = False,
                   **spectrogram_kwargs) -> Pipeline:
    """``Pipeline(STFT, ComplexNorm(2), ApplyFilterbank)`` factory.

    ``power`` defaults to 2; pass a custom ``filterbank`` to swap scales,
    or ``trainable=True`` to make the mel matrix a parameter.
    ``fused=True`` returns the same computation as a one-stage
    ``Pipeline(FusedMelspectrogram)`` with the same (center=True by
    default) frame semantics; it requires the built-in mel filterbank,
    ``power=2`` and default ``normalized``/``onesided``, and raises at
    construction otherwise, so a fused pipeline always launches the kernel
    on a CUDA tensor.
    """
    power = spectrogram_kwargs.pop("power", 2.0)
    spec = Spectrogram(power=power, **spectrogram_kwargs)
    stft_layer: STFT = spec[0]
    if num_bins is None:
        num_bins = stft_layer.num_freqs
    elif num_bins != stft_layer.num_freqs:
        raise ValueError(
            f"num_bins={num_bins} inconsistent with STFT num_freqs="
            f"{stft_layer.num_freqs}")
    if fused:
        if power != 2.0:
            raise ValueError("fused=True requires power=2")
        if stft_layer.normalized or not stft_layer.onesided:
            raise ValueError("fused=True supports default normalized/"
                             "onesided semantics only")
        if filterbank is not None:
            raise ValueError("fused=True supports the built-in mel "
                             "filterbank only (splice a custom one into "
                             "the non-fused Pipeline instead)")
        return Pipeline(FusedMelspectrogram(
            num_mels=num_mels, sample_rate=sample_rate, f_min=f_min,
            f_max=f_max, fft_length=stft_layer.fft_length,
            hop_length=stft_layer.hop_length,
            win_length=stft_layer.win_length, window=stft_layer.window_spec,
            center=stft_layer.center, pad_mode=stft_layer.pad_mode,
            power=2.0, to_db=False, trainable=trainable))
    if filterbank is None:
        filterbank = MelFilterbank(num_mels=num_mels,
                                   sample_rate=sample_rate, f_min=f_min,
                                   f_max=f_max, num_bins=num_bins)
    return Pipeline(*spec, ApplyFilterbank(filterbank, trainable=trainable))


def Barkspectrogram(n_barks: int = 128,
                    sample_rate: float = 22050,
                    f_min: float = 0.0,
                    f_max: Optional[float] = None,
                    bark_scale: str = "traunmuller",
                    trainable: bool = False,
                    **spectrogram_kwargs) -> Pipeline:
    """``Pipeline(STFT, ComplexNorm(2), ApplyFilterbank(bark))`` factory
    (torchaudio's ``BarkSpectrogram`` capability): the
    :func:`Melspectrogram` shape with a Bark-scale bank."""
    power = spectrogram_kwargs.pop("power", 2.0)
    spec = Spectrogram(power=power, **spectrogram_kwargs)
    fb = BarkFilterbank(n_barks=n_barks, sample_rate=sample_rate,
                        f_min=f_min, f_max=f_max,
                        num_bins=spec[0].num_freqs, bark_scale=bark_scale)
    return Pipeline(*spec, ApplyFilterbank(fb, trainable=trainable))


def Chromagram(n_chroma: int = 12,
               sample_rate: float = 22050,
               tuning: float = 0.0,
               base_c: bool = True,
               trainable: bool = False,
               **spectrogram_kwargs) -> Pipeline:
    """``Pipeline(STFT, ComplexNorm(2), ApplyFilterbank(chroma))`` factory
    (torchaudio's ``ChromaSpectrogram`` capability)."""
    power = spectrogram_kwargs.pop("power", 2.0)
    spec = Spectrogram(power=power, **spectrogram_kwargs)
    fb = ChromaFilterbank(n_chroma=n_chroma, sample_rate=sample_rate,
                          num_bins=spec[0].num_freqs, tuning=tuning,
                          base_c=base_c)
    return Pipeline(*spec, ApplyFilterbank(fb, trainable=trainable))
