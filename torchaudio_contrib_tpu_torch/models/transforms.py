"""torchaudio-named transforms over the port's functional ops.

Port of ``torchaudio_contrib_tpu/models/transforms.py`` for the layers
whose ops the port has: each wraps its op with the JAX layer's arguments
and defaults.  Every transform is an ``nn.Module`` (:class:`Transform`);
derived matrices (filterbanks, windows) are non-persistent buffers built
from the config.  Randomised transforms (``FrequencyMasking``,
``TimeMasking``, ``SpecAugment``, ``SpeedPerturbation``) take an explicit
``generator=`` (a ``torch.Generator``, or None for the global one) in the
call where the JAX layers take ``key=``.

``RNNTLoss`` waits for its op (``rnnt_loss``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .layers import Transform
from .. import ops as _ops

__all__ = [
    "MFCC", "Loudness", "PitchShift", "Speed", "AddNoise",
    "Fade", "Vol", "FrequencyMasking", "TimeMasking",
    "Preemphasis", "Deemphasis", "ComputeDeltas", "SlidingWindowCmn",
    "SpectralCentroid", "MelScale", "InverseMelScale",
    "PSD", "SoudenMVDR", "RTFMVDR", "Vad",
    "Overdrive", "Phaser", "Flanger", "Contrast",
    "Lowpass", "Highpass", "Equalizer",
    "LFCC", "Convolve", "FFTConvolve", "SpeedPerturbation",
    "AmplitudeToDB", "MelSpectrogram", "TimeStretch", "SpecAugment",
    "MVDR",
    "BarkScale", "InverseBarkScale", "BarkSpectrogram",
    "ChromaScale", "ChromaSpectrogram",
]


class MFCC(Transform):
    """Waveform → MFCC (:func:`~..ops.mfcc.mfcc`: DCT-II of the log-mel)."""

    def __init__(self, sample_rate: int = 22050, n_mfcc: int = 40,
                 num_mels: int = 128, fft_length: int = 2048,
                 hop_length: int = 512, **kwargs):
        super().__init__()
        self.kw = dict(sample_rate=sample_rate, n_mfcc=n_mfcc,
                       num_mels=num_mels, fft_length=fft_length,
                       hop_length=hop_length, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.mfcc(x, **self.kw)


class Loudness(Transform):
    """BS.1770-4 integrated loudness (LKFS) per clip."""

    def __init__(self, sample_rate: int):
        super().__init__()
        self.sample_rate = sample_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.loudness(x, self.sample_rate)


class PitchShift(Transform):
    """Shift the pitch by ``n_steps`` semitones at constant duration."""

    def __init__(self, sample_rate: int, n_steps: float,
                 bins_per_octave: int = 12, fft_length: int = 1024,
                 hop_length: int = 256):
        super().__init__()
        self.kw = dict(sample_rate=sample_rate, n_steps=n_steps,
                       bins_per_octave=bins_per_octave,
                       fft_length=fft_length, hop_length=hop_length)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.pitch_shift(x, **self.kw)


class Speed(Transform):
    """Tape-speed change (duration and pitch) by ``factor``."""

    def __init__(self, orig_freq: int, factor: float):
        super().__init__()
        self.orig_freq, self.factor = orig_freq, factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.speed(x, self.orig_freq, self.factor)


class AddNoise(Transform):
    """Mix the given noise at an SNR: ``t(x, noise, snr)``."""

    def forward(self, x: torch.Tensor, noise=None, snr=None,
                lengths=None) -> torch.Tensor:
        if noise is None or snr is None:
            raise TypeError("AddNoise requires noise= and snr=")
        return _ops.add_noise(x, noise, snr, lengths=lengths)


class Fade(Transform):
    def __init__(self, fade_in_len: int = 0, fade_out_len: int = 0,
                 fade_shape: str = "linear"):
        super().__init__()
        self.kw = dict(fade_in_len=fade_in_len, fade_out_len=fade_out_len,
                       fade_shape=fade_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.fade(x, **self.kw)


class Vol(Transform):
    """Volume change, clipped to [-1, 1]; ``gain_type`` is ``amplitude``,
    ``power`` or ``db``."""

    def __init__(self, gain: float, gain_type: str = "amplitude"):
        super().__init__()
        if gain_type == "amplitude":
            if gain < 0:
                raise ValueError("amplitude gain must be non-negative")
            self.gain_db = 20.0 * math.log10(max(gain, 1e-12))
        elif gain_type == "power":
            if gain <= 0:
                raise ValueError("power gain must be positive")
            self.gain_db = 10.0 * math.log10(gain)
        elif gain_type == "db":
            self.gain_db = float(gain)
        else:
            raise ValueError("gain_type must be amplitude|power|db")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(_ops.gain(x, self.gain_db), -1.0, 1.0)


class FrequencyMasking(Transform):
    """SpecAugment frequency mask: ``t(spec, generator=g)``."""

    def __init__(self, freq_mask_param: int, mask_value: float = 0.0):
        super().__init__()
        self.param, self.value = freq_mask_param, mask_value

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return _ops.freq_mask(generator, x, self.param,
                              mask_value=self.value)


class TimeMasking(Transform):
    """SpecAugment time mask: ``t(spec, generator=g)``."""

    def __init__(self, time_mask_param: int, mask_value: float = 0.0):
        super().__init__()
        self.param, self.value = time_mask_param, mask_value

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return _ops.time_mask(generator, x, self.param,
                              mask_value=self.value)


class Preemphasis(Transform):
    def __init__(self, coeff: float = 0.97):
        super().__init__()
        self.coeff = coeff

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.preemphasis(x, self.coeff)


class Deemphasis(Transform):
    def __init__(self, coeff: float = 0.97):
        super().__init__()
        self.coeff = coeff

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.deemphasis(x, self.coeff)


class ComputeDeltas(Transform):
    def __init__(self, win_length: int = 5):
        super().__init__()
        self.win_length = win_length

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.compute_deltas(x, self.win_length)


class SlidingWindowCmn(Transform):
    def __init__(self, cmn_window: int = 600, min_cmn_window: int = 100,
                 center: bool = False, norm_vars: bool = False):
        super().__init__()
        self.kw = dict(cmn_window=cmn_window, min_cmn_window=min_cmn_window,
                       center=center, norm_vars=norm_vars)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.sliding_window_cmn(x, **self.kw)


class SpectralCentroid(Transform):
    """Waveform → per-frame spectral centroid (Hz)."""

    def __init__(self, sample_rate: int, fft_length: int = 400,
                 hop_length: int = 200):
        super().__init__()
        self.sample_rate = sample_rate
        self.fft_length, self.hop_length = fft_length, hop_length

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mag = _ops.complex_norm(_ops.stft(x, self.fft_length,
                                          self.hop_length))
        return _ops.spectral_centroid(mag, self.sample_rate)


class MelScale(Transform):
    """Linear-magnitude spectrogram ``(..., F, T)`` → mel ``(...,
    n_mels, T)``: the filterbank product alone (torchaudio's
    ``transforms.MelScale``)."""

    def __init__(self, num_mels: int = 128, sample_rate: int = 22050,
                 f_min: float = 0.0, f_max: Optional[float] = None,
                 num_bins: int = 201, mel_scale: str = "htk",
                 norm: Optional[str] = None):
        super().__init__()
        self._derived("filterbank", _ops.create_mel_filter(
            num_mels, sample_rate, f_min, f_max, num_bins,
            mel_scale=mel_scale, norm=norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.apply_filterbank(x, self.filterbank)


class InverseMelScale(Transform):
    """Mel spectrogram → linear spectrogram (the closed-form ridge
    pseudo-inverse, clipped at 0)."""

    def __init__(self, num_bins: int, num_mels: int = 128,
                 sample_rate: int = 22050, f_min: float = 0.0,
                 f_max: Optional[float] = None, ridge: float = 1e-8):
        super().__init__()
        self._derived("inverse", _ops.create_inverse_mel_filter(
            num_mels, sample_rate, f_min, f_max, num_bins, ridge))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.mel_to_linear(x, self.inverse)


class PSD(Transform):
    """Multichannel spectrogram → PSD stack: ``t(spec, mask=mask)``."""

    def __init__(self, normalize: bool = True, eps: float = 1e-10):
        super().__init__()
        self.normalize, self.eps = normalize, eps

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        return _ops.psd(x, mask, self.normalize, self.eps)


class SoudenMVDR(Transform):
    """``t(spec, psd_s, psd_n)`` → enhanced single-channel spectrogram."""

    def __init__(self, reference_channel: int = 0,
                 diagonal_loading: bool = True, diag_eps: float = 1e-7):
        super().__init__()
        self.kw = dict(reference_channel=reference_channel,
                       diagonal_loading=diagonal_loading, diag_eps=diag_eps)

    def forward(self, x: torch.Tensor, psd_s=None, psd_n=None):
        if psd_s is None or psd_n is None:
            raise TypeError("SoudenMVDR requires psd_s= and psd_n=")
        w = _ops.mvdr_weights_souden(psd_s, psd_n, **self.kw)
        return _ops.apply_beamforming(w, x)


class RTFMVDR(Transform):
    """``t(spec, rtf, psd_n)`` → enhanced single-channel spectrogram."""

    def __init__(self, reference_channel: int = 0,
                 diagonal_loading: bool = True, diag_eps: float = 1e-7):
        super().__init__()
        self.kw = dict(reference_channel=reference_channel,
                       diagonal_loading=diagonal_loading, diag_eps=diag_eps)

    def forward(self, x: torch.Tensor, rtf=None, psd_n=None):
        if rtf is None or psd_n is None:
            raise TypeError("RTFMVDR requires rtf= and psd_n=")
        w = _ops.mvdr_weights_rtf(rtf, psd_n, **self.kw)
        return _ops.apply_beamforming(w, x)


class Overdrive(Transform):
    def __init__(self, gain: float = 20.0, colour: float = 20.0):
        super().__init__()
        self.gain, self.colour = gain, colour

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.overdrive(x, self.gain, self.colour)


class Phaser(Transform):
    def __init__(self, sample_rate: float, **kwargs):
        super().__init__()
        self.sample_rate, self.kw = sample_rate, kwargs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.phaser(x, self.sample_rate, **self.kw)


class Flanger(Transform):
    def __init__(self, sample_rate: float, **kwargs):
        super().__init__()
        self.sample_rate, self.kw = sample_rate, kwargs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.flanger(x, self.sample_rate, **self.kw)


class Contrast(Transform):
    def __init__(self, enhancement_amount: float = 75.0):
        super().__init__()
        self.enhancement_amount = enhancement_amount

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.contrast(x, self.enhancement_amount)


class Lowpass(Transform):
    def __init__(self, sample_rate: float, cutoff_freq: float,
                 Q: float = 0.707):
        super().__init__()
        self.kw = (sample_rate, cutoff_freq, Q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.lowpass_biquad(x, *self.kw)


class Highpass(Transform):
    def __init__(self, sample_rate: float, cutoff_freq: float,
                 Q: float = 0.707):
        super().__init__()
        self.kw = (sample_rate, cutoff_freq, Q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.highpass_biquad(x, *self.kw)


class Equalizer(Transform):
    def __init__(self, sample_rate: float, center_freq: float,
                 gain_db: float, Q: float = 0.707):
        super().__init__()
        self.kw = (sample_rate, center_freq, gain_db, Q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.equalizer_biquad(x, *self.kw)


class Vad(Transform):
    """Voice activity detection (see ``ops/vad.py`` for the API split).
    ``mode="onset"`` (default) → per-clip onset sample index;
    ``mode="trim"`` → ``(trimmed, valid_length)``, a fixed-shape trim
    (speech shifted to sample 0, zero-filled tail), torchaudio's
    ``transforms.Vad`` at a shape that does not depend on the data."""

    def __init__(self, sample_rate: int, mode: str = "onset", **kwargs):
        super().__init__()
        if mode not in ("onset", "trim"):
            raise ValueError("mode must be 'onset' or 'trim'")
        self.sample_rate, self.mode, self.kw = sample_rate, mode, kwargs

    def forward(self, x: torch.Tensor):
        if self.mode == "trim":
            return _ops.vad_trim(x, self.sample_rate, **self.kw)
        return _ops.vad_onset(x, self.sample_rate, **self.kw)


class LFCC(Transform):
    """Waveform → LFCC (linear-frequency cepstra, :func:`~..ops.mfcc.lfcc`)."""

    def __init__(self, sample_rate: int = 22050, n_lfcc: int = 20,
                 n_filter: int = 128, fft_length: int = 2048,
                 hop_length: int = 512, **kwargs):
        super().__init__()
        self.kw = dict(sample_rate=sample_rate, n_lfcc=n_lfcc,
                       n_filter=n_filter, fft_length=fft_length,
                       hop_length=hop_length, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.lfcc(x, **self.kw)


class Convolve(Transform):
    """Direct convolution with a second signal: ``t(x, y)``."""

    def __init__(self, mode: str = "full"):
        super().__init__()
        self.mode = mode

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return _ops.convolve(x, y, mode=self.mode)


class FFTConvolve(Transform):
    """FFT convolution with a second signal: ``t(x, y)``."""

    def __init__(self, mode: str = "full"):
        super().__init__()
        self.mode = mode

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return _ops.fftconvolve(x, y, mode=self.mode)


class SpeedPerturbation(Transform):
    """Random tape-speed augmentation: each call draws one of ``factors``
    from ``generator`` and applies :func:`~..ops.effects.speed`."""

    def __init__(self, orig_freq: int, factors):
        super().__init__()
        self.orig_freq = orig_freq
        self.factors = tuple(float(f) for f in factors)
        if not self.factors or any(f <= 0 for f in self.factors):
            raise ValueError("factors must be a non-empty positive list")

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None, lengths=None):
        device = generator.device if generator is not None else "cpu"
        i = int(torch.randint(0, len(self.factors), (), generator=generator,
                              device=device))
        return _ops.speed(x, self.orig_freq, self.factors[i],
                          lengths=lengths)


class AmplitudeToDB(Transform):
    """torchaudio's dB transform: ``stype`` (``power`` or ``magnitude``)
    picks the 10·/20·log10 multiplier; ``top_db`` clamps to each
    spectrogram's peak."""

    def __init__(self, stype: str = "power", top_db: Optional[float] = None):
        super().__init__()
        if stype not in ("power", "magnitude"):
            raise ValueError("stype must be 'power' or 'magnitude'")
        self.multiplier = 10.0 if stype == "power" else 20.0
        self.top_db = top_db

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.amplitude_to_DB(x, self.multiplier, 1e-10, 0.0,
                                    self.top_db)


def _default_hop(n_fft: int, win_length: Optional[int],
                 hop_length: Optional[int]) -> int:
    """torchaudio's default hop: ``win_length // 2``, ``win_length``
    itself defaulting to ``n_fft``."""
    if hop_length is not None:
        return hop_length
    return (n_fft if win_length is None else win_length) // 2


class _PaddedSpectrogram(Transform):
    """What the torchaudio-named waveform transforms share: ``pad`` zeros
    on both sides of the waveform, and the window ``window_fn`` makes (a
    derived buffer) or None (Hann)."""

    def __init__(self, n_fft: int, win_length: Optional[int], pad: int,
                 window_fn):
        super().__init__()
        self.pad = int(pad)
        window = None
        if window_fn is not None:
            window = torch.as_tensor(window_fn(win_length or n_fft),
                                     dtype=torch.float32)
        self._derived("window", window)

    def _padded(self, x: torch.Tensor) -> torch.Tensor:
        return F.pad(x, (self.pad, self.pad)) if self.pad else x


class MelSpectrogram(_PaddedSpectrogram):
    """torchaudio's mel spectrogram arguments (``n_fft``, ``n_mels``,
    ``window_fn``; the house factory is ``Melspectrogram()``)."""

    def __init__(self, sample_rate: int = 16000, n_fft: int = 400,
                 win_length: Optional[int] = None,
                 hop_length: Optional[int] = None,
                 f_min: float = 0.0, f_max: Optional[float] = None,
                 pad: int = 0, n_mels: int = 128, window_fn=None,
                 power: float = 2.0, normalized: bool = False,
                 center: bool = True, pad_mode: str = "reflect",
                 norm: Optional[str] = None, mel_scale: str = "htk",
                 onesided: bool = True):
        if not onesided:
            raise ValueError("MelSpectrogram requires onesided=True")
        super().__init__(n_fft, win_length, pad, window_fn)
        self.kw = dict(
            num_mels=n_mels, sample_rate=sample_rate, f_min=f_min,
            f_max=f_max, mel_scale=mel_scale, norm=norm, power=power,
            fft_length=n_fft,
            hop_length=_default_hop(n_fft, win_length, hop_length),
            win_length=win_length, center=center, pad_mode=pad_mode,
            normalized=normalized)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.melspectrogram(self._padded(x), window=self.window,
                                   **self.kw)


class _SpectrogramFilterbank(_PaddedSpectrogram):
    """Waveform → spectrogram → one filterbank product (the bark and chroma
    spectrograms); the filterbank is a derived buffer."""

    def __init__(self, n_fft: int, win_length: Optional[int],
                 hop_length: Optional[int], pad: int, window_fn,
                 power: float, normalized: bool, center: bool,
                 pad_mode: str, filterbank: torch.Tensor):
        super().__init__(n_fft, win_length, pad, window_fn)
        self.spec_kw = dict(
            fft_length=n_fft,
            hop_length=_default_hop(n_fft, win_length, hop_length),
            win_length=win_length, center=center, pad_mode=pad_mode,
            normalized=normalized, power=power)
        self._derived("filterbank", filterbank)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = _ops.spectrogram(self._padded(x), window=self.window,
                                **self.spec_kw)
        return _ops.apply_filterbank(spec, self.filterbank)


class TimeStretch(Transform):
    """Phase-vocoder stretch of complex spectrograms: ``t(spec)`` at the
    fixed rate or ``t(spec, overriding_rate=r)`` (the house layer is
    ``StretchSpecTime``)."""

    def __init__(self, hop_length: Optional[int] = None, n_freq: int = 201,
                 fixed_rate: Optional[float] = None):
        super().__init__()
        self.n_freq = n_freq
        self.hop = hop_length if hop_length is not None else n_freq - 1
        self.fixed_rate = fixed_rate
        # torchaudio's linspace(0, pi·hop, n_freq) is hop·2π·f/n_fft
        self._derived("phase_advance", _ops.compute_phase_advance(
            n_freq, self.hop, 2 * (n_freq - 1)))

    def forward(self, x: torch.Tensor,
                overriding_rate: Optional[float] = None) -> torch.Tensor:
        rate = (overriding_rate if overriding_rate is not None
                else self.fixed_rate)
        if rate is None:
            raise ValueError("TimeStretch built without fixed_rate needs "
                             "overriding_rate=")
        if x.shape[-2] != self.n_freq:
            raise ValueError(f"spec has {x.shape[-2]} freq bins, transform "
                             f"built for n_freq={self.n_freq}")
        if float(rate) == 1.0:
            return x
        return _ops.phase_vocoder(x, float(rate), self.phase_advance)


class SpecAugment(Transform):
    """torchaudio's SpecAugment (masks only): ``n_time_masks`` time masks
    of width at most ``min(time_mask_param, p·T)`` and ``n_freq_masks``
    frequency masks of width at most ``freq_mask_param``; ``t(spec,
    generator=g)``.  ``iid_masks`` draws one set of masks per element of
    the leading batch dim (``spec.ndim >= 3``); ``zero_masking=False``
    fills with the spectrogram's global mean instead of 0."""

    def __init__(self, n_time_masks: int, time_mask_param: int,
                 n_freq_masks: int, freq_mask_param: int,
                 iid_masks: bool = True, p: float = 1.0,
                 zero_masking: bool = True):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError("p must be in [0, 1]")
        self.cfg = (int(n_time_masks), int(time_mask_param),
                    int(n_freq_masks), int(freq_mask_param),
                    bool(iid_masks), float(p), bool(zero_masking))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n_t, t_param, n_f, f_param, iid, p, zero = self.cfg
        t_param = min(t_param, int(p * x.shape[-1]))
        val = 0.0 if zero else float(x.mean())

        def one(spec):
            if n_t and t_param > 0:
                spec = _ops.time_mask(generator, spec, t_param,
                                      num_masks=n_t, mask_value=val)
            if n_f and f_param > 0:
                spec = _ops.freq_mask(generator, spec, f_param,
                                      num_masks=n_f, mask_value=val)
            return spec

        if iid and x.ndim >= 3:
            return torch.stack([one(s) for s in x])
        return one(x)


class MVDR(Transform):
    """torchaudio's ``transforms.MVDR``: ``t(spec, mask_s, mask_n)``.
    PSDs from the time-frequency masks, then weights by ``solution``:
    ``ref_channel`` (Souden), ``stv_evd`` or ``stv_power`` (an RTF
    estimate and the RTF formula) → the enhanced single-channel complex
    spectrogram.  ``online=True`` is not provided."""

    def __init__(self, ref_channel: int = 0, solution: str = "ref_channel",
                 multi_mask: bool = False, diag_loading: bool = True,
                 diag_eps: float = 1e-7, online: bool = False):
        super().__init__()
        if solution not in ("ref_channel", "stv_evd", "stv_power"):
            raise ValueError("solution must be ref_channel|stv_evd|stv_power")
        if online:
            raise NotImplementedError(
                "online (recursive) MVDR is not provided: compute PSDs per "
                "block and rebuild the weights instead")
        self.ref, self.solution = int(ref_channel), solution
        self.multi_mask = bool(multi_mask)
        self.loading = dict(diagonal_loading=bool(diag_loading),
                            diag_eps=float(diag_eps))

    def forward(self, x: torch.Tensor, mask_s=None, mask_n=None):
        if mask_s is None or mask_n is None:
            raise TypeError("MVDR requires mask_s= and mask_n=")
        if self.multi_mask:
            # (..., channel, freq, time) masks: the mean over channels
            mask_s, mask_n = mask_s.mean(dim=-3), mask_n.mean(dim=-3)
        psd_s, psd_n = _ops.psd(x, mask_s), _ops.psd(x, mask_n)
        if self.solution == "ref_channel":
            w = _ops.mvdr_weights_souden(psd_s, psd_n,
                                         reference_channel=self.ref,
                                         **self.loading)
        else:
            if self.solution == "stv_evd":
                rtf = _ops.rtf_evd(psd_s, reference_channel=self.ref)
            else:
                rtf = _ops.rtf_power(psd_s, psd_n,
                                     reference_channel=self.ref,
                                     **self.loading)
            w = _ops.mvdr_weights_rtf(rtf, psd_n, reference_channel=self.ref,
                                      **self.loading)
        return _ops.apply_beamforming(w, x)


class BarkScale(Transform):
    """Linear-magnitude spectrogram ``(..., F, T)`` → bark ``(...,
    n_barks, T)``: the bark filterbank product alone."""

    def __init__(self, n_stft: int = 201, sample_rate: int = 16000,
                 f_min: float = 0.0, f_max: Optional[float] = None,
                 n_barks: int = 128, bark_scale: str = "traunmuller"):
        super().__init__()
        self._derived("filterbank", _ops.create_bark_filter(
            n_barks, sample_rate, f_min, f_max, n_stft,
            bark_scale=bark_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.apply_filterbank(x, self.filterbank)


class InverseBarkScale(Transform):
    """Bark spectrogram → linear spectrogram by the closed-form ridge
    pseudo-inverse, as :class:`InverseMelScale` (torchaudio's prototype
    solves it by SGD; the JAX package chose the one product)."""

    def __init__(self, n_stft: int, n_barks: int = 128,
                 sample_rate: int = 16000, f_min: float = 0.0,
                 f_max: Optional[float] = None,
                 bark_scale: str = "traunmuller", ridge: float = 1e-8):
        super().__init__()
        self._derived("inverse", _ops.create_inverse_bark_filter(
            n_barks, sample_rate, f_min, f_max, n_stft,
            bark_scale=bark_scale, ridge=ridge))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.mel_to_linear(x, self.inverse)


class ChromaScale(Transform):
    """Spectrogram ``(..., F, T)`` → pitch-class chroma ``(..., n_chroma,
    T)`` (torchaudio's prototype ``ChromaScale``)."""

    def __init__(self, sample_rate: int = 16000, n_freqs: int = 201,
                 n_chroma: int = 12, tuning: float = 0.0,
                 ctroct: float = 5.0, octwidth: Optional[float] = 2.0,
                 norm: Optional[int] = 2, base_c: bool = True):
        super().__init__()
        self._derived("filterbank", _ops.create_chroma_filter(
            n_chroma, sample_rate, n_freqs, tuning=tuning, ctroct=ctroct,
            octwidth=octwidth, base_c=base_c, norm=norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ops.apply_filterbank(x, self.filterbank)


class BarkSpectrogram(_SpectrogramFilterbank):
    """torchaudio's prototype bark spectrogram arguments (``n_fft``,
    ``n_barks``; the house factory is ``Barkspectrogram()``)."""

    def __init__(self, sample_rate: int = 16000, n_fft: int = 400,
                 win_length: Optional[int] = None,
                 hop_length: Optional[int] = None,
                 f_min: float = 0.0, f_max: Optional[float] = None,
                 pad: int = 0, n_barks: int = 128, window_fn=None,
                 power: float = 2.0, normalized: bool = False,
                 center: bool = True, pad_mode: str = "reflect",
                 bark_scale: str = "traunmuller"):
        super().__init__(
            n_fft, win_length, hop_length, pad, window_fn, power,
            normalized, center, pad_mode,
            _ops.create_bark_filter(n_barks, sample_rate, f_min, f_max,
                                    n_fft // 2 + 1, bark_scale=bark_scale))


class ChromaSpectrogram(_SpectrogramFilterbank):
    """torchaudio's prototype chromagram: spectrogram and chroma filterbank
    product (the house factory is ``Chromagram()``)."""

    def __init__(self, sample_rate: int = 16000, n_fft: int = 400,
                 win_length: Optional[int] = None,
                 hop_length: Optional[int] = None, pad: int = 0,
                 window_fn=None, power: float = 2.0,
                 normalized: bool = False, center: bool = True,
                 pad_mode: str = "reflect", n_chroma: int = 12,
                 tuning: float = 0.0, ctroct: float = 5.0,
                 octwidth: Optional[float] = 2.0, norm: Optional[int] = 2,
                 base_c: bool = True):
        super().__init__(
            n_fft, win_length, hop_length, pad, window_fn, power,
            normalized, center, pad_mode,
            _ops.create_chroma_filter(n_chroma, sample_rate, n_fft // 2 + 1,
                                      tuning=tuning, ctroct=ctroct,
                                      octwidth=octwidth, base_c=base_c,
                                      norm=norm))
