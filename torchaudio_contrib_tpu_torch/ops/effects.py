"""Level and shape utilities: fade, gain, dither, DC shift, CMN, noise,
speed, codec.

Port of ``torchaudio_contrib_tpu/ops/effects.py``: elementwise or
small-window tensor ops, all differentiable except where they round.
:func:`dither` takes an explicit ``torch.Generator`` where the JAX package
takes a PRNG key; :func:`speed` resamples with the port's
:func:`~.resample.resample`; :func:`apply_codec` uses the port's μ-law
codec.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["fade", "gain", "dither", "dcshift", "sliding_window_cmn",
           "add_noise", "speed", "apply_codec"]

_FADE_SHAPES = ("linear", "exponential", "logarithmic",
                "quarter_sine", "half_sine", "parabola")


def _float(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _fade_curve(n: int, shape: str, like: torch.Tensor) -> torch.Tensor:
    r = torch.linspace(0.0, 1.0, n, dtype=like.dtype, device=like.device)
    if shape == "linear":
        return r
    if shape == "exponential":
        return torch.pow(2.0, r - 1.0) * r
    if shape == "logarithmic":
        return torch.sqrt(r)
    if shape == "quarter_sine":
        return torch.sin(r * np.pi / 2.0)
    if shape == "half_sine":
        return (1.0 - torch.cos(r * np.pi)) / 2.0
    if shape == "parabola":                   # sox fade 'p'
        return r * (2.0 - r)
    raise ValueError(
        f"unknown fade shape {shape!r}; expected one of {_FADE_SHAPES}")


def fade(waveform: torch.Tensor, fade_in_len: int = 0,
         fade_out_len: int = 0, fade_shape: str = "linear") -> torch.Tensor:
    """Fade-in and fade-out envelopes over the first and last samples."""
    waveform = _float(waveform)
    t = waveform.shape[-1]
    if not (0 <= fade_in_len <= t and 0 <= fade_out_len <= t):
        raise ValueError(
            f"fade lengths ({fade_in_len}, {fade_out_len}) must be in "
            f"[0, {t}]")
    env = torch.ones(t, dtype=waveform.dtype, device=waveform.device)
    if fade_in_len > 0:
        env[:fade_in_len] *= _fade_curve(fade_in_len, fade_shape, waveform)
    if fade_out_len > 0:
        env[t - fade_out_len:] *= _fade_curve(fade_out_len, fade_shape,
                                              waveform).flip(0)
    return waveform * env


def gain(waveform: torch.Tensor, gain_db: float = 1.0) -> torch.Tensor:
    """Scale the amplitude by ``gain_db`` decibels."""
    return _float(waveform) * (10.0 ** (gain_db / 20.0))


def dcshift(waveform: torch.Tensor, shift: float,
            limiter_gain: Optional[float] = None) -> torch.Tensor:
    """Add a DC offset; with ``limiter_gain``, samples that would clip are
    compressed by SoX's polynomial limiter instead of hard-clipped."""
    waveform = _float(waveform)
    if limiter_gain is None:
        return torch.clamp(waveform + shift, -1.0, 1.0)
    thresh = 1.0 - limiter_gain
    shifted = waveform + shift
    if shift > 0:
        peak = torch.where(
            waveform > thresh - shift,
            thresh + (shifted - thresh)
            / (1.0 + ((shifted - thresh) / limiter_gain) ** 2),
            shifted)
    else:
        peak = torch.where(
            waveform < -thresh - shift,
            -thresh + (shifted + thresh)
            / (1.0 + ((shifted + thresh) / limiter_gain) ** 2),
            shifted)
    return torch.clamp(peak, -1.0, 1.0)


def dither(generator: Optional[torch.Generator], waveform: torch.Tensor,
           density_function: str = "TPDF",
           bit_depth: int = 16) -> torch.Tensor:
    """Add quantisation dither at the LSB of ``bit_depth``.

    ``density_function`` is TPDF (triangular, the audio default), RPDF
    (rectangular) or GPDF (Gaussian).  The noise is drawn from
    ``generator`` on its device (None: the global generator), in the JAX
    package's key's place."""
    waveform = _float(waveform)
    lsb = 2.0 ** (1 - bit_depth)
    df = density_function.upper()
    kw = dict(generator=generator, dtype=waveform.dtype,
              device=generator.device if generator is not None
              else waveform.device)
    if df == "TPDF":
        noise = (torch.rand(waveform.shape, **kw)
                 - torch.rand(waveform.shape, **kw))
    elif df == "RPDF":
        noise = torch.rand(waveform.shape, **kw) - 0.5
    elif df == "GPDF":
        noise = torch.randn(waveform.shape, **kw) * 0.5
    else:
        raise ValueError(
            f"unknown density_function {density_function!r}; expected "
            "TPDF, RPDF or GPDF")
    return waveform + lsb * noise.to(waveform.device)


def add_noise(waveform: torch.Tensor, noise: torch.Tensor, snr,
              lengths=None) -> torch.Tensor:
    """Mix ``noise`` into ``waveform`` at ``snr`` dB (broadcast over the
    leading dims).  ``lengths`` restricts the energy measurement and the
    mixing to each clip's first ``lengths`` samples."""
    waveform = _float(waveform)
    noise = noise.to(waveform.dtype)
    if noise.shape != waveform.shape:
        raise ValueError(
            f"noise shape {tuple(noise.shape)} != waveform "
            f"{tuple(waveform.shape)}")
    snr = torch.as_tensor(snr, dtype=waveform.dtype, device=waveform.device)
    if lengths is not None:
        t = torch.arange(waveform.shape[-1], device=waveform.device)
        mask = (t < torch.as_tensor(lengths, device=waveform.device)[..., None]
                ).to(waveform.dtype)
    else:
        mask = torch.ones((), dtype=waveform.dtype, device=waveform.device)
    e_sig = ((waveform * mask) ** 2).sum(dim=-1)
    e_noi = torch.clamp(((noise * mask) ** 2).sum(dim=-1), min=1e-20)
    # scale so that e_sig / (scale² e_noi) = 10^(snr/10)
    scale = torch.sqrt(e_sig / e_noi) * 10.0 ** (-snr / 20.0)
    return waveform + scale[..., None] * noise * mask


def speed(waveform: torch.Tensor, orig_freq: int, factor: float,
          lengths=None):
    """Speed up (``factor > 1``) or slow down a clip by resampling: the
    duration and the pitch change together.  ``factor`` is approximated
    as a ratio to 1/1000, then one polyphase resample
    (:func:`~.resample.resample`).  Returns ``out`` or ``(out,
    new_lengths)`` when ``lengths`` is given."""
    from .resample import resample
    if factor <= 0:
        raise ValueError("factor must be positive")
    source_freq = int(round(factor * 1000.0))
    target_freq = 1000
    g = math.gcd(source_freq, target_freq)
    source_freq //= g
    target_freq //= g
    out = resample(waveform, orig_freq * source_freq,
                   orig_freq * target_freq)
    if lengths is None:
        return out
    new_lengths = torch.ceil(torch.as_tensor(lengths) * target_freq
                             / source_freq).to(torch.int32)
    return out, new_lengths


def sliding_window_cmn(specgram: torch.Tensor, cmn_window: int = 600,
                       min_cmn_window: int = 100, center: bool = False,
                       norm_vars: bool = False) -> torch.Tensor:
    """Sliding-window cepstral mean (and variance) normalisation of
    ``(..., freq, time)``: each frame by the statistics of a
    ``cmn_window``-frame window (centred when ``center``, else trailing with
    a ``min_cmn_window`` warm-up, Kaldi's semantics), from one cumulative
    sum along time."""
    specgram = _float(specgram)
    t = specgram.shape[-1]
    idx = np.arange(t)
    if center:
        start = np.clip(idx - cmn_window // 2, 0, None)
        end = np.minimum(start + cmn_window, t)
        start = np.minimum(start, np.clip(t - cmn_window, 0, None))
    else:
        start = np.clip(idx - cmn_window + 1, 0, None)
        end = np.maximum(idx + 1, np.minimum(min_cmn_window, t))
    dev = specgram.device
    cnt = torch.as_tensor((end - start).astype(np.float32), device=dev)
    start = torch.as_tensor(start, device=dev)
    end = torch.as_tensor(end, device=dev)
    zero = specgram.new_zeros(specgram.shape[:-1] + (1,))
    c1 = torch.cat([zero, torch.cumsum(specgram, dim=-1)], dim=-1)
    c2 = torch.cat([zero, torch.cumsum(specgram * specgram, dim=-1)], dim=-1)
    s1 = c1[..., end] - c1[..., start]
    s2 = c2[..., end] - c2[..., start]
    mean = s1 / cnt
    out = specgram - mean
    if norm_vars:
        var = torch.clamp(s2 / cnt - mean * mean, min=1e-10)
        out = out / torch.sqrt(var)
    return out


def apply_codec(waveform: torch.Tensor, sample_rate: int,
                format: str = "wav", encoding: Optional[str] = None,
                bits_per_sample: Optional[int] = None) -> torch.Tensor:
    """Simulate a quantising codec's round trip for the WAV family
    (torchaudio's ``functional.apply_codec`` there).  ``encoding`` is
    ``"PCM_S"`` (default, ``bits_per_sample`` 8/16/24/32), ``"PCM_U"``
    (8), ``"ULAW"`` or ``"ALAW"`` (8).  Compressed formats need ffmpeg or
    sox and raise."""
    if format != "wav":
        raise ValueError(
            f"apply_codec supports format='wav' only (got {format!r}): "
            "compressed codecs need ffmpeg/sox, not available in this build")
    x = torch.clamp(waveform.to(torch.float32), -1.0, 1.0)
    enc = (encoding or "PCM_S").upper()
    if enc == "PCM_S":
        bits = bits_per_sample or 16
        if bits not in (8, 16, 24, 32):
            raise ValueError("PCM_S bits_per_sample must be 8/16/24/32")
        q = float(2 ** (bits - 1))
        return torch.clamp(torch.round(x * q), -q, q - 1) / q
    if enc == "PCM_U":
        if bits_per_sample not in (None, 8):
            raise ValueError("PCM_U supports 8 bits")
        # code = x·128 + 128, decoded (code − 128)/128: zero is exact
        u = torch.clamp(torch.round(x * 128.0) + 128.0, 0, 255)
        return (u - 128.0) / 128.0
    if enc == "ULAW":
        from .mulaw import mu_law_encoding, mu_law_decoding
        return mu_law_decoding(mu_law_encoding(x, 256), 256)
    if enc == "ALAW":
        a = 87.6
        ln_a1 = 1.0 + math.log(a)
        ax = torch.abs(x)
        comp = torch.where(ax < 1.0 / a, a * ax / ln_a1,
                           (1.0 + torch.log(torch.clamp(a * ax, min=1.0)))
                           / ln_a1)
        # signed 8-bit companded grid with an exact zero level
        code = torch.clamp(torch.round(torch.sign(x) * comp * 128.0),
                           -128, 127)
        y = code / 128.0
        ay = torch.abs(y)
        lin = torch.where(ay < 1.0 / ln_a1, ay * ln_a1 / a,
                          torch.exp(ay * ln_a1 - 1.0) / a)
        return torch.sign(y) * lin
    raise ValueError(f"unknown encoding {encoding!r} (PCM_S, PCM_U, ULAW, "
                     "ALAW)")
