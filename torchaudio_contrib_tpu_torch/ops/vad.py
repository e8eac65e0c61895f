"""Voice activity detection (SoX-parameter-surface, adaptive spectral SNR).

Port of ``torchaudio_contrib_tpu/ops/vad.py`` (the ``vad`` effect
torchaudio ships: trim leading non-speech), with the same parameter names,
defaults and measure:

1. band-limit the signal (HP/LP biquads — :mod:`.iir`'s doubling scans);
2. every ``1/measure_freq`` seconds, window a short chunk and take its
   power spectrum (all measure frames through ONE ``rfft``);
3. track a smoothed spectrum and an **adaptive noise spectrum** with
   asymmetric up/down EMA rates (fast adaptation during ``boot_time``),
   spectrally subtract ``noise_reduction_amount × noise``; upward
   adaptation is speech-gated (a bin >6 dB above the floor leaks into it
   on a 5 s time constant only);
4. the per-frame measure is the band SNR in dB of the subtracted spectrum
   against the adapted noise floor;
5. trigger when measures stay ≥ ``trigger_level`` for ``trigger_time``,
   bridging dropouts up to ``allowed_gap`` (morphological closing), then
   rewind by ``pre_trigger_time``.

Deviation from SoX, as in the JAX package: frames are scored by the
adaptive-floor SNR, not by SoX's cepstral-lifter power, so
``hp_lifter_freq``/``lp_lifter_freq`` raise if changed from their
defaults.

Only step 3 is sequential, and only over measure frames (20 a second): a
loop of tensor ops, one step per frame.  The run lengths of step 5 are the
frame index minus a ``cummax`` of the last inactive index, and the closing
is two ``max_pool1d`` passes, so nothing else loops.

:func:`vad_onset` returns the onset sample index per clip (fixed shapes);
:func:`vad_trim` shifts speech to sample 0 at a fixed shape; :func:`vad`
trims one clip.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .features import _float
from .iir import highpass_biquad, lowpass_biquad
from .stft import frame_signal

__all__ = ["vad", "vad_onset", "vad_trim"]


def _vad_measures(waveform: torch.Tensor, sample_rate: float,
                  boot_time: float, noise_up_time: float,
                  noise_down_time: float, noise_reduction_amount: float,
                  measure_freq: float, measure_duration: float | None,
                  measure_smooth_time: float, hp_filter_freq: float,
                  lp_filter_freq: float) -> torch.Tensor:
    """Per-measure-frame SNR measures in dB, ``(..., n_measures)``."""
    x = _float(waveform)
    x = highpass_biquad(x, sample_rate, hp_filter_freq)
    x = lowpass_biquad(x, sample_rate, min(lp_filter_freq,
                                           0.49 * sample_rate))

    period = max(int(round(sample_rate / measure_freq)), 1)
    dur = (2.0 / measure_freq if measure_duration is None
           else measure_duration)
    win = max(int(round(dur * sample_rate)), 2)
    if x.shape[-1] < win:
        raise ValueError(
            f"clip too short for vad: {x.shape[-1]} samples < one "
            f"measure window ({win})")
    frames = frame_signal(x, win, period)         # (..., n_meas, win)
    n_fft = 1 << max(int(math.ceil(math.log2(win))), 4)
    w = torch.tensor(np.hanning(win + 2)[1:-1].astype(np.float32),
                     device=x.device).to(x.dtype)
    spec = torch.fft.rfft(frames * w, n=n_fft, dim=-1).abs() ** 2
    n_bins = spec.shape[-1]

    freqs = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    band = torch.tensor(((freqs >= hp_filter_freq)
                         & (freqs <= lp_filter_freq)).astype(np.float32),
                        device=x.device).to(x.dtype)

    dt = 1.0 / measure_freq
    a_smooth = math.exp(-dt / max(measure_smooth_time, 1e-6))
    a_up = math.exp(-dt / max(noise_up_time, 1e-6))
    a_down = math.exp(-dt / max(noise_down_time, 1e-6))
    boot_len = int(round(boot_time * measure_freq))
    a_leak = math.exp(-dt / 5.0)       # speech-gated slow upward leak

    lead = spec.shape[:-2]
    n_meas = spec.shape[-2]
    flat = spec.reshape((-1, n_meas, n_bins))

    def const(v):
        return torch.tensor(v, dtype=flat.dtype, device=flat.device)

    half, leak, up, down = const(0.5), const(a_leak), const(a_up), \
        const(a_down)
    smooth = flat.new_zeros((flat.shape[0], n_bins))
    noise = flat.new_zeros((flat.shape[0], n_bins))
    meas = []
    for idx in range(n_meas):
        p = flat[:, idx]
        smooth = a_smooth * smooth + (1 - a_smooth) * p
        booting = idx < boot_len
        # >6 dB above the floor = speech: leak, don't track (docstring)
        if booting:
            a_up_eff = half
        else:
            a_up_eff = torch.where(p > 4.0 * (noise + 1e-12), leak, up)
        coeff = torch.where(p > noise, a_up_eff, down)
        noise = coeff * noise + (1 - coeff) * p
        if booting:
            meas.append(flat.new_full((flat.shape[0],), -90.0))
            continue
        clean = torch.clamp(smooth - noise_reduction_amount * noise,
                            min=0.0)
        num = (clean * band).sum(dim=-1)
        den = noise_reduction_amount * (noise * band).sum(dim=-1) + 1e-12
        meas.append(10.0 * torch.log10(num / den + 1e-9))
    return torch.stack(meas, dim=-1).reshape(lead + (n_meas,))


def vad_onset(waveform: torch.Tensor, sample_rate: float,
              trigger_level: float = 7.0, trigger_time: float = 0.25,
              search_time: float = 1.0, allowed_gap: float = 0.25,
              pre_trigger_time: float = 0.0, boot_time: float = 0.35,
              noise_up_time: float = 0.1, noise_down_time: float = 0.01,
              noise_reduction_amount: float = 1.35,
              measure_freq: float = 20.0,
              measure_duration: float | None = None,
              measure_smooth_time: float = 0.4,
              hp_filter_freq: float = 50.0,
              lp_filter_freq: float = 6000.0,
              hp_lifter_freq: float = 150.0,
              lp_lifter_freq: float = 2000.0) -> torch.Tensor:
    """Voice-onset sample index per clip (fixed shapes).

    ``waveform`` is ``(..., time)``; returns int32 ``(...)`` — the
    sample index where speech starts (0 if the clip opens with speech,
    clip length if none found).  Parameters mirror
    ``torchaudio.functional.vad``; see the module docstring for the
    measure semantics (and the lifter-parameter deviation).
    ``search_time`` bounds how far the gap-bridging looks, matching its
    SoX role of limiting retroactive joining.
    """
    if (hp_lifter_freq, lp_lifter_freq) != (150.0, 2000.0):
        raise NotImplementedError(
            "this VAD scores frames by adaptive spectral SNR, not a "
            "cepstral lifter (module docstring); hp_lifter_freq/"
            "lp_lifter_freq have no effect and non-default values "
            "would be silently ignored")
    meas = _vad_measures(
        waveform, sample_rate, boot_time, noise_up_time,
        noise_down_time, noise_reduction_amount, measure_freq,
        measure_duration, measure_smooth_time, hp_filter_freq,
        lp_filter_freq)
    n_meas = meas.shape[-1]
    period = max(int(round(sample_rate / measure_freq)), 1)

    active = meas >= trigger_level
    gap_len = min(max(int(round(allowed_gap * measure_freq)), 0),
                  max(int(round(search_time * measure_freq)), 1))
    trig_len = max(int(round(trigger_time * measure_freq)), 1)

    if gap_len > 0:
        # bridge dropouts ≤ gap_len: morphological closing along time,
        # both passes VALID windows of k over the mask padded by k, the
        # erosion negated max; C[t] is the min over the k dilation
        # windows containing t, i.e. offset t + 1 below
        k = gap_len + 1
        f = F.pad(active.to(meas.dtype).reshape(-1, 1, n_meas), (k, k))
        dil = F.max_pool1d(f, k, stride=1)
        ero = -F.max_pool1d(-dil, k, stride=1)
        closed = (ero[..., 0, 1:1 + n_meas] > 0.5).reshape(active.shape)
    else:
        closed = active

    # run length of consecutive closed activity ending at each frame:
    # the index minus the last inactive index at or before it
    idx = torch.arange(n_meas, device=meas.device)
    last_off = torch.cummax(torch.where(closed, -1, idx), dim=-1).values
    runs = idx - last_off

    hit = runs >= trig_len
    any_hit = hit.any(dim=-1)
    first_end = torch.argmax(hit.to(torch.int32), dim=-1)
    onset_meas = first_end - (trig_len - 1)
    pre = int(round(pre_trigger_time * measure_freq))
    onset_meas = torch.clamp(onset_meas - pre, min=0)
    return torch.where(any_hit, onset_meas * period,
                       waveform.shape[-1]).to(torch.int32)


def vad_trim(waveform: torch.Tensor, sample_rate: float, **kwargs):
    """Fixed-shape trim: → ``(trimmed, valid_length)``.

    ``trimmed`` has the SAME shape as ``waveform`` with the detected
    speech shifted to sample 0 and the tail zero-filled;
    ``valid_length`` (int32, one per clip) is the number of valid
    samples (``T − onset``).  Batched inputs ``(..., time)`` trim each
    clip independently, except that a 2-D ``(channel, time)`` input
    shares the min onset across channels (same rule as :func:`vad`).
    Slice with ``trimmed[..., :int(valid_length)]`` for the
    dynamic-length view.
    """
    waveform = torch.as_tensor(waveform)
    if waveform.ndim == 0:
        raise ValueError("waveform must have a time axis")
    onset = vad_onset(waveform, sample_rate, **kwargs)
    if waveform.ndim == 2:
        # (channel, time): channels share the conservative min onset
        onset = onset.min().expand(onset.shape)
    T = waveform.shape[-1]
    idx = torch.arange(T, device=waveform.device)
    gather = torch.clamp(idx + onset[..., None], max=T - 1)
    shifted = torch.gather(waveform.reshape(-1, T), -1,
                           gather.reshape(-1, T).to(torch.int64)
                           ).reshape(waveform.shape)
    valid = (T - onset).to(torch.int32)
    mask = idx < valid[..., None]
    return torch.where(mask, shifted, 0.0), valid


def vad(waveform: torch.Tensor, sample_rate: float,
        **kwargs) -> torch.Tensor:
    """Trim leading non-speech from ONE clip.

    ``waveform`` is ``(time,)`` or ``(channel, time)``; channels share
    the min onset (conservative — keeps all channels aligned and never
    cuts into any channel's speech).  The output length depends on the
    data; in batched pipelines use :func:`vad_onset` or :func:`vad_trim`.
    """
    if waveform.ndim > 2:
        raise ValueError(
            "vad trims single clips; use vad_onset for batches")
    onset = vad_onset(waveform, sample_rate, **kwargs)
    start = int(onset.min())
    return waveform[..., start:]
