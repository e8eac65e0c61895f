"""SoX-style effect chains over the port's own DSP ops.

The port of the JAX package's ``sox_effects``: torchaudio's
``sox_effects.apply_effects_tensor/apply_effects_file`` capability — the
same ``[["gain", "-n"], ["rate", "16000"], ...]`` string-chain surface —
WITHOUT linking libsox: every effect dispatches to this package's
implementations (:mod:`..ops`), so a chain runs on its waveform's device
(the card for a CUDA tensor, with no fallback).

Honest deviations from libsox, all loud:

* Unsupported effect names or argument forms raise ``ValueError``
  naming the effect — never a silent skip.
* ``lowpass``/``highpass`` ``-1`` (single-pole) runs the same biquad
  as ``-2``.
* ``fade`` takes ``[shape] IN [STOP [OUT]]`` with times in seconds
  only; when STOP is given, the clip is cut at STOP (sox semantics)
  and OUT fades out at the new end.
* ``dither`` needs randomness: pass ``generator=`` (a
  ``torch.Generator`` on the waveform's device) to the apply functions,
  where the JAX package takes ``key=``.
* filter ``width`` suffixes: ``q`` (Q factor) and ``h`` (Hz,
  converted to Q as ``center/width``) are supported; ``o``/``k``
  raise.

Times are seconds; frequencies accept sox's ``k`` suffix (``8k`` =
8000).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import ops as _ops

__all__ = ["apply_effects_tensor", "apply_effects_file",
           "effect_names"]


def _num(s: str, what: str = "argument") -> float:
    s = s.strip().lower()
    try:
        if s.endswith("k"):
            return float(s[:-1]) * 1000.0
        return float(s)
    except ValueError:
        raise ValueError(f"cannot parse {what} {s!r}") from None


def _q_from_width(center: float, args: List[str], default_q: float
                  ) -> float:
    """Parse an optional sox width spec into a biquad Q."""
    if not args:
        return default_q
    w = args[0].strip().lower()
    if w.endswith("q"):
        return float(w[:-1])
    if w.endswith("h"):
        return center / _num(w[:-1], "width")
    if w[-1].isdigit():
        return center / _num(w, "width")      # bare number = Hz
    raise ValueError(f"unsupported width suffix in {w!r} "
                     "(use q or h/Hz)")


def _tempo(wave, sr, factor):
    """Duration × 1/factor at constant pitch: STFT → phase vocoder →
    ISTFT (sox tempo's WSOLA replaced by the library's own
    time-stretch machinery)."""
    fft_len, hop = 1024, 256
    spec = _ops.stft(wave, fft_len, hop)
    adv = _ops.compute_phase_advance(fft_len // 2 + 1, hop, fft_len,
                                     device=wave.device)
    stretched = _ops.phase_vocoder(spec, float(factor), adv)
    return _ops.istft(stretched, hop_length=hop, fft_length=fft_len)


def _norm(wave, db):
    peak = torch.max(torch.abs(wave))
    target = 10.0 ** (db / 20.0)
    return wave * (target / torch.clamp(peak, min=1e-12))


def _fade(wave, sr, args):
    shapes = {"q": "quarter_sine", "h": "half_sine", "t": "linear",
              "l": "logarithmic", "p": "parabola"}
    args = list(args)
    shape = "linear"
    if args and args[0].lower() in shapes:
        shape = shapes[args.pop(0).lower()]
    if not args:
        raise ValueError("fade needs a fade-in length")
    fade_in = int(round(_num(args.pop(0), "fade-in") * sr))
    if args:
        stop = int(round(_num(args.pop(0), "stop") * sr))
        wave = wave[..., :stop]
        fade_out = (int(round(_num(args.pop(0), "fade-out") * sr))
                    if args else 0)
    else:
        fade_out = 0
    return _ops.fade(wave, fade_in, fade_out, shape)


def _gain(wave, args):
    args = list(args)
    normalize = False
    db = None
    for a in args:
        if a == "-n":
            normalize = True
        elif a in ("-l", "-b", "-e", "-r"):
            raise ValueError(f"gain flag {a!r} is not supported")
        else:
            db = _num(a, "gain dB")
    if normalize:
        return _norm(wave, db if db is not None else 0.0)
    if db is None:
        raise ValueError("gain needs a dB amount or -n")
    return _ops.gain(wave, db)


def _channels(wave, n):
    n = int(n)
    c = wave.shape[0]
    if n == c:
        return wave
    if n == 1:
        return torch.mean(wave, dim=0, keepdim=True)
    if c == 1:
        return wave.repeat(n, 1)
    raise ValueError(f"cannot remix {c} channels to {n}")


_SUPPORTED = (
    "allpass", "band", "bandpass", "bandreject", "bass", "channels",
    "contrast", "dcshift", "deemph", "dither", "equalizer", "fade",
    "flanger", "gain", "highpass", "lowpass", "norm", "overdrive",
    "pad", "phaser", "pitch", "rate", "reverse", "riaa", "speed",
    "tempo", "treble", "trim", "vad", "vol",
)


def effect_names() -> List[str]:
    """Names accepted by :func:`apply_effects_tensor`."""
    return sorted(_SUPPORTED)


def _apply_one(wave, sr, name, args, generator):
    """One effect on ``wave (C, T)`` → ``(wave, sr)``."""
    a = [str(x) for x in args]
    if name in ("lowpass", "highpass"):
        if a and a[0] in ("-1", "-2"):
            a = a[1:]                    # pole count: biquad either way
        freq = _num(a[0], "frequency")
        q = _q_from_width(freq, a[1:], 0.707)
        fn = (_ops.lowpass_biquad if name == "lowpass"
              else _ops.highpass_biquad)
        return fn(wave, sr, freq, Q=q), sr
    if name in ("bandpass", "bandreject"):
        if a and a[0] == "-c":
            a = a[1:]
        freq = _num(a[0], "frequency")
        q = _q_from_width(freq, a[1:], 0.707)
        fn = (_ops.bandreject_biquad if name == "bandreject"
              else _ops.bandpass_biquad)
        return fn(wave, sr, freq, Q=q), sr
    if name == "band":
        noise = bool(a) and a[0] == "-n"
        if noise:
            a = a[1:]
        freq = _num(a[0], "frequency")
        q = _q_from_width(freq, a[1:], 0.707)
        return _ops.band_biquad(wave, sr, freq, Q=q, noise=noise), sr
    if name == "deemph":
        if a:
            raise ValueError("deemph takes no arguments")
        return _ops.deemph_biquad(wave, sr), sr
    if name == "riaa":
        if a:
            raise ValueError("riaa takes no arguments")
        return _ops.riaa_biquad(wave, sr), sr
    if name == "allpass":
        freq = _num(a[0], "frequency")
        return _ops.allpass_biquad(
            wave, sr, freq, Q=_q_from_width(freq, a[1:], 0.707)), sr
    if name == "equalizer":
        freq = _num(a[0], "frequency")
        q = _q_from_width(freq, a[1:2], 0.707)
        return _ops.equalizer_biquad(
            wave, sr, freq, gain_db=_num(a[2], "gain"), Q=q), sr
    if name in ("bass", "treble"):
        if len(a) > 2:
            raise ValueError(
                f"{name} width/slope argument {a[2]!r} not supported "
                "(only 'gain [frequency]'; the biquad uses the RBJ "
                "shelf slope 1)")
        g = _num(a[0], "gain")
        default = 100.0 if name == "bass" else 3000.0
        freq = _num(a[1], "frequency") if len(a) > 1 else default
        fn = (_ops.bass_biquad if name == "bass"
              else _ops.treble_biquad)
        return fn(wave, sr, g, central_freq=freq), sr
    if name == "gain":
        return _gain(wave, a), sr
    if name == "vol":
        f = _num(a[0], "volume")
        # sox spells the type 'dB' — compare case-insensitively
        kind = (a[1] if len(a) > 1 else "amplitude").lower()
        if kind == "amplitude":
            return wave * f, sr
        if kind == "power":
            if f < 0:
                raise ValueError(
                    "vol type 'power' requires a non-negative factor")
            return wave * math.sqrt(f), sr
        if kind == "db":
            return _ops.gain(wave, f), sr
        raise ValueError(f"vol type {kind!r} not supported")
    if name == "norm":
        return _norm(wave, _num(a[0], "dB") if a else 0.0), sr
    if name == "rate":
        nums = [x for x in a if not x.startswith("-")]
        if not nums:
            raise ValueError("rate needs a target frequency")
        new_sr = int(round(_num(nums[-1], "rate")))
        return _ops.resample(wave, sr, new_sr), new_sr
    if name == "speed":
        return _ops.speed(wave, sr, _num(a[0], "factor")), sr
    if name == "tempo":
        nums = [x for x in a if not x.startswith("-")]
        if len(nums) > 1:
            raise ValueError(
                "tempo WSOLA segment/search/overlap arguments "
                f"{nums[1:]} not supported (phase-vocoder tempo takes "
                "only the factor)")
        return _tempo(wave, sr, _num(nums[0], "factor")), sr
    if name == "pitch":
        cents = _num(a[0], "cents")
        return _ops.pitch_shift(wave, sr, cents / 100.0), sr
    if name == "reverse":
        return wave.flip(-1), sr
    if name == "channels":
        return _channels(wave, _num(a[0], "channel count")), sr
    if name == "trim":
        start = int(round(_num(a[0], "start") * sr))
        if len(a) > 1:
            length = int(round(_num(a[1], "length") * sr))
            return wave[..., start:start + length], sr
        return wave[..., start:], sr
    if name == "pad":
        before = int(round(_num(a[0], "pad") * sr)) if a else 0
        after = int(round(_num(a[1], "pad") * sr)) if len(a) > 1 else 0
        return F.pad(wave, (before, after)), sr
    if name == "fade":
        return _fade(wave, sr, a), sr
    if name == "dcshift":
        return _ops.dcshift(wave, _num(a[0], "shift")), sr
    if name == "dither":
        if generator is None:
            raise ValueError(
                "dither needs randomness: pass generator=torch.Generator")
        return _ops.dither(generator, wave), sr
    if name == "overdrive":
        g = _num(a[0], "gain") if a else 20.0
        c = _num(a[1], "colour") if len(a) > 1 else 20.0
        return _ops.overdrive(wave, g, c), sr
    if name == "contrast":
        return _ops.contrast(
            wave, _num(a[0], "amount") if a else 75.0), sr
    if name == "phaser":
        vals = [_num(x, "phaser arg") for x in a
                if x not in ("-s", "-t")]
        if len(vals) > 5:
            raise ValueError(f"phaser takes at most 5 numeric "
                             f"arguments, got {len(vals)}")
        kw = dict(zip(("gain_in", "gain_out", "delay_ms", "decay",
                       "mod_speed"), vals))
        kw["sinusoidal"] = "-t" not in a
        return _ops.phaser(wave, sr, **kw), sr
    if name == "flanger":
        # sox order: delay depth regen width speed shape phase interp
        if len(a) > 8:
            raise ValueError(f"flanger takes at most 8 arguments, "
                             f"got {len(a)}")
        kw = dict(zip(("delay", "depth", "regen", "width", "speed"),
                      [_num(x, "flanger arg") for x in a[:5]]))
        if len(a) > 5:
            shape = a[5].lower()
            if shape not in ("sine", "sinusoidal", "triangle",
                             "triangular"):
                raise ValueError(f"flanger shape {a[5]!r} not "
                                 "supported (sine|triangle)")
            kw["modulation"] = ("sinusoidal" if shape.startswith("sin")
                                else "triangular")
        if len(a) > 6:
            kw["phase"] = _num(a[6], "phase")
        if len(a) > 7:
            interp = a[7].lower()
            if interp not in ("linear", "quadratic"):
                raise ValueError(f"flanger interpolation {a[7]!r} not "
                                 "supported (linear|quadratic)")
            kw["interpolation"] = interp
        return _ops.flanger(wave, sr, **kw), sr
    if name == "vad":
        return _ops.vad(wave, sr), sr
    raise ValueError(
        f"unsupported sox effect {name!r}; supported: "
        + ", ".join(effect_names()))


def apply_effects_tensor(waveform, sample_rate: int,
                         effects: Sequence[Sequence[str]],
                         channels_first: bool = True,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, int]:
    """Apply a sox-style effect chain to an in-memory waveform.

    ``waveform`` is ``(channels, time)`` (``channels_first=True``,
    the torchaudio default), ``(time, channels)``, or 1-D mono: a tensor
    (the chain runs on its device) or a NumPy array (on the CPU).
    Returns ``(waveform, sample_rate)`` with the same layout.
    """
    wave = torch.as_tensor(waveform)
    squeeze = wave.ndim == 1
    if squeeze:
        # a 1-D waveform becomes (1, T), which is ALREADY channel-major
        # — channels_first describes 2-D layouts only (transposing here
        # would put time on the channel axis and silently break every
        # time-axis effect)
        wave = wave[None]
    else:
        if wave.ndim != 2:
            raise ValueError("waveform must be 1-D or 2-D")
        if not channels_first:
            wave = wave.T
    wave = wave.to(torch.float32)
    sr = int(sample_rate)
    for i, eff in enumerate(effects):
        if not eff:
            raise ValueError(f"empty effect at position {i}")
        wave, sr = _apply_one(wave, sr, str(eff[0]).lower(),
                              list(eff[1:]), generator)
    # only un-batch if the chain kept a single channel (a
    # channel-expanding effect like ["channels","2"] must survive)
    if squeeze and wave.shape[0] == 1:
        return wave[0], sr
    if not channels_first:
        wave = wave.T
    return wave, sr


def apply_effects_file(path: str,
                       effects: Sequence[Sequence[str]],
                       channels_first: bool = True,
                       generator: Optional[torch.Generator] = None,
                       device="cuda") -> Tuple[torch.Tensor, int]:
    """Read a WAV file with the package codec, move it to ``device`` (the
    card unless the caller asks for the CPU) and apply the chain there.
    The codec yields ``(channels, time)``; ``channels_first=False`` only
    transposes the returned tensor."""
    from ..io import read_wav
    data, sr = read_wav(path)
    out, sr = apply_effects_tensor(torch.from_numpy(data).to(device), sr,
                                   effects, channels_first=True,
                                   generator=generator)
    if not channels_first and out.ndim == 2:
        out = out.T
    return out, sr
