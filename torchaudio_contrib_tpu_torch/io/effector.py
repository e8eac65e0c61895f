"""``AudioEffector`` — apply an effect chain + codec round-trip to an
in-memory waveform (torchaudio's ``io.AudioEffector`` capability).

The port of the JAX package's ``io/effector.py``.  torchaudio's effector
drives ffmpeg filter graphs and encoders; here the semantics are re-based
on the package's own surfaces, as in the JAX package:

- ``effect`` is a SoX-style chain string (the ``sox_effects``
  dispatch; e.g. ``"speed 1.2, lowpass 300"`` — comma-separated
  effects, space-separated args), not an ffmpeg filter description.
  Unknown effect names raise loudly with the supported list.
- ``format``/``encoder`` map onto :func:`..ops.apply_codec` (WAV
  family: PCM_S 8/16/24/32, PCM_U, ULAW, ALAW); compressed codecs
  raise loudly.

Layout follows torchaudio: ``apply(waveform (time, channel),
sample_rate)`` → ``(time, channel)``; ``stream(...)`` yields the same
result in ``frames_per_chunk`` slices (effects here are applied
whole-clip first — bit-identical to ``apply``, chunking is an output
convenience, not a latency path; the true streaming frontend is
``parallel.StreamingSTFT``).  The chain runs on the waveform's device (a
tensor's, or the CPU for a NumPy array) and returns tensors there.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch


def _parse_chain(effect: Optional[str]) -> List[List[str]]:
    if not effect:
        return []
    chain = []
    for part in effect.split(","):
        toks = part.split()
        if toks:
            chain.append(toks)
    return chain


class AudioEffector:
    """Apply ``effect`` (SoX-style chain string) and/or a ``format``
    codec round-trip to waveforms in memory.

    ``AudioEffector(effect="speed 1.2, lowpass 300",
    format="wav", encoder="PCM_U")``; ``apply(waveform, sample_rate)``
    with ``waveform (time, channel)`` float32.
    """

    def __init__(self, effect: Optional[str] = None,
                 format: Optional[str] = None, *,
                 encoder: Optional[str] = None,
                 bits_per_sample: Optional[int] = None,
                 pad_end: bool = True):
        self.effect = effect
        self._chain = _parse_chain(effect)   # validated at init time
        self.format = format
        self.encoder = encoder
        self.bits_per_sample = bits_per_sample
        self.pad_end = bool(pad_end)
        if format is not None and format != "wav":
            raise ValueError(
                f"AudioEffector supports format='wav' only (got "
                f"{format!r}): compressed codecs need ffmpeg/sox, "
                "not available in this build")
        if self._chain:
            from .. import sox_effects
            known = set(sox_effects.effect_names())
            bad = [c[0] for c in self._chain if c[0] not in known]
            if bad:
                raise ValueError(
                    f"unknown effect(s) {bad}; supported: "
                    f"{sorted(known)}")

    def _run(self, waveform, sample_rate: int):
        if isinstance(waveform, torch.Tensor):
            wave = waveform.to(torch.float32)
        else:
            wave = torch.from_numpy(np.asarray(waveform, np.float32))
        if wave.ndim == 1:
            wave = wave[:, None]
        if wave.ndim != 2:
            raise ValueError(
                "waveform must be (time, channel) — torchaudio's "
                "AudioEffector layout")
        out, sr = wave.T, int(sample_rate)    # -> (channel, time)
        if self._chain:
            from .. import sox_effects
            out, sr = sox_effects.apply_effects_tensor(
                out, sr, self._chain, channels_first=True)
        if self.format is not None:
            from ..ops import apply_codec
            out = apply_codec(out, sr, format=self.format,
                              encoding=self.encoder,
                              bits_per_sample=self.bits_per_sample)
        return out.T, sr                      # -> (time, channel)

    def apply(self, waveform, sample_rate: int) -> torch.Tensor:
        """Effect chain + codec round trip; ``(time, channel)`` in
        and out (sample rate may change under rate-changing effects
        — matching ``sox_effects`` semantics)."""
        out, _ = self._run(waveform, sample_rate)
        return out

    def stream(self, waveform, sample_rate: int,
               frames_per_chunk: int) -> Iterator[torch.Tensor]:
        """Yield ``apply``'s result in ``(frames_per_chunk, channel)``
        slices; with ``pad_end`` the last chunk is zero-padded to the
        full chunk length."""
        if frames_per_chunk <= 0:
            raise ValueError("frames_per_chunk must be positive")
        out, _ = self._run(waveform, sample_rate)
        n = out.shape[0]
        for start in range(0, n, frames_per_chunk):
            chunk = out[start:start + frames_per_chunk]
            if chunk.shape[0] < frames_per_chunk and self.pad_end:
                chunk = torch.nn.functional.pad(
                    chunk, (0, 0, 0, frames_per_chunk - chunk.shape[0]))
            yield chunk
