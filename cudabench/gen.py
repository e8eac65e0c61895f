"""The one traffic generator: reads a mix's parameters (a file of
``traffic/``) and draws from the seed what every call of a run gets.

A mix names its ``driver`` (a module of ``drivers/``) and gives:

* ``clips``, ``channels``: the waveforms of one call, ``(clips, channels,
  samples)``;
* ``clip_seconds``: the clip lengths; a call's length is one of them;
* ``pool``: distinct waveforms made for each length (cycled in order);
* ``amplitude``: the waveform's standard deviation (Gaussian noise);
* ``keep``: how many calls' outputs are kept for the check, drawn from the
  seed among the first ``keep_span`` calls of the window;
* driver parameters, e.g. ``lr`` for a training step.

Lengths come in blocks: every block of ``len(clip_seconds)`` calls holds
each length once, in an order drawn from the seed, so every seed gets the
same sizes in another order.  The waveforms are drawn on the device from a
``torch.Generator`` seeded with the run's seed.
"""
from __future__ import annotations

import numpy as np
import torch


class Traffic:
    def __init__(self, mix: dict, sample_rate: float, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.clips = int(mix["clips"])
        self.channels = int(mix.get("channels", 1))
        self.seconds = [float(s) for s in mix["clip_seconds"]]
        self.samples = [int(round(s * sample_rate)) for s in self.seconds]
        self.pool = int(mix["pool"])
        self._rng = np.random.default_rng(self.seed)
        self._lengths = np.zeros(0, dtype=np.int64)

    def generator(self, device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(self.seed)

    def waveforms(self, gen: torch.Generator, device) -> list:
        """``[length][pool]`` waveforms ``(clips, channels, samples)``,
        float32, one draw a length."""
        amp = float(self.mix.get("amplitude", 0.1))
        out = []
        for n in self.samples:
            x = torch.randn((self.pool, self.clips, self.channels, n),
                            generator=gen, device=device) * amp
            out.append(list(x.unbind(0)))
        return out

    def call(self, i: int) -> tuple:
        """``(length index, pool index)`` of call ``i``."""
        n = len(self.samples)
        while i >= len(self._lengths):
            block = np.stack([self._rng.permutation(n) for _ in range(1024)])
            self._lengths = np.concatenate([self._lengths, block.ravel()])
        return int(self._lengths[i]), (i // n) % self.pool

    def keep(self) -> list:
        """Sorted call indices whose outputs are kept for the check."""
        k, span = int(self.mix.get("keep", 0)), int(self.mix.get("keep_span",
                                                                  256))
        rng = np.random.default_rng([self.seed, 1])
        return sorted(int(i) for i in rng.choice(span, size=min(k, span),
                                                 replace=False))
