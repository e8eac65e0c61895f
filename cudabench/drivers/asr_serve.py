"""Closed loop of padded batches of speech requests under
``torch.inference_mode()``, one caller, calls back to back: call ``i``
takes batch ``i % pool`` of the pool, runs the system's ``forward`` (the
model on the padded waveforms and their lengths, then the decode) and
copies the tokens and their counts into pinned host buffers without a
synchronise.

The mix's ``clip_seconds`` gives the shortest and the longest request.
The pool's ``clips · pool`` request lengths are drawn independently and
uniformly from that range, ``clips`` to a batch, once from the mix's
``length_seed`` and not from the run's seed: every seed serves the same
batches of the same padded shapes in the same order, so a run's rate
does not follow its seed's draw of padding nor the kernels its padded
lengths select (as ``gen.Traffic`` gives every seed the same clip
lengths).  The seed draws the order of the requests in each batch, the
waveforms (Gaussian, ``amplitude``, zero past each request's length,
drawn on the device) and the weights.  Every batch shape is warmed
twice.

Outputs of the calls ``Traffic.keep`` draws (emissions, log-probabilities,
output lengths, tokens and token counts) are copied into buffers made in
set-up; after the window each is held to the reference (the system's
``check_forward``).  The window's summary adds ``w2v2_frames``: what the
program's ``W2V2_FRAMES`` counter moved over it, where the program has
that counter."""
from __future__ import annotations

import numpy as np
import torch

from ..loop import Closed


def draw_lengths(clips: int, pool: int, shortest: int, longest: int,
                 length_seed: int, seed: int) -> list:
    """``[batch][request]`` lengths in samples (module docstring)."""
    fixed = np.random.default_rng(length_seed).integers(
        shortest, longest + 1, size=(pool, clips))
    order = np.random.default_rng([seed, 2])
    return [[int(row[j]) for j in order.permutation(clips)]
            for row in fixed]


def _frames_counted():
    """The program's ``W2V2_FRAMES``, or None where it has no such
    counter."""
    try:
        from torchaudio_contrib_tpu_torch.utils import trace
    except ImportError:
        return None
    return getattr(trace, "W2V2_FRAMES", None)


class Runner(Closed):
    def __init__(self, ctx):
        self.ctx, sysm, t = ctx, ctx.system, ctx.traffic
        self.device = dev = ctx.device
        self.prog, self.given = ctx.factory(ctx.cfg, ctx.gen, dev)
        self.lengths = draw_lengths(t.clips, t.pool, min(t.samples),
                                    max(t.samples),
                                    int(ctx.mix["length_seed"]), t.seed)
        amp = float(ctx.mix.get("amplitude", 0.1))
        self.xs, self.ls = [], []
        for row in self.lengths:
            n = torch.tensor(row, device=dev)
            x = torch.randn((len(row), max(row)), generator=ctx.gen,
                            device=dev) * amp
            keep = torch.arange(max(row), device=dev)[None] < n[:, None]
            self.xs.append(torch.where(keep, x, 0.0))
            self.ls.append(n)
        self.frames = [sum(sysm.frames(ctx.cfg, n) for n in row)
                       for row in self.lengths]
        self.work = [sysm.work(ctx.cfg, row, max(row))
                     for row in self.lengths]
        outs = {}
        with torch.inference_mode():
            for b in range(t.pool):              # every shape, twice
                for _ in range(2):
                    out = sysm.forward(self.prog, self.xs[b], self.ls[b])
                outs[b] = out
        pinned = torch.device(dev).type == "cuda"
        self.host = [tuple(torch.empty(o.shape, dtype=o.dtype,
                                       pin_memory=pinned)
                           for o in outs[b][3:]) for b in range(t.pool)]
        self.buffers = {i: [torch.empty(o.shape, dtype=o.dtype, device=dev)
                            for o in outs[i % t.pool]] for i in t.keep()}
        self.kept = []

    def step(self, i, spans):
        b = i % self.ctx.traffic.pool
        with spans("entry"), torch.inference_mode():
            out = self.ctx.system.forward(self.prog, self.xs[b], self.ls[b])
            for h, o in zip(self.host[b], out[3:]):
                h.copy_(o, non_blocking=True)
        bufs = self.buffers.get(i)
        if bufs is not None:
            with spans("keep"):
                for buf, o in zip(bufs, out):
                    buf.copy_(o)
            self.kept.append((b, self.xs[b], self.ls[b], *bufs))
        return b

    def run(self, seconds, spans, start):
        """``Closed.run`` with the program's frame count's move."""
        before = _frames_counted()
        out = super().run(seconds, spans, start)
        if before is not None:
            out["w2v2_frames"] = _frames_counted() - before
        return out

    def check(self) -> dict:
        self.prog = None
        return self.ctx.system.check_forward(self.ctx.cfg, self.given,
                                             self.kept)
