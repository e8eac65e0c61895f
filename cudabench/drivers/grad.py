"""Closed loop of forward + backward calls: call ``i`` runs the system's
``forward``, then its ``backward`` (``torch.autograd.grad`` to the
waveform and the trainable parameters) on its waveform batch against a cotangent drawn
from the seed for that batch.  Outputs of the kept calls are copied into
buffers made in set-up and held to the reference (``check_grad``)."""
from __future__ import annotations

import torch

from ..loop import Closed


class Runner(Closed):
    def __init__(self, ctx):
        self.ctx, sysm, t = ctx, ctx.system, ctx.traffic
        self.device = ctx.device
        self.prog, self.given = ctx.factory(ctx.cfg, ctx.gen, ctx.device)
        self.xs = [[x.requires_grad_(True) for x in row]
                   for row in t.waveforms(ctx.gen, ctx.device)]
        self.gs = []
        for n in t.samples:
            shape = sysm.out_shape(ctx.cfg, t.clips, t.channels, n)
            self.gs.append(list(torch.randn((t.pool, *shape), generator=ctx.gen,
                                            device=ctx.device).unbind(0)))
        streams = t.clips * t.channels
        self.frames = [streams * sysm.frames(ctx.cfg, n) for n in t.samples]
        self.work = [sysm.work(ctx.cfg, streams, n, "grad")
                     for n in t.samples]
        outs = {}
        for l in range(len(t.samples)):          # every shape, twice
            for _ in range(2):
                x, g = self.xs[l][0], self.gs[l][0]
                y = sysm.forward(self.prog, x)
                outs[l] = (y, *sysm.backward(self.prog, x, y, g))
        self.buffers = {i: [torch.empty_like(o) for o in outs[t.call(i)[0]]]
                        for i in t.keep()}
        self.kept = []

    def step(self, i, spans):
        l, p = self.ctx.traffic.call(i)
        x, sysm = self.xs[l][p], self.ctx.system
        with spans("entry"):
            y = sysm.forward(self.prog, x)
        with spans("grad"):
            out = (y, *sysm.backward(self.prog, x, y, self.gs[l][p]))
        bufs = self.buffers.get(i)
        if bufs is not None:
            with spans("keep"), torch.no_grad():
                for b, o in zip(bufs, out):
                    b.copy_(o)
            self.kept.append(((l, p), x, self.gs[l][p], *bufs))
        return l

    def check(self) -> dict:
        self.prog = None
        return self.ctx.system.check_grad(self.ctx.cfg, self.given, self.kept)
