"""Closed loop of forward calls under ``torch.inference_mode()``: call
``i`` takes the waveform batch its length and pool index name, on the
device.  Outputs of the calls ``Traffic.keep`` draws are copied into
buffers made in set-up; after the window each is held to the reference
(the system's ``check_forward``)."""
from __future__ import annotations

import torch

from ..loop import Closed


class Runner(Closed):
    def __init__(self, ctx):
        self.ctx, sysm, t = ctx, ctx.system, ctx.traffic
        self.device = ctx.device
        self.prog, self.given = ctx.factory(ctx.cfg, ctx.gen, ctx.device)
        self.xs = t.waveforms(ctx.gen, ctx.device)
        streams = t.clips * t.channels
        self.frames = [streams * sysm.frames(ctx.cfg, n) for n in t.samples]
        self.work = [sysm.work(ctx.cfg, streams, n, "forward")
                     for n in t.samples]
        outs = {}
        with torch.inference_mode():
            for l in range(len(t.samples)):      # every shape, twice
                for _ in range(2):
                    y = sysm.forward(self.prog, self.xs[l][0])
                outs[l] = y
        self.buffers = {i: torch.empty(outs[t.call(i)[0]].shape,
                                       device=ctx.device)
                        for i in t.keep()}
        self.kept = []

    def step(self, i, spans):
        l, p = self.ctx.traffic.call(i)
        with spans("entry"), torch.inference_mode():
            y = self.ctx.system.forward(self.prog, self.xs[l][p])
        buf = self.buffers.get(i)
        if buf is not None:
            with spans("keep"):
                buf.copy_(y)
            self.kept.append(((l, p), self.xs[l][p], buf))
        return l

    def check(self) -> dict:
        self.prog = None
        return self.ctx.system.check_forward(self.ctx.cfg, self.given,
                                             self.kept)
