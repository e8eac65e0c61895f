"""Closed loop of training steps: call ``i`` is the system's
``train_step`` on its waveform batch and integer labels drawn from the
seed, at the mix's ``lr``.

Set-up builds the one model, keeps its parameters as they start (``p0``)
and drives it through ``WARM_STEPS`` calls with this same ``step``, which
warm every shape up; then it copies ``p0`` back into that same model, so
that the window starts from the weights the benchmark made.  The window's
first ``CHECKED`` steps are the checked ones: their batches, which all
differ, and losses are kept, and so are the parameters after the first and
after the third.  After the window the reference follows those three steps
from the same weights (the system's ``check_train``)."""
from __future__ import annotations

import torch

from ..loop import Closed, Spans

WARM_STEPS = 3
CHECKED = 3


class Runner(Closed):
    def __init__(self, ctx):
        self.ctx, sysm, t = ctx, ctx.system, ctx.traffic
        self.device = ctx.device
        self.lr = float(ctx.mix["lr"])
        self.prog, self.given = ctx.factory(ctx.cfg, ctx.gen, ctx.device)
        self.xs = t.waveforms(ctx.gen, ctx.device)
        classes = ctx.cfg["args"]["num_classes"]
        self.labels = [list(torch.randint(0, classes, (t.pool, t.clips),
                                          generator=ctx.gen,
                                          device=ctx.device).unbind(0))
                       for _ in t.samples]
        streams = t.clips * t.channels
        self.frames = [streams * sysm.frames(ctx.cfg, n) for n in t.samples]
        self.work = [sysm.work(ctx.cfg, streams, n, "train")
                     for n in t.samples]
        p0 = self.snapshot()
        for i in range(WARM_STEPS):
            self.step(i, Spans())
        with torch.no_grad():
            for k, v in sysm.params(self.prog).items():
                v.copy_(p0[k])
        self.rec = {"p0": p0, "losses": [], "batches": [], "lr": self.lr}

    def snapshot(self) -> dict:
        return {k: v.detach().clone()
                for k, v in self.ctx.system.params(self.prog).items()}

    def step(self, i, spans):
        l, p = self.ctx.traffic.call(i)
        x, labels = self.xs[l][p], self.labels[l][p]
        with spans("entry"):
            loss = self.ctx.system.train_step(self.prog, x, labels, self.lr)
        rec = getattr(self, "rec", None)
        if rec is not None and len(rec["losses"]) < CHECKED:
            with spans("keep"):
                rec["losses"].append(loss)
                rec["batches"].append((x, labels))
                if len(rec["losses"]) in (1, CHECKED):
                    rec[f"p{len(rec['losses'])}"] = self.snapshot()
        return l

    def check(self) -> dict:
        self.prog = None
        rec = dict(self.rec, losses=[float(v) for v in self.rec["losses"]])
        if len(rec["losses"]) < CHECKED:
            return {"steps_checked": float(len(rec["losses"]))}
        return self.ctx.system.check_train(self.ctx.cfg, self.given, rec)
