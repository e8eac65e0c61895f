"""Faults planted under the timed path, to show that a cell's check
fails them: ``wrap(kind, factory)`` gives a factory whose program has the
fault.  Kinds:

* ``unchanged``: a training step returns its loss and leaves every
  parameter as it was;
* ``half``: half of the batch left out; a training step takes the mean
  over the rest, a forward answers the left-out half with the other
  half's rows;
* ``altered``: one answer altered where it is produced: one output
  element moved by 1 (a forward), one parameter moved as if one gradient
  element were off by 1 (a training step);
* ``late``: sound for a training cell's ``WARM_STEPS`` warm-up calls,
  ``altered`` from then on: a path that changes once warm.
"""
from __future__ import annotations

import torch

from .drivers.train_step import WARM_STEPS

KINDS = ("unchanged", "half", "altered", "late")


class Faulty:
    def __init__(self, prog, kind: str):
        self._prog, self._kind, self._calls = prog, kind, 0

    def __getattr__(self, name):
        return getattr(self._prog, name)

    def _altered(self) -> bool:
        self._calls += 1
        return self._kind == "altered" or (self._kind == "late"
                                           and self._calls > WARM_STEPS)

    def __call__(self, x):
        if self._kind == "half":
            h = x.shape[0] // 2
            y = self._prog(x[:h])
            return torch.cat([y, y[:x.shape[0] - h]])
        y = self._prog(x)
        if self._altered():
            y = y.clone()
            y[(0,) * y.ndim] += 1.0
        return y

    def train_step(self, x, labels, lr):
        if self._kind == "unchanged":
            with torch.no_grad():
                return self._prog.loss_fn(x, labels)
        if self._kind == "half":
            h = x.shape[0] // 2
            return self._prog.train_step(x[:h], labels[:h], lr)
        loss = self._prog.train_step(x, labels, lr)
        if self._altered():
            with torch.no_grad():
                p = dict(self._prog.named_parameters())["head.bias"]
                p.view(-1)[0] -= lr * 1.0
        return loss


def wrap(kind: str, factory):
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}")

    def build(cfg, gen, device):
        prog, given = factory(cfg, gen, device)
        return Faulty(prog, kind), given
    return build
