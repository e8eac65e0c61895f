"""Initialisers shared by the port's models.

Port of ``torchaudio_contrib_tpu/models/_common.py``: Glorot-uniform
kernels and zero biases, drawn from a ``torch.Generator`` where the JAX
package draws from a PRNG key.  The JAX package's ``_ln`` (eps 1e-5, the
population variance) is ``nn.LayerNorm``'s default and needs no helper.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["_glorot_", "_dense", "_pointwise"]


def _glorot_(t: torch.Tensor, fan_in: int, fan_out: int,
             generator, scale: float = 1.0) -> torch.Tensor:
    """Fill ``t`` in place from U(-s, s), s = sqrt(6 / (fan_in + fan_out)),
    times ``scale``."""
    s = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-s, s, generator=generator).mul_(scale)
    return t


def _dense(cin: int, cout: int, generator, bias: bool = True) -> nn.Linear:
    """``nn.Linear(cin, cout)`` with a Glorot-uniform weight and a zero
    bias: the JAX package's ``_dense`` kernel, transposed."""
    lin = nn.Linear(cin, cout, bias=bias)
    _glorot_(lin.weight, cin, cout, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def _pointwise(cin: int, cout: int, generator) -> nn.Conv1d:
    """A kernel-1 ``nn.Conv1d`` initialised as :func:`_dense` (torchaudio
    names a pointwise convolution's weight ``(cout, cin, 1)``)."""
    conv = nn.Conv1d(cin, cout, 1)
    _glorot_(conv.weight, cin, cout, generator)
    nn.init.zeros_(conv.bias)
    return conv
