"""Initialisers and the precision rule shared by the port's models.

Port of ``torchaudio_contrib_tpu/models/_common.py``: Glorot-uniform
kernels and zero biases, drawn from a ``torch.Generator`` where the JAX
package draws from a PRNG key.  The JAX package's ``_ln`` (eps 1e-5, the
population variance) is ``nn.LayerNorm``'s default and needs no helper.

:func:`_fp32_cudnn` wraps each model's outermost ``forward``/``infer``:
its convolutions and cuDNN RNNs run in FP32 whatever
``torch.backends.cudnn.allow_tf32`` says (True by default, which would
run them in TF32), as the ops' convolutions do.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

__all__ = ["_glorot_", "_dense", "_conv", "_pointwise", "_fp32_cudnn"]


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


def _conv(cin: int, cout: int, k: int, generator,
          bias: bool = True) -> nn.Conv1d:
    """An unpadded ``nn.Conv1d(cin, cout, k)`` with the JAX package's
    ``_conv`` init: Glorot-uniform over ``k·cin`` in and ``k·cout`` out,
    zero bias."""
    conv = nn.Conv1d(cin, cout, k, bias=bias)
    _glorot_(conv.weight, k * cin, k * cout, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def _pointwise(cin: int, cout: int, generator) -> nn.Conv1d:
    """A kernel-1 ``nn.Conv1d`` initialised as :func:`_dense` (torchaudio
    names a pointwise convolution's weight ``(cout, cin, 1)``)."""
    conv = nn.Conv1d(cin, cout, 1)
    _glorot_(conv.weight, cin, cout, generator)
    nn.init.zeros_(conv.bias)
    return conv


def _fp32_cudnn(fn):
    """Run the method ``fn`` under ``torch.backends.cudnn.flags`` with
    ``allow_tf32=False``: cuDNN's convolutions and RNNs in FP32.

    ``cudnn.flags`` resets every flag it is not given, so ``enabled``,
    ``benchmark``, ``deterministic`` (and ``benchmark_limit`` where cuDNN
    is there) are passed at the values in force at the call.  The cuBLAS
    flag ``torch.backends.cuda.matmul.allow_tf32`` (False by default) is
    left to the caller.  A backward pass runs under the flags in force
    when the caller runs it."""
    @functools.wraps(fn)
    def pinned(*args, **kwargs):
        c = torch.backends.cudnn
        kept = {"benchmark_limit": c.benchmark_limit} \
            if c.is_available() else {}
        with c.flags(enabled=c.enabled, benchmark=c.benchmark,
                     deterministic=c.deterministic, allow_tf32=False,
                     **kept):
            return fn(*args, **kwargs)
    return pinned
