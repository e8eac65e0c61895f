"""Initialisers and the precision rule shared by the port's models.

Port of ``torchaudio_contrib_tpu/models/_common.py``: Glorot-uniform
kernels and zero biases, drawn from a ``torch.Generator`` where the JAX
package draws from a PRNG key.  The JAX package's ``_ln`` (eps 1e-5, the
population variance) is ``nn.LayerNorm``'s default and needs no helper.

:func:`_fp32_cudnn` wraps each model's outermost ``forward``/``infer``:
its convolutions and cuDNN RNNs run in FP32 whatever
``torch.backends.cudnn.allow_tf32`` says (True by default, which would
run them in TF32), as the ops' convolutions do, and so does a backward
pass through its outputs.
"""
from __future__ import annotations

import functools
import math
import threading

import torch
from torch import nn

__all__ = ["_glorot_", "_dense", "_conv", "_pointwise", "_fp32_cudnn"]

# the ids of the backward passes (autograd graph tasks) that reached a
# pinned output and hold cuDNN's TF32 flag off until they end; the flag is
# the process's, so is this record (passes on other threads share both)
_PINNED_PASSES = set()
_PINNED_LOCK = threading.Lock()


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


def _restore_tf32(task: int, allow: bool):
    with _PINNED_LOCK:
        torch.backends.cudnn.allow_tf32 = allow
        _PINNED_PASSES.discard(task)


def _enter_fp32_backward(grad):
    """Tensor hook on a pinned output: the first to fire in a backward pass
    turns cuDNN's TF32 off and queues the flag's restore for the end of the
    pass.  The engine runs a pass's queued callbacks first in, first out,
    so a nested model's pin, firing later in the same pass, queues
    nothing; a pass nested in another (a reentrant checkpoint) has its own
    id and restores the value it found."""
    task = torch._C._current_graph_task_id()
    with _PINNED_LOCK:
        if task in _PINNED_PASSES:
            return
        _PINNED_PASSES.add(task)
        allow = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
    torch.autograd.Variable._execution_engine.queue_callback(
        functools.partial(_restore_tf32, task, allow))


def _pin_backward(out):
    """Hook every floating tensor of ``out`` (nested tuples, lists and dict
    values) that requires grad with :func:`_enter_fp32_backward`."""
    if isinstance(out, torch.Tensor):
        if out.requires_grad and out.is_floating_point():
            out.register_hook(_enter_fp32_backward)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _pin_backward(o)
    elif isinstance(out, dict):
        for o in out.values():
            _pin_backward(o)


def _fp32_cudnn(fn):
    """Run the method ``fn`` under ``torch.backends.cudnn.flags`` with
    ``allow_tf32=False``: cuDNN's convolutions and RNNs in FP32.

    ``cudnn.flags`` resets every flag it is not given, so ``enabled``,
    ``benchmark``, ``deterministic`` (and ``benchmark_limit`` where cuDNN
    is there) are passed at the values in force at the call.  The cuBLAS
    flag ``torch.backends.cuda.matmul.allow_tf32`` (False by default) is
    left to the caller.

    The backward pass runs later, when the caller asks for it, under the
    flags in force then; so each floating output that requires grad gets a
    hook (:func:`_pin_backward`): a backward pass (``backward()`` or
    ``torch.autograd.grad``) that reaches one runs cuDNN without TF32 from
    there to its end, the other flags as they are, and sets
    ``allow_tf32`` back to its value when the pass ends."""
    @functools.wraps(fn)
    def pinned(*args, **kwargs):
        c = torch.backends.cudnn
        kept = {"benchmark_limit": c.benchmark_limit} \
            if c.is_available() else {}
        with c.flags(enabled=c.enabled, benchmark=c.benchmark,
                     deterministic=c.deterministic, allow_tf32=False,
                     **kept):
            out = fn(*args, **kwargs)
        if torch.is_grad_enabled():
            _pin_backward(out)
        return out
    return pinned
