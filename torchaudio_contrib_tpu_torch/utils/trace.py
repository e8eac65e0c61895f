"""The port's spans and counters, for a ``torch.profiler`` trace.

:func:`span` marks a stretch of host code as ``tac::<name>`` in the trace
of a profiler that is recording, and costs a check of one flag otherwise
(a shared no-op context is returned): there is no switch, the spans are on
exactly while someone profiles.  A span is a record of the profiler's
function scope, so that:

* the profiler links each operation launched inside it (a kernel, a copy,
  a fill) to it or to an operation nested in it, and a trace reader can put
  every device row down to the innermost span that launched it;
* it adds no row on the device's timeline: the device rows of a trace are
  the operations alone, with spans on or off.

Spans never synchronise and change no result or launch order.  The port
marks the fused log-mel op and the classifier's training step:

=========================  ===================================================
``fused_mel``              ``ops.fused_melspectrogram`` on a CUDA tensor
``fused_mel.fwd``          the forward kernel's launch, with the filterbank
                           padded for it
``fused_mel.bwd``          the backward of the fused op, with three children:
``fused_mel.dmel``         the dB gate and the cotangent laid out in rows
``fused_mel.bwd_launch``   the backward kernel's launch, with its operands
``fused_mel.overlap_add``  the frame gradients added onto the waveform
``classifier.step``        ``MelFrontendClassifier.train_step``, with
                           ``classifier.forward``, ``classifier.loss``,
                           ``classifier.grad`` (``torch.autograd.grad``) and
                           ``classifier.update`` (the SGD loop)
``classifier.forward``     ``MelFrontendClassifier.forward``, with
                           ``classifier.frontend``, ``classifier.conv<i>``
                           (pad, convolution and ReLU of block ``i``) and
                           ``classifier.head``
=========================  ===================================================

The CPU path of the fused op takes no span.  A backward runs on autograd's
own thread on the card, so ``fused_mel.bwd`` opens there, inside whatever
span the caller holds on its own thread.

Counters are host integers, read as one by :func:`counts` and
:func:`delta`:

* ``CONST_UPLOADS``, ``CONST_UPLOAD_BYTES``: the tensors and bytes the
  fused op's caches of constants (DFT basis, window, twiddles) copy from
  the host to a device.  They move only when a cache fills, so a move over
  a steady run means the caches thrash.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["span", "counts", "delta"]

PREFIX = "tac::"

CONST_UPLOADS = 0
CONST_UPLOAD_BYTES = 0
_COUNTERS = ("CONST_UPLOADS", "CONST_UPLOAD_BYTES")

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
# function scope: a user-scope record (``torch.profiler.record_function``)
# would also put a row of its own on the device's timeline
record_function = getattr(torch._C._profiler, "_RecordFunctionFast",
                          torch.profiler.record_function)


def span(name: str):
    """A context that marks its body as ``tac::<name>`` while a profiler
    records; a shared no-op context otherwise."""
    if _recording():
        return record_function(PREFIX + name)
    return _OFF


def uploaded(*tensors: torch.Tensor) -> None:
    """Count the constants in ``tensors`` that were copied from the host
    to a device (those on the CPU were not)."""
    global CONST_UPLOADS, CONST_UPLOAD_BYTES
    for t in tensors:
        if t.device.type != "cpu":
            CONST_UPLOADS += 1
            CONST_UPLOAD_BYTES += t.numel() * t.element_size()


def counts() -> dict:
    """``{"COUNTER": value}`` of every counter."""
    return {name: globals()[name] for name in _COUNTERS}


def delta(before: dict) -> dict:
    """What each counter moved since ``before`` (a :func:`counts`)."""
    return {k: v - before[k] for k, v in counts().items()}
