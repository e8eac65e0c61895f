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
marks the fused log-mel op, the classifier's training step, the wav2vec2
family's forward, the greedy CTC decode and the transducer stream pool's step:

=========================  ===================================================
``fused_mel``              ``ops.fused_melspectrogram`` on a CUDA tensor
``fused_mel.fwd``          the forward kernel's launch, with the filterbank
                           padded for it
``fused_mel.bwd``          the backward of the fused op, with three children:
``fused_mel.dmel``         the dB gate and the cotangent laid out in rows
``fused_mel.bwd_launch``   the backward kernel's launch, with its operands
                           and outputs (the waveform gradient where the
                           frame pass writes it)
``fused_mel.overlap_add``  the frame gradients added onto the waveform on
                           the host; it does not open where the frame
                           pass writes the waveform gradient itself
``classifier.step``        ``MelFrontendClassifier.train_step``, with
                           ``classifier.forward``, ``classifier.loss``,
                           ``classifier.grad`` (``torch.autograd.grad``) and
                           ``classifier.update`` (the SGD loop) where the
                           step runs eagerly or is captured, and
                           ``classifier.replay`` where it is replayed from
                           a CUDA graph (the input copies, the graph's
                           launch and the loss's copy)
``classifier.forward``     ``MelFrontendClassifier.forward``, with
                           ``classifier.frontend``, ``classifier.conv<i>``
                           (pad, convolution and ReLU of block ``i``) and
                           ``classifier.head``
``w2v2.forward``           ``Wav2Vec2.forward`` (WavLM, HuBERT and the LARGE
                           variants share it), with the children below; a
                           pre-LN encoder's closing LayerNorm is its own time
``w2v2.extract``           the strided convolutions, their norms and GELUs
``w2v2.project``           the output lengths and pad mask, the LayerNorm
                           and projection, the zeroing of padded frames
``w2v2.pos_conv``          the pad, grouped convolution and GELU of the
                           positional embedding, a post-LN encoder's
                           LayerNorm
``w2v2.layer``             one encoder layer, with ``w2v2.attention`` and
                           ``w2v2.ffn``, each holding the LayerNorm that
                           opens (pre-LN) or closes (post-LN) it; the
                           padded frames' zeroing is the layer's own
``w2v2.head``              the CTC head (``aux``), where there is one
``ctc.greedy``             ``ops.ctc_greedy_decode``: argmax, collapse and
                           compaction
``rnnt.step``              ``RNNTStreamPool.step``: the per-slot arguments
                           staged and copied to the card, then either
                           ``rnnt.features`` (each slot's window of
                           samples and the extractor), ``rnnt.reset``
                           (``RNNT.reset_stream_slots``), ``rnnt.encode``
                           (``Emformer.infer`` and the projection) and
                           ``rnnt.decode`` (the greedy frames and symbols)
                           where the step runs eagerly or is captured, or
                           ``rnnt.replay.encode`` (the input copy and the
                           encode graph's launch) and ``rnnt.replay.decode``
                           (the decode graph's launch and the outputs'
                           copies) where it is replayed
=========================  ===================================================

Layers, as ``PERF.md`` names them: ``fused_mel``, ``classifier.step``,
``classifier.replay``, ``classifier.forward`` and ``w2v2.forward`` are the
entry and dispatch;
``fused_mel.fwd`` and ``fused_mel.bwd*`` launch the fused kernels;
``classifier.conv<i>``, ``classifier.grad``, ``w2v2.extract``,
``w2v2.pos_conv`` and the encoder's spans (``w2v2.project``, ``.layer``,
``.attention``, ``.ffn``, ``.head``) run the library kernels (cuDNN,
cuBLAS); ``ctc.greedy`` is the decode, aten kernels only; ``rnnt.step``
and ``rnnt.replay.*`` are the entry and dispatch, ``rnnt.features``,
``rnnt.encode`` and ``rnnt.decode`` run the library kernels (cuFFT,
cuBLAS) and aten's, ``rnnt.reset`` aten's alone.

The CPU path of the fused op takes no span.  A backward runs on autograd's
own thread on the card, so ``fused_mel.bwd`` opens there, inside whatever
span the caller holds on its own thread.

Counters are host integers, read as one by :func:`counts` and
:func:`delta`:

* ``CONST_UPLOADS``, ``CONST_UPLOAD_BYTES``: the tensors and bytes the
  fused op's caches of constants (DFT basis, window, twiddles) copy from
  the host to a device.  They move only when a cache fills, so a move over
  a steady run means the caches thrash.
* ``STEP_GRAPH_CAPTURES``, ``STEP_GRAPH_REFUSED``: the training steps
  ``MelFrontendClassifier.train_step`` captured into a CUDA graph, and the
  signatures it left eager because their capture failed
  (``models/_step_graph.py``).  A capture moves once a signature, in
  set-up, so a move over a steady run means the graphs thrash.
* ``STEP_GRAPH_REPLAYS``: the steps replayed from those graphs.  It moves
  by one a replayed call, so over a steady run it reads the calls, the one
  counter of :func:`counts` that is work and not a fault.  The stream
  pool's steps (``RNNTStreamPool``) are captured, replayed and refused
  under the same three counters.
* ``RNNT_SLOT_RESETS``: the utterances ``RNNTStreamPool.step`` began in a
  slot, its state reset on the card; over a steady run, the utterances
  that ended and were followed in their slot.

Another counter of work, read as the module's attribute and not one of
:func:`counts`:

* ``W2V2_FRAMES``: the encoder frames a wav2vec2-family forward computed,
  ``batch · T'`` a call, padded frames included; counted from the shapes
  the host holds (:func:`encoded`), never from a device value.  Over the
  valid frames of the requests it gives the share of the encoder's work
  that padding took.
* ``RNNT_VALID_FRAMES``: the utterance frames (10 ms feature frames)
  ``RNNTStreamPool.step`` advanced its slots by, counted from the host's
  arguments; segments past an utterance's end and the lookahead are not
  counted.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["span", "counts", "delta"]

PREFIX = "tac::"

CONST_UPLOADS = 0
CONST_UPLOAD_BYTES = 0
STEP_GRAPH_CAPTURES = 0
STEP_GRAPH_REPLAYS = 0
STEP_GRAPH_REFUSED = 0
RNNT_SLOT_RESETS = 0
_COUNTERS = ("CONST_UPLOADS", "CONST_UPLOAD_BYTES", "STEP_GRAPH_CAPTURES",
             "STEP_GRAPH_REPLAYS", "STEP_GRAPH_REFUSED", "RNNT_SLOT_RESETS")
W2V2_FRAMES = 0
RNNT_VALID_FRAMES = 0

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


def encoded(frames: int) -> None:
    """Count ``frames`` encoder frames computed (``W2V2_FRAMES``)."""
    global W2V2_FRAMES
    W2V2_FRAMES += int(frames)


def counts() -> dict:
    """``{"COUNTER": value}`` of every counter."""
    return {name: globals()[name] for name in _COUNTERS}


def delta(before: dict) -> dict:
    """What each counter moved since ``before`` (a :func:`counts`)."""
    return {k: v - before[k] for k, v in counts().items()}
