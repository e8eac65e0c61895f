"""A training step replayed from a CUDA graph.

``MelFrontendClassifier.train_step`` issues the same launches on every call
whose inputs share a signature (:func:`signature`): only the batch's
values change between them.  :func:`run` records the step's launches
(forward, loss, ``torch.autograd.grad`` and the in-place SGD update) into
one CUDA graph and replays it, so that the host enqueues a step as two
input copies, one graph launch and the loss's copy.

What engages it is what the call shows; there is no switch:

* a CPU input, labels or a parameter or buffer off the input's device, a
  waveform that requires grad, an ``lr`` that is not a plain number, or a
  stream that some other code is capturing: the step runs eagerly;
* the first call of a signature runs eagerly; it fills every first-use
  cache (the kernels' build, their constants on the card, cuDNN's plans)
  outside any graph;
* the second captures the step on a side stream into a private memory
  pool (as ``utils.timing.device_loop`` does) and replays it; later calls
  only replay.  A model keeps ``MAX_GRAPHS`` graphs, the least recently
  used out first, so that a caller whose clip length changes every step
  does not pile up pools;
* a capture that fails leaves its signature eager for the model's life
  and counts ``STEP_GRAPH_REFUSED``; nothing ran during the capture, so
  the step then runs eagerly and its numbers are the eager step's.

A replay copies the batch into the graph's static inputs, replays, moves
the launch counters by the capture's moves (``ops._launches``) and returns
a copy of the static loss, which the next replay overwrites.  The
parameters are updated in their own storage, so a copy into them between
calls is seen by the next replay.  The Python the step runs is run once,
at capture: a hook added to the model later, or a cache of constants
cleared, is not seen by a replay.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
import itertools
import numbers
import weakref

import torch

from ..ops import _launches
from ..utils import trace
from ..utils.timing import capture_graph
from ..utils.trace import span

MAX_GRAPHS = 4      # captured steps a model keeps
MAX_SEEN = 16       # signatures seen once, waiting for their second call

_MODELS = weakref.WeakKeyDictionary()


@dataclass
class _Graph:
    """One captured step: the graph, its static inputs and loss, and the
    launch counters' moves a replay stands for."""
    graph: torch.cuda.CUDAGraph
    waveform: torch.Tensor
    labels: torch.Tensor
    loss: torch.Tensor
    launches: dict

    def replay(self, waveform: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
        self.waveform.copy_(waveform)
        self.labels.copy_(labels)
        self.graph.replay()
        _launches.add(self.launches)
        trace.STEP_GRAPH_REPLAYS += 1
        return self.loss.clone()


@dataclass
class _Steps:
    """A model's signatures: seen once, captured, refused."""
    seen: OrderedDict = field(default_factory=OrderedDict)
    graphs: OrderedDict = field(default_factory=OrderedDict)
    refused: set = field(default_factory=set)


def _tensors(model):
    return itertools.chain(model.parameters(), model.buffers())


def signature(model, waveform: torch.Tensor, labels: torch.Tensor,
              lr) -> tuple:
    """What a captured step depends on besides the batch's values: the
    inputs' shape, dtype and device, ``lr``, each parameter's and buffer's
    identity, storage and ``requires_grad``, grad mode, and the flags the
    step's kernels are chosen under (cuDNN's, cuBLAS's TF32, deterministic
    algorithms, autocast)."""
    cudnn = torch.backends.cudnn
    return ((tuple(waveform.shape), waveform.dtype, waveform.device),
            (tuple(labels.shape), labels.dtype, labels.device), lr,
            tuple((id(t), t.data_ptr(), t.requires_grad)
                  for t in _tensors(model)),
            torch.is_grad_enabled(), cudnn.enabled, cudnn.benchmark,
            cudnn.deterministic, torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_autocast_enabled("cuda"),
            torch.get_autocast_dtype("cuda"))


def _engages(model, waveform, labels, lr) -> bool:
    if not (isinstance(waveform, torch.Tensor)
            and isinstance(labels, torch.Tensor) and waveform.is_cuda
            and not waveform.requires_grad
            and isinstance(lr, numbers.Real)):
        return False
    device = waveform.device
    if labels.device != device or any(t.device != device
                                      for t in _tensors(model)):
        return False
    return not torch.cuda.is_current_stream_capturing()


def _capture(step, waveform: torch.Tensor, labels: torch.Tensor,
             lr) -> _Graph | None:
    """``step`` on static inputs shaped as the call's, captured into a
    graph (``utils.timing.capture_graph``); None if the capture failed."""
    device = waveform.device
    x = torch.empty(waveform.shape, dtype=waveform.dtype, device=device)
    y = torch.empty(labels.shape, dtype=labels.dtype, device=device)
    try:
        graph, loss, moves, _, _ = capture_graph(lambda: step(x, y, lr),
                                                 device)
    except RuntimeError:
        return None
    trace.STEP_GRAPH_CAPTURES += 1
    return _Graph(graph, x, y, loss, moves)


def run(model, step, waveform, labels, lr):
    """``step(waveform, labels, lr)`` for ``model``: eagerly, or replayed
    from the graph of the call's signature (the module's docstring says
    when)."""
    if not _engages(model, waveform, labels, lr):
        return step(waveform, labels, lr)
    key = signature(model, waveform, labels, lr)
    steps = _MODELS.setdefault(model, _Steps())
    graph = steps.graphs.get(key)
    if graph is None:
        if key in steps.refused:
            return step(waveform, labels, lr)
        if steps.seen.pop(key, None) is None:
            loss = step(waveform, labels, lr)
            steps.seen[key] = True
            if len(steps.seen) > MAX_SEEN:
                steps.seen.popitem(last=False)
            return loss
        graph = _capture(step, waveform, labels, lr)
        if graph is None:
            steps.refused.add(key)
            trace.STEP_GRAPH_REFUSED += 1
            return step(waveform, labels, lr)
        steps.graphs[key] = graph
        if len(steps.graphs) > MAX_GRAPHS:
            steps.graphs.popitem(last=False)
    else:
        steps.graphs.move_to_end(key)
    with span("classifier.replay"):
        return graph.replay(waveform, labels)
