"""Steps replayed from CUDA graphs: a training step, and an inference step
whose state lives in static buffers.

A step issues the same launches on every call whose inputs share a
signature: only the inputs' values change between them.  Two kinds of
step are replayed:

* ``MelFrontendClassifier.train_step`` (:func:`run`): forward, loss,
  ``torch.autograd.grad`` and the in-place SGD update recorded into one
  CUDA graph, so that the host enqueues a step as two input copies, one
  graph launch and the loss's copy;
* an inference step in stages (:func:`run_stages`; ``RNNTStreamPool``'s
  ``encode`` and ``decode``): each stage recorded into a graph of its own,
  the stages replayed back to back, so that a trace still puts the step's
  rows down to its stages.  The step reads and updates its owner's state
  in place (static buffers the signature names), takes its inputs through
  static copies, and returns copies of the last stage's outputs.

What engages a graph is what the call shows; there is no switch:

* a CPU input, labels or a parameter, buffer or held tensor off the
  input's device, a waveform that requires grad, an ``lr`` that is not a
  plain number, or a stream that some other code is capturing: the step
  runs eagerly;
* the first call of a signature runs eagerly; it fills every first-use
  cache (the kernels' build, their constants on the card, cuDNN's plans,
  cuFFT's) outside any graph;
* the second captures the step on a side stream into private memory pools
  (as ``utils.timing.device_loop`` does) and replays it; later calls
  only replay.  An owner (a model, a stream pool) keeps ``MAX_GRAPHS``
  captured steps, the least recently used out first, so that a caller
  whose clip length changes every step does not pile up pools;
* a capture that fails leaves its signature eager for the owner's life
  and counts ``STEP_GRAPH_REFUSED``; nothing ran during the capture, so
  the step then runs eagerly and its numbers are the eager step's.

A replay copies the inputs into the graph's static inputs, replays, moves
the launch counters by the capture's moves (``ops._launches``) and returns
copies of the static outputs, which the next replay overwrites.
Parameters and state are read and updated in their own storage, so a copy
into them between calls is seen by the next replay.  The Python the step
runs is run once, at capture: a hook added to the model later, or a cache
of constants cleared, is not seen by a replay.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
import functools
import itertools
import numbers
import weakref

import torch

from ..ops import _launches
from ..utils import trace
from ..utils.timing import capture_graph
from ..utils.trace import span

MAX_GRAPHS = 4      # captured steps an owner keeps
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
    """An owner's signatures: seen once, captured, refused."""
    seen: OrderedDict = field(default_factory=OrderedDict)
    graphs: OrderedDict = field(default_factory=OrderedDict)
    refused: set = field(default_factory=set)


def _tensors(model):
    return itertools.chain(model.parameters(), model.buffers())


def _shape(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


def _held(tensors) -> tuple:
    return tuple((id(t), t.data_ptr(), t.requires_grad) for t in tensors)


def _flags() -> tuple:
    """The grad mode and the flags a step's kernels are chosen under."""
    cudnn = torch.backends.cudnn
    return (torch.is_grad_enabled(), cudnn.enabled, cudnn.benchmark,
            cudnn.deterministic, torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_autocast_enabled("cuda"),
            torch.get_autocast_dtype("cuda"))


def signature(model, waveform: torch.Tensor, labels: torch.Tensor,
              lr) -> tuple:
    """What a captured step depends on besides the batch's values: the
    inputs' shape, dtype and device, ``lr``, each parameter's and buffer's
    identity, storage and ``requires_grad``, grad mode, and the flags the
    step's kernels are chosen under (cuDNN's, cuBLAS's TF32, deterministic
    algorithms, autocast)."""
    return (_shape(waveform), _shape(labels), lr,
            _held(_tensors(model)), *_flags())


def _on_device(device, tensors) -> bool:
    return (all(t.device == device for t in tensors)
            and not torch.cuda.is_current_stream_capturing())


def _engages(model, waveform, labels, lr) -> bool:
    if not (isinstance(waveform, torch.Tensor)
            and isinstance(labels, torch.Tensor) and waveform.is_cuda
            and not waveform.requires_grad
            and isinstance(lr, numbers.Real)):
        return False
    return _on_device(waveform.device, (labels, *_tensors(model)))


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


def _graph_for(owner, key, capture):
    """The captured step to replay for ``key``, or None where this call
    runs eagerly (the module's docstring says when); ``capture()`` makes
    one, or returns None where the capture failed."""
    steps = _MODELS.setdefault(owner, _Steps())
    graph = steps.graphs.get(key)
    if graph is not None:
        steps.graphs.move_to_end(key)
        return graph
    if key in steps.refused:
        return None
    if steps.seen.pop(key, None) is None:
        steps.seen[key] = True
        if len(steps.seen) > MAX_SEEN:
            steps.seen.popitem(last=False)
        return None
    graph = capture()
    if graph is None:
        steps.refused.add(key)
        trace.STEP_GRAPH_REFUSED += 1
        return None
    steps.graphs[key] = graph
    if len(steps.graphs) > MAX_GRAPHS:
        steps.graphs.popitem(last=False)
    return graph


def run(model, step, waveform, labels, lr):
    """``step(waveform, labels, lr)`` for ``model``: eagerly, or replayed
    from the graph of the call's signature (the module's docstring says
    when)."""
    if _engages(model, waveform, labels, lr):
        graph = _graph_for(
            model, signature(model, waveform, labels, lr),
            lambda: _capture(step, waveform, labels, lr))
        if graph is not None:
            with span("classifier.replay"):
                return graph.replay(waveform, labels)
    return step(waveform, labels, lr)


@dataclass
class _Stages:
    """One captured step in stages: a graph and the launch counters' moves
    a stage, the static inputs, and the last stage's outputs."""
    names: tuple
    graphs: list
    launches: list
    inputs: tuple
    outputs: tuple

    def replay(self, inputs, name: str, mark) -> tuple:
        last = len(self.names) - 1
        for k, stage in enumerate(self.names):
            if mark is not None:
                mark(stage)
            with span(f"{name}.replay.{stage}"):
                if k == 0:
                    for static, x in zip(self.inputs, inputs):
                        static.copy_(x)
                self.graphs[k].replay()
                _launches.add(self.launches[k])
                if k == last:
                    out = tuple(o.clone() for o in self.outputs)
        if mark is not None:
            mark(None)
        trace.STEP_GRAPH_REPLAYS += 1
        return out


def _run_eager(stages, inputs, mark) -> tuple:
    out = inputs
    for stage, fn in stages:
        if mark is not None:
            mark(stage)
        out = fn(*out)
    if mark is not None:
        mark(None)
    return out


def _capture_stages(stages, inputs) -> _Stages | None:
    """Each stage captured into a graph of its own, in order, the first
    on static inputs shaped as the call's and each later one on the
    outputs of the one before; None if a capture failed."""
    device = inputs[0].device
    static = tuple(torch.empty(x.shape, dtype=x.dtype, device=device)
                   for x in inputs)
    graphs, moves, out = [], [], static
    try:
        for _, fn in stages:
            graph, out, moved, _, _ = capture_graph(
                functools.partial(fn, *out), device)
            graphs.append(graph)
            moves.append(moved)
    except RuntimeError:
        return None
    trace.STEP_GRAPH_CAPTURES += 1
    return _Stages(tuple(name for name, _ in stages), graphs, moves, static,
                   out)


def _stages_engage(inputs, held) -> bool:
    device = inputs[0].device
    return device.type == "cuda" and _on_device(device, (*inputs, *held))


def run_stages(owner, stages, inputs: tuple, held: tuple, name: str,
               mark=None) -> tuple:
    """An inference step of ``owner`` in ``stages`` (``(name, fn)``: the
    first ``fn`` takes ``inputs``, each later one the tuple the one before
    returns), eagerly or replayed from the stages' graphs (the module's
    docstring says when).  ``held`` are the tensors the stages read or
    update in place, which the signature names; ``mark(stage)`` is called
    as each stage begins and ``mark(None)`` after the last."""
    if _stages_engage(inputs, held):
        key = (tuple(_shape(x) for x in inputs), _held(held), *_flags())
        graph = _graph_for(owner, key,
                           lambda: _capture_stages(stages, inputs))
        if graph is not None:
            return graph.replay(inputs, name, mark)
    return _run_eager(stages, inputs, mark)
