"""Device-resident benchmark timing: ``k`` applications of a function as
one dispatch.

Port of ``torchaudio_contrib_tpu/utils/timing.py``.  The host dispatches
each kernel on its own, and for a function of many small launches that
per-launch host time hides the card's.  The JAX package chains ``k``
applications inside one jitted ``fori_loop``; here the ``k`` applications
and their running sum are captured once into a CUDA graph, and one replay
(one launch of the graph) runs them all.

The JAX loop scales its input by ``1 + 1e-30·i`` only to stop XLA from
hoisting ``f(x)`` out of the loop.  A replay runs every captured launch
again, so there is nothing to stop, and the scale (which rounds to 1.0 in
float32, and would cost a pass over the input per application here) is
dropped: the value is the JAX function's, ``Σ_{i<k} sum(f(x))``.

A CPU tensor runs the ``k`` applications eagerly: the caller asked for the
CPU.  Anything else is put on the card, and a function the capture cannot
take (a host sync such as ``.item()`` or ``.cpu()``, a pageable
host-to-device copy, work on a stream the capture does not see) raises; it
is not run eagerly instead.

The launch counters of ``ops.fused`` and ``ops.fused_griffinlim`` move in
the wrappers' Python code, which runs once, at capture; each replay adds
the capture's moves to them (``ops._launches``), so that they count what
the card ran.
"""
from __future__ import annotations

from dataclasses import dataclass
import functools
import time

import torch

__all__ = ["device_loop", "time_device_loop", "time_device_loop_p"]


@dataclass
class _Capture:
    """One captured loop: the graph, the static input it reads, the 0-d
    sum it writes, the counters' moves a replay stands for, and the seconds
    the capture and the graph's instantiation took."""
    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    total: torch.Tensor
    launches: dict
    capture_s: float
    instantiate_s: float


def _name(f) -> str:
    f = getattr(f, "func", f)       # a functools.partial
    return getattr(f, "__qualname__", type(f).__name__)


def _sum(out: torch.Tensor) -> torch.Tensor:
    return out.sum(dtype=torch.float32)


def _release_generators(device: torch.device) -> None:
    """After a capture CUDA invalidated, ``capture_end`` raises before it
    takes the CUDA generator out of capture mode, and every later draw on
    the card would then raise: give it a fresh state with the same seed
    and offset."""
    gen = torch.cuda.default_generators[device.index]
    gen.graphsafe_set_state(gen.clone_state())


class _Loop:
    """:func:`device_loop`'s callable; ``captures`` holds its graphs by the
    input's ``(shape, dtype, device)``."""

    def __init__(self, f, k: int):
        if k < 1:
            raise ValueError(f"k must be at least 1, got {k}")
        self.f, self.k, self.captures = f, int(k), {}

    def __call__(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device_loop: no CUDA device for a non-tensor input "
                    "(pass a CPU tensor to run on the CPU)")
            x = torch.as_tensor(x, device="cuda")
        if x.device.type == "cpu":
            total = torch.zeros((), dtype=torch.float32)
            for _ in range(self.k):
                total = total + _sum(self.f(x))
            return total
        if x.device.type != "cuda":
            raise ValueError(f"device_loop: unsupported device {x.device}")
        key = (tuple(x.shape), x.dtype, x.device)
        cap = self.captures.get(key)
        if cap is None:
            cap = self.captures[key] = self._capture(x)
        else:
            cap.x.copy_(x)
        cap.graph.replay()
        from ..ops import _launches     # ops imports utils (its spans)
        _launches.add(cap.launches)
        return cap.total.clone()

    def _capture(self, x: torch.Tensor) -> _Capture:
        """Warm ``f`` up on a side stream (every first-use cache, the
        kernels' build among them, is filled outside the graph), then
        capture the ``k`` applications and their sum into one graph
        (:func:`capture_graph`)."""
        dev = x.device
        static = x.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.f(static)
        torch.cuda.current_stream(dev).wait_stream(side)

        def applications():
            total = torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(self.k):
                total = total + _sum(self.f(static))
            return total

        try:
            graph, total, moves, capture_s, instantiate_s = capture_graph(
                applications, dev, side)
        except RuntimeError as e:
            first = e.__context__ or e
            raise RuntimeError(
                f"device_loop: {_name(self.f)} cannot be captured into a "
                f"CUDA graph: {str(first).splitlines()[0]}"
                + ("" if first is e else
                   f" (then: {str(e).splitlines()[0]})")) from e
        return _Capture(graph, static, total, moves, capture_s,
                        instantiate_s)


def capture_graph(fn, device: torch.device, stream=None) -> tuple:
    """``fn()`` captured on ``stream`` (a new side stream by default) into
    a ``CUDAGraph(keep_graph=True)`` with a private memory pool, and
    instantiated: ``(graph, out, moves, capture_s, instantiate_s)``, where
    ``out`` is ``fn``'s output, which each replay writes anew, and
    ``moves`` the launch counters' moves a replay stands for
    (``ops._launches.add(moves)`` at each replay; the capture launched
    nothing, so they are taken off again here).  A failed capture raises
    CUDA's error after giving the card's default generator a fresh state
    (:func:`_release_generators`)."""
    from ..ops import _launches     # ops imports utils (its spans)
    side = stream or torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = _launches.counts()
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, stream=side):
            out = fn()
    except RuntimeError:
        _release_generators(device)
        raise
    finally:
        moves = _launches.delta(before)
        _launches.add(moves, -1)
    t1 = time.perf_counter()
    torch.cuda.current_stream(device).wait_stream(side)
    graph.instantiate()
    return graph, out, moves, t1 - t0, time.perf_counter() - t1


def device_loop(f, k: int = 16):
    """``x -> 0-d float32 tensor`` on ``x``'s device: ``Σ_{i<k}
    sum(f(x))``, the ``k`` applications one CUDA graph replay on the card
    (eager on a CPU tensor).  The first call with a given shape, dtype and
    device warms ``f`` up and captures the graph; later ones copy ``x``
    into its static input and replay it.  Tensors ``f`` closes over are
    read where they lie at each replay."""
    return _Loop(f, k)


def _best_seconds(looped: _Loop, x, reps: int) -> float:
    """The JAX package's method: the first call captures and warms up;
    then the best of ``reps`` replays, each timed from its start to the
    scalar on the host, over ``k``."""
    float(looped(x))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(looped(x))
        best = min(best, (time.perf_counter() - t0) / looped.k)
    return best


def time_device_loop(f, x, k: int = 16, reps: int = 3) -> float:
    """Best-of-``reps`` seconds per single application of ``f(x)``, from
    one replay of ``k`` applications (:func:`device_loop`) to the scalar on
    the host."""
    return _best_seconds(device_loop(f, k), x, reps)


def time_device_loop_p(f, params, x, k: int = 2, reps: int = 3) -> float:
    """:func:`time_device_loop` of ``f(params, x)``: ``params`` (a module
    or a dict of tensors) is read where it lies at each replay, as the JAX
    package passes its parameter pytree as an argument rather than baking
    it into the program."""
    return time_device_loop(functools.partial(f, params), x, k, reps)
