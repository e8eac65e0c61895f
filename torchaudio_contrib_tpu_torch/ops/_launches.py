"""The kernels' launch counters, read and moved as one.

The counters are host integers in :mod:`.fused` and
:mod:`.fused_griffinlim`, incremented where a wrapper launches its kernel.
A CUDA graph runs the wrapper's Python code once, at capture, and its
kernels at every replay: :func:`counts` before and after a capture gives
the graph's launches, and :func:`add` puts them on the counters at each
replay (and takes them off again after the capture, which launched
nothing), so that a counter keeps counting what the card ran.

The card keeps some counters itself (``fused.CARD_COUNTERS``: launches
whose blocks took a banded product, which only the card knows), in mapped
host memory that a replayed kernel moves as an eager one does.
:func:`counts` reads them with the rest, with no synchronise; :func:`add`
leaves them alone.
"""
from __future__ import annotations

from . import fused, fused_griffinlim

_COUNTERS = {
    fused: ("KERNEL_LAUNCHES", "BWD_KERNEL_LAUNCHES", "BWD_DFRAMES_LAUNCHES",
            "FFT_KERNEL_LAUNCHES", "BWD_FFT_LAUNCHES",
            "BWD_DX_FUSED_LAUNCHES", "BWD_DFB_LAUNCHES",
            "BWD_DFB_ONE_READ_LAUNCHES", "MEL_BAND_LAUNCHES"),
    fused_griffinlim: ("GL_KERNEL_LAUNCHES", "GL_TILE_MAJOR_LAUNCHES",
                       "GL_FFT_LAUNCHES"),
}


def counts() -> dict:
    """``{"module.COUNTER": value}`` of every launch counter, the card's
    included."""
    out = {f"{m.__name__.rsplit('.', 1)[-1]}.{name}": getattr(m, name)
           for m, names in _COUNTERS.items() for name in names}
    out.update({f"fused.{name}": value
                for name, value in fused.card_counts().items()})
    return out


def delta(before: dict) -> dict:
    """What each counter moved since ``before`` (a :func:`counts`)."""
    return {k: v - before[k] for k, v in counts().items()}


def add(moves: dict, times: int = 1) -> None:
    """Move each host counter by ``times`` × its entry in ``moves`` (a
    :func:`delta`); the card's count their replays themselves."""
    for m, names in _COUNTERS.items():
        short = m.__name__.rsplit(".", 1)[-1]
        for name in names:
            setattr(m, name, getattr(m, name)
                    + times * moves.get(f"{short}.{name}", 0))
