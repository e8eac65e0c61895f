"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per source, all started together (the shared headers
``csrc/*.cuh`` are found beside them), and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, into ``_build/`` beside the package sources, under a
name derived from the sources' hash, so an edited source is rebuilt and
an unchanged one is loaded as it is.  There is no
fallback: if ``nvcc`` is missing or the build fails, :func:`load` raises
with the compiler's output.

Nothing here runs at import time; CPU-only callers never reach it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_info: dict = {}


def _find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME  # finds the toolkit
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (not on PATH, and no CUDA toolkit under CUDA_HOME): "
        "the CUDA kernels of torchaudio_contrib_tpu_torch cannot be built")


def _sources():
    srcs = sorted(_CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    return srcs, sorted(_CSRC.glob("*.cuh"))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tac_fused_mel_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                      i, f, f, p]
    lib.tac_fused_mel_fwd.restype = i
    lib.tac_fused_mel_fft_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                          i, i, f, f, p]
    lib.tac_fused_mel_fft_fwd.restype = i
    lib.tac_fused_mel_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i,
                                      i, i, i, i, i, p]
    lib.tac_fused_mel_bwd.restype = i
    lib.tac_fused_gl_solve.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                       i, i, i, i, f, i, p]
    lib.tac_fused_gl_solve.restype = i
    lib.tac_fused_gl_solve_fft.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                           i, i, i, i, f, i, p]
    lib.tac_fused_gl_solve_fft.restype = i
    for tile in (lib.tac_fused_mel_fwd_tile, lib.tac_fused_mel_fft_tile,
                 lib.tac_fused_mel_bwd_tile, lib.tac_fused_gl_tile):
        tile.argtypes = [i]
        tile.restype = i
    lib.tac_error_string.argtypes = [i]
    lib.tac_error_string.restype = ctypes.c_char_p
    return lib


def _run_all(cmds) -> str:
    """Run the commands side by side; raise with the compiler's output if
    any fails, else return their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code "
                               f"{proc.returncode}:\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _build_and_load() -> ctypes.CDLL:
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in srcs + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    so = _BUILD / f"libtac_kernels_{h.hexdigest()[:16]}.so"
    log = so.with_suffix(".log")
    built = False
    seconds = 0.0
    if not so.exists():
        nvcc = _find_nvcc()
        _BUILD.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        objs = [so.with_name(f"{src.stem}.{tag}.o") for src in srcs]
        tmp = so.with_name(f"{so.name}.{tag}")
        t0 = time.perf_counter()
        try:
            out = _run_all([[nvcc, *_FLAGS, "-I", str(_CSRC), "-c", "-o",
                             str(obj), str(src)]
                            for src, obj in zip(srcs, objs)])
            out += _run_all([[nvcc, *_ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)]])
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        log.write_text(out)
        os.replace(tmp, so)
        built = True
    _info.update(path=str(so), built=built, seconds=seconds,
                 log=log.read_text() if log.exists() else "")
    return _declare(ctypes.CDLL(str(so)))


def load() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build_and_load()
        return _lib


def build_info() -> dict:
    """``path``, ``built`` (False when an existing build was loaded),
    ``seconds`` of this process's ``nvcc`` run and the compiler ``log``
    (``-Xptxas -v``: registers, shared memory, spills).  Empty before
    :func:`load`."""
    return dict(_info)
