"""Build and load the native codecs (``wavio.cpp``, ``flacio.cpp``).

Each source is compiled by ``g++ -O3 -fPIC -shared -std=c++17`` into the
kernels' build directory (:func:`..ops._cuda.build_dir`:
``$TAC_TORCH_BUILD_DIR`` when set, else ``_build/`` inside the package),
under a name derived from the hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  The
library is written under a name of this process's and then renamed into
place, so concurrent builders (test workers, loader threads of several
processes) never load a half-written file.  The library is loaded with
ctypes' default local symbol scope: the JAX package's codecs export the
same names and may live in the same process.

When ``g++`` is missing or the build fails, :func:`load_library` returns
None and the caller uses its NumPy / pure-Python fallback (the
``have_native`` functions say which path is in use).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

from ..ops._cuda import build_dir

__all__ = ["load_library"]

_DIR = Path(__file__).resolve().parent
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path(source: str) -> Path:
    """Where the library built from ``source`` lives: its stem and the
    hash of its bytes and :data:`FLAGS`, in the build directory."""
    src = _DIR / source
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(src.read_bytes())
    return build_dir() / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def load_library(source: str) -> Optional[ctypes.CDLL]:
    """The library built from ``source`` (a file beside this module),
    built first if it is not there; None if it cannot be built."""
    so = library_path(source)
    if not so.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            print(f"{source}: g++ not found; using the Python fallback",
                  file=sys.stderr)
            return None
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(
            f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(_DIR / source)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            tmp.unlink(missing_ok=True)
            print(f"{source}: native build failed ({e}); using the Python "
                  "fallback", file=sys.stderr)
            return None
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
