"""Kaldi ark/scp table IO (pure Python, no kaldi_io dependency).

The port of the JAX package's ``kaldi_io``: torchaudio's ``kaldi_io``
reader surface (``read_vec_int_ark``, ``read_vec_flt_ark/scp``,
``read_mat_ark/scp`` — there it wraps the ``kaldi_io`` pip package; here
the binary format is parsed directly).  Reads yield CPU tensors (float32
or float64 as stored, int32 for integer vectors); the writers take tensors
(on any device) or arrays and write the JAX package's bytes.

Writers (``write_mat_ark``, ``write_vec_flt_ark``,
``write_vec_int_ark``) are an extra: they emit Kaldi-binary archives
plus optional ``.scp`` index files so pipelines can hand features to
(or take alignments from) a Kaldi system — the natural companion to
:mod:`.compliance.kaldi`'s feature parity.

Format notes (Kaldi binary table):
``<key> \\0B<object>`` per entry; float/double matrices are
``FM ``/``DM `` + ``\\x04``-prefixed int32 rows/cols + row-major
data; vectors are ``FV ``/``DV `` + size; int32 vectors are a size
then one ``\\x04``-prefixed int32 per element.  ``.scp`` lines are
``key path:offset`` with the offset pointing at the ``\\0B`` marker.
Text-mode archives (no ``\\0B``) are read too.  Compressed matrices
(``CM``) raise — decompress with Kaldi's ``copy-feats`` first.
"""
from __future__ import annotations

import struct
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "read_vec_int_ark", "read_vec_flt_ark", "read_vec_flt_scp",
    "read_mat_ark", "read_mat_scp",
    "write_vec_int_ark", "write_vec_flt_ark", "write_mat_ark",
]

_DTYPES = {b"FM": np.float32, b"DM": np.float64,
           b"FV": np.float32, b"DV": np.float64}


def _read_key(f) -> Optional[str]:
    """Space/NUL-terminated token; None at clean EOF.

    EOF in the MIDDLE of a key (a truncated/corrupted archive) raises
    — returning the partial key would let ``_read_object`` fall into
    the text path on the empty remainder and fabricate a phantom
    entry with an empty matrix.
    """
    chars = []
    while True:
        c = f.read(1)
        if not c:
            if chars:
                raise ValueError(
                    "truncated Kaldi archive: EOF inside key "
                    f"{''.join(chars)!r}")
            return None
        if c == b" ":
            if chars:
                return "".join(chars)
            continue
        if c in (b"\n", b"\r"):
            continue
        chars.append(c.decode("ascii"))


def _read_int32(f) -> int:
    marker = f.read(1)
    if marker != b"\x04":
        raise ValueError(
            f"bad int32 size marker {marker!r} (expected \\x04)")
    return struct.unpack("<i", f.read(4))[0]


def _read_object(f):
    """One binary/text Kaldi object at the current position."""
    head = f.read(2)
    if head == b"\x00B":                       # binary mode
        peek = f.read(1)
        if peek == b"\x04":                    # bare int32 vector
            n = struct.unpack("<i", f.read(4))[0]
            out = np.empty(n, np.int32)
            for i in range(n):
                out[i] = _read_int32(f)
            return out
        kind = peek + f.read(2)                # e.g. b"FM "
        tag = kind[:2]
        if tag == b"CM":
            raise ValueError(
                "compressed matrices (CM) are not supported; run "
                "Kaldi copy-feats to decompress first")
        if tag not in _DTYPES:
            raise ValueError(f"unknown Kaldi object type {kind!r}")
        dt = _DTYPES[tag]
        if tag.endswith(b"V"):
            n = _read_int32(f)
            return np.frombuffer(f.read(n * dt().itemsize),
                                 dtype=dt).copy()
        rows = _read_int32(f)
        cols = _read_int32(f)
        data = np.frombuffer(f.read(rows * cols * dt().itemsize),
                             dtype=dt)
        return data.reshape(rows, cols).copy()
    # text mode: tokens until the closing bracket / end of line
    rest = head + f.readline()
    text = rest.decode("ascii").strip()
    if text.startswith("["):                   # matrix/vector
        body = text[1:]
        while "]" not in body:
            line = f.readline().decode("ascii")
            if not line:
                raise ValueError("unterminated text-mode object")
            body += "\n" + line
        body = body[:body.index("]")]
        rows = [r.split() for r in body.strip().splitlines()
                if r.strip()]
        arr = np.asarray([[float(v) for v in r] for r in rows],
                         np.float32)
        return arr[0] if arr.shape[0] == 1 and "\n" not in \
            body.strip() else arr
    return np.asarray([int(v) for v in text.split()], np.int32)


def _iter_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    with open(path, "rb") as f:
        while True:
            key = _read_key(f)
            if key is None:
                return
            yield key, _read_object(f)


def _iter_scp(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    with open(path, encoding="utf-8") as f:
        entries = [ln.split(None, 1) for ln in f if ln.strip()]
    for key, loc in entries:
        loc = loc.strip()
        if ":" not in loc:
            raise ValueError(f"scp entry {key!r} lacks an offset")
        fname, off = loc.rsplit(":", 1)
        with open(fname, "rb") as f:
            f.seek(int(off))
            yield key, _read_object(f)


def read_mat_ark(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Iterate ``(key, (rows, cols) tensor)`` from a matrix ark."""
    for key, obj in _iter_ark(path):
        yield key, torch.from_numpy(np.atleast_2d(obj))


def read_mat_scp(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Iterate ``(key, matrix)`` resolving an scp index."""
    for key, obj in _iter_scp(path):
        yield key, torch.from_numpy(np.atleast_2d(obj))


def read_vec_flt_ark(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Iterate ``(key, float vector)`` from an ark."""
    for key, obj in _iter_ark(path):
        yield key, torch.from_numpy(np.ravel(obj))


def read_vec_flt_scp(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    for key, obj in _iter_scp(path):
        yield key, torch.from_numpy(np.ravel(obj))


def read_vec_int_ark(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Iterate ``(key, int32 vector)`` (e.g. alignments)."""
    for key, obj in _iter_ark(path):
        yield key, torch.from_numpy(np.ravel(obj).astype(np.int32))


# ------------------------------------------------------------ writers
def _write_entries(path, items, encoder, scp_path):
    scp = []
    with open(path, "wb") as f:
        for key, value in items:
            # whitespace/control chars corrupt the archive silently
            # (the reader skips \n/\r, the scp index is line/space
            # delimited) and non-ASCII fails encode below anyway
            if (not key or any(ch.isspace() for ch in key)
                    or any(ord(ch) < 0x21 for ch in key)):
                raise ValueError(f"bad Kaldi key {key!r}")
            f.write(key.encode("ascii") + b" ")
            scp.append(f"{key} {path}:{f.tell()}")
            f.write(b"\x00B")
            encoder(f, value)
    if scp_path is not None:
        with open(scp_path, "w", encoding="utf-8") as f:
            f.write("\n".join(scp) + "\n")


def _host(value) -> np.ndarray:
    """A tensor (on any device) or array-like as a host array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _enc_mat(f, value):
    m = _host(value)
    if m.ndim != 2:
        raise ValueError("matrices must be 2-D")
    if m.dtype == np.float64:
        tag, dt = b"DM ", np.float64
    else:
        tag, dt = b"FM ", np.float32
    f.write(tag)
    f.write(b"\x04" + struct.pack("<i", m.shape[0]))
    f.write(b"\x04" + struct.pack("<i", m.shape[1]))
    f.write(np.ascontiguousarray(m, dt).tobytes())


def _enc_vec_flt(f, value):
    v = np.ravel(_host(value))
    if v.dtype == np.float64:
        tag, dt = b"DV ", np.float64
    else:
        tag, dt = b"FV ", np.float32
    f.write(tag)
    f.write(b"\x04" + struct.pack("<i", v.size))
    f.write(np.ascontiguousarray(v, dt).tobytes())


def _enc_vec_int(f, value):
    v = np.ravel(_host(value)).astype(np.int32)
    f.write(b"\x04" + struct.pack("<i", v.size))
    for x in v:
        f.write(b"\x04" + struct.pack("<i", int(x)))


def write_mat_ark(path: str, items: Sequence[Tuple[str, object]],
                  scp_path: Optional[str] = None) -> None:
    """Write ``(key, matrix)`` pairs as a Kaldi-binary ark
    (+ optional scp index)."""
    _write_entries(path, items, _enc_mat, scp_path)


def write_vec_flt_ark(path: str,
                      items: Sequence[Tuple[str, object]],
                      scp_path: Optional[str] = None) -> None:
    _write_entries(path, items, _enc_vec_flt, scp_path)


def write_vec_int_ark(path: str,
                      items: Sequence[Tuple[str, object]],
                      scp_path: Optional[str] = None) -> None:
    _write_entries(path, items, _enc_vec_int, scp_path)
