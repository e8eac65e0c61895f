"""Audio IO of the port: native WAV + FLAC codecs (C++ via ctypes) with
pure NumPy/Python fallbacks.

The port's copy of the JAX package's ``io`` (importing that one would run
the JAX package's ``__init__``, which imports JAX).  The same files decode
to the same samples, and the writers write the same bytes.  Corpus
preprocessing (BASELINE config 5) needs the host-side loader to keep pace
with the card, so decode is native C++ (``wavio.cpp``/``flacio.cpp``,
built with ``g++`` on first use into the build directory by
:mod:`._native`); the pure-Python fallbacks keep the API available
without a toolchain, and :func:`have_native` / :func:`have_native_flac`
say which path is in use.

Decoding is host work: every reader returns NumPy float32 ``(channels,
frames)`` on the host (``CorpusPreprocessor``'s loader contract); the
root's :func:`~torchaudio_contrib_tpu_torch.load` moves it to a device.

API: ``read_wav(path|bytes) -> (data (channels, frames) float32, sr)``,
``write_wav(path, data, sr, bits=16|32)``; ``read_flac``/``write_flac``/
``flac_info`` likewise (``_flac.py``); ``read_audio``/``audio_info``/
``write_audio`` dispatch on content magic (read) or file extension
(write).  ``write_*`` take NumPy arrays or tensors.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ._flac import (read_flac, write_flac, flac_info,
                    have_native_flac, _host_float32)
from ._native import load_library

__all__ = ["read_wav", "write_wav", "wav_info", "have_native",
           "make_wav_loader",
           "read_flac", "write_flac", "flac_info", "have_native_flac",
           "read_audio", "audio_info", "write_audio",
           "StreamReader", "StreamWriter", "SourceAudioStream"]

_lib = None
_lock = threading.Lock()


def _load():
    """The native codec, built on first use; False when it cannot be
    built (the NumPy fallback then runs)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = load_library("wavio.cpp")
            _lib = _declare(lib) if lib is not None else False
        return _lib


def _declare(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.wav_info.restype = ctypes.c_int
    lib.wav_info.argtypes = [u8p, ctypes.c_size_t,
                             ctypes.POINTER(ctypes.c_uint32),
                             ctypes.POINTER(ctypes.c_uint16),
                             ctypes.POINTER(ctypes.c_uint16),
                             ctypes.POINTER(ctypes.c_uint64),
                             ctypes.POINTER(ctypes.c_uint64),
                             ctypes.POINTER(ctypes.c_uint16)]
    lib.wav_decode.restype = ctypes.c_int
    lib.wav_decode.argtypes = [u8p, ctypes.c_size_t, f32p]
    lib.wav_encoded_size.restype = ctypes.c_uint64
    lib.wav_encoded_size.argtypes = [ctypes.c_uint64, ctypes.c_uint16,
                                     ctypes.c_uint16]
    lib.wav_encode.restype = ctypes.c_int64
    lib.wav_encode.argtypes = [f32p, ctypes.c_uint64, ctypes.c_uint16,
                               ctypes.c_uint32, ctypes.c_uint16, u8p,
                               ctypes.c_uint64]
    return lib


def have_native() -> bool:
    return bool(_load())


def _as_bytes(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    with open(src, "rb") as f:
        return f.read()


def wav_info(src) -> dict:
    """Header metadata without decoding samples."""
    buf = _as_bytes(src)
    lib = _load()
    if lib:
        arr = np.frombuffer(buf, np.uint8)
        p = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        sr = ctypes.c_uint32()
        ch = ctypes.c_uint16()
        bits = ctypes.c_uint16()
        nf = ctypes.c_uint64()
        off = ctypes.c_uint64()
        fmt = ctypes.c_uint16()
        rc = lib.wav_info(p, len(buf), ctypes.byref(sr), ctypes.byref(ch),
                          ctypes.byref(bits), ctypes.byref(nf),
                          ctypes.byref(off), ctypes.byref(fmt))
        if rc != 0:
            raise ValueError(f"invalid/unsupported WAV (code {rc})")
        return {"sample_rate": sr.value, "channels": ch.value,
                "bits": bits.value, "num_frames": nf.value,
                "float": fmt.value == 3}
    return _py_info(buf)


def read_wav(src):
    """Decode to float32 ``(channels, frames)`` in [-1, 1] + sample rate."""
    buf = _as_bytes(src)
    info = wav_info(buf)
    lib = _load()
    if lib:
        out = np.empty((info["channels"], info["num_frames"]), np.float32)
        arr = np.frombuffer(buf, np.uint8)
        rc = lib.wav_decode(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise ValueError(f"WAV decode failed (code {rc})")
        return out, info["sample_rate"]
    return _py_decode(buf, info), info["sample_rate"]


def write_wav(path, data: np.ndarray, sample_rate: int,
              bits: int = 16) -> None:
    """Encode float32 ``(channels, frames)`` (or ``(frames,)``) to WAV."""
    data = _host_float32(data)
    if data.ndim == 1:
        data = data[None, :]
    if data.ndim != 2:
        raise ValueError("data must be (channels, frames)")
    ch, nf = data.shape
    lib = _load()
    if lib:
        size = lib.wav_encoded_size(nf, ch, bits)
        out = np.empty(size, np.uint8)
        n = lib.wav_encode(
            np.ascontiguousarray(data).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
            nf, ch, sample_rate, bits,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size)
        if n < 0:
            raise ValueError(f"WAV encode failed (code {n})")
        with open(path, "wb") as f:
            f.write(out[:n].tobytes())
        return
    _py_encode(path, data, sample_rate, bits)


# ------------------------------------------------------- format dispatch

def _sniff(src):
    """(magic-based format, raw bytes-or-path).  Reads only the first
    4 bytes when given a path."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        head = bytes(src[:4])
    else:
        with open(src, "rb") as f:
            head = f.read(4)
    if head == b"fLaC":
        return "flac"
    if head == b"RIFF":
        return "wav"
    raise ValueError(
        f"unrecognized audio container (magic {head!r}): only WAV and "
        "FLAC are decodable natively — convert other formats externally "
        "once")


def read_audio(src):
    """Decode WAV or FLAC (dispatch on content magic, not extension)
    → ``(data (channels, frames) float32, sample_rate)``."""
    return (read_flac if _sniff(src) == "flac" else read_wav)(src)


def audio_info(src) -> dict:
    """Header metadata for WAV or FLAC without decoding samples."""
    return (flac_info if _sniff(src) == "flac" else wav_info)(src)


def write_audio(path, data, sample_rate: int, bits: int = 16) -> None:
    """Encode by file extension: ``.flac`` → FLAC, else WAV."""
    if str(path).lower().endswith(".flac"):
        write_flac(path, data, sample_rate, bits=bits)
    else:
        write_wav(path, data, sample_rate, bits=bits)


def __getattr__(name):
    # StreamReader/StreamWriter live in .stream (imported lazily so the
    # hot corpus-loader import path stays minimal)
    if name in ("StreamReader", "StreamWriter", "SourceAudioStream"):
        from . import stream
        return getattr(stream, name)
    if name == "AudioEffector":
        from .effector import AudioEffector
        return AudioEffector
    raise AttributeError(name)


def __dir__():
    return sorted(list(globals()) + ["StreamReader", "StreamWriter",
                                     "SourceAudioStream",
                                     "AudioEffector"])


# ---------------------------------------------------------------- fallback

def _py_info(buf: bytes) -> dict:
    import struct
    if buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    off, fmt = 12, None
    while off + 8 <= len(buf):
        cid, sz = buf[off:off + 4], struct.unpack("<I", buf[off+4:off+8])[0]
        body = off + 8
        if cid == b"fmt ":
            tag, ch, sr = struct.unpack("<HHI", buf[body:body + 8])
            bits = struct.unpack("<H", buf[body + 14:body + 16])[0]
            if tag == 0xFFFE and sz >= 40:
                tag = struct.unpack("<H", buf[body + 24:body + 26])[0]
            fmt = (tag, ch, sr, bits)
        elif cid == b"data":
            if fmt is None:
                raise ValueError("data before fmt")
            tag, ch, sr, bits = fmt
            if tag not in (1, 3) or bits not in (16, 24, 32):
                raise ValueError("unsupported WAV format")
            if tag == 3 and bits != 32:
                # mirror the native codec: float WAVs are 32-bit only
                # (decoding a 16/24-bit payload as '<f4' would read
                # garbage across sample boundaries)
                raise ValueError("unsupported WAV format")
            return {"sample_rate": sr, "channels": ch, "bits": bits,
                    "num_frames": sz // (ch * bits // 8),
                    "float": tag == 3, "_off": body}
        off = body + sz + (sz & 1)
    raise ValueError("no data chunk")


def _pcm_flat(raw: bytes, bits: int, is_float: bool) -> np.ndarray:
    """Interleaved PCM bytes -> flat float32 in [-1, 1] (the ONE
    conversion table — used by the whole-buffer decoder below and the
    incremental ``io.stream`` reader)."""
    if is_float:
        return np.frombuffer(raw, "<f4").astype(np.float32)
    if bits == 16:
        return (np.frombuffer(raw, "<i2") / 32768.0).astype(np.float32)
    if bits == 32:
        return (np.frombuffer(raw, "<i4")
                / 2147483648.0).astype(np.float32)
    # 24-bit
    b3 = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.uint32)
    v = (b3[:, 0] | (b3[:, 1] << 8) | (b3[:, 2] << 16)).astype(np.int32)
    v[v >= 1 << 23] -= 1 << 24
    return (v / 8388608.0).astype(np.float32)


def _py_decode(buf: bytes, info: dict) -> np.ndarray:
    if "_off" not in info:
        info = _py_info(buf)
    off, ch, nf = info["_off"], info["channels"], info["num_frames"]
    stride = ch * info["bits"] // 8
    x = _pcm_flat(buf[off:off + nf * stride], info["bits"],
                  info["float"])
    return np.ascontiguousarray(
        x.reshape(nf, ch).T.astype(np.float32))


def _py_encode(path, data, sample_rate, bits):
    import struct
    ch, nf = data.shape
    if bits == 16:
        payload = np.clip(data.T * 32767.0, -32768, 32767) \
            .astype("<i2").tobytes()
        tag = 1
    elif bits == 32:
        payload = data.T.astype("<f4").tobytes()
        tag = 3
    else:
        raise ValueError("bits must be 16 or 32")
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, tag, ch, sample_rate,
                         sample_rate * ch * bits // 8, ch * bits // 8,
                         bits) + b"data" + struct.pack("<I", len(payload)))
    with open(path, "wb") as f:
        f.write(hdr + payload)


def make_wav_loader(paths, target_channels=None):
    """Build a ``loader(i)`` for
    :class:`~torchaudio_contrib_tpu_torch.parallel.CorpusPreprocessor` over a
    list of WAV paths: decodes with the native codec, optionally
    downmixes (to mono), truncates, or tiles (mono up) so every item
    has exactly ``target_channels`` rows.  Raises on decode failure
    (the preprocessor's retry/skip handles it)."""
    paths = list(paths)

    def loader(i):
        data, _ = read_wav(paths[i])
        if target_channels is not None and data.shape[0] != target_channels:
            if target_channels == 1:
                data = data.mean(axis=0, keepdims=True)
            elif data.shape[0] > target_channels:
                data = data[:target_channels]
            elif data.shape[0] == 1:
                data = np.tile(data, (target_channels, 1))
            else:
                raise ValueError(
                    f"{paths[i]}: cannot expand {data.shape[0]} "
                    f"channels to {target_channels} (only mono is "
                    "tiled up)")
        return data

    return loader
