"""Chunked streaming audio IO: ``StreamReader`` / ``StreamWriter``.

The port's copy of the JAX package's ``io/stream.py``: a native-format
subset of ``torchaudio.io.StreamReader``/``StreamWriter`` (which wrap
ffmpeg).  Sources/sinks are the two containers this package can code
natively (WAV via ``wavio.cpp``, FLAC via ``flacio.cpp`` /
``_flac.py``), which covers the released speech corpora
(LibriSpeech = FLAC, most others = WAV).

Semantics mirrored from torchaudio:

- chunks are float32 ``(frames, channels)`` (time-major, unlike the
  rest of this package's ``(channels, frames)`` decode API — this is
  torchaudio's StreamReader layout);
- the final chunk of a stream is SHORTER, never padded;
- ``stream()`` yields one tuple per round with one entry per
  configured output stream (``None`` once that stream is exhausted);
- ``seek`` positions by seconds.

Memory profile: WAV streams read the file incrementally — O(chunk)
resident regardless of file size.  FLAC holds the encoded file in
memory; decode is per-FLAC-frame streaming on the pure-Python path and
one-shot (then chunk-served) on the native path — the encoded buffer,
not the decoded waveform, is the FLAC floor because FLAC frames are
not independently indexable without a SEEKTABLE.

Chunks are NumPy arrays on the host, as the rest of :mod:`.io` returns;
``write_audio_chunk`` also takes tensors on any device.

Out of scope (loud errors): sample-rate
conversion inside the reader (compose :func:`ops.resample` after),
video/compressed codecs, network sources.
"""
from __future__ import annotations

import io as _io
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ._flac import (read_flac, _py_streaminfo, _py_flac_frames,
                    _encode_frame, _streaminfo_block, _host_float32,
                    _load as _flac_native)

__all__ = ["StreamReader", "StreamWriter", "SourceAudioStream"]


@dataclass
class SourceAudioStream:
    """Metadata of a source stream (torchaudio field names)."""
    media_type: str
    codec: str
    codec_long_name: str
    format: str
    bit_rate: int
    sample_rate: float
    num_channels: int
    bits_per_sample: int


# ------------------------------------------------------------------ #
# sources                                                            #
# ------------------------------------------------------------------ #

def _pcm_block_to_float(raw: bytes, info: dict) -> np.ndarray:
    """Interleaved PCM bytes → float32 ``(frames, channels)`` — the
    shared ``io._pcm_flat`` conversion table."""
    from . import _pcm_flat
    return _pcm_flat(raw, info["bits"], info["float"]) \
        .reshape(-1, info["channels"])


class _WavSource:
    """Incremental WAV reader: O(chunk) memory, frame-exact seek."""

    def __init__(self, src):
        if isinstance(src, (bytes, bytearray, memoryview)):
            self._f = _io.BytesIO(bytes(src))
            self._owns = True
        elif hasattr(src, "read"):
            self._f = src
            self._owns = False
        else:
            self._f = open(src, "rb")
            self._owns = True
        self.info = self._parse_header()
        self._frame = 0  # next frame to read

    def _parse_header(self) -> dict:
        """One source of truth for the RIFF walk: ``io._py_info`` on
        the header bytes (grown past 64 KiB only for exotic chunk
        layouts), with its ``_off`` rebased as this reader's data
        offset."""
        from . import _py_info
        f = self._f
        f.seek(0)
        head = f.read(65536)
        while True:
            try:
                info = dict(_py_info(head))
                break
            except ValueError as e:
                more = f.read(1 << 20) \
                    if "no data chunk" in str(e) else b""
                if not more:
                    raise
                head += more
        info["_data_off"] = info.pop("_off")
        return info

    @property
    def codec(self) -> str:
        bits = self.info["bits"]
        return "pcm_f32le" if self.info["float"] else f"pcm_s{bits}le"

    def read(self, n: int) -> Optional[np.ndarray]:
        info = self.info
        left = info["num_frames"] - self._frame
        if left <= 0:
            return None
        n = min(n, left)
        stride = info["channels"] * info["bits"] // 8
        self._f.seek(info["_data_off"] + self._frame * stride)
        raw = self._f.read(n * stride)
        n = len(raw) // stride  # tolerate truncated files
        if n == 0:
            return None
        self._frame += n
        return _pcm_block_to_float(raw[:n * stride], info)

    def seek_frame(self, frame: int) -> None:
        self._frame = min(max(0, frame), self.info["num_frames"])

    def close(self):
        if self._owns:
            self._f.close()


class _FlacSource:
    """FLAC reader: native one-shot decode when available, else the
    pure-Python per-frame generator (O(block) decoded memory)."""

    def __init__(self, src):
        if isinstance(src, (bytes, bytearray, memoryview)):
            self._buf = bytes(src)
        elif hasattr(src, "read"):
            self._buf = src.read()
        else:
            with open(src, "rb") as f:
                self._buf = f.read()
        si = _py_streaminfo(self._buf)
        si.pop("_off")
        self.info = si
        self._decoded: Optional[np.ndarray] = None  # (frames, ch)
        self._gen = None
        self._gen_frame = 0   # absolute frame index of the gen cursor
        self._pending: Optional[np.ndarray] = None
        self._frame = 0

    codec = "flac"

    def _native(self) -> Optional[np.ndarray]:
        if self._decoded is None and _flac_native():
            data, _ = read_flac(self._buf)   # (ch, frames)
            self._decoded = np.ascontiguousarray(data.T)
        return self._decoded

    def read(self, n: int) -> Optional[np.ndarray]:
        total = self.info["num_frames"]
        if self._frame >= total:
            return None
        n = min(n, total - self._frame)
        dec = self._native()
        if dec is not None:
            out = dec[self._frame:self._frame + n]
            self._frame += n
            return out
        # pure-Python streaming path
        if self._gen is None or self._gen_frame > self._frame:
            self._gen = _py_flac_frames(self._buf, _py_streaminfo(self._buf))
            self._gen_frame = 0
            self._pending = None
        parts: List[np.ndarray] = []
        need = self._frame + n   # absolute end frame of this read
        while self._gen_frame < need:
            if self._pending is not None:
                blk = self._pending
                self._pending = None
            else:
                try:
                    blk = next(self._gen).T    # (bs, ch)
                except StopIteration:
                    raise ValueError(
                        "truncated FLAC stream: STREAMINFO promises "
                        f"{total} frames but the byte stream ends at "
                        f"{self._gen_frame}") from None
            lo = self._gen_frame
            hi = lo + blk.shape[0]
            if hi <= self._frame:
                self._gen_frame = hi
                continue
            take = blk[max(0, self._frame + len_cat(parts) - lo):
                       min(blk.shape[0], need - lo)]
            parts.append(take)
            if hi > need:
                self._pending = blk
                # keep _gen_frame at the block start so the remainder
                # is re-sliced on the next read
                break
            self._gen_frame = hi
        out = np.concatenate(parts, axis=0) if parts else None
        if out is not None:
            self._frame += out.shape[0]
        return out

    def seek_frame(self, frame: int) -> None:
        self._frame = min(max(0, frame), self.info["num_frames"])

    def close(self):
        pass


def len_cat(parts: Sequence[np.ndarray]) -> int:
    return sum(p.shape[0] for p in parts)


# ------------------------------------------------------------------ #
# StreamReader                                                       #
# ------------------------------------------------------------------ #

class _OutStream:
    def __init__(self, frames_per_chunk: int, cursor: int = 0):
        self.fpc = frames_per_chunk
        self.cursor = cursor     # absolute next frame to emit
        self.done = False


class StreamReader:
    """Chunked decode of a WAV or FLAC source (path, ``bytes``, or
    binary file object).

    >>> r = StreamReader("clip.flac")
    >>> r.add_basic_audio_stream(frames_per_chunk=1600)
    >>> for (chunk,) in r.stream():   # float32 (<=1600, channels)
    ...     process(chunk)

    ``add_basic_audio_stream(sample_rate=)`` must match the source
    rate (in-reader resampling is ffmpeg's job in torchaudio; here
    compose :func:`torchaudio_contrib_tpu_torch.resample` downstream).
    """

    def __init__(self, src, format: Optional[str] = None,
                 buffer_size: int = 4096):
        kind = format or _sniff_kind(src)
        if kind == "wav":
            self._src = _WavSource(src)
        elif kind == "flac":
            self._src = _FlacSource(src)
        else:
            raise ValueError(
                f"unsupported container {kind!r}: only 'wav' and "
                "'flac' are decodable natively")
        self._streams: List[_OutStream] = []
        self._buf = np.empty((0, self._src.info["channels"]), np.float32)
        self._buf_start = 0      # absolute frame of _buf[0]
        self._block = max(int(buffer_size), 1)

    # -- source info --------------------------------------------------
    @property
    def num_src_streams(self) -> int:
        return 1

    @property
    def default_audio_stream(self) -> int:
        return 0

    def get_src_stream_info(self, i: int) -> SourceAudioStream:
        if i != 0:
            raise IndexError("single-stream container: index must be 0")
        info = self._src.info
        bps = info["bits"]
        return SourceAudioStream(
            media_type="audio", codec=self._src.codec,
            codec_long_name=self._src.codec, format="fltp",
            bit_rate=int(info["sample_rate"] * info["channels"] * bps),
            sample_rate=float(info["sample_rate"]),
            num_channels=info["channels"], bits_per_sample=bps)

    # -- output configuration -----------------------------------------
    def add_basic_audio_stream(self, frames_per_chunk: int,
                               stream_index: Optional[int] = None,
                               format: str = "fltp",
                               sample_rate: Optional[int] = None,
                               **_ignored) -> None:
        if stream_index not in (None, 0):
            raise IndexError("single-stream container: index must be 0")
        if format not in ("fltp", "flt"):
            raise NotImplementedError(
                f"format={format!r}: chunks are float32 (use 'fltp')")
        src_sr = self._src.info["sample_rate"]
        if sample_rate is not None and int(sample_rate) != int(src_sr):
            raise NotImplementedError(
                f"in-reader resampling ({src_sr} -> {sample_rate}) is "
                "not supported — compose ops.resample on the chunks")
        if frames_per_chunk <= 0:
            raise ValueError("frames_per_chunk must be positive")
        # a stream added after consumption/seek starts at the
        # reader's CURRENT position (the existing streams' minimum
        # cursor) — cursor 0 would index below the dropped buffer
        # head and silently slice wrong frames
        cursor = max(self._buf_start,
                     min((s.cursor for s in self._streams),
                         default=self._buf_start))
        self._streams.append(_OutStream(int(frames_per_chunk),
                                        cursor=cursor))

    @property
    def num_out_streams(self) -> int:
        return len(self._streams)

    def remove_stream(self, i: int) -> None:
        self._streams.pop(i)

    # -- position ------------------------------------------------------
    def seek(self, timestamp: float) -> None:
        """Position every output stream at ``timestamp`` seconds (the
        pure-Python FLAC path re-decodes from the stream head —
        documented O(t) cost; WAV and native-FLAC seeks are O(1))."""
        frame = int(round(timestamp * self._src.info["sample_rate"]))
        self._src.seek_frame(frame)
        self._buf = self._buf[:0]
        self._buf_start = frame
        for s in self._streams:
            s.cursor = frame
            s.done = False

    # -- streaming -----------------------------------------------------
    def _fill_to(self, end: int) -> None:
        """Extend the shared buffer to cover absolute frame ``end``
        (or EOF) and drop frames every stream has consumed."""
        min_cursor = min((s.cursor for s in self._streams),
                         default=self._buf_start)
        drop = min_cursor - self._buf_start
        if drop > 0:
            self._buf = self._buf[drop:]
            self._buf_start = min_cursor
        while self._buf_start + self._buf.shape[0] < end:
            blk = self._src.read(max(self._block,
                                     end - self._buf_start
                                     - self._buf.shape[0]))
            if blk is None:
                break
            self._buf = np.concatenate([self._buf, blk], axis=0) \
                if self._buf.size else blk

    def _pop(self, s: _OutStream) -> Optional[np.ndarray]:
        if s.done:
            return None
        self._fill_to(s.cursor + s.fpc)
        lo = s.cursor - self._buf_start
        hi = min(lo + s.fpc, self._buf.shape[0])
        if hi <= lo:
            s.done = True
            return None
        chunk = np.array(self._buf[lo:hi])
        s.cursor += chunk.shape[0]
        if chunk.shape[0] < s.fpc:
            s.done = True     # EOF: final (shorter) chunk
        return chunk

    def stream(self):
        """Iterator over tuples of chunks — one entry per configured
        output stream, ``None`` after that stream's final chunk."""
        if not self._streams:
            raise RuntimeError(
                "no output streams: call add_basic_audio_stream first")
        while True:
            chunks = tuple(self._pop(s) for s in self._streams)
            if all(c is None for c in chunks):
                return
            yield chunks

    def fill_buffer(self) -> int:
        """Decode ahead up to one chunk per stream; 0 = data buffered,
        1 = every stream at EOF (torchaudio's process-packet family
        collapsed to its buffer-level effect)."""
        end = max((s.cursor + s.fpc for s in self._streams
                   if not s.done), default=None)
        if end is None:
            return 1
        self._fill_to(end)
        return 0 if self._buf_start + self._buf.shape[0] > \
            min(s.cursor for s in self._streams if not s.done) else 1

    def pop_chunks(self) -> Tuple[Optional[np.ndarray], ...]:
        """One chunk (or ``None``) per output stream."""
        return tuple(self._pop(s) for s in self._streams)

    def close(self):
        self._src.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _sniff_kind(src) -> str:
    if isinstance(src, (bytes, bytearray, memoryview)):
        head = bytes(src[:4])
    elif hasattr(src, "read"):
        pos = src.tell()
        head = src.read(4)
        src.seek(pos)
    else:
        with open(src, "rb") as f:
            head = f.read(4)
    if head == b"fLaC":
        return "flac"
    if head == b"RIFF":
        return "wav"
    raise ValueError(
        f"unrecognized audio container (magic {head!r}): only WAV and "
        "FLAC are decodable natively")


# ------------------------------------------------------------------ #
# StreamWriter                                                       #
# ------------------------------------------------------------------ #

_WAV_FORMATS = {"pcm_s16le": 16, "pcm_s32le": 32, "pcm_f32le": 32}
_FLAC_FORMATS = {"pcm_s8": 8, "pcm_s16le": 16, "pcm_s24le": 24}


class StreamWriter:
    """Incremental WAV/FLAC encoder: feed float32 ``(frames,
    channels)`` chunks; container sizes (RIFF/data lengths, FLAC
    STREAMINFO blocksizes + total) are patched on :meth:`close`, so
    the destination must be a seekable path/file.

    >>> w = StreamWriter("out.flac")
    >>> w.add_audio_stream(16000, 1, encoder_format="pcm_s16le")
    >>> with w.open():
    ...     for chunk in chunks:
    ...         w.write_audio_chunk(0, chunk)
    """

    def __init__(self, dst, format: Optional[str] = None):
        if format is None:
            name = getattr(dst, "name", dst)
            format = "flac" if str(name).lower().endswith(".flac") \
                else "wav"
        if format not in ("wav", "flac"):
            raise ValueError(
                f"unsupported container {format!r}: only 'wav' and "
                "'flac' are encodable natively")
        self._dst = dst
        self._format = format
        self._cfg = None
        self._f = None
        self._frames = 0
        self._flac_buf: Optional[np.ndarray] = None  # (ch, pending)
        self._flac_no = 0

    def add_audio_stream(self, sample_rate: int, num_channels: int,
                         format: str = "flt",
                         encoder: Optional[str] = None,
                         encoder_format: Optional[str] = None,
                         block_size: int = 4096, **_ignored) -> None:
        if self._cfg is not None:
            raise RuntimeError("only one audio stream per container")
        if format not in ("flt", "fltp"):
            raise NotImplementedError(
                f"format={format!r}: feed float32 chunks ('flt')")
        table = _FLAC_FORMATS if self._format == "flac" else _WAV_FORMATS
        enc = encoder_format or ("pcm_s16le")
        if enc not in table:
            raise ValueError(
                f"encoder_format={enc!r} unsupported for "
                f"{self._format}: choose from {sorted(table)}")
        self._cfg = {"sr": int(sample_rate), "ch": int(num_channels),
                     "bits": table[enc], "float": enc == "pcm_f32le",
                     "block": int(block_size)}

    def open(self):
        if self._cfg is None:
            raise RuntimeError("call add_audio_stream before open()")
        if hasattr(self._dst, "write"):
            self._f = self._dst
        else:
            self._f = open(self._dst, "wb")
        if not self._f.seekable():
            raise ValueError(
                "StreamWriter needs a seekable destination (container "
                "sizes are patched on close)")
        cfg = self._cfg
        if self._format == "wav":
            tag = 3 if cfg["float"] else 1
            self._f.write(
                b"RIFF" + struct.pack("<I", 0) + b"WAVEfmt "
                + struct.pack("<IHHIIHH", 16, tag, cfg["ch"], cfg["sr"],
                              cfg["sr"] * cfg["ch"] * cfg["bits"] // 8,
                              cfg["ch"] * cfg["bits"] // 8, cfg["bits"])
                + b"data" + struct.pack("<I", 0))
        else:
            self._f.write(b"fLaC")
            self._f.write(_streaminfo_block(
                cfg["block"], cfg["block"], cfg["sr"], cfg["ch"],
                cfg["bits"], 0))
            self._flac_buf = np.empty((cfg["ch"], 0), np.int64)
        return self

    def __enter__(self):
        if self._f is None:
            self.open()
        return self

    def __exit__(self, *exc):
        self.close()

    def write_audio_chunk(self, i: int, chunk: np.ndarray) -> None:
        if i != 0:
            raise IndexError("single-stream container: index must be 0")
        if self._f is None:
            raise RuntimeError("call open() before writing")
        cfg = self._cfg
        chunk = _host_float32(chunk)
        if chunk.ndim == 1:
            chunk = chunk[:, None]
        if chunk.ndim != 2 or chunk.shape[1] != cfg["ch"]:
            raise ValueError(
                f"chunk must be (frames, {cfg['ch']}); got {chunk.shape}")
        if self._format == "wav":
            self._f.write(self._pcm_bytes(chunk))
        else:
            q = self._quantize(chunk.T, cfg["bits"])
            self._flac_buf = np.concatenate(
                [self._flac_buf, q], axis=1)
            self._drain_flac(final=False)
        self._frames += chunk.shape[0]

    @staticmethod
    def _quantize(x: np.ndarray, bits: int) -> np.ndarray:
        full = 1 << (bits - 1)
        return np.clip(np.rint(x.astype(np.float64) * full),
                       -full, full - 1).astype(np.int64)

    def _pcm_bytes(self, chunk: np.ndarray) -> bytes:
        cfg = self._cfg
        if cfg["float"]:
            return chunk.astype("<f4").tobytes()
        if cfg["bits"] == 16:
            return np.clip(np.rint(chunk * 32767.0), -32768, 32767) \
                .astype("<i2").tobytes()
        return np.clip(np.rint(chunk.astype(np.float64) * 2147483647.0),
                       -2147483648, 2147483647).astype("<i4").tobytes()

    def _drain_flac(self, final: bool) -> None:
        cfg = self._cfg
        bs = cfg["block"]
        ss_code = {8: 1, 16: 4, 24: 6}[cfg["bits"]]
        while self._flac_buf.shape[1] >= bs or (
                final and self._flac_buf.shape[1] > 0):
            blk = self._flac_buf[:, :bs]
            self._flac_buf = self._flac_buf[:, bs:]
            self._f.write(_encode_frame(
                blk, self._flac_no, cfg["bits"], ss_code, None, "auto"))
            self._flac_no += 1

    def close(self) -> None:
        if self._f is None:
            return
        cfg = self._cfg
        if self._format == "wav":
            payload = self._frames * cfg["ch"] * cfg["bits"] // 8
            self._f.seek(4)
            self._f.write(struct.pack("<I", 36 + payload))
            self._f.seek(40)
            self._f.write(struct.pack("<I", payload))
        else:
            self._drain_flac(final=True)
            # fixed-blocksize stream: STREAMINFO min == max == the
            # block size (the FLAC spec excludes the short final
            # block; min != max would mark the stream variable-size
            # and reinterpret the coded frame numbers) — matches
            # write_flac
            self._f.seek(4)
            self._f.write(_streaminfo_block(
                cfg["block"], cfg["block"], cfg["sr"], cfg["ch"],
                cfg["bits"], self._frames))
        self._f.flush()
        if not hasattr(self._dst, "write"):
            self._f.close()
        self._f = None
