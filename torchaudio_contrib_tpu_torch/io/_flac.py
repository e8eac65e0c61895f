"""FLAC codec: ctypes binding of the native decoder (``flacio.cpp``)
with a pure-Python fallback, plus a pure-Python encoder.

The port's copy of the JAX package's ``io/_flac.py`` (same streams, same
samples, same bytes); only the build differs: ``flacio.cpp`` is built by
:mod:`._native` into the build directory.  LibriSpeech and friends ship as
FLAC, so ``datasets.LIBRISPEECH`` needs an in-repo decoder.

Decoder subset (both paths, identical): 8/16/24-bit, every standard
subframe type (constant/verbatim/fixed 0-4/LPC 1-32), Rice/Rice2
partitions incl. raw escapes, wasted bits, all 4 channel assignments,
CRC-8/16 verified.  Unsupported streams raise ``ValueError`` with the
decoder's error code — never silent garbage.

The encoder is a genuine lossless FLAC encoder (fixed-predictor
search orders 0-2 + Rice coding; ``subframe=`` forces
constant/verbatim/fixed/LPC forms and ``stereo=`` the decorrelation
modes so tests can exercise every decoder path).
"""
from __future__ import annotations

import ctypes
import struct
import threading
from typing import Optional

import numpy as np
import torch

from ._native import load_library

__all__ = ["read_flac", "flac_info", "write_flac", "have_native_flac"]

_lib = None
_lock = threading.Lock()

_ERRORS = {
    -1: "not a FLAC stream (bad magic; Ogg FLAC unsupported)",
    -2: "bad/truncated metadata",
    -3: "unsupported bit depth (8/16/24 supported)",
    -4: "reserved/invalid frame field",
    -5: "CRC mismatch",
    -6: "bitstream overrun",
    -7: "malformed subframe",
    -8: "STREAMINFO has no total sample count",
    -9: "frame sample count exceeds STREAMINFO total",
}


def _host_float32(data) -> np.ndarray:
    """``data`` (a tensor on any device, or anything NumPy reads) as a
    float32 array on the host."""
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu()
    return np.asarray(data, np.float32)


def _err(rc: int) -> ValueError:
    return ValueError(
        f"FLAC decode failed: {_ERRORS.get(rc, 'unknown')} (code {rc})")


def _load():
    """The native decoder, built on first use; False when it cannot be
    built (the Python fallback then decodes)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = load_library("flacio.cpp")
            _lib = _declare(lib) if lib is not None else False
        return _lib


def _declare(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.flac_info.restype = ctypes.c_int
    lib.flac_info.argtypes = [u8p, ctypes.c_size_t,
                              ctypes.POINTER(ctypes.c_uint32),
                              ctypes.POINTER(ctypes.c_uint16),
                              ctypes.POINTER(ctypes.c_uint16),
                              ctypes.POINTER(ctypes.c_uint64)]
    lib.flac_decode.restype = ctypes.c_int
    lib.flac_decode.argtypes = [u8p, ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_float)]
    return lib


def have_native_flac() -> bool:
    return bool(_load())


def _as_bytes(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    with open(src, "rb") as f:
        return f.read()


def flac_info(src) -> dict:
    """STREAMINFO metadata without decoding samples."""
    buf = _as_bytes(src)
    lib = _load()
    if lib:
        arr = np.frombuffer(buf, np.uint8)
        sr = ctypes.c_uint32()
        ch = ctypes.c_uint16()
        bits = ctypes.c_uint16()
        nf = ctypes.c_uint64()
        rc = lib.flac_info(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(buf), ctypes.byref(sr), ctypes.byref(ch),
            ctypes.byref(bits), ctypes.byref(nf))
        if rc != 0:
            raise _err(rc)
        return {"sample_rate": sr.value, "channels": ch.value,
                "bits": bits.value, "num_frames": nf.value,
                "float": False}
    return _py_flac_info(buf)


def read_flac(src):
    """Decode to float32 ``(channels, frames)`` in [-1, 1) + sample
    rate (same contract as ``read_wav``)."""
    buf = _as_bytes(src)
    info = flac_info(buf)
    lib = _load()
    if lib:
        out = np.empty((info["channels"], info["num_frames"]),
                       np.float32)
        arr = np.frombuffer(buf, np.uint8)
        rc = lib.flac_decode(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(buf),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise _err(rc)
        return out, info["sample_rate"]
    return _py_flac_decode(buf, info), info["sample_rate"]


# ------------------------------------------------------------------ #
# CRCs (FLAC polynomials)                                            #
# ------------------------------------------------------------------ #

def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


def _crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 \
                else (c << 1) & 0xFFFF
    return c


# ------------------------------------------------------------------ #
# Python fallback decoder (mirrors flacio.cpp)                       #
# ------------------------------------------------------------------ #

class _BitReader:
    def __init__(self, buf: bytes, byte: int = 0):
        self.buf = buf
        self.byte = byte
        self.bit = 0

    def bits(self, k: int) -> int:
        v = 0
        while k > 0:
            if self.byte >= len(self.buf):
                raise _err(-6)
            take = min(8 - self.bit, k)
            chunk = (self.buf[self.byte] >> (8 - self.bit - take)) \
                & ((1 << take) - 1)
            v = (v << take) | chunk
            self.bit += take
            k -= take
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
        return v

    def sbits(self, k: int) -> int:
        v = self.bits(k)
        return v - (1 << k) if v & (1 << (k - 1)) else v

    def unary(self) -> int:
        q = 0
        while not self.bits(1):
            q += 1
            if q > 1 << 24:
                raise _err(-6)
        return q

    def align(self):
        if self.bit:
            self.bit = 0
            self.byte += 1


def _py_streaminfo(buf: bytes) -> dict:
    if buf[:4] != b"fLaC":
        raise _err(-1)
    off = 4
    si = None
    while True:
        if off + 4 > len(buf):
            raise _err(-2)
        hdr = buf[off]
        blen = int.from_bytes(buf[off + 1:off + 4], "big")
        body = off + 4
        if body + blen > len(buf):
            raise _err(-2)
        if hdr & 0x7F == 0:
            if blen < 34:
                raise _err(-2)
            br = _BitReader(buf, body)
            br.bits(16); br.bits(16); br.bits(24); br.bits(24)
            sr = br.bits(20)
            ch = br.bits(3) + 1
            bits = br.bits(5) + 1
            total = br.bits(36)
            si = {"sample_rate": sr, "channels": ch, "bits": bits,
                  "num_frames": total, "float": False}
        off = body + blen
        if hdr & 0x80:
            break
    if si is None:
        raise _err(-2)
    if si["bits"] not in (8, 16, 24):
        raise _err(-3)
    if si["num_frames"] == 0:
        raise _err(-8)
    si["_off"] = off
    return si


def _py_flac_info(buf: bytes) -> dict:
    si = _py_streaminfo(buf)
    si.pop("_off")
    return si


def _py_residual(br, bs, pred, x):
    method = br.bits(2)
    if method > 1:
        raise _err(-4)
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    porder = br.bits(4)
    nparts = 1 << porder
    if bs % nparts:
        raise _err(-7)
    idx = pred
    for part in range(nparts):
        count = (bs >> porder) - (pred if part == 0 else 0)
        if count < 0:
            raise _err(-7)
        param = br.bits(pbits)
        if param == escape:
            raw = br.bits(5)
            for _ in range(count):
                x[idx] = br.sbits(raw) if raw else 0
                idx += 1
        else:
            for _ in range(count):
                q = br.unary()
                r = br.bits(param) if param else 0
                v = (q << param) | r
                x[idx] = (v >> 1) ^ -(v & 1)
                idx += 1


def _py_subframe(br, bs, bps):
    if br.bits(1):
        raise _err(-4)
    typ = br.bits(6)
    wasted = 0
    if br.bits(1):
        wasted = br.unary() + 1
    bps -= wasted
    if bps <= 0:
        raise _err(-7)
    x = [0] * bs
    if typ == 0:
        x = [br.sbits(bps)] * bs
    elif typ == 1:
        x = [br.sbits(bps) for _ in range(bs)]
    elif 8 <= typ <= 12:
        order = typ - 8
        if order > bs:
            raise _err(-7)
        for i in range(order):
            x[i] = br.sbits(bps)
        _py_residual(br, bs, order, x)
        for i in range(order, bs):
            if order == 1:
                x[i] += x[i - 1]
            elif order == 2:
                x[i] += 2 * x[i - 1] - x[i - 2]
            elif order == 3:
                x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3]
            elif order == 4:
                x[i] += (4 * x[i - 1] - 6 * x[i - 2]
                         + 4 * x[i - 3] - x[i - 4])
    elif typ >= 32:
        order = (typ & 31) + 1
        if order > bs:
            raise _err(-7)
        for i in range(order):
            x[i] = br.sbits(bps)
        prec = br.bits(4)
        if prec == 15:
            raise _err(-4)
        shift = br.sbits(5)
        if shift < 0:
            raise _err(-4)
        coef = [br.sbits(prec + 1) for _ in range(order)]
        _py_residual(br, bs, order, x)
        for i in range(order, bs):
            acc = sum(c * x[i - 1 - j] for j, c in enumerate(coef))
            x[i] += acc >> shift
    else:
        raise _err(-4)
    if wasted:
        x = [v << wasted for v in x]
    return x


def _py_flac_frames(buf: bytes, si: dict):
    """Generator over decoded FLAC frames → float32 ``(ch, bs)``
    arrays in stream order (the streaming counterpart of
    ``_py_flac_decode``; O(block) memory)."""
    ch, total, bits = si["channels"], si["num_frames"], si["bits"]
    scale = 1.0 / (1 << (bits - 1))
    br = _BitReader(buf, si["_off"])
    done = 0
    while done < total:
        start = br.byte
        if br.bit:
            raise _err(-4)
        if start + 2 > len(buf) or buf[start] != 0xFF \
                or (buf[start + 1] & 0xFC) != 0xF8:
            raise _err(-4)
        br.bits(16)
        bs_code = br.bits(4)
        sr_code = br.bits(4)
        ch_asgn = br.bits(4)
        ss_code = br.bits(3)
        if br.bits(1):
            raise _err(-4)
        lead = br.bits(8)
        if lead >= 0x80:
            extra = 0
            m = 0x40
            while lead & m:
                extra += 1
                m >>= 1
            if not 1 <= extra <= 6:
                raise _err(-4)
            for _ in range(extra):
                if br.bits(8) & 0xC0 != 0x80:
                    raise _err(-4)
        if bs_code == 0:
            raise _err(-4)
        elif bs_code == 1:
            bs = 192
        elif bs_code <= 5:
            bs = 576 << (bs_code - 2)
        elif bs_code == 6:
            bs = br.bits(8) + 1
        elif bs_code == 7:
            bs = br.bits(16) + 1
        else:
            bs = 256 << (bs_code - 8)
        if sr_code == 12:
            br.bits(8)
        elif sr_code in (13, 14):
            br.bits(16)
        elif sr_code == 15:
            raise _err(-4)
        hcrc = br.bits(8)
        if _crc8(buf[start:br.byte - 1]) != hcrc:
            raise _err(-5)
        nch = ch_asgn + 1 if ch_asgn < 8 else 2
        if ch_asgn > 10 or nch != ch:
            raise _err(-4)
        bps = {0: bits, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24,
               7: 32}.get(ss_code)
        if bps is None or bps != bits:
            raise _err(-4)
        if done + bs > total:
            raise _err(-9)
        chans = []
        for c in range(ch):
            sub_bps = bps + (1 if (ch_asgn == 8 and c == 1)
                             or (ch_asgn == 9 and c == 0)
                             or (ch_asgn == 10 and c == 1) else 0)
            chans.append(_py_subframe(br, bs, sub_bps))
        br.align()
        fcrc = br.bits(16)
        if _crc16(buf[start:br.byte - 2]) != fcrc:
            raise _err(-5)
        if ch_asgn == 8:
            chans[1] = [l - s for l, s in zip(chans[0], chans[1])]
        elif ch_asgn == 9:
            chans[0] = [r + s for s, r in zip(chans[0], chans[1])]
        elif ch_asgn == 10:
            mid0, side = chans
            left, right = [], []
            for m, s in zip(mid0, side):
                mm = (m << 1) | (s & 1)
                left.append((mm + s) >> 1)
                right.append((mm - s) >> 1)
            chans = [left, right]
        frame = np.empty((ch, bs), np.float32)
        for c in range(ch):
            frame[c] = np.asarray(chans[c], np.float64) * scale
        yield frame
        done += bs


def _py_flac_decode(buf: bytes, info: Optional[dict] = None):
    si = _py_streaminfo(buf)
    out = np.empty((si["channels"], si["num_frames"]), np.float32)
    done = 0
    for frame in _py_flac_frames(buf, si):
        out[:, done:done + frame.shape[1]] = frame
        done += frame.shape[1]
    return out


# ------------------------------------------------------------------ #
# Python encoder                                                     #
# ------------------------------------------------------------------ #

class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nb = 0

    def bits(self, v: int, k: int):
        v &= (1 << k) - 1
        self.acc = (self.acc << k) | v
        self.nb += k
        while self.nb >= 8:
            self.nb -= 8
            self.out.append((self.acc >> self.nb) & 0xFF)
        self.acc &= (1 << self.nb) - 1

    def unary(self, q: int):
        while q >= 32:
            self.bits(0, 32)
            q -= 32
        self.bits(1, q + 1)

    def align(self):
        if self.nb:
            self.bits(0, 8 - self.nb)

    def bytes(self) -> bytes:
        assert self.nb == 0
        return bytes(self.out)


def _rice_param(res) -> int:
    mean = float(np.mean(np.abs(np.asarray(res, np.float64)))) + 1e-9
    k = max(0, int(np.ceil(np.log2(mean + 1.0))))
    return min(k, 14)


def _write_residual(bw, res):
    param = _rice_param(res)
    bw.bits(0, 2)          # Rice, 4-bit params
    bw.bits(0, 4)          # partition order 0
    bw.bits(param, 4)
    for r in res:
        v = (int(r) << 1) if r >= 0 else ((-int(r)) << 1) - 1
        bw.unary(v >> param)
        if param:
            bw.bits(v & ((1 << param) - 1), param)


def _fixed_residual(x, order):
    a = np.asarray(x, np.int64)
    for _ in range(order):
        a = np.diff(a)
    return a


def _write_subframe(bw, x, bps, mode):
    x = [int(v) for v in x]
    if mode == "auto":
        if all(v == x[0] for v in x):
            mode = "constant"
        else:
            mode = "fixed"
    if mode == "constant":
        if any(v != x[0] for v in x):
            raise ValueError("constant subframe needs constant data")
        bw.bits(0, 1); bw.bits(0, 6); bw.bits(0, 1)
        bw.bits(x[0], bps)
        return
    if mode == "verbatim":
        bw.bits(0, 1); bw.bits(1, 6); bw.bits(0, 1)
        for v in x:
            bw.bits(v, bps)
        return
    if mode == "fixed":
        best, best_cost = 0, None
        for order in range(min(3, len(x)) + 1):
            if order > len(x):
                break
            cost = float(np.abs(_fixed_residual(x, order)).sum())
            if best_cost is None or cost < best_cost:
                best, best_cost = order, cost
        order = best
        bw.bits(0, 1); bw.bits(8 + order, 6); bw.bits(0, 1)
        for v in x[:order]:
            bw.bits(v, bps)
        _write_residual(bw, _fixed_residual(x, order))
        return
    if mode == "lpc":
        # order-2 LPC with coefficients (2, -1), shift 0 — numerically
        # identical to fixed order 2; exists to exercise the LPC
        # decode path with a guaranteed-lossless stream
        order, precision, shift = 2, 5, 0
        if len(x) < order:
            raise ValueError("lpc test mode needs >= 2 samples")
        bw.bits(0, 1); bw.bits(32 + order - 1, 6); bw.bits(0, 1)
        for v in x[:order]:
            bw.bits(v, bps)
        bw.bits(precision - 1, 4)
        bw.bits(shift, 5)
        bw.bits(2, precision)
        bw.bits(-1, precision)
        _write_residual(bw, _fixed_residual(x, 2))
        return
    raise ValueError(f"unknown subframe mode {mode!r}")


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    for extra in range(1, 7):
        if n < (1 << (6 - extra + 6 * extra)):
            lead = (0xFF << (7 - extra)) & 0xFF
            lead |= n >> (6 * extra)
            cont = [0x80 | ((n >> (6 * i)) & 0x3F)
                    for i in reversed(range(extra))]
            return bytes([lead] + cont)
    raise ValueError("frame number too large")


def _encode_frame(blk: np.ndarray, frame_no: int, bits: int,
                  ss_code: int, asgn: Optional[int],
                  subframe: str) -> bytes:
    """Encode one FLAC frame from quantized ``(ch, bs)`` int64."""
    ch, bs = blk.shape
    hw = _BitWriter()
    hw.bits(0b11111111111110, 14)
    hw.bits(0, 1)          # reserved
    hw.bits(0, 1)          # fixed blocking strategy
    hw.bits(7, 4)          # blocksize: 16-bit value follows
    hw.bits(0, 4)          # sample rate: from STREAMINFO
    hw.bits(asgn if asgn is not None else ch - 1, 4)
    hw.bits(ss_code, 3)
    hw.bits(0, 1)
    hw.align()
    header = hw.bytes() + _utf8_number(frame_no) \
        + struct.pack(">H", bs - 1)
    header += bytes([_crc8(header)])

    bw = _BitWriter()
    if asgn is None:
        subs = [(blk[c], bits) for c in range(ch)]
    else:
        left, right = blk[0], blk[1]
        side = left - right
        if asgn == 8:
            subs = [(left, bits), (side, bits + 1)]
        elif asgn == 9:
            subs = [(side, bits + 1), (right, bits)]
        else:
            mid = (left + right) >> 1
            subs = [(mid, bits), (side, bits + 1)]
    for xdata, sub_bps in subs:
        _write_subframe(bw, xdata, sub_bps, subframe)
    bw.align()
    frame = header + bw.bytes()
    return frame + struct.pack(">H", _crc16(frame))


def _streaminfo_block(min_bs: int, max_bs: int, sample_rate: int,
                      ch: int, bits: int, nf: int) -> bytes:
    """The complete STREAMINFO metadata block (header + 34-byte body
    + 16 zero MD5 bytes), marked last-metadata-block."""
    si = _BitWriter()
    si.bits(min_bs, 16)
    si.bits(max_bs, 16)
    si.bits(0, 24); si.bits(0, 24)
    si.bits(sample_rate, 20)
    si.bits(ch - 1, 3)
    si.bits(bits - 1, 5)
    si.bits(nf, 36)
    body = si.bytes() + b"\x00" * 16          # md5 unset (all zero)
    return bytes([0x80]) + len(body).to_bytes(3, "big") + body


def write_flac(path, data: np.ndarray, sample_rate: int,
               bits: int = 16, block_size: int = 4096,
               subframe: str = "auto", stereo: str = "independent"
               ) -> None:
    """Encode float32 ``(channels, frames)`` (or ``(frames,)``) to a
    lossless FLAC file.

    ``subframe``: ``auto`` (constant/fixed search), ``verbatim``,
    ``fixed``, ``lpc`` (order-2 test form).  ``stereo`` (2-channel
    only): ``independent`` / ``left_side`` / ``right_side`` /
    ``mid_side``.
    """
    data = _host_float32(data)
    if data.ndim == 1:
        data = data[None]
    if data.ndim != 2:
        raise ValueError("data must be (channels, frames)")
    if bits not in (8, 16, 24):
        raise ValueError("bits must be 8, 16, or 24")
    ch, nf = data.shape
    if stereo != "independent" and ch != 2:
        raise ValueError("stereo modes need exactly 2 channels")
    if not 16 <= block_size <= 65535:
        raise ValueError("block_size must be in [16, 65535]")
    full = 1 << (bits - 1)
    q = np.clip(np.rint(data.astype(np.float64) * full),
                -full, full - 1).astype(np.int64)

    out = bytearray(b"fLaC")
    out += _streaminfo_block(min(block_size, nf) if nf else block_size,
                             block_size, sample_rate, ch, bits, nf)

    ss_code = {8: 1, 16: 4, 24: 6}[bits]
    asgn = {"independent": None, "left_side": 8, "right_side": 9,
            "mid_side": 10}[stereo]
    for frame_no, lo in enumerate(range(0, nf, block_size)):
        out += _encode_frame(q[:, lo:lo + block_size], frame_no,
                             bits, ss_code, asgn, subframe)

    with open(path, "wb") as f:
        f.write(bytes(out))
