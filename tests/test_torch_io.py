"""Parity of the port's ``io`` (native WAV and FLAC codecs, their Python
fallbacks, ``StreamReader``/``StreamWriter``, ``AudioEffector``) and the
root's ``load``/``save``/``info`` with the JAX package, on the CPU.

The same seeded numpy data goes through both packages.  Reads are held
bitwise (a codec is exact); files written by either package are
byte-equal and each package reads the other's.  Both packages' native
libraries are loaded in this process (the port's from its build
directory, the JAX package's from its own directory), each with ctypes'
local symbol scope.
"""
import dataclasses
import struct
import threading

import numpy as np
import pytest
import torch

from torchaudio_contrib_tpu import io as jio
from torchaudio_contrib_tpu.io import _flac as jflac
from torchaudio_contrib_tpu.io import stream as jstream
import torchaudio_contrib_tpu as jtac
import torchaudio_contrib_tpu_torch as ttac
from torchaudio_contrib_tpu_torch import io as tio
from torchaudio_contrib_tpu_torch.io import _flac as tflac
from torchaudio_contrib_tpu_torch.io import _native
from torchaudio_contrib_tpu_torch.io import stream as tstream
from torchaudio_contrib_tpu_torch.ops import _cuda

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)


def _clip(rng, ch, n, peak=0.9):
    return rng.uniform(-peak, peak, (ch, n)).astype(np.float32)


def _quantized(rng, ch, n, bits):
    """Samples on the ``bits`` grid, so that a lossless codec returns
    them exactly."""
    full = 1 << (bits - 1)
    q = rng.integers(-full, full, (ch, n))
    return (q / full).astype(np.float32)


def _wav24(x):
    """A hand-built 24-bit PCM WAV of ``x (ch, n)``."""
    v = np.clip(np.rint(x.T * 8388607), -8388608, 8388607).astype(np.int32)
    raw = b"".join(int(s & 0xFFFFFF).to_bytes(3, "little")
                   for s in v.reshape(-1))
    ch = x.shape[0]
    return (b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, ch, 16000, 16000 * 3 * ch,
                          3 * ch, 24)
            + b"data" + struct.pack("<I", len(raw)) + raw)


def _no_native(monkeypatch):
    monkeypatch.setattr(tio, "_lib", False)
    monkeypatch.setattr(tflac, "_lib", False)


def test_native_codecs_build_into_the_build_directory():
    assert tio.have_native() and tio.have_native_flac()
    for source in ("wavio.cpp", "flacio.cpp"):
        so = _native.library_path(source)
        assert so.parent == _cuda.build_dir() and so.exists()
    # never the JAX package's library, which sits in its package directory
    assert tio._load()._name == str(_native.library_path("wavio.cpp"))
    assert tflac._load()._name == str(_native.library_path("flacio.cpp"))
    assert tio._load()._name != jio._load()._name


def test_concurrent_builds_share_one_library(tmp_path, monkeypatch):
    """Eight threads build into an empty build directory at once: each
    loads a complete library and no temporary file is left."""
    monkeypatch.setenv(_cuda.BUILD_DIR_ENV, str(tmp_path))
    libs, errors = [], []

    def build():
        try:
            libs.append(_native.load_library("wavio.cpp"))
        except Exception as e:     # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(libs) == 8 and all(lib is not None for lib in libs)
    assert [p.name for p in tmp_path.iterdir()] \
        == [_native.library_path("wavio.cpp").name]


@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("bits", [16, 32])
def test_wav_write_bytes_and_reads_equal_the_jax_package(tmp_path, rng, ch,
                                                         bits):
    x = _clip(rng, ch, 4801)
    pj, pt = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    jio.write_wav(pj, x, 16000, bits=bits)
    tio.write_wav(pt, torch.from_numpy(x), 16000, bits=bits)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    got, sr = tio.read_wav(pj)
    want, jsr = jio.read_wav(pt)
    assert sr == jsr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert tio.wav_info(pt) == jio.wav_info(pt)


@pytest.mark.parametrize("fmt", ["pcm24", "pcm_s32le", "float_ext"])
def test_wav_formats_decode_like_the_jax_package(tmp_path, rng, fmt,
                                                 monkeypatch):
    x = _clip(rng, 2, 1001)
    if fmt == "pcm24":
        buf = _wav24(x)
    elif fmt == "pcm_s32le":
        p = str(tmp_path / "s32.wav")
        w = tstream.StreamWriter(p)
        w.add_audio_stream(16000, 2, encoder_format="pcm_s32le")
        with w.open():
            w.write_audio_chunk(0, torch.from_numpy(x.T.copy()))
        buf = open(p, "rb").read()
    else:   # WAVE_FORMAT_EXTENSIBLE around an IEEE float payload
        payload = x.T.astype("<f4").tobytes()
        fmt_body = struct.pack("<HHIIHH", 0xFFFE, 2, 16000, 16000 * 8, 8,
                               32) + struct.pack("<HHIH", 22, 32, 3, 3) \
            + b"\x00" * 14
        buf = (b"RIFF" + struct.pack("<I", 20 + len(fmt_body)
                                     + len(payload)) + b"WAVE"
               + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
               + b"data" + struct.pack("<I", len(payload)) + payload)
    want, _ = jio.read_wav(buf)
    got, _ = tio.read_wav(buf)
    np.testing.assert_array_equal(got, want)
    _no_native(monkeypatch)
    np.testing.assert_array_equal(tio.read_wav(buf)[0], want)
    assert {k: v for k, v in tio.wav_info(buf).items() if k != "_off"} \
        == jio.wav_info(buf)


def test_wav_python_fallback_writes_the_jax_fallbacks_bytes(tmp_path, rng,
                                                            monkeypatch):
    x = _clip(rng, 2, 700)
    for bits in (16, 32):
        pj, pt = str(tmp_path / f"j{bits}.wav"), str(tmp_path / f"t{bits}.wav")
        jio._py_encode(pj, x, 8000, bits)
        _no_native(monkeypatch)
        tio.write_wav(pt, x, 8000, bits=bits)
        monkeypatch.undo()
        assert open(pj, "rb").read() == open(pt, "rb").read()


@pytest.mark.parametrize("ch,bits,stereo,subframe", [
    (1, 8, "independent", "auto"),
    (1, 16, "independent", "verbatim"),
    (1, 24, "independent", "lpc"),
    (2, 16, "independent", "fixed"),
    (2, 16, "left_side", "auto"),
    (2, 16, "right_side", "auto"),
    (2, 24, "mid_side", "auto"),
    (2, 8, "mid_side", "lpc"),
])
def test_flac_bytes_and_decoders_equal_the_jax_package(tmp_path, rng, ch,
                                                       bits, stereo,
                                                       subframe,
                                                       monkeypatch):
    x = _quantized(rng, ch, 2500, bits)
    x[:, 600:900] = x[:, 600:601]       # a constant run
    pj, pt = str(tmp_path / "j.flac"), str(tmp_path / "t.flac")
    kw = dict(bits=bits, block_size=1024, stereo=stereo, subframe=subframe)
    jflac.write_flac(pj, x, 16000, **kw)
    tflac.write_flac(pt, torch.from_numpy(x), 16000, **kw)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    want, _ = jflac.read_flac(pj)
    got, sr = tflac.read_flac(pj)
    assert sr == 16000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)          # lossless
    assert tflac.flac_info(pt) == jflac.flac_info(pt)
    _no_native(monkeypatch)
    assert not tio.have_native_flac()
    np.testing.assert_array_equal(tflac.read_flac(pt)[0], want)


def test_flac_errors_are_the_jax_packages(tmp_path, rng):
    x = _quantized(rng, 1, 3000, 16)
    p = str(tmp_path / "c.flac")
    tflac.write_flac(p, x, 8000)
    buf = bytearray(open(p, "rb").read())
    buf[-40] ^= 0x5A                                # corrupt a frame
    for read in (tflac.read_flac, jflac.read_flac):
        with pytest.raises(ValueError, match="CRC mismatch|malformed|overrun"):
            read(bytes(buf))
    for bad in (dict(bits=12), dict(stereo="mid_side"),
                dict(block_size=8)):
        with pytest.raises(ValueError):
            tflac.write_flac(str(tmp_path / "e.flac"), x, 8000, **bad)
    with pytest.raises(ValueError, match="unrecognized audio container"):
        tio.read_audio(b"OggS" + bytes(40))


def test_dispatch_and_cross_reads(tmp_path, rng):
    x = _quantized(rng, 2, 1800, 16)
    for ext in (".wav", ".flac"):
        pj, pt = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
        jio.write_audio(pj, x, 22050)
        tio.write_audio(pt, x, 22050)
        assert open(pj, "rb").read() == open(pt, "rb").read()
        np.testing.assert_array_equal(tio.read_audio(pj)[0],
                                      jio.read_audio(pt)[0])
        assert tio.audio_info(pt) == jio.audio_info(pj)


def test_make_wav_loader_matches_the_jax_package(tmp_path, rng):
    paths = []
    for i, ch in enumerate((1, 2, 3)):
        p = str(tmp_path / f"c{i}.wav")
        jio.write_wav(p, _clip(rng, ch, 400 + i), 16000)
        paths.append(p)
    for target in (None, 1, 2):
        tl, jl = tio.make_wav_loader(paths, target), \
            jio.make_wav_loader(paths, target)
        for i in range(3):
            if target == 2 and i == 2:
                got = tl(i)
                assert got.shape[0] == 2
            np.testing.assert_array_equal(tl(i), jl(i))
    with pytest.raises(ValueError, match="cannot expand"):
        tio.make_wav_loader(paths, 4)(1)


def _chunks(reader):
    return [c for (c,) in reader.stream()]


@pytest.mark.parametrize("ext", [".wav", ".flac"])
def test_stream_reader_chunks_and_seek(tmp_path, rng, ext, monkeypatch):
    x = _quantized(rng, 2, 5003, 16)
    p = str(tmp_path / f"s{ext}")
    tio.write_audio(p, x, 8000)
    for native in (True, False):
        if not native:
            _no_native(monkeypatch)
        r, j = tstream.StreamReader(p), jstream.StreamReader(p)
        for rd in (r, j):
            rd.add_basic_audio_stream(frames_per_chunk=700)
            rd.add_basic_audio_stream(frames_per_chunk=1024)
        got, want = list(r.stream()), list(j.stream())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
        first = [c[0] for c in got if c[0] is not None]
        assert [c.shape[0] for c in first] == [700] * 7 + [103]
        np.testing.assert_array_equal(np.concatenate(first).T,
                                      tio.read_audio(p)[0])
        r.seek(0.3)
        j.seek(0.3)
        np.testing.assert_array_equal(r.pop_chunks()[0],
                                      j.pop_chunks()[0])
        assert dataclasses.asdict(r.get_src_stream_info(0)) \
            == dataclasses.asdict(j.get_src_stream_info(0))
        r.close()
        j.close()


@pytest.mark.parametrize("ext,enc", [(".wav", "pcm_s16le"),
                                     (".wav", "pcm_f32le"),
                                     (".flac", "pcm_s24le")])
def test_stream_writer_bytes_equal_the_jax_package(tmp_path, rng, ext, enc):
    x = _clip(rng, 2, 3001, 0.8)
    outs = []
    for name, mod, wrap in (("t", tstream, torch.from_numpy),
                            ("j", jstream, np.asarray)):
        p = str(tmp_path / f"{name}{ext}")
        w = mod.StreamWriter(p)
        w.add_audio_stream(16000, 2, encoder_format=enc, block_size=512)
        with w.open():
            for lo in range(0, 3001, 777):
                w.write_audio_chunk(0, wrap(x[:, lo:lo + 777].T.copy()))
        outs.append(open(p, "rb").read())
    assert outs[0] == outs[1]


def test_audio_effector_matches_the_jax_package(rng):
    x = _clip(rng, 2, 1600, 0.5).T.copy()           # (time, channel)
    for effect, fmt, enc in (("gain -3, reverse", None, None),
                             (None, "wav", "PCM_U"),
                             ("vol 0.5, trim 0.01 0.05", "wav", "ULAW")):
        t = ttac.io.AudioEffector(effect=effect, format=fmt, encoder=enc)
        j = jio.AudioEffector(effect=effect, format=fmt, encoder=enc)
        got = t.apply(torch.from_numpy(x), 16000)
        want = np.asarray(j.apply(x, 16000))
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        chunks = list(t.stream(x, 16000, 300))
        assert all(c.shape == (300, 2) for c in chunks)
        np.testing.assert_array_equal(
            torch.cat(chunks)[:got.shape[0]].numpy(), got.numpy())
    with pytest.raises(ValueError, match="unknown effect"):
        ttac.io.AudioEffector(effect="chorus 0.5")
    with pytest.raises(ValueError, match="format='wav' only"):
        ttac.io.AudioEffector(format="mp3")


def test_load_save_info_match_the_jax_package(tmp_path, rng):
    x = _quantized(rng, 2, 2222, 24)
    for ext, bits in ((".flac", 24), (".wav", 32), (".wav", 16)):
        pj, pt = str(tmp_path / f"j{bits}{ext}"), str(tmp_path / f"t{bits}{ext}")
        jtac.save(pj, x.T, 16000, channels_first=False, bits_per_sample=bits)
        ttac.save(pt, torch.from_numpy(x.T.copy()), 16000,
                  channels_first=False, bits_per_sample=bits)
        assert open(pj, "rb").read() == open(pt, "rb").read()
        got, sr = ttac.load(pt, device="cpu")
        want, jsr = jtac.load(pj)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert sr == jsr == 16000
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got_t, _ = ttac.load(pt, channels_first=False, device="cpu")
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want).T)
        assert ttac.info(pt) == jtac.info(pj)
