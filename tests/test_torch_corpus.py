"""The port's corpus path (``parallel/corpus.py``) vs the JAX package, on
the CPU.

The same numpy clips go through ``torchaudio_contrib_tpu.parallel`` and
``torchaudio_contrib_tpu_torch.parallel`` (``device="cpu"``): streaming and
chunked STFTs against the one-shot transform, and whole
``CorpusPreprocessor`` runs (retry, skip-and-log, loader threads, prefetch,
sink, last-batch padding, the three wire formats, ``use_fused``) against
the JAX runs' statistics and sink rows.  Toy sizes (fft 256, 32 mels, 12
files of 4096 samples, batch 8: the JAX side shards over its 8 CPU
devices).  Tolerances: 1e-5 of peak for linear outputs and 1e-4 dB for log
outputs (float32 chains on both sides; the lossy wires quantise on the
host with the same NumPy code, so they are held to the same bars).
"""
import functools
import logging

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from torchaudio_contrib_tpu import ops as jops
from torchaudio_contrib_tpu import parallel as jpar
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch import parallel as tpar
from torchaudio_contrib_tpu_torch.ops import fused as tfused

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

DB_ATOL = 1e-4          # log-mel outputs, dB
LIN_PARITY = 1e-5       # linear outputs, of peak
SR, CLIP, N_FILES, BATCH = 8000, 4096, 12, 8
MEL = dict(fft_length=256, hop_length=64, num_mels=32, sample_rate=SR,
           frames_per_chunk=8)
BAD, FLAKY = 7, 3       # always fails; fails once, then loads


def _clips():
    rng = np.random.default_rng(0)
    # a spread of levels, one short clip (zero-padded), one stereo clip
    # (the first channel is kept)
    clips = [(rng.standard_normal((1, CLIP)) * (0.1 + i)).astype(np.float32)
             for i in range(N_FILES)]
    clips[4] = clips[4][:, :3000]
    clips[9] = np.concatenate([clips[9], -clips[9]], axis=0)
    return clips


CLIPS = _clips()


def _loader():
    failed = set()

    def load(i):
        if i == BAD:
            raise IOError("synthetic decode failure")
        if i == FLAKY and i not in failed:
            failed.add(i)
            raise IOError("transient failure")
        return CLIPS[i]

    return load


def _run(par, workers=0, **kw):
    """One run over all files: ``(stats, {idx: row})``."""
    rows = {}
    extra = {} if par is jpar else {"device": "cpu"}
    pre = par.CorpusPreprocessor(
        _loader(), clip_samples=CLIP, batch_size=BATCH, retries=1,
        num_workers=workers,
        sink=lambda i, m: rows.__setitem__(i, np.array(m)),
        **extra, **{**MEL, **kw})
    return pre.run(range(N_FILES)), rows


@functools.lru_cache(maxsize=None)
def _jax_run(**kw):
    return _run(jpar, **kw)


def _same_rows(got, want, linear=False):
    assert sorted(got) == sorted(want)
    for i in want:
        assert got[i].shape == want[i].shape, i
        if linear:
            err = np.max(np.abs(got[i] - want[i])) / np.max(np.abs(want[i]))
            assert err <= LIN_PARITY, (i, err)
        else:
            np.testing.assert_allclose(got[i], want[i], atol=DB_ATOL,
                                       rtol=0, err_msg=str(i))


# ---- streaming and chunked transforms -------------------------------------

def test_streaming_stft_matches_oneshot(rng):
    fft, hop, k = 256, 64, 8
    stream = tpar.StreamingSTFT(fft, hop)
    x = rng.standard_normal((2, stream.carry_len + hop * k * 5)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    want = tops.stft(xt, fft, hop, center=False)
    state = stream.init_state((2,))
    assert state.shape == (2, stream.carry_len) and not state.any()
    state = xt[..., :stream.carry_len]
    specs, pos = [], stream.carry_len
    while pos + hop * k <= x.shape[-1]:
        state, s = stream.process(state, xt[..., pos:pos + hop * k])
        specs.append(s)
        pos += hop * k
    got = torch.cat(specs, dim=-1)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= LIN_PARITY * want.abs().max()
    jwant = np.asarray(jops.stft(jnp.asarray(x), fft, hop, center=False))
    assert np.max(np.abs(got.numpy() - jwant)) <= (
        LIN_PARITY * np.max(np.abs(jwant)))


def test_streaming_chunk_validation():
    stream = tpar.StreamingSTFT(256, 64)
    with pytest.raises(ValueError, match="multiple of hop_length"):
        stream.process(stream.init_state(), torch.zeros(100))
    with pytest.raises(ValueError, match="hop_length <= fft_length"):
        tpar.StreamingSTFT(256, 512)
    with pytest.raises(ValueError, match="shorter than one chunk"):
        tpar.chunked_melspectrogram(torch.zeros(1, 500), 256, 64, 32, SR,
                                    frames_per_chunk=8)


@pytest.mark.parametrize("to_db", [True, False])
def test_chunked_matches_oneshot_and_jax(rng, to_db):
    """Chunks with a carry give the one-shot frames (the ragged tail chunk
    dropped, as the JAX scan drops it), and the same values as the JAX
    package's scan."""
    fft, hop, mels, fpc = 256, 64, 32, 8
    x = rng.standard_normal((2, 1, 5000)).astype(np.float32)
    xt = torch.from_numpy(x)
    got = tpar.chunked_melspectrogram(xt, fft, hop, mels, SR,
                                      frames_per_chunk=fpc, to_db=to_db)
    n_chunks = (5000 - (fft - hop)) // (hop * fpc)
    assert got.shape == (2, 1, mels, n_chunks * fpc)
    fb = tops.create_mel_filter(mels, SR, 0.0, None, fft // 2 + 1)
    one = tfused._reference(xt, fb, fft, hop, "hann", 2.0, to_db, 1.0, 1e-7)
    one = one[..., :got.shape[-1]]
    want = np.asarray(jpar.chunked_melspectrogram(
        jnp.asarray(x), fft, hop, mels, SR, frames_per_chunk=fpc,
        to_db=to_db))
    if to_db:
        assert (got - one).abs().max().item() <= DB_ATOL
        np.testing.assert_allclose(got.numpy(), want, atol=DB_ATOL, rtol=0)
    else:
        peak = one.abs().max().item()
        assert (got - one).abs().max().item() <= LIN_PARITY * peak
        assert np.max(np.abs(got.numpy() - want)) <= LIN_PARITY * peak


# ---- CorpusPreprocessor ----------------------------------------------------

def test_fault_tolerance_and_chunked_rows_match_jax(caplog):
    """Retry, then skip and log: the same files done and failed, the same
    sink ids and the same chunked log-mel rows as the JAX run."""
    with caplog.at_level(logging.WARNING,
                         logger="torchaudio_contrib_tpu.corpus"):
        stats, rows = _run(tpar)
    jstats, jrows = _jax_run()
    assert (stats.files_done, stats.files_failed) == (
        jstats.files_done, jstats.files_failed) == (N_FILES - 1, 1)
    assert BAD not in rows and FLAKY in rows
    assert stats.frames == jstats.frames > 0 and stats.frames_per_sec > 0
    _same_rows(rows, jrows)
    messages = [r.getMessage() for r in caplog.records]
    assert f"file {BAD} skipped after 2 attempts" in messages
    assert any(m.startswith(f"file {FLAKY} failed (attempt 1)")
               for m in messages)


def test_prefetch_with_workers_gives_the_serial_rows():
    """Four loader threads, three batches in flight: the same rows as the
    serial run (and so as the JAX run), whatever order they load in."""
    stats, rows = _run(tpar, workers=4, prefetch_batches=3)
    serial_stats, serial = _run(tpar)
    assert (stats.files_done, stats.files_failed) == (N_FILES - 1, 1)
    assert sorted(rows) == sorted(serial)
    for i in rows:
        np.testing.assert_array_equal(rows[i], serial[i])


def test_use_fused_matches_jax():
    """``use_fused=True`` on the CPU: the fused op's plain chain at
    ``precision="fast"``, every frame of the clip (no chunking)."""
    stats, rows = _run(tpar, use_fused=True)
    jstats, jrows = _jax_run(use_fused=True)
    n_frames = 1 + (CLIP - 256) // 64
    assert all(r.shape == (1, 32, n_frames) for r in rows.values())
    assert stats.frames == jstats.frames == (N_FILES - 1) * n_frames
    _same_rows(rows, jrows)


@pytest.mark.parametrize("wire,to_db", [("int16", True), ("mulaw8", False)])
def test_lossy_wires_match_jax(wire, to_db):
    """Quantised on the host as the JAX loader does, dequantised on the
    device; the rows match the JAX run's.  And they differ from the float32
    wire's by the codec's error, which the JAX tests bound (int16: 3e-2
    dB; μ-law: 2e-2 of peak, linear)."""
    stats, rows = _run(tpar, wire_format=wire, prefetch_batches=3,
                       to_db=to_db)
    _, jrows = _jax_run(wire_format=wire, prefetch_batches=3, to_db=to_db)
    assert (stats.files_done, stats.files_failed) == (N_FILES - 1, 1)
    _same_rows(rows, jrows, linear=not to_db)
    _, f32 = _run(tpar, to_db=to_db)
    for i in rows:
        if to_db:
            np.testing.assert_allclose(rows[i], f32[i], atol=3e-2)
        else:
            err = np.max(np.abs(rows[i] - f32[i])) / np.max(f32[i])
            assert 0 < err <= 2e-2, (i, err)


def test_last_batch_is_padded_with_silence():
    """12 files in batches of 8: the second batch is padded, and the pad
    value decodes to silence: μ-law code 128 is within half a code step of
    0 (code 0 would be a full-scale -1 DC signal)."""
    pre = tpar.CorpusPreprocessor(lambda i: CLIPS[i], clip_samples=CLIP,
                                  batch_size=BATCH, wire_format="mulaw8",
                                  device="cpu", **MEL)
    staged = []
    real = pre.features
    pre.features = lambda x, s: (staged.append((x.clone(), s.clone())),
                                 real(x, s))[1]
    stats = pre.run(range(N_FILES))
    assert stats.files_done == N_FILES and len(staged) == 2
    x, scale = staged[1]
    assert x.dtype == torch.uint8 and (x[4:] == 128).all()
    assert (scale[4:] == 1.0).all()
    assert pre._dequantize(x, scale)[4:].abs().max().item() < 1e-4
    assert pre._dequantize(torch.zeros_like(x), scale)[4:].min() == -1.0


def test_mesh_and_wire_format_are_checked():
    with pytest.raises(TypeError, match="DeviceMesh"):
        tpar.CorpusPreprocessor(lambda i: CLIPS[i], CLIP, BATCH,
                                mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="wire_format"):
        tpar.CorpusPreprocessor(lambda i: CLIPS[i], CLIP, BATCH,
                                wire_format="bf16", device="cpu")
