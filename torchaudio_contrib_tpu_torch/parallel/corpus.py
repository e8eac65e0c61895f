"""Corpus-scale preprocessing: streamed chunked STFT and a batch
preprocessor, on one GPU or split over a mesh's data axis.

Port of ``torchaudio_contrib_tpu/parallel/corpus.py`` (BASELINE config 5).
``StreamingSTFT`` holds a carry of the last ``fft_length − hop`` samples, so
feeding chunks of ``hop·frames_per_chunk`` samples yields exactly the frames
a one-shot ``stft(center=False)`` gives; ``chunked_melspectrogram`` runs it
over fixed chunks of a long clip (a Python loop in place of ``lax.scan``,
the same O(chunk) working set for the transform).  ``CorpusPreprocessor``
loads, quantises, batches and transforms a corpus with the JAX package's
retry, skip-and-log, loader threads, prefetch, sink and wire formats.

Port-specific, on a CUDA device:

* each batch is written into a pinned host buffer and copied to the card
  with ``non_blocking=True`` on a side stream, so batch k+1's copy overlaps
  batch k's kernels; the compute stream waits for the copy, and the copied
  tensors are handed to it (``record_stream``) so the caching allocator
  does not reuse them early.  A buffer is refilled only after the event
  recorded behind its last copy has completed;
* a ``sink``'s rows come back into pinned host memory, copied right
  behind the batch's kernels, and ``sink(idx, row)`` runs only after that
  copy's event;
* ``stats.seconds`` covers the device work: the run waits for the last
  batch, as the JAX ``drain(final=True)`` forces execution;
* ``use_fused=True`` runs :func:`~..ops.fused.fused_melspectrogram` at
  ``precision="fast"``: with ``power=2`` a CUDA batch launches the fused
  log-mel kernel once (``ops.fused.KERNEL_LAUNCHES``) or raises; any other
  power computes the plain chain, the fused op's rule on every device.

With ``mesh=`` (a :func:`~.sharding.make_mesh` mesh) every rank runs the
same ``run(indices)``: each batch of ``batch_size`` indices is split over
the mesh's ``data`` axis, and each rank loads, stages and transforms the
rows that fall in its shard (``batch_size / data`` of them) on the mesh's
device, as the JAX ``shard_map`` runs the kernel per shard.  Each rank's
``sink`` gets its own rows, so the union over ranks is the one-rank run's;
the returned :class:`CorpusStats` are summed over the ``data`` ranks
(``seconds`` is the slowest rank's).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import math
import queue
import threading
import time
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from ..ops.complexops import complex_norm
from ..ops.db import amplitude_to_db
from ..ops.filters import apply_filterbank, create_mel_filter
from ..ops.fused import fused_melspectrogram
from ..ops.mulaw import mu_law_decoding
from ..ops.stft import stft as _stft
from ._comm import axis_group, mesh_device

logger = logging.getLogger("torchaudio_contrib_tpu.corpus")

__all__ = [
    "StreamingSTFT",
    "chunked_melspectrogram",
    "CorpusPreprocessor",
    "CorpusStats",
]

_WIRE_DTYPES = {"float32": torch.float32, "int16": torch.int16,
                "mulaw8": torch.uint8}


class StreamingSTFT:
    """Chunked STFT with overlap carry; identical frames to one-shot
    ``stft(center=False)`` over the concatenated stream.

    The state is an explicit tensor: the trailing ``fft_length −
    hop_length`` samples of everything fed so far.
    """

    def __init__(self, fft_length: int, hop_length: int, window="hann",
                 win_length: Optional[int] = None,
                 normalized: bool = False, onesided: bool = True):
        if hop_length > fft_length:
            raise ValueError("streaming requires hop_length <= fft_length")
        self.fft_length = fft_length
        self.hop_length = hop_length
        self.win_length = win_length if win_length is not None else fft_length
        self.window = window
        self.normalized = normalized
        self.onesided = onesided
        self.carry_len = fft_length - hop_length

    def init_state(self, batch_shape: Sequence[int] = (),
                   dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
        """Zero carry.  The implicit leading zeros mean the first
        ``carry_len`` samples of output correspond to zero padding; feed
        real samples into the state where exactness at the stream head
        matters."""
        return torch.zeros(tuple(batch_shape) + (self.carry_len,),
                           dtype=dtype, device=device)

    def process(self, state: torch.Tensor, chunk: torch.Tensor):
        """``state (..., carry)``, ``chunk (..., hop·k)`` → ``(state',
        spec)`` with ``spec (..., n_freqs, k)``."""
        n = chunk.shape[-1]
        if n % self.hop_length != 0:
            raise ValueError(
                f"chunk length {n} must be a multiple of hop_length="
                f"{self.hop_length}")
        buf = torch.cat([state, chunk], dim=-1)
        spec = _stft(buf, self.fft_length, self.hop_length, self.win_length,
                     self.window, center=False, normalized=self.normalized,
                     onesided=self.onesided)
        return buf[..., n:], spec


def chunked_melspectrogram(waveform: torch.Tensor,
                           fft_length: int = 2048,
                           hop_length: int = 512,
                           num_mels: int = 128,
                           sample_rate: float = 22050,
                           f_min: float = 0.0,
                           f_max: Optional[float] = None,
                           frames_per_chunk: int = 64,
                           window="hann",
                           to_db: bool = True,
                           power: float = 2.0) -> torch.Tensor:
    """Log-mel of a long ``(..., T)`` clip over fixed-size chunks: one
    chunk's frames at a time, the carry between them.

    The input is truncated to the carry plus a whole number of chunks (the
    JAX package's ``lax.scan`` drops the ragged tail chunk the same way);
    the output is ``(..., num_mels, n_chunks·frames_per_chunk)``.
    """
    stream = StreamingSTFT(fft_length, hop_length, window)
    chunk_samples = hop_length * frames_per_chunk
    total = waveform.shape[-1]
    n_chunks = max((total - stream.carry_len) // chunk_samples, 0)
    if n_chunks == 0:
        raise ValueError("input shorter than one chunk; call stft directly")
    fb = create_mel_filter(num_mels, sample_rate, f_min, f_max,
                           fft_length // 2 + 1, dtype=waveform.dtype,
                           device=waveform.device)
    # the carry starts as the first carry_len samples: frame 0 is exact
    carry = waveform[..., :stream.carry_len]
    mels = []
    for c in range(n_chunks):
        start = stream.carry_len + c * chunk_samples
        carry, spec = stream.process(
            carry, waveform[..., start:start + chunk_samples])
        mel = apply_filterbank(complex_norm(spec, power), fb)
        if to_db:
            mel = amplitude_to_db(mel, power=power)
        mels.append(mel)
    return torch.cat(mels, dim=-1)


@dataclasses.dataclass
class CorpusStats:
    files_done: int = 0
    files_failed: int = 0
    frames: int = 0
    seconds: float = 0.0

    @property
    def frames_per_sec(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0


class CorpusPreprocessor:
    """Batched mel extraction over a file corpus on one device, or on each
    rank of ``mesh``'s data axis (its shard of every batch; see the module
    docstring).

    ``loader(i) -> np.ndarray (channels, samples)`` may raise; failures are
    retried ``retries`` times, then the file is skipped and logged: a bad
    file never stops the run.  Clips are padded or truncated to
    ``clip_samples``, batched to ``batch_size`` (the last batch padded with
    silence) and transformed on ``device`` (the card unless the caller asks
    for the CPU).  ``wire_format`` is what crosses to the device:
    ``"float32"``, ``"int16"`` (peak-normalised on the host, dequantised on
    the device; ~3e-5 relative waveform error) or ``"mulaw8"`` (peak-
    normalised μ-law codes, a quarter of the float32 bytes; lossy, ~38 dB
    SNR).  ``prefetch_batches`` batches stay in flight before the oldest is
    drained to ``sink(idx, features)``.
    """

    def __init__(self, loader: Callable[[int], np.ndarray],
                 clip_samples: int, batch_size: int,
                 mesh=None,
                 channels: int = 1,
                 retries: int = 1,
                 sink: Optional[Callable[[int, np.ndarray], None]] = None,
                 num_workers: int = 0,
                 use_fused: bool = False,
                 wire_format: str = "float32",
                 prefetch_batches: int = 2,
                 device="cuda",
                 **mel_kwargs):
        if wire_format not in _WIRE_DTYPES:
            raise ValueError(f"unknown wire_format {wire_format!r}")
        self.mesh = mesh
        self._shard = (None, 0, 1)
        if mesh is not None:
            self._shard = axis_group(mesh, "data")
            if batch_size % self._shard[2] != 0:
                raise ValueError(
                    "batch_size must divide over the data axis")
            device = mesh_device(mesh)
        self.loader = loader
        self.clip_samples = clip_samples
        self.global_batch_size = batch_size
        self.batch_size = batch_size // self._shard[2]
        self.channels = channels
        self.retries = retries
        self.sink = sink
        self.num_workers = num_workers
        self.use_fused = use_fused
        self.wire_format = wire_format
        self.prefetch_batches = max(1, int(prefetch_batches))
        self.device = torch.device(device)
        self.mel_kwargs = mel_kwargs
        if use_fused:
            mk = mel_kwargs
            fft_length = mk.get("fft_length", 2048)
            self._fb = create_mel_filter(
                mk.get("num_mels", 128), mk.get("sample_rate", 22050),
                mk.get("f_min", 0.0), mk.get("f_max"), fft_length // 2 + 1,
                device=self.device)
        self._copy_stream = None      # made on the first CUDA run

    # ---- the device side ---------------------------------------------------

    def _dequantize(self, x: torch.Tensor, scale: torch.Tensor):
        """The wire batch as float32 waveforms, on its device."""
        if self.wire_format == "int16":
            return x.to(torch.float32) * (scale / 32767.0)[:, None, None]
        if self.wire_format == "mulaw8":
            return mu_law_decoding(x, 256) * scale[:, None, None]
        return x

    def features(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """``(batch, channels, mels, frames)`` features of a wire batch on
        the device."""
        x = self._dequantize(x, scale)
        if not self.use_fused:
            return chunked_melspectrogram(x, **self.mel_kwargs)
        mk = self.mel_kwargs
        return fused_melspectrogram(
            x, self._fb, mk.get("fft_length", 2048),
            mk.get("hop_length", 512), window=mk.get("window", "hann"),
            power=mk.get("power", 2.0), to_db=mk.get("to_db", True),
            precision="fast")

    # ---- the host side -----------------------------------------------------

    def _load_one(self, idx: int):
        """→ ``(clip, scale)`` or None.  In the int16 and mulaw8 wire
        formats the clip is peak-normalised and quantised here, on the
        loader thread, so the work runs in parallel; ``scale`` restores the
        amplitude on the device."""
        for attempt in range(self.retries + 1):
            try:
                x = np.asarray(self.loader(idx), dtype=np.float32)
                if x.ndim == 1:
                    x = x[None, :]
                out = np.zeros((self.channels, self.clip_samples),
                               np.float32)
                c = min(self.channels, x.shape[0])
                t = min(self.clip_samples, x.shape[1])
                out[:c, :t] = x[:c, :t]
                if self.wire_format == "int16":
                    scale = max(float(np.max(np.abs(out))), 1e-30)
                    xi = np.round(out * (32767.0 / scale)).astype(np.int16)
                    return xi, np.float32(scale)
                if self.wire_format == "mulaw8":
                    # the NumPy mirror of ops.mulaw.mu_law_encoding
                    scale = max(float(np.max(np.abs(out))), 1e-30)
                    xn = out / scale
                    y = np.sign(xn) * np.log1p(255.0 * np.abs(xn)) \
                        / math.log1p(255.0)
                    code = ((y + 1.0) / 2.0 * 255.0 + 0.5).astype(np.uint8)
                    return code, np.float32(scale)
                return out, np.float32(1.0)
            except Exception as e:  # noqa: BLE001 — the run must survive
                logger.warning("file %d failed (attempt %d): %s", idx,
                               attempt + 1, e)
        logger.error("file %d skipped after %d attempts", idx,
                     self.retries + 1)
        return None

    def _iter_loaded(self, indices: Iterable[int], stats: CorpusStats):
        """Yield ``(idx, (clip, scale))``; with ``num_workers > 0`` the
        loading runs on worker threads, overlapping the device (the GIL is
        released in file IO and in NumPy)."""
        if self.num_workers <= 0:
            for idx in indices:
                item = self._load_one(idx)
                if item is None:
                    stats.files_failed += 1
                else:
                    yield idx, item
            return

        idx_q: queue.Queue = queue.Queue()
        out_q: queue.Queue = queue.Queue(maxsize=4 * self.batch_size)
        end = object()

        def worker():
            while True:
                i = idx_q.get()
                if i is end:
                    out_q.put(end)
                    return
                out_q.put((i, self._load_one(i)))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        for i in indices:
            idx_q.put(i)
        for _ in threads:
            idx_q.put(end)
        done_workers = 0
        while done_workers < len(threads):
            item = out_q.get()
            if item is end:
                done_workers += 1
                continue
            i, x = item
            if x is None:
                stats.files_failed += 1
            else:
                yield i, x
        for t in threads:
            t.join()

    def _staging(self):
        """``prefetch_batches + 1`` host buffers ``(wire batch, scales,
        event of its last copy)``: pinned on a CUDA run."""
        cuda = self.device.type == "cuda"
        shape = (self.batch_size, self.channels, self.clip_samples)
        dtype = _WIRE_DTYPES[self.wire_format]
        return [(torch.empty(shape, dtype=dtype, pin_memory=cuda),
                 torch.empty(self.batch_size, dtype=torch.float32,
                             pin_memory=cuda),
                 torch.cuda.Event() if cuda else None)
                for _ in range(self.prefetch_batches + 1)]

    def _to_device(self, xh: torch.Tensor, sh: torch.Tensor, copied):
        """The staged batch on the device.  On a CUDA run the copy goes on
        the side stream, ``copied`` is recorded behind it, the compute
        stream waits for it and owns the copies from then on."""
        if self.device.type != "cuda":
            return xh.to(self.device), sh.to(self.device)
        compute = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            x = xh.to(self.device, non_blocking=True)
            scale = sh.to(self.device, non_blocking=True)
            copied.record(self._copy_stream)
        compute.wait_stream(self._copy_stream)
        x.record_stream(compute)
        scale.record_stream(compute)
        return x, scale

    def _my_indices(self, indices: Iterable[int]):
        """The indices of this rank's data shard of every batch."""
        _, r, n = self._shard
        if n == 1:
            yield from indices
            return
        for pos, idx in enumerate(indices):
            if (pos % self.global_batch_size) // self.batch_size == r:
                yield idx

    def _reduce_stats(self, stats: CorpusStats) -> CorpusStats:
        """Sum the counts over the data ranks; the slowest rank's time."""
        group, _, n = self._shard
        if n == 1:
            return stats
        dev = (self.device if torch.distributed.get_backend(group) == "nccl"
               else torch.device("cpu"))
        counts = torch.tensor([stats.files_done, stats.files_failed,
                               stats.frames], dtype=torch.float64,
                              device=dev)
        secs = torch.tensor([stats.seconds], dtype=torch.float64,
                            device=dev)
        torch.distributed.all_reduce(counts, group=group)
        torch.distributed.all_reduce(secs, op=torch.distributed.ReduceOp.MAX,
                                     group=group)
        done, failed, frames = (int(v) for v in counts.tolist())
        return CorpusStats(done, failed, frames, float(secs.item()))

    def run(self, indices: Iterable[int]) -> CorpusStats:
        stats = CorpusStats()
        cuda = self.device.type == "cuda"
        staging = self._staging()
        batch, scales, ids = [], [], []
        pending: collections.deque = collections.deque()
        n_dispatched = [0]
        t0 = time.perf_counter()

        def drain(p):
            mel, host, p_ids, done = p
            if done is not None:
                done.synchronize()
            if self.sink is not None:
                rows = (host if host is not None else mel).numpy()
                for k, idx in enumerate(p_ids):
                    self.sink(idx, rows[k])
            stats.frames += mel.shape[-1] * len(p_ids)

        def dispatch():
            """Launch this batch; drain the oldest batch in flight once
            ``prefetch_batches`` are queued, so host loading and sinking
            overlap the device several batches deep."""
            if not batch:
                return
            n = len(batch)
            xh, sh, copied = staging[n_dispatched[0] % len(staging)]
            n_dispatched[0] += 1
            if copied is not None:
                copied.synchronize()    # the buffer's last copy is done
            xn, sn = xh.numpy(), sh.numpy()
            for k, clip in enumerate(batch):
                xn[k] = clip
            # pad value per wire format: mu-law code 128 is silence (code 0
            # decodes to a full-scale -1.0 DC signal)
            xn[n:] = 128 if self.wire_format == "mulaw8" else 0
            sn[:n] = scales
            sn[n:] = 1.0
            x, scale = self._to_device(xh, sh, copied)
            mel = self.features(x, scale)
            host = done = None
            if cuda:
                if self.sink is not None:
                    host = torch.empty(mel.shape, dtype=mel.dtype,
                                       pin_memory=True)
                    host.copy_(mel, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            pending.append((mel, host, list(ids[:n]), done))
            batch.clear()
            scales.clear()
            ids.clear()
            while len(pending) > self.prefetch_batches:
                drain(pending.popleft())

        for idx, (clip, scale) in self._iter_loaded(
                self._my_indices(indices), stats):
            batch.append(clip)
            scales.append(scale)
            ids.append(idx)
            stats.files_done += 1
            if len(batch) == self.batch_size:
                dispatch()
        dispatch()
        while pending:
            drain(pending.popleft())
        stats.seconds = time.perf_counter() - t0
        return self._reduce_stats(stats)
