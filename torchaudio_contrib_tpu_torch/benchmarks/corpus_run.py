"""BASELINE config 5 on the card: corpus preprocessing through the fused
log-mel kernel.

    python -m torchaudio_contrib_tpu_torch.benchmarks.corpus_run

The shape of the JAX package's ``benchmarks/run_configs.py`` config 5: 512
files made from 8 synthetic 10 s clips at 16 kHz (``loader(i) = clips[i %
8]``), batches of 256, 2 loader threads, 3 batches in flight, the int16
wire, ``use_fused=True`` at fft 2048, hop 512, 128 mels, 22.05 kHz mel
scale.  One warm-up batch runs before the timed run.  Prints one JSON line:
files/s and frames/s of the timed run, its wall seconds, the host→device
bytes of a batch, the fused kernel's device time per batch (CUDA events on
one staged batch; and from ``torch.profiler`` over a second, traced run of
the same files), the device's busy time over that traced run and its share
of the timed run's wall (the trace's busy time over the untraced wall), and
the card's name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from . import card, time_cuda_ms
from ..ops import fused
from ..parallel import CorpusPreprocessor

CONFIG5 = dict(files=512, clips=8, samples=16000 * 10, batch_size=256,
               num_workers=2, prefetch_batches=3, wire_format="int16",
               use_fused=True, fft_length=2048, hop_length=512,
               num_mels=128, sample_rate=22050, frames_per_chunk=64)
_RUN_KEYS = ("batch_size", "num_workers", "prefetch_batches", "wire_format",
             "use_fused", "fft_length", "hop_length", "num_mels",
             "sample_rate", "frames_per_chunk")


def synthetic_clips(gen: torch.Generator, clips: int = CONFIG5["clips"],
                    samples: int = CONFIG5["samples"]) -> np.ndarray:
    """``(clips, 1, samples)`` float32 noise from ``gen``, on the host."""
    return torch.randn((clips, 1, samples), generator=gen).numpy()


def preprocessor(clips: np.ndarray, loader=None, **overrides):
    """Config 5's ``CorpusPreprocessor`` on the card over ``clips``
    (``loader(i) = clips[i % len(clips)]`` unless one is given)."""
    kw = {k: CONFIG5[k] for k in _RUN_KEYS}
    kw.update(overrides)
    if loader is None:
        def loader(i):
            return clips[i % len(clips)]
    return CorpusPreprocessor(loader, clip_samples=clips.shape[-1],
                              device="cuda", **kw)


def staged_batch(pre: CorpusPreprocessor, indices):
    """One batch of ``indices`` as the run stages it, on the card: the
    wire tensor and the scales."""
    items = [pre._load_one(i) for i in indices]
    x = torch.from_numpy(np.stack([c for c, _ in items])).cuda()
    scale = torch.tensor([s for _, s in items], dtype=torch.float32).cuda()
    return x, scale


def _device_ms(prof, calls: int = 1):
    """``(busy ms, fused forward kernel ms)`` of a trace: every device
    activity, and the forward kernels of ``csrc/fused_mel_fwd.cu``."""
    busy = b1 = 0.0
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = event.self_cuda_time_total
        busy += us / 1e3
        if "fused_mel" in event.key and "fwd" in event.key:
            b1 += us / 1e3
    return busy / calls, b1 / calls


def measure(pre: CorpusPreprocessor, files: int) -> dict:
    """The timed run of ``files`` files (its launches counted), then a
    traced run of the same files and the fused kernel on one staged batch
    by CUDA events."""
    from torch.profiler import ProfilerActivity, profile
    fused.KERNEL_LAUNCHES = fused.FFT_KERNEL_LAUNCHES = 0
    stats = pre.run(range(files))
    launches = (fused.KERNEL_LAUNCHES, fused.FFT_KERNEL_LAUNCHES)
    batches = -(-stats.files_done // pre.batch_size)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = pre.run(range(files))
    busy_ms, b1_trace_ms = _device_ms(prof)
    x, scale = staged_batch(pre, range(pre.batch_size))
    mk = pre.mel_kwargs
    with torch.inference_mode():
        wave = pre._dequantize(x, scale)
        b1_ms = time_cuda_ms(lambda: fused.fused_melspectrogram(
            wave, pre._fb, mk["fft_length"], mk["hop_length"],
            precision="fast"), 2, 7)
        features_ms = time_cuda_ms(lambda: pre.features(x, scale), 2, 7)
    wall = stats.seconds
    return {
        "files": stats.files_done, "failed": stats.files_failed,
        "batches": batches, "launches": launches[0],
        "fft_launches": launches[1],
        "files_per_sec": stats.files_done / wall,
        "frames_per_sec": stats.frames_per_sec, "frames": stats.frames,
        "wall_s": wall, "traced_wall_s": traced.seconds,
        "h2d_bytes_per_batch": x.numel() * x.element_size()
        + scale.numel() * scale.element_size(),
        "b1_ms_per_batch": b1_ms, "features_ms_per_batch": features_ms,
        "b1_trace_ms_per_batch": b1_trace_ms / batches,
        "busy_ms": busy_ms, "busy_share": busy_ms / (wall * 1e3),
    }


def run(seed: int = 0) -> dict:
    """Config 5 at full width: the warm-up batch, then :func:`measure`."""
    clips = synthetic_clips(torch.Generator().manual_seed(seed))
    pre = preprocessor(clips)
    pre.run(range(pre.batch_size))              # warm-up, untimed
    t0 = time.perf_counter()
    out = measure(pre, CONFIG5["files"])
    out["measure_s"] = time.perf_counter() - t0
    out["card"] = card()
    print(json.dumps({"config5": out}), flush=True)
    return out


if __name__ == "__main__":
    run()
