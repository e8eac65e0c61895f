"""GPU smoke run of the PyTorch port's serving path.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``; builds the port's kernels from ``csrc/`` itself.  It
imports no JAX.  Phases, each printing its lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the kernels' ``nvcc`` build and its ptxas summary;
3. kernel vs plain PyTorch at small shapes (config 2, Whisper, stereo with
   a ragged frame count, ``to_db=False``, ``center=True``, a shorter
   window, the classifier's shape): relative error to peak <= 1e-5;
4. the main path, once, between a reset and a read of the kernel's launch
   counter: BASELINE config 2 at full width (32 x 30 s at 22.05 kHz, fft
   2048, hop 512, 128 mels) through
   ``FusedMelspectrogram(precision="split3")``, then
   ``MelFrontendClassifier(fused=True)`` answering 4 requests of
   (8, 1, 16000) under ``torch.inference_mode()``;
5. config 2 checked (shape, finiteness, parity) and timed against the
   plain version (CUDA events);
6. the 4 requests' logits checked against the same module run on a CPU
   copy (the plain path).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before those lines; so does a machine without a CUDA card.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import time

import torch

F32_PARITY = 1e-5      # kernel vs plain, max|diff| / max|plain|
LOGIT_ATOL = 1e-4      # classifier logits, kernel path vs plain path
# BASELINE.json config 2, the headline workload, at full width
CFG2 = dict(batch=32, seconds=30, sr=22050, fft=2048, hop=512, mels=128)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def _time_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median over ``iters`` runs of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)          # name, power limit
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    from torchaudio_contrib_tpu_torch.ops import _cuda, fused
    t0 = time.perf_counter()
    fused._kernel_lib()
    info = _cuda.build_info()
    summary = [line.strip() for line in info["log"].splitlines()
               if "registers" in line or "spill" in line]
    print(f"build: {'nvcc built' if info['built'] else 'loaded'} "
          f"{info['path']} in {info['seconds']:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s); "
          + "; ".join(summary), flush=True)


def phase_parity(gen: torch.Generator) -> None:
    from torchaudio_contrib_tpu_torch.ops import create_mel_filter, fused
    from torchaudio_contrib_tpu_torch.ops.stft import _pad_center
    cases = [
        # name, shape, fft, hop, mels, sr, win_length, to_db, center
        ("config 2, 2 x 4 s", (2, 4 * 22050), 2048, 512, 128, 22050,
         None, True, False),
        ("Whisper fft 400 hop 160", (2, 3 * 16000), 400, 160, 80, 16000,
         None, True, False),
        ("stereo (2, 2, T), ragged frames", (2, 2, 7000), 256, 64, 40,
         16000, None, True, False),
        ("to_db=False", (2, 20000), 512, 128, 64, 16000, None, False,
         False),
        ("center=True", (3, 9000), 512, 200, 64, 16000, None, True, True),
        ("win_length 300 < fft 512", (2, 9000), 512, 128, 64, 16000, 300,
         True, False),
        ("classifier shape (8, 1, 16000)", (8, 1, 16000), 512, 128, 64,
         16000, None, True, False),
    ]
    for name, shape, n_fft, hop, mels, sr, wl, to_db, center in cases:
        x = torch.randn(shape, generator=gen).cuda()
        fb = create_mel_filter(mels, sr, 0.0, None, n_fft // 2 + 1,
                               device="cuda")
        with torch.inference_mode():
            got = fused.fused_melspectrogram(x, fb, n_fft, hop, to_db=to_db,
                                             win_length=wl, center=center)
            xs = _pad_center(x, n_fft // 2, "reflect") if center else x
            want = fused._reference(xs, fb, n_fft, hop, "hann", 2.0, to_db,
                                    1.0, 1e-7, wl)
        torch.cuda.synchronize()
        err = _rel(got, want)
        unit = "dB" if to_db else "linear"
        print(f"parity {name}: out {tuple(got.shape)}, "
              f"max|kernel-plain|/max|plain| = {err:.3e} ({unit})",
              flush=True)
        _check(got.shape == want.shape, f"{name}: shape {got.shape} != "
               f"{want.shape}")
        _check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
        _check(err <= F32_PARITY, f"{name}: {err} > {F32_PARITY}")


def phase_main_path(gen: torch.Generator):
    """Drive the serving path once, between one reset and one read of the
    launch counter: config 2 at full width, then the 4 classifier
    requests.  Checking and timing come after, outside the count."""
    import torchaudio_contrib_tpu_torch as tac
    from torchaudio_contrib_tpu_torch.ops import fused
    layer = tac.FusedMelspectrogram(num_mels=CFG2["mels"],
                                    sample_rate=CFG2["sr"],
                                    fft_length=CFG2["fft"],
                                    hop_length=CFG2["hop"],
                                    precision="split3").cuda()
    x = torch.randn((CFG2["batch"], 1, CFG2["seconds"] * CFG2["sr"]),
                    generator=gen).cuda()
    model_cpu = tac.MelFrontendClassifier(
        num_classes=10, num_mels=64, sample_rate=16000, fft_length=512,
        hop_length=128, fused=True,
        generator=torch.Generator().manual_seed(0)).eval()
    model = copy.deepcopy(model_cpu).cuda()
    requests = [torch.randn((8, 1, 16000), generator=gen)
                for _ in range(4)]
    with torch.inference_mode():
        fused.KERNEL_LAUNCHES = 0
        y = layer(x)
        torch.cuda.synchronize()
        cfg2_launches = fused.KERNEL_LAUNCHES
        logits = [model(r.cuda()) for r in requests]
        torch.cuda.synchronize()
        launches = fused.KERNEL_LAUNCHES
    print(f"main path: kernel launches {launches} (config 2: "
          f"{cfg2_launches}, serving: {launches - cfg2_launches})",
          flush=True)
    _check(cfg2_launches >= 1, "config 2 did not launch the kernel")
    _check(launches - cfg2_launches >= 4,
           f"4 requests launched the kernel {launches - cfg2_launches} "
           f"times")
    return launches, (layer, x, y), (model_cpu, requests, logits)


def phase_config2(layer, x, y, card: str) -> dict:
    from torchaudio_contrib_tpu_torch.ops import fused
    n_fft, hop = CFG2["fft"], CFG2["hop"]
    frames = 1 + (x.shape[-1] - n_fft) // hop
    plain = lambda: fused._reference(x, layer.filterbank, n_fft, hop,  # noqa: E731
                                     "hann", 2.0, True, 1.0, 1e-7)
    kern = lambda: layer(x)  # noqa: E731
    with torch.inference_mode():
        ref = plain()
        _check(y.shape == (CFG2["batch"], 1, CFG2["mels"], frames),
               f"shape {tuple(y.shape)}")
        _check(bool(torch.isfinite(y).all()), "non-finite output")
        err = _rel(y, ref)
        max_abs = (y - ref).abs().max().item()
        _check(err <= F32_PARITY, f"config 2 parity {err} > {F32_PARITY}")
        # in turns (plain, kernel, kernel, plain); the better median of each
        plain_a, ms_a, ms_b, plain_b = (_time_ms(plain), _time_ms(kern),
                                        _time_ms(kern), _time_ms(plain))
        ms, plain_ms = min(ms_a, ms_b), min(plain_a, plain_b)
    n = CFG2["batch"] * frames
    print(f"config 2 ({CFG2['batch']} x {CFG2['seconds']} s, fft {n_fft}, "
          f"hop {hop}, {CFG2['mels']} mels): out {tuple(y.shape)}, "
          f"max|kernel-plain| = {max_abs:.3e} dB, rel {err:.3e}", flush=True)
    print(f"timing [{card}]: kernel {ms:.3f} ms ({n / ms * 1e3:,.0f} "
          f"frames/s), plain torch.stft chain {plain_ms:.3f} ms "
          f"({n / plain_ms * 1e3:,.0f} frames/s)", flush=True)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def phase_serving(model_cpu, requests, logits) -> None:
    worst = 0.0
    with torch.inference_mode():
        for r, got in zip(requests, logits):
            _check(got.shape == (8, 10), f"logits {tuple(got.shape)}")
            _check(bool(torch.isfinite(got).all()), "non-finite logits")
            want = model_cpu(r)
            worst = max(worst, (got.cpu() - want).abs().max().item())
    print(f"serving: 4 requests of (8, 1, 16000) -> logits (8, 10), "
          f"max|logits - plain-path logits| = {worst:.3e}", flush=True)
    _check(worst <= LOGIT_ATOL, f"logits differ by {worst} > {LOGIT_ATOL}")


def main() -> None:
    card = phase_device()
    phase_build()
    gen = torch.Generator().manual_seed(0)
    phase_parity(gen)
    launches, cfg2_run, serving_run = phase_main_path(gen)
    stats = phase_config2(*cfg2_run, card)
    phase_serving(*serving_run)
    kernel = {
        "name": "fused_mel_fwd",
        "route": "cuda",
        "source": "torchaudio_contrib_tpu_torch/csrc/fused_mel_fwd.cu",
        "replaces": "torchaudio_contrib_tpu/ops/fused.py:440",
        "launches": launches,
        **stats,
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
