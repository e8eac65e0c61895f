"""GPU smoke run of the PyTorch port's serving, training and inverse paths.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``; builds the port's kernels from ``csrc/`` itself.  It
imports no JAX.  Phases, each printing its lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the kernels' ``nvcc`` build and its ptxas summary;
3. forward kernel vs plain PyTorch at small shapes (config 2, Whisper,
   stereo with a ragged frame count, ``to_db=False``, ``center=True``, a
   shorter window, the classifier's shape, fft 1024 with an odd frame
   count): relative error to peak <= 1e-5.  A power-of-two ``fft_length``
   from 256 to 2048 takes the shared-memory FFT kernel, any other
   (Whisper's 400) the DFT-product kernel; where the FFT kernel runs, the
   DFT-product kernel is run on the same input and held to the same bar;
4. gradients through the kernels (forward with its residual, backward)
   vs autograd of the plain chain at the same shapes, for the waveform and
   the filterbank, on the route the size takes and, where that is the FFT
   route, on the DFT route too: relative error to peak <= 1e-4, and two
   backward runs bitwise equal; then the filterbank-only case (the
   backward's frame passes not launched) and silence (gradients exactly
   0);
5. the serving path, once, between a reset and a read of the launch
   counters: BASELINE config 2 at full width (32 x 30 s at 22.05 kHz, fft
   2048, hop 512, 128 mels) through ``FusedMelspectrogram(precision=
   "split3")``, then ``MelFrontendClassifier(fused=True)`` answering 4
   requests of (8, 1, 16000) under ``torch.inference_mode()``; both must
   go through the FFT kernel (its own counter);
6. config 2 checked (shape, finiteness, parity) and timed, FFT route and
   DFT route, against the plain version (CUDA events);
7. the 4 requests' logits checked against the same module run on a CPU
   copy (the plain path);
8. the training path, each part between a reset and a read of the
   counters: config 2 forward + backward at full width through
   ``FusedMelspectrogram(trainable=True)`` with the waveform requiring
   grad, then BASELINE config 3 at full width: 4 ``train_step``s of
   ``MelFrontendClassifier(fused=True, trainable_frontend=True)`` on 32 x
   10 s at 16 kHz, each from the parameters the CPU copy had before its
   own step;
9. config 2's gradients checked against autograd of the plain chain; each
   kernel of both routes checked against its plain version at config 2,
   the FFT kernels also against the plain versions that repeat their
   arithmetic step by step; fwd+bwd, the forward with and without its
   residual and the backward timed on both routes against their plain
   versions;
10. config 3's losses and parameters checked against the CPU copy's
    (the plain path), and ms per step timed on both;
11. the fused Griffin-Lim kernels vs their plain version at small shapes
    (fft 1024 / hop 256, 2048 / 512, 1024 / 512, 1024 / 1024, fft 400 / hop
    160, stereo, ``center=False``, a Hamming window), in both state
    layouts, on the route the size takes (the shared-memory FFT kernels for
    a power of two from 256 to 2048, else the DFT-product kernels) and,
    where that is the FFT route, on the DFT route too: one iteration from
    the same state (the FFT kernels also against the plain version that
    repeats their arithmetic step by step), the 4-iteration waveform, the
    32-iteration spectral convergence; tile-major against row-major; two
    runs and the stage-bisect build's ``full`` variant bitwise against the
    solve;
12. the inverse path, each part between a reset and a read of the
    counters (every solve of it must take the FFT route): (a) ``griffin_lim(method="pallas")`` on the magnitudes of 8 x
    110 250 samples (fft 1024, hop 256, 431 frames, 32 iterations); (b) 4
    vocoder requests of 8 log-mels (8, 80, 431) through ``mel_to_audio`` at
    the Tacotron2 Griffin-Lim vocoder's settings (60 iterations) under
    ``torch.inference_mode()``; (c) the layout probe ``gl_probe.run`` at
    fft 1024 and 2048 and the stage bisect ``gl_bisect.run``;
13. (a) checked: shape, finiteness, spectral convergence against the
    ``matmul`` loop's on the same magnitudes;
14. BASELINE config 4: (4, 2, 32768) -> ``stft`` -> ``istft`` on the card
    (plain PyTorch, no kernel), max abs error <= 1e-4;
15. the solve at full width (fft 1024 and fft 2048) checked against its
    plain versions and timed on both routes against them, against the
    ``matmul`` and ``fft`` loops and against a loop of
    ``torch.stft``/``torch.istft``; the stage bisect on both routes.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before those lines; so does a machine without a CUDA card.
"""
from __future__ import annotations

import copy
from functools import partial
import json
import math
import re
import time

import torch

F32_PARITY = 1e-5      # kernel vs plain, max|diff| / max|plain|
GRAD_PARITY = 1e-4     # the same for gradients (BASELINE's bar)
LOGIT_ATOL = 1e-4      # classifier logits, kernel path vs plain path
LOSS_RTOL = 1e-5       # config 3, one step's loss, card vs CPU copy
# Config 3, parameters after one step from the same parameters, against
# the same step in float64 on the CPU: max|card - f64| / max|f64 update|.
# The update is lr * gradient, so this is the gradient's error relative to
# its peak, as GRAD_PARITY.  The filterbank's gradient is ill-conditioned
# once the first step has made some of its entries negative: mel bins then
# cancel towards 0, and d(dB)/d(mel) = 4.34 / mel amplifies the forward's
# f32 rounding (on this script's data the CPU's f32 chain lands 3-6 % of
# an update away from the float64 step there, the card up to 41 %; which
# mel entries land near 0 decides it).  So it is held to STEP_PARITY_FB at
# the first step and, after that, in l2 to FB_DRIFT_L2 of the update: a
# filterbank gradient that is missing or has the wrong sign lands 1 or 2
# away.
STEP_PARITY = 1e-4
STEP_PARITY_FB = 1e-3
FB_DRIFT_L2 = 0.5
# Fused Griffin-Lim, kernel vs plain (both f32 chains), relative to peak.
# One iteration from the same state: the two products (read off ``prev``,
# the unnormalised rebuilt spectrum) to GL_PRODUCT_PARITY; the projected
# state to GL_STATE_PARITY, since mag * upd / |upd| amplifies the products'
# rounding where |upd| is near zero.
GL_PRODUCT_PARITY = 1e-5
GL_STATE_PARITY = 1e-4
GL_WAVE_PARITY = 1e-4      # the 4-iteration waveform
GL_LAYOUT_PARITY = 1e-6    # tile-major vs row-major waveform
GL_CONV_PARITY = 1e-3      # |convergence(kernel) - convergence(plain)|, 32 it.
GL_CONV_SLACK = 0.05       # fused convergence <= the matmul loop's + this
ISTFT_ATOL = 1e-4          # config 4 round trip, max abs error
# Published peaks of one H100 SXM (data sheet, 700 W): FP32 outside the
# tensor cores, and HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# BASELINE.json config 2, the headline workload, at full width
CFG2 = dict(batch=32, seconds=30, sr=22050, fft=2048, hop=512, mels=128)
# BASELINE.json config 3 (trainable front end into the CNN), full width
CFG3 = dict(batch=32, samples=160000, sr=16000, fft=512, hop=128, mels=64,
            classes=10, steps=4, lr=1e-3)
# The Griffin-Lim benchmark's shape (8 x 5 s at 22.05 kHz, 32 iterations)
# at the vocoder's transform and at the stage bisect's.
GL_FULL = dict(clips=8, samples=110250, n_iter=32, momentum=0.99)
GL_SHAPES = ((1024, 256), (2048, 512))
# The Tacotron2 Griffin-Lim vocoder's settings.
VOCODER = dict(num_mels=80, sample_rate=22050, f_max=8000.0, fft_length=1024,
               hop_length=256, n_iter=60, power=1.0)
# With hop = fft a Hann window has no overlap, so a projection changes only
# the samples the clamped envelope zeroes.  From the zero-phase start the
# spectrum then stays almost real, and wherever a bin's real part passes
# through zero |upd| is near 0, where mag * upd / |upd| turns the products'
# rounding into a sign; nothing pulls a flipped bin back.  Which bins flip
# is the luck of rounding (seen on an H100: one bin in 1.4 million, 5e-4 of
# peak after one iteration, at products equal to 1e-6).  So at that shape
# the state and the waveform are compared in l2 (GL_NO_OVERLAP_L2) and
# the convergence to GL_NO_OVERLAP_CONV; the products keep their bar.
GL_NO_OVERLAP_L2 = 5e-3
GL_NO_OVERLAP_CONV = 2e-2
# name, shape, fft, hop, window, center
GL_CASES = [
    ("fft 1024 hop 256", (2, 11025), 1024, 256, "hann", True),
    ("fft 2048 hop 512", (2, 22050), 2048, 512, "hann", True),
    ("fft 1024 hop 512", (2, 11025), 1024, 512, "hann", True),
    ("fft 1024 hop 1024 (no overlap)", (2, 11025), 1024, 1024, "hann", True),
    ("fft 400 hop 160 (no multiple of 128, fft % hop != 0)", (2, 16000),
     400, 160, "hann", True),
    ("stereo (2, 2, T)", (2, 2, 6000), 512, 128, "hann", True),
    ("center=False", (2, 11025), 1024, 256, "hann", False),
    ("hamming window", (2, 6000), 512, 128, "hamming", True),
]
# name, shape, fft, hop, mels, sr, win_length, to_db, center
PARITY_CASES = [
    ("config 2, 2 x 4 s", (2, 4 * 22050), 2048, 512, 128, 22050,
     None, True, False),
    ("Whisper fft 400 hop 160", (2, 3 * 16000), 400, 160, 80, 16000,
     None, True, False),
    ("stereo (2, 2, T), ragged frames", (2, 2, 7000), 256, 64, 40,
     16000, None, True, False),
    ("to_db=False", (2, 20000), 512, 128, 64, 16000, None, False, False),
    ("center=True", (3, 9000), 512, 200, 64, 16000, None, True, True),
    ("win_length 300 < fft 512", (2, 9000), 512, 128, 64, 16000, 300,
     True, False),
    ("classifier shape (8, 1, 16000)", (8, 1, 16000), 512, 128, 64,
     16000, None, True, False),
    ("fft 1024 hop 256, 21 frames (odd)", (2, 1024 + 20 * 256), 1024, 256,
     80, 22050, None, True, False),
]


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def _counts() -> tuple:
    from torchaudio_contrib_tpu_torch.ops import fused
    return (fused.KERNEL_LAUNCHES, fused.BWD_KERNEL_LAUNCHES,
            fused.BWD_DFRAMES_LAUNCHES)


def _fft_counts() -> tuple:
    """Launches that took the FFT route: forward, backward frame passes."""
    from torchaudio_contrib_tpu_torch.ops import fused
    return (fused.FFT_KERNEL_LAUNCHES, fused.BWD_FFT_LAUNCHES)


def _reset_counts() -> None:
    from torchaudio_contrib_tpu_torch.ops import fused
    fused.KERNEL_LAUNCHES = 0
    fused.BWD_KERNEL_LAUNCHES = 0
    fused.BWD_DFRAMES_LAUNCHES = 0
    fused.FFT_KERNEL_LAUNCHES = 0
    fused.BWD_FFT_LAUNCHES = 0


def _dft_route(xs, fb, n_fft, hop, wl, to_db):
    """The fused op on ``xs (..., T)`` through the DFT-product kernels,
    whatever the size: the op's own path (``_fused_apply``) with the route
    named."""
    from torchaudio_contrib_tpu_torch.ops import fused
    return fused._fused_apply(
        xs, fb, n_fft, hop, "hann", wl, to_db, 1.0, 1e-7,
        partial(fused._fused_mel_fwd_cuda, _route="dft"),
        partial(fused._fused_mel_bwd_cuda, _route="dft"))


def _gl_counts() -> tuple:
    from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as fg
    return (fg.GL_KERNEL_LAUNCHES, fg.GL_TILE_MAJOR_LAUNCHES)


def _gl_fft_count() -> int:
    """Solves that took the FFT route."""
    from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as fg
    return fg.GL_FFT_LAUNCHES


def _reset_gl_counts() -> None:
    from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as fg
    fg.GL_KERNEL_LAUNCHES = 0
    fg.GL_TILE_MAJOR_LAUNCHES = 0
    fg.GL_FFT_LAUNCHES = 0


def _gl_operands(mag, n_fft: int, hop: int, window, tile_major: bool) -> dict:
    """``{route: operands}`` of the fused Griffin-Lim solve from the state
    two plain iterations reach (a generic complex state): the DFT route's
    (also the plain version's) and, where the size takes it, the FFT
    route's, first."""
    from torchaudio_contrib_tpu_torch.ops import fused, fused_griffinlim as fg
    dft = fg._gl_prepare(mag, n_fft, hop, window, None, tile_major)[:5]
    start, _ = fg._gl_solve_plain(*dft, n_fft, hop, 2, GL_FULL["momentum"],
                                  tile_major)
    ops = {}
    if fused._fft_kernel_supported(n_fft):
        ops["fft"] = (start,) + fg._gl_prepare(
            mag, n_fft, hop, window, None, tile_major, "fft")[1:5]
    ops["dft"] = (start,) + dft[1:]
    return ops


def _fft_flops(n_fft: int) -> float:
    """Operations of one real (or Hermitian) length-``n_fft`` transform as
    an FFT does it: half the ``5 n log2 n`` of a complex one."""
    return 2.5 * n_fft * math.log2(n_fft)


def _bound(flops: float, nbytes: float, design_flops: float) -> dict:
    """The least time the card could take for the function: the larger of
    the operations it needs (its transforms counted as FFTs, its other
    products over the bins there are) over the FP32 peak and the bytes over
    the memory rate.  ``design_flop_ms`` is beside it what these kernels'
    own operation count takes at that peak: every transform a dense matrix
    product over their padded 64-bin frequency tiles.  No single PyTorch
    call computes any of these kernels' functions, so ``library_ms`` is
    null; the named comparisons (the ``torch.stft`` chain, the ``fft``
    loop) are printed with the timings."""
    ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "design_flop_ms": design_flops / PEAK_FP32 * 1e3,
            "library_ms": None}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _grads(fn, x, fb, g, need=(True, True)):
    """``(dx, dfb)`` of ``sum(fn(x, fb) * g)``; None where not needed."""
    x = x.detach().clone().requires_grad_(need[0])
    fb = fb.detach().clone().requires_grad_(need[1])
    (fn(x, fb) * g).sum().backward()
    return x.grad, fb.grad


def _time_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median over ``iters`` runs of one call, by CUDA events."""
    from torchaudio_contrib_tpu_torch.benchmarks import time_cuda_ms
    return time_cuda_ms(fn, warmup, iters)


def _turns(plain, kern, warmup: int = 2, iters: int = 10) -> tuple:
    """(kernel ms, plain ms): in turns plain, kernel, kernel, plain; the
    better median of each."""
    a, b, c, d = (_time_ms(plain, warmup, iters), _time_ms(kern, warmup, iters),
                  _time_ms(kern, warmup, iters), _time_ms(plain, warmup, iters))
    return min(b, c), min(a, d)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    from torchaudio_contrib_tpu_torch.benchmarks import card as card_name
    card = card_name()
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
    print(f"build: {'nvcc built' if info['built'] else 'loaded'} "
          f"{info['path']} in {info['seconds']:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s); ptxas, per kernel: "
          + "; ".join(_ptxas_summary(info["log"])), flush=True)


def _ptxas_summary(log: str) -> list:
    """``name<template ints>: registers, spill bytes`` for each kernel in
    an ``nvcc -Xptxas -v`` log."""
    out, name, spilled = [], None, 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = re.search(r"\d+([a-z_]+kernel)", entry.group(1))
            ints = re.findall(r"L[ib](\d+)E", entry.group(1))
            name = (kernel.group(1) if kernel else entry.group(1)) \
                + (f"<{','.join(ints)}>" if ints else "")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            spilled = int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            out.append(f"{name} {used.group(1)} regs, {spilled} spill bytes")
            name = None
    return out


def phase_parity(gen: torch.Generator) -> None:
    from torchaudio_contrib_tpu_torch.ops import create_mel_filter, fused
    from torchaudio_contrib_tpu_torch.ops.stft import _pad_center
    for name, shape, n_fft, hop, mels, sr, wl, to_db, center in \
            PARITY_CASES:
        x = torch.randn(shape, generator=gen).cuda()
        fb = create_mel_filter(mels, sr, 0.0, None, n_fft // 2 + 1,
                               device="cuda")
        takes_fft = fused._fft_kernel_supported(n_fft)
        with torch.inference_mode():
            before = _counts()[0], _fft_counts()[0]
            got = fused.fused_melspectrogram(x, fb, n_fft, hop, to_db=to_db,
                                             win_length=wl, center=center)
            moved = _counts()[0] - before[0], _fft_counts()[0] - before[1]
            xs = _pad_center(x, n_fft // 2, "reflect") if center else x
            want = fused._reference(xs, fb, n_fft, hop, "hann", 2.0, to_db,
                                    1.0, 1e-7, wl)
            errs = {"fft" if takes_fft else "dft": _rel(got, want)}
            if takes_fft:
                errs["dft"] = _rel(_dft_route(xs, fb, n_fft, hop, wl, to_db),
                                   want)
        torch.cuda.synchronize()
        unit = "dB" if to_db else "linear"
        print(f"parity {name}: out {tuple(got.shape)}, "
              f"max|kernel-plain|/max|plain| ({unit}): "
              + ", ".join(f"{k} route {v:.3e}" for k, v in errs.items()),
              flush=True)
        _check(moved == (1, int(takes_fft)),
               f"{name}: launches (all, FFT route) {moved}")
        _check(got.shape == want.shape, f"{name}: shape {got.shape} != "
               f"{want.shape}")
        _check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
        _check(max(errs.values()) <= F32_PARITY,
               f"{name}: {errs} > {F32_PARITY}")


def phase_main_path(gen: torch.Generator):
    """Drive the serving path once, between one reset and one read of the
    launch counter: config 2 at full width, then the 4 classifier
    requests.  Checking and timing come after, outside the count."""
    import torchaudio_contrib_tpu_torch as tac
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
        _reset_counts()
        y = layer(x)
        torch.cuda.synchronize()
        cfg2_launches, cfg2_fft = _counts()[0], _fft_counts()[0]
        logits = [model(r.cuda()) for r in requests]
        torch.cuda.synchronize()
        launches, fft_launches = _counts()[0], _fft_counts()[0]
    print(f"main path: kernel launches {launches} (config 2: "
          f"{cfg2_launches}, serving: {launches - cfg2_launches}), of them "
          f"the FFT kernel {fft_launches} (config 2: {cfg2_fft}, serving: "
          f"{fft_launches - cfg2_fft})", flush=True)
    _check(cfg2_launches >= 1, "config 2 did not launch the kernel")
    _check(launches - cfg2_launches >= 4,
           f"4 requests launched the kernel {launches - cfg2_launches} "
           f"times")
    _check(cfg2_fft >= cfg2_launches
           and fft_launches - cfg2_fft >= launches - cfg2_launches,
           "the serving path did not go through the FFT kernel")
    return launches, (layer, x, y), (model_cpu, requests, logits)


def phase_config2(layer, x, y, card: str) -> dict:
    from torchaudio_contrib_tpu_torch.ops import fused
    n_fft, hop = CFG2["fft"], CFG2["hop"]
    frames = 1 + (x.shape[-1] - n_fft) // hop
    plain = lambda: fused._reference(x, layer.filterbank, n_fft, hop,  # noqa: E731
                                     "hann", 2.0, True, 1.0, 1e-7)
    kern = lambda: layer(x)  # noqa: E731
    dft = lambda: _dft_route(x, layer.filterbank, n_fft, hop, None,  # noqa: E731
                             True)
    with torch.inference_mode():
        ref = plain()
        _check(y.shape == (CFG2["batch"], 1, CFG2["mels"], frames),
               f"shape {tuple(y.shape)}")
        _check(bool(torch.isfinite(y).all()), "non-finite output")
        err, dft_err = _rel(y, ref), _rel(dft(), ref)
        max_abs = (y - ref).abs().max().item()
        _check(max(err, dft_err) <= F32_PARITY,
               f"config 2 parity {err}, DFT route {dft_err} > {F32_PARITY}")
        # in turns (plain, kernel, kernel, plain); the better median of each
        plain_a, ms_a, ms_b, plain_b = (_time_ms(plain), _time_ms(kern),
                                        _time_ms(kern), _time_ms(plain))
        ms, plain_ms = min(ms_a, ms_b), min(plain_a, plain_b)
        dft_ms = _time_ms(dft, 2, 7)
    n = CFG2["batch"] * frames
    print(f"config 2 ({CFG2['batch']} x {CFG2['seconds']} s, fft {n_fft}, "
          f"hop {hop}, {CFG2['mels']} mels): out {tuple(y.shape)}, "
          f"max|kernel-plain| = {max_abs:.3e} dB, rel {err:.3e} (DFT route "
          f"rel {dft_err:.3e})", flush=True)
    print(f"timing [{card}]: forward kernel, FFT route {ms:.3f} ms "
          f"({n / ms * 1e3:,.0f} frames/s), DFT route {dft_ms:.3f} ms "
          f"({n / dft_ms * 1e3:,.0f} frames/s), plain torch.stft chain "
          f"{plain_ms:.3f} ms ({n / plain_ms * 1e3:,.0f} frames/s)",
          flush=True)
    return {"design": "smem_fft", "max_abs_err": max_abs, "ms": ms,
            "dft_ms": dft_ms, "plain_ms": plain_ms}


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


def phase_grad_parity(gen: torch.Generator) -> None:
    """Gradients through the kernels vs autograd of the plain chain at the
    shapes of ``phase_parity``, then the filterbank-only and silent
    cases."""
    from torchaudio_contrib_tpu_torch.ops import create_mel_filter, fused
    from torchaudio_contrib_tpu_torch.ops.stft import _pad_center
    for name, shape, n_fft, hop, mels, sr, wl, to_db, center in \
            PARITY_CASES:
        x = torch.randn(shape, generator=gen).cuda()
        fb = create_mel_filter(mels, sr, 0.0, None, n_fft // 2 + 1,
                               device="cuda")

        def kern(xv, fbv):
            return fused.fused_melspectrogram(xv, fbv, n_fft, hop,
                                              to_db=to_db, win_length=wl,
                                              center=center)

        def plain(xv, fbv):
            xs = _pad_center(xv, n_fft // 2, "reflect") if center else xv
            return fused._reference(xs, fbv, n_fft, hop, "hann", 2.0, to_db,
                                    1.0, 1e-7, wl)

        with torch.no_grad():
            g = torch.randn(tuple(plain(x, fb).shape), generator=gen).cuda()
        def kern_dft(xv, fbv):
            xs = _pad_center(xv, n_fft // 2, "reflect") if center else xv
            return _dft_route(xs, fbv, n_fft, hop, wl, to_db)

        takes_fft = fused._fft_kernel_supported(n_fft)
        want = _grads(plain, x, fb, g)
        before, fft_before = _counts(), _fft_counts()
        got, again = _grads(kern, x, fb, g), _grads(kern, x, fb, g)
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(_counts(), before)]
        fft_launched = [a - b for a, b in zip(_fft_counts(), fft_before)]
        errs = [_rel(a, b) for a, b in zip(got, want)]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        line = ""
        if takes_fft:
            dft, dft_again = (_grads(kern_dft, x, fb, g),
                              _grads(kern_dft, x, fb, g))
            dft_errs = [_rel(a, b) for a, b in zip(dft, want)]
            bitwise = bitwise and all(torch.equal(a, b)
                                      for a, b in zip(dft, dft_again))
            line = (f" (FFT route; DFT route dx {dft_errs[0]:.3e}, dfb "
                    f"{dft_errs[1]:.3e})")
            _check(max(dft_errs) <= GRAD_PARITY,
                   f"{name}: DFT route gradient error {dft_errs}")
        print(f"grad parity {name}: max|kernel-plain|/max|plain| dx "
              f"{errs[0]:.3e}, dfb {errs[1]:.3e}{line}; two runs bitwise "
              f"equal {bitwise}; launches fwd/bwd/frame passes {launched}, "
              f"of them on the FFT route fwd/frame passes {fft_launched}",
              flush=True)
        _check(launched == [2, 2, 2], f"{name}: launches {launched}")
        _check(fft_launched == [2 * int(takes_fft)] * 2,
               f"{name}: FFT route launches {fft_launched}")
        _check(all(bool(torch.isfinite(t).all()) for t in got),
               f"{name}: non-finite gradient")
        _check(max(errs) <= GRAD_PARITY,
               f"{name}: gradient error {errs} > {GRAD_PARITY}")
        _check(bitwise, f"{name}: two backward runs differ")

    # config 2 at 2 x 4 s: the filterbank alone, then silence
    _, shape, n_fft, hop, mels, sr = PARITY_CASES[0][:6]
    x = torch.randn(shape, generator=gen).cuda()
    fb = create_mel_filter(mels, sr, 0.0, None, n_fft // 2 + 1, device="cuda")

    def kern(xv, fbv):
        return fused.fused_melspectrogram(xv, fbv, n_fft, hop)

    def plain(xv, fbv):
        return fused._reference(xv, fbv, n_fft, hop, "hann", 2.0, True, 1.0,
                                1e-7)

    with torch.no_grad():
        g = torch.randn(tuple(plain(x, fb).shape), generator=gen).cuda()
    _, want = _grads(plain, x, fb, g, need=(False, True))
    before = _counts()
    dx, got = _grads(kern, x, fb, g, need=(False, True))
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_counts(), before)]
    err = _rel(got, want)
    print(f"grad parity filterbank only: dfb {err:.3e}; launches "
          f"fwd/bwd/frame passes {launched}", flush=True)
    _check(dx is None and launched == [1, 1, 0],
           f"filterbank only: launches {launched} (frame passes must not run)")
    _check(err <= GRAD_PARITY, f"filterbank only: {err} > {GRAD_PARITY}")
    dx, dfb = _grads(kern, torch.zeros_like(x), fb, g)
    zero = not bool(dx.any()) and not bool(dfb.any())
    print(f"grad parity silence: gradients exactly 0: {zero}", flush=True)
    _check(zero, "silent input gave non-zero gradients")


def phase_train_path(gen: torch.Generator):
    """Drive the training path: config 2 forward + backward once, then
    config 3's train steps, each between a reset and a read of the
    counters.

    The CPU copy takes its steps first, outside the count, and each card
    step starts from the parameters the CPU copy had before its own step.
    Run free, the two drift apart for a reason that is not the kernels: at
    lr 1e-3 the loss of this model swings by 2x from one step to the next,
    and that amplifies rounding.  Compared one step at a time, each step's
    difference is that step's error alone."""
    import torchaudio_contrib_tpu_torch as tac
    layer = tac.FusedMelspectrogram(num_mels=CFG2["mels"],
                                    sample_rate=CFG2["sr"],
                                    fft_length=CFG2["fft"],
                                    hop_length=CFG2["hop"],
                                    precision="split3",
                                    trainable=True).cuda()
    n_samples = CFG2["seconds"] * CFG2["sr"]
    frames = 1 + (n_samples - CFG2["fft"]) // CFG2["hop"]
    x = torch.randn((CFG2["batch"], 1, n_samples),
                    generator=gen).cuda().requires_grad_()
    g = torch.randn((CFG2["batch"], 1, CFG2["mels"], frames),
                    generator=gen).cuda()

    model_cpu = tac.MelFrontendClassifier(
        num_classes=CFG3["classes"], num_mels=CFG3["mels"],
        sample_rate=CFG3["sr"], fft_length=CFG3["fft"],
        hop_length=CFG3["hop"], fused=True, trainable_frontend=True,
        precision="split3", generator=torch.Generator().manual_seed(1))
    model = copy.deepcopy(model_cpu).cuda()
    xb = torch.randn((CFG3["batch"], 1, CFG3["samples"]), generator=gen)
    labels = torch.randint(0, CFG3["classes"], (CFG3["batch"],),
                           generator=gen)
    snaps, cpu_losses = [], []
    t0 = time.perf_counter()
    for _ in range(CFG3["steps"]):
        snaps.append({k: v.clone() for k, v in model_cpu.state_dict().items()})
        cpu_losses.append(model_cpu.train_step(xb, labels, CFG3["lr"]).item())
    cpu_ms = (time.perf_counter() - t0) * 1e3 / CFG3["steps"]
    snaps.append(model_cpu.state_dict())
    xb_c, labels_c = xb.cuda(), labels.cuda()

    _reset_counts()
    y = layer(x)
    dx, dfb = torch.autograd.grad(y, (x, layer.filterbank), g)
    torch.cuda.synchronize()
    cfg2_counts, cfg2_fft = _counts(), _fft_counts()
    _reset_counts()
    losses, after = [], []
    for k in range(CFG3["steps"]):
        model.load_state_dict(snaps[k])
        losses.append(model.train_step(xb_c, labels_c, CFG3["lr"]))
        after.append({n: v.to("cpu", copy=True)
                      for n, v in model.state_dict().items()})
    torch.cuda.synchronize()
    cfg3_counts, cfg3_fft = _counts(), _fft_counts()
    print(f"training path: launches fwd/bwd/frame passes: config 2 fwd+bwd "
          f"{list(cfg2_counts)}, config 3 {CFG3['steps']} steps "
          f"{list(cfg3_counts)}; of them on the FFT route, fwd/frame "
          f"passes: config 2 {list(cfg2_fft)}, config 3 {list(cfg3_fft)}",
          flush=True)
    _check(cfg2_fft == (cfg2_counts[0], cfg2_counts[2])
           and cfg3_fft == (cfg3_counts[0], cfg3_counts[2]),
           "the training path did not go through the FFT kernels")
    _check(min(cfg2_counts) >= 1,
           f"config 2 fwd+bwd launches {cfg2_counts}: a kernel did not run")
    _check(cfg3_counts[0] >= CFG3["steps"] and cfg3_counts[1] >= CFG3["steps"],
           f"config 3 launches {cfg3_counts} < {CFG3['steps']} steps")
    _check(cfg3_counts[2] == 0, "config 3's waveform needs no gradient, but "
           "the backward ran its frame passes")
    counts = [a + b for a, b in zip(cfg2_counts, cfg3_counts)]
    return (counts, (layer, x, g, y, dx, dfb),
            (model, xb_c, labels_c, snaps, cpu_losses, cpu_ms, losses, after))


def phase_config2_train(layer, x, g, y, dx, dfb, card: str) -> tuple:
    """Config 2's gradients vs autograd of the plain chain; each kernel vs
    its plain version at config 2; timings.  Returns the forward with its
    residual's and the backward's stats."""
    from torchaudio_contrib_tpu_torch.ops import fused
    n_fft, hop, batch = CFG2["fft"], CFG2["hop"], CFG2["batch"]
    fb = layer.filterbank
    frames = y.shape[-1]
    args = (n_fft, hop, "hann", None, True, 1.0, 1e-7)
    _check(y.shape == (batch, 1, CFG2["mels"], frames)
           and dx.shape == x.shape and dfb.shape == fb.shape,
           f"shapes {tuple(y.shape)} {tuple(dx.shape)} {tuple(dfb.shape)}")
    _check(all(bool(torch.isfinite(t).all()) for t in (y, dx, dfb)),
           "config 2 fwd+bwd: non-finite")
    want = torch.autograd.grad(fused._reference(x, fb, *args[:3], 2.0,
                                                *args[4:]), (x, fb), g)
    errs = [_rel(dx, want[0]), _rel(dfb, want[1])]
    print(f"config 2 fwd+bwd ({batch} x {CFG2['seconds']} s): "
          f"max|kernel-plain|/max|plain| dx {errs[0]:.3e}, dfb "
          f"{errs[1]:.3e}", flush=True)
    _check(max(errs) <= GRAD_PARITY, f"config 2 gradients {errs}")

    with torch.no_grad():
        x2, fbd = x.detach().reshape(batch, -1), fb.detach()
        out_p, reim_p = fused._fwd_res_plain(x2, fbd, *args, save_spec=True)
        out_s, reim_s = fused._fwd_fft_plain(x2, fbd, *args, save_spec=True)
        dmel = fused._dmel_from(g.reshape(out_p.shape), out_p, *args[4:])
        reim2 = reim_p.reshape(dmel.shape[0], -1)
        bargs = (fbd, n_fft, "hann", None)
        dframes_p, dfb_p = fused._bwd_plain(dmel, reim2, *bargs, True, True)
        dframes_s, _ = fused._bwd_fft_plain(dmel, reim2, *bargs, True, False)
        del out_s
        stats = {}
        for route in ("fft", "dft"):
            out, reim = fused._fused_mel_fwd_cuda(x2, fbd, *args,
                                                  save_spec=True, _route=route)
            out_serve, _ = fused._fused_mel_fwd_cuda(x2, fbd, *args,
                                                     _route=route)
            runs = [fused._fused_mel_bwd_cuda(dmel, reim2, *bargs, True, True,
                                              _route=route) for _ in range(2)]
            torch.cuda.synchronize()
            (dframes, dfb_k), (dframes_2, dfb_2) = runs
            fwd_err = [_rel(out, out_p), _rel(reim, reim_p)]
            bwd_err = [_rel(dframes, dframes_p), _rel(dfb_k, dfb_p)]
            same = torch.equal(out, out_serve)
            twice = torch.equal(dframes, dframes_2) and torch.equal(dfb_k,
                                                                    dfb_2)
            step = ""
            if route == "fft":
                step_err = [_rel(reim, reim_s), _rel(dframes, dframes_s)]
                step = (f"; against the step-by-step plain versions "
                        f"residual {step_err[0]:.3e}, dframes "
                        f"{step_err[1]:.3e}")
                _check(step_err[0] <= F32_PARITY
                       and step_err[1] <= GRAD_PARITY,
                       f"FFT kernels vs their step-by-step versions: "
                       f"{step_err}")
            stats[route] = (
                (out - out_p).abs().max().item(),
                max((dframes - dframes_p).abs().max().item(),
                    (dfb_k - dfb_p).abs().max().item()))
            print(f"kernels at config 2, {route.upper()} route, vs their "
                  f"plain versions: forward out {fwd_err[0]:.3e}, residual "
                  f"{fwd_err[1]:.3e}, output with the residual bitwise equal "
                  f"to without: {same}; backward dframes {bwd_err[0]:.3e}, "
                  f"dfb {bwd_err[1]:.3e} (max abs {stats[route][1]:.3e}), "
                  f"two runs bitwise equal: {twice}{step}", flush=True)
            _check(max(fwd_err) <= F32_PARITY and same,
                   f"{route} forward with residual: {fwd_err}, same output "
                   f"{same}")
            _check(max(bwd_err) <= GRAD_PARITY and twice,
                   f"{route} backward kernel: {bwd_err}, two runs equal "
                   f"{twice}")
        del out, reim, out_serve, runs, dframes, dframes_2, dframes_s, reim_s
        del dframes_p, out_p
    fwd_abs, bwd_abs = stats["fft"]

    xg = x.detach().requires_grad_()

    def kern_fb():
        return torch.autograd.grad(layer(xg), (xg, fb), g)

    def dft_fb():
        return torch.autograd.grad(_dft_route(xg, fb, n_fft, hop, None, True),
                                   (xg, fb), g)

    def plain_fb():
        ref = fused._reference(xg, fb, *args[:3], 2.0, *args[4:])
        return torch.autograd.grad(ref, (xg, fb), g)

    def fwd(route=None, save_spec=False):
        return fused._fused_mel_fwd_cuda(x2, fbd, *args, save_spec=save_spec,
                                         _route=route)

    def bwd(need_dx=True, route=None):
        return fused._fused_mel_bwd_cuda(dmel, reim2, *bargs, need_dx, True,
                                         _route=route)

    def bwd_plain():
        return fused._bwd_plain(dmel, reim2, *bargs, True, True)

    ms_fb, plain_fb_ms = _turns(plain_fb, kern_fb)
    dft_fb_ms = _time_ms(dft_fb, 2, 5)
    with torch.no_grad():
        ms_res, ms_fwd = _turns(fwd, lambda: fwd(save_spec=True))
        ms_bwd, plain_bwd = _turns(bwd_plain, bwd)
        ms_bwd_fb = _time_ms(lambda: bwd(False), 2, 10)
        dft_fwd, dft_res, dft_bwd = (
            _time_ms(lambda: fwd("dft"), 2, 5),
            _time_ms(lambda: fwd("dft", True), 2, 5),
            _time_ms(lambda: bwd(True, "dft"), 2, 5))
        plain_fwd_res = _time_ms(lambda: fused._fwd_res_plain(
            x2, fbd, *args, save_spec=True), 2, 10)
    n = batch * frames
    print(f"timing [{card}]: config 2 fwd+bwd kernels, FFT route "
          f"{ms_fb:.3f} ms ({n / ms_fb * 1e3:,.0f} frames/s), DFT route "
          f"{dft_fb_ms:.3f} ms ({n / dft_fb_ms * 1e3:,.0f} frames/s), plain "
          f"chain autograd {plain_fb_ms:.3f} ms "
          f"({n / plain_fb_ms * 1e3:,.0f} frames/s)", flush=True)
    print(f"timing [{card}]: forward kernel, FFT route {ms_fwd:.3f} ms, with "
          f"residual {ms_res:.3f} ms; DFT route {dft_fwd:.3f} ms, with "
          f"residual {dft_res:.3f} ms (plain version with residual "
          f"{plain_fwd_res:.3f} ms); backward kernel, FFT route "
          f"{ms_bwd:.3f} ms, DFT route {dft_bwd:.3f} ms, dFB only "
          f"{ms_bwd_fb:.3f} ms, plain version {plain_bwd:.3f} ms", flush=True)
    return ({"max_abs_err": fwd_abs, "ms": ms_res, "dft_ms": dft_res,
             "plain_ms": plain_fwd_res},
            {"design": "smem_fft", "max_abs_err": bwd_abs, "ms": ms_bwd,
             "dft_ms": dft_bwd, "plain_ms": plain_bwd})


def phase_config3(model, xb_c, labels_c, snaps, cpu_losses, cpu_ms, losses,
                  after, card: str) -> None:
    """Config 3's card steps vs the CPU copy's losses and vs the same steps
    in float64 on the CPU (from the same parameters), then ms per step."""
    import torchaudio_contrib_tpu_torch as tac
    losses = [v.item() for v in losses]
    _check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    print(f"config 3 ({CFG3['batch']} x 1 x {CFG3['samples']}, fft "
          f"{CFG3['fft']}, hop {CFG3['hop']}, {CFG3['mels']} mels): losses "
          f"card {[f'{v:.6f}' for v in losses]}, CPU "
          f"{[f'{v:.6f}' for v in cpu_losses]}, max rel diff {loss_err:.3e}",
          flush=True)
    _check(loss_err <= LOSS_RTOL, f"config 3 losses differ by {loss_err}")

    exact = tac.MelFrontendClassifier(
        num_classes=CFG3["classes"], num_mels=CFG3["mels"],
        sample_rate=CFG3["sr"], fft_length=CFG3["fft"],
        hop_length=CFG3["hop"], fused=True, trainable_frontend=True,
        precision="split3").double()
    xb64, labels = xb_c.cpu().double(), labels_c.cpu()
    fb_name = next(n for n in snaps[0] if n.endswith("filterbank"))
    cnn_worst = 0.0
    for k, got in enumerate(after):
        exact.load_state_dict(snaps[k])
        exact.train_step(xb64, labels, CFG3["lr"])
        want = exact.state_dict()
        line = []
        for name, value in got.items():
            update = want[name] - snaps[k][name].double()
            err = value.double() - want[name]
            cpu = snaps[k + 1][name].double() - want[name]
            if name != fb_name:
                ratio = err.abs().max().item() / update.abs().max().item()
                cnn_worst = max(cnn_worst, ratio)
                continue
            if k == 0:
                fb = err.abs().max().item() / update.abs().max().item()
                fb_cpu = cpu.abs().max().item() / update.abs().max().item()
                line.append(f"filterbank max {fb:.3e} (CPU f32 {fb_cpu:.3e})")
                _check(fb <= STEP_PARITY_FB, f"step 0 filterbank {fb}")
            else:
                fb = (err.norm() / update.norm()).item()
                fb_cpu = (cpu.norm() / update.norm()).item()
                negative = int((snaps[k][name] < 0).sum())
                line.append(f"filterbank l2 {fb:.3e} (CPU f32 {fb_cpu:.3e}; "
                            f"{negative} entries < 0)")
                _check(fb <= FB_DRIFT_L2, f"step {k} filterbank l2 {fb}")
        print(f"config 3 step {k} vs float64: " + ", ".join(line), flush=True)
        _check(all(bool(torch.isfinite(v).all()) for v in got.values()),
               f"step {k}: non-finite parameters")
    print(f"config 3 every other parameter, every step: max|card-f64|/max|"
          f"update| {cnn_worst:.3e}", flush=True)
    _check(cnn_worst <= STEP_PARITY,
           f"config 3 CNN parameters differ: {cnn_worst}")

    # lr 0 runs every kernel of a step and leaves the parameters as they are
    ms = _time_ms(lambda: model.train_step(xb_c, labels_c, 0.0), 2, 8)
    plain = tac.MelFrontendClassifier(
        num_classes=CFG3["classes"], num_mels=CFG3["mels"],
        sample_rate=CFG3["sr"], fft_length=CFG3["fft"],
        hop_length=CFG3["hop"], fused=False, trainable_frontend=True,
        generator=torch.Generator().manual_seed(1)).cuda()
    plain_ms = _time_ms(lambda: plain.train_step(xb_c, labels_c, 0.0), 2, 8)
    print(f"timing [{card}]: config 3 train step, fused kernels "
          f"{ms:.3f} ms; plain STFT pipeline (fused=False) on the card "
          f"{plain_ms:.3f} ms; plain path on the CPU {cpu_ms:.1f} ms "
          f"(host clock)", flush=True)


def _convergence(y, mag, n_fft: int, hop: int, window="hann",
                 center: bool = True) -> float:
    """Spectral convergence ``|| |STFT(y)| - mag || / || mag ||``."""
    from torchaudio_contrib_tpu_torch.ops import stft
    got = stft(y, n_fft, hop, window=window, center=center).abs()
    return (torch.linalg.norm(got - mag) / torch.linalg.norm(mag)).item()


def phase_gl_parity(gen: torch.Generator) -> None:
    """The fused Griffin-Lim kernels vs their plain versions on the card,
    row-major (the JAX package's first kernel) and tile-major (its layout
    probe), and the stage-bisect build's ``full`` variant: on the route the
    size takes and, where that is the FFT route, on the DFT route too."""
    from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as fg
    from torchaudio_contrib_tpu_torch.ops import stft, stft_output_length
    m = GL_FULL["momentum"]
    with torch.inference_mode():
        for name, shape, n_fft, hop, window, center in GL_CASES:
            x = torch.randn(shape, generator=gen).cuda()
            mag = stft(x, n_fft, hop, window=window, center=center).abs()
            length = stft_output_length(mag.shape[-1], n_fft, hop,
                                        center=center)
            waves = {}
            if hop == n_fft:
                err_of, what = _rel_l2, "l2"
                bars = (GL_NO_OVERLAP_L2, GL_NO_OVERLAP_L2,
                        GL_NO_OVERLAP_CONV)
            else:
                err_of, what = _rel, "max|kernel-plain|/max|plain|"
                bars = (GL_STATE_PARITY, GL_WAVE_PARITY, GL_CONV_PARITY)
            args = (mag, n_fft, hop, window)
            for tile_major in (False, True):
                lay = "tile-major" if tile_major else "row-major"
                # one iteration in every version, from the state two plain
                # iterations reach (a generic complex state)
                ops = _gl_operands(mag, n_fft, hop, window, tile_major)
                p_state, p_prev = fg._gl_solve_plain(*ops["dft"], n_fft, hop,
                                                     1, m, tile_major)
                y4_p = fg._gl_plain(*args, 4, m, length, center,
                                    tile_major=tile_major)
                y32_p = fg._gl_plain(*args, 32, m, length, center,
                                     tile_major=tile_major)
                conv_p = _convergence(y32_p, mag, n_fft, hop, window, center)
                before = _gl_counts() + (_gl_fft_count(),)
                for route, route_ops in ops.items():
                    k_state, k_prev = fg._gl_solve_cuda(
                        *route_ops, n_fft, hop, 1, m, tile_major,
                        _route=route)
                    solve = partial(fg._gl_solve_cuda, _route=route)
                    y4, y32 = (fg._gl_run(solve, route, *args, n, m, length,
                                          center, None, tile_major)
                               for n in (4, 32))
                    torch.cuda.synchronize()
                    errs = (_rel(k_prev, p_prev), err_of(k_state, p_state),
                            err_of(y4, y4_p))
                    conv = _convergence(y32, mag, n_fft, hop, window, center)
                    step = ""
                    if route == "fft":
                        s_state, s_prev = fg._gl_solve_fft_plain(
                            *route_ops, n_fft, hop, 1, m, tile_major)
                        s_errs = (_rel(k_prev, s_prev),
                                  err_of(k_state, s_state))
                        step = (f" (against the step-by-step plain version "
                                f"products {s_errs[0]:.3e}, state "
                                f"{s_errs[1]:.3e})")
                        _check(s_errs[0] <= GL_PRODUCT_PARITY
                               and s_errs[1] <= bars[0],
                               f"{name}, {lay}: FFT kernels vs their "
                               f"step-by-step version {s_errs}")
                    print(f"gl parity {name}, {lay}, {route.upper()} route: "
                          f"{tuple(mag.shape)} -> {tuple(y4.shape)}; one "
                          f"iteration max|kernel-plain|/max|plain| products "
                          f"{errs[0]:.3e}, {what} state {errs[1]:.3e}{step}; "
                          f"4-iteration waveform {errs[2]:.3e}; 32-iteration "
                          f"convergence kernel {conv:.6f}, plain "
                          f"{conv_p:.6f}", flush=True)
                    _check(y4.shape == shape[:-1] + (length,)
                           and all(bool(torch.isfinite(t).all())
                                   for t in (k_state, k_prev, y4, y32)),
                           f"{name}, {lay}, {route}: shape {tuple(y4.shape)} "
                           f"or non-finite")
                    _check(errs[0] <= GL_PRODUCT_PARITY and errs[1] <= bars[0]
                           and errs[2] <= bars[1],
                           f"{name}, {lay}, {route}: {errs} over "
                           f"({GL_PRODUCT_PARITY}, {bars[0]}, {bars[1]})")
                    _check(abs(conv - conv_p) <= bars[2],
                           f"{name}, {lay}, {route}: convergence {conv} vs "
                           f"{conv_p}")
                    waves[route, tile_major] = y4
                # the op itself takes the first of the routes
                y4 = fg._gl_fused(*args, 4, m, length, center,
                                  tile_major=tile_major)
                torch.cuda.synchronize()
                launched = [a - b for a, b in zip(
                    _gl_counts() + (_gl_fft_count(),), before)]
                n = 3 * len(ops) + 1
                takes_fft = "fft" in ops
                _check(launched == [n, n * int(tile_major),
                                    4 * int(takes_fft)],
                       f"{name}, {lay}: launches (all, tile-major, FFT "
                       f"route) {launched}")
                _check(torch.equal(y4, waves[next(iter(ops)), tile_major]),
                       f"{name}, {lay}: the op did not take the "
                       f"{next(iter(ops))} route")
            for route in ops:
                layouts = _rel(waves[route, True], waves[route, False])
                same = torch.equal(waves[route, True], waves[route, False])
                # two runs, and the bisect build's "full" variant, are the
                # solve itself
                prep = fg._gl_prepare(mag, n_fft, hop, window, None, False,
                                      route)[:5]
                solve = fg._gl_solve_cuda(*prep, n_fft, hop, 4, m,
                                          _route=route)
                again = fg._gl_solve_cuda(*prep, n_fft, hop, 4, m,
                                          _route=route)
                full = fg._gl_solve_cuda(*prep, n_fft, hop, 4, m, False,
                                         "full", _route=route)
                nonorm = fg._gl_solve_cuda(*prep, n_fft, hop, 4, m, False,
                                           "nonorm", _route=route)
                twice = all(torch.equal(a, b) for a, b in zip(solve, again))
                bitwise = all(torch.equal(a, b) for a, b in zip(solve, full))
                print(f"gl parity {name}, {route.upper()} route: tile-major "
                      f"vs row-major waveform {layouts:.3e} (bitwise equal: "
                      f"{same}); two runs bitwise equal: {twice}; bisect "
                      f"'full' bitwise equal to the solve: {bitwise}; "
                      f"'nonorm' differs: "
                      f"{not torch.equal(nonorm[0], solve[0])}", flush=True)
                _check(layouts <= GL_LAYOUT_PARITY
                       and (same or route == "dft"),
                       f"{name}, {route}: layouts differ by {layouts}")
                _check(twice, f"{name}, {route}: two runs of the solve differ")
                _check(bitwise,
                       f"{name}, {route}: bisect 'full' differs from the solve")
                _check(not torch.equal(nonorm[0], solve[0]),
                       f"{name}, {route}: the 'nonorm' switch changed nothing")


def phase_inverse_path(gen: torch.Generator):
    """Drive the inverse path, each part between a reset and a read of the
    fused Griffin-Lim counters: (a) ``griffin_lim``, (b) the vocoder's
    ``mel_to_audio`` requests, (c) the layout probe, (d) the stage bisect.
    Returns the launches of the row-major solve, the tile-major solve and
    the bisect build, those of them on the FFT route, and what the later
    phases check."""
    from torchaudio_contrib_tpu_torch import ops
    from torchaudio_contrib_tpu_torch.benchmarks import gl_bisect, gl_probe
    clips, samples = GL_FULL["clips"], GL_FULL["samples"]
    n_fft, hop = GL_SHAPES[0]
    x = torch.randn((clips, samples), generator=gen).cuda()
    noise = [torch.randn((8, samples), generator=gen).cuda()
             for _ in range(4)]
    mel_kw = {k: VOCODER[k] for k in ("num_mels", "sample_rate", "f_max",
                                      "fft_length", "hop_length", "power")}
    with torch.inference_mode():
        mag = ops.stft(x, n_fft, hop).abs()
        logmels = [torch.log(torch.clamp(ops.melspectrogram(n, **mel_kw),
                                         min=1e-5)) for n in noise]
        _reset_gl_counts()
        y = ops.griffin_lim(mag, n_fft, hop, n_iter=GL_FULL["n_iter"],
                            momentum=GL_FULL["momentum"], length=samples,
                            method="pallas")
        torch.cuda.synchronize()
        a_counts, fft_counts = _gl_counts(), [_gl_fft_count()]
        _reset_gl_counts()
        waves = [ops.mel_to_audio(torch.exp(mel), method="pallas", **VOCODER)
                 for mel in logmels]
        torch.cuda.synchronize()
        b_counts = _gl_counts()
        fft_counts.append(_gl_fft_count())
        _reset_gl_counts()
        probes = [gl_probe.run(f, h, 5.0) for f, h in GL_SHAPES]
        torch.cuda.synchronize()
        c_counts = _gl_counts()
        fft_counts.append(_gl_fft_count())
        _reset_gl_counts()
        bisect = gl_bisect.run()
        torch.cuda.synchronize()
        d_counts = _gl_counts()
        fft_counts.append(_gl_fft_count())
    print(f"inverse path: solves launched (all, tile-major): griffin_lim "
          f"{list(a_counts)}, 4 vocoder requests {list(b_counts)}, layout "
          f"probe {list(c_counts)}, stage bisect {list(d_counts)}; of them "
          f"on the FFT route {fft_counts}", flush=True)
    _check(fft_counts == [a_counts[0], b_counts[0], c_counts[0], d_counts[0]],
           "the inverse path did not go through the FFT-route kernels")
    _check(a_counts == (1, 0), f"griffin_lim launched {a_counts}")
    _check(b_counts == (4, 0), f"4 vocoder requests launched {b_counts}")
    _check(c_counts[1] >= 2 and c_counts[0] - c_counts[1] >= 2,
           f"the layout probe launched {c_counts}")
    _check(d_counts[0] >= len(bisect) == 5 and d_counts[1] == 0,
           f"the stage bisect launched {d_counts} for {sorted(bisect)}")
    frames = mag.shape[-1]
    for mel, wave in zip(logmels, waves):
        _check(mel.shape == (8, VOCODER["num_mels"], frames)
               and wave.shape == (8, (frames - 1) * hop)
               and bool(torch.isfinite(wave).all())
               and wave.abs().max().item() > 0,
               f"vocoder: mel {tuple(mel.shape)} -> {tuple(wave.shape)}")
    for probe in probes:
        _check(probe["rel_err"] <= GL_LAYOUT_PARITY,
               f"layout probe: waveforms differ by {probe['rel_err']}")
    print(f"vocoder: 4 requests of log-mel {tuple(logmels[0].shape)} -> "
          f"waveform {tuple(waves[0].shape)}, finite; layout probe rel_err "
          f"{[p['rel_err'] for p in probes]}", flush=True)
    launches = (a_counts[0] + b_counts[0] + c_counts[0] - c_counts[1],
                c_counts[1], d_counts[0])
    # every solve of these paths took the FFT route (checked above)
    return launches, launches, (mag, y), probes, bisect


def phase_gl_full(mag, y) -> None:
    """(a)'s waveform checked against the ``matmul`` loop's convergence on
    the same magnitudes."""
    from torchaudio_contrib_tpu_torch import ops
    n_fft, hop = GL_SHAPES[0]
    with torch.inference_mode():
        ref = ops.griffin_lim(mag, n_fft, hop, n_iter=GL_FULL["n_iter"],
                              momentum=GL_FULL["momentum"],
                              length=GL_FULL["samples"], method="matmul")
        conv, conv_ref = (_convergence(t, mag, n_fft, hop) for t in (y, ref))
    print(f"griffin_lim {tuple(mag.shape)} -> {tuple(y.shape)}, "
          f"{GL_FULL['n_iter']} iterations: spectral convergence fused "
          f"{conv:.4f}, matmul loop {conv_ref:.4f}", flush=True)
    _check(y.shape == (GL_FULL["clips"], GL_FULL["samples"])
           and bool(torch.isfinite(y).all()), f"shape {tuple(y.shape)}")
    _check(conv <= conv_ref + GL_CONV_SLACK,
           f"fused convergence {conv} > matmul loop's {conv_ref} + "
           f"{GL_CONV_SLACK}")


def phase_config4(gen: torch.Generator) -> None:
    """BASELINE config 4: the ISTFT round trip on the card (no kernel)."""
    from torchaudio_contrib_tpu_torch import ops
    x = torch.randn((4, 2, 32768), generator=gen).cuda()
    with torch.inference_mode():
        back = ops.istft(ops.stft(x, 1024, 256), 256, length=32768)
    err = (back - x).abs().max().item()
    print(f"config 4: (4, 2, 32768) -> stft(1024, 256) -> istft: "
          f"{tuple(back.shape)}, max abs error {err:.3e}", flush=True)
    _check(back.shape == x.shape and err <= ISTFT_ATOL,
           f"round trip {tuple(back.shape)}, error {err} > {ISTFT_ATOL}")


def _library_gl(mag, n_fft: int, hop: int, n_iter: int, momentum: float,
                length: int):
    """Momentum Griffin-Lim as a loop of ``torch.stft``/``torch.istft``
    (cuFFT): the library yardstick, used nowhere in the port."""
    w = torch.hann_window(n_fft, device=mag.device)
    spec = torch.complex(mag, torch.zeros_like(mag))
    prev = torch.zeros_like(spec)
    for _ in range(n_iter):
        wave = torch.istft(spec, n_fft, hop, window=w, length=length)
        rebuilt = torch.stft(wave, n_fft, hop, window=w, return_complex=True)
        update = rebuilt + momentum * (rebuilt - prev)
        spec = mag * update / torch.clamp(update.abs(), min=1e-16)
        prev = rebuilt
    return torch.istft(spec, n_fft, hop, window=w, length=length)


def _gl_work(clips: int, n_frames: int, n_fft: int, hop: int, n_iter: int,
             tensors) -> dict:
    """Operation and byte counts of one fused Griffin-Lim solve.  ``flops``:
    the function, an inverse and a forward real transform per frame and
    iteration as FFTs.  ``design``: the FFT kernels' own count: each
    transform a complex one of ``n_fft/2`` points with its Hermitian or
    real-bin step (12 operations a bin) and the window, the overlap-add
    gather, the epilogue (16 operations a padded bin).  ``dft_design``: the
    DFT-product kernels', both transforms as dense products over ``ft``
    padded 64-bin tiles of re and im.  ``traffic``: the bytes three
    launches an iteration move through device memory: ``state`` and
    ``prev`` read and written, ``mag`` read, the frames ``fr`` and the
    signal ``xv`` written and read, every iteration."""
    state, mag_t = tensors[0], tensors[1]
    rows, half, ft = clips * n_frames, n_fft // 2, n_fft // 128 + 1
    n_samples = (n_frames - 1) * hop + n_fft
    transform = 5.0 * half * math.log2(half) + 12.0 * (half + 1) + n_fft
    design = n_iter * (rows * (2 * transform + 16.0 * ft * 64)
                       + clips * n_samples * (-(-n_fft // hop) + 1.0))
    traffic = n_iter * 4.0 * (4 * state.numel() + mag_t.numel()
                              + 2 * rows * n_fft + 2 * clips * n_samples)
    return {"flops": n_iter * 2 * rows * _fft_flops(n_fft), "design": design,
            "dft_design": n_iter * 2 * 2.0 * rows * (ft * 128) * n_fft,
            "traffic": traffic}


def phase_gl_timings(gen: torch.Generator, card: str, probes, bisect) -> tuple:
    """The solve at full width, fft 1024 and fft 2048: one iteration
    checked against the plain versions in both layouts on both routes, then
    the solve timed on both routes against its plain versions and the whole
    op against the other loops.  Returns the kernels-line entries of the
    row-major solve and the tile-major solve (fft 1024) and of the bisect
    build (fft 2048)."""
    from torchaudio_contrib_tpu_torch import ops
    from torchaudio_contrib_tpu_torch.benchmarks import gl_bisect
    from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as fg
    clips, samples = GL_FULL["clips"], GL_FULL["samples"]
    n_iter, m = GL_FULL["n_iter"], GL_FULL["momentum"]
    entries = {}
    x = torch.randn((clips, samples), generator=gen).cuda()
    with torch.inference_mode():
        for (n_fft, hop), probe in zip(GL_SHAPES, probes):
            mag = ops.stft(x, n_fft, hop).abs()
            for tile_major in (False, True):
                lay = "tile-major" if tile_major else "row-major"
                prep = _gl_operands(mag, n_fft, hop, "hann", tile_major)
                want = fg._gl_solve_plain(*prep["dft"], n_fft, hop, 1, m,
                                          tile_major)
                step = fg._gl_solve_fft_plain(*prep["fft"], n_fft, hop, 1, m,
                                              tile_major)
                errs = {}
                for route, route_ops in prep.items():
                    got = fg._gl_solve_cuda(*route_ops, n_fft, hop, 1, m,
                                            tile_major, _route=route)
                    errs[route] = (_rel(got[1], want[1]),
                                   _rel(got[0], want[0]))
                    if route == "fft":
                        max_abs = (got[0] - want[0]).abs().max().item()
                        s_errs = (_rel(got[1], step[1]), _rel(got[0], step[0]))
                    _check(errs[route][0] <= GL_PRODUCT_PARITY
                           and errs[route][1] <= GL_STATE_PARITY,
                           f"fft {n_fft}, {lay}, {route} route: one "
                           f"iteration {errs[route]}")
                _check(s_errs[0] <= GL_PRODUCT_PARITY
                       and s_errs[1] <= GL_STATE_PARITY,
                       f"fft {n_fft}, {lay}: FFT kernels vs their "
                       f"step-by-step version {s_errs}")

                def solve(route):
                    return fg._gl_solve_cuda(*prep[route], n_fft, hop, n_iter,
                                             m, tile_major, _route=route)

                ms, plain_ms = _turns(
                    lambda: fg._gl_solve_plain(*prep["dft"], n_fft, hop,
                                               n_iter, m, tile_major),
                    lambda: solve("fft"), 2, 7)
                dft_ms = _time_ms(lambda: solve("dft"), 1, 3)
                fft_plain_ms = _time_ms(
                    lambda: fg._gl_solve_fft_plain(*prep["fft"], n_fft, hop,
                                                   n_iter, m, tile_major),
                    1, 3)
                n_frames = mag.shape[-1]
                work = _gl_work(clips, n_frames, n_fft, hop, n_iter,
                                prep["fft"])
                stats = {"design": "smem_fft", "max_abs_err": max_abs,
                         "ms": ms, "dft_ms": dft_ms, "plain_ms": plain_ms,
                         "fft_plain_ms": fft_plain_ms,
                         **_bound(work["flops"],
                                  _nbytes(*prep["fft"], got[0], got[1]),
                                  work["design"]),
                         "dft_design_flop_ms":
                             work["dft_design"] / PEAK_FP32 * 1e3,
                         "traffic_floor_ms":
                             work["traffic"] / PEAK_BYTES * 1e3}
                print(f"timing [{card}]: fused Griffin-Lim solve, fft "
                      f"{n_fft}, hop {hop}, {clips} x {n_frames} "
                      f"frames, {n_iter} iterations, {lay}: kernels, FFT "
                      f"route {ms:.3f} ms, DFT route {dft_ms:.3f} ms; plain "
                      f"version {plain_ms:.3f} ms, step-by-step plain "
                      f"version {fft_plain_ms:.3f} ms; bound "
                      f"{stats['bound_ms']:.4f} ms by {stats['bound_by']} "
                      f"({work['flops'] / 1e9:.2f} GFLOP as FFTs), traffic "
                      f"floor of three launches an iteration "
                      f"{stats['traffic_floor_ms']:.3f} ms "
                      f"({work['traffic'] / 1e9:.2f} GB); the FFT kernels' "
                      f"{work['design'] / 1e9:.2f} GFLOP at the FP32 peak "
                      f"{stats['design_flop_ms']:.3f} ms, the DFT products' "
                      f"{work['dft_design'] / 1e12:.3f} TFLOP "
                      f"{stats['dft_design_flop_ms']:.3f} ms; one iteration "
                      f"max|kernel-plain|/max|plain| products, state: FFT "
                      f"route {errs['fft'][0]:.3e}, {errs['fft'][1]:.3e} "
                      f"(step-by-step {s_errs[0]:.3e}, {s_errs[1]:.3e}), DFT "
                      f"route {errs['dft'][0]:.3e}, {errs['dft'][1]:.3e}",
                      flush=True)
                entries[(n_fft, tile_major)] = stats
                del prep, want, step, got

            def whole(method):
                return ops.griffin_lim(mag, n_fft, hop, n_iter=n_iter,
                                       momentum=m, length=samples,
                                       method=method)

            fused_ms, matmul_ms, fft_ms, lib_ms = (
                _time_ms(lambda: whole("pallas"), 2, 5),
                _time_ms(lambda: whole("matmul"), 1, 3),
                _time_ms(lambda: whole("fft"), 1, 3),
                _time_ms(lambda: _library_gl(mag, n_fft, hop, n_iter, m,
                                             samples), 1, 3))
            conv = [_convergence(t, mag, n_fft, hop) for t in (
                whole("pallas"), whole("fft"),
                _library_gl(mag, n_fft, hop, n_iter, m, samples))]
            print(f"timing [{card}]: griffin_lim fft {n_fft}, hop {hop}, "
                  f"{n_iter} iterations, whole op: fused kernels "
                  f"{fused_ms:.3f} ms, matmul loop {matmul_ms:.3f} ms, fft "
                  f"loop {fft_ms:.3f} ms, torch.stft/torch.istft loop "
                  f"{lib_ms:.3f} ms; spectral convergence fused "
                  f"{conv[0]:.4f}, fft loop {conv[1]:.4f}, torch loop "
                  f"{conv[2]:.4f}; layout probe: row-major "
                  f"{probe['baseline']:.3f} ms, tile-major "
                  f"{probe['tile_major']:.3f} ms", flush=True)
            for key in ((n_fft, False), (n_fft, True)):
                entries[key].update(whole_op_ms=fused_ms,
                                    matmul_loop_ms=matmul_ms,
                                    fft_loop_ms=fft_ms,
                                    torch_stft_loop_ms=lib_ms)
        bisect_dft = gl_bisect.run(route="dft", iters=3)
    print(f"timing [{card}]: stage bisect at fft 2048, hop 512, ms per "
          f"variant: FFT route "
          + ", ".join(f"{k} {v:.3f}" for k, v in bisect.items())
          + "; DFT route "
          + ", ".join(f"{k} {v:.3f}" for k, v in bisect_dft.items()),
          flush=True)
    # the bisect build's own entry: its "full" variant at fft 2048, full
    # width, bitwise the solve, and one iteration against the plain version
    n_fft, hop = GL_SHAPES[1]
    with torch.inference_mode():
        mag = ops.stft(x, n_fft, hop).abs()
        prep = _gl_operands(mag, n_fft, hop, "hann", False)
        want = fg._gl_solve_plain(*prep["dft"], n_fft, hop, 1, m)
        for route, route_ops in prep.items():
            full = fg._gl_solve_cuda(*route_ops, n_fft, hop, 1, m, False,
                                     "full", _route=route)
            solve = fg._gl_solve_cuda(*route_ops, n_fft, hop, 1, m,
                                      _route=route)
            bitwise = all(torch.equal(a, b) for a, b in zip(full, solve))
            err = _rel(full[0], want[0])
            if route == "fft":
                max_abs = (full[0] - want[0]).abs().max().item()
            print(f"stage bisect 'full' at fft {n_fft}, {clips} x "
                  f"{mag.shape[-1]} frames, {route.upper()} route: bitwise "
                  f"equal to the solve: {bitwise}; one iteration "
                  f"max|kernel-plain|/max|plain| state {err:.3e}", flush=True)
            _check(bitwise, f"bisect 'full' differs from the solve at full "
                   f"width on the {route} route")
            _check(err <= GL_STATE_PARITY,
                   f"bisect 'full', {route} route, one iteration: {err}")
    bisect_entry = {**entries[(n_fft, False)], "max_abs_err": max_abs,
                    "ms": bisect["full"], "dft_ms": bisect_dft["full"],
                    "variants_ms": bisect, "dft_variants_ms": bisect_dft}
    n_fft = GL_SHAPES[0][0]
    return entries[(n_fft, False)], entries[(n_fft, True)], bisect_entry


def _mel_bounds(x, mels: int, n_fft: int, hop: int) -> tuple:
    """The bounds of the fused mel forward and backward at ``x (B, 1, T)``.
    The function: one real transform per frame (an FFT's operations) plus
    the mel products over the ``n_fft//2 + 1`` bins there are, in FP32;
    each input read once and each output written once.  ``design_flop_ms``
    is for the FFT kernels' own count: one complex transform per two
    frames, splitting the pair (12 operations a bin), and the mel products
    over the bins padded to groups of 4 (forward) or to the 64-bin tiles
    (backward) and the mels padded to 64.  ``dft_design_flop_ms`` is for
    the DFT-product kernels: the transform as a matrix product over their
    padded 64-bin tiles."""
    rows = x.shape[0] * (1 + (x.shape[-1] - n_fft) // hop)
    n_freqs = n_fft // 2 + 1
    ft = -(-n_freqs // 64)
    m_pad = -(-mels // 64) * 64
    fft, mel = rows * _fft_flops(n_fft), 2.0 * rows * n_freqs * mels
    split = 12.0 * rows * n_freqs
    mel_quads = 2.0 * rows * 4 * -(-n_freqs // 4) * m_pad
    dft = 2.0 * rows * n_fft * ft * 128
    mel_pad = 2.0 * rows * ft * 64 * m_pad
    fb = n_freqs * mels
    fwd = _bound(fft + mel, 4 * (x.numel() + fb + rows * mels),
                 fft + split + mel_quads)
    bwd = _bound(fft + 2 * mel, 4 * (rows * mels + rows * 2 * n_freqs + fb
                                     + rows * n_fft + fb),
                 fft + split + 2 * mel_pad)
    fwd["dft_design_flop_ms"] = (dft + mel_pad) / PEAK_FP32 * 1e3
    bwd["dft_design_flop_ms"] = (dft + 2 * mel_pad) / PEAK_FP32 * 1e3
    return fwd, bwd


def main() -> None:
    card = phase_device()
    phase_build()
    gen = torch.Generator().manual_seed(0)
    phase_parity(gen)
    phase_grad_parity(gen)
    launches, cfg2_run, serving_run = phase_main_path(gen)
    stats = phase_config2(*cfg2_run, card)
    phase_serving(*serving_run)
    train_counts, cfg2_train, cfg3_train = phase_train_path(gen)
    _, bwd_stats = phase_config2_train(*cfg2_train, card)
    phase_config3(*cfg3_train, card)
    fwd_bound, bwd_bound = _mel_bounds(cfg2_run[1], CFG2["mels"], CFG2["fft"],
                                       CFG2["hop"])
    del cfg2_run, serving_run, cfg2_train, cfg3_train
    torch.cuda.empty_cache()
    phase_gl_parity(gen)
    gl_launches, gl_fft_launches, gl_run, probes, bisect = \
        phase_inverse_path(gen)
    phase_gl_full(*gl_run)
    phase_config4(gen)
    gl_stats = phase_gl_timings(gen, card, probes, bisect)
    source = "torchaudio_contrib_tpu_torch/csrc/"
    gl_file = "torchaudio_contrib_tpu/ops/fused_griffinlim.py"
    kernels = [
        {"name": "fused_mel_fwd", "route": "cuda",
         "source": source + "fused_mel_fwd.cu",
         "headers": [source + "fft_smem.cuh"],
         "replaces": "torchaudio_contrib_tpu/ops/fused.py:440",
         "launches": launches + train_counts[0], **stats, **fwd_bound},
        {"name": "fused_mel_bwd", "route": "cuda",
         "source": source + "fused_mel_bwd.cu",
         "headers": [source + "fft_smem.cuh"],
         "replaces": "torchaudio_contrib_tpu/ops/fused.py:604",
         "launches": train_counts[1], **bwd_stats, **bwd_bound},
    ] + [
        {"name": name, "route": "cuda", "source": source + "fused_gl.cu",
         "headers": [source + "fft_smem.cuh"], "replaces": replaces,
         "launches": n, "fft_launches": on_fft, "dft_launches": n - on_fft,
         **entry}
        for name, replaces, n, on_fft, entry in zip(
            ("fused_gl", "fused_gl_tile_major", "fused_gl_bisect"),
            (gl_file + ":132", gl_file + ":261",
             "benchmarks/r3_gl_bisect.py:97"), gl_launches, gl_fft_launches,
            gl_stats)
    ]
    for k in kernels:
        # a bound over a time measured for the same function is no bound
        _check(0 < k["bound_ms"] <= min(k["ms"], k["plain_ms"]),
               f"{k['name']}: bound {k['bound_ms']} ms over a measured time")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
