"""Operations and bytes that a cell's work needs, counted from its shapes.

The counts are of the function, whatever computes it: a real transform of
``n`` samples as an FFT does it (half the ``5 n log2 n`` of a complex one),
a matrix product as two operations a multiply-add, and every input byte
read once and every output byte written once.  ``|.|^2``, the dB epilogue,
ReLU, the means and the biases are left out: they are under 1 % of any
count here, and leaving them out keeps a bound a lower bound.  The
arithmetic of the fused mel kernels follows ``chip_smoke.py``'s
``_fft_flops`` and ``_mel_bounds`` (config 2 forward: 13.1 GFLOP, 106 MB;
forward + backward: 24.0 GFLOP for the backward).

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: FP32
outside the tensor cores (every configuration here runs in float32 with
TF32 off) and HBM3.
"""
from __future__ import annotations

import math

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def fft_flops(n_fft: int) -> float:
    """Operations of one real length-``n_fft`` transform as an FFT."""
    return 2.5 * n_fft * math.log2(n_fft)


def n_frames(n_samples: int, fft_length: int, hop_length: int) -> int:
    """Frames of a ``center=False`` transform: trailing samples that fill
    no frame are dropped."""
    return 1 + (n_samples - fft_length) // hop_length


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate."""
    return max(flops / PEAK_FP32, nbytes / PEAK_BYTES)


def logmel_fwd(streams: int, n_samples: int, fft_length: int,
               hop_length: int, mels: int) -> tuple:
    """``(flops, bytes)`` of the log-mel of ``streams`` waveforms: one
    transform a frame and the mel product over the bins there are; the
    waveform and the filterbank read, the log-mel written."""
    rows = streams * n_frames(n_samples, fft_length, hop_length)
    n_freqs = fft_length // 2 + 1
    flops = rows * fft_flops(fft_length) + 2.0 * rows * n_freqs * mels
    nbytes = F32 * (streams * n_samples + n_freqs * mels + rows * mels)
    return flops, nbytes


def logmel_bwd(streams: int, n_samples: int, fft_length: int,
               hop_length: int, mels: int, need_dx: bool,
               need_dfb: bool) -> tuple:
    """``(flops, bytes)`` of the log-mel's backward for the gradients
    asked for.  The filterbank's gradient is one product of the power
    spectrum with the mel cotangent; the waveform's is the product of the
    cotangent with the filterbank and one inverse transform a frame.
    Bytes: the cotangent, the filterbank and the waveform (the least input
    the spectrum follows from) read; each gradient written."""
    rows = streams * n_frames(n_samples, fft_length, hop_length)
    n_freqs = fft_length // 2 + 1
    product = 2.0 * rows * n_freqs * mels
    flops = 0.0
    nbytes = F32 * (rows * mels + n_freqs * mels + streams * n_samples)
    if need_dfb:
        flops += product
        nbytes += F32 * n_freqs * mels
    if need_dx:
        flops += product + rows * fft_flops(fft_length)
        nbytes += F32 * streams * n_samples
    return flops, nbytes


def same_out(size: int, stride: int) -> int:
    """Output length of a ``padding="SAME"`` convolution."""
    return -(-size // stride)


def cnn_fwd_flops(clips: int, mels: int, frames: int, channels,
                  classes: int, kernel: int = 3, stride: int = 2) -> float:
    """Operations of the classifier's convolutions and head, forward:
    ``2 · out_h · out_w · cout · cin · k²`` a convolution and clip."""
    h, w, cin, flops = mels, frames, 1, 0.0
    for cout in channels:
        h, w = same_out(h, stride), same_out(w, stride)
        flops += 2.0 * h * w * cout * cin * kernel * kernel
        cin = cout
    flops += 2.0 * cin * classes
    return clips * flops


def cnn_bwd_flops(clips: int, mels: int, frames: int, channels,
                  classes: int) -> float:
    """The backward: each weight's gradient and each input's gradient cost
    what the forward product costs; the first convolution's input gradient
    is counted, since a trainable filterbank needs it."""
    return 2.0 * cnn_fwd_flops(clips, mels, frames, channels, classes)
