"""torchaudio_contrib_tpu_torch — the PyTorch + CUDA port.

The port of ``torchaudio_contrib_tpu`` (the JAX package, which stays the
reference) to PyTorch, with hand-written CUDA kernels for Hopper where the
JAX package had TPU kernels.  The slices ported so far cover the mel
front end for serving and training: windows, STFT, mel and linear
filterbanks, dB, the fused log-mel kernels (forward and backward), MFCC
and LFCC, the layer pipelines and ``MelFrontendClassifier`` (forward,
``loss_fn``, ``train_step``).
Module names follow the JAX package's; the flat names below mirror its
``__init__`` for the symbols ported so far.

This package imports torch and NumPy only — never JAX, and never the JAX
package.
"""

__version__ = "0.1.0"

from . import ops, models, utils

from .ops import (
    stft, frame_signal, num_frames,
    complex_norm, angle, magphase,
    hertz_to_mel, mel_to_hertz,
    create_mel_filter, create_linear_filter, apply_filterbank,
    amplitude_to_db, db_to_amplitude,
    amplitude_to_DB, DB_to_amplitude,
    fused_melspectrogram, fused_mel_supported, resolve_precision,
    create_dct, mfcc, lfcc,
    spectrogram, melspectrogram,
    hann_window, hamming_window, blackman_window, get_window,
)
from .models import (
    Transform, Pipeline,
    STFT, ComplexNorm,
    Filterbank, MelFilterbank, ApplyFilterbank,
    AmplitudeToDb, DbToAmplitude,
    Spectrogram, Melspectrogram, FusedMelspectrogram,
    MelFrontendClassifier,
)

__all__ = [
    "ops", "models", "utils",
    "stft", "frame_signal", "num_frames",
    "complex_norm", "angle", "magphase",
    "hertz_to_mel", "mel_to_hertz",
    "create_mel_filter", "create_linear_filter", "apply_filterbank",
    "amplitude_to_db", "db_to_amplitude",
    "amplitude_to_DB", "DB_to_amplitude",
    "fused_melspectrogram", "fused_mel_supported", "resolve_precision",
    "create_dct", "mfcc", "lfcc",
    "spectrogram", "melspectrogram",
    "hann_window", "hamming_window", "blackman_window", "get_window",
    "Transform", "Pipeline",
    "STFT", "ComplexNorm",
    "Filterbank", "MelFilterbank", "ApplyFilterbank",
    "AmplitudeToDb", "DbToAmplitude",
    "Spectrogram", "Melspectrogram", "FusedMelspectrogram",
    "MelFrontendClassifier",
]
