"""torchaudio_contrib_tpu_torch — the PyTorch + CUDA port.

The port of ``torchaudio_contrib_tpu`` (the JAX package, which stays the
reference) to PyTorch, with hand-written CUDA kernels for Hopper where the
JAX package had TPU kernels.  The slices ported so far cover the mel
front end for serving and training (windows, STFT, mel and linear
filterbanks, dB, the fused log-mel kernels forward and backward, MFCC
and LFCC, the layer pipelines and ``MelFrontendClassifier`` with
``loss_fn`` and ``train_step``) and the inverse path (ISTFT, Griffin-Lim
with its fused kernels, mel and bark inversion, ``mel_to_audio``, the
phase vocoder, resampling, pitch shift, μ-law, bark filterbanks), the
corpus path (``parallel``: streamed chunked STFT and the batch preprocessor
with the fused kernel, on one GPU), the ops with no recurrence of their
own (masking, deltas and emphasis, spectral descriptors, chroma, CQT,
pitch detection, effects, convolution, DSP synthesis, metrics,
beamforming) and the torchaudio-named transforms over them
(``models.transforms``).
Module names follow the JAX package's; the flat names below mirror its
``__init__`` for the symbols ported so far.

This package imports torch and NumPy only — never JAX, and never the JAX
package.
"""

__version__ = "0.1.0"

from . import ops, models, utils, benchmarks, parallel

from .ops import (
    stft, istft, frame_signal, num_frames, stft_output_length,
    complex_norm, angle, magphase,
    hertz_to_mel, mel_to_hertz, hertz_to_bark, bark_to_hertz,
    create_mel_filter, create_linear_filter, create_bark_filter,
    melscale_fbanks, linear_fbanks, barkscale_fbanks, apply_filterbank,
    amplitude_to_db, db_to_amplitude,
    amplitude_to_DB, DB_to_amplitude,
    fused_melspectrogram, fused_mel_supported, resolve_precision,
    create_dct, mfcc, lfcc,
    spectrogram, melspectrogram, inverse_spectrogram,
    mu_law_encoding, mu_law_decoding,
    phase_vocoder, compute_phase_advance,
    griffin_lim, griffinlim,
    create_inverse_mel_filter, create_inverse_bark_filter,
    mel_to_linear, mel_to_audio,
    resample, pitch_shift,
    hann_window, hamming_window, blackman_window, get_window,
)
from .models import (
    Transform, Pipeline,
    STFT, ISTFT, InverseSpectrogram, ComplexNorm,
    Filterbank, MelFilterbank, BarkFilterbank, ApplyFilterbank,
    AmplitudeToDb, DbToAmplitude,
    MuLawEncoding, MuLawDecoding,
    Resample, StretchSpecTime, GriffinLim,
    Spectrogram, Melspectrogram, Barkspectrogram, FusedMelspectrogram,
    MelFrontendClassifier,
)

__all__ = [
    "ops", "models", "utils", "benchmarks", "parallel",
    "stft", "istft", "frame_signal", "num_frames", "stft_output_length",
    "complex_norm", "angle", "magphase",
    "hertz_to_mel", "mel_to_hertz", "hertz_to_bark", "bark_to_hertz",
    "create_mel_filter", "create_linear_filter", "create_bark_filter",
    "melscale_fbanks", "linear_fbanks", "barkscale_fbanks",
    "apply_filterbank",
    "amplitude_to_db", "db_to_amplitude",
    "amplitude_to_DB", "DB_to_amplitude",
    "fused_melspectrogram", "fused_mel_supported", "resolve_precision",
    "create_dct", "mfcc", "lfcc",
    "spectrogram", "melspectrogram", "inverse_spectrogram",
    "mu_law_encoding", "mu_law_decoding",
    "phase_vocoder", "compute_phase_advance",
    "griffin_lim", "griffinlim",
    "create_inverse_mel_filter", "create_inverse_bark_filter",
    "mel_to_linear", "mel_to_audio",
    "resample", "pitch_shift",
    "hann_window", "hamming_window", "blackman_window", "get_window",
    "Transform", "Pipeline",
    "STFT", "ISTFT", "InverseSpectrogram", "ComplexNorm",
    "Filterbank", "MelFilterbank", "BarkFilterbank", "ApplyFilterbank",
    "AmplitudeToDb", "DbToAmplitude",
    "MuLawEncoding", "MuLawDecoding",
    "Resample", "StretchSpecTime", "GriffinLim",
    "Spectrogram", "Melspectrogram", "Barkspectrogram",
    "FusedMelspectrogram",
    "MelFrontendClassifier",
]
