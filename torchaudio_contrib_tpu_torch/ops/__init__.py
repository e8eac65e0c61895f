"""Functional core of the PyTorch port (the mel front end's slices).

Module names follow ``torchaudio_contrib_tpu.ops``; each module is the
counterpart of the JAX module of the same name.
"""
from .windows import (
    hann_window,
    hamming_window,
    blackman_window,
    bartlett_window,
    kaiser_window,
    nuttall_window,
    rectangular_window,
    get_window,
    cola_window_sum,
    check_nola,
)
from .filters import (
    hertz_to_mel,
    mel_to_hertz,
    create_mel_filter,
    create_linear_filter,
    apply_filterbank,
)
from .complexops import complex_norm, angle, magphase
from .db import (amplitude_to_db, db_to_amplitude,
                 amplitude_to_DB, DB_to_amplitude)
from .stft import stft, frame_signal, num_frames
from .spectro import spectrogram, melspectrogram
from .fused import (fused_melspectrogram, fused_mel_supported,
                    resolve_precision)
from .mfcc import create_dct, mfcc, lfcc

__all__ = [
    "hann_window", "hamming_window", "blackman_window",
    "bartlett_window", "kaiser_window", "nuttall_window",
    "rectangular_window", "get_window", "cola_window_sum", "check_nola",
    "hertz_to_mel", "mel_to_hertz", "create_mel_filter",
    "create_linear_filter", "apply_filterbank",
    "complex_norm", "angle", "magphase",
    "amplitude_to_db", "db_to_amplitude",
    "amplitude_to_DB", "DB_to_amplitude",
    "stft", "frame_signal", "num_frames",
    "spectrogram", "melspectrogram",
    "fused_melspectrogram", "fused_mel_supported", "resolve_precision",
    "create_dct", "mfcc", "lfcc",
]
