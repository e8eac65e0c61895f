"""Functional core of the PyTorch port (the mel front end's slices and
the inverse path: ISTFT, Griffin-Lim, mel inversion, the vocoder ops).

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
    hertz_to_bark,
    bark_to_hertz,
    create_mel_filter,
    create_linear_filter,
    create_bark_filter,
    melscale_fbanks,
    linear_fbanks,
    barkscale_fbanks,
    apply_filterbank,
)
from .complexops import complex_norm, angle, magphase
from .db import (amplitude_to_db, db_to_amplitude,
                 amplitude_to_DB, DB_to_amplitude)
from .stft import stft, istft, frame_signal, num_frames, stft_output_length
from .spectro import spectrogram, melspectrogram, inverse_spectrogram
from .fused import (fused_melspectrogram, fused_mel_supported,
                    resolve_precision)
from .mfcc import create_dct, mfcc, lfcc
from .mulaw import mu_law_encoding, mu_law_decoding
from .phase_vocoder import phase_vocoder, compute_phase_advance
from .griffinlim import griffin_lim
from .fused_griffinlim import fused_gl_supported
from .melinv import (create_inverse_mel_filter, create_inverse_bark_filter,
                     mel_to_linear, mel_to_audio)
from .resample import resample
from .pitch import pitch_shift

griffinlim = griffin_lim

__all__ = [
    "hann_window", "hamming_window", "blackman_window",
    "bartlett_window", "kaiser_window", "nuttall_window",
    "rectangular_window", "get_window", "cola_window_sum", "check_nola",
    "hertz_to_mel", "mel_to_hertz", "hertz_to_bark", "bark_to_hertz",
    "create_mel_filter", "create_linear_filter", "create_bark_filter",
    "melscale_fbanks", "linear_fbanks", "barkscale_fbanks",
    "apply_filterbank",
    "complex_norm", "angle", "magphase",
    "amplitude_to_db", "db_to_amplitude",
    "amplitude_to_DB", "DB_to_amplitude",
    "stft", "istft", "frame_signal", "num_frames", "stft_output_length",
    "spectrogram", "melspectrogram", "inverse_spectrogram",
    "fused_melspectrogram", "fused_mel_supported", "resolve_precision",
    "create_dct", "mfcc", "lfcc",
    "mu_law_encoding", "mu_law_decoding",
    "phase_vocoder", "compute_phase_advance",
    "griffin_lim", "griffinlim", "fused_gl_supported",
    "create_inverse_mel_filter", "create_inverse_bark_filter",
    "mel_to_linear", "mel_to_audio",
    "resample", "pitch_shift",
]
