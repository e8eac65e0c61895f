"""Functional core of the PyTorch port (the mel front end's slices, the
inverse path: ISTFT, Griffin-Lim, mel inversion, the vocoder ops; the
ops with no recurrence of their own: masking, deltas and emphasis,
spectral descriptors, chroma, CQT, pitch detection, effects, convolution,
DSP synthesis, metrics, beamforming; the IIR family: ``lfilter`` and the
biquads, loudness, VAD, the modulation effects, Kaldi pitch; room
acoustics: image-source responses and ray tracing).

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
from .augment import (mask_along_axis, mask_along_axis_iid,
                      time_mask, freq_mask)
from .features import compute_deltas, preemphasis, deemphasis
from .spectral import (spectral_centroid, spectral_bandwidth,
                       spectral_rolloff, spectral_flatness,
                       zero_crossing_rate)
from .chroma import create_chroma_filter, chroma_filterbank
from .cqt import cqt_frequencies, create_cqt_kernel, cqt, pseudo_cqt
from .pitchdetect import detect_pitch_frequency
from .effects import (fade, gain, dither, dcshift, sliding_window_cmn,
                      add_noise, speed, apply_codec)
from .convolve import convolve, fftconvolve
from .dsp import (oscillator_bank, adsr_envelope, extend_pitch,
                  sinc_impulse_response, frequency_impulse_response,
                  filter_waveform, exp_sigmoid)
from .iir import (lfilter, filtfilt, biquad, lowpass_biquad, highpass_biquad,
                  bandpass_biquad, bandreject_biquad, allpass_biquad,
                  equalizer_biquad, bass_biquad, treble_biquad,
                  band_biquad, deemph_biquad, riaa_biquad)
from .loudness import loudness, a_weighting
from .kaldipitch import compute_kaldi_pitch
from .modfx import overdrive, contrast, phaser, flanger
from .vad import vad, vad_onset, vad_trim
from .rir import simulate_rir_ism
from .raytrace import ray_tracing
from .metrics import snr, si_snr, frechet_distance
from .beamform import (psd, mvdr_weights_souden, mvdr_weights_rtf,
                       rtf_evd, rtf_power, apply_beamforming)

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
    "mask_along_axis", "mask_along_axis_iid", "time_mask", "freq_mask",
    "compute_deltas", "preemphasis", "deemphasis",
    "spectral_centroid", "spectral_bandwidth", "spectral_rolloff",
    "spectral_flatness", "zero_crossing_rate",
    "create_chroma_filter", "chroma_filterbank",
    "cqt_frequencies", "create_cqt_kernel", "cqt", "pseudo_cqt",
    "detect_pitch_frequency",
    "fade", "gain", "dither", "dcshift", "sliding_window_cmn",
    "add_noise", "speed", "apply_codec",
    "lfilter", "filtfilt", "biquad", "lowpass_biquad", "highpass_biquad",
    "bandpass_biquad", "bandreject_biquad", "allpass_biquad",
    "equalizer_biquad", "bass_biquad", "treble_biquad",
    "band_biquad", "deemph_biquad", "riaa_biquad",
    "loudness", "a_weighting", "compute_kaldi_pitch",
    "overdrive", "contrast", "phaser", "flanger",
    "vad", "vad_onset", "vad_trim",
    "convolve", "fftconvolve", "simulate_rir_ism", "ray_tracing",
    "oscillator_bank", "adsr_envelope", "extend_pitch",
    "sinc_impulse_response", "frequency_impulse_response",
    "filter_waveform", "exp_sigmoid",
    "snr", "si_snr", "frechet_distance",
    "psd", "mvdr_weights_souden", "mvdr_weights_rtf", "rtf_evd",
    "rtf_power", "apply_beamforming",
]
