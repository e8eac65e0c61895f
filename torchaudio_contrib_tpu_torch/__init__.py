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
beamforming), the IIR family (``lfilter`` and the biquads as log-depth
doubling scans, BS.1770 loudness, VAD, the SoX modulation effects, Kaldi
pitch), room acoustics (image-source responses, ray tracing), the Kaldi
feature extractors (``compliance.kaldi``), the torchaudio-named
transforms over them (``models.transforms``), and the ASR training and
decoding path: the CTC and RNN-T losses (``RNNTLoss``), forced alignment,
edit distance, greedy, beam and lexicon + n-gram LM CTC decoding (host
and device searches) and the Wav2Letter and DeepSpeech models, fed by the
fused front end; the streaming transducer family (Emformer and
Conformer encoders, the RNN-T model with its greedy and beam decoders, their
factories and the Emformer-RNNT bundles in ``pipelines``); and the wav2vec2
family (Wav2Vec2 and WavLM encoders with their factories, HuBERT
pretraining, the Conformer and Emformer SSL variants, the wav2vec2 ASR and
forced-alignment bundles, and ``utils.save_params``/``load_params`` in the
JAX package's file format); and the TTS family (Tacotron2, the WaveRNN and
HiFi-GAN vocoders, the Tacotron2 + WaveRNN / Griffin-Lim and HiFi-GAN
bundles in ``pipelines``, and ``datasets.CMUDict`` for the phone bundles).
Module names follow the JAX package's; the flat names below are those of
its ``__init__`` that are ported so far.

This package imports torch and NumPy only — never JAX, and never the JAX
package.
"""

__version__ = "0.1.0"

from . import (ops, models, utils, benchmarks, parallel, compliance,
               datasets, pipelines)

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
    lfilter, filtfilt, biquad, lowpass_biquad, highpass_biquad,
    bandpass_biquad, bandreject_biquad, allpass_biquad,
    equalizer_biquad, bass_biquad, treble_biquad,
    band_biquad, deemph_biquad, riaa_biquad,
    loudness, a_weighting,
    compute_kaldi_pitch,
    overdrive, contrast, phaser, flanger,
    vad, vad_onset, vad_trim,
    simulate_rir_ism, ray_tracing,
    chroma_filterbank, mask_along_axis, mask_along_axis_iid, time_mask,
    freq_mask, compute_deltas, preemphasis, deemphasis, spectral_centroid,
    spectral_bandwidth, spectral_rolloff, spectral_flatness,
    zero_crossing_rate, create_chroma_filter, cqt_frequencies,
    create_cqt_kernel, cqt, pseudo_cqt, detect_pitch_frequency, fade, gain,
    dither, dcshift, sliding_window_cmn, add_noise, speed, apply_codec,
    convolve, fftconvolve, oscillator_bank, adsr_envelope, extend_pitch,
    sinc_impulse_response, frequency_impulse_response, filter_waveform,
    exp_sigmoid, forced_align, merge_tokens, TokenSpan, edit_distance,
    edit_distance_batched, rnnt_loss, rnnt_loss_fused, ctc_greedy_decode,
    ctc_prefix_beam_search, ctc_beam_decode, CTCHypothesis, ctc_loss, snr,
    si_snr, frechet_distance, psd, mvdr_weights_souden, mvdr_weights_rtf,
    rtf_evd, rtf_power, apply_beamforming, ctc_lexicon_beam_decode,
    device_ctc_decoder, DeviceCTCDecoder,
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
    AmplitudeToDB, MelSpectrogram, TimeStretch, SpecAugment, MVDR,
    BarkScale, InverseBarkScale, BarkSpectrogram, ChromaScale,
    ChromaSpectrogram, ChromaFilterbank, Chromagram, Wav2Letter, DeepSpeech,
    CTCDecoderLM, ZeroLM, ARPALM, CTCDecoder, CTCDecoderOutput, ctc_decoder,
    Emformer, ConvEmformer, Conformer, RNNT, RNNTPredictor, RNNTBeamSearch,
    Wav2Vec2, Wav2Vec2Model, WavLM, wav2vec2_model, wav2vec2_base,
    wav2vec2_large, wav2vec2_large_lv60k, hubert_base, hubert_large,
    hubert_xlarge, wavlm_base, wavlm_large, wav2vec2_xlsr_300m,
    wav2vec2_xlsr_1b, wav2vec2_xlsr_2b, HuBERTPretrainModel, span_mask,
    hubert_pretrain_base, hubert_pretrain_large, hubert_pretrain_xlarge,
    ConformerWav2Vec2, conformer_wav2vec2_model, conformer_wav2vec2_base,
    ConformerWav2Vec2PretrainModel, conformer_wav2vec2_pretrain_model,
    conformer_wav2vec2_pretrain_base, conformer_wav2vec2_pretrain_large,
    EmformerHuBERT, emformer_hubert_model, emformer_hubert_base,
    Tacotron2, WaveRNN, HiFiGANVocoder, hifigan_vocoder_v1,
    hifigan_vocoder_v2, hifigan_vocoder_v3,
    MFCC, Loudness, PitchShift, Speed, AddNoise, Fade, Vol,
    FrequencyMasking, TimeMasking, Preemphasis, Deemphasis, ComputeDeltas,
    SlidingWindowCmn, SpectralCentroid, MelScale, InverseMelScale, PSD,
    SoudenMVDR, RTFMVDR, Vad, Overdrive, Phaser, Flanger, Contrast, Lowpass,
    Highpass, Equalizer, RNNTLoss, LFCC, Convolve, FFTConvolve,
    SpeedPerturbation,
)

__all__ = [
    "ops", "models", "utils", "benchmarks", "parallel", "compliance",
    "datasets", "pipelines",
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
    "lfilter", "filtfilt", "biquad", "lowpass_biquad", "highpass_biquad",
    "bandpass_biquad", "bandreject_biquad", "allpass_biquad",
    "equalizer_biquad", "bass_biquad", "treble_biquad",
    "band_biquad", "deemph_biquad", "riaa_biquad",
    "loudness", "a_weighting",
    "compute_kaldi_pitch",
    "overdrive", "contrast", "phaser", "flanger",
    "vad", "vad_onset", "vad_trim",
    "simulate_rir_ism", "ray_tracing",
    "Transform", "Pipeline",
    "STFT", "ISTFT", "InverseSpectrogram", "ComplexNorm",
    "Filterbank", "MelFilterbank", "BarkFilterbank", "ApplyFilterbank",
    "AmplitudeToDb", "DbToAmplitude",
    "MuLawEncoding", "MuLawDecoding",
    "Resample", "StretchSpecTime", "GriffinLim",
    "Spectrogram", "Melspectrogram", "Barkspectrogram",
    "FusedMelspectrogram",
    "MelFrontendClassifier",
    "chroma_filterbank", "mask_along_axis", "mask_along_axis_iid",
    "time_mask", "freq_mask", "compute_deltas", "preemphasis", "deemphasis",
    "spectral_centroid", "spectral_bandwidth", "spectral_rolloff",
    "spectral_flatness", "zero_crossing_rate", "create_chroma_filter",
    "cqt_frequencies", "create_cqt_kernel", "cqt", "pseudo_cqt",
    "detect_pitch_frequency", "fade", "gain", "dither", "dcshift",
    "sliding_window_cmn", "add_noise", "speed", "apply_codec", "convolve",
    "fftconvolve", "oscillator_bank", "adsr_envelope", "extend_pitch",
    "sinc_impulse_response", "frequency_impulse_response",
    "filter_waveform", "exp_sigmoid", "forced_align", "merge_tokens",
    "TokenSpan", "edit_distance", "edit_distance_batched", "rnnt_loss",
    "rnnt_loss_fused", "ctc_greedy_decode", "ctc_prefix_beam_search",
    "ctc_beam_decode", "CTCHypothesis", "ctc_loss", "snr", "si_snr",
    "frechet_distance", "psd", "mvdr_weights_souden", "mvdr_weights_rtf",
    "rtf_evd", "rtf_power", "apply_beamforming", "ctc_lexicon_beam_decode",
    "device_ctc_decoder", "DeviceCTCDecoder",
    "AmplitudeToDB", "MelSpectrogram", "TimeStretch", "SpecAugment", "MVDR",
    "BarkScale", "InverseBarkScale", "BarkSpectrogram", "ChromaScale",
    "ChromaSpectrogram", "ChromaFilterbank", "Chromagram", "Wav2Letter",
    "DeepSpeech", "CTCDecoderLM", "ZeroLM", "ARPALM", "CTCDecoder",
    "CTCDecoderOutput", "ctc_decoder", "Emformer", "ConvEmformer",
    "Conformer", "RNNT", "RNNTPredictor", "RNNTBeamSearch",
    "Wav2Vec2", "Wav2Vec2Model", "WavLM", "wav2vec2_model", "wav2vec2_base",
    "wav2vec2_large", "wav2vec2_large_lv60k", "hubert_base", "hubert_large",
    "hubert_xlarge", "wavlm_base", "wavlm_large", "wav2vec2_xlsr_300m",
    "wav2vec2_xlsr_1b", "wav2vec2_xlsr_2b", "HuBERTPretrainModel",
    "span_mask", "hubert_pretrain_base", "hubert_pretrain_large",
    "hubert_pretrain_xlarge", "ConformerWav2Vec2",
    "conformer_wav2vec2_model", "conformer_wav2vec2_base",
    "ConformerWav2Vec2PretrainModel", "conformer_wav2vec2_pretrain_model",
    "conformer_wav2vec2_pretrain_base", "conformer_wav2vec2_pretrain_large",
    "EmformerHuBERT", "emformer_hubert_model", "emformer_hubert_base",
    "Tacotron2", "WaveRNN", "HiFiGANVocoder", "hifigan_vocoder_v1",
    "hifigan_vocoder_v2", "hifigan_vocoder_v3",
    "MFCC", "Loudness", "PitchShift",
    "Speed", "AddNoise", "Fade", "Vol", "FrequencyMasking", "TimeMasking",
    "Preemphasis", "Deemphasis", "ComputeDeltas", "SlidingWindowCmn",
    "SpectralCentroid", "MelScale", "InverseMelScale", "PSD", "SoudenMVDR",
    "RTFMVDR", "Vad", "Overdrive", "Phaser", "Flanger", "Contrast",
    "Lowpass", "Highpass", "Equalizer", "RNNTLoss", "LFCC", "Convolve",
    "FFTConvolve", "SpeedPerturbation",
]
