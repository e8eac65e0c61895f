"""Layer API and models of the PyTorch port (the mel front end's and the
inverse path's slices, the torchaudio-named transforms over the ported
ops, the classic ASR models Wav2Letter and DeepSpeech, and the host
lexicon + LM CTC decoder)."""
from .layers import (
    Transform, Pipeline,
    STFT, ISTFT, InverseSpectrogram, ComplexNorm,
    Filterbank, MelFilterbank, BarkFilterbank, ChromaFilterbank,
    ApplyFilterbank,
    AmplitudeToDb, DbToAmplitude,
    MuLawEncoding, MuLawDecoding,
    Resample, StretchSpecTime, GriffinLim,
    Spectrogram, Melspectrogram, Barkspectrogram, Chromagram,
    FusedMelspectrogram,
)
from .frontend import MelFrontendClassifier
from .asr import Wav2Letter, DeepSpeech
from .decoder import (
    CTCDecoderLM, ZeroLM, ARPALM,
    CTCDecoder, CTCDecoderOutput, ctc_decoder,
)
from . import transforms
from .transforms import (
    MFCC, PitchShift, Speed, AddNoise, Fade, Vol, FrequencyMasking,
    TimeMasking, Preemphasis, Deemphasis, ComputeDeltas, SlidingWindowCmn,
    SpectralCentroid, MelScale, InverseMelScale, PSD, SoudenMVDR, RTFMVDR,
    LFCC, Convolve, FFTConvolve, SpeedPerturbation, AmplitudeToDB,
    MelSpectrogram, TimeStretch, SpecAugment, MVDR, BarkScale,
    InverseBarkScale, BarkSpectrogram, ChromaScale, ChromaSpectrogram,
    Loudness, Vad, Overdrive, Phaser, Flanger, Contrast, Lowpass, Highpass,
    Equalizer, RNNTLoss,
)

__all__ = [
    "Transform", "Pipeline",
    "STFT", "ISTFT", "InverseSpectrogram", "ComplexNorm",
    "Filterbank", "MelFilterbank", "BarkFilterbank", "ChromaFilterbank",
    "ApplyFilterbank",
    "AmplitudeToDb", "DbToAmplitude",
    "MuLawEncoding", "MuLawDecoding",
    "Resample", "StretchSpecTime", "GriffinLim",
    "Spectrogram", "Melspectrogram", "Barkspectrogram", "Chromagram",
    "FusedMelspectrogram",
    "MelFrontendClassifier", "Wav2Letter", "DeepSpeech",
    "CTCDecoderLM", "ZeroLM", "ARPALM",
    "CTCDecoder", "CTCDecoderOutput", "ctc_decoder",
    "transforms",
] + list(transforms.__all__)
