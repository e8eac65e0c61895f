"""Layer API and models of the PyTorch port (the mel front end's and the
inverse path's slices, the torchaudio-named transforms over the ported
ops, the classic ASR models Wav2Letter and DeepSpeech, the host
lexicon + LM CTC decoder, and the streaming transducer family: Emformer
and Conformer encoders, the RNN-T model, its greedy and beam decoders and
their factories)."""
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
from .emformer import Emformer, ConvEmformer, EmformerTranscriber
from .conformer import Conformer, ConformerTranscriber
from .rnnt import RNNTPredictor, LayerNormLSTMPredictor, RNNT, RNNTBeamSearch
from .factories import (emformer_rnnt_model, emformer_rnnt_base,
                        conformer_rnnt_model, conformer_rnnt_base)
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
    "Emformer", "ConvEmformer", "EmformerTranscriber",
    "Conformer", "ConformerTranscriber",
    "RNNTPredictor", "LayerNormLSTMPredictor", "RNNT", "RNNTBeamSearch",
    "emformer_rnnt_model", "emformer_rnnt_base",
    "conformer_rnnt_model", "conformer_rnnt_base",
    "CTCDecoderLM", "ZeroLM", "ARPALM",
    "CTCDecoder", "CTCDecoderOutput", "ctc_decoder",
    "transforms",
] + list(transforms.__all__)
