"""Layer API and models of the PyTorch port (the mel front end's and the
inverse path's slices, the torchaudio-named transforms over the ported
ops, the classic ASR models Wav2Letter and DeepSpeech, the host
lexicon + LM CTC decoder, the streaming transducer family: Emformer
and Conformer encoders, the RNN-T model, its greedy and beam decoders and
their factories; and the wav2vec2 family: Wav2Vec2/WavLM and their
factories, HuBERT pretraining, the Conformer and Emformer SSL variants;
and the TTS family: Tacotron2, the WaveRNN and HiFi-GAN vocoders; and
the separation, assessment and embedding models: ConvTasNet, HDemucs in
the JAX package's build and torchaudio's, the Squim models and VGGish)."""
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
from .rnnt import (RNNTPredictor, LayerNormLSTMPredictor, RNNT, RNNTBeamSearch,
                   RNNTStreamPool)
from .factories import (emformer_rnnt_model, emformer_rnnt_base,
                        conformer_rnnt_model, conformer_rnnt_base,
                        wav2vec2_model, hubert_pretrain_base,
                        hubert_pretrain_large, hubert_pretrain_xlarge,
                        hifigan_vocoder, conv_tasnet_base, hdemucs_low,
                        hdemucs_medium, hdemucs_high, squim_objective_base,
                        squim_subjective_base)
from .tasnet import ConvTasNet
from .hdemucs import HDemucs
from .hdemucs_ta import HDemucsTA
from .squim import SquimObjective, SquimObjectiveTA, SquimSubjective
from .vggish import VGGish, VGGishInputProcessor
from .tacotron2 import Tacotron2
from .wavernn import WaveRNN
from .hifigan import (HiFiGANVocoder, hifigan_vocoder_v1, hifigan_vocoder_v2,
                      hifigan_vocoder_v3)
from .wav2vec2 import (
    Wav2Vec2, Wav2Vec2Model, WavLM, wavlm_buckets,
    wav2vec2_base, wav2vec2_large, wav2vec2_large_lv60k,
    hubert_base, hubert_large, hubert_xlarge, wavlm_base, wavlm_large,
    wav2vec2_xlsr_300m, wav2vec2_xlsr_1b, wav2vec2_xlsr_2b,
)
from .hubert import HuBERTPretrainModel, span_mask
from .conformer_w2v2 import (
    ConformerWav2Vec2, conformer_wav2vec2_model, conformer_wav2vec2_base,
    ConformerWav2Vec2PretrainModel, conformer_wav2vec2_pretrain_model,
    conformer_wav2vec2_pretrain_base, conformer_wav2vec2_pretrain_large,
)
from .emformer_hubert import (EmformerHuBERT, emformer_hubert_model,
                              emformer_hubert_base)
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
    "RNNTStreamPool",
    "emformer_rnnt_model", "emformer_rnnt_base",
    "conformer_rnnt_model", "conformer_rnnt_base",
    "Wav2Vec2", "Wav2Vec2Model", "WavLM", "wavlm_buckets",
    "wav2vec2_base", "wav2vec2_large", "wav2vec2_large_lv60k",
    "hubert_base", "hubert_large", "hubert_xlarge", "wavlm_base",
    "wavlm_large", "wav2vec2_xlsr_300m", "wav2vec2_xlsr_1b",
    "wav2vec2_xlsr_2b", "wav2vec2_model", "HuBERTPretrainModel",
    "span_mask", "hubert_pretrain_base", "hubert_pretrain_large",
    "hubert_pretrain_xlarge",
    "ConformerWav2Vec2", "conformer_wav2vec2_model",
    "conformer_wav2vec2_base", "ConformerWav2Vec2PretrainModel",
    "conformer_wav2vec2_pretrain_model", "conformer_wav2vec2_pretrain_base",
    "conformer_wav2vec2_pretrain_large",
    "EmformerHuBERT", "emformer_hubert_model", "emformer_hubert_base",
    "Tacotron2", "WaveRNN", "HiFiGANVocoder", "hifigan_vocoder",
    "hifigan_vocoder_v1", "hifigan_vocoder_v2", "hifigan_vocoder_v3",
    "ConvTasNet", "HDemucs", "HDemucsTA", "SquimObjective",
    "SquimObjectiveTA", "SquimSubjective", "VGGish", "VGGishInputProcessor",
    "conv_tasnet_base", "hdemucs_low", "hdemucs_medium", "hdemucs_high",
    "squim_objective_base", "squim_subjective_base",
    "CTCDecoderLM", "ZeroLM", "ARPALM",
    "CTCDecoder", "CTCDecoderOutput", "ctc_decoder",
    "transforms",
] + list(transforms.__all__)
