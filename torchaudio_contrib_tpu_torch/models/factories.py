"""Named factories of the transducer and wav2vec2 families.

Port of the four transducer factories of
``torchaudio_contrib_tpu/models/factories.py`` (``emformer_rnnt_model``,
``emformer_rnnt_base``, ``conformer_rnnt_model``,
``conformer_rnnt_base``), ``wav2vec2_model``, the three HuBERT
pretraining factories (``hubert_pretrain_base|large|xlarge``),
``hifigan_vocoder``, ``conv_tasnet_base``, ``hdemucs_low|medium|high``
(``compat="torchaudio"`` for :class:`HDemucsTA`), ``squim_objective_base``
and ``squim_subjective_base``: every factory of the JAX package.  Each takes ``device=`` (the card unless the caller asks
for the CPU) and ``generator=`` for the initial weights, and builds on
the CPU before it moves the model.
"""
from __future__ import annotations

from typing import Optional

import torch

from .conformer import ConformerTranscriber
from .hdemucs import HDemucs
from .hdemucs_ta import HDemucsTA
from .hifigan import HiFiGANVocoder
from .emformer import Emformer, EmformerTranscriber
from .hubert import HuBERTPretrainModel
from .rnnt import RNNT, LayerNormLSTMPredictor
from .squim import SquimObjective, SquimObjectiveTA, SquimSubjective
from .tasnet import ConvTasNet
from .wav2vec2 import Wav2Vec2, hubert_base, hubert_large, hubert_xlarge

__all__ = ["emformer_rnnt_model", "emformer_rnnt_base",
           "conformer_rnnt_model", "conformer_rnnt_base",
           "wav2vec2_model", "hubert_pretrain_base", "hubert_pretrain_large",
           "hubert_pretrain_xlarge", "hifigan_vocoder", "conv_tasnet_base",
           "hdemucs_low", "hdemucs_medium", "hdemucs_high",
           "squim_objective_base", "squim_subjective_base"]


def emformer_rnnt_model(*, input_dim: int, encoding_dim: int = 0,
                        num_symbols: int,
                        segment_length: int,
                        right_context_length: int,
                        left_context_length: int = 30,
                        num_heads: int = 8, ffn_dim: int = 2048,
                        num_layers: int = 20,
                        max_memory_size: int = 4,
                        predictor_embed_dim: int = 512,
                        predictor_hidden_dim: int = 512,
                        predictor_layers: int = 2,
                        joiner_dim: int = 1024,
                        time_reduction_input_dim: int = 0,
                        time_reduction_stride: int = 1,
                        transformer_activation: str = "gelu",
                        lstm_layer_norm: bool = False,
                        lstm_layer_norm_epsilon: float = 1e-5,
                        device="cuda",
                        generator: Optional[torch.Generator] = None
                        ) -> RNNT:
    """Emformer-transcriber RNN-T, in two builds.

    * ``time_reduction_stride == 1``: the JAX package's own stack — the
      Emformer reads ``input_dim`` features and emits ``input_dim``-wide
      encodings (``encoding_dim`` must equal it or be 0), a plain LSTM
      predictor and an ``enc_proj`` to ``joiner_dim``.
    * ``time_reduction_stride > 1``: torchaudio's ``emformer_rnnt_base``
      layout — :class:`EmformerTranscriber` emitting
      ``encoding_dim``-wide encodings, the layer-norm LSTM predictor, a
      ReLU joiner and no ``enc_proj``, so a torchaudio ``state_dict``
      loads as it is; ``segment_length`` and ``right_context_length`` are
      in input (pre-reduction) frames.
    """
    if time_reduction_stride > 1:
        if not (encoding_dim and time_reduction_input_dim):
            raise ValueError(
                "the torchaudio-compatible build needs encoding_dim "
                "and time_reduction_input_dim")
        enc = EmformerTranscriber(
            input_dim=input_dim, output_dim=encoding_dim,
            segment_length=segment_length,
            right_context_length=right_context_length,
            time_reduction_input_dim=time_reduction_input_dim,
            time_reduction_stride=time_reduction_stride,
            num_heads=num_heads, ffn_dim=ffn_dim, num_layers=num_layers,
            left_context_length=left_context_length,
            max_memory_size=max_memory_size,
            activation=transformer_activation, tanh_on_mem=True,
            device="cpu", generator=generator)
        predictor = LayerNormLSTMPredictor(
            num_symbols, predictor_embed_dim, predictor_hidden_dim,
            encoding_dim, num_layers=predictor_layers,
            layer_norm=lstm_layer_norm,
            layer_norm_eps=lstm_layer_norm_epsilon, device="cpu",
            generator=generator)
        return RNNT(enc, num_symbols=num_symbols, encoding_dim=encoding_dim,
                    joiner_activation="relu", predictor=predictor,
                    enc_proj=False, device=device, generator=generator)
    if encoding_dim and encoding_dim != input_dim:
        raise ValueError(
            "this Emformer emits input_dim-wide encodings; pass "
            "encoding_dim=input_dim (or 0) — a projection layer is "
            "only part of the time_reduction_stride>1 build")
    enc = Emformer(input_dim, num_heads, ffn_dim, num_layers, segment_length,
                   left_context_length=left_context_length,
                   right_context_length=right_context_length,
                   max_memory_size=max_memory_size, tanh_on_mem=True,
                   device="cpu", generator=generator)
    return RNNT(enc, num_symbols=num_symbols, encoding_dim=input_dim,
                joiner_dim=joiner_dim,
                predictor_embed_dim=predictor_embed_dim,
                predictor_hidden_dim=predictor_hidden_dim,
                predictor_layers=predictor_layers, device=device,
                generator=generator)


def emformer_rnnt_base(num_symbols: int = 4097,
                       compat: Optional[str] = None, *, device="cuda",
                       generator: Optional[torch.Generator] = None) -> RNNT:
    """The LibriSpeech-scale streaming configuration (80 log-mels,
    segment 16, right context 4, 20 Emformer layers).
    ``compat="torchaudio"`` is the published layout (input linear 80 →
    128, stride-4 time reduction, 512-wide compat Emformer, 1024-wide
    encodings, a 3-layer layer-norm LSTM predictor with eps 1e-3)."""
    if compat == "torchaudio":
        return emformer_rnnt_model(
            input_dim=80, encoding_dim=1024, num_symbols=num_symbols,
            segment_length=16, right_context_length=4,
            left_context_length=30, num_heads=8, ffn_dim=2048,
            num_layers=20, max_memory_size=0,
            predictor_embed_dim=512, predictor_hidden_dim=512,
            predictor_layers=3, time_reduction_input_dim=128,
            time_reduction_stride=4, transformer_activation="gelu",
            lstm_layer_norm=True, lstm_layer_norm_epsilon=1e-3,
            device=device, generator=generator)
    return emformer_rnnt_model(
        input_dim=80, num_symbols=num_symbols, segment_length=16,
        right_context_length=4, device=device, generator=generator)


def conformer_rnnt_model(*, input_dim: int, encoding_dim: int,
                         time_reduction_stride: int,
                         conformer_input_dim: int,
                         conformer_ffn_dim: int,
                         conformer_num_layers: int,
                         conformer_num_heads: int,
                         conformer_depthwise_conv_kernel_size: int,
                         conformer_dropout: float = 0.0,
                         num_symbols: int,
                         symbol_embedding_dim: int,
                         num_lstm_layers: int,
                         lstm_hidden_dim: int,
                         lstm_layer_norm: bool = True,
                         lstm_layer_norm_epsilon: float = 1e-5,
                         lstm_dropout: float = 0.0,
                         joiner_activation: str = "tanh",
                         device="cuda",
                         generator: Optional[torch.Generator] = None
                         ) -> RNNT:
    """Conformer-transcriber RNN-T (torchaudio's prototype
    ``conformer_rnnt_model`` surface): :class:`ConformerTranscriber` +
    the layer-norm LSTM predictor + an additive joiner, with an
    ``enc_proj`` as in the JAX model.  ``conformer_dropout`` and
    ``lstm_dropout`` act in training mode, as torchaudio's do (the JAX
    package drops them; in eval mode, and at the default 0, the models
    are the same)."""
    enc = ConformerTranscriber(
        input_dim=input_dim, output_dim=encoding_dim,
        time_reduction_stride=time_reduction_stride,
        conformer_input_dim=conformer_input_dim,
        conformer_ffn_dim=conformer_ffn_dim,
        conformer_num_layers=conformer_num_layers,
        conformer_num_heads=conformer_num_heads,
        conformer_depthwise_conv_kernel_size=(
            conformer_depthwise_conv_kernel_size),
        dropout=conformer_dropout, device="cpu", generator=generator)
    predictor = LayerNormLSTMPredictor(
        num_symbols, symbol_embedding_dim, lstm_hidden_dim, encoding_dim,
        num_layers=num_lstm_layers, layer_norm=lstm_layer_norm,
        layer_norm_eps=lstm_layer_norm_epsilon, dropout=lstm_dropout,
        device="cpu", generator=generator)
    return RNNT(enc, num_symbols=num_symbols, encoding_dim=encoding_dim,
                joiner_activation=joiner_activation, predictor=predictor,
                device=device, generator=generator)


def conformer_rnnt_base(num_symbols: int = 1024, *, device="cuda",
                        generator: Optional[torch.Generator] = None
                        ) -> RNNT:
    """The prototype's base configuration: 80 features, stride-4
    reduction, 16 × 256-wide Conformer, 1024-wide encodings, a 2-layer
    512-wide layer-norm LSTM predictor."""
    return conformer_rnnt_model(
        input_dim=80, encoding_dim=1024, time_reduction_stride=4,
        conformer_input_dim=256, conformer_ffn_dim=1024,
        conformer_num_layers=16, conformer_num_heads=4,
        conformer_depthwise_conv_kernel_size=31,
        num_symbols=num_symbols, symbol_embedding_dim=256,
        num_lstm_layers=2, lstm_hidden_dim=512,
        lstm_layer_norm=True, lstm_layer_norm_epsilon=1e-5,
        joiner_activation="tanh", device=device, generator=generator)


def wav2vec2_model(**kwargs) -> Wav2Vec2:
    """Generic constructor (torchaudio's ``wav2vec2_model``): all
    :class:`Wav2Vec2` keywords pass through."""
    return Wav2Vec2(**kwargs)


def hifigan_vocoder(**kwargs) -> HiFiGANVocoder:
    """Generic constructor (torchaudio's ``hifigan_vocoder``): all
    :class:`HiFiGANVocoder` keywords pass through."""
    return HiFiGANVocoder(**kwargs)


def _pretrain(encoder_factory, num_classes: int, device, generator
              ) -> HuBERTPretrainModel:
    return HuBERTPretrainModel(encoder_factory(device="cpu",
                                               generator=generator),
                               num_classes=num_classes, device=device,
                               generator=generator)


def hubert_pretrain_base(num_classes: int = 100, *, device="cuda",
                         generator: Optional[torch.Generator] = None
                         ) -> HuBERTPretrainModel:
    """HuBERT pretraining over the BASE encoder (the first iteration's
    MFCC k-means classes by default)."""
    return _pretrain(hubert_base, num_classes, device, generator)


def hubert_pretrain_large(num_classes: int = 500, *, device="cuda",
                          generator: Optional[torch.Generator] = None
                          ) -> HuBERTPretrainModel:
    return _pretrain(hubert_large, num_classes, device, generator)


def hubert_pretrain_xlarge(num_classes: int = 500, *, device="cuda",
                           generator: Optional[torch.Generator] = None
                           ) -> HuBERTPretrainModel:
    return _pretrain(hubert_xlarge, num_classes, device, generator)


# -- separation and assessment -------------------------------------------------

_SOURCES = ("drums", "bass", "other", "vocals")


def conv_tasnet_base(num_sources: int = 2, *, device="cuda",
                     generator: Optional[torch.Generator] = None
                     ) -> ConvTasNet:
    """The published ConvTasNet base configuration (N=512, L=16, B=128,
    H=512, P=3, X=8, R=3)."""
    return ConvTasNet(num_sources=num_sources, device=device,
                      generator=generator)


def _hdemucs(nfft: int, ta_depth: int, sources, compat, device, generator):
    if compat == "torchaudio":
        return HDemucsTA(sources=sources, nfft=nfft, depth=ta_depth,
                         device=device, generator=generator)
    if compat is not None:
        raise ValueError(f"unknown compat {compat!r}")
    return HDemucs(sources=sources, nfft=nfft, device=device,
                   generator=generator)


def hdemucs_low(sources=_SOURCES, compat: Optional[str] = None, *,
                device="cuda", generator: Optional[torch.Generator] = None):
    """HDemucs for ~8 kHz material (nfft 1024); ``compat="torchaudio"``
    gives the checkpoint-compatible :class:`HDemucsTA` (depth 5)."""
    return _hdemucs(1024, 5, sources, compat, device, generator)


def hdemucs_medium(sources=_SOURCES, compat: Optional[str] = None, *,
                   device="cuda", generator: Optional[torch.Generator] = None):
    """HDemucs for ~16 kHz material (nfft 2048); ``compat="torchaudio"``
    gives :class:`HDemucsTA` (depth 6)."""
    return _hdemucs(2048, 6, sources, compat, device, generator)


def hdemucs_high(sources=_SOURCES, compat: Optional[str] = None, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
    """HDemucs for 44.1/48 kHz material (nfft 4096); ``compat="torchaudio"``
    gives :class:`HDemucsTA` (depth 6), the ``HDEMUCS_HIGH_MUSDB*``
    layout."""
    return _hdemucs(4096, 6, sources, compat, device, generator)


def squim_objective_base(compat: Optional[str] = None, *, device="cuda",
                         generator: Optional[torch.Generator] = None):
    """``compat="torchaudio"`` gives torchaudio's weight-compatible layout
    (:class:`SquimObjectiveTA`, the ``SQUIM_OBJECTIVE`` bundle's)."""
    if compat == "torchaudio":
        return SquimObjectiveTA(device=device, generator=generator)
    if compat is not None:
        raise ValueError(f"unknown compat {compat!r}")
    return SquimObjective(device=device, generator=generator)


def squim_subjective_base(*, device="cuda",
                          generator: Optional[torch.Generator] = None
                          ) -> SquimSubjective:
    return SquimSubjective(device=device, generator=generator)
