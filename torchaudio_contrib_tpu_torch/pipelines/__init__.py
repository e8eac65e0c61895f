"""Pipeline bundles: a model, its feature extractor and its decoder.

Port of the transducer and wav2vec2 parts of
``torchaudio_contrib_tpu/pipelines``: :class:`RNNTBundle` and the three
``EMFORMER_RNNT_BASE_*``; :class:`Wav2Vec2Bundle`,
:class:`Wav2Vec2ASRBundle` and their 24 constants (``WAV2VEC2_*``,
``HUBERT_*``, ``WAVLM_*``); :class:`Wav2Vec2FABundle` and ``MMS_FA``; the
TTS bundles (:class:`Tacotron2TTSBundle`, :class:`HiFiGANVocoderBundle`,
:class:`Tacotron2GriffinLimBundle` and their five constants); the
separation, assessment and embedding bundles
(:class:`SourceSeparationBundle` with ``HDEMUCS_HIGH_MUSDB``,
``HDEMUCS_HIGH_MUSDB_PLUS`` and ``CONVTASNET_BASE_LIBRI2MIX``;
:class:`SquimBundle` with ``SQUIM_OBJECTIVE`` and ``SQUIM_SUBJECTIVE``;
:class:`VGGishBundle` with ``VGGISH``).

No pretrained weights can be fetched.  ``get_model`` builds the
architecture on ``device`` (the card unless the caller asks for the CPU)
with weights from a ``torch.Generator``, or loads ``torch_checkpoint`` (a
``state_dict`` or a path to one: torchaudio's layout for the RNN-T, the separation and assessment models, HF's for the
wav2vec2 family, ``torchvggish``'s for VGGish) or ``checkpoint`` (a file of the JAX package's
``utils.checkpoint.save_params``, read by the port's ``load_params`` and
carried over by ``utils.convert``), and raises with none of them.  It
returns the module (the JAX package's returns ``(model, params)``); the TTS
bundles' ``get_tacotron2``/``get_vocoder`` take the same arguments.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import models as M
from ..datasets import CMUDict
from ..models import RNNTBeamSearch, RNNTStreamPool, emformer_rnnt_model
from ..models.layers import Melspectrogram
from ..ops.align import forced_align, merge_tokens
from ..ops.filters import create_mel_filter
from ..ops.melinv import mel_to_audio
from ..ops.stft import stft
from ..utils.checkpoint import load_params
from ..utils.convert import (conv_tasnet_from_jax_params,
                             conv_tasnet_from_torch_state_dict,
                             hdemucs_from_torch_state_dict,
                             hdemucs_ta_from_jax_params,
                             squim_objective_from_torch_state_dict,
                             squim_objective_ta_from_jax_params,
                             squim_subjective_from_jax_params,
                             vggish_from_jax_params,
                             vggish_from_torch_state_dict,
                             emformer_rnnt_from_jax_params,
                             hifigan_from_jax_params,
                             hifigan_from_torch_state_dict,
                             tacotron2_from_jax_params,
                             wav2vec2_from_jax_params,
                             wav2vec2_from_torch_state_dict,
                             wavernn_from_jax_params)

__all__ = [
    "RNNTBundle", "EMFORMER_RNNT_BASE_LIBRISPEECH",
    "EMFORMER_RNNT_BASE_MUSTC", "EMFORMER_RNNT_BASE_TEDLIUM3",
    "Wav2Vec2Bundle", "Wav2Vec2ASRBundle", "Wav2Vec2FABundle", "MMS_FA",
    "WAV2VEC2_BASE", "WAV2VEC2_LARGE", "HUBERT_BASE", "HUBERT_LARGE",
    "WAVLM_BASE", "WAVLM_LARGE", "WAV2VEC2_XLSR_300M",
    "WAV2VEC2_ASR_BASE_960H", "HUBERT_ASR_LARGE",
    "WAV2VEC2_LARGE_LV60K", "WAV2VEC2_XLSR53", "WAV2VEC2_XLSR_1B",
    "WAV2VEC2_XLSR_2B", "HUBERT_XLARGE", "WAVLM_BASE_PLUS",
    "WAV2VEC2_ASR_BASE_10M", "WAV2VEC2_ASR_BASE_100H",
    "WAV2VEC2_ASR_LARGE_10M", "WAV2VEC2_ASR_LARGE_100H",
    "WAV2VEC2_ASR_LARGE_960H", "WAV2VEC2_ASR_LARGE_LV60K_10M",
    "WAV2VEC2_ASR_LARGE_LV60K_100H", "WAV2VEC2_ASR_LARGE_LV60K_960H",
    "HUBERT_ASR_XLARGE",
    "Tacotron2TTSBundle", "TACOTRON2_WAVERNN_CHAR_LJSPEECH",
    "HiFiGANVocoderBundle", "HIFIGAN_VOCODER_V3_LJSPEECH",
    "Tacotron2GriffinLimBundle", "TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH",
    "TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH", "TACOTRON2_WAVERNN_PHONE_LJSPEECH",
    "SourceSeparationBundle", "HDEMUCS_HIGH_MUSDB", "HDEMUCS_HIGH_MUSDB_PLUS",
    "CONVTASNET_BASE_LIBRI2MIX", "SquimBundle", "SQUIM_OBJECTIVE",
    "SQUIM_SUBJECTIVE", "VGGishBundle", "VGGISH",
]

# torchaudio's wav2vec2 CTC character vocabulary
_ASR_LABELS = ("-", "|", "E", "T", "A", "O", "N", "I", "H", "S", "R",
               "D", "L", "U", "M", "W", "C", "F", "G", "Y", "P", "B",
               "V", "K", "'", "X", "J", "Q", "Z")


def _torch_state_dict(source) -> Mapping:
    """A ``state_dict``, or one loaded from a path (``torch.load`` on the
    CPU, weights only; a ``{"state_dict": …}``/``{"model": …}`` wrapper is
    unwrapped)."""
    if isinstance(source, Mapping):
        return source
    obj = torch.load(source, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, Mapping) and isinstance(obj.get(key), Mapping):
            obj = obj[key]
    if not isinstance(obj, Mapping):
        raise ValueError(f"{source} does not hold a state_dict")
    return obj


def _resolve(build: Callable, generator, checkpoint, torch_checkpoint,
             device, from_jax: Callable, from_torch: Callable) -> nn.Module:
    """``build(device, generator)`` with weights from ``torch_checkpoint``
    (through ``from_torch(state_dict, model)``; ``None`` where the bundle
    reads none), ``checkpoint`` (through ``from_jax(params)``) or
    ``generator``, in that order."""
    if torch_checkpoint is None and checkpoint is None:
        if generator is None:
            raise ValueError(
                "no pretrained weights are downloadable: pass "
                "generator=torch.Generator() for fresh parameters, "
                "torch_checkpoint=<state_dict or path> or "
                "checkpoint=<a save_params file> for trained ones")
        return build(device, generator)
    model = build("cpu", None)
    if torch_checkpoint is not None:
        if from_torch is None:
            raise NotImplementedError(
                "this bundle reads no torch checkpoint (its model is the "
                "JAX package's own design): pass checkpoint=<a save_params "
                "file> or generator=")
        sd = from_torch(_torch_state_dict(torch_checkpoint), model)
    else:
        sd = from_jax(load_params(checkpoint))
    model.load_state_dict(sd)
    return model.to(device)


_RNNT_FFT = 400


class _RNNTFeatureExtractor(nn.Module):
    """``waveform (B, T)`` → ``(B, 1 + T // hop, n_mels)``: the mel
    spectrogram (fft 400) times the int16 gain, through torchaudio's
    piecewise-linear log (``log(x)`` above ``e``, ``x / e`` below)."""

    def __init__(self, n_mels: int, sample_rate: int, hop_length: int):
        super().__init__()
        self.mel = Melspectrogram(num_mels=n_mels, sample_rate=sample_rate,
                                  fft_length=_RNNT_FFT,
                                  hop_length=hop_length)
        self.gain = float(32767 ** 2)    # 10^(0.05 · 2·20·log10(2^15 − 1))

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        m = self.mel(waveform).transpose(-1, -2) * self.gain
        return torch.where(m > math.e, torch.log(m.clamp(min=math.e)),
                           m / math.e)


@dataclass(frozen=True)
class RNNTBundle:
    """Streaming Emformer-RNNT ASR, torchaudio's ``emformer_rnnt_base``
    layout: 80 log-mels at a 10 ms hop → bias-free input linear (80 → 128)
    → stride-4 time reduction → 20 compat Emformer layers (512 wide, 8
    heads, ffn 2048, GELU, left context 30, segment 4 and right context 1
    in reduced frames) → 1024-wide encodings; a 3-layer 512-wide layer-norm
    LSTM predictor (eps 1e-3); a ReLU joiner over ``num_symbols`` targets.

    As in the JAX package, the released global feature normalisation (a
    stats file) is not part of the bundle: normalise the extractor's
    output yourself if your checkpoint expects it."""
    n_mels: int = 80
    num_symbols: int = 4097
    segment_length: int = 16
    right_context_length: int = 4
    time_reduction_stride: int = 4
    sample_rate: int = 16000
    hop_length: int = 160

    def _model(self, device, generator):
        return emformer_rnnt_model(
            input_dim=self.n_mels, encoding_dim=1024,
            num_symbols=self.num_symbols,
            segment_length=self.segment_length,
            right_context_length=self.right_context_length,
            left_context_length=30, num_heads=8, ffn_dim=2048,
            num_layers=20, max_memory_size=0,
            predictor_embed_dim=512, predictor_hidden_dim=512,
            predictor_layers=3, time_reduction_input_dim=128,
            time_reduction_stride=self.time_reduction_stride,
            transformer_activation="gelu", lstm_layer_norm=True,
            lstm_layer_norm_epsilon=1e-3, device=device,
            generator=generator)

    def get_model(self, generator: Optional[torch.Generator] = None,
                  checkpoint=None, torch_checkpoint=None, *,
                  device="cuda"):
        """The model (an ``RNNT`` module) on ``device``: with weights from
        ``generator``, or loaded from ``torch_checkpoint`` (a
        torchaudio-layout ``state_dict`` or a path to one) or
        ``checkpoint`` (the JAX bundle's params saved by ``save_params``;
        their ``enc_proj`` must be the identity that
        ``import_emformer_rnnt`` gives, see
        ``utils.convert.emformer_rnnt_from_jax_params``)."""
        return _resolve(self._model, generator, checkpoint,
                        torch_checkpoint, device,
                        emformer_rnnt_from_jax_params, lambda sd, _: sd)

    def get_feature_extractor(self, *, device="cuda") -> nn.Module:
        """``waveform (B, T)`` → ``(B, 1 + T // 160, 80)`` features for
        ``model.transcribe``/``greedy_decode`` (the transcriber does the
        stride-4 reduction itself; trim the frames to a multiple of 4)."""
        return _RNNTFeatureExtractor(self.n_mels, self.sample_rate,
                                     self.hop_length).to(device)

    def get_decoder(self, model, beam_width: int = 8) -> RNNTBeamSearch:
        return RNNTBeamSearch(model, beam_width=beam_width)

    def get_stream_pool(self, model, slots: int,
                        max_symbols: int = 4) -> RNNTStreamPool:
        """``slots`` concurrent streams of ``model`` (:meth:`get_model`'s)
        advanced a segment a call and decoded greedily, their features by
        this bundle's extractor on the model's device
        (:class:`~..models.RNNTStreamPool`)."""
        device = model.joiner.linear.weight.device
        return RNNTStreamPool(model, self.get_feature_extractor(
            device=device), slots, fft_length=_RNNT_FFT,
            hop_length=self.hop_length, max_symbols=max_symbols)


EMFORMER_RNNT_BASE_LIBRISPEECH = RNNTBundle()
# the same architecture over corpus-specific sentencepiece targets (500
# pieces + blank), as the JAX package pins them
EMFORMER_RNNT_BASE_MUSTC = RNNTBundle(num_symbols=501)
EMFORMER_RNNT_BASE_TEDLIUM3 = RNNTBundle(num_symbols=501)


# -- the wav2vec2 family ---------------------------------------------------

@dataclass(frozen=True)
class Wav2Vec2Bundle:
    """Self-supervised encoder bundle: ``get_model`` gives the factory's
    encoder (features ``(B, T', d_model)``)."""
    _factory: Callable
    sample_rate: int = 16000

    def _build(self, device, generator):
        return self._factory(device=device, generator=generator)

    def get_model(self, generator: Optional[torch.Generator] = None,
                  checkpoint=None, torch_checkpoint=None, *,
                  device="cuda") -> nn.Module:
        """``torch_checkpoint``: an HF-layout ``Wav2Vec2Model``/
        ``HubertModel``/``WavLMModel`` ``state_dict`` or a path to one
        (``utils.convert.wav2vec2_from_torch_state_dict``);
        ``checkpoint``: the JAX encoder's params saved by
        ``save_params``."""
        return _resolve(self._build, generator, checkpoint,
                        torch_checkpoint, device, wav2vec2_from_jax_params,
                        wav2vec2_from_torch_state_dict)


@dataclass(frozen=True)
class Wav2Vec2ASRBundle(Wav2Vec2Bundle):
    """CTC fine-tuned ASR bundle: the encoder + a character head (``aux``,
    ``len(labels)`` wide; an HF checkpoint's ``lm_head``)."""
    labels: Tuple[str, ...] = _ASR_LABELS

    def _build(self, device, generator):
        return self._factory(aux_out=len(self.labels), device=device,
                             generator=generator)

    def get_labels(self) -> Tuple[str, ...]:
        return self.labels

    def decode(self, ids: Sequence[int]) -> str:
        """Collapse a CTC greedy id sequence to text (blank 0, ``|`` the
        word boundary)."""
        out, prev = [], -1
        for i in ids:
            i = int(i)
            if i != prev and i != 0:
                out.append(self.labels[i])
            prev = i
        return "".join(out).replace("|", " ").strip()

    def get_decoder(self, lexicon, lm=None, **kwargs):
        """Lexicon-constrained beam decoder over this bundle's labels
        (``models.ctc_decoder``, on the host); ``lexicon`` maps words to
        spellings in ``self.labels``, ``lm`` is a ``models.CTCDecoderLM``
        (e.g. ``ARPALM``)."""
        return M.ctc_decoder(lexicon, list(self.labels), lm=lm,
                             blank_token=self.labels[0], sil_token="|",
                             **kwargs)


WAV2VEC2_BASE = Wav2Vec2Bundle(M.wav2vec2_base)
WAV2VEC2_LARGE = Wav2Vec2Bundle(M.wav2vec2_large)
HUBERT_BASE = Wav2Vec2Bundle(M.hubert_base)
HUBERT_LARGE = Wav2Vec2Bundle(M.hubert_large)
WAVLM_BASE = Wav2Vec2Bundle(M.wavlm_base)
WAVLM_LARGE = Wav2Vec2Bundle(M.wavlm_large)
WAV2VEC2_XLSR_300M = Wav2Vec2Bundle(M.wav2vec2_xlsr_300m)
WAV2VEC2_ASR_BASE_960H = Wav2Vec2ASRBundle(M.wav2vec2_base)
HUBERT_ASR_LARGE = Wav2Vec2ASRBundle(M.hubert_large)

# a -10M/-100H/-960H/-PLUS suffix is the provenance of published weights,
# not architecture: each variant pins the same architecture, as the JAX
# package's do; XLSR-53 shares the lv60k architecture
WAV2VEC2_LARGE_LV60K = Wav2Vec2Bundle(M.wav2vec2_large_lv60k)
WAV2VEC2_XLSR53 = Wav2Vec2Bundle(M.wav2vec2_large_lv60k)
WAV2VEC2_XLSR_1B = Wav2Vec2Bundle(M.wav2vec2_xlsr_1b)
WAV2VEC2_XLSR_2B = Wav2Vec2Bundle(M.wav2vec2_xlsr_2b)
HUBERT_XLARGE = Wav2Vec2Bundle(M.hubert_xlarge)
WAVLM_BASE_PLUS = Wav2Vec2Bundle(M.wavlm_base)

WAV2VEC2_ASR_BASE_10M = Wav2Vec2ASRBundle(M.wav2vec2_base)
WAV2VEC2_ASR_BASE_100H = Wav2Vec2ASRBundle(M.wav2vec2_base)
WAV2VEC2_ASR_LARGE_10M = Wav2Vec2ASRBundle(M.wav2vec2_large)
WAV2VEC2_ASR_LARGE_100H = Wav2Vec2ASRBundle(M.wav2vec2_large)
WAV2VEC2_ASR_LARGE_960H = Wav2Vec2ASRBundle(M.wav2vec2_large)
WAV2VEC2_ASR_LARGE_LV60K_10M = Wav2Vec2ASRBundle(M.wav2vec2_large_lv60k)
WAV2VEC2_ASR_LARGE_LV60K_100H = Wav2Vec2ASRBundle(M.wav2vec2_large_lv60k)
WAV2VEC2_ASR_LARGE_LV60K_960H = Wav2Vec2ASRBundle(M.wav2vec2_large_lv60k)
HUBERT_ASR_XLARGE = Wav2Vec2ASRBundle(M.hubert_xlarge)


# -- forced alignment ------------------------------------------------------

class _FAEmissionModel(nn.Module):
    """Forced-alignment emissions: the wav2vec2 logits → ``log_softmax``
    (so the spans' scores are log-probabilities), with the star wildcard
    appended as a zero (probability-1) column when ``with_star``."""

    def __init__(self, model: nn.Module, with_star: bool):
        super().__init__()
        self.model = model
        self.with_star = with_star

    def forward(self, waveforms: torch.Tensor, lengths=None, **kwargs):
        out, out_lengths = self.model(waveforms, lengths, **kwargs)
        emission = torch.log_softmax(out, -1)
        if self.with_star:
            emission = torch.cat(
                [emission, emission.new_zeros(emission.shape[:-1] + (1,))],
                -1)
        return emission, out_lengths


class _CTCAligner:
    """``aligner(emission (T, V) log-probs, tokens)`` → a list of
    ``TokenSpan`` (frame-resolution spans): ``forced_align`` on the
    emission's device, ``merge_tokens`` on the host."""

    def __call__(self, emission: torch.Tensor, tokens) -> list:
        if emission.ndim != 2:
            raise ValueError("emission must be (frames, classes)")
        tokens = torch.as_tensor(tokens, device=emission.device) \
            .long().reshape(1, -1)
        labels, scores = forced_align(emission[None], tokens)
        return merge_tokens(labels[0], scores[0])


@dataclass(frozen=True)
class Wav2Vec2FABundle:
    """Multilingual forced-alignment bundle (torchaudio's ``MMS_FA``): a
    wav2vec2 LARGE-lv60k geometry emitting per-frame label posteriors over
    the 28-label romanised vocabulary below (the JAX package's order), and
    the CTC aligner."""

    _labels: Tuple[str, ...] = (
        "-", "a", "i", "e", "n", "o", "u", "t", "s", "r", "m", "k",
        "l", "d", "g", "h", "y", "b", "p", "w", "c", "v", "j", "z",
        "f", "'", "q", "x")
    sample_rate: int = 16000

    def get_labels(self, star: Optional[str] = "*",
                   blank: str = "-") -> Tuple[str, ...]:
        labels = (blank,) + self._labels[1:]
        return labels if star is None else labels + (star,)

    def get_dict(self, star: Optional[str] = "*") -> dict:
        return {c: i for i, c in enumerate(self.get_labels(star))}

    def _build(self, device, generator):
        return M.wav2vec2_large_lv60k(aux_out=len(self._labels),
                                      device=device, generator=generator)

    def get_model(self, with_star: bool = True,
                  generator: Optional[torch.Generator] = None,
                  checkpoint=None, torch_checkpoint=None, *,
                  device="cuda") -> nn.Module:
        """The emission model (``forward(waveforms, lengths=None)`` →
        ``(log-probs (B, T', 28 [+ 1]), out_lengths)``); weights as
        :meth:`Wav2Vec2Bundle.get_model` (a 28-wide head: the star is no
        trained class)."""
        base = _resolve(self._build, generator, checkpoint,
                        torch_checkpoint, device, wav2vec2_from_jax_params,
                        wav2vec2_from_torch_state_dict)
        return _FAEmissionModel(base, with_star)

    def get_aligner(self) -> _CTCAligner:
        return _CTCAligner()


MMS_FA = Wav2Vec2FABundle()


# -- text to speech ----------------------------------------------------------

def _pad_ids(ids: list) -> tuple:
    """Id lists → ``(ids (B, T) int32, lengths (B,) int32)`` NumPy arrays,
    zero-padded (T at least 1)."""
    lengths = np.asarray([len(i) for i in ids], np.int32)
    T = max(1, int(lengths.max()) if len(lengths) else 1)
    out = np.zeros((len(ids), T), np.int32)
    for r, seq in enumerate(ids):
        out[r, :len(seq)] = seq
    return out, lengths


class _CharTextProcessor:
    """Character-level text → ``(ids (B, T), lengths (B,))`` int32 NumPy
    arrays (torchaudio's ``_get_chars`` convention: pad first); characters
    outside the table are dropped."""

    symbols = "_-!'(),.:;? abcdefghijklmnopqrstuvwxyz"

    def __call__(self, texts):
        if isinstance(texts, str):
            # a bare string would iterate as the batch
            texts = [texts]
        return _pad_ids([[self.symbols.index(c) for c in t.lower()
                          if c in self.symbols] for t in texts])


@dataclass(frozen=True)
class Tacotron2TTSBundle:
    """Character Tacotron2 + WaveRNN vocoder (torchaudio's
    ``TACOTRON2_WAVERNN_CHAR_LJSPEECH`` geometry: 80 mels at 22.05 kHz, the
    vocoder's hop 275 as upsample scales (5, 5, 11)).  ``get_tacotron2`` and
    ``get_vocoder`` return their module in eval mode."""
    n_mels: int = 80
    sample_rate: int = 22050
    hop_length: int = 275

    def get_text_processor(self):
        return _CharTextProcessor()

    def _tacotron2(self, device, generator):
        return M.Tacotron2(n_symbols=len(_CharTextProcessor.symbols),
                           n_mels=self.n_mels, device=device,
                           generator=generator)

    def get_tacotron2(self, generator: Optional[torch.Generator] = None,
                      checkpoint=None, torch_checkpoint=None, *,
                      device="cuda") -> nn.Module:
        """``Tacotron2`` with weights from ``generator``, a torchaudio-layout
        ``state_dict`` (or a path to one) or the JAX model's params saved by
        ``save_params``."""
        return _resolve(self._tacotron2, generator, checkpoint,
                              torch_checkpoint, device,
                              tacotron2_from_jax_params, lambda sd, _: sd).eval()

    def _wavernn(self, device, generator):
        return M.WaveRNN(upsample_scales=(5, 5, 11),
                         hop_length=self.hop_length, n_freq=self.n_mels,
                         device=device, generator=generator)

    def get_vocoder(self, generator: Optional[torch.Generator] = None,
                    checkpoint=None, torch_checkpoint=None, *,
                    device="cuda") -> nn.Module:
        """``WaveRNN`` with weights as :meth:`get_tacotron2` (a
        torchaudio-layout ``WaveRNN`` ``state_dict``)."""
        return _resolve(self._wavernn, generator, checkpoint,
                              torch_checkpoint, device,
                              wavernn_from_jax_params, lambda sd, _: sd).eval()


class _HiFiGANMelTransform(nn.Module):
    """``waveform (..., T)`` → ``(..., n_mels, T // hop)`` log-mel: reflect
    padding by ``(fft − hop)//2``, an uncentered ``stft``, the magnitude
    ``sqrt(re² + im² + 1e-9)``, a Slaney mel product in FP32,
    ``log(clamp(mel, 1e-5))``."""

    def __init__(self, b: "HiFiGANVocoderBundle"):
        super().__init__()
        self.fft, self.hop = b.fft_length, b.hop_length
        self.register_buffer("fb", create_mel_filter(
            b.n_mels, b.sample_rate, b.f_min, b.f_max, b.fft_length // 2 + 1,
            mel_scale="slaney", norm="slaney"))

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        pad = (self.fft - self.hop) // 2
        x = waveform.to(torch.float32)
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                  mode="reflect").reshape(lead + (-1,))
        spec = stft(x, self.fft, self.hop, center=False)
        mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
        mel = torch.einsum("...ft,fm->...mt", mag, self.fb)
        return torch.log(mel.clamp(min=1e-5))


@dataclass(frozen=True)
class HiFiGANVocoderBundle:
    """HiFi-GAN mel → waveform bundle (torchaudio's
    ``HIFIGAN_VOCODER_V3_LJSPEECH`` surface): ``get_vocoder`` and the
    training recipe's log-mel, ``get_mel_transform`` (fft 1024, hop 256,
    Slaney mels up to 8 kHz)."""
    _factory: Callable = M.hifigan_vocoder_v3
    sample_rate: int = 22050
    n_mels: int = 80
    fft_length: int = 1024
    hop_length: int = 256
    f_min: float = 0.0
    f_max: float = 8000.0

    def _build(self, device, generator):
        return self._factory(in_channels=self.n_mels, device=device,
                             generator=generator)

    def get_vocoder(self, generator: Optional[torch.Generator] = None,
                    checkpoint=None, torch_checkpoint=None, *,
                    device="cuda") -> nn.Module:
        """``HiFiGANVocoder`` in eval mode: weights from ``generator``, a
        generator ``state_dict`` or a path to one (HF ``SpeechT5HifiGan``
        or the original repo's names, weight norm folded:
        ``utils.convert.hifigan_from_torch_state_dict``) or the JAX
        model's params saved by ``save_params``."""
        return _resolve(self._build, generator, checkpoint,
                              torch_checkpoint, device,
                              hifigan_from_jax_params,
                              hifigan_from_torch_state_dict).eval()

    def get_mel_transform(self, *, device="cuda") -> nn.Module:
        return _HiFiGANMelTransform(self).to(device)


TACOTRON2_WAVERNN_CHAR_LJSPEECH = Tacotron2TTSBundle()
HIFIGAN_VOCODER_V3_LJSPEECH = HiFiGANVocoderBundle()


# -- Griffin-Lim and phone bundles -------------------------------------------

def _arpabet_symbols() -> Tuple[str, ...]:
    """The 96-symbol phone table of the JAX package: 12 specials, then the
    sorted ARPAbet (15 vowels bare and with stress 0/1/2, 24
    consonants)."""
    vowels = "AA AE AH AO AW AY EH ER EY IH IY OW OY UH UW".split()
    consonants = ("B CH D DH F G HH JH K L M N NG P R S SH T TH V W "
                  "Y Z ZH").split()
    phones = sorted(consonants + [v + s for v in vowels
                                  for s in ("", "0", "1", "2")])
    return tuple("_-!'(),.:;? ") + tuple(phones)


class _PhoneTextProcessor:
    """Phone text frontend over a local CMU Pronouncing Dictionary
    (``root`` holds ``cmudict-0.7b``, read by ``datasets.CMUDict``; the
    first pronunciation of a word wins).  Words are looked up upper-case,
    with their apostrophes and then without; punctuation keeps its own
    symbol; a space separates words.  An unknown word raises ``KeyError``
    (``oov="skip"`` drops it)."""

    symbols = _arpabet_symbols()

    def __init__(self, root: str, oov: str = "raise"):
        if oov not in ("raise", "skip"):
            raise ValueError("oov must be 'raise' or 'skip'")
        self._oov = oov
        self._dict = {}
        for word, phones in CMUDict(root):
            self._dict.setdefault(word, phones)
        self._index = {s: i for i, s in enumerate(self.symbols)}

    def __call__(self, texts):
        if isinstance(texts, str):
            texts = [texts]
        ids = []
        for text in texts:
            seq = []
            for word in text.upper().split():
                core = word.strip("!(),.:;?")
                phones = self._dict.get(core)
                if phones is None and core.strip("'") != core:
                    phones = self._dict.get(core.strip("'"))
                if phones is None and core.strip("'"):
                    if self._oov == "raise":
                        raise KeyError(
                            f"word {core!r} not in CMUDict: add a "
                            "pronunciation or use oov='skip'")
                    phones = []
                wseq = [self._index[p] for p in phones or []
                        if p in self._index]
                wseq += [self._index[ch] for ch in word
                         if ch in "!'(),.:;?" and ch in self._index]
                if not wseq:
                    continue
                if seq:
                    seq.append(self._index[" "])
                seq.extend(wseq)
            ids.append(seq or [0])
        return _pad_ids(ids)


class _GriffinLimVocoder:
    """Tacotron2's natural-log mel ``(B, n_mels, T)`` → ``(waveform (B,
    samples), lengths)``: ``exp``, then ``ops.mel_to_audio`` (ridge mel
    inversion + Griffin-Lim, the default ``method="matmul"``) on the mel's
    device.  ``lengths`` (frames) become ``frames · hop`` samples, clamped
    to the waveform."""

    def __init__(self, sample_rate=22050, n_fft=1024, hop_length=256,
                 n_mels=80, f_min=0.0, f_max=8000.0, n_iter=60,
                 momentum=0.99, power=1.0):
        self.sample_rate = sample_rate
        self.kw = dict(num_mels=n_mels, sample_rate=sample_rate,
                       f_min=f_min, f_max=f_max, fft_length=n_fft,
                       hop_length=hop_length, n_iter=n_iter,
                       momentum=momentum, power=power)
        self.hop_length = hop_length

    def __call__(self, mel: torch.Tensor, lengths=None,
                 generator: Optional[torch.Generator] = None):
        wave = mel_to_audio(torch.exp(torch.as_tensor(mel)),
                            generator=generator, **self.kw)
        if lengths is not None:
            # the center=True ISTFT yields (frames - 1) * hop samples
            lengths = np.minimum(np.asarray(torch.as_tensor(lengths).cpu())
                                 * self.hop_length, wave.shape[-1])
        return wave, lengths


@dataclass(frozen=True)
class Tacotron2GriffinLimBundle(Tacotron2TTSBundle):
    """Tacotron2 + the Griffin-Lim vocoder (no vocoder weights; fft 1024,
    hop 256, 80 mels up to 8 kHz, 60 iterations)."""
    hop_length: int = 256

    def get_vocoder(self, generator=None, checkpoint=None,
                    torch_checkpoint=None):
        if generator is not None or checkpoint is not None \
                or torch_checkpoint is not None:
            raise ValueError("the Griffin-Lim vocoder has no weights: call "
                             "get_vocoder() bare")
        return _GriffinLimVocoder(sample_rate=self.sample_rate,
                                  hop_length=self.hop_length,
                                  n_mels=self.n_mels)


@dataclass(frozen=True)
class Tacotron2PhoneMixin:
    """``get_text_processor(root=...)`` gives the CMUDict phone frontend;
    Tacotron2 is sized for the 96-phone table."""

    def get_text_processor(self, root=None, oov="raise"):
        if root is None:
            raise ValueError("phone bundles need root= naming a directory "
                             "that holds cmudict-0.7b (nothing is "
                             "downloaded)")
        return _PhoneTextProcessor(root, oov=oov)

    def _tacotron2(self, device, generator):
        return M.Tacotron2(n_symbols=len(_arpabet_symbols()),
                           n_mels=self.n_mels, device=device,
                           generator=generator)


@dataclass(frozen=True)
class _Tacotron2WaveRNNPhone(Tacotron2PhoneMixin, Tacotron2TTSBundle):
    pass


@dataclass(frozen=True)
class _Tacotron2GLPhone(Tacotron2PhoneMixin, Tacotron2GriffinLimBundle):
    pass


TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH = Tacotron2GriffinLimBundle()
TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH = _Tacotron2GLPhone()
TACOTRON2_WAVERNN_PHONE_LJSPEECH = _Tacotron2WaveRNNPhone()


# -- separation, assessment and embedding -------------------------------------

@dataclass(frozen=True)
class _ModelBundle:
    """A bundle of one model: ``get_model`` builds ``_factory(device=,
    generator=)`` with weights from ``generator``, ``torch_checkpoint``
    (``_from_torch``; ``None`` where the bundle reads none) or ``checkpoint``
    (``_from_jax``)."""
    _factory: Callable
    _from_jax: Callable
    _from_torch: Optional[Callable] = None

    def get_model(self, generator: Optional[torch.Generator] = None,
                  checkpoint=None, torch_checkpoint=None, *,
                  device="cuda") -> nn.Module:
        """``torch_checkpoint``: torchaudio's ``state_dict`` of the model
        (``HDemucs`` for the HDemucs bundles, ``ConvTasNet``,
        ``SquimObjective``) or a path to one; ``checkpoint``: the JAX
        model's params saved by ``save_params``."""
        return _resolve(
            lambda device, generator: self._factory(device=device,
                                                    generator=generator),
            generator, checkpoint, torch_checkpoint, device,
            self._from_jax, self._from_torch)


@dataclass(frozen=True)
class SourceSeparationBundle(_ModelBundle):
    """Source separation: ``get_model`` gives the separator (``forward(mix)``
    → one waveform per entry of ``sources``)."""
    sample_rate: int = 44100
    sources: Tuple[str, ...] = ("drums", "bass", "other", "vocals")


def _hdemucs_high_ta(*, device, generator):
    return M.hdemucs_high(compat="torchaudio", device=device,
                          generator=generator)


# the HIGH bundles have torchaudio's layout (HDemucsTA), so the released
# MUSDB checkpoints load; models.HDemucs is the JAX package's redesign
HDEMUCS_HIGH_MUSDB = SourceSeparationBundle(
    _hdemucs_high_ta, hdemucs_ta_from_jax_params,
    hdemucs_from_torch_state_dict)
HDEMUCS_HIGH_MUSDB_PLUS = SourceSeparationBundle(
    _hdemucs_high_ta, hdemucs_ta_from_jax_params,
    hdemucs_from_torch_state_dict)
CONVTASNET_BASE_LIBRI2MIX = SourceSeparationBundle(
    M.conv_tasnet_base, conv_tasnet_from_jax_params,
    conv_tasnet_from_torch_state_dict, sample_rate=8000,
    sources=("speech1", "speech2"))


@dataclass(frozen=True)
class SquimBundle(_ModelBundle):
    """Speech quality assessment: ``get_model`` gives the Squim model."""
    sample_rate: int = 16000


def _squim_objective_ta(*, device, generator):
    return M.squim_objective_base(compat="torchaudio", device=device,
                                  generator=generator)


# OBJECTIVE has torchaudio's layout, so its released checkpoint loads;
# SUBJECTIVE is the JAX package's NORESQA-MOS-style build
SQUIM_OBJECTIVE = SquimBundle(_squim_objective_ta,
                              squim_objective_ta_from_jax_params,
                              squim_objective_from_torch_state_dict)
SQUIM_SUBJECTIVE = SquimBundle(M.squim_subjective_base,
                               squim_subjective_from_jax_params)


@dataclass(frozen=True)
class VGGishBundle:
    """AudioSet VGGish embeddings (torchaudio's ``prototype.pipelines.VGGISH``
    surface): ``get_model`` maps 96×64 log-mel patches to 128-wide
    embeddings, ``get_input_processor`` builds the published
    ``mel_features`` front end."""
    sample_rate: int = 16000

    def get_model(self, generator: Optional[torch.Generator] = None,
                  checkpoint=None, torch_checkpoint=None, *,
                  device="cuda") -> nn.Module:
        """``torch_checkpoint``: a ``torchvggish`` ``state_dict`` or a path
        to one; ``checkpoint``: the JAX model's params saved by
        ``save_params``."""
        return _resolve(
            lambda device, generator: M.VGGish(device=device,
                                               generator=generator),
            generator, checkpoint, torch_checkpoint, device,
            vggish_from_jax_params, vggish_from_torch_state_dict)

    def get_input_processor(self) -> M.VGGishInputProcessor:
        return M.VGGishInputProcessor()


VGGISH = VGGishBundle()
