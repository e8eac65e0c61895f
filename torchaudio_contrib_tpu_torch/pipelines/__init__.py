"""Pipeline bundles: a model, its feature extractor and its decoder.

Port of the transducer and wav2vec2 parts of
``torchaudio_contrib_tpu/pipelines``: :class:`RNNTBundle` and the three
``EMFORMER_RNNT_BASE_*``; :class:`Wav2Vec2Bundle`,
:class:`Wav2Vec2ASRBundle` and their 24 constants (``WAV2VEC2_*``,
``HUBERT_*``, ``WAVLM_*``); :class:`Wav2Vec2FABundle` and ``MMS_FA``.  The
JAX package's other bundles wait for their models.

No pretrained weights can be fetched.  ``get_model`` builds the
architecture on ``device`` (the card unless the caller asks for the CPU)
with weights from a ``torch.Generator``, or loads ``torch_checkpoint`` (a
``state_dict`` or a path to one: torchaudio's layout for the RNN-T, HF's
for the wav2vec2 family) or ``checkpoint`` (a file of the JAX package's
``utils.checkpoint.save_params``, read by the port's ``load_params`` and
carried over by ``utils.convert``), and raises with none of them.  It
returns the module (the JAX package's returns ``(model, params)``).
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import models as M
from ..models import RNNTBeamSearch, emformer_rnnt_model
from ..models.layers import Melspectrogram
from ..ops.align import forced_align, merge_tokens
from ..utils.checkpoint import load_params
from ..utils.convert import (emformer_rnnt_from_jax_params,
                             wav2vec2_from_jax_params,
                             wav2vec2_from_torch_state_dict)

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
    (through ``from_torch(state_dict, model)``), ``checkpoint`` (through
    ``from_jax(params)``) or ``generator``, in that order."""
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
        sd = from_torch(_torch_state_dict(torch_checkpoint), model)
    else:
        sd = from_jax(load_params(checkpoint))
    model.load_state_dict(sd)
    return model.to(device)


class _RNNTFeatureExtractor(nn.Module):
    """``waveform (B, T)`` → ``(B, 1 + T // hop, n_mels)``: the mel
    spectrogram (fft 400) times the int16 gain, through torchaudio's
    piecewise-linear log (``log(x)`` above ``e``, ``x / e`` below)."""

    def __init__(self, n_mels: int, sample_rate: int, hop_length: int):
        super().__init__()
        self.mel = Melspectrogram(num_mels=n_mels, sample_rate=sample_rate,
                                  fft_length=400, hop_length=hop_length)
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
