"""Pipeline bundles: a model, its feature extractor and its decoder.

Port of the transducer part of ``torchaudio_contrib_tpu/pipelines``:
:class:`RNNTBundle` and its three bundles ``EMFORMER_RNNT_BASE_LIBRISPEECH``,
``EMFORMER_RNNT_BASE_MUSTC`` and ``EMFORMER_RNNT_BASE_TEDLIUM3``; the JAX
package's other bundles wait for their models.  No pretrained weights can
be fetched: :meth:`RNNTBundle.get_model` builds the architecture with
weights from a ``torch.Generator``, or loads a torchaudio-layout
``state_dict`` (the port's names are torchaudio's), and raises with
neither.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..models import RNNTBeamSearch, emformer_rnnt_model
from ..models.layers import Melspectrogram

__all__ = ["RNNTBundle", "EMFORMER_RNNT_BASE_LIBRISPEECH",
           "EMFORMER_RNNT_BASE_MUSTC", "EMFORMER_RNNT_BASE_TEDLIUM3"]


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
        ``generator``, or loaded from ``torch_checkpoint``, a
        torchaudio-layout ``state_dict`` or a path to one (``torch.load``,
        weights only).  ``checkpoint`` (the JAX package's own format)
        raises until its loader is ported."""
        if checkpoint is not None:
            raise NotImplementedError(
                "checkpoint= reads the JAX package's utils.checkpoint "
                "format, which is not ported yet (ROADMAP A7); pass "
                "torch_checkpoint=<torchaudio-layout state_dict or path>")
        if torch_checkpoint is not None:
            sd = torch_checkpoint if isinstance(torch_checkpoint, Mapping) \
                else torch.load(torch_checkpoint, map_location="cpu",
                                weights_only=True)
            model = self._model("cpu", None)
            model.load_state_dict(sd)
            return model.to(device)
        if generator is None:
            raise ValueError(
                "no pretrained weights are downloadable: pass "
                "generator=torch.Generator() for fresh parameters or "
                "torch_checkpoint=<state_dict or path> for trained ones")
        return self._model(device, generator)

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
