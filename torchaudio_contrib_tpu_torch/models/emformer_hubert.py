"""Emformer-encoder HuBERT variant (streaming self-supervised features).

Port of ``torchaudio_contrib_tpu/models/emformer_hubert.py``: acoustic
features ``(B, T, F)``, a frame stacker (``stride``) + layer norm + linear
projection, and the port's house :class:`~.emformer.Emformer`; so the same
model serves full-utterance pretraining (it has the
:class:`~.wav2vec2.Wav2Vec2` SSL surface, and
:class:`~.hubert.HuBERTPretrainModel` composes with it) and chunkwise
streaming through ``init_state``/``infer``, which reproduces the one-shot
forward (the Emformer's contract).

Lengths: a clip of ``T`` feature frames stacks to ``T // stride`` encoder
frames, of which the last ``right_context`` are the clip's lookahead, so
``output_length(T) = T // stride - right_context`` (per sample in a padded
batch).  Parameters: ``proj_ln``, ``proj``, ``encoder.*`` (the Emformer's
torchaudio names), ``aux``.  Modules take ``device=`` (the card unless the
caller asks for the CPU) and ``generator=`` for their initial weights.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ._common import _dense
from .emformer import Emformer

__all__ = ["EmformerHuBERT", "emformer_hubert_model", "emformer_hubert_base"]


class EmformerHuBERT(nn.Module):
    """``forward(features (B, T, feature_dim), lengths=None)`` →
    ``(encodings (B, T // stride - right_context, d_model) [or logits if
    aux_out], out_lengths)``."""

    def __init__(self, feature_dim: int = 80, stride: int = 4,
                 d_model: int = 768, num_heads: int = 8,
                 ffn_dim: int = 2048, num_layers: int = 12,
                 segment_length: int = 4,
                 left_context_length: int = 30,
                 right_context_length: int = 1,
                 max_memory_size: int = 4,
                 aux_out: Optional[int] = None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stride < 1:
            raise ValueError("stride must be >= 1")
        self.feature_dim = feature_dim
        self.stride = stride
        self.d_model = d_model
        self.aux_out = aux_out
        cin = feature_dim * stride
        self.proj_ln = nn.LayerNorm(cin)
        self.proj = _dense(cin, d_model, generator)
        self.encoder = Emformer(
            d_model, num_heads, ffn_dim, num_layers, segment_length,
            left_context_length=left_context_length,
            right_context_length=right_context_length,
            max_memory_size=max_memory_size, device="cpu",
            generator=generator)
        if aux_out is not None:
            self.aux = _dense(d_model, aux_out, generator)
        self.to(device)

    # -- SSL surface ------------------------------------------------------
    def output_length(self, length):
        """Valid encoder frames for a feature-frame count (the last
        ``right_context`` stacked frames are the lookahead tail)."""
        r = self.encoder.R
        if isinstance(length, int):
            return max(length // self.stride - r, 0)
        return (torch.as_tensor(length).long() // self.stride - r).clamp(
            min=0)

    def _stack_project(self, features):
        """(B, T, F) → stacked (B, T // stride, F·stride) features and
        their LN + projection (B, T // stride, d_model)."""
        if features.ndim != 3 or features.shape[-1] != self.feature_dim:
            raise ValueError(
                f"features must be (batch, time, {self.feature_dim})")
        b, t, f = features.shape
        tr = t // self.stride
        feats = features[:, :tr * self.stride].reshape(b, tr, f * self.stride)
        return feats, self.proj(self.proj_ln(feats))

    def forward(self, features: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, *,
                frame_mask: Optional[torch.Tensor] = None,
                mask_embedding: Optional[torch.Tensor] = None,
                return_features: bool = False):
        feats, x = self._stack_project(features)
        b, tr, _ = x.shape
        R = self.encoder.R
        t_out = tr - R
        if t_out < 1:
            raise ValueError("need at least (right_context + 1) * stride "
                             "feature frames")
        dev = x.device
        out_lengths = torch.full((b,), t_out, dtype=torch.long, device=dev)
        if lengths is not None:
            out_lengths = self.output_length(
                torch.as_tensor(lengths, device=dev))
        if frame_mask is not None:
            if mask_embedding is None:
                raise ValueError("frame_mask needs mask_embedding")
            if frame_mask.shape[1] != t_out:
                raise ValueError(
                    f"frame_mask covers the {t_out} utterance frames, "
                    f"got {frame_mask.shape[1]}")
            full = torch.cat([frame_mask, frame_mask.new_zeros((b, R))], 1)
            x = torch.where(full[..., None], mask_embedding, x)
        x, out_lengths = self.encoder(x, out_lengths)
        if self.aux_out is not None:
            x = self.aux(x)
        if return_features:
            return x, out_lengths, feats[:, :t_out]
        return x, out_lengths

    # -- streaming ---------------------------------------------------------
    def init_state(self, batch_size: int, device=None) -> dict:
        """Zeroed streaming state (the Emformer's)."""
        return self.encoder.init_state(batch_size, device)

    def infer(self, chunk: torch.Tensor, state: dict, utt_lengths=None,
              rc_lengths=None):
        """One streaming step over ``(segment_length + right_context) *
        stride`` new feature frames (lookahead included); returns
        ``(encodings (B, segment_length, d_model), out_lengths, state)``.
        Lengths are in encoder frames, as the Emformer's."""
        enc = self.encoder
        want = (enc.S + enc.R) * self.stride
        if chunk.ndim != 3 or chunk.shape[1] != want:
            raise ValueError(
                f"chunk must be (batch, {want}, {self.feature_dim})")
        _, x = self._stack_project(chunk)
        out, out_len, state = enc.infer(x, state, utt_lengths=utt_lengths,
                                        rc_lengths=rc_lengths)
        if self.aux_out is not None:
            out = self.aux(out)
        return out, out_len, state


def emformer_hubert_model(**kwargs) -> EmformerHuBERT:
    """Generic constructor (torchaudio's ``emformer_hubert_model``): all
    :class:`EmformerHuBERT` keywords."""
    return EmformerHuBERT(**kwargs)


def emformer_hubert_base(aux_out: Optional[int] = None,
                         **kwargs) -> EmformerHuBERT:
    """Streaming-HuBERT base scale: 80-dim fbank in, 4-frame stacking, 12
    Emformer layers × 768, as the JAX package pins it."""
    kwargs.setdefault("feature_dim", 80)
    kwargs.setdefault("stride", 4)
    kwargs.setdefault("d_model", 768)
    kwargs.setdefault("num_layers", 12)
    return EmformerHuBERT(aux_out=aux_out, **kwargs)
