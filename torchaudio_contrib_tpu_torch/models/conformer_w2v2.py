"""Conformer-encoder wav2vec 2.0 variant (feature input).

Port of ``torchaudio_contrib_tpu/models/conformer_w2v2.py``: acoustic
features ``(B, T, F)`` are stacked ``stride`` frames at a time (a time
reduction), layer-normed and projected to the model width, and encoded by
the port's :class:`~.conformer.Conformer`.  It has the
:class:`~.wav2vec2.Wav2Vec2` SSL surface, so
:class:`~.hubert.HuBERTPretrainModel` composes with it (features where it
says waveforms).

Parameters: ``proj_ln``, ``proj``, ``encoder.*`` (the Conformer's
torchaudio names), ``aux``; the pretraining wrapper adds
``mask_embedding``.  Modules take ``device=`` (the card unless the caller
asks for the CPU) and ``generator=`` for their initial weights (and the
wrapper's forward takes ``generator=`` for its span mask, where the JAX
package takes a key).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ._common import _dense
from .conformer import Conformer
from .hubert import _draw_frame_mask

__all__ = ["ConformerWav2Vec2", "conformer_wav2vec2_model",
           "conformer_wav2vec2_base",
           "ConformerWav2Vec2PretrainModel",
           "conformer_wav2vec2_pretrain_model",
           "conformer_wav2vec2_pretrain_base",
           "conformer_wav2vec2_pretrain_large"]


class ConformerWav2Vec2(nn.Module):
    """``forward(features (B, T, feature_dim), lengths=None)`` →
    ``(encodings (B, T // stride, d_model) [or logits if aux_out],
    out_lengths)``; frames past ``lengths // stride`` are zeroed."""

    def __init__(self, feature_dim: int = 64, stride: int = 4,
                 d_model: int = 256, num_layers: int = 12,
                 num_heads: int = 4, ff_ratio: int = 4,
                 conv_kernel: int = 31,
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
        self.encoder = Conformer(d_model, d_model, num_layers, num_heads,
                                 ff_ratio, conv_kernel, device="cpu",
                                 generator=generator)
        if aux_out is not None:
            self.aux = _dense(d_model, aux_out, generator)
        self.to(device)

    def output_length(self, length):
        """Reduced frame count for an input feature-frame count."""
        return length // self.stride

    def forward(self, features: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, *,
                frame_mask: Optional[torch.Tensor] = None,
                mask_embedding: Optional[torch.Tensor] = None,
                return_features: bool = False):
        if features.ndim != 3 or features.shape[-1] != self.feature_dim:
            raise ValueError(
                f"features must be (batch, time, {self.feature_dim})")
        b, t, f = features.shape
        tr = t // self.stride
        if tr < 1:
            raise ValueError("need at least `stride` feature frames")
        dev = features.device
        # time reduction: stack `stride` consecutive frames
        feats = features[:, :tr * self.stride].reshape(b, tr, f * self.stride)
        out_lengths = torch.full((b,), tr, dtype=torch.long, device=dev)
        pad_mask = None
        if lengths is not None:
            out_lengths = self.output_length(
                torch.as_tensor(lengths, device=dev).long())
            pad_mask = torch.arange(tr, device=dev)[None] \
                < out_lengths[:, None]
            feats = torch.where(pad_mask[..., None], feats, 0.0)
        x = self.proj(self.proj_ln(feats))
        if frame_mask is not None:
            if mask_embedding is None:
                raise ValueError("frame_mask needs mask_embedding")
            x = torch.where(frame_mask[..., None], mask_embedding, x)
        x = self.encoder(x, out_lengths if lengths is not None else None)
        if pad_mask is not None:
            x = torch.where(pad_mask[..., None], x, 0.0)
        if self.aux_out is not None:
            x = self.aux(x)
        if return_features:
            return x, out_lengths, feats
        return x, out_lengths


def conformer_wav2vec2_model(**kwargs) -> ConformerWav2Vec2:
    """Generic constructor: all :class:`ConformerWav2Vec2` keywords."""
    return ConformerWav2Vec2(**kwargs)


def conformer_wav2vec2_base(aux_out: Optional[int] = None, *, device="cuda",
                            generator: Optional[torch.Generator] = None
                            ) -> ConformerWav2Vec2:
    """Base: 64-dim features, 4× time reduction, 12 Conformer layers at
    width 256."""
    return ConformerWav2Vec2(aux_out=aux_out, device=device,
                             generator=generator)


class ConformerWav2Vec2PretrainModel(nn.Module):
    """Masked-prediction wrapper around :class:`ConformerWav2Vec2`: the
    encoder plus a learned ``mask_embedding`` and a span-mask generator.
    ``forward(features, lengths=None, frame_mask=None, *, generator=None)``
    (also ``apply``) samples span masks over the valid reduced frames (or
    takes ``frame_mask``), replaces masked encoder inputs with the mask
    embedding and returns ``(encodings, out_lengths, frame_mask,
    unmasked_features)``."""

    def __init__(self, encoder: ConformerWav2Vec2,
                 mask_prob: float = 0.065, mask_span: int = 10, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if encoder.aux_out is not None:
            raise ValueError("pretraining encoder must have aux_out=None "
                             "(the head would hide the representations)")
        if not 0.0 < mask_prob <= 1.0:
            raise ValueError("mask_prob must be in (0, 1]")
        if mask_span < 1:
            raise ValueError("mask_span must be >= 1")
        self.encoder = encoder
        self.mask_prob = mask_prob
        self.mask_span = mask_span
        self.mask_embedding = nn.Parameter(torch.empty(encoder.d_model))
        with torch.no_grad():
            self.mask_embedding.normal_(generator=generator).mul_(0.1)
        self.to(device)

    def forward(self, features: torch.Tensor, lengths=None,
                frame_mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None):
        frame_mask = _draw_frame_mask(self.encoder, features, lengths,
                                      frame_mask, generator, self.mask_prob,
                                      self.mask_span)
        enc, out_lengths, feats = self.encoder(
            features, lengths, frame_mask=frame_mask,
            mask_embedding=self.mask_embedding, return_features=True)
        return enc, out_lengths, frame_mask, feats

    # the JAX package's name (it shadows ``nn.Module.apply(fn)``)
    apply = forward


def conformer_wav2vec2_pretrain_model(
        mask_prob: float = 0.065, mask_span: int = 10, *, device="cuda",
        generator: Optional[torch.Generator] = None,
        **kwargs) -> ConformerWav2Vec2PretrainModel:
    """Generic constructor: encoder keywords pass through to
    :class:`ConformerWav2Vec2`."""
    enc = ConformerWav2Vec2(**kwargs, device="cpu", generator=generator)
    return ConformerWav2Vec2PretrainModel(enc, mask_prob, mask_span,
                                          device=device, generator=generator)


def conformer_wav2vec2_pretrain_base(**kwargs
                                     ) -> ConformerWav2Vec2PretrainModel:
    """The pretraining wrapper at the base scale (64-dim features, 12
    layers × 256)."""
    return conformer_wav2vec2_pretrain_model(**kwargs)


def conformer_wav2vec2_pretrain_large(**kwargs
                                      ) -> ConformerWav2Vec2PretrainModel:
    """The pretraining wrapper at the large scale (12 layers × 768, 8
    heads), as the JAX package pins it."""
    kwargs.setdefault("d_model", 768)
    kwargs.setdefault("num_heads", 8)
    return conformer_wav2vec2_pretrain_model(**kwargs)
