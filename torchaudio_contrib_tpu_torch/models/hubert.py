"""HuBERT masked-prediction pretraining (Hsu et al. 2021).

Port of ``torchaudio_contrib_tpu/models/hubert.py``: an encoder run with
span-masked projected features (a learned mask token replaces masked
frames), a final projection, and cosine-similarity logits against learned
per-cluster label embeddings; the loss is cross-entropy against offline
cluster assignments over masked (and, weighted, unmasked) frames plus an
L2 penalty on the extractor's output.

:func:`span_mask` draws one uniform a frame from a ``torch.Generator``
(where the JAX package takes a PRNG key; the streams differ, so the two
agree in distribution, not sample by sample) and dilates the span starts
with a max-pool: no host loop.  The encoder is any module with the
:class:`~.wav2vec2.Wav2Vec2` SSL surface (``frame_mask=``,
``mask_embedding=``, ``return_features=True``, ``output_length``,
``d_model``, ``aux_out``): ``ConformerWav2Vec2`` and ``EmformerHuBERT``
compose too, with features where it says waveforms.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ._common import _dense

__all__ = ["span_mask", "HuBERTPretrainModel"]


def span_mask(generator: Optional[torch.Generator], batch_size: int,
              num_frames: int, lengths=None, mask_prob: float = 0.065,
              mask_span: int = 10, *, device=None) -> torch.Tensor:
    """Sample HuBERT/wav2vec2-style span masks ``(B, T) bool``.

    Each frame is a span *start* with probability ``mask_prob`` (drawn on
    the generator's device); a start at ``s`` masks ``[s, s + mask_span)``.
    Starts are kept only where the whole span fits inside ``lengths``
    (default ``num_frames``), so masks never cross into padding.  The
    mask is on ``device``: by default that of a tensor ``lengths``, else
    the card.
    """
    if device is None:
        device = lengths.device if isinstance(lengths, torch.Tensor) \
            else "cuda"
    gen_dev = generator.device if generator is not None else "cpu"
    starts = torch.rand((batch_size, num_frames), generator=generator,
                        device=gen_dev).to(device) < mask_prob
    frames = torch.arange(num_frames, device=device)[None]
    if lengths is None:
        limit = num_frames - mask_span + 1
    else:
        limit = torch.as_tensor(lengths, device=device).long()[:, None] \
            - mask_span + 1
    starts = starts & (frames < limit)
    # dilate: frame t is masked iff a start lies in (t - span, t]
    return F.max_pool1d(F.pad(starts.float()[:, None], (mask_span - 1, 0)),
                        mask_span, 1)[:, 0] > 0.0


def _draw_frame_mask(encoder, inputs: torch.Tensor, lengths, frame_mask,
                     generator, mask_prob: float, mask_span: int):
    """``frame_mask`` as given, or one drawn by :func:`span_mask` over the
    encoder's valid output frames of ``inputs`` (``generator`` is needed
    then)."""
    if frame_mask is not None:
        return frame_mask
    if generator is None:
        raise ValueError("need generator when frame_mask is None")
    dev = inputs.device
    t_out = int(encoder.output_length(inputs.shape[1]))
    out_lengths = None if lengths is None else encoder.output_length(
        torch.as_tensor(lengths, device=dev).long())
    return span_mask(generator, inputs.shape[0], t_out, out_lengths,
                     mask_prob, mask_span, device=dev)


class HuBERTPretrainModel(nn.Module):
    """``forward(waveforms, lengths=None, frame_mask=None, *,
    generator=None)`` (also ``apply``) → ``(logits (B, T', C), frame_mask
    (B, T'), out_lengths, features)``; ``loss(waveforms, labels,
    lengths=None, frame_mask=None, *, generator=None)`` → the scalar
    objective.

    ``labels (B, T')`` are cluster ids at the encoder's frame rate (< 0 is
    ignored).  Parameters: ``encoder.*`` (the encoder's own names),
    ``mask_embedding (d_model,)``, ``final_proj`` and ``label_embeddings
    (num_classes, final_dim)``.  The module is moved to ``device`` with
    its encoder."""

    def __init__(self, encoder: nn.Module, num_classes: int,
                 final_dim: int = 256, mask_prob: float = 0.065,
                 mask_span: int = 10, temperature: float = 0.1,
                 masked_weight: float = 1.0,
                 unmasked_weight: float = 0.0,
                 feature_penalty: float = 10.0, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if encoder.aux_out is not None:
            raise ValueError("pretraining encoder must have aux_out=None "
                             "(the aux head is for fine-tuning)")
        self.encoder = encoder
        self.num_classes = num_classes
        self.final_dim = final_dim
        self.mask_prob = mask_prob
        self.mask_span = mask_span
        self.tau = temperature
        self.w_m = masked_weight
        self.w_u = unmasked_weight
        self.w_f = feature_penalty
        d, f = encoder.d_model, final_dim
        self.mask_embedding = nn.Parameter(torch.empty(d))
        with torch.no_grad():
            self.mask_embedding.uniform_(-0.1, 0.1, generator=generator)
        self.final_proj = _dense(d, f, generator)
        self.label_embeddings = nn.Parameter(torch.empty(num_classes, f))
        with torch.no_grad():
            self.label_embeddings.normal_(generator=generator).mul_(0.02)
        self.to(device)

    def forward(self, waveforms: torch.Tensor, lengths=None,
                frame_mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None):
        """Masked forward.  ``frame_mask`` overrides the sampled mask (pass
        the same mask to compare runs); ``generator`` is needed iff
        ``frame_mask`` is None."""
        frame_mask = _draw_frame_mask(self.encoder, waveforms, lengths,
                                      frame_mask, generator, self.mask_prob,
                                      self.mask_span)
        x, out_lengths, feats = self.encoder(
            waveforms, lengths, frame_mask=frame_mask,
            mask_embedding=self.mask_embedding, return_features=True)
        proj = self.final_proj(x)
        # cosine-similarity logits against the label embeddings
        proj = proj / (torch.linalg.vector_norm(proj, dim=-1,
                                                keepdim=True) + 1e-8)
        emb = self.label_embeddings
        emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                     + 1e-8)
        logits = proj @ emb.t() / self.tau            # (B, T', C)
        return logits, frame_mask, out_lengths, feats

    # the JAX package's name (it shadows ``nn.Module.apply(fn)``)
    apply = forward

    def loss(self, waveforms: torch.Tensor, labels, lengths=None,
             frame_mask: Optional[torch.Tensor] = None, *,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``w_m``·CE(masked) + ``w_u``·CE(unmasked) +
        ``w_f``·mean(features²) over valid frames; ``labels < 0`` are
        ignored."""
        logits, frame_mask, out_lengths, feats = self(
            waveforms, lengths, frame_mask, generator=generator)
        dev = logits.device
        labels = torch.as_tensor(labels, device=dev).long()
        valid = labels >= 0
        frames = torch.arange(logits.shape[1], device=dev)[None]
        if out_lengths is not None:
            valid = valid & (frames < out_lengths[:, None])
        logp = torch.log_softmax(logits, -1)
        ce = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]

        def _mean(mask):
            w = (mask & valid).float()
            return (ce * w).sum() / w.sum().clamp(min=1.0)

        out = self.w_m * _mean(frame_mask)
        if self.w_u:
            out = out + self.w_u * _mean(~frame_mask)
        if self.w_f:
            if out_lengths is None:
                pen = (feats ** 2).mean()
            else:       # the mean over valid frames (padding-invariant)
                vf = (torch.arange(feats.shape[1], device=dev)[None]
                      < out_lengths[:, None]).to(feats.dtype)
                pen = (feats ** 2 * vf[..., None]).sum() \
                    / (vf.sum().clamp(min=1.0) * feats.shape[-1])
            out = out + self.w_f * pen
        return out
