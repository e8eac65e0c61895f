"""Conformer encoder (Gulati et al. 2020) and its RNN-T transcriber.

Port of ``torchaudio_contrib_tpu/models/conformer.py``.  A block is ½FFN
→ self-attention with a learned T5-style relative-position bias (a
per-head table over signed distances clipped to ``max_distance``) →
convolution module (pointwise GLU → depthwise → norm → SiLU → pointwise)
→ ½FFN → LayerNorm, each with its residual; ``convolution_first`` swaps
attention and convolution.  ``lengths`` mask the attention keys (a masked
logit is replaced by ``-1e30``, as the JAX package does, so a row with no
valid key is uniform rather than NaN) and zero padded frames between
blocks.

``conv_norm`` picks the norm after the depthwise convolution:
``"layernorm"`` or ``"affine"`` (a frozen per-channel ``y·w + b``,
BatchNorm's inference form).  ``state_dict`` names are torchaudio's
``models.Conformer`` (``conformer_layers.{i}.ffn1.sequential.1`` …,
``self_attn.in_proj_weight``, ``conv_module.sequential.{0,2,3,5}``) plus
what torchaudio's has not: ``input_projection`` and
``self_attn.rel_bias``.  ``dropout`` acts in training mode where
torchaudio's does (inside each FFN, on the attention weights and output,
after the convolution module); the JAX model has none, and the default 0
is the same model.

Modules take ``device=`` (the card unless the caller asks for the CPU)
and ``generator=`` for their initial weights.  The depthwise convolution
is a grouped ``nn.Conv1d`` (cuDNN on the card, which
``torch.backends.cudnn.allow_tf32`` governs).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ._common import _dense, _glorot_, _pointwise

__all__ = ["Conformer", "ConformerTranscriber"]

_NEG = -1e30


class _FeedForward(nn.Module):
    def __init__(self, d: int, f: int, dropout: float, generator):
        super().__init__()
        self.sequential = nn.Sequential(
            nn.LayerNorm(d), _dense(d, f, generator), nn.SiLU(),
            nn.Dropout(dropout), _dense(f, d, generator),
            nn.Dropout(dropout))

    def forward(self, x):
        return x + 0.5 * self.sequential(x)


class _Affine(nn.Module):
    """A frozen per-channel affine over the last axis."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return x * self.weight + self.bias


class _SelfAttention(nn.Module):
    def __init__(self, d: int, h: int, max_distance: int, dropout: float,
                 generator):
        super().__init__()
        self.h = h
        self.max_distance = max_distance
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        _glorot_(self.in_proj_weight, d, 3 * d, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = _dense(d, d, generator)
        self.rel_bias = nn.Parameter(
            0.02 * torch.randn((2 * max_distance + 1, h),
                               generator=generator))

    def forward(self, y, key_mask):
        b, t, d = y.shape
        h = self.h
        q, k, v = F.linear(y, self.in_proj_weight, self.in_proj_bias) \
            .unflatten(-1, (3, h, d // h)).permute(2, 0, 3, 1, 4)
        logits = q @ k.transpose(-1, -2) / math.sqrt(d // h)
        pos = torch.arange(t, device=y.device)
        dist = (pos[None, :] - pos[:, None]).clamp(-self.max_distance,
                                                   self.max_distance)
        logits = logits + self.rel_bias[dist + self.max_distance] \
            .permute(2, 0, 1)[None]
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :], _NEG)
        w = F.dropout(torch.softmax(logits, -1), self.dropout,
                      self.training)
        return self.out_proj((w @ v).transpose(1, 2).reshape(b, t, d))


class _ConvModule(nn.Module):
    def __init__(self, d: int, kernel: int, conv_norm: str, dropout: float,
                 generator):
        super().__init__()
        self.layer_norm = nn.LayerNorm(d)
        depthwise = nn.Conv1d(d, d, kernel, padding=kernel // 2, groups=d)
        with torch.no_grad():
            depthwise.weight.normal_(generator=generator).mul_(0.1)
            depthwise.bias.zero_()
        self.sequential = nn.Sequential(
            _pointwise(d, 2 * d, generator), nn.GLU(dim=1), depthwise,
            nn.LayerNorm(d) if conv_norm == "layernorm" else _Affine(d),
            nn.SiLU(), _pointwise(d, d, generator), nn.Dropout(dropout))

    def forward(self, x, pad_mask):
        seq = self.sequential
        y = self.layer_norm(x)
        if pad_mask is not None:
            y = torch.where(pad_mask[..., None], y, 0.0)
        y = seq[2](seq[1](seq[0](y.transpose(1, 2)))).transpose(1, 2)
        y = seq[4](seq[3](y))
        return x + seq[6](seq[5](y.transpose(1, 2)).transpose(1, 2))


class _ConformerLayer(nn.Module):
    def __init__(self, d, f, h, kernel, max_distance, conv_norm,
                 convolution_first, dropout, generator):
        super().__init__()
        self.convolution_first = convolution_first
        self.ffn1 = _FeedForward(d, f, dropout, generator)
        self.self_attn_layer_norm = nn.LayerNorm(d)
        self.self_attn = _SelfAttention(d, h, max_distance, dropout,
                                        generator)
        self.self_attn_dropout = nn.Dropout(dropout)
        self.conv_module = _ConvModule(d, kernel, conv_norm, dropout,
                                       generator)
        self.ffn2 = _FeedForward(d, f, dropout, generator)
        self.final_layer_norm = nn.LayerNorm(d)

    def _attention(self, x, pad_mask):
        return x + self.self_attn_dropout(
            self.self_attn(self.self_attn_layer_norm(x), pad_mask))

    def forward(self, x, pad_mask):
        x = self.ffn1(x)
        if self.convolution_first:
            x = self._attention(self.conv_module(x, pad_mask), pad_mask)
        else:
            x = self.conv_module(self._attention(x, pad_mask), pad_mask)
        x = self.final_layer_norm(self.ffn2(x))
        if pad_mask is not None:
            x = torch.where(pad_mask[..., None], x, 0.0)
        return x


class Conformer(nn.Module):
    """Masked Conformer encoder: ``forward(x (B, T, input_dim),
    lengths=None)`` → ``(B, T, d_model)``."""

    def __init__(self, input_dim: int, d_model: int = 256,
                 num_layers: int = 4, num_heads: int = 4,
                 ff_ratio: int = 4, conv_kernel: int = 31,
                 max_distance: int = 128,
                 conv_norm: str = "layernorm",
                 convolution_first: bool = False, dropout: float = 0.0, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must divide num_heads")
        if conv_kernel % 2 == 0:
            raise ValueError("conv_kernel must be odd")
        if conv_norm not in ("layernorm", "affine"):
            raise ValueError("conv_norm must be 'layernorm' or "
                             f"'affine', got {conv_norm!r}")
        self.input_dim = input_dim
        self.d_model = d_model
        self.input_projection = _dense(input_dim, d_model, generator)
        self.conformer_layers = nn.ModuleList(
            _ConformerLayer(d_model, ff_ratio * d_model, num_heads,
                            conv_kernel, max_distance, conv_norm,
                            convolution_first, dropout, generator)
            for _ in range(num_layers))
        self.to(device)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.ndim != 3 or x.shape[-1] != self.input_dim:
            raise ValueError(f"x must be (batch, time, {self.input_dim})")
        pad_mask = None
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=x.device)
            pad_mask = torch.arange(x.shape[1], device=x.device)[None] \
                < lengths[:, None]
        x = self.input_projection(x)
        for layer in self.conformer_layers:
            x = layer(x, pad_mask)
        return x


class ConformerTranscriber(nn.Module):
    """torchaudio's prototype ``_ConformerEncoder`` geometry as an RNN-T
    transcriber: stride-``s`` frame stacking (a trailing remainder of
    frames dropped) → the Conformer (its input projection is the input
    linear, ``input_dim·s → conformer_input_dim``, and the convolution
    comes first) → ``output_linear`` → ``layer_norm``; ``forward`` returns
    ``(encodings (B, T // s, output_dim), lengths // s)``."""

    def __init__(self, *, input_dim: int, output_dim: int,
                 time_reduction_stride: int,
                 conformer_input_dim: int, conformer_ffn_dim: int,
                 conformer_num_layers: int, conformer_num_heads: int,
                 conformer_depthwise_conv_kernel_size: int = 31,
                 dropout: float = 0.0, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if conformer_ffn_dim % conformer_input_dim:
            raise ValueError(
                "conformer_ffn_dim must be a multiple of "
                f"conformer_input_dim (got {conformer_ffn_dim} vs "
                f"{conformer_input_dim})")
        self.input_dim = input_dim
        self.stride = time_reduction_stride
        self.conformer = Conformer(
            input_dim * time_reduction_stride, conformer_input_dim,
            conformer_num_layers, conformer_num_heads,
            conformer_ffn_dim // conformer_input_dim,
            conformer_depthwise_conv_kernel_size, convolution_first=True,
            dropout=dropout, device="cpu", generator=generator)
        self.output_linear = _dense(conformer_input_dim, output_dim,
                                    generator)
        self.layer_norm = nn.LayerNorm(output_dim)
        self.to(device)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None):
        if x.ndim != 3 or x.shape[-1] != self.input_dim:
            raise ValueError(f"x must be (batch, time, {self.input_dim})")
        B, T, D = x.shape
        s = self.stride
        t_red = T // s
        if t_red < 1:
            raise ValueError(f"need at least {s} input frames (got {T})")
        y = x[:, :t_red * s].reshape(B, t_red, D * s)
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.long)
        red = torch.as_tensor(lengths, device=x.device).long() // s
        h = self.conformer(y, red)
        return self.layer_norm(self.output_linear(h)), red
