"""Plain wav2vec 2.0 with a CTC head (Baevski et al. 2020,
arXiv:2006.11477, as torchaudio's ``wav2vec2_model`` describes it), and the
plain collapse of a best path.

The model: a stack of strided 1-D convolutions on the raw waveform, each
followed by its norm and an exact GELU (``group_norm``: one GroupNorm with
a group a channel after the first convolution only, its statistics over
the whole padded length; ``layer_norm``: a LayerNorm over channels after
every one); a LayerNorm over channels and a linear projection; padded
frames set to zero; a grouped convolutional positional embedding (kernel
``k``, padded ``k//2`` on both sides, the last output dropped for an even
``k``) added through a GELU; transformer layers, post-LN (``x = LN(x +
attn(x)); x = LN(x + ffn(x))``) or pre-LN (``x = x + attn(LN(x)); x = x +
ffn(LN(x))``, a LayerNorm at the end), with the encoder's LayerNorm after
the positional embedding in the post-LN order; attention as ``softmax(q
kᵀ / √d_head)`` with padded keys masked; the FFN ``W₂ GELU(W₁ x)``; a
linear head.  Output lengths follow each convolution: ``(n - k) // s +
1``.

Parameters are a dict under the measured model's ``state_dict`` names.
Every function runs in the dtype of its input and its parameters: float64
for the reference, float32 with ``tf32=True`` for the lower-precision
control.  It imports nothing of the program.

Departures from torchaudio's description, none of which changes a valid
frame:

* dropout and layer drop are left out (inference);
* the positional convolution's weight norm is folded into one weight, as
  the measured model stores it;
* padded keys are masked with the dtype's lowest value where torchaudio
  adds -10000: the softmax of a row with a valid key is the same, since
  both weights underflow to 0;
* the measured model sets padded frames to zero after the extractor, after
  the positional embedding and after every layer, torchaudio only after
  the projection: padded frames differ, so only valid frames are compared.
  A padded frame enters a valid one through the positional convolution
  alone, and there both are zero.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .logmel import tf32 as _tf32


def output_length(length, layers):
    """Frames of the extractor for ``length`` samples (an int or a
    tensor)."""
    for _, k, s in layers:
        length = (length - k) // s + 1
    return length


def _layer_norm(x, p: dict, name: str):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], 1e-5)


def _linear(x, p: dict, name: str):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def extract(p: dict, x: torch.Tensor, a: dict) -> torch.Tensor:
    """``x (B, T)`` -> ``(B, T', C)``."""
    y = x[:, None]
    for i, (_, k, s) in enumerate(a["extractor_conv_layers"]):
        pre = f"feature_extractor.conv_layers.{i}."
        y = F.conv1d(y, p[pre + "conv.weight"], p.get(pre + "conv.bias"),
                     stride=s)
        if a["extractor_mode"] == "layer_norm":
            y = _layer_norm(y.transpose(1, 2), p,
                            pre + "layer_norm").transpose(1, 2)
        elif i == 0:
            y = F.group_norm(y, y.shape[1], p[pre + "layer_norm.weight"],
                             p[pre + "layer_norm.bias"], 1e-5)
        y = F.gelu(y)
    return y.transpose(1, 2)


def attention(p: dict, x: torch.Tensor, keys: torch.Tensor | None,
              heads: int, pre: str) -> torch.Tensor:
    """Self-attention of ``x (B, T, d)``; ``keys (B, T)`` True where a key
    is valid."""
    b, t, d = x.shape
    hd = d // heads
    q, k, v = (_linear(x, p, pre + name).view(b, t, heads, hd)
               .transpose(1, 2) for name in ("q_proj", "k_proj", "v_proj"))
    logits = q @ k.transpose(-1, -2) / math.sqrt(hd)
    if keys is not None:
        logits = logits.masked_fill(~keys[:, None, None, :],
                                    torch.finfo(logits.dtype).min)
    w = torch.softmax(logits, -1)
    return _linear((w @ v).transpose(1, 2).reshape(b, t, d), p,
                   pre + "out_proj")


def ffn(p: dict, x: torch.Tensor, pre: str) -> torch.Tensor:
    return _linear(F.gelu(_linear(x, p, pre + "intermediate_dense")), p,
                   pre + "output_dense")


def encode(p: dict, x: torch.Tensor, keys, a: dict) -> torch.Tensor:
    """The projected frames ``x (B, T', d)`` through the positional
    embedding and the layers."""
    k = a["pos_conv_kernel"]
    pos = F.conv1d(F.pad(x.transpose(1, 2), (k // 2, k // 2)),
                   p["encoder.pos_conv_embed.conv.weight"],
                   p["encoder.pos_conv_embed.conv.bias"],
                   groups=a["pos_conv_groups"])
    if k % 2 == 0:
        pos = pos[..., :-1]
    x = x + F.gelu(pos.transpose(1, 2))
    first = a["layer_norm_first"]
    if not first:
        x = _layer_norm(x, p, "encoder.layer_norm")
    for i in range(a["num_layers"]):
        pre = f"encoder.layers.{i}."
        if first:
            x = x + attention(p, _layer_norm(x, p, pre + "layer_norm"), keys,
                              a["num_heads"], pre + "attention.")
            x = x + ffn(p, _layer_norm(x, p, pre + "final_layer_norm"),
                        pre + "feed_forward.")
        else:
            x = _layer_norm(x + attention(p, x, keys, a["num_heads"],
                                          pre + "attention."),
                            p, pre + "layer_norm")
            x = _layer_norm(x + ffn(p, x, pre + "feed_forward."), p,
                            pre + "final_layer_norm")
    if first:
        x = _layer_norm(x, p, "encoder.layer_norm")
    return x


def forward(p: dict, x: torch.Tensor, lengths: torch.Tensor | None,
            a: dict, tf32: bool = False) -> tuple:
    """``x (B, T)`` zero past ``lengths (B,)`` (None: every clip whole) ->
    ``(logits (B, T', aux_out), out_lengths (B,))``; cuBLAS and cuDNN in
    TF32 only where ``tf32`` says so.  ``a``: the configuration's
    ``args``."""
    with _tf32(tf32):
        feats = extract(p, x, a)
        t = feats.shape[1]
        if lengths is None:
            out_lengths = torch.full((x.shape[0],), t, dtype=torch.long,
                                     device=x.device)
            keys = None
        else:
            out_lengths = output_length(lengths.to(x.device).long(),
                                        a["extractor_conv_layers"])
            keys = torch.arange(t, device=x.device)[None] \
                < out_lengths[:, None]
        h = _linear(_layer_norm(feats, p, "feature_projection.layer_norm"),
                    p, "feature_projection.projection")
        if keys is not None:
            h = torch.where(keys[..., None], h, 0.0)
        h = encode(p, h, keys, a)
        return _linear(h, p, "aux"), out_lengths


def collapse(path: torch.Tensor, blank: int = 0) -> list:
    """A best path's labels ``(T,)`` as a CTC answer: repeats merged, then
    blanks dropped."""
    out, prev = [], None
    for label in path.tolist():
        if label != prev and label != blank:
            out.append(label)
        prev = label
    return out
