"""Wav2Vec2 acoustic encoder (Baevski et al. 2020) and WavLM.

Port of ``torchaudio_contrib_tpu/models/wav2vec2.py``: a strided conv
feature extractor (raw waveform → ~50 Hz frames) → feature projection → a
transformer encoder with a grouped-conv positional embedding; an optional
``aux_out`` linear head makes it a CTC model.

Both published variants, as the JAX package pins them:

- ``extractor_mode="layer_norm"`` (LARGE/XLS-R): a LayerNorm over channels
  after every extractor conv, conv biases.  ``"group_norm"`` (BASE): a
  per-channel ``nn.GroupNorm(C, C)`` after conv 0 only, no conv bias; its
  statistics run over time *including padding*, so that mode is not
  padding invariant (the published behaviour).
- ``layer_norm_first=True`` (pre-LN layers, ``encoder.layer_norm`` once at
  the output) or ``False`` (BASE: ``encoder.layer_norm`` after the
  positional conv, post-LN layers).

The ``state_dict`` names are the HF layout (``feature_extractor.conv_layers
.{i}.conv``, ``encoder.layers.{i}.attention.q_proj`` …, the CTC head
``aux``) that the JAX package's ``utils.import_torch.import_wav2vec2``
reads, so ``import_wav2vec2(model.state_dict(), jax_model)`` loads this
module's weights into the JAX model.  Attention is written out as products,
a ``masked_fill`` with the JAX constant ``-1e30`` and a softmax: a row with
no valid key (a clip whose ``output_length`` is 0) is uniform, where
``F.scaled_dot_product_attention`` with a boolean mask gives NaN.  The
positional conv is a grouped ``nn.Conv1d`` (cuDNN on the card, in FP32
whatever ``torch.backends.cudnn.allow_tf32`` says: ``forward`` runs under
``_common._fp32_cudnn``, the extractor's convs too), padded
``(k//2, (k-1)//2)``:
the same function as the JAX package's ``lax`` conv, summed in another
order.

Modules take ``device=`` (the card unless the caller asks for the CPU) and
draw their weights from ``generator`` (Glorot-uniform kernels, zero
biases, as the JAX ``init``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ._common import _dense, _fp32_cudnn, _glorot_

__all__ = ["Wav2Vec2", "Wav2Vec2Model", "WavLM", "wavlm_buckets",
           "wav2vec2_base", "wav2vec2_large", "wav2vec2_large_lv60k",
           "hubert_base", "hubert_large", "hubert_xlarge",
           "wavlm_base", "wavlm_large",
           "wav2vec2_xlsr_300m", "wav2vec2_xlsr_1b", "wav2vec2_xlsr_2b"]

_NEG = -1e30


def _conv_init(conv: nn.Conv1d, generator) -> nn.Conv1d:
    """The JAX package's ``_conv``: Glorot-uniform over ``k·cin`` in and
    ``k·cout`` out, zero bias."""
    cout, cin, k = conv.weight.shape
    _glorot_(conv.weight, k * cin, k * cout, generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
    return conv


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, bias: bool,
                 norm: Optional[str], generator):
        super().__init__()
        self.conv = _conv_init(nn.Conv1d(cin, cout, k, stride=s, bias=bias),
                               generator)
        self.norm = norm
        if norm == "layer_norm":
            self.layer_norm = nn.LayerNorm(cout)
        elif norm == "group_norm":
            self.layer_norm = nn.GroupNorm(cout, cout, eps=1e-5)

    def forward(self, y):                      # (B, C, T) → (B, C', T')
        y = self.conv(y)
        if self.norm == "layer_norm":
            y = self.layer_norm(y.transpose(1, 2)).transpose(1, 2)
        elif self.norm == "group_norm":
            y = self.layer_norm(y)
        return F.gelu(y)


class _FeatureExtractor(nn.Module):
    def __init__(self, layers, mode: str, bias: bool, generator):
        super().__init__()
        convs, cin = [], 1
        for i, (cout, k, s) in enumerate(layers):
            norm = "layer_norm" if mode == "layer_norm" else \
                ("group_norm" if i == 0 else None)
            convs.append(_ConvLayer(cin, cout, k, s, bias, norm, generator))
            cin = cout
        self.conv_layers = nn.ModuleList(convs)


class _FeatureProjection(nn.Module):
    def __init__(self, c: int, d: int, generator):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c)
        self.projection = _dense(c, d, generator)


class _PosConv(nn.Module):
    def __init__(self, d: int, k: int, groups: int, generator):
        super().__init__()
        self.conv = _conv_init(nn.Conv1d(d, d, k, groups=groups), generator)


class _Attention(nn.Module):
    """q, k and v as three linears (HF names), each drawn as its third of
    the JAX package's fused ``(d, 3d)`` kernel; WavLM's gate and (layer 0)
    bucket table beside them."""

    def __init__(self, d: int, h: int, generator, wavlm: bool = False,
                 num_buckets: int = 0, rel_table: bool = False):
        super().__init__()
        for name in ("q_proj", "k_proj", "v_proj"):
            lin = nn.Linear(d, d)
            _glorot_(lin.weight, d, 3 * d, generator)
            nn.init.zeros_(lin.bias)
            setattr(self, name, lin)
        self.out_proj = _dense(d, d, generator)
        if wavlm:
            self.gru_rel_pos_linear = _dense(d // h, 8, generator)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
            if rel_table:
                self.rel_attn_embed = nn.Embedding(num_buckets, h)
                with torch.no_grad():
                    self.rel_attn_embed.weight.normal_(
                        generator=generator).mul_(0.02)


class _FeedForward(nn.Module):
    def __init__(self, d: int, f: int, generator):
        super().__init__()
        self.intermediate_dense = _dense(d, f, generator)
        self.output_dense = _dense(f, d, generator)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _EncoderLayer(nn.Module):
    def __init__(self, d: int, h: int, f: int, generator, **wavlm):
        super().__init__()
        self.attention = _Attention(d, h, generator, **wavlm)
        self.layer_norm = nn.LayerNorm(d)
        self.feed_forward = _FeedForward(d, f, generator)
        self.final_layer_norm = nn.LayerNorm(d)


class _Encoder(nn.Module):
    def __init__(self, d: int, h: int, f: int, n: int, pos_k: int,
                 pos_groups: int, generator, num_buckets: int = 0):
        super().__init__()
        # the JAX init draws the positional conv after the layers
        layers = [_EncoderLayer(d, h, f, generator, wavlm=num_buckets > 0,
                                num_buckets=num_buckets, rel_table=i == 0)
                  for i in range(n)]
        self.pos_conv_embed = _PosConv(d, pos_k, pos_groups, generator)
        self.layer_norm = nn.LayerNorm(d)
        self.layers = nn.ModuleList(layers)


class Wav2Vec2(nn.Module):
    """``forward(waveforms (B, T), lengths=None)`` → ``(features (B, T',
    d_model) [or logits if aux_out], out_lengths)``.

    ``extractor_conv_layers`` is ``((channels, kernel, stride), ...)``; the
    default is the standard stack (total stride 320: 20 ms frames at 16
    kHz).  ``lengths`` give each clip's samples: frames past
    ``output_length(lengths)`` are zeroed at the extractor's output, before
    and after the positional conv and after every layer, and masked as
    attention keys.  The SSL hooks ``frame_mask (B, T') bool`` +
    ``mask_embedding (d_model,)`` replace the projected features at masked
    frames; ``return_features=True`` also returns the extractor's output
    ``(B, T', C)``.
    """

    _DEFAULT_EXTRACTOR = ((512, 10, 5), (512, 3, 2), (512, 3, 2),
                          (512, 3, 2), (512, 3, 2), (512, 2, 2),
                          (512, 2, 2))

    def __init__(self, extractor_conv_layers: Sequence[Tuple[int, int, int]]
                 = _DEFAULT_EXTRACTOR, d_model: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 ff_dim: int = 3072, pos_conv_kernel: int = 128,
                 pos_conv_groups: int = 16,
                 aux_out: Optional[int] = None,
                 extractor_mode: str = "layer_norm",
                 conv_bias: Optional[bool] = None,
                 layer_norm_first: bool = True, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 _num_buckets: int = 0):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must be divisible by num_heads")
        if d_model % pos_conv_groups:
            raise ValueError("d_model must be divisible by pos_conv_groups")
        if extractor_mode not in ("layer_norm", "group_norm"):
            raise ValueError(
                "extractor_mode must be 'layer_norm' or 'group_norm'")
        self.extractor = tuple(tuple(int(v) for v in l)
                               for l in extractor_conv_layers)
        self.d_model = d_model
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ff_dim = ff_dim
        self.pos_k = pos_conv_kernel
        self.pos_groups = pos_conv_groups
        self.aux_out = aux_out
        self.extractor_mode = extractor_mode
        # published defaults: the layer_norm extractor has conv biases
        # (fairseq LARGE), the group_norm one none (fairseq BASE)
        self.conv_bias = (extractor_mode == "layer_norm"
                          if conv_bias is None else bool(conv_bias))
        self.layer_norm_first = bool(layer_norm_first)
        self.feature_extractor = _FeatureExtractor(
            self.extractor, extractor_mode, self.conv_bias, generator)
        c = self.extractor[-1][0]
        self.feature_projection = _FeatureProjection(c, d_model, generator)
        self.encoder = _Encoder(d_model, num_heads, ff_dim, num_layers,
                                pos_conv_kernel, pos_conv_groups, generator,
                                _num_buckets)
        if aux_out is not None:
            self.aux = _dense(d_model, aux_out, generator)
        self.to(device)

    def output_length(self, length):
        """Frame count produced for an input sample count (exact; an int
        or a tensor)."""
        for _, k, s in self.extractor:
            length = (length - k) // s + 1
        return length

    def _extract(self, waveforms):
        y = waveforms[:, None]                        # (B, 1, T)
        for layer in self.feature_extractor.conv_layers:
            y = layer(y)
        return y.transpose(1, 2)                      # (B, T', C)

    def _pos_bias(self, t: int, device):
        """WavLM's ``(H, T, T)`` bucket bias (None here)."""
        return None

    def _attention(self, att: _Attention, x, pad_mask, pos_bias=None):
        b, t, d = x.shape
        h = self.num_heads
        hd = d // h
        q, k, v = (lin(x).view(b, t, h, hd).transpose(1, 2)
                   for lin in (att.q_proj, att.k_proj, att.v_proj))
        logits = q @ k.transpose(-1, -2) / math.sqrt(hd)
        if pos_bias is not None:
            # WavLM's gated relative position bias: per-(head, query)
            # gates from the PRE-projection input, reshaped per head
            gates = torch.sigmoid(att.gru_rel_pos_linear(
                x.view(b, t, h, hd)).view(b, t, h, 2, 4).sum(-1))
            gate = gates[..., 0] * (gates[..., 1]
                                    * att.gru_rel_pos_const.view(h)
                                    - 1.0) + 2.0            # (B, T, H)
            logits = logits + gate.transpose(1, 2)[..., None] * pos_bias
        if pad_mask is not None:
            logits = logits.masked_fill(~pad_mask[:, None, None, :], _NEG)
        w = torch.softmax(logits, -1)
        return att.out_proj((w @ v).transpose(1, 2).reshape(b, t, d))

    def encoder_layer(self, layer: _EncoderLayer, x, pad_mask=None,
                      pos_bias=None):
        """ONE transformer layer (``self.encoder.layers[i]``) on ``x (B,
        T', d_model)``; public, as the JAX package's, for a pipeline that
        streams the stack (the forward loops this same function)."""
        if self.layer_norm_first:
            x = x + self._attention(layer.attention, layer.layer_norm(x),
                                    pad_mask, pos_bias)
            x = x + layer.feed_forward(layer.final_layer_norm(x))
        else:
            x = layer.layer_norm(x + self._attention(layer.attention, x,
                                                     pad_mask, pos_bias))
            x = layer.final_layer_norm(x + layer.feed_forward(x))
        if pad_mask is not None:
            x = torch.where(pad_mask[..., None], x, 0.0)
        return x

    def _encode(self, x, pad_mask):
        pos_bias = self._pos_bias(x.shape[1], x.device)
        for layer in self.encoder.layers:
            x = self.encoder_layer(layer, x, pad_mask, pos_bias)
        if self.layer_norm_first:
            x = self.encoder.layer_norm(x)
            if pad_mask is not None:
                x = torch.where(pad_mask[..., None], x, 0.0)
        return x

    @_fp32_cudnn
    def forward(self, waveforms: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, *,
                frame_mask: Optional[torch.Tensor] = None,
                mask_embedding: Optional[torch.Tensor] = None,
                return_features: bool = False):
        if waveforms.ndim != 2:
            raise ValueError("waveforms must be (batch, time)")
        dev = waveforms.device
        feats = self._extract(waveforms)              # (B, T', C)
        t_out = feats.shape[1]
        pad_mask = None
        out_lengths = torch.full((waveforms.shape[0],), t_out,
                                 dtype=torch.long, device=dev)
        if lengths is not None:
            out_lengths = self.output_length(
                torch.as_tensor(lengths, device=dev).long())
            pad_mask = torch.arange(t_out, device=dev)[None] \
                < out_lengths[:, None]
            feats = torch.where(pad_mask[..., None], feats, 0.0)

        fp = self.feature_projection
        x = fp.projection(fp.layer_norm(feats))
        if frame_mask is not None:
            if mask_embedding is None:
                raise ValueError("frame_mask needs mask_embedding")
            x = torch.where(frame_mask[..., None], mask_embedding, x)
        # padded frames of x are not zero (layer_norm(0) is its bias):
        # zero them so that the positional conv sees the zeros its own
        # edge padding supplies
        if pad_mask is not None:
            x = torch.where(pad_mask[..., None], x, 0.0)
        # taps span offsets [-k//2, (k-1)//2] (the published conv pads k//2
        # on both sides and drops the last output for an even kernel)
        k = self.pos_k
        pos = self.encoder.pos_conv_embed.conv(
            F.pad(x.transpose(1, 2), (k // 2, (k - 1) // 2)))
        x = x + F.gelu(pos.transpose(1, 2))
        if not self.layer_norm_first:
            x = self.encoder.layer_norm(x)
        if pad_mask is not None:
            x = torch.where(pad_mask[..., None], x, 0.0)
        x = self._encode(x, pad_mask)
        if self.aux_out is not None:
            x = self.aux(x)
        if return_features:
            return x, out_lengths, feats
        return x, out_lengths


Wav2Vec2Model = Wav2Vec2


@functools.lru_cache(maxsize=16)
def _bucket_grid(t: int, num_buckets: int, max_distance: int) -> np.ndarray:
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]
    return wavlm_buckets(rel, num_buckets, max_distance)


def wavlm_buckets(rel, num_buckets: int, max_distance: int):
    """T5-style sign-separated half-exact/half-log bucket ids for an integer
    offset array ``rel = k - q`` (NumPy): a copy of the JAX package's, which
    its sequence-parallel attention also indexes by a 1-D offset range."""
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    arel = np.abs(rel)
    max_exact = nb // 2
    log_large = max_exact + (
        np.log(np.maximum(arel, 1) / max_exact)
        / math.log(max_distance / max_exact)
        * (nb - max_exact)).astype(np.int64)
    out += np.where(arel < max_exact, arel, np.minimum(log_large, nb - 1))
    return out


class WavLM(Wav2Vec2):
    """WavLM (Chen et al. 2022): a :class:`Wav2Vec2` whose self-attention
    adds a gated relative position bias.  Offsets ``k - q`` are bucketed
    (:func:`wavlm_buckets`) into one learned ``(num_buckets, num_heads)``
    table shared by all layers (``encoder.layers.0.attention
    .rel_attn_embed``, HF's place); each layer gates it per (head, query)
    from its attention input reshaped per head (``gru_rel_pos_linear``,
    ``gru_rel_pos_const``).  The bucket grid of a length is built once on
    the host and cached."""

    def __init__(self, *args, num_buckets: int = 320,
                 max_distance: int = 800, **kwargs):
        if num_buckets < 4 or num_buckets % 2:
            raise ValueError("num_buckets must be even and >= 4")
        if max_distance <= num_buckets // 4:
            raise ValueError("max_distance must exceed num_buckets//4")
        super().__init__(*args, _num_buckets=num_buckets, **kwargs)
        self.num_buckets = num_buckets
        self.max_distance = max_distance

    def _pos_bias(self, t: int, device):
        table = self.encoder.layers[0].attention.rel_attn_embed.weight
        idx = torch.from_numpy(_bucket_grid(t, self.num_buckets,
                                            self.max_distance)).to(device)
        return table[idx].permute(2, 0, 1)            # (H, T, T)


# -- standard configurations (torchaudio's wav2vec2_*/hubert_* zoo).  BASE
# geometries use the group_norm extractor + post-LN encoder; LARGE+ the
# layer_norm extractor (conv bias) + pre-LN encoder, as the JAX package
# pins them (wav2vec2 LARGE keeps BASE's normalisation).
def _factory(cls, aux_out, device, generator, **kw):
    return cls(aux_out=aux_out, device=device, generator=generator, **kw)


_BASE = dict(extractor_mode="group_norm", layer_norm_first=False)
_LARGE = dict(d_model=1024, num_layers=24, num_heads=16, ff_dim=4096)
_XL = dict(d_model=1280, num_layers=48, num_heads=16, ff_dim=5120)


def wav2vec2_base(aux_out: Optional[int] = None, *, device="cuda",
                  generator: Optional[torch.Generator] = None) -> Wav2Vec2:
    """BASE: 12 layers, d 768, 12 heads, FFN 3072 (95 M parameters)."""
    return _factory(Wav2Vec2, aux_out, device, generator, **_BASE)


def wav2vec2_large(aux_out: Optional[int] = None, *, device="cuda",
                   generator: Optional[torch.Generator] = None) -> Wav2Vec2:
    """LARGE (LibriSpeech-960): 24 layers, d 1024, 16 heads, FFN 4096, with
    BASE's normalisation (group_norm extractor, post-LN encoder)."""
    return _factory(Wav2Vec2, aux_out, device, generator, **_LARGE, **_BASE)


def wav2vec2_large_lv60k(aux_out: Optional[int] = None, *, device="cuda",
                         generator: Optional[torch.Generator] = None
                         ) -> Wav2Vec2:
    """LARGE (LibriVox-60k): the layer_norm extractor + pre-LN encoder."""
    return _factory(Wav2Vec2, aux_out, device, generator, **_LARGE)


def hubert_base(aux_out: Optional[int] = None, *, device="cuda",
                generator: Optional[torch.Generator] = None) -> Wav2Vec2:
    """HuBERT BASE: wav2vec2 BASE's encoder (the objective differs)."""
    return _factory(Wav2Vec2, aux_out, device, generator, **_BASE)


def hubert_large(aux_out: Optional[int] = None, *, device="cuda",
                 generator: Optional[torch.Generator] = None) -> Wav2Vec2:
    return _factory(Wav2Vec2, aux_out, device, generator, **_LARGE)


def hubert_xlarge(aux_out: Optional[int] = None, *, device="cuda",
                  generator: Optional[torch.Generator] = None) -> Wav2Vec2:
    """XLARGE: 48 layers, d 1280, 16 heads, FFN 5120 (~1 B parameters)."""
    return _factory(Wav2Vec2, aux_out, device, generator, **_XL)


def wavlm_base(aux_out: Optional[int] = None, *, device="cuda",
               generator: Optional[torch.Generator] = None) -> WavLM:
    """WavLM BASE: wav2vec2 BASE + the gated bias (320 buckets, max
    distance 800)."""
    return _factory(WavLM, aux_out, device, generator, **_BASE)


def wavlm_large(aux_out: Optional[int] = None, *, device="cuda",
                generator: Optional[torch.Generator] = None) -> WavLM:
    """WavLM LARGE: 24 layers, d 1024, 16 heads, FFN 4096."""
    return _factory(WavLM, aux_out, device, generator, **_LARGE)


def wav2vec2_xlsr_300m(aux_out: Optional[int] = None, *, device="cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> Wav2Vec2:
    """XLS-R 0.3 B: the LARGE encoder geometry."""
    return _factory(Wav2Vec2, aux_out, device, generator, **_LARGE)


def wav2vec2_xlsr_1b(aux_out: Optional[int] = None, *, device="cuda",
                     generator: Optional[torch.Generator] = None
                     ) -> Wav2Vec2:
    """XLS-R 1 B: 48 layers, d 1280, 16 heads, FFN 5120."""
    return _factory(Wav2Vec2, aux_out, device, generator, **_XL)


def wav2vec2_xlsr_2b(aux_out: Optional[int] = None, *, device="cuda",
                     generator: Optional[torch.Generator] = None
                     ) -> Wav2Vec2:
    """XLS-R 2 B: 48 layers, d 1920, 16 heads, FFN 7680."""
    return _factory(Wav2Vec2, aux_out, device, generator, d_model=1920,
                    num_layers=48, num_heads=16, ff_dim=7680)
