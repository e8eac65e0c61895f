"""Emformer: the streaming encoder of the Emformer-RNNT.

Port of ``torchaudio_contrib_tpu/models/emformer.py`` (Shi et al. 2021):
block processing with hard-copied right context, cached left context and
an averaged memory bank, so that chunkwise :meth:`Emformer.infer` equals
the full-utterance ``forward``.  Attention runs over ``(batch, segment)``
with per-segment queries ``[segment, right context, summary]`` and keys
``[memory bank, left context, segment, right context]``; which keys a
query sees is decided from stream coordinates alike in both modes (the
JAX module's docstring sets the rules out).

Masked attention replaces a masked logit by ``-1e9`` (``masked_fill``),
as the JAX package's ``jnp.where`` does, so that a row whose keys are all
masked (a padded sample, a stream's tail) gets uniform weights where
``F.scaled_dot_product_attention`` would give NaN: attention is written
out as products, a fill and a softmax.

``compat="torchaudio"`` is torchaudio's ``_EmformerLayer`` layout (a
``layer_norm_output`` after each layer, memory keys not normalised, the
memory taken from the context before ``out_proj``), and the
``state_dict`` names are torchaudio's in both builds
(``emformer_layers.{i}.attention.emb_to_query`` …).

Each module takes ``device=`` (the card unless the caller asks for the
CPU) and draws its weights from ``generator`` (Glorot-uniform, zero
biases).  Streaming state is a dict of tensors and a segment counter;
:meth:`Emformer.infer` returns a new state and never writes into the one
it was given, so a caller may replay a chunk.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ._common import _dense, _fp32_cudnn, _glorot_

__all__ = ["Emformer", "ConvEmformer", "EmformerTranscriber"]

_NEG = -1e9
_ACTIVATIONS = {"relu": nn.ReLU, "gelu": nn.GELU, "silu": nn.SiLU}


class _Attention(nn.Module):
    """torchaudio's ``_EmformerAttention`` parameters: the key and value
    projections packed as one ``(2d, d)`` linear, keys first."""

    def __init__(self, d: int, generator):
        super().__init__()
        self.emb_to_query = _dense(d, d, generator)
        self.emb_to_key_value = nn.Linear(d, 2 * d)
        _glorot_(self.emb_to_key_value.weight[:d], d, d, generator)
        _glorot_(self.emb_to_key_value.weight[d:], d, d, generator)
        nn.init.zeros_(self.emb_to_key_value.bias)
        self.out_proj = _dense(d, d, generator)


class _ConvModule(nn.Module):
    """ConvEmformer's convolution module: pre-LN, pointwise GLU, causal
    depthwise convolution, SiLU, pointwise projection."""

    def __init__(self, d: int, kernel_size: int, generator):
        super().__init__()
        self.layer_norm = nn.LayerNorm(d)
        self.pointwise_conv1 = _dense(d, 2 * d, generator)
        self.depthwise_conv = nn.Conv1d(d, d, kernel_size, groups=d,
                                        bias=False)
        s = math.sqrt(6.0 / (kernel_size + 2 * d))
        with torch.no_grad():
            self.depthwise_conv.weight.uniform_(-s, s, generator=generator)
        self.pointwise_conv2 = _dense(d, d, generator)


class _Layer(nn.Module):
    def __init__(self, d: int, ffn_dim: int, activation: str, compat,
                 generator):
        super().__init__()
        self.layer_norm_input = nn.LayerNorm(d)
        self.attention = _Attention(d, generator)
        self.pos_ff = nn.Sequential(
            nn.LayerNorm(d), _dense(d, ffn_dim, generator),
            _ACTIVATIONS[activation](), nn.Dropout(0.0),
            _dense(ffn_dim, d, generator))
        if compat:
            self.layer_norm_output = nn.LayerNorm(d)


class Emformer(nn.Module):
    """``forward(x (B, T+R, D), lengths)`` → ``(out (B, T, D), lengths)``:
    the utterance right-padded with ``R`` lookahead frames (torchaudio's
    convention); ``T`` need not be a segment multiple.
    ``init_state(B)`` + ``infer(chunk (B, S+R, D), state, utt_lengths,
    rc_lengths)`` → ``(out (B, S, D), out_lengths, state)`` advances one
    segment a call."""

    def __init__(self, input_dim: int, num_heads: int, ffn_dim: int,
                 num_layers: int, segment_length: int,
                 left_context_length: int = 0,
                 right_context_length: int = 0,
                 max_memory_size: int = 0,
                 tanh_on_mem: bool = False,
                 activation: str = "relu",
                 compat: Optional[str] = None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if input_dim % num_heads:
            raise ValueError("input_dim must be divisible by num_heads")
        if segment_length < 1:
            raise ValueError("segment_length must be >= 1")
        if activation not in _ACTIVATIONS:
            raise ValueError("activation must be relu/gelu/silu")
        if compat not in (None, "torchaudio"):
            raise ValueError("compat must be None or 'torchaudio'")
        self.d = input_dim
        self.h = num_heads
        self.n_layers = num_layers
        self.S = segment_length
        self.L = left_context_length
        self.R = right_context_length
        self.M = max_memory_size
        self.tanh_on_mem = tanh_on_mem
        self.compat = compat
        self.emformer_layers = nn.ModuleList(
            _Layer(input_dim, ffn_dim, activation, compat, generator)
            for _ in range(num_layers))
        if not compat:
            self.output_layer_norm = nn.LayerNorm(input_dim)
        self.to(device)

    def _device(self) -> torch.device:
        return self.emformer_layers[0].layer_norm_input.weight.device

    # -- attention over one segment (leading dims arbitrary) -------------
    def _attend(self, att: _Attention, q, kv, kmask):
        """Returns ``(projected output, context before out_proj)``; the
        latter feeds the compat build's memory chain."""
        h, dh = self.h, self.d // self.h
        qh = att.emb_to_query(q).unflatten(-1, (h, dh)).transpose(-3, -2)
        k, v = att.emb_to_key_value(kv).chunk(2, -1)
        kh = k.unflatten(-1, (h, dh)).transpose(-3, -2)
        vh = v.unflatten(-1, (h, dh)).transpose(-3, -2)
        logits = qh @ kh.transpose(-1, -2) / math.sqrt(dh)
        logits = logits.masked_fill(~kmask[..., None, None, :], _NEG)
        w = torch.softmax(logits, -1)
        ctx = (w @ vh).transpose(-3, -2).flatten(-2)
        return att.out_proj(ctx), ctx

    def _post_attention(self, layer, utt_a, rc_a, masks, conv_cache):
        """Hook between the attention residual and the FFN: identity here;
        :class:`ConvEmformer` inserts its convolution module."""
        return utt_a, rc_a, None

    def _layer_body(self, layer, utt, lc, rc, bank, masks,
                    conv_cache=None):
        """One layer on raw (pre-LN) ``utt (..., S, D)``, ``lc (..., L,
        D)``, ``rc (..., R, D)``, ``bank (..., M, D)``; masks = (lc_m,
        seg_m, rc_m, mem_m).  Returns (utt', rc', summary output, conv
        cache)."""
        lc_m, seg_m, rc_m, mem_m = masks
        S, R = self.S, self.R
        ln1 = layer.layer_norm_input
        n_utt = ln1(utt)
        n_lc = ln1(lc) if self.L else lc
        n_rc = ln1(rc) if R else rc
        # torchaudio norms only [right_context, utterance]; memory keys
        # enter attention raw there
        n_bank = bank if (self.compat or not self.M) else ln1(bank)
        summary = torch.where(seg_m[..., None], n_utt, 0.0).mean(
            -2, keepdim=True)
        q = torch.cat([n_utt, n_rc, summary], -2)
        kv = torch.cat([n_bank, n_lc, n_utt, n_rc], -2)
        kmask = torch.cat([mem_m, lc_m, seg_m, rc_m], -1)
        o, ctx = self._attend(layer.attention, q, kv, kmask)
        utt_a = utt + o[..., :S, :]
        rc_a = rc + o[..., S:S + R, :] if R else rc
        utt_a, rc_a, new_cache = self._post_attention(
            layer, utt_a, rc_a, masks, conv_cache)
        utt2 = utt_a + layer.pos_ff(utt_a)
        rc2 = rc_a + layer.pos_ff(rc_a) if R else rc_a
        if self.compat:
            utt2 = layer.layer_norm_output(utt2)
            rc2 = layer.layer_norm_output(rc2) if R else rc2
            m_out = ctx[..., -1, :]          # before out_proj (torchaudio)
            m_out = torch.tanh(m_out) if self.tanh_on_mem \
                else m_out.clamp(-10.0, 10.0)
        else:
            m_out = o[..., -1, :]
            if self.tanh_on_mem:
                m_out = torch.tanh(m_out)
        return utt2, rc2, m_out, new_cache

    def _out(self, utt):
        return utt if self.compat else self.output_layer_norm(utt)

    # -- full-utterance forward ------------------------------------------
    @_fp32_cudnn
    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None):
        B, TR, D = x.shape
        if D != self.d:
            raise ValueError(f"input dim {D} != {self.d}")
        S, L, R, M = self.S, self.L, self.R, self.M
        T = TR - R
        if T < 1:
            raise ValueError("need at least one utterance frame")
        dev = x.device
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.long, device=dev)
        lengths = torch.as_tensor(lengths, device=dev).long().clamp(max=T)
        nseg = -(-T // S)
        Tp = nseg * S
        xp = F.pad(x[:, :T], (0, 0, 0, Tp - T))
        # stream-extended values: utterance, padding, then the lookahead
        # tail at position T + r, as in stream coordinates
        ext = F.pad(x, (0, 0, 0, Tp - T))                 # (B, Tp+R, D)

        seg_ids = torch.arange(nseg, device=dev)[:, None]
        seg_c = seg_ids * S + torch.arange(S, device=dev)
        lc_c = seg_ids * S - L + torch.arange(max(L, 1), device=dev)
        # hard-copied right context starts where the segment's valid
        # frames end: min((i+1)S, T)
        rc_c = ((seg_ids + 1) * S).clamp(max=T) \
            + torch.arange(max(R, 1), device=dev)
        mem_j = seg_ids - M + torch.arange(max(M, 1), device=dev)

        len_b = lengths[:, None, None]
        # full-length samples own the appended R-frame tail
        ext_len = (lengths + torch.where(lengths == T, R, 0))[:, None, None]
        empty = torch.zeros((B, nseg, 0), dtype=torch.bool, device=dev)
        seg_m = seg_c[None] < len_b
        lc_m = ((lc_c[None] >= 0) & (lc_c[None] < len_b)) if L else empty
        rc_m = (rc_c[None] < ext_len) if R else empty
        mem_m = ((mem_j[None] >= 0) & (mem_j[None] * S < len_b)) if M \
            else empty
        masks = (lc_m, seg_m, rc_m, mem_m)

        utt = torch.where(seg_m[..., None], xp.reshape(B, nseg, S, D), 0.0)
        none = x.new_zeros((B, nseg, 0, D))
        if R:
            rc = ext[:, rc_c.reshape(-1)].reshape(B, nseg, R, D)
            rc = torch.where(rc_m[..., None], rc, 0.0)
        else:
            rc = none

        # layer 0's memory chain: mean-pooled raw input segments
        mems = utt.mean(-2)                               # (B, nseg, D)
        mem_g = mem_j.clamp(0, nseg - 1).reshape(-1)
        lc_g = lc_c.clamp(0, Tp - 1).reshape(-1)
        for layer in self.emformer_layers:
            bank = mems[:, mem_g].reshape(B, nseg, M, D) if M else none
            lc = utt.reshape(B, Tp, D)[:, lc_g].reshape(B, nseg, L, D) \
                if L else none
            utt, rc, mems, _ = self._layer_body(layer, utt, lc, rc, bank,
                                                masks)
        out = self._out(utt).reshape(B, Tp, D)[:, :T]
        valid = torch.arange(T, device=dev)[None, :, None] < len_b
        return torch.where(valid, out, 0.0), lengths

    # -- streaming --------------------------------------------------------
    def init_state(self, batch_size: int, device=None) -> dict:
        """Zeroed streaming state; validity comes from the segment counter
        ``seg`` and the per-sample frames ``seen`` so far."""
        dev = self._device() if device is None else device
        L, M, D = max(self.L, 1), max(self.M, 1), self.d
        return {"layers": [{"lc": torch.zeros((batch_size, L, D),
                                              device=dev),
                            "bank": torch.zeros((batch_size, M, D),
                                                device=dev)}
                           for _ in range(self.n_layers)],
                "seg": 0,
                "seen": torch.zeros((batch_size,), dtype=torch.long,
                                    device=dev)}

    @_fp32_cudnn
    def infer(self, chunk: torch.Tensor, state: dict,
              utt_lengths: Optional[torch.Tensor] = None,
              rc_lengths: Optional[torch.Tensor] = None):
        """One segment: ``chunk (B, S+R, D)`` = ``S`` utterance slots
        (zero-padded past the stream's end) + ``R`` lookahead frames;
        ``utt_lengths`` (B,) the valid new utterance frames (default S),
        ``rc_lengths`` (B,) the valid lookahead frames (default R: pass
        fewer at the stream's end).  Returns a new state."""
        B, SR, D = chunk.shape
        S, L, R, M = self.S, self.L, self.R, self.M
        if SR != S + R:
            raise ValueError(f"chunk must have {S + R} frames, got {SR}")
        dev = chunk.device
        i, seen = state["seg"], state["seen"]
        utt_len = torch.full((B,), S, dtype=torch.long, device=dev) \
            if utt_lengths is None \
            else torch.as_tensor(utt_lengths, device=dev).long().clamp(0, S)
        rc_len = torch.full((B,), R, dtype=torch.long, device=dev) \
            if rc_lengths is None \
            else torch.as_tensor(rc_lengths, device=dev).long().clamp(0, R)

        empty = torch.zeros((B, 0), dtype=torch.bool, device=dev)
        seg_m = torch.arange(S, device=dev)[None] < utt_len[:, None]
        rc_m = (torch.arange(max(R, 1), device=dev)[None]
                < rc_len[:, None]) if R else empty
        lc_c = i * S - L + torch.arange(max(L, 1), device=dev)[None]
        lc_m = ((lc_c >= 0) & (lc_c < seen[:, None])) if L else empty
        mem_j = i - M + torch.arange(max(M, 1), device=dev)[None]
        mem_m = ((mem_j >= 0) & (mem_j * S < seen[:, None])) if M \
            else empty
        masks = (lc_m, seg_m, rc_m, mem_m)

        none = chunk.new_zeros((B, 0, D))
        utt = torch.where(seg_m[..., None], chunk[:, :S], 0.0)
        rc = torch.where(rc_m[..., None], chunk[:, S:], 0.0) if R else none
        m_in = utt.mean(-2)                  # layer 0's memory element
        new_layers = []
        for layer, st in zip(self.emformer_layers, state["layers"]):
            lc = st["lc"][:, -L:] if L else none
            bank = st["bank"][:, -M:] if M else none
            # cache this layer's input before computing its output
            new_st = {
                "lc": torch.cat([st["lc"], utt], 1)[:, -max(L, 1):]
                if L else st["lc"],
                "bank": torch.cat([st["bank"], m_in[:, None]],
                                  1)[:, -max(M, 1):]
                if M else st["bank"],
            }
            utt, rc, m_in, new_cache = self._layer_body(
                layer, utt, lc, rc, bank, masks, conv_cache=st.get("conv"))
            if new_cache is not None:
                new_st["conv"] = new_cache
            new_layers.append(new_st)
        out = torch.where(seg_m[..., None], self._out(utt), 0.0)
        return out, utt_len, {"layers": new_layers, "seg": i + 1,
                              "seen": seen + utt_len}


class ConvEmformer(Emformer):
    """Emformer with a convolution module in each layer, between the
    attention residual and the FFN: pre-LN → pointwise GLU → causal
    depthwise convolution (``kernel_size`` taps, left-padded by the
    previous segment's last ``kernel_size − 1`` frames after attention) →
    SiLU → pointwise → residual.  The right context rides the same
    convolution as the segment's continuation, so chunkwise ``infer``
    still equals ``forward``; the state gains a ``(B, kernel_size − 1,
    D)`` cache a layer.  The depthwise convolution is one grouped
    ``F.conv1d`` (cuDNN on the card, in FP32 whatever
    ``torch.backends.cudnn.allow_tf32`` says: ``forward`` and ``infer`` run
    under ``_common._fp32_cudnn``)."""

    def __init__(self, input_dim: int, num_heads: int, ffn_dim: int,
                 num_layers: int, segment_length: int,
                 kernel_size: int = 31, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 **emformer_kwargs):
        if kernel_size < 1:
            raise ValueError("kernel_size must be >= 1")
        super().__init__(input_dim, num_heads, ffn_dim, num_layers,
                         segment_length, device="cpu", generator=generator,
                         **emformer_kwargs)
        self.K = kernel_size
        for layer in self.emformer_layers:
            layer.conv_module = _ConvModule(input_dim, kernel_size,
                                            generator)
        self.to(device)

    def init_state(self, batch_size: int, device=None) -> dict:
        state = super().init_state(batch_size, device)
        for st in state["layers"]:
            st["conv"] = torch.zeros((batch_size, max(self.K - 1, 1),
                                      self.d), device=st["lc"].device)
        return state

    def _post_attention(self, layer, utt_a, rc_a, masks, conv_cache):
        _, seg_m, rc_m, _ = masks
        S, R, D = self.S, self.R, self.d
        km1 = self.K - 1
        # zero invalid slots so the convolution never mixes in attention
        # output of padding (the same in both modes)
        utt_a = torch.where(seg_m[..., None], utt_a, 0.0)
        if R:
            rc_a = torch.where(rc_m[..., None], rc_a, 0.0)
        if conv_cache is None:
            # full mode, utt_a (B, nseg, S, D): segment i's cache is
            # segment i-1's last K-1 frames after attention
            B, nseg = utt_a.shape[:2]
            coords = (torch.arange(nseg, device=utt_a.device)[:, None] * S
                      - km1 + torch.arange(km1, device=utt_a.device))
            g = utt_a.reshape(B, nseg * S, D)[:, coords.clamp(min=0)
                                              .reshape(-1)]
            cache_v = torch.where((coords >= 0)[None, ..., None],
                                  g.reshape(B, nseg, km1, D), 0.0)
            new_cache = None
        else:
            cache_v = conv_cache[:, :km1]
            new_cache = torch.cat([conv_cache, utt_a], -2)[:, -max(km1, 1):] \
                if km1 else conv_cache

        cm = layer.conv_module
        x = torch.cat([cache_v, utt_a] + ([rc_a] if R else []), -2)
        y = F.glu(cm.pointwise_conv1(cm.layer_norm(x)), -1)
        lead = y.shape[:-2]
        y = F.conv1d(y.reshape((-1,) + y.shape[-2:]).transpose(1, 2),
                     cm.depthwise_conv.weight, groups=D)
        y = y.transpose(1, 2).reshape(lead + (S + R, D))
        out = cm.pointwise_conv2(F.silu(y))
        utt_a = utt_a + out[..., :S, :]
        if R:
            rc_a = rc_a + out[..., S:, :]
        return utt_a, rc_a, new_cache


class EmformerTranscriber(nn.Module):
    """torchaudio's ``_EmformerEncoder`` around the compat Emformer:
    ``input_linear`` (no bias) → stride-``s`` frame stacking ``(B, T, D)
    → (B, T/s, D·s)`` → ``transformer`` (``Emformer(compat=
    "torchaudio")``) → ``output_linear`` → ``layer_norm``.

    Lengths are in input (mel-frame) units and come back in reduced units
    (``lengths // s``).  ``segment_length`` and ``right_context_length``
    are in input units and must be multiples of the stride, and so must
    the utterance length ``T`` that ``forward(x (B, T + R, input_dim))``
    is given.  Streaming: ``init_state(B)`` + ``infer(chunk (B,
    segment_length + right_context_length, input_dim), state,
    utt_lengths, rc_lengths)``."""

    def __init__(self, *, input_dim: int, output_dim: int,
                 segment_length: int, right_context_length: int,
                 time_reduction_input_dim: int,
                 time_reduction_stride: int,
                 num_heads: int = 8, ffn_dim: int = 2048,
                 num_layers: int = 20,
                 left_context_length: int = 30,
                 max_memory_size: int = 0,
                 activation: str = "gelu",
                 tanh_on_mem: bool = True, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        s = time_reduction_stride
        if segment_length % s or right_context_length % s:
            raise ValueError(
                "segment_length and right_context_length must be "
                f"divisible by time_reduction_stride={s}")
        self.input_dim = input_dim
        self.stride = s
        self.S_in = segment_length
        self.R_in = right_context_length
        d = time_reduction_input_dim * s
        self.input_linear = _dense(input_dim, time_reduction_input_dim,
                                   generator, bias=False)
        self.transformer = Emformer(
            d, num_heads, ffn_dim, num_layers, segment_length // s,
            left_context_length=left_context_length,
            right_context_length=right_context_length // s,
            max_memory_size=max_memory_size, tanh_on_mem=tanh_on_mem,
            activation=activation, compat="torchaudio", device="cpu",
            generator=generator)
        self.output_linear = _dense(d, output_dim, generator)
        self.layer_norm = nn.LayerNorm(output_dim)
        self.to(device)

    def _reduce(self, y):
        B, T, D = y.shape
        return y.reshape(B, T // self.stride, D * self.stride)

    def _head(self, feats):
        return self.layer_norm(self.output_linear(feats))

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None):
        B, TR, _ = x.shape
        s = self.stride
        T = TR - self.R_in
        if T < 1 or T % s:
            raise ValueError(
                f"utterance length {T} (input frames {TR} minus right "
                f"context {self.R_in}) must be a positive multiple of the "
                f"time-reduction stride {s}")
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.long)
        lengths = torch.as_tensor(lengths, device=x.device).long()
        out, out_lengths = self.transformer(
            self._reduce(self.input_linear(x)), lengths // s)
        return self._head(out), out_lengths

    def init_state(self, batch_size: int, device=None) -> dict:
        return self.transformer.init_state(batch_size, device)

    def infer(self, chunk: torch.Tensor, state: dict,
              utt_lengths=None, rc_lengths=None):
        """One segment; ``chunk (B, S_in + R_in, input_dim)``, lengths in
        input units."""
        if chunk.shape[1] != self.S_in + self.R_in:
            raise ValueError(
                f"chunk must have {self.S_in + self.R_in} frames")
        s = self.stride
        out, out_lengths, state = self.transformer.infer(
            self._reduce(self.input_linear(chunk)), state,
            None if utt_lengths is None
            else torch.as_tensor(utt_lengths).long() // s,
            None if rc_lengths is None
            else torch.as_tensor(rc_lengths).long() // s)
        return self._head(out), out_lengths, state
