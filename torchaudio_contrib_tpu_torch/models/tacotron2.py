"""Tacotron2 (Shen et al. 2018): text → mel spectrogram.

Port of ``torchaudio_contrib_tpu/models/tacotron2.py``: character (or
phone) embedding → three conv + BatchNorm + ReLU blocks → bidirectional
LSTM encoder → autoregressive decoder (prenet, attention LSTM cell,
location-sensitive attention, decoder LSTM cell, mel and stop-token
projections) → postnet residual.  ``forward``/``apply`` is the
teacher-forced pass, ``infer`` the free-running one; both return
``(mel, mel_postnet, stop_logits, alignments)``, ``infer`` adds
``lengths``.

As in the JAX package:

- pad positions are zeroed before and after each encoder conv, and the
  backward LSTM direction starts at each clip's own last token
  (``pack_padded_sequence``), so a clip's valid outputs do not depend on
  the batch's padding;
- the prenet runs without dropout (torchaudio applies dropout there even
  at inference);
- the LSTM cells are ``nn.LSTMCell`` (gates ``i, f, g, o``; the +1 forget
  bias is only the initial value of ``bias_ih``);
- the attention energies of pad tokens are ``masked_fill``-ed with
  ``-1e30`` before the softmax, so a clip with no token attends uniformly.

The ``state_dict`` names are torchaudio's (``encoder.convolutions.{i}.{0,1}``,
``encoder.lstm``, ``decoder.prenet.layers.{0,1}``,
``decoder.attention_layer…``, ``postnet.convolutions.{i}.{0,1}``), so the
JAX package's ``import_tacotron2`` loads them.  The JAX model holds each
BatchNorm as a frozen affine; here they are ``nn.BatchNorm1d`` modules,
which act as that affine in eval mode (``utils.convert`` carries one across
exactly).  The module is built in training mode, as torchaudio's; call
``eval()`` before inference (the bundles return it in eval mode).

The decoder is a Python loop of one step a frame, a few tens of small
launches each on the card.  ``forward`` and ``infer`` run the convolutions and the
encoder LSTM in FP32 whatever ``torch.backends.cudnn.allow_tf32`` says
(``_common._fp32_cudnn``).  Modules take ``device=`` (the card unless the
caller asks for the CPU) and draw their weights from ``generator``, as the
JAX ``init`` does from its key.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ._common import _conv, _dense, _fp32_cudnn, _glorot_

__all__ = ["Tacotron2"]

_NEG = -1e30


def _same(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (unpadded) on ``x (B, C, T)`` with XLA's "SAME" padding:
    ``(k-1)//2`` before, ``k//2`` after."""
    k = conv.kernel_size[0]
    return conv(F.pad(x, ((k - 1) // 2, k // 2)))


def _init_lstm(mod: nn.Module, cin: int, h: int, generator,
               suffix: str = "") -> None:
    """The JAX ``_lstm_params``: Glorot-uniform input and recurrent
    kernels, and one summed bias (here ``bias_ih``; ``bias_hh`` is 0)
    that starts at 1 on the forget gate."""
    _glorot_(getattr(mod, "weight_ih" + suffix), cin, 4 * h, generator)
    _glorot_(getattr(mod, "weight_hh" + suffix), h, 4 * h, generator)
    with torch.no_grad():
        b = getattr(mod, "bias_ih" + suffix)
        b.zero_()
        b[h:2 * h] = 1.0
        getattr(mod, "bias_hh" + suffix).zero_()


def _conv_bn(cin: int, cout: int, k: int, generator) -> nn.Sequential:
    """torchaudio's ``convolutions.{i}``: ``0`` the conv, ``1`` the
    BatchNorm (identity statistics: the JAX ``init``'s affine g=1, b=0)."""
    return nn.Sequential(_conv(cin, cout, k, generator), nn.BatchNorm1d(cout))


class _Encoder(nn.Module):
    def __init__(self, embed: int, enc: int, k: int, n_convs: int,
                 generator):
        super().__init__()
        self.convolutions = nn.ModuleList(
            _conv_bn(embed if i == 0 else enc, enc, k, generator)
            for i in range(n_convs))
        self.lstm = nn.LSTM(enc, enc // 2, batch_first=True,
                            bidirectional=True)
        for sfx in ("_l0", "_l0_reverse"):
            _init_lstm(self.lstm, enc, enc // 2, generator, sfx)


class _Prenet(nn.Module):
    def __init__(self, n_mels: int, dim: int, generator):
        super().__init__()
        self.layers = nn.ModuleList([_dense(n_mels, dim, generator, False),
                                     _dense(dim, dim, generator, False)])


class _LocationLayer(nn.Module):
    def __init__(self, filters: int, k: int, att: int, generator):
        super().__init__()
        self.location_conv = _conv(2, filters, k, generator, bias=False)
        self.location_dense = _dense(filters, att, generator, False)


class _Attention(nn.Module):
    def __init__(self, dec: int, enc: int, att: int, filters: int, k: int,
                 generator):
        super().__init__()
        self.query_layer = _dense(dec, att, generator, False)
        self.memory_layer = _dense(enc, att, generator, False)
        self.v = _dense(att, 1, generator, False)
        self.location_layer = _LocationLayer(filters, k, att, generator)


class _Decoder(nn.Module):
    def __init__(self, n_mels: int, enc: int, att: int, filters: int,
                 k: int, dec: int, prenet: int, generator):
        super().__init__()
        self.prenet = _Prenet(n_mels, prenet, generator)
        self.attention_rnn = nn.LSTMCell(prenet + enc, dec)
        _init_lstm(self.attention_rnn, prenet + enc, dec, generator)
        self.attention_layer = _Attention(dec, enc, att, filters, k,
                                          generator)
        self.decoder_rnn = nn.LSTMCell(dec + enc, dec)
        _init_lstm(self.decoder_rnn, dec + enc, dec, generator)
        self.linear_projection = _dense(dec + enc, n_mels, generator)
        self.gate_layer = _dense(dec + enc, 1, generator)


class _Postnet(nn.Module):
    def __init__(self, n_mels: int, dim: int, k: int, n_convs: int,
                 generator):
        super().__init__()
        chans = [n_mels] + [dim] * (n_convs - 1) + [n_mels]
        self.convolutions = nn.ModuleList(
            _conv_bn(chans[i], chans[i + 1], k, generator)
            for i in range(n_convs))


class Tacotron2(nn.Module):
    """``forward(tokens (B, S), token_lengths (B,), mels (B, n_mels, T))``
    → ``(mel (B, n_mels, T), mel_postnet, stop_logits (B, T), alignments
    (B, T, S))``; ``infer(tokens, token_lengths, max_steps, stop_threshold)``
    adds ``lengths (B,)``, each clip's first stop crossing (``max_steps``
    where there is none).  ``apply`` is ``forward`` (the JAX package's
    name; it shadows ``nn.Module.apply``)."""

    def __init__(self, n_symbols: int = 148, n_mels: int = 80,
                 embed_dim: int = 512, encoder_dim: int = 512,
                 attention_dim: int = 128, attention_filters: int = 32,
                 attention_kernel: int = 31, decoder_dim: int = 1024,
                 prenet_dim: int = 256, postnet_dim: int = 512,
                 postnet_kernel: int = 5, encoder_kernel: int = 5,
                 n_encoder_convs: int = 3, n_postnet_convs: int = 5, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if encoder_dim % 2:
            raise ValueError("encoder_dim must be even (biLSTM halves)")
        self.n_symbols = n_symbols
        self.n_mels = n_mels
        self.enc = encoder_dim
        self.dec = decoder_dim
        self.n_enc_convs = n_encoder_convs
        self.n_post_convs = n_postnet_convs
        self.embedding = nn.Embedding(n_symbols, embed_dim)
        with torch.no_grad():
            self.embedding.weight.normal_(generator=generator).mul_(0.3)
        self.encoder = _Encoder(embed_dim, encoder_dim, encoder_kernel,
                                n_encoder_convs, generator)
        self.decoder = _Decoder(n_mels, encoder_dim, attention_dim,
                                attention_filters, attention_kernel,
                                decoder_dim, prenet_dim, generator)
        self.postnet = _Postnet(n_mels, postnet_dim, postnet_kernel,
                                n_postnet_convs, generator)
        self.to(device)

    # -- encoder -----------------------------------------------------------
    def _encode(self, tokens, token_lengths):
        x = self.embedding(tokens)                          # (B, S, E)
        S = x.shape[1]
        mask = torch.arange(S, device=x.device)[None] < token_lengths[:, None]
        x = torch.where(mask[..., None], x, 0.0).transpose(1, 2)
        for block in self.encoder.convolutions:
            x = F.relu(block[1](_same(block[0], x)))
            x = torch.where(mask[:, None], x, 0.0)
        packed = pack_padded_sequence(
            x.transpose(1, 2), token_lengths.clamp(min=1).cpu(),
            batch_first=True, enforce_sorted=False)
        memory, _ = pad_packed_sequence(self.encoder.lstm(packed)[0],
                                        batch_first=True, total_length=S)
        return torch.where(mask[..., None], memory, 0.0), mask

    def _prenet(self, x):
        for lin in self.decoder.prenet.layers:
            x = F.relu(lin(x))
        return x

    # -- one decoder step ----------------------------------------------------
    def _step(self, memory, mem_proj, mask, carry, prev_frame):
        h_a, c_a, h_d, c_d, ctx, att_w, att_cum = carry
        d, att = self.decoder, self.decoder.attention_layer
        h_a, c_a = d.attention_rnn(
            torch.cat([self._prenet(prev_frame), ctx], -1), (h_a, c_a))
        loc = _same(att.location_layer.location_conv,
                    torch.stack([att_w, att_cum], 1))       # (B, F, S)
        loc = att.location_layer.location_dense(loc.transpose(1, 2))
        q = att.query_layer(h_a)[:, None]
        e = att.v(torch.tanh(q + mem_proj + loc))[..., 0]  # (B, S)
        w = torch.softmax(e.masked_fill(~mask, _NEG), -1)
        ctx = torch.bmm(w[:, None], memory)[:, 0]
        h_d, c_d = d.decoder_rnn(torch.cat([h_a, ctx], -1), (h_d, c_d))
        hc = torch.cat([h_d, ctx], -1)
        frame = d.linear_projection(hc)
        stop = d.gate_layer(hc)[..., 0]
        return (h_a, c_a, h_d, c_d, ctx, w, att_cum + w), (frame, stop, w)

    def _init_carry(self, b, s, ref):
        z = lambda n: ref.new_zeros((b, n))
        return (z(self.dec), z(self.dec), z(self.dec), z(self.dec),
                z(self.enc), z(s), z(s))

    def _postnet(self, mel):                            # (B, M, T)
        y = mel
        convs = self.postnet.convolutions
        for i, block in enumerate(convs):
            y = block[1](_same(block[0], y))
            if i < len(convs) - 1:
                y = torch.tanh(y)
        return mel + y

    def _prepare(self, tokens, token_lengths):
        dev = self.embedding.weight.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        if tokens.ndim != 2:
            raise ValueError("tokens must be (batch, symbols)")
        token_lengths = torch.as_tensor(token_lengths, device=dev).long()
        memory, mask = self._encode(tokens, token_lengths)
        return memory, self.decoder.attention_layer.memory_layer(memory), mask

    def _finish(self, frames, stops, alis):
        mel = torch.stack(frames, -1)                       # (B, M, T)
        return (mel, self._postnet(mel), torch.stack(stops, 1),
                torch.stack(alis, 1))

    # -- teacher-forced forward ---------------------------------------------
    @_fp32_cudnn
    def forward(self, tokens, token_lengths, mels: torch.Tensor):
        if mels.ndim != 3 or mels.shape[1] != self.n_mels:
            raise ValueError("tokens (B, S); mels (B, n_mels, T)")
        memory, mem_proj, mask = self._prepare(tokens, token_lengths)
        b, s = mask.shape
        carry = self._init_carry(b, s, memory)
        prev = memory.new_zeros((b, self.n_mels))
        frames, stops, alis = [], [], []
        for t in range(mels.shape[-1]):
            carry, (frame, stop, w) = self._step(memory, mem_proj, mask,
                                                 carry, prev)
            frames.append(frame)
            stops.append(stop)
            alis.append(w)
            prev = mels[:, :, t]
        return self._finish(frames, stops, alis)

    apply = forward

    # -- inference ------------------------------------------------------------
    @_fp32_cudnn
    def infer(self, tokens, token_lengths, max_steps: int = 200,
              stop_threshold: float = 0.5):
        memory, mem_proj, mask = self._prepare(tokens, token_lengths)
        b, s = mask.shape
        carry = self._init_carry(b, s, memory)
        prev = memory.new_zeros((b, self.n_mels))
        frames, stops, alis = [], [], []
        for _ in range(max_steps):
            carry, (prev, stop, w) = self._step(memory, mem_proj, mask,
                                                carry, prev)
            frames.append(prev)
            stops.append(stop)
            alis.append(w)
        mel, post, stop, ali = self._finish(frames, stops, alis)
        stopped = torch.sigmoid(stop) > stop_threshold
        lengths = torch.where(stopped.any(1),
                              stopped.int().argmax(1) + 1,
                              torch.full_like(stopped[:, 0], max_steps,
                                              dtype=torch.long))
        return mel, post, stop, ali, lengths.int()
