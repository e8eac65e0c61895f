"""Hybrid Demucs (v3) music source separation, the JAX package's own
redesign (Défossez 2021).

Port of ``torchaudio_contrib_tpu/models/hdemucs.py``: a time-domain U-Net
and a frequency-domain (complex-as-channels) U-Net that merge into shared
inner layers and split again; each encoder layer carries a dilated-conv
residual stack (``DConv``), with a BiLSTM and a banded self-attention in
the shared layers; the model sums one waveform per source from each
branch (the frequency branch through an ISTFT).

The geometry is the JAX model's, not torchaudio's (``HDemucsTA`` is that
one): the STFT hop is ``stride**depth`` (256 at nfft 4096, the branches
then align at the merge), the input is padded to ``hop·stride**shared``
and cropped back, the frequency layers convolve the frequency axis with
time folded into the batch, a kernel-``Fm`` conv merges the remaining
frequency bins and its transpose unmerges them.  Normalisation is the
JAX model's: a channel LayerNorm after each encoder/decoder conv,
GroupNorm(1) inside DConv, per-clip standardisation with the population
standard deviation plus 1e-5 outside the square root.  The GELUs are the
tanh form (``jax.nn.gelu``'s default), the LSTM gates i, f, o, u in the
JAX parameters (``utils.convert`` permutes them into ``nn.LSTM``'s i, f,
g, o); the band attention masks with ``masked_fill`` at −1e9.

``forward(mix (B, audio_channels, T))`` → ``(B, n_sources,
audio_channels, T)``.  ``forward`` runs the convolutions and the LSTM in
FP32 whatever ``torch.backends.cudnn.allow_tf32`` says, and so does a
backward pass through its output (``_common._fp32_cudnn``).  Weights are
drawn from ``generator`` as the JAX ``init`` draws them (Glorot-uniform,
zero biases, unit norms, LayerScale 0.1, the frequency embedding
N(0, 0.2²)).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import istft, stft
from ._common import _fp32_cudnn, _glorot_

__all__ = ["HDemucs"]


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _conv(cin, cout, k, generator, **kw) -> nn.Conv1d:
    """Bias-free ``nn.Conv1d`` with the JAX ``_conv_w`` init."""
    conv = nn.Conv1d(cin, cout, k, bias=False, **kw)
    _glorot_(conv.weight, k * cin, k * cout, generator)
    return conv


def _dense(cin, cout, generator) -> nn.Linear:
    lin = nn.Linear(cin, cout, bias=False)
    _glorot_(lin.weight, cin, cout, generator)
    return lin


def _glu(x):
    a, b = x.chunk(2, dim=1)
    return a * torch.sigmoid(b)


class _ChannelNorm(nn.LayerNorm):
    """LayerNorm over the channels of ``(N, C, L)`` (the JAX ``_ln`` on
    its channels-last layout)."""

    def forward(self, x):
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class _BiLSTM(nn.Module):
    """The JAX ``_bilstm``: one bidirectional LSTM layer and a bias-free
    projection, on ``(N, H, L)``."""

    def __init__(self, hid: int, generator):
        super().__init__()
        self.lstm = nn.LSTM(hid, hid, bidirectional=True, batch_first=True)
        for name, p in self.lstm.named_parameters():
            if name.startswith("weight"):
                _glorot_(p, hid, 8 * hid, generator)
            else:
                nn.init.zeros_(p)
        self.proj = _dense(2 * hid, hid, generator)

    def forward(self, x):
        return self.proj(self.lstm(x.transpose(1, 2))[0]).transpose(1, 2)


class _BandAttention(nn.Module):
    """One-head self-attention within ±``window`` steps on ``(N, H, L)``."""

    def __init__(self, hid: int, window: int, generator):
        super().__init__()
        self.window = window
        self.norm = nn.LayerNorm(hid)
        self.qkv = _dense(hid, 3 * hid, generator)
        self.out = _dense(hid, hid, generator)

    def forward(self, x):
        L, H = x.shape[-1], x.shape[1]
        q, k, v = self.qkv(self.norm(x.transpose(1, 2))).chunk(3, dim=-1)
        logits = q @ k.transpose(1, 2) / math.sqrt(H)
        idx = torch.arange(L, device=x.device)
        far = (idx[:, None] - idx[None, :]).abs() > self.window
        logits = logits.masked_fill(far, -1e9)
        return self.out(torch.softmax(logits, -1) @ v).transpose(1, 2)


class _DConvBlock(nn.Module):
    def __init__(self, ch: int, hid: int, d: int, lstm_attn: bool,
                 attn_window: int, generator):
        super().__init__()
        self.conv1 = _conv(ch, hid, 3, generator, dilation=2 ** d,
                           padding=2 ** d)
        self.norm1 = nn.GroupNorm(1, hid)
        self.lstm = _BiLSTM(hid, generator) if lstm_attn else None
        self.attn = (_BandAttention(hid, attn_window, generator)
                     if lstm_attn else None)
        self.conv2 = _conv(hid, 2 * ch, 1, generator)
        self.norm2 = nn.GroupNorm(1, 2 * ch)
        self.scale = nn.Parameter(torch.full((ch,), 0.1))

    def forward(self, x):
        y = _gelu(self.norm1(self.conv1(x)))
        if self.lstm is not None:
            y = y + self.lstm(y)
            y = y + self.attn(y)
        y = _glu(self.norm2(self.conv2(y)))
        return x + self.scale[:, None] * y


class _Encoder(nn.Module):
    """``(N, C, L)`` → ``(N, C', L / stride)``: strided conv → LN → GELU →
    DConv → 1×1 conv → LN → GLU."""

    def __init__(self, cin, cout, model: "HDemucs", generator,
                 lstm_attn=False):
        super().__init__()
        K, st = model.K, model.st
        self.conv = _conv(cin, cout, K, generator, stride=st,
                          padding=(K - st) // 2)
        self.norm = _ChannelNorm(cout)
        hid = max(cout // model.dconv_comp, 1)
        self.dconv = nn.ModuleList(
            _DConvBlock(cout, hid, d, lstm_attn, model.attn_window,
                        generator) for d in range(model.dconv_depth))
        self.gate = _conv(cout, 2 * cout, 1, generator)
        self.gate_norm = _ChannelNorm(2 * cout)

    def forward(self, x):
        y = _gelu(self.norm(self.conv(x)))
        for block in self.dconv:
            y = block(y)
        return _glu(self.gate_norm(self.gate(y)))


class _Decoder(nn.Module):
    """``(N, C, L)`` + skip → ``(N, C', L·stride)``: 1×1 conv → LN → GLU →
    transposed conv cropped to ``L·stride`` [→ GELU]."""

    def __init__(self, cin, cout, model: "HDemucs", generator):
        super().__init__()
        K, st = model.K, model.st
        self.gate = _conv(cin, 2 * cin, 1, generator)
        self.gate_norm = _ChannelNorm(2 * cin)
        self.conv_tr = nn.ConvTranspose1d(cin, cout, K, st, bias=False)
        _glorot_(self.conv_tr.weight, K * cin, K * cout, generator)
        self.lo, self.st = (K - st) // 2, st

    def forward(self, x, skip, last=False):
        y = _glu(self.gate_norm(self.gate(x + skip)))
        y = self.conv_tr(y)[..., self.lo:self.lo + x.shape[-1] * self.st]
        return y if last else _gelu(y)


def _fold_freq(z):
    """``(B, C, F, L)`` → ``(B·L, C, F)``: time into the batch."""
    B, C, Fr, L = z.shape
    return z.permute(0, 3, 1, 2).reshape(B * L, C, Fr)


def _unfold_freq(y, B):
    BL, C, Fr = y.shape
    return y.reshape(B, BL // B, C, Fr).permute(0, 2, 3, 1)


class HDemucs(nn.Module):
    """``forward(mix (B, audio_channels, T))`` → ``(B, n_sources,
    audio_channels, T)``.

    ``depth`` branch layers (stride 4 each; the frequency branch strides
    along frequency) and ``shared_depth`` shared 1-D layers; ``nfft//2``
    must be divisible by ``stride**depth``."""

    def __init__(self, sources: Sequence[str] = ("drums", "bass",
                                                 "other", "vocals"),
                 audio_channels: int = 2, channels: int = 48,
                 growth: float = 2.0, depth: int = 4,
                 shared_depth: int = 2, nfft: int = 4096,
                 kernel: int = 8, stride: int = 4,
                 dconv_depth: int = 2, dconv_comp: int = 4,
                 attn_window: int = 100, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kernel < stride or (kernel - stride) % 2:
            raise ValueError("need kernel >= stride with even "
                             "(kernel - stride)")
        self.sources = tuple(sources)
        self.S = len(self.sources)
        self.C = audio_channels
        self.depth, self.shared = depth, shared_depth
        self.nfft, self.K, self.st = nfft, kernel, stride
        self.hop = stride ** depth
        self.F0 = nfft // 2
        if self.F0 % self.hop:
            raise ValueError(f"nfft//2 ({self.F0}) must be divisible "
                             f"by stride**depth ({self.hop})")
        self.Fm = self.F0 // self.hop
        self.dconv_depth, self.dconv_comp = dconv_depth, dconv_comp
        self.attn_window = attn_window
        ch = [int(round(channels * growth ** i))
              for i in range(depth + shared_depth)]
        self.ch = ch
        d, sh, g = depth, shared_depth, generator
        cins_t = [self.C] + ch[:d - 1]
        cins_f = [2 * self.C] + ch[:d - 1]
        self.enc_t = nn.ModuleList(_Encoder(cins_t[i], ch[i], self, g)
                                   for i in range(d))
        self.enc_f = nn.ModuleList(_Encoder(cins_f[i], ch[i], self, g)
                                   for i in range(d))
        self.enc_s = nn.ModuleList(
            _Encoder(ch[d - 1 + i], ch[d + i], self, g, lstm_attn=True)
            for i in range(sh))
        self.dec_s = nn.ModuleList(_Decoder(ch[d + i], ch[d - 1 + i], self, g)
                                   for i in reversed(range(sh)))
        self.dec_t = nn.ModuleList(
            _Decoder(ch[i], self.S * self.C if i == 0 else cins_t[i], self, g)
            for i in reversed(range(d)))
        self.dec_f = nn.ModuleList(
            _Decoder(ch[i], self.S * 2 * self.C if i == 0 else cins_f[i],
                     self, g)
            for i in reversed(range(d)))
        self.freq_emb = nn.Parameter(torch.empty(self.F0 // stride, ch[0]))
        with torch.no_grad():
            self.freq_emb.normal_(generator=g).mul_(0.2)
        c = ch[d - 1]
        self.merge = nn.Conv2d(c, c, (self.Fm, 1), bias=False)
        self.unmerge = nn.ConvTranspose2d(c, c, (self.Fm, 1), (self.Fm, 1),
                                          bias=False)
        for conv in (self.merge, self.unmerge):
            _glorot_(conv.weight, self.Fm * c, self.Fm * c, g)
        self.to(device)

    def valid_length(self, length: int) -> int:
        unit = self.hop * self.st ** self.shared
        return -(-length // unit) * unit

    @_fp32_cudnn
    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        if mix.ndim != 3 or mix.shape[1] != self.C:
            raise ValueError(f"mix must be (batch, {self.C}, time), got "
                             f"{tuple(mix.shape)}")
        B, C, T = mix.shape
        Tp = self.valid_length(T)
        # per-clip standardisation on the samples before padding
        mu = mix.mean((1, 2), keepdim=True)
        sd = mix.std((1, 2), keepdim=True, correction=0) + 1e-5
        x = F.pad((mix - mu) / sd, (0, Tp - T))
        L = Tp // self.hop

        z = stft(x, self.nfft, self.hop, window="hann", center=True)
        z = z[:, :, :self.F0, :L]                      # (B, C, F0, L)
        zin = torch.cat([z.real, z.imag], 1)           # (B, 2C, F0, L)
        tin = x

        skips_t, skips_f = [], []
        for i in range(self.depth):
            tin = self.enc_t[i](tin)
            zin = _unfold_freq(self.enc_f[i](_fold_freq(zin)), B)
            if i == 0:
                zin = zin + self.freq_emb.T[None, :, :, None]
            skips_t.append(tin)
            skips_f.append(zin)

        s = tin + self.merge(zin)[:, :, 0]             # (B, ch, L)
        skips_s = []
        for enc in self.enc_s:
            s = enc(s)
            skips_s.append(s)
        for i, dec in enumerate(self.dec_s):
            s = dec(s, skips_s[self.shared - 1 - i])

        xt = s
        zf = self.unmerge(s[:, :, None])               # (B, ch, Fm, L)
        for j, i in enumerate(reversed(range(self.depth))):
            xt = self.dec_t[j](xt, skips_t[i], last=(i == 0))
            zf = _unfold_freq(self.dec_f[j](_fold_freq(zf),
                                            _fold_freq(skips_f[i]),
                                            last=(i == 0)), B)

        wav_t = xt.reshape(B, self.S, C, Tp)
        spec = zf.reshape(B, self.S, 2 * C, self.F0, L)
        spec = torch.complex(spec[:, :, :C].contiguous(),
                             spec[:, :, C:].contiguous())
        spec = F.pad(torch.view_as_real(spec), (0, 0, 0, 1, 0, 1))
        wav_f = istft(torch.view_as_complex(spec.contiguous()), self.hop,
                      window="hann", center=True, length=Tp,
                      fft_length=self.nfft)
        out = (wav_t + wav_f) * sd[:, None] + mu[:, None]
        return out[..., :T]
