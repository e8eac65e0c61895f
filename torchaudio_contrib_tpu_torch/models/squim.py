"""Squim: reference-free speech quality and intelligibility measures
(Kumar et al. 2023).

Port of ``torchaudio_contrib_tpu/models/squim.py``, three models:

* :class:`SquimObjective` — the JAX package's own build: a strided-conv
  frame encoder, a dual-path (DPRNN) core of intra- and inter-chunk
  BiLSTMs, attention pooling and small GELU heads giving STOI ∈ (0, 1),
  PESQ ∈ (1, 4.5) and SI-SDR in dB;
* :class:`SquimObjectiveTA` — torchaudio's ``models.SquimObjective``
  layout and ``state_dict`` names (which the JAX package's
  ``import_squim_objective`` reads): a bias-free ``Conv1d`` + ReLU
  encoder, the canonical DPRNN (50 %-overlap segmentation, ``SingleRNN``
  = bidirectional ``nn.LSTM`` + projection, ``GroupNorm(1, eps=1e-8)``,
  a 1×1 conv + PReLU, overlap-add) and three branches of one post-norm
  transformer-encoder layer (written out), AutoPool and a PReLU head;
* :class:`SquimSubjective` — MOS ∈ (1, 5) from a test waveform and a
  non-matching clean reference: the shared encoder and core, the test
  cross-attending into the reference, a pooled head.

``forward`` takes ``waveforms (B, T)`` (and ``reference (B, T')`` for the
subjective model) and returns ``(stoi, pesq, si_sdr)``, each ``(B,)``, or
the MOS ``(B,)``.  The house models' GELUs are the tanh form
(``jax.nn.gelu``'s default) and their LSTM gates i, f, o, u in the JAX
parameters (``utils.convert`` permutes them into ``nn.LSTM``'s i, f, g,
o); the TA model's LSTMs are torch's already.  Attention is explicit
products.  ``forward`` runs the convolutions and LSTMs in FP32 whatever
``torch.backends.cudnn.allow_tf32`` says, and so does a backward pass
through its outputs (``_common._fp32_cudnn``).  Weights are drawn from
``generator`` as the JAX ``init`` draws them (Glorot-uniform, zero
biases, unit norms, PReLU 0.25, AutoPool α 1, pooling queries
N(0, 0.1²)).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ._common import _dense, _fp32_cudnn, _glorot_

__all__ = ["SquimObjective", "SquimObjectiveTA", "SquimSubjective"]

METRICS = ("stoi", "pesq", "si_sdr")


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _lstm(cin: int, hid: int, generator) -> nn.LSTM:
    """A batch-first bidirectional ``nn.LSTM`` with the JAX ``_lstm_p``
    init: Glorot-uniform kernels over the four gates, one zero bias."""
    lstm = nn.LSTM(cin, hid, bidirectional=True, batch_first=True)
    for name, p in lstm.named_parameters():
        if name.startswith("weight_ih"):
            _glorot_(p, cin, 4 * hid, generator)
        elif name.startswith("weight_hh"):
            _glorot_(p, hid, 4 * hid, generator)
        else:
            nn.init.zeros_(p)
    return lstm


def _range(metric: str, v):
    if metric == "stoi":
        return torch.sigmoid(v)
    if metric == "pesq":
        return 1.0 + 3.5 * torch.sigmoid(v)
    return v


# -- the house models ----------------------------------------------------------

class _HouseBiLSTM(nn.Module):
    def __init__(self, d: int, h: int, generator):
        super().__init__()
        self.lstm = _lstm(d, h, generator)
        self.proj = _dense(2 * h, d, generator, bias=False)

    def forward(self, x):
        return self.proj(self.lstm(x)[0])


class _DPRNNBlock(nn.Module):
    def __init__(self, d: int, h: int, generator):
        super().__init__()
        self.intra = _HouseBiLSTM(d, h, generator)
        self.n1 = nn.LayerNorm(d)
        self.inter = _HouseBiLSTM(d, h, generator)
        self.n2 = nn.LayerNorm(d)


class _Encoder(nn.Module):
    """Waveforms → RMS normalisation → strided conv → LN → GELU → the
    chunked DPRNN core: ``(B, T)`` → ``(B, L, d_model)``."""

    def __init__(self, d_model, enc_kernel, enc_stride, hidden, num_blocks,
                 chunk, generator):
        super().__init__()
        self.k, self.s, self.chunk = enc_kernel, enc_stride, chunk
        self.conv = nn.Conv1d(1, d_model, enc_kernel, enc_stride, bias=False)
        _glorot_(self.conv.weight, enc_kernel, enc_kernel * d_model,
                 generator)
        self.norm = nn.LayerNorm(d_model)
        self.blocks = nn.ModuleList(_DPRNNBlock(d_model, hidden, generator)
                                    for _ in range(num_blocks))

    def forward(self, waveforms):
        if waveforms.ndim != 2:
            raise ValueError("waveforms must be (batch, time)")
        if waveforms.shape[1] < self.k:
            raise ValueError(f"need at least {self.k} samples")
        rms = waveforms.pow(2).mean(-1, keepdim=True).sqrt()
        y = self.conv((waveforms / (rms + 1e-8))[:, None])
        x = _gelu(self.norm(y.transpose(1, 2)))          # (B, L, D)
        B, L, D = x.shape
        nc = -(-L // self.chunk)
        x = F.pad(x, (0, 0, 0, nc * self.chunk - L))
        x = x.reshape(B, nc, self.chunk, D)
        for blk in self.blocks:
            intra = blk.intra(x.reshape(B * nc, self.chunk, D))
            x = blk.n1(x + intra.reshape(B, nc, self.chunk, D))
            xt = x.transpose(1, 2).reshape(B * self.chunk, nc, D)
            inter = blk.inter(xt).reshape(B, self.chunk, nc, D)
            x = blk.n2(x + inter.transpose(1, 2))
        return x.reshape(B, nc * self.chunk, D)[:, :L]


class _AttnPool(nn.Module):
    """Learned-query attention pooling ``(B, L, D)`` → ``(B, D)``."""

    def __init__(self, d: int, generator):
        super().__init__()
        self.wq = _dense(d, d, generator, bias=False)
        self.q = nn.Parameter(torch.empty(d))
        with torch.no_grad():
            self.q.normal_(generator=generator).mul_(0.1)

    def forward(self, x):
        w = torch.softmax(self.wq(x) @ self.q / math.sqrt(x.shape[-1]), -1)
        return torch.einsum("bl,bld->bd", w, x)


class _Head(nn.Module):
    def __init__(self, d: int, generator, hidden: int = 64):
        super().__init__()
        self.fc1 = _dense(d, hidden, generator)
        self.fc2 = _dense(hidden, 1, generator)

    def forward(self, x):
        return self.fc2(_gelu(self.fc1(x)))[..., 0]


class SquimObjective(nn.Module):
    """``forward(waveforms (B, T))`` → ``(stoi, pesq, si_sdr)``, each
    ``(B,)``."""

    METRICS = METRICS

    def __init__(self, d_model: int = 64, enc_kernel: int = 128,
                 enc_stride: int = 64, hidden: int = 64,
                 num_blocks: int = 2, chunk: int = 32, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = _Encoder(d_model, enc_kernel, enc_stride, hidden,
                                num_blocks, chunk, generator)
        self.pool = nn.ModuleDict({m: _AttnPool(d_model, generator)
                                   for m in METRICS})
        self.head = nn.ModuleDict({m: _Head(d_model, generator)
                                   for m in METRICS})
        self.to(device)

    @_fp32_cudnn
    def forward(self, waveforms: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        z = self.encoder(waveforms)
        return tuple(_range(m, self.head[m](self.pool[m](z)))
                     for m in METRICS)


class SquimSubjective(nn.Module):
    """``forward(test (B, T), reference (B, T'))`` → MOS ``(B,)`` ∈ (1, 5):
    both waveforms through the shared encoder and core, the test's frames
    cross-attending into the reference's, a pooled head over both."""

    def __init__(self, d_model: int = 64, enc_kernel: int = 128,
                 enc_stride: int = 64, hidden: int = 64,
                 num_blocks: int = 2, chunk: int = 32, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = self.d = d_model
        self.encoder = _Encoder(d_model, enc_kernel, enc_stride, hidden,
                                num_blocks, chunk, generator)
        self.cross_q = _dense(d, d, generator, bias=False)
        self.cross_k = _dense(d, d, generator, bias=False)
        self.cross_v = _dense(d, d, generator, bias=False)
        self.cross_norm = nn.LayerNorm(d)
        self.pool = _AttnPool(2 * d, generator)
        self.head = _Head(2 * d, generator)
        self.to(device)

    @_fp32_cudnn
    def forward(self, test: torch.Tensor,
                reference: torch.Tensor) -> torch.Tensor:
        zt = self.encoder(test)
        zr = self.encoder(reference)
        q = self.cross_q(self.cross_norm(zt))
        logits = q @ self.cross_k(zr).transpose(1, 2) / math.sqrt(self.d)
        att = torch.softmax(logits, -1) @ self.cross_v(zr)
        mos = self.head(self.pool(torch.cat([zt, att], -1)))
        return 1.0 + 4.0 * torch.sigmoid(mos)


# -- torchaudio's layout ---------------------------------------------------------

class _SingleRNN(nn.Module):
    """Bidirectional LSTM + projection back to the input width."""

    def __init__(self, d: int, h: int, generator):
        super().__init__()
        self.rnn = _lstm(d, h, generator)
        self.proj = _dense(2 * h, d, generator)

    def forward(self, x):
        return self.proj(self.rnn(x)[0])


class _DPRNN(nn.Module):
    def __init__(self, feat_dim, hidden_dim, d_model, num_blocks,
                 chunk_size, generator):
        super().__init__()
        self.chunk, self.stride = chunk_size, chunk_size // 2
        n = num_blocks
        self.row_rnn = nn.ModuleList(
            _SingleRNN(feat_dim, hidden_dim, generator) for _ in range(n))
        self.row_norm = nn.ModuleList(nn.GroupNorm(1, feat_dim, eps=1e-8)
                                      for _ in range(n))
        self.col_rnn = nn.ModuleList(
            _SingleRNN(feat_dim, hidden_dim, generator) for _ in range(n))
        self.col_norm = nn.ModuleList(nn.GroupNorm(1, feat_dim, eps=1e-8)
                                      for _ in range(n))
        self.conv = nn.Sequential(nn.Conv2d(feat_dim, d_model, 1),
                                  nn.PReLU())
        _glorot_(self.conv[0].weight, feat_dim, d_model, generator)
        nn.init.zeros_(self.conv[0].bias)

    @staticmethod
    def _gn(norm, x):
        """GroupNorm(1) on channels-last ``(B, n, K, F)``."""
        return norm(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def _split(self, x):
        """``(B, T, F)`` → ``(B, n_chunks, K, F)``, 50 % overlap."""
        B, T, Fd = x.shape
        K, s = self.chunk, self.stride
        rest = K - (s + T % K) % K
        x = F.pad(x, (0, 0, s, rest + s))
        total = x.shape[1]
        n = (total - s) // K
        seg1 = x[:, :total - s].reshape(B, n, K, Fd)
        seg2 = x[:, s:].reshape(B, n, K, Fd)
        return torch.stack([seg1, seg2], 2).reshape(B, 2 * n, K, Fd), rest

    def _merge(self, x, rest: int):
        """Overlap-add back to ``(B, T, F)`` (the two interleaved views
        tile the padded signal, so no averaging)."""
        B, n2, K, Fd = x.shape
        s = self.stride
        pair = x.reshape(B, n2 // 2, 2 * K, Fd)
        flat1 = pair[:, :, :K].reshape(B, -1, Fd)[:, s:]
        flat2 = pair[:, :, K:].reshape(B, -1, Fd)[:, :-s]
        out = flat1 + flat2
        return out[:, :out.shape[1] - rest]

    def forward(self, y):
        z, rest = self._split(y)
        B, nC, K, Fd = z.shape
        for row, row_n, col, col_n in zip(self.row_rnn, self.row_norm,
                                          self.col_rnn, self.col_norm):
            r = row(z.reshape(B * nC, K, Fd)).reshape(B, nC, K, Fd)
            z = z + self._gn(row_n, r)
            c = col(z.transpose(1, 2).reshape(B * K, nC, Fd))
            c = c.reshape(B, K, nC, Fd).transpose(1, 2)
            z = z + self._gn(col_n, c)
        conv, prelu = self.conv
        z = prelu(F.linear(z, conv.weight[:, :, 0, 0], conv.bias))
        return self._merge(z, rest)


class _SelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``), the products written out."""

    def __init__(self, d: int, heads: int, generator):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        _glorot_(self.in_proj_weight, d, 3 * d, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = _dense(d, d, generator)

    def forward(self, z):
        B, T, d = z.shape
        h = self.heads
        q, k, v = F.linear(z, self.in_proj_weight,
                           self.in_proj_bias).chunk(3, -1)
        q, k, v = (t.reshape(B, T, h, d // h).transpose(1, 2)
                   for t in (q, k, v))
        w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // h), -1)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, T, d))


class _EncoderLayer(nn.Module):
    """Post-norm ``nn.TransformerEncoderLayer`` (ReLU FFN of 4·d)."""

    def __init__(self, d: int, heads: int, generator):
        super().__init__()
        self.self_attn = _SelfAttention(d, heads, generator)
        self.linear1 = _dense(d, 4 * d, generator)
        self.linear2 = _dense(4 * d, d, generator)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, z):
        z = self.norm1(z + self.self_attn(z))
        return self.norm2(z + self.linear2(F.relu(self.linear1(z))))


class _AutoPool(nn.Module):
    """Softmax over time of ``alpha·x``, per feature."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, z):
        return (z * torch.softmax(z * self.alpha, dim=1)).sum(1)


class _Encoder1d(nn.Module):
    def __init__(self, feat_dim: int, win_len: int, generator):
        super().__init__()
        self.conv1d = nn.Conv1d(1, feat_dim, win_len, win_len // 2,
                                bias=False)
        _glorot_(self.conv1d.weight, win_len, feat_dim, generator)

    def forward(self, x):
        return F.relu(self.conv1d(x[:, None])).transpose(1, 2)


class SquimObjectiveTA(nn.Module):
    """torchaudio's ``models.SquimObjective``: ``forward(waveforms (B, T))``
    → ``(stoi, pesq, si_sdr)``, each ``(B,)`` (the contract of
    :class:`SquimObjective`)."""

    METRICS = METRICS

    def __init__(self, feat_dim: int = 256, win_len: int = 64,
                 d_model: int = 256, nhead: int = 4,
                 hidden_dim: int = 256, num_blocks: int = 2,
                 chunk_size: int = 71, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % nhead:
            raise ValueError("d_model must divide by nhead")
        self.k = win_len
        self.encoder = _Encoder1d(feat_dim, win_len, generator)
        self.dprnn = _DPRNN(feat_dim, hidden_dim, d_model, num_blocks,
                            chunk_size, generator)
        branches = []
        for _ in METRICS:
            head = nn.Sequential(_dense(d_model, d_model, generator),
                                 nn.PReLU(),
                                 _dense(d_model, 1, generator))
            branches.append(nn.Sequential(
                _EncoderLayer(d_model, nhead, generator), _AutoPool(), head))
        self.branches = nn.ModuleList(branches)
        self.to(device)

    @_fp32_cudnn
    def forward(self, waveforms: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if waveforms.ndim != 2:
            raise ValueError("waveforms must be (batch, time)")
        if waveforms.shape[1] < self.k:
            raise ValueError(f"need at least {self.k} samples")
        rms = waveforms.pow(2).mean(-1, keepdim=True).sqrt()
        z = self.dprnn(self.encoder(waveforms / (rms * 20.0 + 1e-8)))
        return tuple(_range(m, branch(z)[..., 0])
                     for m, branch in zip(METRICS, self.branches))
