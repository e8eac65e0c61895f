"""Hybrid Demucs v3 in torchaudio's layout (the ``HDEMUCS_HIGH_MUSDB*``
bundles' model).

Port of ``torchaudio_contrib_tpu/models/hdemucs_ta.py``, layer for layer
and with torchaudio's ``models.HDemucs`` ``state_dict`` names, which the
JAX package's ``import_hdemucs`` reads:

* frequency branch: the complex-as-channels spectrogram ``(B, 2C, F, T)``
  through encoder layers convolving the frequency axis (kernel ``(8, 1)``,
  stride ``(4, 1)``, pad 2) until ``F`` collapses, then time-axis layers
  (kernel 4, stride 2);
* time branch: kernel-8, stride-4 layers on the waveform, one per
  frequency layer; the last is a bare conv injected into the matching
  frequency layer, and the branches share every deeper layer;
* every full layer: conv → [GroupNorm(4) from ``norm_starts``] → GELU →
  the DConv residual stack (dilated 3-tap convs, GroupNorm(1), GLU,
  LayerScale; from ``dconv_lstm``/``dconv_attn`` a 2-layer BiLSTM, framed
  in 50 %-overlap windows beyond ``lstm_max_steps`` steps, and the
  LocalState banded-decay attention) → 1×1 rewrite conv → [GroupNorm(4)]
  → GLU;
* decoders mirror them with transposed convs and 3×3 rewrite convs; the
  frequency decoder gives a CaC spectrogram through a normalized ISTFT,
  the time decoder a waveform, and the model returns their sum.

``forward(mix (B, audio_channels, T))`` → ``(B, n_sources,
audio_channels, T)`` for any ``T``.  The STFT and ISTFT are the port's
``ops.stft``/``ops.istft`` (``normalized=True``, reflect padding), the
BiLSTMs ``nn.LSTM(bidirectional=True)`` over the folded batch (cuDNN on
the card; torch's gate order i, f, g, o, as the JAX model's), the GELUs
exact.  ``forward`` runs the convolutions and LSTMs in FP32 whatever
``torch.backends.cudnn.allow_tf32`` says, and so does a backward pass
through its output (``_common._fp32_cudnn``).  Weights are drawn from
``generator`` as the JAX ``init`` draws them: torch's reset bounds
(U(±1/√fan_in) for convs and linears, U(±1/√hidden) for the LSTMs with
one bias, the other zero), unit norms, LayerScale at ``dconv_init``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import istft, stft
from ._common import _fp32_cudnn

__all__ = ["HDemucsTA"]


def _reset_(module: nn.Module, generator) -> None:
    """Redraw every conv, linear and LSTM parameter of ``module`` from
    ``generator`` with torch's reset bounds (the JAX ``_conv_p``,
    ``_tconv_p``, ``_dense_p`` and ``_lstm_dir_p``); an LSTM's
    ``bias_hh`` is zero (the JAX LSTM has one bias)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d,
                              nn.ConvTranspose2d, nn.Linear)):
                fan_in = nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
                s = 1.0 / math.sqrt(max(fan_in, 1))
                m.weight.uniform_(-s, s, generator=generator)
                m.bias.uniform_(-s, s, generator=generator)
            elif isinstance(m, nn.LSTM):
                s = 1.0 / math.sqrt(m.hidden_size)
                for name, p in m.named_parameters():
                    if name.startswith("bias_hh"):
                        p.zero_()
                    else:
                        p.uniform_(-s, s, generator=generator)


class _LayerScale(nn.Module):
    def __init__(self, channels: int, init: float):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), float(init)))

    def forward(self, x):
        return self.scale[:, None] * x


class _BLSTM(nn.Module):
    """Bidirectional LSTM with a projection and a skip; beyond
    ``max_steps`` steps the sequence is cut into 50 %-overlap frames of
    ``max_steps``, run as one batch, and the frames' centre halves are
    stitched back."""

    def __init__(self, dim: int, layers: int, max_steps: Optional[int]):
        super().__init__()
        self.max_steps = max_steps
        self.lstm = nn.LSTM(dim, dim, num_layers=layers, bidirectional=True)
        self.linear = nn.Linear(2 * dim, dim)

    def forward(self, x):
        N, C, T = x.shape
        y = x
        width = self.max_steps
        framed = width is not None and T > width
        if framed:
            stride = width // 2
            nf = -(-T // stride)
            x = F.pad(x, (0, (nf - 1) * stride + width - T))
            x = x.unfold(-1, width, stride)               # (N, C, nf, width)
            x = x.permute(0, 2, 1, 3).reshape(N * nf, C, width)
        h = self.lstm(x.permute(2, 0, 1))[0]
        x = self.linear(h).permute(1, 2, 0)
        if framed:
            frames = x.reshape(N, nf, C, width)
            limit = width // 4
            outs = [frames[:, k, :, (0 if k == 0 else limit):
                           (width if k == nf - 1 else width - limit)]
                    for k in range(nf)]
            x = torch.cat(outs, -1)[..., :T]
        return x + y


class _LocalState(nn.Module):
    """Banded-decay attention: content, query and key 1×1 convs, learned
    per-head distance decays, the self position masked to −100."""

    def __init__(self, channels: int, heads: int, ndecay: int):
        super().__init__()
        self.heads, self.ndecay = heads, ndecay
        self.content = nn.Conv1d(channels, channels, 1)
        self.query = nn.Conv1d(channels, channels, 1)
        self.key = nn.Conv1d(channels, channels, 1)
        self.query_decay = nn.Conv1d(channels, heads * ndecay, 1)
        self.proj = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        N, C, T = x.shape
        heads, ndecay = self.heads, self.ndecay
        queries = self.query(x).reshape(N, heads, -1, T)
        keys = self.key(x).reshape(N, heads, -1, T)
        dots = torch.einsum("bhct,bhcs->bhts", keys, queries) \
            / math.sqrt(keys.shape[2])
        if ndecay:
            decays = torch.arange(1, ndecay + 1, device=x.device,
                                  dtype=x.dtype)
            decay_q = torch.sigmoid(
                self.query_decay(x).reshape(N, heads, ndecay, T)) / 2
            pos = torch.arange(T, device=x.device, dtype=x.dtype)
            delta = (pos[:, None] - pos[None, :]).abs()
            decay_kernel = -decays[:, None, None] * delta / math.sqrt(ndecay)
            dots = dots + torch.einsum("fts,bhfs->bhts", decay_kernel,
                                       decay_q)
        eye = torch.eye(T, dtype=torch.bool, device=x.device)
        dots = dots.masked_fill(eye, -100.0)
        weights = torch.softmax(dots, dim=2)
        content = self.content(x).reshape(N, heads, -1, T)
        result = torch.einsum("bhts,bhct->bhcs", weights,
                              content).reshape(N, C, T)
        return x + self.proj(result)


class _DConv(nn.Module):
    """``layers.{d}``: dilated conv → GN(1) → GELU → [BLSTM] →
    [LocalState] → 1×1 conv → GN(1) → GLU → LayerScale, added to the
    input."""

    def __init__(self, channels: int, depth: int, compress: int,
                 lstm: bool, attn: bool, heads: int, ndecay: int,
                 lstm_layers: int, lstm_max_steps, init: float):
        super().__init__()
        hid = channels // compress
        layers = []
        for d in range(depth):
            dil = 2 ** d
            mods = [nn.Conv1d(channels, hid, 3, dilation=dil, padding=dil),
                    nn.GroupNorm(1, hid), nn.GELU()]
            if lstm:
                mods.append(_BLSTM(hid, lstm_layers, lstm_max_steps))
            if attn:
                mods.append(_LocalState(hid, heads, ndecay))
            mods += [nn.Conv1d(hid, 2 * channels, 1),
                     nn.GroupNorm(1, 2 * channels), nn.GLU(1),
                     _LayerScale(channels, init)]
            layers.append(nn.Sequential(*mods))
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = x + layer(x)
        return x


class _HEncLayer(nn.Module):
    def __init__(self, spec: dict, model: "HDemucsTA"):
        super().__init__()
        self.spec = spec
        ci, co, k = spec["chin"], spec["chout"], spec["ker"]
        if spec["freq"]:
            self.conv = nn.Conv2d(ci, co, (k, 1), (spec["stride"], 1),
                                  (spec["pad"], 0))
        else:
            self.conv = nn.Conv1d(ci, co, k, spec["stride"], spec["pad"])
        if spec["empty"]:
            return
        rk, ctx = 1 + 2 * spec["context"], spec["context"]
        conv = nn.Conv2d if spec["freq"] else nn.Conv1d
        self.rewrite = conv(co, 2 * co, rk, 1, ctx)
        if spec["norm"]:
            self.norm1 = nn.GroupNorm(model.norm_groups, co)
            self.norm2 = nn.GroupNorm(model.norm_groups, 2 * co)
        self.dconv = _DConv(co, model.dconv_depth, model.dconv_comp,
                            spec["lstm"], spec["attn"], model.attn_heads,
                            model.attn_ndecay, model.lstm_layers,
                            model.lstm_max_steps, model.dconv_init)

    def _norm(self, name, x):
        return getattr(self, name)(x) if self.spec["norm"] else x

    def forward(self, x, inject=None):
        spec = self.spec
        freq = spec["freq"]
        if not freq and x.ndim == 4:
            x = x.reshape(x.shape[0], -1, x.shape[-1])
        if not freq and x.shape[-1] % spec["stride"]:
            x = F.pad(x, (0, spec["stride"] - x.shape[-1] % spec["stride"]))
        y = self.conv(x)
        if spec["empty"]:
            return y
        if inject is not None:
            if inject.ndim == 3 and y.ndim == 4:
                inject = inject[:, :, None]
            y = y + inject
        y = F.gelu(self._norm("norm1", y))
        if freq:
            B, C, Fr, T = y.shape
            yd = self.dconv(y.permute(0, 2, 1, 3).reshape(B * Fr, C, T))
            y = yd.reshape(B, Fr, C, T).permute(0, 2, 1, 3)
        else:
            y = self.dconv(y)
        return F.glu(self._norm("norm2", self.rewrite(y)), dim=1)


class _HDecLayer(nn.Module):
    def __init__(self, spec: dict, model: "HDemucsTA"):
        super().__init__()
        self.spec = spec
        ci, co, k = spec["chin"], spec["chout"], spec["ker"]
        if spec["freq"]:
            self.conv_tr = nn.ConvTranspose2d(ci, co, (k, 1),
                                              (spec["stride"], 1))
        else:
            self.conv_tr = nn.ConvTranspose1d(ci, co, k, spec["stride"])
        if spec["norm"]:
            self.norm2 = nn.GroupNorm(model.norm_groups, co)
        if not spec["empty"]:
            rk, ctx = 1 + 2 * spec["context"], spec["context"]
            conv = nn.Conv2d if spec["freq"] else nn.Conv1d
            self.rewrite = conv(ci, 2 * ci, rk, 1, ctx)
            if spec["norm"]:
                self.norm1 = nn.GroupNorm(model.norm_groups, 2 * ci)

    def _norm(self, name, x):
        return getattr(self, name)(x) if self.spec["norm"] else x

    def forward(self, x, skip, length: int):
        spec = self.spec
        freq = spec["freq"]
        if freq and x.ndim == 3:
            x = x.reshape(x.shape[0], spec["chin"], -1, x.shape[-1])
        if not spec["empty"]:
            y = F.glu(self._norm("norm1", self.rewrite(x + skip)), dim=1)
        else:
            y = x
        z = self._norm("norm2", self.conv_tr(y))
        pad = spec["pad"]
        if freq:
            if pad:
                z = z[..., pad:-pad, :]
        else:
            z = z[..., pad:pad + length]
        if not spec["last"]:
            z = F.gelu(z)
        return z, y


class _ScaledEmbedding(nn.Module):
    def __init__(self, rows: int, dim: int, scale: float):
        super().__init__()
        self.embedding = nn.Embedding(rows, dim)
        self.scale = scale

    @property
    def weight(self):
        return self.embedding.weight * self.scale


class HDemucsTA(nn.Module):
    """torchaudio-compatible Hybrid Demucs.

    ``forward(mix (B, audio_channels, T))`` → ``(B, n_sources,
    audio_channels, T)``.  The defaults are the high model (depth 6, nfft
    4096, 48 channels, growth 2)."""

    def __init__(self, sources: Sequence[str] = ("drums", "bass",
                                                 "other", "vocals"),
                 audio_channels: int = 2, channels: int = 48,
                 growth: float = 2.0, nfft: int = 4096, depth: int = 6,
                 freq_emb: float = 0.2, emb_scale: int = 10,
                 kernel_size: int = 8, time_stride: int = 2,
                 stride: int = 4, context: int = 1,
                 context_enc: int = 0, norm_starts: int = 4,
                 norm_groups: int = 4, dconv_depth: int = 2,
                 dconv_comp: int = 4, dconv_attn: int = 4,
                 dconv_lstm: int = 4, dconv_init: float = 1e-4,
                 attn_heads: int = 4, attn_ndecay: int = 4,
                 lstm_layers: int = 2,
                 lstm_max_steps: Optional[int] = 200, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sources = tuple(sources)
        self.S = len(self.sources)
        self.C = audio_channels
        self.nfft = nfft
        self.depth = depth
        self.freq_emb_scale = freq_emb
        self.norm_groups = norm_groups
        self.dconv_depth = dconv_depth
        self.dconv_comp = dconv_comp
        self.dconv_init = dconv_init
        self.attn_heads = attn_heads
        self.attn_ndecay = attn_ndecay
        self.lstm_layers = lstm_layers
        self.lstm_max_steps = lstm_max_steps

        # the layer plan of the JAX model's (and torchaudio's) __init__
        chin, chin_z = audio_channels, 2 * audio_channels
        chout = chout_z = channels
        freqs = nfft // 2
        enc, tenc, dec, tdec = [], [], [], []
        for index in range(depth):
            lstm = index >= dconv_lstm
            attn = index >= dconv_attn
            norm = index >= norm_starts
            freq = freqs > 1
            stri, ker = stride, kernel_size
            if not freq:
                ker, stri = time_stride * 2, time_stride
            pad, last_freq = True, False
            if freq and freqs <= kernel_size:
                ker, pad, last_freq = freqs, False, True
            enc.append(dict(
                chin=chin_z, chout=chout_z, ker=ker, stride=stri,
                pad=(ker // 4 if pad else 0), freq=freq, norm=norm,
                empty=False, context=context_enc, lstm=lstm, attn=attn))
            if freq:
                tenc.append(dict(
                    chin=chin, chout=chout, ker=kernel_size,
                    stride=stride, pad=kernel_size // 4, freq=False,
                    norm=norm, empty=last_freq, context=context_enc,
                    lstm=lstm, attn=attn))
            if index == 0:
                chin = audio_channels * self.S
                chin_z = 2 * chin
            dec.insert(0, dict(
                chin=chout_z, chout=chin_z, ker=ker, stride=stri,
                pad=(ker // 4 if pad else 0), freq=freq, norm=norm,
                empty=False, last=(index == 0), context=context))
            if freq:
                tdec.insert(0, dict(
                    chin=chout, chout=chin, ker=kernel_size,
                    stride=stride, pad=kernel_size // 4, freq=False,
                    norm=norm, empty=last_freq, last=(index == 0),
                    context=context))
            chin, chin_z = chout, chout_z
            chout = int(growth * chout)
            chout_z = int(growth * chout_z)
            if freq:
                freqs = 1 if freqs <= kernel_size else freqs // stride
            if index == 0:
                emb_rows, emb_dim = freqs, chin_z
        self.enc_specs, self.tenc_specs = enc, tenc
        self.dec_specs, self.tdec_specs = dec, tdec

        self.freq_emb = _ScaledEmbedding(emb_rows, emb_dim, emb_scale)
        self.encoder = nn.ModuleList(_HEncLayer(s, self) for s in enc)
        self.tencoder = nn.ModuleList(_HEncLayer(s, self) for s in tenc)
        self.decoder = nn.ModuleList(_HDecLayer(s, self) for s in dec)
        self.tdecoder = nn.ModuleList(_HDecLayer(s, self) for s in tdec)
        with torch.no_grad():
            self.freq_emb.embedding.weight.normal_(generator=generator)
            self.freq_emb.embedding.weight.div_(emb_scale)
        _reset_(self, generator)
        self.to(device)

    # -- spectral plumbing ---------------------------------------------------
    def _spec(self, x):
        """Triple-half-hop reflect pre-pad, normalized reflect STFT, the
        Nyquist row dropped and two frames trimmed each side: exactly
        ``ceil(T / hop)`` frames."""
        hl = self.nfft // 4
        T = x.shape[-1]
        le = -(-T // hl)
        pad = hl // 2 * 3
        x = F.pad(x, (pad, pad + le * hl - T), mode="reflect")
        z = stft(x, self.nfft, hl, window="hann", center=True,
                 pad_mode="reflect", normalized=True)
        return z[..., :-1, 2:2 + le]

    def _ispec(self, z, length: int):
        """Inverse of :meth:`_spec`: the Nyquist row and the edge frames
        restored as zeros, normalized ISTFT, the pre-pad cropped."""
        hl = self.nfft // 4
        z = F.pad(torch.view_as_real(z), (0, 0, 2, 2, 0, 1))
        z = torch.view_as_complex(z.contiguous())
        pad = hl // 2 * 3
        le = hl * (-(-length // hl)) + 2 * pad
        x = istft(z, hl, window="hann", center=True, normalized=True,
                  length=le, fft_length=self.nfft)
        return x[..., pad:pad + length]

    # -- forward -------------------------------------------------------------
    @_fp32_cudnn
    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        if mix.ndim != 3 or mix.shape[1] != self.C:
            raise ValueError(f"mix must be (batch, {self.C}, time), got "
                             f"{tuple(mix.shape)}")
        B, C, T = mix.shape
        z = self._spec(mix)                            # (B, C, F0, Tf)
        x = torch.stack([z.real, z.imag], dim=2).reshape(
            B, 2 * C, *z.shape[-2:])
        mean = x.mean((1, 2, 3), keepdim=True)
        std = x.std((1, 2, 3), keepdim=True, correction=1)
        x = (x - mean) / (1e-5 + std)
        meant = mix.mean((1, 2), keepdim=True)
        stdt = mix.std((1, 2), keepdim=True, correction=1)
        xt = (mix - meant) / (1e-5 + stdt)

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, layer in enumerate(self.encoder):
            lengths.append(x.shape[-1])
            inject = None
            if idx < len(self.tencoder):
                lengths_t.append(xt.shape[-1])
                tlayer = self.tencoder[idx]
                xt = tlayer(xt)
                if not tlayer.spec["empty"]:
                    saved_t.append(xt)
                else:
                    inject = xt
            x = layer(x, inject)
            if idx == 0:
                emb = self.freq_emb.weight
                x = x + self.freq_emb_scale * emb.T[None, :, :, None]
            saved.append(x)

        offset = self.depth - len(self.tdecoder)
        for idx, layer in enumerate(self.decoder):
            x, pre = layer(x, saved.pop(-1), lengths.pop(-1))
            if idx >= offset:
                tlayer = self.tdecoder[idx - offset]
                length_t = lengths_t.pop(-1)
                if tlayer.spec["empty"]:
                    xt, _ = tlayer(pre[:, :, 0], None, length_t)
                else:
                    xt, _ = tlayer(xt, saved_t.pop(-1), length_t)

        S = self.S
        Fq, Tf = z.shape[-2], z.shape[-1]
        # un-standardise on (B, S, 2C, F, T), then unpack the CaC pairs
        x = x.reshape(B, S, 2 * C, Fq, Tf) * std[:, None] + mean[:, None]
        x = x.reshape(B, S, C, 2, Fq, Tf)
        zout = torch.complex(x[:, :, :, 0].contiguous(),
                             x[:, :, :, 1].contiguous())
        xf = self._ispec(zout, T)
        xt = xt.reshape(B, S, C, T) * stdt[:, None] + meant[:, None]
        return xt + xf
