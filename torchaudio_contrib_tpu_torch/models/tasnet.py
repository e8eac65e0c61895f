"""ConvTasNet (Luo & Mesgarani 2019): time-domain source separation.

Port of ``torchaudio_contrib_tpu/models/tasnet.py``, torchaudio's
``models.ConvTasNet`` architecture and ``state_dict`` names: a learned
encoder (``Conv1d(1, N, L, stride L/2, padding L/2)``, no bias, no
activation), the TCN mask generator (global layer norm
``GroupNorm(1, C, eps=1e-8)``, a bottleneck 1×1 conv, ``X`` dilated
depthwise blocks repeated ``R`` times with single-parameter PReLUs and a
residual and a skip 1×1 conv each, the last block skip only), sigmoid
masks over ``sources × N`` and a shared bias-free
``ConvTranspose1d(N, 1, L, stride L/2, padding L/2)`` decoder.

``forward(mix (B, time))`` → ``(B, num_sources, time)``, the JAX model's
contract.  The clip is zero-padded to a multiple of L/2 (at least L)
and the output cropped back.  ``forward`` runs the convolutions in FP32
whatever ``torch.backends.cudnn.allow_tf32`` says, and so does a backward
pass through its output (``_common._fp32_cudnn``).  The depthwise convs
run in cuDNN, which sums the taps in another order than XLA.  Weights
are drawn from ``generator`` as the JAX ``init`` draws them
(Glorot-uniform kernels, zero biases, unit norms, PReLU slopes 0.25).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ._common import _fp32_cudnn, _glorot_

__all__ = ["ConvTasNet"]


def _conv(cin: int, cout: int, k: int, generator, **kw) -> nn.Conv1d:
    """``nn.Conv1d`` with the JAX ``_conv_init``: Glorot-uniform over
    ``k·cin`` in (``cin`` per group) and ``k·cout`` out, zero bias."""
    conv = nn.Conv1d(cin, cout, k, **kw)
    _glorot_(conv.weight, k * (cin // conv.groups), k * cout, generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
    return conv


def _gln(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(1, c, eps=1e-8)


class _ConvBlock(nn.Module):
    """One TCN block: 1×1 conv → PReLU → gLN → dilated depthwise conv →
    PReLU → gLN, then a residual (absent in the last block) and a skip
    1×1 conv."""

    def __init__(self, io: int, hidden: int, kernel: int, dilation: int,
                 generator, no_residual: bool = False):
        super().__init__()
        self.conv_layers = nn.Sequential(
            _conv(io, hidden, 1, generator),
            nn.PReLU(),
            _gln(hidden),
            _conv(hidden, hidden, kernel, generator, groups=hidden,
                  dilation=dilation, padding=(kernel - 1) * dilation // 2),
            nn.PReLU(),
            _gln(hidden),
        )
        self.res_out = (None if no_residual
                        else _conv(hidden, io, 1, generator))
        self.skip_out = _conv(hidden, io, 1, generator)

    def forward(self, x):
        z = self.conv_layers(x)
        res = None if self.res_out is None else self.res_out(z)
        return res, self.skip_out(z)


class _MaskGenerator(nn.Module):
    def __init__(self, num_sources, N, B, H, P, X, R, generator):
        super().__init__()
        self.ns, self.N = num_sources, N
        self.input_norm = _gln(N)
        self.input_conv = _conv(N, B, 1, generator)
        n = X * R
        self.conv_layers = nn.ModuleList(
            _ConvBlock(B, H, P, 2 ** (i % X), generator,
                       no_residual=(i == n - 1)) for i in range(n))
        self.output_prelu = nn.PReLU()
        self.output_conv = _conv(B, num_sources * N, 1, generator)

    def forward(self, feats):
        y = self.input_conv(self.input_norm(feats))
        skip_sum = 0.0
        for layer in self.conv_layers:
            res, skip = layer(y)
            if res is not None:
                y = y + res
            skip_sum = skip_sum + skip
        m = self.output_conv(self.output_prelu(skip_sum))
        return torch.sigmoid(m.reshape(feats.shape[0], self.ns, self.N, -1))


class ConvTasNet(nn.Module):
    """``forward(mix (B, time))`` → ``(B, num_sources, time)``.

    Defaults follow the paper and torchaudio: ``enc_filters`` N=512,
    ``enc_kernel`` L=16 (stride L/2), bottleneck B=128, hidden H=512,
    TCN kernel P=3, ``num_blocks`` X=8 (dilations 1..2^{X-1}),
    ``num_repeats`` R=3.
    """

    def __init__(self, num_sources: int = 2, enc_kernel: int = 16,
                 enc_filters: int = 512, bottleneck: int = 128,
                 hidden: int = 512, tcn_kernel: int = 3,
                 num_blocks: int = 8, num_repeats: int = 3, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if enc_kernel % 2:
            raise ValueError("enc_kernel must be even (stride L/2)")
        self.ns, self.L, self.N = num_sources, enc_kernel, enc_filters
        self.B, self.H, self.P = bottleneck, hidden, tcn_kernel
        self.X, self.R = num_blocks, num_repeats
        stride = enc_kernel // 2
        self.encoder = _conv(1, enc_filters, enc_kernel, generator,
                             stride=stride, padding=stride, bias=False)
        self.mask_generator = _MaskGenerator(
            num_sources, enc_filters, bottleneck, hidden, tcn_kernel,
            num_blocks, num_repeats, generator)
        self.decoder = nn.ConvTranspose1d(enc_filters, 1, enc_kernel,
                                          stride=stride, padding=stride,
                                          bias=False)
        _glorot_(self.decoder.weight, enc_kernel, enc_kernel * enc_filters,
                 generator)
        self.to(device)

    @_fp32_cudnn
    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        if mix.ndim != 2:
            raise ValueError("mix must be (batch, time)")
        b, t = mix.shape
        stride = self.L // 2
        pad = (-t) % stride
        if t + pad < self.L:
            pad = self.L - t
        x = F.pad(mix, (0, pad))[:, None]                  # (B, 1, T+)
        feats = self.encoder(x)                            # (B, N, F)
        masks = self.mask_generator(feats)                 # (B, S, N, F)
        sep = (feats[:, None] * masks).reshape(b * self.ns, self.N, -1)
        wav = self.decoder(sep).reshape(b, self.ns, -1)
        return wav[:, :, :t]
