"""HiFi-GAN vocoder (Kong et al. 2020): mel → waveform generator.

Port of ``torchaudio_contrib_tpu/models/hifigan.py``: ``conv_pre`` (7
taps), then per upsampling stage a leaky ReLU, a stride-``u`` transposed
conv (``nn.ConvTranspose1d`` with torch's ``padding=(k−u)//2``, which gives
exactly ``frames·u`` samples, as the JAX package's ``k−1−(k−u)//2`` pad of
``lax.conv_transpose`` does) and a multi-receptive-field fusion (the mean
of parallel dilated residual blocks: type 1 two convs per dilation, type 2
one); then the published generator's bare ``leaky_relu`` (slope 0.01, not
the 0.1 used elsewhere), ``conv_post`` and ``tanh``.  Plain convs stand in
for weight norm, as in the JAX package (its inference form).

``forward(mel (B, in_channels, frames))`` → ``(B, 1, frames·prod(rates))``;
``(in_channels, frames)`` → ``(1, frames·prod(rates))``.  The
``state_dict`` names are HF ``SpeechT5HifiGan``'s (``conv_pre``,
``upsampler.{i}``, ``resblocks.{r}.convs1/convs2.{j}`` for type 1,
``resblocks.{r}.convs.{j}`` for type 2, ``conv_post``), which the JAX
package's ``import_hifigan`` reads.  ``forward`` runs the convolutions in
FP32 whatever ``torch.backends.cudnn.allow_tf32`` says
(``_common._fp32_cudnn``).  Modules take ``device=`` (the card unless the
caller asks for the CPU) and draw their weights from ``generator``
(normal(0, 0.01), zero biases, as the JAX ``init``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ._common import _fp32_cudnn

__all__ = ["HiFiGANVocoder", "hifigan_vocoder_v1", "hifigan_vocoder_v2",
           "hifigan_vocoder_v3"]


def _init(conv, generator):
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.01, generator=generator)
        conv.bias.zero_()
    return conv


def _same_conv(cin: int, cout: int, k: int, generator, dilation: int = 1):
    """'Same' conv for an odd kernel."""
    return _init(nn.Conv1d(cin, cout, k, dilation=dilation,
                           padding=dilation * (k - 1) // 2), generator)


class _ResBlock(nn.Module):
    def __init__(self, c: int, k: int, dilations, rb_type: int, generator):
        super().__init__()
        if rb_type == 1:
            self.convs1 = nn.ModuleList(_same_conv(c, c, k, generator, d)
                                        for d in dilations)
            self.convs2 = nn.ModuleList(_same_conv(c, c, k, generator)
                                        for _ in dilations)
        else:
            self.convs = nn.ModuleList(_same_conv(c, c, k, generator, d)
                                       for d in dilations)

    def forward(self, x, slope: float):
        if hasattr(self, "convs"):
            for conv in self.convs:
                x = x + conv(F.leaky_relu(x, slope))
            return x
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, slope)), slope))
        return x


class HiFiGANVocoder(nn.Module):
    """``forward(mel (B, in_channels, frames))`` → ``(B, 1, frames·U)``,
    ``U = prod(upsample_rates)``.  ``resblock_type`` 1 = two convs per
    dilation (v1/v2), 2 = one (v3).  The defaults are the published v1."""

    def __init__(self, in_channels: int = 80,
                 upsample_rates=(8, 8, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes=(16, 16, 4, 4),
                 resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5),) * 3,
                 resblock_type: int = 1,
                 lrelu_slope: float = 0.1, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(upsample_rates) != len(upsample_kernel_sizes):
            raise ValueError("need one kernel size per upsample rate")
        if len(resblock_kernel_sizes) != len(resblock_dilation_sizes):
            raise ValueError(
                "need one dilation tuple per resblock kernel size")
        if resblock_type not in (1, 2):
            raise ValueError("resblock_type must be 1 or 2")
        for k, u in zip(upsample_kernel_sizes, upsample_rates):
            if (k - u) % 2:
                raise ValueError(
                    f"upsample kernel {k} minus rate {u} must be even "
                    "(torch padding=(k-u)//2 arithmetic)")
        self.in_channels = in_channels
        self.rates = tuple(upsample_rates)
        self.rb_kernels = tuple(resblock_kernel_sizes)
        self.rb_dilations = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.rb_type = resblock_type
        self.slope = lrelu_slope
        self.upsample_factor = math.prod(self.rates)
        c = upsample_initial_channel
        self.conv_pre = _same_conv(in_channels, c, 7, generator)
        ups, blocks = [], []
        for u, k in zip(self.rates, upsample_kernel_sizes):
            ups.append(_init(nn.ConvTranspose1d(c, c // 2, k, u,
                                                padding=(k - u) // 2),
                             generator))
            c //= 2
            blocks += [_ResBlock(c, kr, d, resblock_type, generator)
                       for kr, d in zip(self.rb_kernels, self.rb_dilations)]
        self.upsampler = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(blocks)
        self.conv_post = _same_conv(c, 1, 7, generator)
        self.to(device)

    @_fp32_cudnn
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        if mel.ndim != 3 or mel.shape[1] != self.in_channels:
            raise ValueError(f"mel must be (batch, {self.in_channels}, "
                             f"frames), got {tuple(mel.shape)}")
        x = self.conv_pre(mel)
        n = len(self.rb_kernels)
        for i, up in enumerate(self.upsampler):
            x = up(F.leaky_relu(x, self.slope))
            acc = 0.0
            for block in self.resblocks[i * n:(i + 1) * n]:
                acc = acc + block(x, self.slope)
            x = acc / n
        x = torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))
        if x.shape[-1] != mel.shape[-1] * self.upsample_factor:
            raise RuntimeError(f"{x.shape[-1]} samples from "
                               f"{mel.shape[-1]} frames")
        return x[0] if squeeze else x


def hifigan_vocoder_v1(in_channels: int = 80, **kwargs) -> HiFiGANVocoder:
    """Published v1: 256× upsampling (8·8·2·2), 512 initial channels."""
    return HiFiGANVocoder(in_channels=in_channels, **kwargs)


def hifigan_vocoder_v2(in_channels: int = 80, **kwargs) -> HiFiGANVocoder:
    """The v1 topology at 128 initial channels."""
    return HiFiGANVocoder(in_channels=in_channels,
                          upsample_initial_channel=128, **kwargs)


def hifigan_vocoder_v3(in_channels: int = 80, **kwargs) -> HiFiGANVocoder:
    """v3: 256× as 8·8·4, 256 initial channels, type-2 resblocks."""
    return HiFiGANVocoder(
        in_channels=in_channels, upsample_rates=(8, 8, 4),
        upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=256,
        resblock_kernel_sizes=(3, 5, 7),
        resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)),
        resblock_type=2, **kwargs)
