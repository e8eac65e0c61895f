"""Mel front end + small CNN classifier, forward and training.

Port of ``torchaudio_contrib_tpu/models/frontend.py``: log-mel features
(the fused kernels with ``fused=True``, the STFT→mel→dB pipeline
otherwise) averaged over channels, three stride-2 3×3 conv + ReLU blocks,
global average pooling and a linear head.  Layouts are PyTorch's
(NCHW / OIHW) with mels as H and frames as W; the JAX model's
``padding="SAME"`` at stride 2 is reproduced exactly (it pads (0, 1) on
an even input, not (1, 1)).  ``loss_fn``/``train_step`` are the JAX
model's mean cross-entropy and plain SGD step; with ``fused=True`` on the
GPU the filterbank's gradient runs through the backward kernel.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ._common import _fp32_cudnn
from .layers import (AmplitudeToDb, FusedMelspectrogram, Melspectrogram,
                     Pipeline)

__all__ = ["MelFrontendClassifier"]


def _same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"``: ``out = ceil(size / stride)``, with the
    odd pixel of the total padding on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class MelFrontendClassifier(nn.Module):
    """Mel-spectrogram front end + 3-block CNN.

    ``forward(waveform (B, C, T)) -> logits (B, num_classes)``.
    ``trainable_frontend=True`` makes the mel filterbank a parameter
    (``frontend.{i}.filterbank`` in ``state_dict()``).  Weights are
    initialised as the JAX model's (He-normal convs, zero biases) from
    ``generator``; use :func:`~..utils.convert.from_jax_params` to load the
    JAX model's own parameters instead.
    """

    def __init__(self, num_classes: int = 10, num_mels: int = 64,
                 sample_rate: float = 16000, fft_length: int = 512,
                 hop_length: int = 128, trainable_frontend: bool = True,
                 channels: Tuple[int, ...] = (32, 64, 128),
                 fused: bool = False, precision: str = "auto",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.num_mels = num_mels
        self.channels = tuple(channels)
        self.trainable_frontend = trainable_frontend
        if fused:
            # center=False frame semantics, as in the JAX model
            self.frontend = Pipeline(FusedMelspectrogram(
                num_mels=num_mels, sample_rate=sample_rate,
                fft_length=fft_length, hop_length=hop_length,
                trainable=trainable_frontend, precision=precision))
        else:
            mel = Melspectrogram(num_mels=num_mels, sample_rate=sample_rate,
                                 fft_length=fft_length,
                                 hop_length=hop_length,
                                 trainable=trainable_frontend)
            self.frontend = Pipeline(*mel, AmplitudeToDb(power=2.0))
        convs = []
        cin = 1
        for cout in self.channels:
            convs.append(nn.Conv2d(cin, cout, 3, stride=2, padding=0))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.head = nn.Linear(cin, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """He-normal conv weights, ``N(0, 1/cin)`` head, zero biases."""
        for conv in self.convs:
            cin = conv.in_channels
            conv.weight.normal_(0.0, float(np.sqrt(2.0 / (9 * cin))),
                                generator=generator)
            conv.bias.zero_()
        self.head.weight.normal_(0.0, float(np.sqrt(1.0 / self.head.in_features)),
                                 generator=generator)
        self.head.bias.zero_()

    def features(self, waveform: torch.Tensor) -> torch.Tensor:
        """``(B, C, T)`` → log-mel ``(B, C, mels, frames)``."""
        return self.frontend(waveform)

    @_fp32_cudnn
    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        x = self.features(waveform).mean(dim=1, keepdim=True)  # (B,1,M,F)
        for conv in self.convs:
            ph = _same_pad(x.shape[-2], 3, 2)
            pw = _same_pad(x.shape[-1], 3, 2)
            x = F.relu(conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1]))))
        return self.head(x.mean(dim=(-2, -1)))

    def loss_fn(self, waveform: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy of ``forward(waveform)`` against integer
        ``labels (B,)``."""
        return F.cross_entropy(self(waveform), labels.long())

    @_fp32_cudnn
    def train_step(self, waveform: torch.Tensor, labels: torch.Tensor,
                   lr: float = 1e-3) -> torch.Tensor:
        """One plain SGD step, ``p ← p − lr·∂loss/∂p``, on every parameter
        (the filterbank too when it is trainable), in place.  Returns the
        loss before the step, detached."""
        params = [p for p in self.parameters() if p.requires_grad]
        loss = self.loss_fn(waveform, labels)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g)
        return loss.detach()
