"""WaveRNN vocoder (the fatchord variant torchaudio ships).

Port of ``torchaudio_contrib_tpu/models/wavernn.py``: a mel-conditioned
autoregressive classifier of the next sample.  The conditioning is a
MelResNet (a ``kernel_size``-tap conv eating ``kernel_size − 1`` frames,
``n_res_block`` residual blocks of kernel-1 convs with BatchNorm, an output
conv) stretched to the sample rate, and the spectrogram itself upsampled by
``upsample_scales`` (repeat, then a ``(2s+1)``-tap smoothing conv a scale);
then an input linear, two GRUs with residuals (``nn.GRU``: its ``n`` gate
applies the reset gate to ``W_hn·h + b_hn``, as the JAX ``_gru_cell``) and
three linears over ``n_classes`` bins.

``forward``/``apply(waveform (B, T), specgram (B, n_freq, T_mel))`` →
logits ``(B, T, n_classes)`` of each next sample, with ``T =
hop_length · (T_mel − kernel_size + 1)``.  ``infer(specgram,
generator=None)`` generates a sample at a time (a Python loop of about 15
launches a step on the card) and returns the class centres
``2c/(n_classes − 1) − 1``.  It samples by Gumbel-max from ``generator``
(noise drawn on the generator's device a block of steps at a time), where
the JAX package draws ``jax.random.categorical`` from a key: the random
streams differ, the distribution is the same.

The ``state_dict`` names are torchaudio's
(``upsample.resnet.melresnet_model.{0,1,3…}``,
``upsample.upsample_layers.{2i+1}`` as ``Conv2d(1, 1, (1, 2s+1))``,
``fc``, ``rnn1``, ``rnn2``, ``fc1``-``fc3``), so the JAX package's
``import_wavernn`` loads them.  The BatchNorms act as the JAX model's
frozen affines in eval mode; the module is built in training mode, as
torchaudio's.  ``forward`` and ``infer`` run the convolutions and the GRUs
in FP32 whatever ``torch.backends.cudnn.allow_tf32`` says
(``_common._fp32_cudnn``).  Modules take ``device=`` (the card unless the
caller asks for the CPU) and draw their weights from ``generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ._common import _conv, _dense, _fp32_cudnn, _glorot_

__all__ = ["WaveRNN"]

# steps of Gumbel noise drawn at once by ``infer``
_NOISE_BLOCK = 1024


def _gru(cin: int, h: int, generator) -> nn.GRU:
    gru = nn.GRU(cin, h, batch_first=True)
    _glorot_(gru.weight_ih_l0, cin, 3 * h, generator)
    _glorot_(gru.weight_hh_l0, h, 3 * h, generator)
    nn.init.zeros_(gru.bias_ih_l0)
    nn.init.zeros_(gru.bias_hh_l0)
    return gru


class _ResBlock(nn.Module):
    def __init__(self, h: int, generator):
        super().__init__()
        self.resblock_model = nn.Sequential(
            _conv(h, h, 1, generator, bias=False), nn.BatchNorm1d(h), nn.ReLU(),
            _conv(h, h, 1, generator, bias=False), nn.BatchNorm1d(h))

    def forward(self, x):
        return x + self.resblock_model(x)


class _MelResNet(nn.Module):
    def __init__(self, n_res_block, n_freq, n_hidden, n_output, kernel,
                 generator):
        super().__init__()
        self.melresnet_model = nn.Sequential(
            _conv(n_freq, n_hidden, kernel, generator, bias=False),
            nn.BatchNorm1d(n_hidden), nn.ReLU(),
            *[_ResBlock(n_hidden, generator) for _ in range(n_res_block)],
            _conv(n_hidden, n_output, 1, generator))


class _Stretch(nn.Module):
    """torchaudio's ``Stretch2d(s, 1)``: repeat each frame ``s`` times."""

    def __init__(self, s: int):
        super().__init__()
        self.s = s

    def forward(self, x):
        return x.repeat_interleave(self.s, -1)


class _Upsample(nn.Module):
    def __init__(self, scales, n_res_block, n_freq, n_hidden, n_output,
                 kernel, generator):
        super().__init__()
        self.resnet = _MelResNet(n_res_block, n_freq, n_hidden, n_output,
                                 kernel, generator)
        layers = []
        for s in scales:
            conv = nn.Conv2d(1, 1, (1, 2 * s + 1), padding=(0, s),
                             bias=False)
            nn.init.constant_(conv.weight, 1.0 / (2 * s + 1))
            layers += [_Stretch(s), conv]
        self.upsample_layers = nn.Sequential(*layers)


class WaveRNN(nn.Module):
    """``forward(waveform (B, T), specgram (B, n_freq, T_mel))`` →
    ``(B, T, n_classes)``; ``apply`` is ``forward`` (the JAX package's
    name; it shadows ``nn.Module.apply``); ``infer(specgram,
    generator=None)`` → ``(B, T)``."""

    def __init__(self, upsample_scales: Sequence[int] = (5, 5, 11),
                 n_classes: int = 256, hop_length: int = 275,
                 n_res_block: int = 10, n_rnn: int = 512,
                 n_fc: int = 512, kernel_size: int = 5,
                 n_freq: int = 128, n_hidden: int = 128,
                 n_output: int = 128, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if math.prod(upsample_scales) != hop_length:
            raise ValueError("prod(upsample_scales) must equal hop_length")
        if n_output % 4:
            raise ValueError("n_output must divide by 4 (aux splits)")
        self.scales = tuple(upsample_scales)
        self.n_classes = n_classes
        self.hop = hop_length
        self.n_res_block = n_res_block
        self.n_rnn = n_rnn
        self.kernel = kernel_size
        self.n_freq = n_freq
        self.n_aux = n_output // 4
        self.upsample = _Upsample(self.scales, n_res_block, n_freq,
                                  n_hidden, n_output, kernel_size, generator)
        na = self.n_aux
        self.fc = _dense(1 + n_freq + na, n_rnn, generator)
        self.rnn1 = _gru(n_rnn, n_rnn, generator)
        self.rnn2 = _gru(n_rnn + na, n_rnn, generator)
        self.fc1 = _dense(n_rnn + na, n_fc, generator)
        self.fc2 = _dense(n_fc + na, n_fc, generator)
        self.fc3 = _dense(n_fc, n_classes, generator)
        self.to(device)

    # -- conditioning ------------------------------------------------------
    def _condition(self, specgram):
        """``(B, F, T_mel)`` → cond ``(B, T, F)``, the four aux slices
        ``(B, T, n_aux)``."""
        if specgram.ndim != 3 or specgram.shape[1] != self.n_freq:
            raise ValueError(
                f"specgram must be (batch, {self.n_freq}, frames)")
        aux = self.upsample.resnet.melresnet_model(specgram)
        aux = aux.repeat_interleave(self.hop, -1).transpose(1, 2)
        y = self.upsample.upsample_layers(specgram[:, None])[:, 0]
        trim = (self.kernel - 1) // 2 * self.hop
        cond = y[..., trim:y.shape[-1] - trim].transpose(1, 2)
        return cond, aux.split(self.n_aux, -1)

    # -- forward -----------------------------------------------------------
    @_fp32_cudnn
    def forward(self, waveform: torch.Tensor,
                specgram: torch.Tensor) -> torch.Tensor:
        if waveform.ndim != 2:
            raise ValueError("waveform (B, T), specgram (B, n_freq, Tm)")
        cond, a = self._condition(specgram)
        t = waveform.shape[1]
        if cond.shape[1] != t or a[0].shape[1] != t:
            raise ValueError(f"waveform length {t} != hop*(T_mel-kernel+1)"
                             f" = {cond.shape[1]}")
        x = self.fc(torch.cat([waveform[..., None], cond, a[0]], -1))
        x = self.rnn1(x)[0] + x
        x = self.rnn2(torch.cat([x, a[1]], -1))[0] + x
        x = F.relu(self.fc1(torch.cat([x, a[2]], -1)))
        x = F.relu(self.fc2(torch.cat([x, a[3]], -1)))
        return self.fc3(x)

    apply = forward

    # -- inference -----------------------------------------------------------
    @staticmethod
    def _cell(gru: nn.GRU, x, h):
        return torch.gru_cell(x, h, gru.weight_ih_l0, gru.weight_hh_l0,
                              gru.bias_ih_l0, gru.bias_hh_l0)

    def _gumbel(self, generator, steps: int, b: int, dev):
        """Gumbel noise ``(steps, b, n_classes)`` from ``generator`` on its
        own device, moved to ``dev``."""
        gdev = generator.device if generator is not None else dev
        u = torch.rand((steps, b, self.n_classes), generator=generator,
                       device=gdev).clamp_(min=1e-20)
        return (-torch.log(-torch.log(u))).to(dev)

    @_fp32_cudnn
    def infer(self, specgram: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Autoregressive generation (torchaudio's ``WaveRNN.infer``):
        ``specgram (B, n_freq, T_mel)`` → waveform ``(B, T)`` of class
        centres in [−1, 1], each step's class drawn from its softmax by
        Gumbel-max."""
        cond, a = self._condition(specgram)
        B, T = cond.shape[:2]
        dev = cond.device
        h1 = cond.new_zeros((B, self.n_rnn))
        h2 = cond.new_zeros((B, self.n_rnn))
        prev = cond.new_zeros((B, 1))
        out = cond.new_empty((B, T))
        # the class centres as a table made on the CPU: a device's own
        # division may round differently (a product by the reciprocal)
        centres = (2.0 * torch.arange(self.n_classes, dtype=torch.float32)
                   / (self.n_classes - 1) - 1.0).to(dev)
        for t in range(T):
            if t % _NOISE_BLOCK == 0:
                noise = self._gumbel(generator, min(_NOISE_BLOCK, T - t), B,
                                     dev)
            x = self.fc(torch.cat([prev, cond[:, t], a[0][:, t]], -1))
            h1 = self._cell(self.rnn1, x, h1)
            x = h1 + x
            h2 = self._cell(self.rnn2, torch.cat([x, a[1][:, t]], -1), h2)
            x = h2 + x
            x = F.relu(self.fc1(torch.cat([x, a[2][:, t]], -1)))
            x = F.relu(self.fc2(torch.cat([x, a[3][:, t]], -1)))
            cls = (self.fc3(x) + noise[t % _NOISE_BLOCK]).argmax(-1)
            prev = centres[cls][:, None]
            out[:, t] = prev[:, 0]
        return out
