"""VGGish: the AudioSet audio-embedding CNN (Hershey et al. 2017).

Port of ``torchaudio_contrib_tpu/models/vggish.py``.  :class:`VGGish` has
the public ``torchvggish`` layout and ``state_dict`` names (which the JAX
package's ``import_vggish`` reads): four VGG blocks of 3×3 convs with
ReLU (64 → 128 → 256×2 → 512×2, ``features.{0,3,6,8,11,13}``) and 2×2 max
pools over ``(N, 1, 96, 64)`` log-mel patches, flattened in (H, W, C)
order (the JAX model's NHWC flatten), then three ReLU linears
(12288 → 4096 → 4096 → 128, ``embeddings.{0,2,4}``).  ``forward`` runs
the convolutions in FP32 whatever ``torch.backends.cudnn.allow_tf32``
says, and so does a backward pass through its output
(``_common._fp32_cudnn``).

:class:`VGGishInputProcessor` is the published ``mel_features`` front
end: a periodic Hann window of 400 samples in a 512-point FFT every 160
samples with no centring, the magnitude spectrum, the HTK mel matrix
(built in float64, DC row zeroed, no normalisation), ``log(mel + 0.01)``
and non-overlapping 96-frame patches.  It runs on the device of the
waveform it is given.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ._common import _fp32_cudnn, _glorot_

__all__ = ["VGGish", "VGGishInputProcessor"]

# (cin, cout) per conv; a 2x2 pool follows convs 0, 1, 3 and 5
_CONVS = ((1, 64), (64, 128), (128, 256), (256, 256), (256, 512),
          (512, 512))
_POOL_AFTER = (0, 1, 3, 5)


class VGGish(nn.Module):
    """``forward(x)`` → ``(N, 128)`` embeddings; ``x`` is a batch of
    log-mel patches ``(N, 96, 64)`` or ``(N, 1, 96, 64)``."""

    in_frames = 96
    in_bands = 64
    embedding_dim = 128

    def __init__(self, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = []
        for i, (cin, cout) in enumerate(_CONVS):
            conv = nn.Conv2d(cin, cout, 3, padding=1)
            _glorot_(conv.weight, 9 * cin, 9 * cout, generator)
            nn.init.zeros_(conv.bias)
            layers += [conv, nn.ReLU()]
            if i in _POOL_AFTER:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        flat = (self.in_frames // 16) * (self.in_bands // 16) * 512
        fcs = []
        for cin, cout in ((flat, 4096), (4096, 4096), (4096, 128)):
            lin = nn.Linear(cin, cout)
            _glorot_(lin.weight, cin, cout, generator)
            nn.init.zeros_(lin.bias)
            fcs += [lin, nn.ReLU()]
        self.embeddings = nn.Sequential(*fcs)
        self.to(device)

    @_fp32_cudnn
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            if x.shape[1] != 1:
                raise ValueError(
                    f"expected a single input channel, got {tuple(x.shape)}")
            x = x[:, 0]
        if tuple(x.shape[-2:]) != (self.in_frames, self.in_bands):
            raise ValueError(f"expected (N, {self.in_frames}, "
                             f"{self.in_bands}) patches, got {tuple(x.shape)}")
        x = self.features(x[:, None])                 # (N, 512, 6, 4)
        return self.embeddings(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


@functools.lru_cache(maxsize=4)
def _mel_matrix(num_bins: int, sample_rate: float, n_mels: int,
                f_min: float, f_max: float) -> np.ndarray:
    """``mel_features.spectrogram_to_mel_matrix``: HTK mel scale,
    unnormalised triangles over linearly spaced FFT-bin frequencies, DC
    row zeroed; float64."""
    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)
    bins_mel = mel(np.linspace(0.0, sample_rate / 2.0, num_bins))
    edges = np.linspace(mel(f_min), mel(f_max), n_mels + 2)
    lo, ce, hi = edges[:-2], edges[1:-1], edges[2:]
    lower = (bins_mel[:, None] - lo[None]) / (ce - lo)[None]
    upper = (hi[None] - bins_mel[:, None]) / (hi - ce)[None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights[0, :] = 0.0
    return weights


class VGGishInputProcessor:
    """Waveform (16 kHz) → ``(N, 96, 64)`` log-mel patches for
    :class:`VGGish`.  Takes ``(T,)`` mono or ``(C, T)`` (averaged over
    channels); trailing samples that do not fill a 96-frame patch are
    dropped."""

    sample_rate = 16000

    def __init__(self):
        sr = self.sample_rate
        self.win = int(round(sr * 0.025))                 # 400
        self.hop = int(round(sr * 0.010))                 # 160
        self.fft = 2 ** int(np.ceil(np.log2(self.win)))   # 512
        n = np.arange(self.win, dtype=np.float64)
        self._window = torch.tensor(
            0.5 - 0.5 * np.cos(2.0 * np.pi / self.win * n), dtype=torch.float32)
        self._mel = torch.tensor(
            _mel_matrix(self.fft // 2 + 1, sr, 64, 125.0, 7500.0),
            dtype=torch.float32)

    def __call__(self, waveform) -> torch.Tensor:
        x = torch.as_tensor(waveform, dtype=torch.float32)
        if x.ndim == 2:
            x = x.mean(0)
        if x.ndim != 1:
            raise ValueError(
                f"expected (T,) or (channels, T), got {tuple(x.shape)}")
        if x.shape[0] < self.win:
            raise ValueError(
                f"need at least {self.win} samples, got {x.shape[0]}")
        frames = x.unfold(0, self.win, self.hop) * self._window.to(x.device)
        n_frames = frames.shape[0]
        n_patches = n_frames // VGGish.in_frames
        if n_patches < 1:
            raise ValueError(
                f"waveform too short: {n_frames} mel frames < "
                f"{VGGish.in_frames} (need ~0.975 s at 16 kHz)")
        mag = torch.fft.rfft(frames, self.fft).abs()
        logmel = torch.log(mag @ self._mel.to(x.device) + 0.01)
        return logmel[:n_patches * VGGish.in_frames].reshape(
            n_patches, VGGish.in_frames, VGGish.in_bands)
