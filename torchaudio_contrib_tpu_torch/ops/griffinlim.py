"""Griffin-Lim phase reconstruction.

Port of ``torchaudio_contrib_tpu/ops/griffinlim.py``: recover a waveform
from a magnitude spectrogram by alternating projections, the momentum
variant of Perraudin et al. 2013.  The ``fft`` and ``matmul`` methods loop
over :func:`~.stft.istft` / :func:`~.stft.stft` round trips; ``pallas``
(the JAX package's name for its fused kernel, kept for compatibility) runs
the whole loop through the hand-written CUDA kernels of
:mod:`.fused_griffinlim`.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from .fused_griffinlim import (RULE, fused_gl_supported, _gl_fused,
                               _random_phase)
from .stft import stft as _stft, istft as _istft, stft_output_length

__all__ = ["griffin_lim"]


def griffin_lim(mag_specgrams: torch.Tensor,
                fft_length: Optional[int] = None,
                hop_length: Optional[int] = None,
                window="hann",
                n_iter: int = 32,
                momentum: float = 0.99,
                length: Optional[int] = None,
                center: bool = True,
                generator: Optional[torch.Generator] = None,
                method: str = "fft") -> torch.Tensor:
    """Reconstruct a waveform from magnitudes ``(..., freq, time)``.

    ``mag_specgrams`` is a *magnitude* (power 1) spectrogram.  Returns
    ``(..., samples)``.  ``generator`` seeds the initial random phase, in
    the place of the JAX package's ``key``; the phase is zero when it is
    None (deterministic, and converges similarly with momentum).

    ``method`` selects how the inner loop's transforms run: ``"fft"``
    (``torch.fft``), ``"matmul"`` (DFT matrices), or ``"pallas"``: the whole
    loop as the fused kernels of :mod:`.fused_griffinlim`, with free-edge
    boundary semantics (see there).  On a CUDA tensor an eligible
    configuration launches the kernels or raises; on a CPU tensor it runs
    their plain version.  A configuration outside
    :func:`~.fused_griffinlim.fused_gl_supported` runs ``"matmul"`` with a
    ``UserWarning``.
    """
    n_freqs, n_frames = mag_specgrams.shape[-2:]
    if fft_length is None:
        fft_length = 2 * (n_freqs - 1)
    if hop_length is None:
        hop_length = fft_length // 4
    if length is None:
        length = stft_output_length(n_frames, fft_length, hop_length,
                                    center=center)
    if momentum < 0 or momentum >= 1:
        raise ValueError("momentum must be in [0, 1)")

    if method == "pallas":
        if fused_gl_supported(fft_length, hop_length, n_frames):
            return _gl_fused(mag_specgrams, fft_length, hop_length, window,
                             n_iter, momentum, length, center,
                             generator=generator)
        warnings.warn(
            f"griffin_lim(method='pallas'): config fft={fft_length} "
            f"hop={hop_length} n_frames={n_frames} is outside the fused "
            f"kernels' rule ({RULE}); falling back to method='matmul'",
            stacklevel=2)
        method = "matmul"

    mag = mag_specgrams.to(torch.float32)
    if generator is not None:
        spec = torch.polar(mag, _random_phase(mag.shape, generator,
                                              mag.device))
    else:
        spec = torch.complex(mag, torch.zeros_like(mag))

    def project(s):
        """istft → stft: project onto the set of consistent spectrograms."""
        y = _istft(s, hop_length, window=window, center=center,
                   length=length, fft_length=fft_length, method=method)
        return _stft(y, fft_length, hop_length, window=window,
                     center=center, method=method)

    prev = torch.zeros_like(spec)
    for _ in range(n_iter):
        rebuilt = project(spec)
        # momentum acceleration on the unnormalised phase estimate
        update = rebuilt + momentum * (rebuilt - prev)
        update = update / torch.clamp(torch.abs(update), min=1e-16)
        spec, prev = mag * update, rebuilt
    return _istft(spec, hop_length, window=window, center=center,
                  length=length, fft_length=fft_length, method=method)
