"""μ-law companding codec.

Port of ``torchaudio_contrib_tpu/ops/mulaw.py``.  Input waveforms are
assumed normalised to [-1, 1]; encoding maps to integers in
``[0, n_quantize-1]``; ``decode(encode(x)) ≈ x`` within one quantisation
step.  The encode's round-to-int is not differentiable; decoding is.
"""
from __future__ import annotations

import math

import torch

__all__ = ["mu_law_encoding", "mu_law_decoding"]


def mu_law_encoding(x: torch.Tensor, n_quantize: int = 256) -> torch.Tensor:
    """Compand ``x ∈ [-1, 1]`` to int32 codes in ``[0, n_quantize-1]``.
    Inputs outside [-1, 1] are clamped so codes always stay in range."""
    mu = float(n_quantize - 1)
    x = torch.clamp(x, -1.0, 1.0)
    x_mu = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)
    return ((x_mu + 1.0) / 2.0 * mu + 0.5).to(torch.int32)


def mu_law_decoding(x_mu: torch.Tensor, n_quantize: int = 256,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Expand integer codes back to waveform amplitudes in [-1, 1]."""
    mu = float(n_quantize - 1)
    x = x_mu.to(dtype) / mu * 2.0 - 1.0
    return torch.sign(x) * torch.expm1(torch.abs(x) * math.log1p(mu)) / mu
