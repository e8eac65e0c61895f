"""Complex-spectrogram utilities: magnitude, phase, magphase.

Port of ``torchaudio_contrib_tpu/ops/complexops.py``.  Operates on native
complex tensors and accepts the legacy trailing-``(…, 2)`` real view
(auto-detected on real inputs whose last dim is 2).
"""
from __future__ import annotations

import torch

__all__ = ["complex_norm", "angle", "magphase"]


def _re_im(x: torch.Tensor):
    if x.is_complex():
        return x.real, x.imag
    if x.shape[-1] == 2:
        return x[..., 0], x[..., 1]
    raise ValueError(
        "expected a complex tensor or a real tensor with trailing dim 2, "
        f"got dtype={x.dtype} shape={tuple(x.shape)}")


def complex_norm(spec: torch.Tensor, power: float = 1.0) -> torch.Tensor:
    """``|spec|**power``.  power=1 → magnitude, power=2 → power spectrogram.

    The power=2 case is computed as ``re²+im²`` directly (no sqrt), so its
    gradient at 0 is defined.
    """
    re, im = _re_im(spec)
    sq = re * re + im * im
    if power == 2.0:
        return sq
    if power == 1.0:
        return torch.sqrt(sq)
    return torch.pow(sq, power / 2.0)


def angle(spec: torch.Tensor) -> torch.Tensor:
    """Element-wise phase ``atan2(im, re)``."""
    re, im = _re_im(spec)
    return torch.atan2(im, re)


def magphase(spec: torch.Tensor, power: float = 1.0):
    """Separate a complex spectrogram into ``(|spec|**power, phase)``."""
    return complex_norm(spec, power), angle(spec)
