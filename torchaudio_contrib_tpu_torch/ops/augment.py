"""SpecAugment-style spectrogram masking (Park et al. 2019).

Port of ``torchaudio_contrib_tpu/ops/augment.py``.  A mask is a comparison
of an index ramp with a random start and width, one ``where`` per mask, so
the gradient passes through unchanged outside the masked bands.  The
randomness comes from an explicit ``torch.Generator`` where the JAX
package takes a PRNG ``key``, in the same place (first) and possibly None
(the global generator).  The draws differ between the packages; the
semantics do not: each mask draws its width from ``U{0..mask_param}``,
then its start from ``U{0..max(size − width, 1) − 1}``.  The draws are
made on the generator's device and the masks are built on the
spectrogram's.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["mask_along_axis", "mask_along_axis_iid", "time_mask",
           "freq_mask"]


def _randint(high: int, generator: Optional[torch.Generator]) -> int:
    device = generator.device if generator is not None else "cpu"
    return int(torch.randint(0, high, (), generator=generator,
                             device=device))


def mask_along_axis(generator: Optional[torch.Generator],
                    spec: torch.Tensor, mask_param: int, axis: int,
                    num_masks: int = 1,
                    mask_value: float = 0.0) -> torch.Tensor:
    """Fill ``num_masks`` random contiguous bands along ``axis`` with
    ``mask_value``.  Each band's width is drawn from ``U{0..mask_param}``
    and its start uniformly; the same bands apply across the leading
    dims (see :func:`mask_along_axis_iid` for one set per example)."""
    if mask_param <= 0:
        return spec
    axis = axis % spec.ndim
    size = spec.shape[axis]
    shape = [1] * spec.ndim
    shape[axis] = size
    idx = torch.arange(size, device=spec.device).view(shape)
    out = spec
    for _ in range(num_masks):
        width = _randint(mask_param + 1, generator)
        start = _randint(max(size - width, 1), generator)
        band = (idx >= start) & (idx < start + width)
        out = torch.where(band, torch.as_tensor(mask_value, dtype=spec.dtype,
                                                device=spec.device), out)
    return out


def time_mask(generator: Optional[torch.Generator], spec: torch.Tensor,
              mask_param: int, num_masks: int = 1,
              mask_value: float = 0.0) -> torch.Tensor:
    """Mask random time bands of ``(..., freq, time)``."""
    return mask_along_axis(generator, spec, mask_param, -1, num_masks,
                           mask_value)


def freq_mask(generator: Optional[torch.Generator], spec: torch.Tensor,
              mask_param: int, num_masks: int = 1,
              mask_value: float = 0.0) -> torch.Tensor:
    """Mask random frequency bands of ``(..., freq, time)``."""
    return mask_along_axis(generator, spec, mask_param, -2, num_masks,
                           mask_value)


def mask_along_axis_iid(generator: Optional[torch.Generator],
                        specs: torch.Tensor, mask_param: int, axis: int,
                        num_masks: int = 1,
                        mask_value: float = 0.0) -> torch.Tensor:
    """Independent bands for each element of the leading batch dim
    (torchaudio's ``mask_along_axis_iid``)."""
    if specs.ndim < 2:
        raise ValueError("mask_along_axis_iid needs a leading batch dim")
    axis = axis % specs.ndim
    if axis == 0:
        raise ValueError("cannot mask the batch axis")
    return torch.stack([mask_along_axis(generator, s, mask_param, axis - 1,
                                        num_masks, mask_value)
                        for s in specs])
