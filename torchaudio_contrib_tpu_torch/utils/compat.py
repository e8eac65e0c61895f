"""Compatibility helpers bridging the reference's tensor conventions.

The reference (pre-torch-1.8) represents complex spectrograms as real
tensors with a trailing ``(…, 2)`` re/im dim.  The port's native
representation is complex64; these convert losslessly in both directions,
with the JAX package's rules: :func:`view_as_real` raises on real input,
:func:`view_as_complex` passes complex input through and raises unless the
trailing dim is 2.  Unlike ``torch.view_as_real``/``view_as_complex``
they copy (no view of the input is returned), as the JAX functions do.
"""
from __future__ import annotations

import torch

__all__ = ["view_as_real", "view_as_complex"]


def view_as_real(spec: torch.Tensor) -> torch.Tensor:
    """Complex ``(...,)`` → real ``(..., 2)`` trailing re/im view."""
    if not torch.is_complex(spec):
        raise ValueError(f"expected complex input, got {spec.dtype}")
    return torch.stack([spec.real, spec.imag], dim=-1)


def view_as_complex(spec: torch.Tensor) -> torch.Tensor:
    """Real ``(..., 2)`` trailing re/im view → complex tensor."""
    if torch.is_complex(spec):
        return spec
    if spec.shape[-1] != 2:
        raise ValueError(
            f"expected trailing dim 2, got shape {tuple(spec.shape)}")
    return torch.complex(spec[..., 0], spec[..., 1])
