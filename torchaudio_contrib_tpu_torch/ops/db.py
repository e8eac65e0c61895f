"""Decibel conversion.

Port of ``torchaudio_contrib_tpu/ops/db.py``.  ``amplitude_to_db`` treats
the input as an amplitude and uses ``20·log10``; for power inputs pass
``power=2`` for the ``10·log10`` convention.
"""
from __future__ import annotations

import math

import torch

__all__ = ["amplitude_to_db", "db_to_amplitude",
           "amplitude_to_DB", "DB_to_amplitude"]


def amplitude_to_db(x: torch.Tensor, ref: float = 1.0, amin: float = 1e-7,
                    power: float = 1.0,
                    top_db: float | None = None) -> torch.Tensor:
    """Log-compress ``x`` to decibels: ``(20/power)·log10(clamp(x, amin)/ref)``.

    ``amin`` clamps the input away from 0.  ``top_db`` clamps the result
    to ``[max - top_db, max]``, with the max taken over each
    spectrogram's (freq, time) plane independently.
    """
    if amin <= 0:
        raise ValueError("amin must be > 0")
    mult = 20.0 / power
    x_db = mult * torch.log10(torch.clamp(x, min=amin))
    x_db = x_db - mult * math.log10(max(amin, ref))
    if top_db is not None:
        if top_db < 0:
            raise ValueError("top_db must be >= 0")
        dims = tuple(range(max(x_db.ndim - 2, 0), x_db.ndim))
        peak = torch.amax(x_db, dim=dims, keepdim=True)
        x_db = torch.maximum(x_db, peak - top_db)
    return x_db


def db_to_amplitude(x_db: torch.Tensor, ref: float = 1.0,
                    power: float = 1.0) -> torch.Tensor:
    """Inverse of :func:`amplitude_to_db` (exact above the ``amin`` clamp)."""
    mult = 20.0 / power
    return ref * torch.pow(10.0, x_db / mult)


def amplitude_to_DB(x: torch.Tensor, multiplier: float, amin: float,
                    db_multiplier: float,
                    top_db: float | None = None) -> torch.Tensor:
    """torchaudio-signature dB conversion:
    ``multiplier·log10(clamp(x, amin)) − multiplier·db_multiplier``.
    The ``top_db`` clamp peaks over the trailing (channel, freq, time)
    volume when the input has more than two dims, else over (freq, time).
    """
    if amin <= 0:
        raise ValueError("amin must be > 0")
    x_db = (multiplier * torch.log10(torch.clamp(x, min=amin))
            - multiplier * db_multiplier)
    if top_db is not None:
        if top_db < 0:
            raise ValueError("top_db must be >= 0")
        n_peak = 3 if x_db.ndim > 2 else 2
        dims = tuple(range(x_db.ndim - n_peak, x_db.ndim))
        peak = torch.amax(x_db, dim=dims, keepdim=True)
        x_db = torch.maximum(x_db, peak - top_db)
    return x_db


def DB_to_amplitude(x_db: torch.Tensor, ref: float,
                    power: float) -> torch.Tensor:
    """torchaudio-signature inverse: ``ref · (10^(x/10))^power``."""
    return ref * torch.pow(torch.pow(10.0, 0.1 * x_db), power)
