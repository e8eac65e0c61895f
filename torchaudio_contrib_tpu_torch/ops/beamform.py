"""Multichannel beamforming: PSD matrices, RTF estimation, MVDR.

Port of ``torchaudio_contrib_tpu/ops/beamform.py`` (torchaudio's ``psd``,
``mvdr_weights_souden``, ``mvdr_weights_rtf``, ``rtf_evd``, ``rtf_power``,
``apply_beamforming``).  Batched complex64 einsums over ``(…, freq,
channel, channel)`` stacks and ``torch.linalg`` solves and
eigendecompositions of the small C×C problems; every product runs with
TF32 off (:func:`~.metrics.full_f32_matmul`), full float32 on the card.

Shapes: spectrograms ``(…, channel, freq, time)`` complex; PSD stacks
``(…, freq, channel, channel)``; weights ``(…, freq, channel)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .metrics import full_f32_matmul

__all__ = [
    "psd",
    "mvdr_weights_souden",
    "mvdr_weights_rtf",
    "rtf_evd",
    "rtf_power",
    "apply_beamforming",
]


def _complex(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.complex64))


def psd(specgram: torch.Tensor, mask: Optional[torch.Tensor] = None,
        normalize: bool = True, eps: float = 1e-10) -> torch.Tensor:
    """Cross-channel power spectral density per frequency, ``(…, freq,
    channel, channel)``.  ``mask (…, freq, time)`` weights the
    time-frequency points (e.g. a speech presence probability);
    ``normalize`` divides by the mask's sum per frequency (by the frame
    count without a mask)."""
    spec = _complex(specgram)
    with full_f32_matmul():
        if mask is not None:
            m = mask.to(spec.real.dtype)
            out = torch.einsum("...cft,...eft->...fce",
                               spec * m[..., None, :, :], spec.conj())
            if normalize:
                out = out / (m.sum(dim=-1)[..., None, None] + eps)
        else:
            out = torch.einsum("...cft,...eft->...fce", spec, spec.conj())
            if normalize:
                out = out / spec.shape[-1]
    return out


def _diag_load(mat: torch.Tensor, eps_scale: float) -> torch.Tensor:
    """Tikhonov-load a Hermitian stack: ``M + ε·tr(M)/C·I``."""
    c = mat.shape[-1]
    tr = torch.diagonal(mat, dim1=-2, dim2=-1).sum(-1).real / c
    eye = torch.eye(c, dtype=mat.dtype, device=mat.device)
    return mat + (eps_scale * tr[..., None, None] + 1e-12) * eye


def mvdr_weights_souden(psd_s: torch.Tensor, psd_n: torch.Tensor,
                        reference_channel: int = 0,
                        diagonal_loading: bool = True,
                        diag_eps: float = 1e-7) -> torch.Tensor:
    """MVDR weights by Souden's formulation: ``w = (Φₙ⁻¹ Φₛ / tr(Φₙ⁻¹
    Φₛ))·e_ref`` per ``(…, freq)``, ``Φₙ`` loaded first when
    ``diagonal_loading``.  Returns ``(…, freq, channel)``."""
    psd_n = _complex(psd_n)
    psd_s = psd_s.to(psd_n.dtype)
    if diagonal_loading:
        psd_n = _diag_load(psd_n, diag_eps)
    with full_f32_matmul():
        num = torch.linalg.solve(psd_n, psd_s)
    tr = torch.diagonal(num, dim1=-2, dim2=-1).sum(-1)
    return num[..., reference_channel] / (tr[..., None] + 1e-10)


def mvdr_weights_rtf(rtf: torch.Tensor, psd_n: torch.Tensor,
                     reference_channel: int = 0,
                     diagonal_loading: bool = True,
                     diag_eps: float = 1e-7) -> torch.Tensor:
    """MVDR weights from a relative transfer function ``(…, freq,
    channel)``: ``w = (Φₙ⁻¹ v) / (vᴴ Φₙ⁻¹ v) · conj(v[ref])`` (the last
    factor leaves the reference channel undistorted, torchaudio's
    semantics)."""
    psd_n = _complex(psd_n)
    rtf = rtf.to(psd_n.dtype)
    if diagonal_loading:
        psd_n = _diag_load(psd_n, diag_eps)
    with full_f32_matmul():
        num = torch.linalg.solve(psd_n, rtf[..., None])[..., 0]
        den = torch.einsum("...c,...c->...", rtf.conj(), num)
    w = num / (den[..., None] + 1e-10)
    return w * rtf[..., reference_channel, None].conj()


def rtf_evd(psd_s: torch.Tensor, reference_channel: int = 0) -> torch.Tensor:
    """The RTF as the principal eigenvector of the speech PSD per frequency
    (Hermitian ``eigh``), scaled so that the reference channel is 1."""
    psd_s = _complex(psd_s)
    _, vecs = torch.linalg.eigh(psd_s)            # ascending eigenvalues
    v = vecs[..., -1]
    return v / (v[..., reference_channel, None] + 1e-15)


def rtf_power(psd_s: torch.Tensor, psd_n: torch.Tensor,
              reference_channel: int = 0, n_iter: int = 3,
              diagonal_loading: bool = True,
              diag_eps: float = 1e-7) -> torch.Tensor:
    """The RTF by ``n_iter`` power iterations on ``Φₙ⁻¹ Φₛ`` (solves only,
    no eigendecomposition), mapped back through ``Φₛ`` and normalised to
    the reference channel."""
    if n_iter < 1:
        raise ValueError("n_iter must be >= 1")
    psd_n = _complex(psd_n)
    psd_s = psd_s.to(psd_n.dtype)
    if diagonal_loading:
        psd_n = _diag_load(psd_n, diag_eps)
    with full_f32_matmul():
        phi = torch.linalg.solve(psd_n, psd_s)
        v = torch.zeros(psd_s.shape[:-1], dtype=psd_s.dtype,
                        device=psd_s.device)
        v[..., reference_channel] = 1.0
        for _ in range(n_iter - 1):
            v = torch.einsum("...ce,...e->...c", phi, v)
            v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True)
                     + 1e-15)
        rtf = torch.einsum("...ce,...e->...c", psd_s, v)
    return rtf / (rtf[..., reference_channel, None] + 1e-15)


def apply_beamforming(beamform_weights: torch.Tensor,
                      specgram: torch.Tensor) -> torch.Tensor:
    """``y[f, t] = Σ_c conj(w[f, c])·x[c, f, t]``: weights ``(…, freq,
    channel)`` on ``(…, channel, freq, time)`` → ``(…, freq, time)``."""
    spec = _complex(specgram)
    w = beamform_weights.to(spec.dtype)
    with full_f32_matmul():
        return torch.einsum("...fc,...cft->...ft", w.conj(), spec)
