"""Signal-quality metrics: SNR, scale-invariant SNR, Fréchet distance.

Port of ``torchaudio_contrib_tpu/ops/metrics.py``: reductions over the last
axis, differentiable and batched over the leading dims.
:func:`frechet_distance` takes its matrix square roots with
``torch.linalg.eigh``, on the tensors' device.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["snr", "si_snr", "frechet_distance"]


def snr(estimate, reference, eps: float = 1e-8):
    """Signal-to-noise ratio in dB along the last axis."""
    estimate, reference = torch.as_tensor(estimate), torch.as_tensor(reference)
    noise = estimate - reference
    p_ref = (reference * reference).sum(-1)
    p_noise = (noise * noise).sum(-1)
    return 10.0 * torch.log10((p_ref + eps) / (p_noise + eps))


def si_snr(estimate, reference, zero_mean: bool = True, eps: float = 1e-8):
    """Scale-invariant SNR (SI-SDR, Le Roux 2019) in dB along the last
    axis: the estimate is projected onto the reference (the optimal gain);
    ``zero_mean`` removes each signal's DC first.  Negate for a loss."""
    estimate, reference = torch.as_tensor(estimate), torch.as_tensor(reference)
    if zero_mean:
        estimate = estimate - estimate.mean(-1, keepdim=True)
        reference = reference - reference.mean(-1, keepdim=True)
    dot = (estimate * reference).sum(-1, keepdim=True)
    p_ref = (reference * reference).sum(-1, keepdim=True)
    target = dot / (p_ref + eps) * reference
    noise = estimate - target
    return 10.0 * torch.log10(((target * target).sum(-1) + eps)
                              / ((noise * noise).sum(-1) + eps))


@contextlib.contextmanager
def full_f32_matmul():
    """Matrix products in full float32 on the card (TF32 off) for the
    duration of the block; the previous setting is restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _sqrtm_psd(mat: torch.Tensor) -> torch.Tensor:
    """Square root of a symmetric PSD stack by eigendecomposition (tiny
    negative eigenvalues from rounding clamped to 0)."""
    w, v = torch.linalg.eigh(mat)
    w = torch.clamp(w, min=0.0)
    return (v * torch.sqrt(w)[..., None, :]) @ v.transpose(-1, -2)


def frechet_distance(mu_x, sigma_x, mu_y, sigma_y):
    """Squared Fréchet (2-Wasserstein) distance between the Gaussians
    ``N(mu_x, sigma_x)`` and ``N(mu_y, sigma_y)`` (the FAD metric):
    ``‖mu_x − mu_y‖² + tr(Σx + Σy − 2·(Σx Σy)^½)``, the cross term as
    ``tr(sqrtm(√Σx · Σy · √Σx))``, so both roots are symmetric ``eigh``
    solves.  Leading batch dims broadcast; products run with TF32 off."""
    mu_x, mu_y = torch.as_tensor(mu_x), torch.as_tensor(mu_y)
    sigma_x, sigma_y = torch.as_tensor(sigma_x), torch.as_tensor(sigma_y)
    if mu_x.shape[-1] != sigma_x.shape[-1] or \
            sigma_x.shape[-1] != sigma_x.shape[-2]:
        raise ValueError(f"mu {tuple(mu_x.shape)} / sigma "
                         f"{tuple(sigma_x.shape)} mismatch")
    if mu_y.shape[-1] != mu_x.shape[-1] or \
            sigma_y.shape[-2:] != sigma_x.shape[-2:]:
        raise ValueError(
            f"y-side shapes mu {tuple(mu_y.shape)} / sigma "
            f"{tuple(sigma_y.shape)} do not match x-side mu "
            f"{tuple(mu_x.shape)} / sigma {tuple(sigma_x.shape)}")
    dtype = torch.promote_types(
        torch.promote_types(mu_x.dtype, mu_y.dtype),
        torch.promote_types(sigma_x.dtype, sigma_y.dtype))
    dtype = torch.promote_types(dtype, torch.float32)
    mu_x, mu_y = mu_x.to(dtype), mu_y.to(dtype)
    sigma_x, sigma_y = sigma_x.to(dtype), sigma_y.to(dtype)
    with full_f32_matmul():
        a = _sqrtm_psd(sigma_x)
        cross = _sqrtm_psd(a @ sigma_y @ a)
    diff = mu_x - mu_y

    def tr(m):
        return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)

    return ((diff * diff).sum(-1) + tr(sigma_x) + tr(sigma_y)
            - 2.0 * tr(cross))
