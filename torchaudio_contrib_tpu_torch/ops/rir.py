"""Shoebox room impulse response via the image-source method (ISM).

Port of ``torchaudio_contrib_tpu/ops/rir.py`` (torchaudio's
``simulate_rir_ism``: rectangular room, frequency-flat wall absorption).
The image lattice, its reflection counts and attenuations are a float64
NumPy build on the host; the distances, the Hann-windowed fractional-delay
sinc taps of every image at every microphone and their sum into the
responses run as tensor ops, the sum as one ``index_add_`` over all the
microphones' rows.  On the card that sum adds with float atomics, so its order (and the
last bits of the result) varies from run to run.

Amplitude convention: ``1/(4π·dist)`` spherical spreading, direct path
included.  Apply a response to a waveform with
:func:`~.convolve.fftconvolve`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["simulate_rir_ism"]


def simulate_rir_ism(room, source, mic_array, max_order: int = 3,
                     absorption=0.3, output_length: int | None = None,
                     delay_filter_length: int = 81,
                     sound_speed: float = 343.0,
                     sample_rate: float = 16000.0) -> torch.Tensor:
    """Room impulse responses ``(n_mics, rir_length)``.

    ``room`` is ``(3,)`` box dimensions in meters, ``source`` ``(3,)``,
    ``mic_array`` ``(n_mics, 3)`` (all inside the room).
    ``absorption`` is a scalar or ``(6,)`` per-wall energy absorption in
    ``[0, 1)`` — order ``(x0, x1, y0, y1, z0, z1)`` walls (frequency-flat;
    band-dependent absorption is out of scope and raises).
    ``output_length`` fixes the RIR length (default: the max image delay
    + filter length, computed on the host).  ``delay_filter_length`` must
    be odd (centered sinc).  The responses are computed on the device of
    ``mic_array`` if it is a tensor, else on the card (``"cuda"``).
    """
    if delay_filter_length % 2 != 1:
        raise ValueError("delay_filter_length must be odd")
    if max_order < 0:
        raise ValueError("max_order must be >= 0")
    room_np = np.asarray(room, np.float64)
    if room_np.shape != (3,):
        raise ValueError("room must be (3,) box dimensions")
    alpha = np.asarray(absorption, np.float64)
    if alpha.ndim == 0:
        alpha = np.full(6, float(alpha))
    if alpha.shape != (6,):
        raise ValueError(
            "absorption must be a scalar or (6,) per-wall values "
            "(band-dependent absorption is not supported)")
    if np.any(alpha < 0) or np.any(alpha >= 1):
        raise ValueError("absorption must be in [0, 1)")
    refl = np.sqrt(1.0 - alpha)                   # amplitude coefficients
    device = (mic_array.device if isinstance(mic_array, torch.Tensor)
              else "cuda")

    source = torch.as_tensor(source, dtype=torch.float32).to(device)
    mics = torch.as_tensor(mic_array, dtype=torch.float32).to(device)
    mics = mics.reshape(-1, 3)

    n_rng = np.arange(-max_order, max_order + 1)
    nx, ny, nz, px, py, pz = np.meshgrid(
        n_rng, n_rng, n_rng, [0, 1], [0, 1], [0, 1], indexing="ij")
    n = np.stack([nx, ny, nz], -1).reshape(-1, 3)   # (n_img, 3)
    p = np.stack([px, py, pz], -1).reshape(-1, 3)
    # reflection counts: wall d0 hit |n_d − p_d| times, wall d1 |n_d|
    hits0 = np.abs(n - p)
    hits1 = np.abs(n)
    order = (hits0 + hits1).sum(-1)
    keep = order <= max_order
    n, p = n[keep], p[keep]
    # amplitude attenuation from wall absorption (float64 host build)
    logr = np.concatenate([np.log(np.maximum(refl[0::2], 1e-300))[None],
                           np.log(np.maximum(refl[1::2], 1e-300))[None]])
    att = np.exp((hits0[keep] * logr[0] + hits1[keep] * logr[1])
                 .sum(-1))                         # (n_img,)

    def dev32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    sign = dev32(1.0 - 2.0 * p)                         # (n_img, 3)
    offs = dev32(2.0 * n * room_np)
    img = sign * source + offs                          # (n_img, 3)

    dist = torch.linalg.vector_norm(img[:, None, :] - mics[None, :, :],
                                    dim=-1)             # (n_img, n_mics)
    dist = torch.clamp(dist, min=1e-3)
    delay = dist * (sample_rate / sound_speed)
    amp = dev32(att)[:, None] / (4.0 * np.pi * dist)

    half = delay_filter_length // 2
    if output_length is None:
        # host-side bound: the farthest image corner
        far = np.linalg.norm(np.abs(room_np) * (2 * max_order + 2))
        output_length = int(math.ceil(far * sample_rate / sound_speed)
                            + delay_filter_length)
    t_len = int(output_length)

    # fractional-delay sinc taps around each integer delay
    base = torch.floor(delay)                           # (n_img, n_mics)
    frac = delay - base
    k = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    arg = k[None, None, :] - frac[..., None]            # (img, mic, taps)
    win = 0.5 * (1.0 + torch.cos(np.pi * arg / (half + 1)))
    win = torch.where(torch.abs(arg) <= half + 1, win, 0.0)
    taps = torch.sinc(arg) * win * amp[..., None]

    idx = base.to(torch.int64)[..., None] + torch.arange(
        -half, half + 1, device=device)                 # (img, mic, taps)
    valid = (idx >= 0) & (idx < t_len)
    idx = torch.clamp(idx, 0, t_len - 1)
    taps = torch.where(valid, taps, 0.0)

    n_mics = mics.shape[0]
    # one index_add_ over every mic row: (n_img·taps) values per row
    flat_idx = (idx.transpose(0, 1).reshape(n_mics, -1)
                + torch.arange(n_mics, device=device)[:, None] * t_len)
    flat_val = taps.transpose(0, 1).reshape(-1)
    rir = torch.zeros(n_mics * t_len, dtype=torch.float32, device=device)
    rir.index_add_(0, flat_idx.reshape(-1), flat_val)
    return rir.view(n_mics, t_len)
