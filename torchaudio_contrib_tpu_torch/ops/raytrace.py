"""Stochastic acoustic ray tracing for shoebox rooms (``ray_tracing``,
the torchaudio prototype surface).

Port of ``torchaudio_contrib_tpu/ops/raytrace.py``, with its energy model:

- ``num_rays`` directions from a deterministic Fibonacci sphere.
- Each ray carries per-band energy ``1 / num_rays``; specular reflection
  at the six axis-aligned walls multiplies it by ``1 − absorption[band,
  wall]``.
- A ray whose segment passes within ``mic_radius`` of a microphone
  deposits its current energy into that channel's histogram at the
  closest-approach time.
- ``scattering``: at every wall hit a ``scattering`` fraction of the
  post-absorption energy goes straight to each microphone, weighted by
  the mic sphere's solid-angle fraction seen from the hit point; the
  specular ray continues with the rest.

All rays advance in lockstep: the JAX package's ``lax.scan`` over
``max_bounces`` is a loop over bounces here, each one tensor ops over all
rays and microphones.  The geometry is written as elementwise operations
(no matrix product, no reduction whose order a device may choose), so the
CPU and the card take the same decisions; the deposits are one
``index_add_`` a bounce into a histogram with bands innermost and an
overflow slot, which on the card adds with float atomics (last bits vary
from run to run).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["ray_tracing"]


def _fibonacci_sphere(n: int) -> np.ndarray:
    """(n, 3) unit vectors, near-uniform on the sphere."""
    i = np.arange(n, dtype=np.float64) + 0.5
    z = 1.0 - 2.0 * i / n
    phi = (2.0 * math.pi * (2.0 - (1.0 + math.sqrt(5.0)) / 2.0)) * i
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Σ_k a[..., k]·b[..., k]`` over the last axis of 3, in that order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def ray_tracing(room, source, mic_array, num_rays: int,
                absorption=0.0, scattering: float = 0.0,
                mic_radius: float = 0.5,
                sound_speed: float = 343.0,
                energy_thres: float = 1e-7,
                time_thres: float = 10.0,
                hist_bin_size: float = 0.004,
                max_bounces: Optional[int] = None) -> torch.Tensor:
    """Energy histograms ``(channels, num_bands, num_bins)`` for a
    shoebox room.

    ``room (3,)`` dimensions (meters, walls at 0 and ``room[i]``);
    ``source (3,)``; ``mic_array (channels, 3)`` (a single ``(3,)``
    mic is promoted).  ``absorption`` is a scalar or
    ``(num_bands, 6)`` per-band/per-wall energy absorption in
    ``[0, 1]`` — wall order ``(-x, +x, -y, +y, -z, +z)``.
    ``num_bins = ceil(time_thres / hist_bin_size)``.  The rays are traced
    on the device of ``mic_array`` if it is a tensor, else on the card
    (``"cuda"``).
    """
    device = "cuda"
    if isinstance(mic_array, torch.Tensor):
        device = mic_array.device
        mic_array = mic_array.detach().cpu().numpy()
    room_np = np.asarray(room, np.float64).reshape(3)
    src_np = np.asarray(source, np.float64).reshape(3)
    mics_np = np.atleast_2d(np.asarray(mic_array, np.float64))
    if mics_np.shape[-1] != 3 or mics_np.ndim != 2:
        raise ValueError("mic_array must be (channels, 3)")
    if (room_np <= 0).any():
        raise ValueError("room dimensions must be positive")
    for name, pts in (("source", src_np[None]), ("mic", mics_np)):
        if (pts < 0).any() or (pts > room_np).any():
            raise ValueError(f"{name} must lie inside the room")
    if not 0.0 <= float(scattering) < 1.0:
        raise ValueError("scattering must be in [0, 1)")
    if num_rays < 1:
        raise ValueError("num_rays must be >= 1")

    absorb = np.asarray(absorption, np.float64)
    if absorb.ndim == 0:
        absorb = np.full((1, 6), float(absorb))
    elif absorb.shape == (6,):
        absorb = absorb[None]
    if absorb.ndim != 2 or absorb.shape[1] != 6:
        raise ValueError(
            "absorption must be a scalar, (6,), or (num_bands, 6)")
    if (absorb < 0).any() or (absorb > 1).any():
        raise ValueError("absorption must be in [0, 1]")
    num_bands = absorb.shape[0]

    num_bins = int(math.ceil(time_thres / hist_bin_size))
    n_mics = mics_np.shape[0]
    if max_bounces is None:
        # farthest a ray can travel is time_thres·c; the shortest
        # wall-to-wall leg bounds bounces (cap keeps the loop sane)
        max_bounces = min(
            int(math.ceil(time_thres * sound_speed / room_np.min()))
            + 1, 4000)

    def dev32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    direc = dev32(_fibonacci_sphere(int(num_rays)))          # (R, 3)
    pos = dev32(src_np).expand(direc.shape).clone()
    room_t = dev32(room_np)
    mics = dev32(mics_np)                                    # (M, 3)
    trans = dev32((1.0 - absorb).T)                          # (6, bands)
    energy = torch.full((int(num_rays), num_bands), 1.0 / num_rays,
                        dtype=torch.float32, device=device)
    dist = torch.zeros(int(num_rays), dtype=torch.float32, device=device)
    hist = torch.zeros(n_mics * (num_bins + 1), num_bands,
                       dtype=torch.float32, device=device)
    scat = float(scattering)
    inv_bin = 1.0 / (hist_bin_size * sound_speed)   # dist -> bin
    eps = 1e-5
    row0 = (torch.arange(n_mics, device=device) * (num_bins + 1))[None, :]
    axes = torch.arange(3, device=device)[None, :]

    def deposit(path, e, valid):
        """Add ``e (R, M, bands)`` at path length ``path (R, M)`` into the
        flat histogram ``(M·(num_bins + 1), bands)``: bands innermost, so
        row ``m·(bins+1) + bin`` is one (bin, all bands) slot; a bin past
        the end or an invalid deposit goes to the overflow slot."""
        bins = torch.floor(path * inv_bin).to(torch.int64)
        bins = torch.where(valid & (bins >= 0) & (bins < num_bins),
                           bins, num_bins)
        hist.index_add_(0, (row0 + bins).reshape(-1),
                        e.reshape(-1, num_bands))

    for _ in range(int(max_bounces)):
        alive = (energy.amax(dim=-1) > energy_thres) & \
            (dist * (1.0 / sound_speed) < time_thres)       # (R,)

        # nearest axis-aligned wall along the ray
        flat = torch.abs(direc) < eps
        safe = torch.where(flat, eps, direc)
        t_pos = (room_t[None, :] - pos) / safe
        t_neg = (0.0 - pos) / safe
        t_axis = torch.where(direc > 0, t_pos, t_neg)        # (R, 3)
        t_axis = torch.where(flat, math.inf, t_axis)
        t_hit, axis = torch.min(t_axis, dim=-1)              # (R,)
        going_up = torch.gather(direc, 1, axis[:, None])[:, 0] > 0
        wall = axis * 2 + going_up.to(torch.int64)

        # segment–sphere capture for every mic
        rel = mics[None, :, :] - pos[:, None, :]             # (R, M, 3)
        t_ca = _dot3(rel, direc[:, None, :])
        d2 = _dot3(rel, rel) - t_ca * t_ca
        crossed = (t_ca > 0) & (t_ca < t_hit[:, None]) & \
            (d2 < mic_radius * mic_radius) & alive[:, None]
        e_cross = torch.where(crossed[..., None], energy[:, None, :], 0.0)
        deposit(dist[:, None] + t_ca, e_cross, crossed)

        hit = pos + t_hit[:, None] * direc
        dist_wall = dist + t_hit
        e_wall = energy * trans[wall]                        # (R, bands)

        if scat > 0.0:
            relw = mics[None, :, :] - hit[:, None, :]
            dmic = torch.sqrt(_dot3(relw, relw))
            ratio = torch.clamp(
                mic_radius / torch.clamp(dmic, min=mic_radius), 0.0, 1.0)
            omega = 0.5 * (1.0 - torch.sqrt(1.0 - ratio * ratio))
            e_rain = (e_wall[:, None, :] * scat * omega[..., None]
                      * alive[:, None, None])
            deposit(dist_wall[:, None] + dmic, e_rain,
                    alive[:, None].expand(dmic.shape))
            e_wall = e_wall * (1.0 - scat)

        # specular reflection, nudged off the wall
        sign = torch.where(axes == axis[:, None], -1.0, 1.0)
        new_dir = direc * sign
        new_pos = torch.minimum(torch.clamp(hit + eps * new_dir, min=0.0),
                                room_t)
        energy = torch.where(alive[:, None], e_wall, energy)
        pos = torch.where(alive[:, None], new_pos, pos)
        direc = torch.where(alive[:, None], new_dir, direc)
        dist = torch.where(alive, dist_wall, dist)
    # drop the overflow slot; present (channels, bands, bins)
    out = hist.view(n_mics, num_bins + 1, num_bands)[:, :num_bins, :]
    return out.transpose(1, 2).contiguous()
