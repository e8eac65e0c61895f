"""Fused Griffin-Lim: the whole momentum iteration as hand-written CUDA
kernels.

Port of ``torchaudio_contrib_tpu/ops/fused_griffinlim.py``.  On a CUDA
tensor :func:`_gl_fused` runs every projection of the solve through
``csrc/fused_gl.cu`` (built by :mod:`._cuda` on first use): per iteration a
synthesis product ``fr = state · syn`` (the windowed inverse real DFT as a
matrix product), an overlap-add with the clamped inverse envelope, and an
analysis product that reads its frames straight from the enveloped signal
and applies the momentum step and the magnitude projection in its epilogue.
One call into the library runs all ``n_iter`` iterations on torch's current
stream.  On a CPU tensor the same solve runs as :func:`_gl_solve_plain`,
the plain PyTorch version in the kernels' layouts.  There is no other
fallback: a CUDA tensor the kernels cannot take raises.

Boundary semantics, as in the JAX package: the solve iterates in the
*free-edge* domain.  It works on the padded signal of
``(n_frames − 1)·hop + fft`` samples, with the inverse envelope clamped to
0 where the summed squared window is under ``1e-3`` of its maximum, and
does not re-apply reflect padding per iteration.  So its result differs by
design from the ``fft``/``matmul`` loops of :func:`.griffinlim.griffin_lim`
(at equal convergence); edge samples where the envelope vanishes are
zero.

State, ``prev`` (the momentum memory: the unnormalised rebuilt spectrum),
the bases and every product are float32 on the card (FP32 FMAs): the JAX
kernel's bf16 state is a property of the TPU's matrix unit and is not
carried over.

Layouts (``FBT = 64`` onesided bins per frequency tile, ``ft`` tiles):
the state is ``(clips, n_frames, ft·2·FBT)`` with ``[re_t | im_t]`` per
tile, the magnitudes ``(clips, n_frames, ft·FBT)``; with
``tile_major=True`` they are ``(clips, ft, n_frames, 2·FBT)`` and
``(clips, ft, n_frames, FBT)``, the JAX package's layout probe.  Both run
the same kernels with other strides.

``GL_KERNEL_LAUNCHES`` counts the solves launched on the card (one per
call into the library, which runs ``3·n_iter`` kernels) and
``GL_TILE_MAJOR_LAUNCHES`` those of them in tile-major layout.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda
from .fused import (_basis_on, _cdiv, _round_up, _hashable_window,
                    _FRAME_TILE, _FREQ_TILE, _K_TILE)
from .stft import (_idft_matrices, _on, _resolve_window, _overlap_add,
                   frame_signal)
from .windows import cola_window_sum

__all__ = ["fused_gl_supported"]

GL_KERNEL_LAUNCHES = 0
GL_TILE_MAJOR_LAUNCHES = 0

_FBT = _FREQ_TILE       # onesided bins per frequency tile (the analysis
                        # basis is the fused mel kernels' basis)
_N_TILE = 64            # synthesis output samples per block
_MAX_CLIPS = 65535      # grid.z

# The stage switches of csrc/fused_gl.cu, for timing attribution: only
# "full" computes Griffin-Lim.
VARIANTS = ("full", "nonorm", "noola", "nosyn", "noana")

RULE = ("fft_length even and >= 2, 0 < hop_length <= fft_length, "
        "n_frames >= 1")


def fused_gl_supported(fft_length: int, hop_length: int,
                       n_frames: int) -> bool:
    """Eligibility for :func:`~.griffinlim.griffin_lim`'s fused method:
    ``fft_length`` even and at least 2, ``0 < hop_length <= fft_length``,
    at least one frame.  The kernels read frames at any hop and mask ragged
    edges, so the JAX package's multiples of 128, its ``fft % hop == 0``
    and its on-chip memory estimate do not apply here."""
    return (fft_length >= 2 and fft_length % 2 == 0
            and 0 < hop_length <= fft_length and n_frames >= 1)


@functools.lru_cache(maxsize=16)
def _syn_np(fft_length: int, win_key):
    """The synthesis basis ``(ft·2·FBT, round_up(fft, N_TILE))``, built in
    float64 and cast to float32: tile ``t`` rows ``[icr_t·w ; ici_t·w]``
    (the state's column order), with the window, ``1/N`` and the
    conjugate-symmetry weights folded in.  Padded bins and padded samples
    are zero."""
    n_freqs = fft_length // 2 + 1
    ft = _cdiv(n_freqs, _FBT)
    w = _resolve_window(win_key if win_key is not None else "hann",
                        fft_length, fft_length)
    icr, ici = _idft_matrices(fft_length)
    pad = ((0, ft * _FBT - n_freqs),
           (0, _round_up(fft_length, _N_TILE) - fft_length))
    icr = np.pad(icr * w[None, :], pad)
    ici = np.pad(ici * w[None, :], pad)
    tiles = []
    for t in range(ft):
        s = slice(t * _FBT, (t + 1) * _FBT)
        tiles += [icr[s], ici[s]]
    return np.concatenate(tiles, axis=0).astype(np.float32), w


def _gl_bases_on(device, fft_length: int, win_key):
    """``(syn, ana, window float64, ft)`` on ``device``: ``syn`` from
    :func:`_syn_np`; ``ana (round_up(fft, K_TILE), ft·2·FBT)`` is the fused
    mel kernels' windowed DFT basis (tile ``t`` columns
    ``[w·cos_t | −w·sin_t]``)."""
    syn = _on(device, torch.float32, _syn_only, fft_length, win_key)
    ana, _, ft = _basis_on(torch.device(device), fft_length,
                           win_key if win_key is not None else "hann", None)
    return syn, ana, _syn_np(fft_length, win_key)[1], ft


def _syn_only(fft_length: int, win_key) -> np.ndarray:
    return _syn_np(fft_length, win_key)[0]


def _inv_envelope(w: np.ndarray, hop_length: int, n_frames: int,
                  n_samples: int) -> np.ndarray:
    """The clamped least-squares inverse envelope (float32): ``1/env``
    where the summed squared window exceeds ``1e-3`` of its maximum, else
    0."""
    env = cola_window_sum(w, hop_length, n_frames, n_samples)
    return np.where(env > 1e-3 * env.max(),
                    1.0 / np.maximum(env, 1e-8), 0.0).astype(np.float32)


def _inv_envelope_of(fft_length: int, win_key, hop_length: int,
                     n_frames: int) -> np.ndarray:
    """:func:`_inv_envelope` of the config's window over the padded signal
    of ``(n_frames − 1)·hop + fft`` samples."""
    return _inv_envelope(_syn_np(fft_length, win_key)[1], hop_length,
                         n_frames,
                         (n_frames - 1) * hop_length + fft_length)


def _random_phase(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform phases in ``[−π, π)`` drawn on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return ((2.0 * u - 1.0) * np.pi).to(device)


# ---- layouts ---------------------------------------------------------------

def _pack(re, im, mag, ft: int, tile_major: bool):
    """``(state0, magT)`` in the kernels' layout from ``(clips, n_frames,
    n_freqs)`` parts: bins zero-padded to ``ft·FBT`` and cut into tiles."""
    bc, rows, n_freqs = mag.shape
    pad = (0, ft * _FBT - n_freqs)
    re4, im4, mag4 = (F.pad(t, pad).view(bc, rows, ft, _FBT)
                      for t in (re, im, mag))
    state = torch.stack([re4, im4], dim=-2)          # (bc, rows, ft, 2, FBT)
    if tile_major:
        return (state.permute(0, 2, 1, 3, 4).reshape(bc, ft, rows, 2 * _FBT)
                .contiguous(), mag4.permute(0, 2, 1, 3).contiguous())
    return (state.reshape(bc, rows, ft * 2 * _FBT).contiguous(),
            mag4.reshape(bc, rows, ft * _FBT).contiguous())


def _row_major(state, tile_major: bool):
    """The state (or ``prev``) as ``(clips, n_frames, ft, 2, FBT)``."""
    if tile_major:
        bc, ft, rows, _ = state.shape
        return state.view(bc, ft, rows, 2, _FBT).permute(0, 2, 1, 3, 4)
    bc, rows, w2 = state.shape
    return state.view(bc, rows, w2 // (2 * _FBT), 2, _FBT)


def _unpack(state, n_freqs: int, tile_major: bool) -> torch.Tensor:
    """Complex ``(clips, n_frames, n_freqs)`` from a state."""
    s5 = _row_major(state, tile_major)
    bc, rows = s5.shape[:2]
    re = s5[..., 0, :].reshape(bc, rows, -1)[..., :n_freqs]
    im = s5[..., 1, :].reshape(bc, rows, -1)[..., :n_freqs]
    return torch.complex(re.contiguous(), im.contiguous())


# ---- the solve: plain version and launch wrapper ---------------------------

def _gl_solve_plain(state0, magT, syn, ana, inv_env, fft_length: int,
                    hop_length: int, n_iter: int, momentum: float,
                    tile_major: bool = False):
    """Plain PyTorch version of the kernels' solve: ``(state, prev)`` after
    ``n_iter`` free-edge projections from ``state0`` (``prev`` starts at
    zero, so the first step projects ``(1 + momentum)·reim``), taking and
    returning the kernels' layouts."""
    s5 = _row_major(state0, tile_major)
    bc, rows, ft = s5.shape[:3]
    state = s5.reshape(bc, rows, ft * 2 * _FBT)
    mag4 = (magT.permute(0, 2, 1, 3) if tile_major
            else magT.view(bc, rows, ft, _FBT))
    n_samples = (rows - 1) * hop_length + fft_length
    syn, ana = syn[:, :fft_length], ana[:fft_length]
    prev = torch.zeros_like(state)
    for _ in range(n_iter):
        fr = state @ syn                                 # (bc, rows, fft)
        xv = _overlap_add(fr, fft_length, hop_length, n_samples) * inv_env
        reim = frame_signal(xv, fft_length, hop_length) @ ana
        upd = (reim + momentum * (reim - prev)).view(bc, rows, ft, 2, _FBT)
        prev = reim
        nrm = torch.sqrt(upd[..., 0, :] ** 2 + upd[..., 1, :] ** 2)
        sc = mag4 / torch.clamp(nrm, min=1e-16)
        state = (upd * sc[..., None, :]).reshape(bc, rows, -1)

    def back(t):
        t5 = t.view(bc, rows, ft, 2, _FBT)
        if tile_major:
            return t5.permute(0, 2, 1, 3, 4).reshape(
                bc, ft, rows, 2 * _FBT).contiguous()
        return t5.reshape(bc, rows, -1).contiguous()

    return back(state), back(prev)


@functools.lru_cache(maxsize=1)
def _kernel_lib():
    lib = _cuda.load()
    want = (_FRAME_TILE, _FBT, _K_TILE, _N_TILE)
    tiles = tuple(lib.tac_fused_gl_tile(i) for i in range(4))
    if tiles != want:
        raise RuntimeError(f"kernel tiles {tiles} do not match the host "
                           f"layout {want}")
    return lib


def _gl_solve_cuda(state0, magT, syn, ana, inv_env, fft_length: int,
                   hop_length: int, n_iter: int, momentum: float,
                   tile_major: bool = False, variant: str = "full"):
    """Launch the solve on the card; arguments and results as
    :func:`_gl_solve_plain`.  ``variant`` picks one of :data:`VARIANTS`
    (stage switches for timing; only ``"full"`` is Griffin-Lim).  Raises on
    any input it does not take; never computes the result another way."""
    global GL_KERNEL_LAUNCHES, GL_TILE_MAJOR_LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    want_ndim = 4 if tile_major else 3
    for name, t in (("state0", state0), ("magT", magT), ("syn", syn),
                    ("ana", ana), ("inv_env", inv_env)):
        if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()
                and t.device == state0.device):
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor on one device; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if state0.ndim != want_ndim or magT.ndim != want_ndim:
        raise ValueError(f"state {tuple(state0.shape)} / magnitudes "
                         f"{tuple(magT.shape)} do not fit tile_major="
                         f"{tile_major}")
    if tile_major:
        bc, ft, rows, w2t = state0.shape
        mag_want = (bc, ft, rows, _FBT)
    else:
        bc, rows, w2 = state0.shape
        ft, w2t = w2 // (2 * _FBT), 2 * _FBT
        mag_want = (bc, rows, ft * _FBT)
    n_pad = _round_up(fft_length, _N_TILE)
    n_samples = (rows - 1) * hop_length + fft_length
    if not (w2t == 2 * _FBT and state0.numel() == bc * rows * ft * 2 * _FBT
            and tuple(magT.shape) == mag_want
            and tuple(syn.shape) == (ft * 2 * _FBT, n_pad)
            and tuple(ana.shape) == (_round_up(fft_length, _K_TILE),
                                     ft * 2 * _FBT)
            and tuple(inv_env.shape) == (n_samples,)):
        raise ValueError(
            f"operands do not fit fft_length={fft_length}, hop_length="
            f"{hop_length}: state {tuple(state0.shape)}, magnitudes "
            f"{tuple(magT.shape)}, syn {tuple(syn.shape)}, ana "
            f"{tuple(ana.shape)}, envelope {tuple(inv_env.shape)}")
    if not fused_gl_supported(fft_length, hop_length, rows):
        raise ValueError(f"fft_length={fft_length}, hop_length={hop_length},"
                         f" n_frames={rows} outside the kernels' rule "
                         f"({RULE})")
    if (bc > _MAX_CLIPS or rows * max(n_pad, ft * 2 * _FBT) >= 2 ** 31
            or n_samples >= 2 ** 31):
        raise ValueError(f"{bc} clips of {rows} frames exceed the kernels' "
                         f"grid ({_MAX_CLIPS} clips, 2**31 elements a clip)")
    if n_iter < 0 or not 0 <= momentum < 1:
        raise ValueError(f"n_iter={n_iter}, momentum={momentum}")
    state = state0.clone()
    prev = torch.zeros_like(state0)
    if n_iter == 0:
        return state, prev          # nothing to launch, nothing counted
    # a skipped stage leaves its buffer unwritten: start those from zero
    scratch = torch.empty if variant == "full" else torch.zeros
    fr = scratch((bc, rows, n_pad), dtype=torch.float32, device=state.device)
    xv = scratch((bc, n_samples), dtype=torch.float32, device=state.device)
    lib = _kernel_lib()
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = lib.tac_fused_gl_solve(
            state.data_ptr(), prev.data_ptr(), magT.data_ptr(),
            syn.data_ptr(), ana.data_ptr(), inv_env.data_ptr(),
            fr.data_ptr(), xv.data_ptr(), bc, rows, fft_length, hop_length,
            ft, n_pad, int(tile_major), int(n_iter), float(momentum),
            VARIANTS.index(variant), stream)
    if rc != 0:
        raise RuntimeError(f"fused Griffin-Lim kernels failed to launch: "
                           f"{lib.tac_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    GL_KERNEL_LAUNCHES += 1
    GL_TILE_MAJOR_LAUNCHES += int(tile_major)
    return state, prev


# ---- the op ----------------------------------------------------------------

def _gl_prepare(mag_specgrams, fft_length: int, hop_length: int, window,
                generator=None, tile_major: bool = False):
    """The solve's operands for magnitudes ``(..., n_freqs, n_frames)``:
    ``(state0, magT, syn, ana, inv_env, window float64)``.  The initial
    state is ``mag·exp(i·phase)``, with zero phase when ``generator`` is
    None."""
    n_freqs = fft_length // 2 + 1
    if mag_specgrams.shape[-2] != n_freqs:
        raise ValueError(f"magnitudes have {mag_specgrams.shape[-2]} bins; "
                         f"fft_length={fft_length} needs {n_freqs}")
    n_frames = mag_specgrams.shape[-1]
    mag = mag_specgrams.to(torch.float32).reshape(-1, n_freqs, n_frames)
    device = mag.device
    win_key = _hashable_window(window)
    syn, ana, w, ft = _gl_bases_on(device, fft_length, win_key)
    inv_env = _on(device, torch.float32, _inv_envelope_of, fft_length,
                  win_key, hop_length, n_frames)
    magL = mag.transpose(1, 2)
    if generator is not None:
        phase = _random_phase(mag.shape, generator, device).transpose(1, 2)
        re, im = magL * torch.cos(phase), magL * torch.sin(phase)
    else:
        re, im = magL, torch.zeros_like(magL)
    state0, magT = _pack(re, im, magL, ft, tile_major)
    return state0, magT, syn, ana, inv_env, w


def _gl_finish(state, lead, n_freqs: int, fft_length: int, hop_length: int,
               w, inv_env, length, center: bool, tile_major: bool):
    """The waveform from the solved state: exact ``irfft`` × window →
    overlap-add × clamped inverse envelope → crop ``fft//2`` when
    ``center`` → crop or zero-pad to ``length``."""
    spec = _unpack(state, n_freqs, tile_major)
    frames = torch.fft.irfft(spec, n=fft_length, dim=-1) * torch.as_tensor(
        w, dtype=torch.float32, device=state.device)
    n_samples = inv_env.shape[0]
    y = _overlap_add(frames, fft_length, hop_length, n_samples) * inv_env
    if center:
        y = y[..., fft_length // 2:]
    if length is not None:
        if y.shape[-1] >= length:
            y = y[..., :length]
        else:
            y = F.pad(y, (0, length - y.shape[-1]))
    return y.reshape(lead + (y.shape[-1],))


def _gl_run(solve, mag_specgrams, fft_length, hop_length, window, n_iter,
            momentum, length, center, generator, tile_major):
    state0, magT, syn, ana, inv_env, w = _gl_prepare(
        mag_specgrams, fft_length, hop_length, window, generator, tile_major)
    state, _ = solve(state0, magT, syn, ana, inv_env, fft_length, hop_length,
                     int(n_iter), float(momentum), tile_major)
    return _gl_finish(state, mag_specgrams.shape[:-2],
                      mag_specgrams.shape[-2], fft_length, hop_length, w,
                      inv_env, length, center, tile_major)


def _gl_plain(mag_specgrams, fft_length, hop_length, window, n_iter,
              momentum, length, center, generator=None, tile_major=False):
    """The fused Griffin-Lim's plain PyTorch version, on the tensor's own
    device: the same free-edge solve, operands and layouts as
    :func:`_gl_fused`, with :func:`_gl_solve_plain` in the kernels'
    place."""
    return _gl_run(_gl_solve_plain, mag_specgrams, fft_length, hop_length,
                   window, n_iter, momentum, length, center, generator,
                   tile_major)


def _gl_fused(mag_specgrams, fft_length, hop_length, window, n_iter,
              momentum, length, center, generator=None, tile_major=False):
    """The fused Griffin-Lim loop (the JAX package's ``_gl_pallas``); the
    caller guarantees eligibility.  A CUDA tensor launches the kernels or
    raises; a CPU tensor runs the plain version."""
    device = mag_specgrams.device.type
    if device == "cpu":
        solve = _gl_solve_plain
    elif device == "cuda":
        solve = _gl_solve_cuda
    else:
        raise ValueError(f"unsupported device {mag_specgrams.device}")
    return _gl_run(solve, mag_specgrams, fft_length, hop_length, window,
                   n_iter, momentum, length, center, generator, tile_major)
