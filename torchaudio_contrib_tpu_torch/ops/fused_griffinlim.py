"""Fused Griffin-Lim: the whole momentum iteration as hand-written CUDA
kernels.

Port of ``torchaudio_contrib_tpu/ops/fused_griffinlim.py``.  On a CUDA
tensor :func:`_gl_fused` runs every projection of the solve through
``csrc/fused_gl.cu`` (built by :mod:`._cuda` on first use): per iteration a
synthesis ``fr = window · irfft(state)``, an overlap-add with the clamped
inverse envelope, and an analysis that reads its frames straight from the
enveloped signal and applies the momentum step and the magnitude projection
in its epilogue.  One call into the library runs all ``n_iter`` iterations
on torch's current stream.  On a CPU tensor the same solve runs as
:func:`_gl_solve_plain`, the plain PyTorch version in the kernels' layouts.
There is no other fallback: a CUDA tensor the kernels cannot take raises.

Two routes of the kernels, by ``fft_length`` alone (the rule of the fused
mel kernels, :func:`.fused._fft_kernel_supported`): a power of two from 256
to 2048 takes the FFT kernels, which run both transforms of an iteration as
shared-memory FFTs (``csrc/fft_smem.cuh``) and take the window and the
twiddle table as operands; any other even size takes the DFT-product
kernels, whose operands are the two dense bases ``syn`` and ``ana``.
:func:`_gl_solve_plain` is the plain version of the DFT route,
:func:`_gl_solve_fft_plain` repeats the FFT route's arithmetic step by
step.

Boundary semantics, as in the JAX package: the solve iterates in the
*free-edge* domain.  It works on the padded signal of
``(n_frames − 1)·hop + fft`` samples, with the inverse envelope clamped to
0 where the summed squared window is under ``1e-3`` of its maximum, and
does not re-apply reflect padding per iteration.  So its result differs by
design from the ``fft``/``matmul`` loops of :func:`.griffinlim.griffin_lim`
(at equal convergence); edge samples where the envelope vanishes are
zero.

State, ``prev`` (the momentum memory: the unnormalised rebuilt spectrum),
the constants and all arithmetic are float32 on the card: the JAX
kernel's bf16 state is a property of the TPU's matrix unit and is not
carried over.

Layouts (``FBT = 64`` onesided bins per frequency tile, ``ft`` tiles):
the state is ``(clips, n_frames, ft·2·FBT)`` with ``[re_t | im_t]`` per
tile, the magnitudes ``(clips, n_frames, ft·FBT)``; with
``tile_major=True`` they are ``(clips, ft, n_frames, 2·FBT)`` and
``(clips, ft, n_frames, FBT)``, the JAX package's layout probe.  Both run
the same kernels with other strides.

``GL_KERNEL_LAUNCHES`` counts the solves launched on the card (one per
call into the library, which runs ``3·n_iter`` kernels),
``GL_TILE_MAJOR_LAUNCHES`` those of them in tile-major layout and
``GL_FFT_LAUNCHES`` those of them on the FFT route.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda
from .fused import (_basis_on, _cdiv, _round_up, _hashable_window,
                    _fft_consts_on, _route_for, _stockham_fft, _to_tiles,
                    _FFT_MAX, _FFT_MIN, _FRAME_TILE, _FREQ_TILE, _K_TILE)
from .stft import (_idft_matrices, _on, _resolve_window, _overlap_add,
                   frame_signal)
from .windows import cola_window_sum

__all__ = ["fused_gl_supported"]

GL_KERNEL_LAUNCHES = 0
GL_TILE_MAJOR_LAUNCHES = 0
GL_FFT_LAUNCHES = 0

_FBT = _FREQ_TILE       # onesided bins per frequency tile (the analysis
                        # basis is the fused mel kernels' basis)
_N_TILE = 64            # synthesis output samples per block
_MAX_CLIPS = 65535      # grid.z (grid.y on the FFT route)

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


def _window_np(fft_length: int, win_key) -> np.ndarray:
    """The config's window (float64, ``fft_length`` samples; Hann when
    ``win_key`` is None)."""
    return _resolve_window(win_key if win_key is not None else "hann",
                           fft_length, fft_length)


@functools.lru_cache(maxsize=16)
def _syn_np(fft_length: int, win_key):
    """The synthesis basis ``(ft·2·FBT, round_up(fft, N_TILE))``, built in
    float64 and cast to float32: tile ``t`` rows ``[icr_t·w ; ici_t·w]``
    (the state's column order), with the window, ``1/N`` and the
    conjugate-symmetry weights folded in.  Padded bins and padded samples
    are zero."""
    n_freqs = fft_length // 2 + 1
    ft = _cdiv(n_freqs, _FBT)
    w = _window_np(fft_length, win_key)
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
    return _inv_envelope(_window_np(fft_length, win_key), hop_length,
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


# ---- the solve: plain versions and launch wrapper --------------------------

def _gl_iterate(state0, magT, inv_env, fft_length: int, hop_length: int,
                n_iter: int, momentum: float, tile_major: bool, synthesis,
                analysis):
    """``(state, prev)`` after ``n_iter`` free-edge projections from
    ``state0`` (``prev`` starts at zero, so the first step projects ``(1 +
    momentum)·reim``), taking and returning the kernels' layouts.
    ``synthesis`` maps a row-major state ``(clips, n_frames, ft·2·FBT)`` to
    windowed frames ``(clips, n_frames, fft)``, ``analysis`` frames of the
    enveloped signal to ``reim`` in the state's layout."""
    s5 = _row_major(state0, tile_major)
    bc, rows, ft = s5.shape[:3]
    state = s5.reshape(bc, rows, ft * 2 * _FBT)
    mag4 = (magT.permute(0, 2, 1, 3) if tile_major
            else magT.view(bc, rows, ft, _FBT))
    n_samples = (rows - 1) * hop_length + fft_length
    prev = torch.zeros_like(state)
    for _ in range(n_iter):
        fr = synthesis(state)                            # (bc, rows, fft)
        xv = _overlap_add(fr, fft_length, hop_length, n_samples) * inv_env
        reim = analysis(frame_signal(xv, fft_length, hop_length))
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


def _gl_solve_plain(state0, magT, syn, ana, inv_env, fft_length: int,
                    hop_length: int, n_iter: int, momentum: float,
                    tile_major: bool = False):
    """Plain PyTorch version of the DFT-product kernels' solve (see
    :func:`_gl_iterate`): both transforms as products with the dense bases
    ``syn`` and ``ana``."""
    syn, ana = syn[:, :fft_length], ana[:fft_length]
    return _gl_iterate(state0, magT, inv_env, fft_length, hop_length, n_iter,
                       momentum, tile_major, lambda state: state @ syn,
                       lambda frames: frames @ ana)


def _gl_solve_fft_plain(state0, magT, window, twiddle, inv_env,
                        fft_length: int, hop_length: int, n_iter: int,
                        momentum: float, tile_major: bool = False):
    """Plain PyTorch version of the FFT kernels' solve, step by step as
    ``csrc/fused_gl.cu`` runs it; arguments and results as
    :func:`_gl_solve_plain` with the window ``(fft,)`` and the kernels'
    twiddle table (``(fft, 2)`` real or ``(fft,)`` complex) in the bases'
    place.  With ``N = fft_length``, ``M = N/2``:

    * synthesis: the Hermitian spectrum ``Y = state/N`` with the imaginary
      parts of DC and Nyquist dropped, ``Z_k = (Y_k + conj Y_{M−k}) + i·(Y_k
      − conj Y_{M−k})·conj W_k`` for ``k < M``, whose unnormalised inverse
      ``M``-point transform (:func:`~.fused._stockham_fft`) is ``z[m] =
      y[2m] + i·y[2m+1]``, then the window: ``window · irfft(state)``;
    * analysis: the windowed frame packed as ``z[m] = x[2m] + i·x[2m+1]``,
      its ``M``-point transform, and the bins ``X_k = E_k + W_k·O_k`` (``X_M
      = E_0 − O_0``) from its even and odd halves; padded bins are zero.
    """
    n, m = fft_length, fft_length // 2
    tw = twiddle if twiddle.is_complex() else torch.view_as_complex(
        twiddle.contiguous())
    ft = _cdiv(m + 1, _FBT)
    k_syn = torch.arange(m, device=state0.device)
    k_ana = torch.arange(m + 1, device=state0.device)
    w_ana = torch.cat([tw[:m], -tw[:1]])

    def synthesis(state):
        lead = state.shape[:2]
        ri = state.reshape(*lead, ft, 2, _FBT)
        re = ri[..., 0, :].reshape(*lead, -1)[..., :m + 1] * (1.0 / n)
        im = ri[..., 1, :].reshape(*lead, -1)[..., :m + 1] * (1.0 / n)
        im[..., 0] = 0.0
        im[..., m] = 0.0
        y = torch.complex(re, im)
        yk, yn = y[..., k_syn], y[..., m - k_syn].conj()
        o = (yk - yn) * tw[:m].conj()
        z = _stockham_fft((yk + yn) + torch.complex(-o.imag, o.real), tw,
                          inverse=True)
        return torch.stack([z.real, z.imag], dim=-1).reshape(*lead, n) * window

    def analysis(frames):
        frames = frames * window
        zf = _stockham_fft(torch.complex(frames[..., 0::2],
                                         frames[..., 1::2]), tw)
        zk, zn = zf[..., k_ana % m], zf[..., (m - k_ana) % m]
        e = 0.5 * (zk + zn.conj())
        o = torch.complex(0.5 * (zk.imag + zn.imag),
                          0.5 * (zn.real - zk.real))
        spec = e + w_ana * o
        return _to_tiles(spec.real, spec.imag, ft)

    return _gl_iterate(state0, magT, inv_env, fft_length, hop_length, n_iter,
                       momentum, tile_major, synthesis, analysis)


@functools.lru_cache(maxsize=1)
def _kernel_lib():
    lib = _cuda.load()
    want = (_FRAME_TILE, _FBT, _K_TILE, _N_TILE, _FFT_MIN, _FFT_MAX)
    tiles = tuple(lib.tac_fused_gl_tile(i) for i in range(6))
    if tiles != want:
        raise RuntimeError(f"kernel tiles {tiles} do not match the host "
                           f"layout {want}")
    return lib


def _gl_solve_cuda(state0, magT, basis_a, basis_b, inv_env, fft_length: int,
                   hop_length: int, n_iter: int, momentum: float,
                   tile_major: bool = False, variant: str = "full",
                   _route=None):
    """Launch the solve on the card; arguments and results as
    :func:`_gl_solve_plain` on the DFT route (``basis_a``, ``basis_b`` are
    ``syn``, ``ana``) and as :func:`_gl_solve_fft_plain` on the FFT route
    (the window and the twiddle table).  The FFT kernels when
    :func:`~.fused._fft_kernel_supported`, else the DFT-product kernels
    (``_route`` names one of them to compare both at one shape).
    ``variant`` picks one of :data:`VARIANTS` (stage switches for timing;
    only ``"full"`` is Griffin-Lim).  Raises on any input it does not take;
    never computes the result another way."""
    global GL_KERNEL_LAUNCHES, GL_TILE_MAJOR_LAUNCHES, GL_FFT_LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    route = _route_for(fft_length, _route)
    names = ("window", "twiddle") if route == "fft" else ("syn", "ana")
    want_ndim = 4 if tile_major else 3
    for name, t in (("state0", state0), ("magT", magT), (names[0], basis_a),
                    (names[1], basis_b), ("inv_env", inv_env)):
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
    if route == "fft":
        bases_want = ((fft_length,), (fft_length, 2))
    else:
        bases_want = ((ft * 2 * _FBT, n_pad),
                      (_round_up(fft_length, _K_TILE), ft * 2 * _FBT))
    if not (w2t == 2 * _FBT and state0.numel() == bc * rows * ft * 2 * _FBT
            and ft == _cdiv(fft_length // 2 + 1, _FBT)
            and tuple(magT.shape) == mag_want
            and (tuple(basis_a.shape), tuple(basis_b.shape)) == bases_want
            and tuple(inv_env.shape) == (n_samples,)):
        raise ValueError(
            f"operands do not fit fft_length={fft_length}, hop_length="
            f"{hop_length} on the {route.upper()} route: state "
            f"{tuple(state0.shape)}, magnitudes {tuple(magT.shape)}, "
            f"{names[0]} {tuple(basis_a.shape)}, {names[1]} "
            f"{tuple(basis_b.shape)}, envelope {tuple(inv_env.shape)}")
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
    head = (state.data_ptr(), prev.data_ptr(), magT.data_ptr(),
            basis_a.data_ptr(), basis_b.data_ptr(), inv_env.data_ptr(),
            fr.data_ptr(), xv.data_ptr(), bc, rows, fft_length, hop_length,
            ft)
    tail = (int(tile_major), int(n_iter), float(momentum),
            VARIANTS.index(variant))
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        if route == "fft":
            rc = lib.tac_fused_gl_solve_fft(*head, *tail, stream)
        else:
            rc = lib.tac_fused_gl_solve(*head, n_pad, *tail, stream)
    if rc != 0:
        raise RuntimeError(f"fused Griffin-Lim kernels ({route.upper()} "
                           f"route) failed to launch: "
                           f"{lib.tac_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    GL_KERNEL_LAUNCHES += 1
    GL_TILE_MAJOR_LAUNCHES += int(tile_major)
    GL_FFT_LAUNCHES += int(route == "fft")
    return state, prev


# ---- the op ----------------------------------------------------------------

def _gl_prepare(mag_specgrams, fft_length: int, hop_length: int, window,
                generator=None, tile_major: bool = False,
                route: str = "dft"):
    """The solve's operands for magnitudes ``(..., n_freqs, n_frames)``:
    ``(state0, magT, syn, ana, inv_env, window float64)`` for the DFT route
    and its plain version, ``(state0, magT, window, twiddle, inv_env,
    window float64)`` for the FFT route and its (no dense basis is built or
    copied to the device there).  The initial state is ``mag·exp(i·phase)``,
    with zero phase when ``generator`` is None."""
    n_freqs = fft_length // 2 + 1
    if mag_specgrams.shape[-2] != n_freqs:
        raise ValueError(f"magnitudes have {mag_specgrams.shape[-2]} bins; "
                         f"fft_length={fft_length} needs {n_freqs}")
    n_frames = mag_specgrams.shape[-1]
    mag = mag_specgrams.to(torch.float32).reshape(-1, n_freqs, n_frames)
    device = mag.device
    win_key = _hashable_window(window)
    if _route_for(fft_length, route) == "fft":
        basis_a, basis_b = _fft_consts_on(
            device, fft_length, win_key if win_key is not None else "hann",
            None)
        w, ft = _window_np(fft_length, win_key), _cdiv(n_freqs, _FBT)
    else:
        basis_a, basis_b, w, ft = _gl_bases_on(device, fft_length, win_key)
    inv_env = _on(device, torch.float32, _inv_envelope_of, fft_length,
                  win_key, hop_length, n_frames)
    magL = mag.transpose(1, 2)
    if generator is not None:
        phase = _random_phase(mag.shape, generator, device).transpose(1, 2)
        re, im = magL * torch.cos(phase), magL * torch.sin(phase)
    else:
        re, im = magL, torch.zeros_like(magL)
    state0, magT = _pack(re, im, magL, ft, tile_major)
    return state0, magT, basis_a, basis_b, inv_env, w


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


def _gl_run(solve, route, mag_specgrams, fft_length, hop_length, window,
            n_iter, momentum, length, center, generator, tile_major):
    """Operands for ``route``, ``solve`` on them, the waveform."""
    state0, magT, basis_a, basis_b, inv_env, w = _gl_prepare(
        mag_specgrams, fft_length, hop_length, window, generator, tile_major,
        route)
    state, _ = solve(state0, magT, basis_a, basis_b, inv_env, fft_length,
                     hop_length, int(n_iter), float(momentum), tile_major)
    return _gl_finish(state, mag_specgrams.shape[:-2],
                      mag_specgrams.shape[-2], fft_length, hop_length, w,
                      inv_env, length, center, tile_major)


def _gl_plain(mag_specgrams, fft_length, hop_length, window, n_iter,
              momentum, length, center, generator=None, tile_major=False,
              route: str = "dft"):
    """The fused Griffin-Lim's plain PyTorch version, on the tensor's own
    device: the same free-edge solve, operands and layouts as
    :func:`_gl_fused`, with :func:`_gl_solve_plain` (``route="dft"``) or
    :func:`_gl_solve_fft_plain` (``route="fft"``) in the kernels' place."""
    solve = (_gl_solve_fft_plain if _route_for(fft_length, route) == "fft"
             else _gl_solve_plain)
    return _gl_run(solve, route, mag_specgrams, fft_length, hop_length,
                   window, n_iter, momentum, length, center, generator,
                   tile_major)


def _gl_fused(mag_specgrams, fft_length, hop_length, window, n_iter,
              momentum, length, center, generator=None, tile_major=False):
    """The fused Griffin-Lim loop (the JAX package's ``_gl_pallas``); the
    caller guarantees eligibility.  A CUDA tensor launches the kernels of
    the route its ``fft_length`` takes or raises; a CPU tensor runs the
    plain version."""
    device = mag_specgrams.device.type
    if device == "cpu":
        solve, route = _gl_solve_plain, "dft"
    elif device == "cuda":
        solve, route = _gl_solve_cuda, _route_for(fft_length, None)
    else:
        raise ValueError(f"unsupported device {mag_specgrams.device}")
    return _gl_run(solve, route, mag_specgrams, fft_length, hop_length,
                   window, n_iter, momentum, length, center, generator,
                   tile_major)
