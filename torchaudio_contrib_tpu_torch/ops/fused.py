"""Fused (log-)mel spectrogram: one CUDA kernel from waveform to log-mel,
and a CUDA backward for training.

Port of ``torchaudio_contrib_tpu/ops/fused.py``.  On a CUDA tensor,
:func:`fused_melspectrogram` launches a hand-written Hopper kernel of
``csrc/fused_mel_fwd.cu`` (built by :mod:`._cuda` on first use), which
frames and windows the waveform, transforms each frame, forms the power,
applies the filterbank and the dB epilogue without writing the spectrum
to device memory.  Which kernel is a function of ``fft_length`` alone
(:func:`_fft_kernel_supported`):

* a power of two from 256 to 2048 takes the FFT kernels: the transform is
  a radix-8/4/2 FFT per frame in shared memory (``csrc/fft_smem.cuh``),
  a real frame as one complex transform of half its length.  The forward
  and the frame gradient are then bound by their mel products (FP32 FMAs)
  and the FFT's shared-memory traffic;
* every other size (Whisper's 400, odd and very small sizes) takes the
  DFT-product kernels: the transform as a dense FP32 product with the
  windowed DFT basis, ~160 x an FFT's operations, which bounds them.

When a gradient is needed, :class:`_FusedMel` runs the forward with its
re/im residual output and hands the whole backward to one callable of a
fixed contract (see :class:`_FusedMel`); on the card that is
:func:`_op_bwd_cuda`: the dB gate, the backward kernels of
``csrc/fused_mel_bwd.cu`` (whose frame-gradient passes are one kernel
around the inverse FFT on the first route, two passes around the
transposed product on the second) and the overlap-add onto the waveform.
On the first route, at a hop from ``fft_length/17`` to ``fft_length``
(:func:`_dx_fusable`), the frame pass does the overlap-add itself and
writes the waveform gradient: the frame gradient never reaches device
memory.  Every other case overlap-adds the kernel's frame gradient with
``stft._overlap_add``.  :func:`_op_bwd_plain` and
:func:`_op_bwd_fft_plain` keep the same contract around the kernels'
plain versions, for the CPU tests.
On a CPU tensor it runs :func:`_reference`, the plain PyTorch chain the
kernels compute, with autograd.  So does a call with ``power != 2`` on any
device, as in the JAX package (its ``_kernel_eligible``): the rule is read
from the arguments before anything is launched.  There is no other
fallback: a CUDA tensor the kernels cannot take raises, and so does a
failed build or launch on either route.

The kernels put the stream (clip) index on a grid dimension of at most
65 535 blocks; the wrappers launch larger batches as slabs of that many
(:func:`_slabs`), one launch counted per call.

On the FFT route both filterbank products, the forward's mel product and
the frame pass's ``dp``, run over the filterbank's nonzero bands wherever
those cover a small share of the dense product (every mel or linear
filterbank does): :func:`_mel_bands` launches ``mel_band_kernel`` on every
call, which writes the padded filterbank, its transpose and the band
tables, and every block of the product's kernel decides from the tables
alone.  Nothing is cached from one call to the next, so a filterbank changed
in place is always seen.  :func:`_fb_bands` and :func:`_band_choice` are
the tables and the decision in plain PyTorch.

``KERNEL_LAUNCHES`` counts the forward kernels' launches,
``BWD_KERNEL_LAUNCHES`` the backward's, and ``BWD_DFRAMES_LAUNCHES`` those
backward launches that also ran the frame gradient passes;
``FFT_KERNEL_LAUNCHES`` and ``BWD_FFT_LAUNCHES`` count those of the
forward and of the frame passes that took the FFT route (and nothing
else), and ``BWD_DX_FUSED_LAUNCHES`` those frame passes that wrote the
waveform gradient themselves; ``BWD_DFB_LAUNCHES`` counts the
filterbank-gradient passes and ``BWD_DFB_ONE_READ_LAUNCHES`` those whose
blocks covered every mel column, so that they read the residual once;
``MEL_BAND_LAUNCHES`` the band passes.  The card counts the launches that
took a banded product itself (``B1_BANDED_LAUNCHES``,
``BWD_DP_BANDED_LAUNCHES``: :func:`card_counts`), one thread of the launch
adding one in mapped host memory, since only the card knows what its
blocks decided.  So a run can show which kernels it went through.

On a CUDA tensor the op marks its parts for a recording ``torch.profiler``
(``tac::fused_mel``, ``tac::fused_mel.fwd``, ``tac::fused_mel.bwd`` with
``.dmel``, ``.bwd_launch`` and, where the host overlap-adds,
``.overlap_add``), and the caches of
constants count what they copy to the card (``CONST_UPLOADS``,
``CONST_UPLOAD_BYTES``): see :mod:`..utils.trace`.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.trace import span, uploaded
from . import _cuda
from .complexops import complex_norm
from .db import amplitude_to_db
from .filters import apply_filterbank
from .stft import (stft, _dft_matrices, _overlap_add, _pad_center,
                   _resolve_window)

__all__ = ["fused_melspectrogram", "fused_mel_supported",
           "resolve_precision"]

KERNEL_LAUNCHES = 0
BWD_KERNEL_LAUNCHES = 0
BWD_DFRAMES_LAUNCHES = 0
FFT_KERNEL_LAUNCHES = 0
BWD_FFT_LAUNCHES = 0
BWD_DX_FUSED_LAUNCHES = 0
BWD_DFB_LAUNCHES = 0
BWD_DFB_ONE_READ_LAUNCHES = 0
MEL_BAND_LAUNCHES = 0
# counted on the card, in _CARD_COUNTS (see card_counts)
CARD_COUNTERS = ("B1_BANDED_LAUNCHES", "BWD_DP_BANDED_LAUNCHES")
_CARD_COUNTS = None
_CARD_COUNTS_LOCK = threading.Lock()

_PRECISIONS = ("fast", "split3", "split6")

# Tile constants of csrc/fused_mel_fwd.cu and csrc/fused_mel_bwd.cu; the
# basis, the filterbank and the residual are laid out for them here, and
# they are checked against the built library.
_FRAME_TILE = 64    # frames per thread block
_FREQ_TILE = 64     # onesided bins per frequency tile
_K_TILE = 16        # fft samples per K step (basis rows pad to this)
_MEL_TILE = 64      # mel columns per step (filterbank columns pad to this)
_MAX_MELS = 704     # the (frames, mels) accumulator must fit shared memory
_MAX_GRID_Y = 65535  # streams (clips) per launch: grid.y (grid.z)
_DFB_BLOCKS = 264   # the dFB pass splits the rows to fill two blocks an SM
_DFB_BINS = 128     # bins per dFB block (two frequency tiles)
_DFB_MELS = 128     # mel columns per dFB block where m_pad is a multiple
# the FFT kernels take their banded product where its work is at most this
# share, in 1/1024, of the dense product's: the forward's mel product and
# the frame pass's dp (see csrc/fused_mel_fwd.cu, csrc/fused_mel_bwd.cu)
_B1_BAND_SHARE = 160
_DP_BAND_SHARE = 512
_BAND_EMPTY = 0x3fffffff   # an empty band's low end (csrc/mel_band.cuh)
# csrc/fft_smem.cuh: the frame lengths the FFT kernels are built for
# (powers of two; the complex transform has half the length), and the
# radix of a pass: radix-8 passes, then one radix-2 or radix-4 pass where
# the size leaves one.
_FFT_MIN = 256
_FFT_MAX = 2048
_FFT_RADIX = 8
# frames per block of the backward's FFT frame pass: its overlap-add
# epilogue needs a hop of at least fft_length / (_DX_FRAMES + 1), so that
# a tile's edges are shared with its two neighbours and no other tile
_DX_FRAMES = 16

_LN10_INV_10 = 10.0 / math.log(10.0)   # d(dB)/d(mel) = this / mel
_DB_TO_LIN = math.log(10.0) / 10.0     # mel = ref·exp(dB·this)


def resolve_precision(precision: str, fft_length: int,
                      num_mels: int) -> str:
    """Resolve ``"auto"`` to a concrete tier for this config, as the JAX
    package does: ``split6`` when mel bands average fewer than 8 linear
    bins, else ``split3``; an explicit tier passes through; anything else
    raises.  On the GPU every tier runs the same FP32 kernels (see
    :func:`fused_melspectrogram`)."""
    if precision == "auto":
        return ("split6" if (fft_length // 2 + 1) < 8 * num_mels
                else "split3")
    if precision not in _PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}: expected 'auto', "
            f"'split6', 'split3', or 'fast'")
    return precision


def fused_mel_supported(fft_length: int, hop_length: int) -> bool:
    """True when the kernel covers this config: any ``fft_length >= 2``
    and any positive hop (frames are read from the waveform at any
    stride; ragged edges are masked in the kernel)."""
    return fft_length >= 2 and hop_length > 0


def _slabs(n: int, size: int = _MAX_GRID_Y):
    """``(start, stop)`` ranges of at most ``size`` that cover ``range(n)``
    in order: the streams (clips) of one launch each."""
    return [(s, min(s + size, n)) for s in range(0, n, size)]


def _fft_kernel_supported(fft_length: int) -> bool:
    """True when ``fft_length`` takes the FFT kernels: a power of two from
    256 to 2048.  Every other size takes the DFT-product kernels."""
    return (_FFT_MIN <= fft_length <= _FFT_MAX
            and fft_length & (fft_length - 1) == 0)


def _dx_fusable(fft_length: int, hop_length: int) -> bool:
    """True when the backward's frame pass can overlap-add the frame
    gradient itself: the FFT route, and ``fft_length/(_DX_FRAMES + 1) ≤
    hop_length ≤ fft_length``."""
    return (_fft_kernel_supported(fft_length)
            and fft_length <= (_DX_FRAMES + 1) * hop_length
            and hop_length <= fft_length)


def _route_for(fft_length: int, route) -> str:
    """``"fft"`` or ``"dft"``: the rule of :func:`_fft_kernel_supported`
    unless ``route`` names one (to time and compare both kernels at one
    shape)."""
    if route is None:
        return "fft" if _fft_kernel_supported(fft_length) else "dft"
    if route not in ("fft", "dft"):
        raise ValueError(f"unknown route {route!r}: expected 'fft' or 'dft'")
    if route == "fft" and not _fft_kernel_supported(fft_length):
        raise ValueError(f"the FFT kernels take a power of two from "
                         f"{_FFT_MIN} to {_FFT_MAX}, not "
                         f"fft_length={fft_length}")
    return route


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def _hashable_window(window):
    if window is None or isinstance(window, str):
        return window
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().double().numpy()
    return tuple(np.asarray(window, dtype=np.float64).ravel().tolist())


@functools.lru_cache(maxsize=16)
def _basis_np(fft_length: int, win_key, win_length):
    """Windowed onesided DFT basis, built in float64 and cast to float32:
    ``(round_up(fft, K_TILE), FT·2·FREQ_TILE)`` with tile ``t`` columns
    ``[w·cos_t | −w·sin_t]``.  ``win_length < fft_length`` zero-pads and
    centres the window; bins past ``fft//2+1`` and rows past ``fft`` are
    zero, so the kernel's padded lanes contribute nothing."""
    n_freqs = fft_length // 2 + 1
    ft_count = _cdiv(n_freqs, _FREQ_TILE)
    f_pad = ft_count * _FREQ_TILE
    if win_length is None:
        win_length = fft_length
    w = _resolve_window(win_key, win_length, fft_length)[:, None]
    cos_m, msin_m = _dft_matrices(fft_length, True)
    pad = ((0, _round_up(fft_length, _K_TILE) - fft_length),
           (0, f_pad - n_freqs))
    wr = np.pad(w * cos_m, pad)
    wi = np.pad(w * msin_m, pad)
    tiles = []
    for t in range(ft_count):
        s = slice(t * _FREQ_TILE, (t + 1) * _FREQ_TILE)
        tiles.append(np.concatenate([wr[:, s], wi[:, s]], axis=1))
    basis = np.concatenate(tiles, axis=1).astype(np.float32)
    return basis, n_freqs, ft_count


@functools.lru_cache(maxsize=16)
def _basis_on(device: torch.device, fft_length: int, win_key, win_length):
    """:func:`_basis_np` copied to ``device`` once per config."""
    basis, n_freqs, ft_count = _basis_np(fft_length, win_key, win_length)
    basis = torch.from_numpy(basis).to(device)
    uploaded(basis)
    return basis, n_freqs, ft_count


def _fft_plan(n: int):
    """The passes ``(radix, product of the earlier radices)`` of the FFT
    kernels' complex transform of ``n`` points: radix 8 while 8 divides
    what is left, then what is left (2 or 4)."""
    plan, ns = [], 1
    while ns < n:
        r = min(_FFT_RADIX, n // ns)
        plan.append((r, ns))
        ns *= r
    return plan


@functools.lru_cache(maxsize=16)
def _twiddle_np(fft_length: int) -> np.ndarray:
    """The FFT kernels' twiddle table ``(fft_length, 2)`` of ``(re, im)``
    pairs, in float64, in the order the kernels' threads read it (see
    ``csrc/fft_smem.cuh``).  With ``N = fft_length``, ``M = N/2`` and ``W_j
    = exp(−2πi j/N)``: entries ``[0, M)`` are ``W_k``, for the real-input
    step; then, for each pass ``(R, NS)`` of the ``M``-point transform
    after the first, ``w^(r·k)`` at ``(r − 1)·NS + k`` for ``r = 1..R−1``,
    ``k = 0..NS−1``, ``w = exp(−2πi/(NS·R))``, every value taken from the
    same ``W``; zeros fill the rest."""
    n, m = fft_length, fft_length // 2
    ang = 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    base = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    parts = [base[:m]]
    for radix, ns in _fft_plan(m)[1:]:
        r = np.arange(1, radix)[:, None]
        k = np.arange(ns)[None, :]
        parts.append(base[(2 * r * k * (m // (ns * radix))).ravel()])
    table = np.concatenate(parts)
    return np.pad(table, ((0, n - len(table)), (0, 0)))


@functools.lru_cache(maxsize=16)
def _fft_consts_on(device: torch.device, fft_length: int, win_key,
                   win_length):
    """The FFT kernels' constants on ``device``, once per config: the
    window zero-padded to ``fft_length`` and the twiddle table, built in
    float64 and cast to float32."""
    if win_length is None:
        win_length = fft_length
    w = _resolve_window(win_key, win_length, fft_length)
    # never inference tensors, whatever mode the first caller was in
    with torch.inference_mode(False):
        consts = (torch.from_numpy(w.astype(np.float32)).to(device),
                  torch.from_numpy(_twiddle_np(fft_length).astype(np.float32))
                  .to(device))
    uploaded(*consts)
    return consts


def _fft_consts(like, fft_length, window, win_length):
    """``(window (fft,), twiddles (fft,) complex)`` for the step-by-step
    plain versions, on ``like``'s device in its precision: the float32
    tables the kernels read, or the float64 ones for a float64 input."""
    if like.dtype == torch.float64:
        wl = fft_length if win_length is None else win_length
        w = torch.from_numpy(_resolve_window(_hashable_window(window), wl,
                                             fft_length)).to(like)
        tw = torch.from_numpy(_twiddle_np(fft_length)).to(like.device)
    else:
        w, tw = _fft_consts_on(like.device, fft_length,
                               _hashable_window(window), win_length)
        w = w.to(like.dtype)
    return w, torch.view_as_complex(tw.contiguous())


def _fb_padded(filterbank, ft_count: int, m_pad: int):
    """The filterbank zero-padded to ``(ft_count·FREQ_TILE, m_pad)``."""
    n_freqs, num_mels = filterbank.shape
    return F.pad(filterbank, (0, m_pad - num_mels,
                              0, ft_count * _FREQ_TILE - n_freqs))


# ---- the filterbank's bands ---------------------------------------------------

def _fb_bands(filterbank, m_pad: int):
    """The band tables that ``mel_band_kernel`` writes, in plain PyTorch and
    in its layout: ``(mel_band (m_pad, 2), bin_band (FT·FREQ_TILE, 2))``
    int32.  ``mel_band[m]`` is ``[lo, hi)``, the bins from mel ``m``'s
    first nonzero entry to its last, ``bin_band[k]`` the mels from bin
    ``k``'s first to its last; an empty range is ``(_BAND_EMPTY, 0)``.
    Nonzero means ``!= 0``: NaN and inf lie in a band.  The padding rows
    and columns are empty."""
    n_freqs, num_mels = filterbank.shape
    f_pad = _cdiv(n_freqs, _FREQ_TILE) * _FREQ_TILE
    nz = F.pad(filterbank != 0, (0, m_pad - num_mels, 0, f_pad - n_freqs))
    dev = filterbank.device

    def bands(mask, along):
        i = torch.arange(mask.shape[along], device=dev).view(
            (-1, 1) if along == 0 else (1, -1))
        return torch.stack([torch.where(mask, i, _BAND_EMPTY).amin(along),
                            torch.where(mask, i + 1, 0).amax(along)],
                           -1).to(torch.int32)

    return bands(nz, 0), bands(nz, 1)


def _band_work(mel_band, bin_band, fft_length: int, m_pad: int):
    """``((b1, b1_dense), (dp, dp_dense))``: the work of the forward's
    banded mel product and of the frame pass's banded dp against their
    dense products, as every block of the FFT kernels counts it from the
    tables.  The forward counts each mel's band rounded out to groups of 4
    bins against ``4·ceil((N/2+1)/4)`` bins a mel; the frame pass counts,
    for each lane of ``max(N/512, 1)`` consecutive bins below ``N/2``, the
    mels of their bands joined, against ``m_pad`` a lane."""
    band = mel_band.long()
    lo, hi = band[:, 0], band[:, 1]
    bins = int(torch.where(hi > lo, (hi + 3) // 4 * 4 - lo // 4 * 4, 0).sum())
    half = fft_length // 2
    lanes = bin_band[:half].long().view(-1, max(half // 256, 1), 2)
    mels = int((lanes[..., 1].amax(1) - lanes[..., 0].amin(1))
               .clamp(min=0).sum())
    return ((bins, 4 * ((half + 4) // 4) * m_pad),
            (mels, lanes.shape[0] * m_pad))


def _band_choice(mel_band, bin_band, fft_length: int, m_pad: int):
    """``(b1, dp)``: whether the forward's mel product and the frame pass's
    dp take their banded loops at these tables (:func:`_band_work`): where
    the banded work is at most its share (``_B1_BAND_SHARE``,
    ``_DP_BAND_SHARE``, in 1/1024) of the dense product's."""
    (b1, b1_dense), (dp, dp_dense) = _band_work(mel_band, bin_band,
                                                fft_length, m_pad)
    return (b1 * 1024 <= _B1_BAND_SHARE * b1_dense,
            dp * 1024 <= _DP_BAND_SHARE * dp_dense)


def _mel_product_banded(p, filterbank, mel_band):
    """``p (..., n_freqs) @ filterbank`` summed over each mel's band only."""
    band = mel_band.tolist()
    out = p.new_zeros(p.shape[:-1] + (filterbank.shape[1],))
    for m, (lo, hi) in enumerate(band[:filterbank.shape[1]]):
        if hi > lo:
            out[..., m] = p[..., lo:hi] @ filterbank[lo:hi, m]
    return out


def _dp_banded(dmel, filterbank, bin_band):
    """``dmel (rows, ≥ num_mels) @ filterbank.T`` summed over each bin's
    band only: ``(rows, n_freqs)``."""
    out = dmel.new_zeros((dmel.shape[0], filterbank.shape[0]))
    for k, (lo, hi) in enumerate(bin_band[:filterbank.shape[0]].tolist()):
        if hi > lo:
            out[:, k] = dmel[:, lo:hi] @ filterbank[k, lo:hi]
    return out


def _banded_flag(banded) -> int:
    """The kernels' ``banded`` argument: -1 (the tables decide), 1, 0."""
    if not (banded is None or banded is True or banded is False):
        raise ValueError(f"_banded must be None, True or False, not "
                         f"{banded!r}")
    return -1 if banded is None else int(banded)


def _card_counter(i: int) -> int:
    """The card's address of counter ``i`` of ``CARD_COUNTERS``: pinned host
    memory, which the card reaches through unified addressing."""
    global _CARD_COUNTS
    if _CARD_COUNTS is None:
        # once: a second buffer would leave launches writing to a freed one
        with _CARD_COUNTS_LOCK:
            if _CARD_COUNTS is None:
                _CARD_COUNTS = torch.zeros(len(CARD_COUNTERS),
                                           dtype=torch.int32, pin_memory=True)
    return _CARD_COUNTS.data_ptr() + i * _CARD_COUNTS.element_size()


def card_counts() -> dict:
    """``{name: launches}`` of ``CARD_COUNTERS``, as the card has counted
    them so far: read with no synchronise, so exact once the card has
    finished the launches (after a ``torch.cuda.synchronize()``)."""
    values = ([0] * len(CARD_COUNTERS) if _CARD_COUNTS is None
              else _CARD_COUNTS.tolist())
    return dict(zip(CARD_COUNTERS, values))


def _band_sizes(ft_count: int, m_pad: int, padded: bool):
    """Floats of ``fbp`` (0 unless ``padded``), ``fbt``, ``mel_band`` and
    ``bin_band`` in :func:`_mel_bands`' buffer, in that order."""
    size = ft_count * _FREQ_TILE * m_pad
    return (size if padded else 0, size, m_pad * 2, ft_count * _FREQ_TILE * 2)


def _mel_bands(filterbank, ft_count: int, m_pad: int, padded: bool,
               stream: int):
    """Launch ``mel_band_kernel`` on the filterbank, on ``stream`` (the
    caller holds its device): returns the buffer it writes, one allocation
    that holds ``fbp`` (the padded filterbank, which the forward's dense
    product reads; only when ``padded``), ``fbt``, ``mel_band`` and
    ``bin_band`` as :func:`_fb_bands` lays them out, and their addresses
    (None for a missing ``fbp``); :func:`_band_parts` views it.  No
    synchronise, and no tensor but the buffer, to keep the host's part of
    a call small."""
    global MEL_BAND_LAUNCHES
    n_freqs, num_mels = filterbank.shape
    sizes = _band_sizes(ft_count, m_pad, padded)
    buf = torch.empty(sum(sizes), dtype=torch.float32,
                      device=filterbank.device)
    ptrs, at = [], buf.data_ptr()
    for n in sizes:
        ptrs.append(at if n else None)
        at += 4 * n
    lib = _kernel_lib()
    rc = lib.tac_mel_bands(filterbank.data_ptr(), *filterbank.stride(),
                           n_freqs, num_mels, m_pad, ft_count, *ptrs, stream)
    _launch_check(lib, rc, "band")
    MEL_BAND_LAUNCHES += 1
    return buf, ptrs


def _band_parts(buf, ft_count: int, m_pad: int, padded: bool):
    """:func:`_mel_bands`' buffer as ``(fbp or None, fbt, mel_band,
    bin_band)`` tensors."""
    fbp, fbt, mel_band, bin_band = buf.split(_band_sizes(ft_count, m_pad,
                                                         padded))
    f_pad = ft_count * _FREQ_TILE
    return (fbp.view(f_pad, m_pad) if padded else None,
            fbt.view(m_pad, f_pad), mel_band.view(torch.int32).view(m_pad, 2),
            bin_band.view(torch.int32).view(f_pad, 2))


@functools.lru_cache(maxsize=1)
def _kernel_lib():
    lib = _cuda.load()
    for query, want in ((lib.tac_fused_mel_fwd_tile,
                         (_FRAME_TILE, _FREQ_TILE, _K_TILE, _MEL_TILE)),
                        (lib.tac_fused_mel_fft_tile,
                         (_FFT_MIN, _FFT_MAX, _FREQ_TILE, _MEL_TILE,
                          _B1_BAND_SHARE)),
                        (lib.tac_fused_mel_bwd_tile,
                         (_FRAME_TILE, _FREQ_TILE, _K_TILE, _MEL_TILE,
                          _DX_FRAMES, _DFB_BINS, _DFB_MELS,
                          _DP_BAND_SHARE))):
        tiles = tuple(query(i) for i in range(len(want)))
        if tiles != want:
            raise RuntimeError(f"kernel tiles {tiles} do not match the host "
                               f"layout {want}")
    return lib


def _launch_check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused mel {what} kernel failed to launch: "
                           f"{lib.tac_error_string(rc).decode()} "
                           f"(cudaError {rc})")


def _reference(waveform, filterbank, fft_length, hop_length, window, power,
               to_db, db_ref, amin, win_length=None):
    """The plain PyTorch version of the kernel: stft(center=False) →
    |·|^power → mel → dB, as the JAX package's ``_jnp_reference``."""
    spec = stft(waveform, fft_length, hop_length, win_length=win_length,
                window=window, center=False)
    mel = apply_filterbank(complex_norm(spec, power), filterbank)
    if to_db:
        mel = amplitude_to_db(mel, ref=db_ref, amin=amin, power=power)
    return mel


# ---- the kernels' plain versions, in the kernels' layouts -------------------

def _plain_basis(like, fft_length, window, win_length):
    """The kernels' basis rows ``[:fft_length]`` on ``like``'s device and
    in its dtype (no host copy per call on the card), with ``n_freqs`` and
    ``ft_count``."""
    basis, n_freqs, ft_count = _basis_on(
        like.device, fft_length, _hashable_window(window), win_length)
    return basis[:fft_length].to(like.dtype), n_freqs, ft_count


def _fwd_res_plain(x2, filterbank, fft_length, hop_length, window,
                   win_length, to_db, db_ref, amin, save_spec=False):
    """Plain PyTorch version of the forward kernel on ``x2 (streams, T)``:
    ``(out (streams, num_mels, n_frames), reim)``, where ``reim`` is the
    ``(streams, n_frames, FT·2·FREQ_TILE)`` residual (``[re_t | im_t]`` per
    tile, the basis's layout) when ``save_spec``, else None.  Computes in
    ``x2``'s dtype."""
    basis, n_freqs, ft_count = _plain_basis(x2, fft_length, window,
                                            win_length)
    streams = x2.shape[0]
    reim = x2.unfold(-1, fft_length, hop_length) @ basis
    n_frames = reim.shape[1]
    ri = reim.view(streams, n_frames, ft_count, 2, _FREQ_TILE)
    p = (ri[..., 0, :] ** 2 + ri[..., 1, :] ** 2).reshape(
        streams, n_frames, ft_count * _FREQ_TILE)
    mel = p[..., :n_freqs] @ filterbank
    if to_db:
        mel = amplitude_to_db(mel, ref=db_ref, amin=amin, power=2.0)
    return mel.transpose(1, 2).contiguous(), (reim if save_spec else None)


def _dfb_dreim_plain(dmel, reim, filterbank, need_dx, need_dfb,
                     bin_band=None):
    """The backward's dFB pass and pass A in plain PyTorch: ``(dreim (rows,
    FT·2·FREQ_TILE) or None, dfb (n_freqs, num_mels) or None)``; given
    ``bin_band`` (:func:`_fb_bands`), dp is summed over each bin's band."""
    n_freqs, num_mels = filterbank.shape
    rows = dmel.shape[0]
    ri = reim.view(rows, -1, 2, _FREQ_TILE)
    re, im = ri[:, :, 0], ri[:, :, 1]
    dreim = dfb = None
    if need_dfb:
        p = (re * re + im * im).reshape(rows, -1)
        dfb = p[:, :n_freqs].T @ dmel[:, :num_mels]
    if need_dx:
        dp = (dmel[:, :num_mels] @ filterbank.T if bin_band is None
              else _dp_banded(dmel, filterbank, bin_band))
        dp = F.pad(dp, (0, ri.shape[1] * _FREQ_TILE - n_freqs)).view(
            rows, -1, _FREQ_TILE)
        dreim = torch.stack([2.0 * re * dp, 2.0 * im * dp],
                            dim=2).reshape(rows, -1)
    return dreim, dfb


def _bwd_plain(dmel, reim, filterbank, fft_length, window, win_length,
               need_dx, need_dfb):
    """Plain PyTorch version of the backward kernel: from ``dmel (rows,
    m_pad)`` (gated, zero past num_mels) and the residual ``reim (rows,
    FT·2·FREQ_TILE)``, ``(dframes (rows, fft) or None, dfb (n_freqs,
    num_mels) or None)``."""
    dreim, dfb = _dfb_dreim_plain(dmel, reim, filterbank, need_dx, need_dfb)
    dframes = None
    if need_dx:
        basis, _, _ = _plain_basis(reim, fft_length, window, win_length)
        dframes = dreim @ basis.T
    return dframes, dfb


# ---- the FFT kernels' plain versions, step by step ---------------------------

def _rot4(a, inverse):
    """``a·(−i)`` forward, ``a·(+i)`` inverse."""
    return torch.complex(-a.imag, a.real) if inverse \
        else torch.complex(a.imag, -a.real)


def _dft_small(x, inverse):
    """The kernels' 2-, 4- and 8-point DFTs of the list ``x``, outputs in
    natural order."""
    if len(x) == 2:
        return [x[0] + x[1], x[0] - x[1]]
    if len(x) == 4:
        e0, e1 = x[0] + x[2], x[0] - x[2]
        o0, o1 = x[1] + x[3], _rot4(x[1] - x[3], inverse)
        return [e0 + o0, e1 + o1, e0 - o0, e1 - o1]
    e, o = _dft_small(x[0::2], inverse), _dft_small(x[1::2], inverse)
    h = math.sqrt(0.5)
    w1 = complex(h, h) if inverse else complex(h, -h)
    w3 = complex(-h, h) if inverse else complex(-h, -h)
    o = [o[0], o[1] * w1, _rot4(o[2], inverse), o[3] * w3]
    return [a + b for a, b in zip(e, o)] + [a - b for a, b in zip(e, o)]


def _stockham_fft(z, tw, inverse: bool = False):
    """The FFT kernels' transform of ``z (..., M)`` complex along its last
    axis, pass by pass as ``csrc/fft_smem.cuh`` runs it: a Stockham autosort
    FFT whose pass of radix ``R`` after radices multiplying to ``NS`` takes,
    for butterfly ``b`` in ``[0, M/R)`` with ``k = b mod NS``, the points
    ``b + r·M/R``, multiplies point ``r`` by ``w^(r·k)``, ``w = exp(−2πi/
    (NS·R))`` (conjugated for the inverse), takes their ``R``-point DFT and
    writes output ``r`` to ``(b − k)·R + k + r·NS``.  Unnormalised in both
    directions.  ``tw`` is the kernels' table (:func:`_twiddle_np`, complex)
    of a frame of ``2M`` samples, whose passes' sections start at ``M``."""
    n = z.shape[-1]
    if inverse:
        tw = tw.conj()
    offset = n
    for radix, ns in _fft_plan(n):
        b = torch.arange(n // radix, device=z.device)
        k = b % ns
        pts = [z[..., b + r * (n // radix)] for r in range(radix)]
        if ns > 1:
            pts = [pts[0]] + [pts[r] * tw[offset + (r - 1) * ns + k]
                              for r in range(1, radix)]
            offset += (radix - 1) * ns
        z = torch.empty_like(z)
        for r, value in enumerate(_dft_small(pts, inverse)):
            z[..., (b - k) * radix + k + r * ns] = value
    return z


def _to_tiles(re, im, ft_count: int):
    """``re``, ``im`` ``(..., n_freqs)`` in the residual's layout ``(...,
    FT·2·FREQ_TILE)``: tile ``t`` columns ``[re_t | im_t]``, zeros in the
    bins past ``n_freqs``."""
    pad = ft_count * _FREQ_TILE - re.shape[-1]
    parts = [F.pad(t, (0, pad)).reshape(t.shape[:-1] + (ft_count, 1,
                                                        _FREQ_TILE))
             for t in (re, im)]
    return torch.cat(parts, dim=-2).reshape(re.shape[:-1] + (-1,))


def _fwd_fft_plain(x2, filterbank, fft_length, hop_length, window,
                   win_length, to_db, db_ref, amin, save_spec=False,
                   _banded=None):
    """Plain PyTorch version of the FFT forward kernel, step by step;
    arguments and results as :func:`_fwd_res_plain`.  A windowed frame of
    ``N = 2M`` samples is packed as ``z[m] = x[2m] + i·x[2m+1]``,
    transformed by :func:`_stockham_fft` (``M`` points, the kernel's twiddle
    table, whose first ``M`` entries are ``W``) and split into its bins: with
    ``E_k = (Z_k + conj Z_{M−k})/2`` and ``O_k = (Z_k − conj Z_{M−k})/(2i)``,
    ``X_k = E_k + W_k·O_k`` for ``k < M`` and ``X_M = E_0 − O_0``.  The mel
    product runs over each mel's band where :func:`_band_choice` says the
    kernel's does (``_banded`` forces either)."""
    n = fft_length
    m = n // 2
    ft_count = _cdiv(m + 1, _FREQ_TILE)
    w, tw = _fft_consts(x2, n, window, win_length)
    frames = x2.unfold(-1, n, hop_length) * w
    zf = _stockham_fft(torch.complex(frames[..., 0::2], frames[..., 1::2]),
                       tw)
    k = torch.arange(m + 1, device=zf.device)
    zk, zn = zf[..., k % m], zf[..., (m - k) % m]
    e = 0.5 * (zk + zn.conj())
    o = torch.complex(0.5 * (zk.imag + zn.imag), 0.5 * (zn.real - zk.real))
    spec = e + torch.cat([tw[:m], -tw[:1]]) * o
    re, im = spec.real, spec.imag
    m_pad = _round_up(filterbank.shape[1], _MEL_TILE)
    mel_band, bin_band = _fb_bands(filterbank, m_pad)
    if _banded is None:
        _banded = _band_choice(mel_band, bin_band, n, m_pad)[0]
    p = re * re + im * im
    mel = (_mel_product_banded(p, filterbank, mel_band) if _banded
           else p @ filterbank)
    if to_db:
        mel = amplitude_to_db(mel, ref=db_ref, amin=amin, power=2.0)
    reim = _to_tiles(re, im, ft_count) if save_spec else None
    return mel.transpose(1, 2).contiguous(), reim


def _dframes_fft_plain(dreim, fft_length, window, win_length):
    """Plain PyTorch version of the backward's FFT frame-gradient pass,
    step by step: ``dreim (rows, FT·2·FREQ_TILE)`` → ``dframes (rows,
    fft)``.  With ``G = dre + i·dim``, ``dframes_n = w_n · Re Σ_{k=0}^{N/2}
    G_k e^{+2πikn/N}``: the unnormalised inverse transform ``y`` of the
    Hermitian spectrum ``Y_0 = Re G_0``, ``Y_{N/2} = Re G_{N/2}``, ``Y_k =
    G_k/2`` (not ``irfft(G)``: DC and Nyquist weigh double).  As the kernel
    runs it, ``M = N/2``: ``Z_k = (Y_k + conj Y_{M−k}) + i·(Y_k − conj
    Y_{M−k})·conj W_k`` for ``k < M``, whose inverse ``M``-point transform
    is ``z[m] = y[2m] + i·y[2m+1]``."""
    n = fft_length
    m = n // 2
    rows = dreim.shape[0]
    w, tw = _fft_consts(dreim, n, window, win_length)
    ri = dreim.view(rows, -1, 2, _FREQ_TILE)
    dre = ri[:, :, 0].reshape(rows, -1)[:, :m + 1]
    dim = ri[:, :, 1].reshape(rows, -1)[:, :m + 1]
    y = 0.5 * torch.complex(dre, dim)
    y[:, 0] = dre[:, 0]
    y[:, m] = dre[:, m]
    k = torch.arange(m, device=dreim.device)
    yk, yn = y[:, k], y[:, m - k].conj()
    o = (yk - yn) * tw[:m].conj()
    z = _stockham_fft((yk + yn) + torch.complex(-o.imag, o.real), tw,
                      inverse=True)
    return torch.stack([z.real, z.imag], dim=-1).reshape(rows, n) * w


def _bwd_fft_plain(dmel, reim, filterbank, fft_length, window, win_length,
                   need_dx, need_dfb, _banded=None):
    """Plain PyTorch version of the backward kernel on the FFT route;
    arguments and results as :func:`_bwd_plain`.  dp runs over each bin's
    band where :func:`_band_choice` says the frame pass's does (``_banded``
    forces either)."""
    bands = None
    if need_dx:
        mel_band, bin_band = _fb_bands(filterbank, dmel.shape[1])
        if _banded is None:
            _banded = _band_choice(mel_band, bin_band, fft_length,
                                   dmel.shape[1])[1]
        bands = bin_band if _banded else None
    dreim, dfb = _dfb_dreim_plain(dmel, reim, filterbank, need_dx, need_dfb,
                                  bands)
    dframes = (_dframes_fft_plain(dreim, fft_length, window, win_length)
               if need_dx else None)
    return dframes, dfb


# ---- the kernels' launch wrappers -------------------------------------------

def _fused_mel_fwd_cuda(x2, filterbank, fft_length, hop_length, window,
                        win_length, to_db, db_ref, amin, save_spec=False,
                        _route=None, _banded=None):
    """Launch a forward kernel on ``x2 (streams, T)``; returns ``(out
    (streams, num_mels, n_frames), reim or None)`` as
    :func:`_fwd_res_plain`.  The FFT kernel when
    :func:`_fft_kernel_supported`, else the DFT-product kernel (``_route``
    names one of them to compare both at one shape).  The FFT kernel runs
    after the band pass (:func:`_mel_bands`) and takes its banded mel
    product where the bands decide so (:func:`_band_choice`); ``_banded``
    True or False forces one product, for the tests.  Raises on any input
    it does not take; never computes the result another way."""
    global KERNEL_LAUNCHES, FFT_KERNEL_LAUNCHES
    route = _route_for(fft_length, _route)
    banded = _banded_flag(_banded)
    if route == "dft" and _banded is not None:
        raise ValueError("the banded products are the FFT kernels'")
    if not (x2.is_cuda and x2.dtype == torch.float32 and x2.ndim == 2
            and x2.is_contiguous()):
        raise ValueError("kernel input must be a contiguous float32 CUDA "
                         f"tensor (streams, T); got {x2.dtype} "
                         f"{tuple(x2.shape)} on {x2.device}")
    if not (filterbank.device == x2.device
            and filterbank.dtype == torch.float32 and filterbank.ndim == 2):
        raise ValueError("filterbank must be a float32 (bins, mels) tensor "
                         f"on {x2.device}; got {filterbank.dtype} "
                         f"{tuple(filterbank.shape)} on {filterbank.device}")
    streams, n_samples = x2.shape
    num_mels = filterbank.shape[1]
    if num_mels > _MAX_MELS:
        raise ValueError(f"num_mels={num_mels} exceeds the kernel's "
                         f"{_MAX_MELS}")
    if n_samples >= 2 ** 31:
        raise ValueError(f"input {tuple(x2.shape)} exceeds the kernel's "
                         f"2**31 samples a stream")
    n_frames = 1 + (n_samples - fft_length) // hop_length
    win_key = _hashable_window(window)
    ft_count = _cdiv(fft_length // 2 + 1, _FREQ_TILE)
    m_pad = _round_up(num_mels, _MEL_TILE)
    out = torch.empty((streams, num_mels, n_frames), dtype=torch.float32,
                      device=x2.device)
    reim = (torch.empty((streams, n_frames, ft_count * 2 * _FREQ_TILE),
                        dtype=torch.float32, device=x2.device)
            if save_spec else None)
    db_off = _LN10_INV_10 * math.log(max(amin, db_ref)) if to_db else 0.0
    lib = _kernel_lib()
    tail = (num_mels, m_pad, int(to_db), float(amin), float(db_off))
    slabs = _slabs(streams)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        # the filterbank as the kernel reads it: the band pass's buffer or
        # the padded copy (held until the launch)
        if route == "fft":
            fb_buf, bands = _mel_bands(filterbank, ft_count, m_pad, True,
                                       stream)
            ops = (*(t.data_ptr() for t in _fft_consts_on(
                x2.device, fft_length, win_key, win_length)), *bands[:3])
            entry, mid = lib.tac_fused_mel_fft_fwd, ()
            # the card counts a banded launch once, in the first slab
            ends = [(banded, _card_counter(0))] + [(banded, None)] * (
                len(slabs) - 1)
        else:
            fb_buf = _fb_padded(filterbank, ft_count, m_pad).contiguous()
            ops = (_basis_on(x2.device, fft_length, win_key,
                             win_length)[0].data_ptr(), fb_buf.data_ptr())
            entry, mid = lib.tac_fused_mel_fwd, (ft_count,)
            ends = [()] * len(slabs)
        for (s0, s1), end in zip(slabs, ends):
            rc = entry(x2[s0].data_ptr(), *ops, out[s0].data_ptr(),
                       reim[s0].data_ptr() if save_spec else None,
                       s1 - s0, n_samples, fft_length, hop_length, n_frames,
                       *mid, *tail, *end, stream)
            _launch_check(lib, rc, f"forward ({route})")
    KERNEL_LAUNCHES += 1
    FFT_KERNEL_LAUNCHES += int(route == "fft")
    return out, reim


def _dfb_splits(rows: int, tiles: int):
    """``(n_splits, rows_per_split)`` for the dFB pass: enough row splits
    that ``tiles`` output tiles fill about ``_DFB_BLOCKS`` blocks, at least
    256 rows each.  A function of the shapes only, so the sum order, and
    with it every bit of the result, is the same on every run."""
    n_splits = max(1, min(_cdiv(_DFB_BLOCKS, tiles), _cdiv(rows, 256)))
    per = _round_up(_cdiv(rows, n_splits), _K_TILE)
    return _cdiv(rows, per), per


def _dfb_grid(rows: int, n_freqs: int, m_pad: int):
    """``(n_splits, rows_per_split, tiles, one_read)`` for the dFB pass,
    as ``csrc/fused_mel_bwd.cu`` lays it out: ``_DFB_BINS``-bin tiles, a
    lone last bin (the Nyquist bin of the FFT sizes) folded into tile 0;
    all ``m_pad`` mel columns in one tile up to ``_DFB_MELS``, else tiles
    of ``_DFB_MELS`` (``_MEL_TILE`` where ``m_pad`` is no multiple of
    it); ``tiles`` output tiles a split, and ``one_read`` when every
    block covers all the mel columns, so that the residual is read once."""
    full, rem = divmod(n_freqs, _DFB_BINS)
    bin_tiles = full + int(rem > 1 or (rem == 1 and full == 0))
    mel_tiles = m_pad // (_DFB_MELS if m_pad % _DFB_MELS == 0 else _MEL_TILE)
    n_splits, per = _dfb_splits(rows, bin_tiles * mel_tiles)
    return n_splits, per, bin_tiles * mel_tiles, mel_tiles == 1


def _fused_mel_bwd_cuda(dmel, reim, filterbank, fft_length, window,
                        win_length, need_dx, need_dfb, _route=None,
                        hop_length=None, n_samples=None, _banded=None):
    """Launch the backward kernel; arguments and results as
    :func:`_bwd_plain`.  The frame-gradient passes run only when
    ``need_dx``: as one kernel around an inverse FFT when
    :func:`_fft_kernel_supported` (``dreim`` stays in registers; after the
    band pass, its dp product banded where the bands decide so, or as
    ``_banded`` forces), else as pass A and the product with the basis
    (``_route`` names one of the two).  The filterbank-gradient pass runs
    only when ``need_dfb``, and reads no filterbank.

    Given ``hop_length`` and ``n_samples`` (:func:`_dx_fusable`, FFT route
    only), the frame pass overlap-adds the frame gradient onto the waveform
    itself: the rows are streams of ``1 + (n_samples − fft)//hop`` frames,
    and the waveform gradient ``(streams, n_samples)``, zero past the last
    frame, is returned in place of ``dframes``.  Raises on any input it
    does not take."""
    global BWD_KERNEL_LAUNCHES, BWD_DFRAMES_LAUNCHES, BWD_FFT_LAUNCHES
    global BWD_DX_FUSED_LAUNCHES, BWD_DFB_LAUNCHES, BWD_DFB_ONE_READ_LAUNCHES
    route = _route_for(fft_length, _route)
    banded = _banded_flag(_banded)
    if route == "dft" and _banded is not None:
        raise ValueError("the banded products are the FFT kernels'")
    for name, t in (("dmel", dmel), ("reim", reim)):
        if not (t.is_cuda and t.dtype == torch.float32 and t.ndim == 2
                and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"matrix; got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    n_freqs = fft_length // 2 + 1
    ft_count = _cdiv(n_freqs, _FREQ_TILE)
    rows, m_pad = dmel.shape
    num_mels = filterbank.shape[1]
    if not (filterbank.device == dmel.device
            and filterbank.dtype == torch.float32
            and filterbank.shape[0] == n_freqs):
        raise ValueError(f"filterbank must be float32 ({n_freqs}, mels) on "
                         f"{dmel.device}; got {filterbank.dtype} "
                         f"{tuple(filterbank.shape)} on {filterbank.device}")
    if (m_pad % _MEL_TILE or not num_mels <= m_pad < num_mels + _MEL_TILE
            or reim.shape != (rows, ft_count * 2 * _FREQ_TILE)
            or reim.device != dmel.device):
        raise ValueError(f"dmel {tuple(dmel.shape)} / reim "
                         f"{tuple(reim.shape)} do not fit {num_mels} mels "
                         f"and {ft_count} frequency tiles")
    fuse_dx = hop_length is not None
    if fuse_dx:
        if not (need_dx and route == "fft"
                and _dx_fusable(fft_length, hop_length)):
            raise ValueError(f"the frame pass overlap-adds in the kernel "
                             f"only on the FFT route at a hop from "
                             f"fft_length/{_DX_FRAMES + 1} to fft_length, "
                             f"not fft_length={fft_length}, hop_length="
                             f"{hop_length}, route {route!r}")
        n_frames = 1 + (n_samples - fft_length) // hop_length
        if not (fft_length <= n_samples < 2 ** 31 and rows % n_frames == 0):
            raise ValueError(f"the {rows} rows are no whole number of "
                             f"streams of {n_samples} samples at hop "
                             f"{hop_length}")
    if not (need_dx or need_dfb):
        return None, None
    dev = dict(dtype=torch.float32, device=dmel.device)
    dframes = dx = None
    if need_dx and fuse_dx:
        dx = torch.empty((rows // n_frames, n_samples), **dev)
    elif need_dx:
        dframes = torch.empty((rows, fft_length), **dev)
    # the frame passes' operands: the transposed filterbank, its bins' bands,
    # the window and the twiddles (one kernel), or the padded filterbank,
    # the dreim scratch and the basis (two)
    fbp = w = tw = dreim = basis = None
    k_pad = 0
    win_key = _hashable_window(window)
    if need_dx and route == "fft":
        w, tw = _fft_consts_on(dmel.device, fft_length, win_key, win_length)
    elif need_dx:
        fbp = _fb_padded(filterbank, ft_count, m_pad).contiguous()
        dreim = torch.empty_like(reim)
        basis, _, _ = _basis_on(dmel.device, fft_length, win_key, win_length)
        k_pad = basis.shape[0]
    dfb = part = None
    n_splits = per = 0      # read by the library only with dfb
    one_read = False
    if need_dfb:
        n_splits, per, _, one_read = _dfb_grid(rows, n_freqs, m_pad)
        dfb = torch.empty((n_freqs, m_pad), **dev)
        if n_splits > 1:
            part = torch.empty((n_splits, n_freqs, m_pad), **dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _kernel_lib()
    with torch.cuda.device(dmel.device):
        stream = torch.cuda.current_stream(dmel.device).cuda_stream
        # the FFT frame pass's transposed filterbank and its bins' bands
        fbt = bin_band = counter = None
        if need_dx and route == "fft":
            fb_buf, (_, fbt, _, bin_band) = _mel_bands(
                filterbank, ft_count, m_pad, False, stream)
            counter = _card_counter(1)
        rc = lib.tac_fused_mel_bwd(
            dmel.data_ptr(), reim.data_ptr(), ptr(fbp), fbt, bin_band,
            ptr(basis), ptr(w), ptr(tw), ptr(dreim), ptr(dframes), ptr(dx),
            ptr(dfb), ptr(part), rows, fft_length, k_pad, ft_count, m_pad,
            n_splits, per, hop_length if fuse_dx else 0,
            n_samples if fuse_dx else 0, banded, counter, stream)
    _launch_check(lib, rc, f"backward ({route})")
    BWD_KERNEL_LAUNCHES += 1
    BWD_DFRAMES_LAUNCHES += int(need_dx)
    BWD_FFT_LAUNCHES += int(need_dx and route == "fft")
    BWD_DX_FUSED_LAUNCHES += int(fuse_dx)
    BWD_DFB_LAUNCHES += int(need_dfb)
    BWD_DFB_ONE_READ_LAUNCHES += int(one_read)
    return (dx if fuse_dx else dframes,
            dfb[:, :num_mels] if need_dfb else None)


# ---- autograd --------------------------------------------------------------

def _dmel_from(g, y, to_db: bool, db_ref: float, amin: float):
    """The backward kernel's ``dmel (streams·n_frames, m_pad)`` from the
    output cotangent ``g`` and the saved output ``y``, both ``(streams,
    num_mels, n_frames)``: d(loss)/d(mel) with the dB gate recomputed from
    ``y`` (``mel_clamped = max(ref, amin)·10^(y/10)``), frames as rows,
    mels zero-padded to the mel tile.

    As in the JAX package, the gate carries a 1e-4 relative tolerance:
    entries clamped to ``amin`` in the forward (silence, zero-weight mel
    bins) come back through the f32 exp∘log round trip as ``amin·(1 ±
    ~4e-6)``, and a strict ``> amin`` test would leak ``g/amin``-scale
    gradients into them (the chain's gradient is exactly 0 there)."""
    if to_db:
        mel_c = max(db_ref, amin) * torch.exp(y * _DB_TO_LIN)
        g = torch.where(mel_c > amin * (1.0 + 1e-4),
                        g * (_LN10_INV_10 / mel_c), torch.zeros_like(g))
    streams, num_mels, n_frames = y.shape
    m_pad = _round_up(num_mels, _MEL_TILE)
    g = F.pad(g.transpose(1, 2), (0, m_pad - num_mels))
    return g.reshape(streams * n_frames, m_pad).contiguous()


def _dx_from_frames(dframes, streams: int, fft_length: int,
                    hop_length: int, n_samples: int):
    """``dframes (streams·n_frames, fft)`` overlap-added onto the waveform
    with ``stft._overlap_add``: ``dx (streams, n_samples)``, zero past the
    last full frame."""
    with span("fused_mel.overlap_add"):
        n_frames = dframes.shape[0] // streams
        full = (n_frames - 1) * hop_length + fft_length
        dx = _overlap_add(dframes.view(streams, n_frames, fft_length),
                          fft_length, hop_length, full)
        return F.pad(dx, (0, n_samples - full))


def _op_bwd_cuda(g, y, reim, filterbank, cfg, n_samples, need_dx, need_dfb,
                 _route=None):
    """The op's backward on the card (:class:`_FusedMel`'s contract): the
    dB gate (:func:`_dmel_from`), the backward kernel
    (:func:`_fused_mel_bwd_cuda`, ``_route`` as there) and the overlap-add.
    The frame pass does the overlap-add itself where the launch takes the
    FFT route and the hop allows it (:func:`_dx_fusable`); elsewhere it is
    done here, on the kernel's frame gradient."""
    fft_length, hop_length, window, win_length, to_db, db_ref, amin = cfg
    streams, _, n_frames = y.shape
    with span("fused_mel.dmel"):
        dmel = _dmel_from(g, y, to_db, db_ref, amin)
    fuse_dx = (need_dx and _route_for(fft_length, _route) == "fft"
               and _dx_fusable(fft_length, hop_length))
    with span("fused_mel.bwd_launch"):
        frames, dfb = _fused_mel_bwd_cuda(
            dmel, reim.reshape(streams * n_frames, -1), filterbank,
            fft_length, window, win_length, need_dx, need_dfb,
            _route=_route, hop_length=hop_length if fuse_dx else None,
            n_samples=n_samples)
    if fuse_dx or not need_dx:
        return frames, dfb
    return (_dx_from_frames(frames, streams, fft_length, hop_length,
                            n_samples), dfb)


def _op_bwd_steps(kernel_bwd, g, y, reim, filterbank, cfg, n_samples,
                  need_dx, need_dfb):
    """:class:`_FusedMel`'s contract around a plain version of the backward
    kernel (``kernel_bwd``, as :func:`_bwd_plain`): the dB gate, the
    kernel's frame gradient and the overlap-add, under the card's spans."""
    fft_length, hop_length, window, win_length, to_db, db_ref, amin = cfg
    streams, _, n_frames = y.shape
    with span("fused_mel.dmel"):
        dmel = _dmel_from(g, y, to_db, db_ref, amin)
    with span("fused_mel.bwd_launch"):
        dframes, dfb = kernel_bwd(
            dmel, reim.reshape(streams * n_frames, -1), filterbank,
            fft_length, window, win_length, need_dx, need_dfb)
    dx = (_dx_from_frames(dframes, streams, fft_length, hop_length,
                          n_samples) if need_dx else None)
    return dx, dfb


def _op_bwd_plain(*args):
    """The op's backward with the DFT-product kernel's plain version
    (:func:`_bwd_plain`); arguments and results as :class:`_FusedMel`'s
    contract."""
    return _op_bwd_steps(_bwd_plain, *args)


def _op_bwd_fft_plain(*args):
    """The op's backward with the FFT kernel's step-by-step plain version
    (:func:`_bwd_fft_plain`); arguments and results as
    :class:`_FusedMel`'s contract."""
    return _op_bwd_steps(_bwd_fft_plain, *args)


class _FusedMel(torch.autograd.Function):
    """The fused op with its gradient, the counterpart of the JAX
    package's ``_fused_core`` custom VJP.

    ``apply(x2 (streams, T), filterbank, cfg, fwd, bwd)`` with ``cfg =
    (fft_length, hop_length, window, win_length, to_db, db_ref, amin)``,
    the forward callable ``fwd`` (:func:`_fused_mel_fwd_cuda` on the card,
    a plain version in the CPU tests) and the backward ``bwd``, which does
    the whole backward under one contract::

        bwd(g, y, reim, filterbank, cfg, n_samples, need_dx, need_dfb)
            -> (dx (streams, n_samples) or None,
                dfb (n_freqs, num_mels) or None)

    ``g`` is the output's cotangent and ``y`` the saved output, both
    ``(streams, num_mels, n_frames)``, ``reim`` the forward's residual;
    ``dx`` is zero past the last full frame.  ``bwd`` is
    :func:`_op_bwd_cuda` on the card, :func:`_op_bwd_plain` or
    :func:`_op_bwd_fft_plain` in the CPU tests.  It is asked only for the
    gradients ``ctx.needs_input_grad`` wants: with no waveform gradient
    the frame passes and the overlap-add are skipped, with no filterbank
    gradient the dFB pass."""

    @staticmethod
    def forward(ctx, x2, filterbank, cfg, fwd, bwd):
        with span("fused_mel.fwd"):
            out, reim = fwd(x2, filterbank, *cfg, save_spec=True)
        ctx.save_for_backward(filterbank, out, reim)
        ctx.cfg, ctx.bwd, ctx.n_samples = cfg, bwd, x2.shape[-1]
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with span("fused_mel.bwd"):
            filterbank, out, reim = ctx.saved_tensors
            dx, dfb = ctx.bwd(g, out, reim, filterbank, ctx.cfg,
                              ctx.n_samples, *ctx.needs_input_grad[:2])
        return dx, dfb, None, None, None


def _fused_apply(waveform, filterbank, fft_length, hop_length, window,
                 win_length, to_db, db_ref, amin, fwd, bwd):
    """``waveform (..., T)`` → ``(..., num_mels, n_frames)`` through the
    kernel callables: ``fwd`` alone when no gradient is needed, else
    :class:`_FusedMel`."""
    lead, n_samples = waveform.shape[:-1], waveform.shape[-1]
    x2 = waveform.reshape(-1, n_samples).contiguous()
    cfg = (fft_length, hop_length, window, win_length, to_db, db_ref, amin)
    if torch.is_grad_enabled() and (x2.requires_grad
                                    or filterbank.requires_grad):
        out = _FusedMel.apply(x2, filterbank, cfg, fwd, bwd)
    else:
        with span("fused_mel.fwd"):
            out, _ = fwd(x2, filterbank, *cfg)
    return out.reshape(lead + out.shape[1:])


def fused_melspectrogram(waveform: torch.Tensor,
                         filterbank: torch.Tensor,
                         fft_length: int = 2048,
                         hop_length: int = 512,
                         window="hann",
                         power: float = 2.0,
                         to_db: bool = True,
                         db_ref: float = 1.0,
                         amin: float = 1e-7,
                         precision: str = "auto",
                         win_length=None,
                         center: bool = False,
                         pad_mode: str = "reflect") -> torch.Tensor:
    """Mel (or log-mel) spectrogram of ``waveform (..., T)`` as one fused
    kernel.

    ``filterbank`` is ``(fft_length//2+1, num_mels)`` (e.g. from
    :func:`~torchaudio_contrib_tpu_torch.ops.create_mel_filter`).  Returns
    ``(..., num_mels, n_frames)`` with ``n_frames = 1 + (T − fft)//hop``
    (trailing samples that fill no frame are dropped).

    ``precision`` is resolved and validated as in the JAX package
    (:func:`resolve_precision`), but every tier runs the same kernels
    (an f32 FFT per frame for ``fft_length`` a power of two from 256 to
    2048, else an FP32 product with the DFT basis; the mel products are
    FP32 FMAs on both routes): ``split3``, ``split6`` and ``auto`` get
    at least the accuracy they promise, and ``fast`` gets f32-grade output
    and gradients rather than bf16-grade.

    ``center=True`` reflect-pads (``pad_mode``) by ``fft_length//2`` on
    both sides before the kernel, for frame-for-frame parity with the
    ``Melspectrogram()`` pipeline.

    On a CPU tensor this runs the plain chain (:func:`_reference`), with
    autograd.  On a CUDA tensor it launches the kernels when ``power`` is 2
    and computes the plain chain on the card for any other ``power``, as the
    JAX package does on every backend; that rule is decided from the
    arguments, before any launch, and such a call counts no launch.  A
    failed build or launch raises.  Gradients flow to the waveform and to
    the filterbank through the backward kernel whenever either requires
    grad; under ``torch.inference_mode()`` or ``torch.no_grad()`` the
    forward runs without its residual.
    """
    # the plain chain on the CPU takes no span
    with (span("fused_mel") if waveform.is_cuda
          else contextlib.nullcontext()):
        precision = resolve_precision(precision, fft_length,
                                      filterbank.shape[-1])
        if not fused_mel_supported(fft_length, hop_length):
            raise ValueError(f"unsupported fft_length={fft_length} / "
                             f"hop_length={hop_length}")
        n_freqs = fft_length // 2 + 1
        if filterbank.ndim != 2 or filterbank.shape[0] != n_freqs:
            raise ValueError(f"filterbank must have {n_freqs} rows, got "
                             f"{tuple(filterbank.shape)}")
        if waveform.device != filterbank.device:
            raise ValueError(f"waveform on {waveform.device} but filterbank "
                             f"on {filterbank.device}")
        if center:
            waveform = _pad_center(waveform, fft_length // 2, pad_mode)
        n_samples = waveform.shape[-1]
        if n_samples < fft_length:
            raise ValueError(f"input too short: {n_samples} < "
                             f"fft_length={fft_length}")
        if waveform.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {waveform.device}")
        if waveform.device.type == "cpu" or power != 2.0:
            return _reference(waveform, filterbank, fft_length, hop_length,
                              window, power, to_db, db_ref, amin, win_length)
        return _fused_apply(waveform.to(torch.float32),
                            filterbank.to(torch.float32), fft_length,
                            hop_length, window, win_length, to_db, db_ref,
                            amin, _fused_mel_fwd_cuda, _op_bwd_cuda)
