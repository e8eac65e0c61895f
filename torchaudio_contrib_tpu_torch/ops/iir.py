"""IIR filtering: ``lfilter``, ``filtfilt`` and the biquad family.

Port of ``torchaudio_contrib_tpu/ops/iir.py``.  An order-K IIR is a linear
recurrence ``s[n] = A·s[n−1] + e₁·v[n]`` on a K-vector state (companion
form), where ``v`` is the feed-forward (FIR) half of the filter.  The JAX
package runs it as one ``associative_scan`` of per-sample K×K maps (memory
T·K²) up to K = 8 and as a per-sample ``lax.scan`` above.  Eager PyTorch
has neither, and here one path serves every order:

* ``A`` is the same at every step, so a Hillis-Steele doubling over time
  needs only the powers ``A^(2^j)``, ``j < ⌈log2 T⌉``.  They are built on
  the host in float64 (K×K each), one K×K product a step; each step then updates the K-vector of every sample, ``c[n] ← A^s·c[n−s] +
  c[n]`` (zero for ``n < s``): ``⌈log2 T⌉`` steps of elementwise
  multiply-adds, memory T·K.  There is no sequential branch above K = 8.
* The K×K-by-vector products are written as explicit multiply-adds, never
  ``matmul``: with poles near the unit circle the recurrence is conditioned
  like ``1/(1−|p|)``, and reduced-precision products (bf16 on the TPU, TF32
  on the card) collapsed such filters.
* K = 1 runs :func:`~.features._linear_recurrence`.
* The FIR half is a sum of shifted slices up to 16 taps, and ``conv1d``
  with TF32 off above that.
* Both halves run in float64 and the output is cast back to the input's
  dtype.  Splitting a filter into its FIR half and its recursive half
  amplifies the FIR half's rounding by the recursive half's gain: the
  BS.1770 high-pass (``b = [1, −2, 1]``, a double pole at 0.995 at 48 kHz)
  has a recursive DC gain of 4·10⁴, and on 10 s of noise the float32 chain
  was 0.12 (of a 2.6 peak) from ``scipy.signal.lfilter``, 5e-3 dB of
  energy (the JAX package's float32 scan: 0.095, 7e-3 dB).  In float64 the
  same doubling is within 1e-9; every step is a memory-bound elementwise
  pass, so the cost is its bytes.

All functions are differentiable (every step is linear with constant
coefficients, so autograd keeps no intermediate); time is the last axis,
with any leading dims.  Biquad designs follow the Audio-EQ-Cookbook (R.
Bristow-Johnson), the family torchaudio exposes (``lowpass_biquad`` …
``treble_biquad``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .features import _float, _linear_recurrence

__all__ = [
    "lfilter",
    "biquad",
    "lowpass_biquad",
    "highpass_biquad",
    "bandpass_biquad",
    "bandreject_biquad",
    "allpass_biquad",
    "equalizer_biquad",
    "bass_biquad",
    "treble_biquad",
    "band_biquad",
    "deemph_biquad",
    "riaa_biquad",
]


def _cast(values: np.ndarray, dtype: torch.dtype) -> list:
    """float64 host coefficients as Python floats rounded to ``dtype``."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return [float(v) for v in np.asarray(values).astype(np_dtype).ravel()]


def _fir_part(x: torch.Tensor, b: np.ndarray) -> torch.Tensor:
    """Causal FIR ``Σ_k b[k]·x[n-k]`` along the last axis.

    Short kernels (every biquad, m ≤ 16) are summed as shifted slices in
    the signal's precision; longer ones run as one ``conv1d`` with TF32
    off, so the card never rounds to TF32."""
    m = b.shape[0]
    bc = _cast(b, x.dtype)
    if m == 1:
        return x * bc[0]
    t = x.shape[-1]
    if m <= 16:
        xp = F.pad(x, (m - 1, 0))
        out = bc[0] * x
        for k in range(1, m):
            out = out + bc[k] * xp[..., m - 1 - k:m - 1 - k + t]
        return out
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, t), (m - 1, 0))
    w = torch.tensor(bc[::-1], dtype=x.dtype, device=x.device)
    with torch.backends.cudnn.flags(allow_tf32=False):
        out = F.conv1d(xp, w.view(1, 1, m))
    return out.reshape(lead + (t,))


def _companion(a_tail: np.ndarray) -> np.ndarray:
    k = a_tail.shape[0]
    A = np.zeros((k, k), np.float64)
    A[0, :] = -np.asarray(a_tail, np.float64)
    A[1:, :-1] = np.eye(k - 1)
    return A


def _sections(a_tail: np.ndarray) -> list:
    """The recursive half as a cascade of sections of order 1 or 2 (tails
    of their monic denominators), from the roots of ``1 + Σ a_k z^-k``:
    each complex-conjugate pair and each pair of real roots makes one
    section, an odd real root a first-order one.  Orders 1 and 2 stay one
    section, with the given coefficients."""
    if a_tail.shape[0] <= 2:
        return [a_tail]
    roots = np.roots(np.concatenate([[1.0], a_tail]))
    pairs = roots[roots.imag > 0]
    real = np.sort(roots[roots.imag == 0].real)
    out = [np.array([-2.0 * p.real, abs(p) ** 2]) for p in pairs]
    out += [np.array([-(p + q), p * q]) for p, q in zip(real[::2], real[1::2])]
    if real.shape[0] % 2:
        out.append(np.array([-real[-1]]))
    return out


def _section(v: torch.Tensor, a_tail: np.ndarray) -> torch.Tensor:
    """One section of order K ≤ 2: ``y[n] = v[n] − Σ a[k]·y[n−k]`` by
    doubling with the host-built powers of its companion matrix."""
    k = a_tail.shape[0]
    if k == 1:
        coef = _cast(-a_tail, v.dtype)[0]
        return _linear_recurrence(torch.full_like(v, coef), v)
    t = v.shape[-1]
    power = _companion(a_tail)
    # c[i] is component i of the K-vector of every sample; e1·v to start
    c = [v] + [torch.zeros_like(v) for _ in range(k - 1)]
    s = 1
    while s < t:
        p = _cast(power, v.dtype)
        nxt = []
        for i in range(k):
            out = c[i].clone()
            for j in range(k):
                if p[i * k + j] != 0.0:
                    out[..., s:].add_(c[j][..., :t - s], alpha=p[i * k + j])
            nxt.append(out)
        c = nxt
        power = power @ power
        s *= 2
    return c[0]


def _recursive_part(v: torch.Tensor, a_tail: np.ndarray) -> torch.Tensor:
    """Solve ``y[n] = v[n] − Σ_{k≥1} a[k]·y[n−k]`` (zero initial state).

    Companion form ``s[n] = A·s[n−1] + e₁·v[n]``, ``y[n] = s[n][0]``, by
    doubling over time with the host-built powers of ``A`` (module
    docstring): ``⌈log2 T⌉`` steps a section, one section up to order 2.
    Above order 2 the powers of a companion matrix are not safe even in
    float64: with clustered poles its entries grow past the range of
    float64 before they decay (a tenth-order Butterworth at 0.1 of
    Nyquist overflows), so higher orders run as a cascade of second-order
    sections (:func:`_sections`), the form in which ``scipy.signal`` also
    runs high orders."""
    if a_tail.shape[0] == 0:
        return v
    for sec in _sections(a_tail):
        v = _section(v, sec)
    return v


def _doubling_steps(t: int) -> int:
    """Steps of the doubling scan over ``t`` samples: ``⌈log2 t⌉``."""
    return max(int(t) - 1, 0).bit_length()


def lfilter(waveform: torch.Tensor, a_coeffs, b_coeffs,
            *, clamp: bool = False) -> torch.Tensor:
    """Direct-form IIR filter along the last axis, zero initial state.

    ``a_coeffs``/``b_coeffs`` are denominator/numerator coefficients
    (``a[0]`` need not be 1 — both are normalized by it).  The argument
    ORDER follows torchaudio (`waveform, a, b`); the math matches
    ``scipy.signal.lfilter(b, a, x)``.  ``clamp=True`` clips the output
    to [-1, 1] (torchaudio compat).

    The FIR half as shifted slices (or one convolution); the recursive
    half as a doubling scan of ``⌈log2 T⌉`` steps, both in float64 and
    the output in the input's dtype (module docstring).
    """
    waveform = _float(waveform)
    a = np.atleast_1d(np.asarray(a_coeffs, np.float64))
    b = np.atleast_1d(np.asarray(b_coeffs, np.float64))
    if a.ndim != 1 or b.ndim != 1:
        raise ValueError("a_coeffs/b_coeffs must be 1-D")
    if a[0] == 0:
        raise ValueError("a_coeffs[0] must be nonzero")
    b = b / a[0]
    a = a / a[0]
    v = _fir_part(waveform.to(torch.float64), b)
    y = _recursive_part(v, a[1:]).to(waveform.dtype)
    if clamp:
        y = torch.clamp(y, -1.0, 1.0)
    return y


def biquad(waveform: torch.Tensor, b0: float, b1: float, b2: float,
           a0: float, a1: float, a2: float) -> torch.Tensor:
    """Second-order IIR section (order-2 :func:`lfilter`)."""
    return lfilter(waveform, (a0, a1, a2), (b0, b1, b2))


def _rbj(design: str, sample_rate: float, freq: float, Q: float,
         gain_db: float = 0.0):
    """Audio-EQ-Cookbook biquad coefficients (float64)."""
    w0 = 2.0 * math.pi * freq / sample_rate
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * Q)
    A = 10.0 ** (gain_db / 40.0)
    if design == "lowpass":
        b = ((1 - cw) / 2, 1 - cw, (1 - cw) / 2)
        a = (1 + alpha, -2 * cw, 1 - alpha)
    elif design == "highpass":
        b = ((1 + cw) / 2, -(1 + cw), (1 + cw) / 2)
        a = (1 + alpha, -2 * cw, 1 - alpha)
    elif design == "bandpass":             # constant 0 dB peak gain
        b = (alpha, 0.0, -alpha)
        a = (1 + alpha, -2 * cw, 1 - alpha)
    elif design == "bandreject":
        b = (1.0, -2 * cw, 1.0)
        a = (1 + alpha, -2 * cw, 1 - alpha)
    elif design == "allpass":
        b = (1 - alpha, -2 * cw, 1 + alpha)
        a = (1 + alpha, -2 * cw, 1 - alpha)
    elif design == "peaking":
        b = (1 + alpha * A, -2 * cw, 1 - alpha * A)
        a = (1 + alpha / A, -2 * cw, 1 - alpha / A)
    elif design == "lowshelf":
        sq = 2.0 * math.sqrt(A) * alpha
        b = (A * ((A + 1) - (A - 1) * cw + sq),
             2 * A * ((A - 1) - (A + 1) * cw),
             A * ((A + 1) - (A - 1) * cw - sq))
        a = ((A + 1) + (A - 1) * cw + sq,
             -2 * ((A - 1) + (A + 1) * cw),
             (A + 1) + (A - 1) * cw - sq)
    elif design == "highshelf":
        sq = 2.0 * math.sqrt(A) * alpha
        b = (A * ((A + 1) + (A - 1) * cw + sq),
             -2 * A * ((A - 1) + (A + 1) * cw),
             A * ((A + 1) + (A - 1) * cw - sq))
        a = ((A + 1) - (A - 1) * cw + sq,
             2 * ((A - 1) - (A + 1) * cw),
             (A + 1) - (A - 1) * cw - sq)
    else:  # pragma: no cover
        raise ValueError(design)
    return b, a


def lowpass_biquad(waveform, sample_rate: float, cutoff_freq: float,
                   Q: float = 0.707) -> torch.Tensor:
    """RBJ low-pass (−12 dB/octave above ``cutoff_freq``)."""
    b, a = _rbj("lowpass", sample_rate, cutoff_freq, Q)
    return lfilter(waveform, a, b)


def highpass_biquad(waveform, sample_rate: float, cutoff_freq: float,
                    Q: float = 0.707) -> torch.Tensor:
    """RBJ high-pass (−12 dB/octave below ``cutoff_freq``)."""
    b, a = _rbj("highpass", sample_rate, cutoff_freq, Q)
    return lfilter(waveform, a, b)


def bandpass_biquad(waveform, sample_rate: float, central_freq: float,
                    Q: float = 0.707) -> torch.Tensor:
    """RBJ band-pass, constant 0 dB peak gain."""
    b, a = _rbj("bandpass", sample_rate, central_freq, Q)
    return lfilter(waveform, a, b)


def bandreject_biquad(waveform, sample_rate: float, central_freq: float,
                      Q: float = 0.707) -> torch.Tensor:
    """RBJ notch filter."""
    b, a = _rbj("bandreject", sample_rate, central_freq, Q)
    return lfilter(waveform, a, b)


def allpass_biquad(waveform, sample_rate: float, central_freq: float,
                   Q: float = 0.707) -> torch.Tensor:
    """RBJ all-pass (unit magnitude, phase rotation at ``central_freq``)."""
    b, a = _rbj("allpass", sample_rate, central_freq, Q)
    return lfilter(waveform, a, b)


def equalizer_biquad(waveform, sample_rate: float, center_freq: float,
                     gain_db: float, Q: float = 0.707) -> torch.Tensor:
    """RBJ peaking equalizer: ±``gain_db`` around ``center_freq``."""
    b, a = _rbj("peaking", sample_rate, center_freq, Q, gain_db)
    return lfilter(waveform, a, b)


def bass_biquad(waveform, sample_rate: float, gain_db: float,
                central_freq: float = 100.0,
                Q: float = 0.707) -> torch.Tensor:
    """RBJ low-shelf (bass control)."""
    b, a = _rbj("lowshelf", sample_rate, central_freq, Q, gain_db)
    return lfilter(waveform, a, b)


def treble_biquad(waveform, sample_rate: float, gain_db: float,
                  central_freq: float = 3000.0,
                  Q: float = 0.707) -> torch.Tensor:
    """RBJ high-shelf (treble control)."""
    b, a = _rbj("highshelf", sample_rate, central_freq, Q, gain_db)
    return lfilter(waveform, a, b)


def band_biquad(waveform, sample_rate: float, central_freq: float,
                Q: float = 0.707, noise: bool = False) -> torch.Tensor:
    """SoX ``band`` single-pole-pair band-pass: a resonator with
    exponentially placed poles; ``noise=True`` uses the alternate (wider,
    pitched-noise) gain normalization."""
    w0 = 2.0 * math.pi * central_freq / sample_rate
    bw_hz = central_freq / Q
    a2 = math.exp(-2.0 * math.pi * bw_hz / sample_rate)
    a1 = -4.0 * a2 / (1.0 + a2) * math.cos(w0)
    b0 = math.sqrt(1.0 - a1 * a1 / (4.0 * a2)) * (1.0 - a2)
    if noise:
        b0 = math.sqrt(((1.0 + a2) ** 2 - a1 * a1)
                       * (1.0 - a2) / (1.0 + a2))
    return lfilter(waveform, (1.0, a1, a2), (b0, 0.0, 0.0))


# ISO 908 CD / DAT de-emphasis: a high-shelf whose (freq, slope, gain)
# are tabulated per rate (SoX ``deemph``)
_DEEMPH = {44100: (5283.0, 0.4845, -9.477),
           48000: (5356.0, 0.479, -9.62)}


def deemph_biquad(waveform, sample_rate: float) -> torch.Tensor:
    """CD/DAT de-emphasis shelving EQ (SoX ``deemph``).  Supported
    sample rates: 44100, 48000."""
    cfg = _DEEMPH.get(int(sample_rate))
    if cfg is None:
        raise ValueError(
            f"deemph_biquad supports {sorted(_DEEMPH)} Hz, got "
            f"{sample_rate}")
    freq, slope, gain_db = cfg
    # shelf-slope parametrization: alpha = sw/2*sqrt((A+1/A)(1/S-1)+2)
    # == sw/(2Q) with Q = 1/sqrt((A+1/A)(1/S-1)+2)
    A = 10.0 ** (gain_db / 40.0)
    Q = 1.0 / math.sqrt((A + 1.0 / A) * (1.0 / slope - 1.0) + 2.0)
    b, a = _rbj("highshelf", sample_rate, freq, Q, gain_db)
    return lfilter(waveform, a, b)


# SoX riaa zero/pole tables per supported sample rate
_RIAA_ZP = {
    44100: ((-0.2014898, 0.9233820), (0.7083149, 0.9924091)),
    48000: ((-0.1766069, 0.9321590), (0.7396325, 0.9931330)),
    88200: ((-0.1168735, 0.9648312), (0.8590646, 0.9964002)),
    96000: ((-0.1141486, 0.9676817), (0.8699137, 0.9966946)),
}


def riaa_biquad(waveform, sample_rate: float) -> torch.Tensor:
    """RIAA phono playback EQ (SoX ``riaa``): bass boost / treble cut
    from tabulated zero/pole pairs, gain-normalized to 0 dB at 1 kHz.
    Supported sample rates: 44100/48000/88200/96000."""
    zp = _RIAA_ZP.get(int(sample_rate))
    if zp is None:
        raise ValueError(
            f"riaa_biquad supports {sorted(_RIAA_ZP)} Hz, got "
            f"{sample_rate}")
    (z0, z1), (p0, p1) = zp
    b = np.array([1.0, -(z0 + z1), z0 * z1], np.float64)
    a = np.array([1.0, -(p0 + p1), p0 * p1], np.float64)
    # normalize to unit gain at 1 kHz
    w = 2.0 * math.pi * 1000.0 / sample_rate
    e = np.exp(-1j * w * np.arange(3))
    g = abs(np.dot(a, e) / np.dot(b, e))
    return lfilter(waveform, tuple(a), tuple(b * g))


def filtfilt(waveform: torch.Tensor, a_coeffs, b_coeffs,
             *, clamp: bool = False) -> torch.Tensor:
    """Zero-phase forward-backward IIR filtering.

    Zero initial state in both passes and no edge extension — the
    literal ``lfilter → flip → lfilter → flip`` composition (this is
    torchaudio's semantics; ``scipy.signal.filtfilt`` additionally
    seeds each pass with ``lfilter_zi``-matched initial conditions, so
    the two differ within a filter-settling length of the edges).
    Both passes are the same doubling scan.
    """
    y = lfilter(waveform, a_coeffs, b_coeffs)
    y = lfilter(y.flip(-1), a_coeffs, b_coeffs).flip(-1)
    if clamp:
        y = torch.clamp(y, -1.0, 1.0)
    return y
