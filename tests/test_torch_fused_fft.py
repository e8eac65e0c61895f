"""The FFT route of the port's fused mel kernels, on the CPU.

The CUDA kernels of ``csrc/fft_smem.cuh`` cannot run without a card, so
``torchaudio_contrib_tpu_torch.ops.fused`` keeps plain PyTorch versions
that repeat their arithmetic step by step: the same twiddle table, the
same packing of a real frame as one complex frame of half its length, the
same Stockham passes, the same Hermitian weights for the transposed
transform, the residual in the same tile layout.  Here they are held

* against ``torch.fft`` and float64 DFT matrices (float64 shows index and
  sign errors that float32 rounding would hide);
* against the plain versions of the DFT-product kernels
  (``_fwd_res_plain``, ``_bwd_plain``), whose float32 basis bounds the
  agreement in float64 at ~1e-7;
* against the JAX package: ``_FusedMel`` driven with the step-by-step
  versions (``_op_bwd_fft_plain``) against ``jax`` values and gradients of the JAX op, at the bars
  of ``tests/test_torch_fused.py`` and ``tests/test_torch_fused_bwd.py``;
* and the routing rule: which ``fft_length`` takes which kernels.

The kernels themselves are held against these versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu import ops as jops
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import fused as tfused
from torchaudio_contrib_tpu_torch.ops.stft import (_dft_matrices,
                                                   _pad_center,
                                                   _resolve_window)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

F32_TOL = 2e-6     # of peak: two float32 chains of the same transform
F64_TOL = 1e-12    # of peak, in float64 against a float64 reference
GRAD_TOL = 1e-4    # gradients against the JAX package (the BASELINE bar)
SIZES = (256, 512, 1024, 2048)
POINTS = (128, 256, 512, 1024)     # complex points of those frames

# fft, hop, samples, mels, window, win_length: every size of the FFT route,
# odd and even frame counts, hop > fft/2, a shorter window, a Hamming window
CASES = [
    (256, 64, 2 * 256 + 64 * 11, 24, "hann", None),        # 20 frames
    (256, 200, 256 + 200 * 6 + 7, 40, "hamming", None),    # 7 frames
    (512, 128, 512 + 128 * 14, 64, "hann", 300),           # 15 frames
    (512, 300, 512 + 300 * 3 + 1, 32, "hamming", 400),     # 4 frames
    (1024, 256, 1024 + 256 * 8, 80, "hann", None),         # 9 frames
    (1024, 700, 1024 + 700 * 5, 16, "hann", 1000),         # 6 frames
    (2048, 512, 2048 + 512 * 4, 128, "hann", None),        # 5 frames
    (2048, 1100, 2048 + 1100 * 3, 130, "hamming", None),   # 4 frames
]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _inputs(rng, fft, hop, samples, mels, dtype, streams=3):
    x = torch.from_numpy(rng.standard_normal((streams, samples))).to(dtype)
    fb = tops.create_mel_filter(mels, 16000, 0.0, None,
                                fft // 2 + 1).to(dtype)
    n_frames = 1 + (samples - fft) // hop
    m_pad = -(-mels // 64) * 64
    dmel = torch.from_numpy(rng.standard_normal(
        (streams * n_frames, m_pad))).to(dtype)
    dmel[:, mels:] = 0.0
    return x, fb, dmel


def _unpack(reim, n_freqs):
    """The tile layout ``[re_t | im_t]`` → complex ``(..., n_freqs)``."""
    r = reim.reshape(reim.shape[:-1] + (-1, 2, 64))
    re = r[..., 0, :].reshape(reim.shape[:-1] + (-1,))
    im = r[..., 1, :].reshape(reim.shape[:-1] + (-1,))
    return torch.complex(re, im)[..., :n_freqs]


def _basis64(fft, window, wl):
    """The windowed onesided DFT ``(fft, n_freqs)`` complex, float64."""
    w = _resolve_window(window, fft if wl is None else wl, fft)[:, None]
    cos_m, msin_m = _dft_matrices(fft, True)
    return torch.from_numpy(w * cos_m + 1j * (w * msin_m))


# ---- the transform itself ----------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", POINTS)
def test_stockham_matches_torch_fft(rng, n, inverse):
    z = torch.from_numpy(rng.standard_normal((5, n))
                         + 1j * rng.standard_normal((5, n)))
    tw = torch.view_as_complex(torch.from_numpy(tfused._twiddle_np(2 * n)))
    want = torch.fft.ifft(z) * n if inverse else torch.fft.fft(z)
    assert _rel(tfused._stockham_fft(z, tw, inverse), want) <= F64_TOL
    got = tfused._stockham_fft(z.to(torch.complex64),
                               tw.to(torch.complex64), inverse)
    assert got.dtype == torch.complex64 and _rel(got, want) <= F32_TOL


def test_fft_plan_and_twiddles():
    """Radix-8 passes, then one radix-2 or radix-4 pass.  The table of a
    frame of ``N = 2M`` samples holds ``exp(−2πik/N)`` for ``k < M``, then
    each later pass's ``w^(r·k)`` at ``(r − 1)·NS + k``, then zeros."""
    assert tfused._fft_plan(128) == [(8, 1), (8, 8), (2, 64)]
    assert tfused._fft_plan(256) == [(8, 1), (8, 8), (4, 64)]
    assert tfused._fft_plan(512) == [(8, 1), (8, 8), (8, 64)]
    assert tfused._fft_plan(1024) == [(8, 1), (8, 8), (8, 64), (2, 512)]
    for n, used in ((256, 248), (512, 504), (1024, 1016), (2048, 2040)):
        tw = tfused._twiddle_np(n)
        assert tw.shape == (n, 2) and tw.dtype == np.float64
        tw = tw[:, 0] + 1j * tw[:, 1]
        m = n // 2
        np.testing.assert_allclose(tw[:m], np.exp(-2j * np.pi
                                                  * np.arange(m) / n),
                                   atol=1e-15)
        assert not tw[used:].any() and np.all(np.abs(tw[:used]) > 0.99)
        offset = m
        for radix, ns in tfused._fft_plan(m)[1:]:
            r, k = np.arange(1, radix)[:, None], np.arange(ns)[None, :]
            want = np.exp(-2j * np.pi * r * k / (ns * radix)).ravel()
            np.testing.assert_allclose(tw[offset:offset + want.size], want,
                                       atol=1e-15)
            offset += want.size
        assert offset == used


# ---- the step-by-step forward -------------------------------------------------

@pytest.mark.parametrize("fft,hop,samples,mels,window,wl", CASES)
def test_forward_float64(rng, fft, hop, samples, mels, window, wl):
    """Against ``torch.fft.rfft`` of the windowed frames in float64, and
    against ``_fwd_res_plain`` (whose basis is rounded to float32)."""
    x, fb, _ = _inputs(rng, fft, hop, samples, mels, torch.float64)
    args = (fft, hop, window, wl, False, 1.0, 1e-7)
    out, reim = tfused._fwd_fft_plain(x, fb, *args, save_spec=True)
    n_freqs = fft // 2 + 1
    w = torch.from_numpy(_resolve_window(window, wl or fft, fft))
    spec = torch.fft.rfft(x.unfold(-1, fft, hop) * w)
    assert reim.shape == (3, spec.shape[1], (fft // 128 + 1) * 128)
    assert _rel(_unpack(reim, n_freqs), spec) <= F64_TOL
    want = (spec.abs() ** 2 @ fb).transpose(1, 2)
    assert out.shape == want.shape and _rel(out, want) <= F64_TOL
    out_p, reim_p = tfused._fwd_res_plain(x, fb, *args, save_spec=True)
    assert _rel(out, out_p) <= F32_TOL and _rel(reim, reim_p) <= F32_TOL


@pytest.mark.parametrize("to_db", [True, False], ids=["db", "linear"])
@pytest.mark.parametrize("fft,hop,samples,mels,window,wl", CASES)
def test_forward_float32(rng, fft, hop, samples, mels, window, wl, to_db):
    x, fb, _ = _inputs(rng, fft, hop, samples, mels, torch.float32)
    args = (fft, hop, window, wl, to_db, 0.5, 1e-6)
    out, reim = tfused._fwd_fft_plain(x, fb, *args, save_spec=True)
    out_p, reim_p = tfused._fwd_res_plain(x, fb, *args, save_spec=True)
    assert out.dtype == torch.float32 and out.shape == out_p.shape
    assert reim.shape == reim_p.shape
    assert _rel(reim, reim_p) <= F32_TOL
    # narrow mel bands hold single bins, whose float32 error is relative
    # to the spectrum's peak, not to the bin
    assert _rel(out, out_p) <= (1e-5 if to_db else F32_TOL)
    spec = torch.fft.rfft(x.unfold(-1, fft, hop) * torch.from_numpy(
        _resolve_window(window, wl or fft, fft)).float())
    assert _rel(_unpack(reim, fft // 2 + 1), spec) <= F32_TOL
    serve, none = tfused._fwd_fft_plain(x, fb, *args)
    assert none is None and torch.equal(serve, out)


def test_quiet_frame_beside_a_loud_one_keeps_its_accuracy(rng):
    """Each frame is transformed alone, so a burst 60 dB above its
    neighbours does not leak its rounding into them: the float32
    step-by-step output stays within 1e-4 dB of float64 on every frame
    (two frames packed into one complex transform are 3e-4 dB off here)."""
    fft, hop = 2048, 512
    t = fft + 40 * hop
    env = np.full(t, 1e-3)
    for start in range(0, t, 8 * hop):
        env[start:start + hop] = 1.0
    x = torch.from_numpy(rng.standard_normal((2, t)) * env)
    fb = tops.create_mel_filter(128, 22050, 0.0, None, fft // 2 + 1).double()
    args = (fft, hop, "hann", None, True, 1.0, 1e-10)
    want, _ = tfused._fwd_fft_plain(x, fb, *args)
    got, _ = tfused._fwd_fft_plain(x.float(), fb.float(), *args)
    assert want.max() - want.min() > 60.0
    assert (got.double() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n", SIZES)
def test_residual_layout_is_the_same_on_both_routes(rng, n):
    """Same shape, and exact zeros in the padded bins ``n_freqs..FT·64``,
    which the backward's pass A and dFB pass read."""
    x, fb, _ = _inputs(rng, n, n // 4, 3 * n, 20, torch.float32, streams=2)
    args = (n, n // 4, "hann", None, True, 1.0, 1e-7)
    _, a = tfused._fwd_fft_plain(x, fb, *args, save_spec=True)
    _, b = tfused._fwd_res_plain(x, fb, *args, save_spec=True)
    assert a.shape == b.shape == (2, 9, (n // 128 + 1) * 128)
    tiles = a.view(2, 9, -1, 2, 64)
    pad = (n // 2 + 1) % 64
    assert not tiles[:, :, -1, :, pad:].any()
    assert tiles[:, :, -1, 0, :pad].abs().min() > 0     # re of Nyquist


# ---- the step-by-step transpose ----------------------------------------------

@pytest.mark.parametrize("fft,hop,samples,mels,window,wl", CASES)
def test_transpose_float64(rng, fft, hop, samples, mels, window, wl):
    """``dframes_n = w_n · Re Σ_k G_k e^{+2πikn/N}``: against the float64
    basis, against ``_bwd_plain``, and as the adjoint of the forward
    transform (``⟨A x, g⟩ = ⟨x, Aᵀ g⟩``)."""
    n_freqs, ft = fft // 2 + 1, fft // 128 + 1
    rows = 7
    g = torch.from_numpy(rng.standard_normal((rows, n_freqs))
                         + 1j * rng.standard_normal((rows, n_freqs)))
    dreim = tfused._to_tiles(g.real, g.imag, ft)
    assert dreim.shape == (rows, ft * 128)
    got = tfused._dframes_fft_plain(dreim, fft, window, wl)
    basis = _basis64(fft, window, wl)
    want = g.real @ basis.real.T + g.imag @ basis.imag.T
    assert got.shape == (rows, fft) and _rel(got, want) <= F64_TOL
    # not irfft(G): DC and Nyquist weigh as the others
    frames = torch.from_numpy(rng.standard_normal((rows, fft)))
    spec = frames.to(torch.complex128) @ basis
    lhs = (spec.real * g.real + spec.imag * g.imag).sum().item()
    rhs = (frames * got).sum().item()
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)

    x, fb, dmel = _inputs(rng, fft, hop, samples, mels, torch.float64)
    _, reim = tfused._fwd_res_plain(x, fb, fft, hop, window, wl, True, 1.0,
                                    1e-7, save_spec=True)
    reim = reim.reshape(dmel.shape[0], -1)
    bargs = (fb, fft, window, wl, True, True)
    df, dfb = tfused._bwd_fft_plain(dmel, reim, *bargs)
    df_p, dfb_p = tfused._bwd_plain(dmel, reim, *bargs)
    assert df.shape == df_p.shape and _rel(df, df_p) <= F32_TOL
    assert torch.equal(dfb, dfb_p)


@pytest.mark.parametrize("fft,hop,samples,mels,window,wl", CASES)
def test_transpose_float32(rng, fft, hop, samples, mels, window, wl):
    x, fb, dmel = _inputs(rng, fft, hop, samples, mels, torch.float32)
    _, reim = tfused._fwd_res_plain(x, fb, fft, hop, window, wl, True, 1.0,
                                    1e-7, save_spec=True)
    reim = reim.reshape(dmel.shape[0], -1)
    bargs = (fb, fft, window, wl)
    df, dfb = tfused._bwd_fft_plain(dmel, reim, *bargs, True, True)
    df_p, dfb_p = tfused._bwd_plain(dmel, reim, *bargs, True, True)
    assert df.dtype == torch.float32 and _rel(df, df_p) <= F32_TOL
    assert torch.equal(dfb, dfb_p)
    assert tfused._bwd_fft_plain(dmel, reim, *bargs, False, True)[0] is None
    assert tfused._bwd_fft_plain(dmel, reim, *bargs, True, False)[1] is None


# ---- _FusedMel through the step-by-step versions vs the JAX package -----------

def _fft_path(x, fb, fft, hop, center=False, pad_mode="reflect",
              precision="auto", window="hann", win_length=None, to_db=True,
              db_ref=1.0, amin=1e-7):
    """The public op's CUDA path with the FFT kernels' plain versions."""
    if center:
        x = _pad_center(x, fft // 2, pad_mode)
    return tfused._fused_apply(x, fb, fft, hop, window, win_length, to_db,
                               db_ref, amin, tfused._fwd_fft_plain,
                               tfused._op_bwd_fft_plain)


JAX_CASES = [
    ((2, 16384), 512, 128, 64, 16000, {}),
    ((2, 1, 16384), 512, 128, 64, 16000, {"center": True}),
    ((3, 2, 8192), 256, 128, 32, 16000, {"to_db": False}),
    ((2, 8192), 512, 128, 32, 16000, {"win_length": 300}),
    ((1, 3, 9000), 256, 100, 40, 22050, {"db_ref": 0.5, "amin": 1e-5}),
    ((2, 8000), 512, 200, 64, 16000, {"center": True,
                                      "pad_mode": "constant"}),
    ((2, 9000), 1024, 256, 80, 22050, {"window": "hamming"}),
    ((1, 12000), 2048, 512, 128, 22050, {}),
]


@pytest.mark.parametrize("shape,fft,hop,mels,sr,kw", JAX_CASES)
def test_fused_autograd_on_the_fft_route_matches_jax(rng, shape, fft, hop,
                                                     mels, sr, kw):
    """Output within 1e-4 dB (``atol`` 1e-4, ``rtol`` 1e-5) and gradients
    within 1e-4 of peak of the JAX op's on the CPU."""
    x = rng.standard_normal(shape).astype(np.float32)
    fb = tops.create_mel_filter(mels, sr, 0.0, None, fft // 2 + 1).numpy()
    t = shape[-1] + (2 * (fft // 2) if kw.get("center") else 0)
    g = rng.standard_normal(
        shape[:-1] + (mels, 1 + (t - fft) // hop)).astype(np.float32)

    def loss(xv, fbv, gv):
        return jnp.sum(jops.fused_melspectrogram(xv, fbv, fft, hop, **kw)
                       * gv)

    want = np.asarray(jops.fused_melspectrogram(
        jnp.asarray(x), jnp.asarray(fb), fft, hop, **kw))
    want_dx, want_dfb = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(fb), jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    fbt = torch.from_numpy(fb).requires_grad_()
    out = _fft_path(xt, fbt, fft, hop, **kw)
    (out * torch.from_numpy(g)).sum().backward()
    assert tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-4,
                               rtol=1e-5)
    assert _rel(xt.grad, want_dx) <= GRAD_TOL
    assert _rel(fbt.grad, want_dfb) <= GRAD_TOL
    with torch.no_grad():
        serve = _fft_path(torch.from_numpy(x), torch.from_numpy(fb), fft,
                          hop, **kw)
    assert torch.equal(serve, out.detach())


def test_gradcheck_float64_on_the_fft_route():
    """``_FusedMel`` with the step-by-step versions is the exact gradient
    of its own forward: finite differences in float64 at the smallest
    size of the route."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 300), generator=gen, dtype=torch.float64)
    fb = torch.rand((129, 3), generator=gen, dtype=torch.float64) + 0.1

    def fn(xv, fbv):
        return tfused._fused_apply(xv, fbv, 256, 40, "hann", None, True, 1.0,
                                   1e-7, tfused._fwd_fft_plain,
                                   tfused._op_bwd_fft_plain)

    assert torch.autograd.gradcheck(
        fn, (x.requires_grad_(), fb.requires_grad_()), eps=1e-6, atol=1e-6)


def test_silence_gives_exactly_zero_on_the_fft_route(rng):
    x = torch.zeros((2, 4096), requires_grad=True)
    fb = tops.create_mel_filter(32, 16000, 0.0, None, 257).requires_grad_()
    g = torch.from_numpy(rng.standard_normal(
        (2, 32, 1 + (4096 - 512) // 128)).astype(np.float32))
    (_fft_path(x, fb, 512, 128) * g).sum().backward()
    assert not x.grad.any() and not fb.grad.any()


# ---- the routing rule ------------------------------------------------------------

@pytest.mark.parametrize("fft,takes_fft", [
    (256, True), (512, True), (1024, True), (2048, True),
    (400, False), (128, False), (4096, False), (1000, False), (2, False),
    (255, False), (768, False)])
def test_routing_rule(fft, takes_fft):
    assert tfused._fft_kernel_supported(fft) is takes_fft
    assert tfused._route_for(fft, None) == ("fft" if takes_fft else "dft")
    assert tfused._route_for(fft, "dft") == "dft"
    if takes_fft:
        assert tfused._route_for(fft, "fft") == "fft"
    else:
        with pytest.raises(ValueError, match="power of two"):
            tfused._route_for(fft, "fft")
    with pytest.raises(ValueError, match="unknown route"):
        tfused._route_for(fft, "cufft")


@pytest.mark.parametrize("fft,hop,fusable", [
    (2048, 512, True), (2048, 2048, True), (2048, 2049, False),
    (2048, 121, True), (2048, 120, False), (256, 16, True), (256, 15, False),
    (1024, 300, True), (400, 160, False), (128, 32, False),
    (4096, 1024, False)])
def test_dx_rule(fft, hop, fusable):
    """The frame pass overlap-adds itself on the FFT route at a hop from
    fft / 17 to fft; the DFT route and every other hop keep
    ``_overlap_add``."""
    assert tfused._dx_fusable(fft, hop) is fusable


# each plain backward of the op, with the forward of the same route
PLAIN_PATHS = {"dft": (tfused._fwd_res_plain, tfused._op_bwd_plain),
               "fft": (tfused._fwd_fft_plain, tfused._op_bwd_fft_plain)}


@pytest.mark.parametrize("fft,hop,fused", [
    (512, 128, True), (2048, 512, True), (256, 100, True),
    (400, 160, False), (512, 600, False), (2048, 100, False)])
def test_backward_hands_the_overlap_add_to_the_frame_pass(rng, fft, hop,
                                                          fused):
    """Every plain backward of the op that the size takes, driven by
    ``_FusedMel`` under its one contract, gives the chain's gradients for
    a waveform with samples past the last full frame, whether or not the
    card's frame pass would overlap-add there (:func:`_dx_fusable`); those
    samples get exactly zero."""
    assert tfused._dx_fusable(fft, hop) is fused
    mels, n = 32, 3 * fft + 5 * hop + hop // 3
    full = n - (n - fft) % hop
    x = rng.standard_normal((2, n)).astype(np.float32)
    fb = tops.create_mel_filter(mels, 16000, 0.0, None, fft // 2 + 1)
    g = torch.from_numpy(rng.standard_normal(
        (2, mels, 1 + (n - fft) // hop)).astype(np.float32))

    def grads(fn):
        xt = torch.from_numpy(x).requires_grad_()
        fbt = fb.clone().requires_grad_()
        (fn(xt, fbt) * g).sum().backward()
        return xt.grad, fbt.grad

    want = grads(lambda xt, fbt: tfused._reference(
        xt, fbt, fft, hop, "hann", 2.0, True, 1.0, 1e-7))
    routes = ("dft", "fft") if tfused._fft_kernel_supported(fft) else ("dft",)
    for route in routes:
        got = grads(lambda xt, fbt: tfused._fused_apply(
            xt, fbt, fft, hop, "hann", None, True, 1.0, 1e-7,
            *PLAIN_PATHS[route]))
        assert not got[0][:, full:].any(), route
        for a, b in zip(got, want):
            assert _rel(a, b) <= GRAD_TOL, route


def test_dx_counter_is_a_launch_counter():
    """``BWD_DX_FUSED_LAUNCHES`` is one of the counters a graph replay
    moves."""
    from torchaudio_contrib_tpu_torch.ops import _launches
    assert "fused.BWD_DX_FUSED_LAUNCHES" in _launches.counts()


def test_wrappers_refuse_cpu_tensors_on_both_routes():
    """On anything but a CUDA tensor the launch wrappers raise; neither
    route computes the result another way, and no counter moves."""
    fb = tops.create_mel_filter(32, 16000, 0.0, None, 257)
    before = (tfused.KERNEL_LAUNCHES, tfused.FFT_KERNEL_LAUNCHES,
              tfused.BWD_KERNEL_LAUNCHES, tfused.BWD_FFT_LAUNCHES)
    for route in (None, "fft", "dft"):
        with pytest.raises(ValueError, match="CUDA"):
            tfused._fused_mel_fwd_cuda(torch.zeros(2, 4096), fb, 512, 128,
                                       "hann", None, True, 1.0, 1e-7,
                                       _route=route)
        with pytest.raises(ValueError, match="CUDA"):
            tfused._fused_mel_bwd_cuda(torch.zeros(10, 64),
                                       torch.zeros(10, 640), fb, 512, "hann",
                                       None, True, True, _route=route)
    assert before == (tfused.KERNEL_LAUNCHES, tfused.FFT_KERNEL_LAUNCHES,
                      tfused.BWD_KERNEL_LAUNCHES, tfused.BWD_FFT_LAUNCHES)


def test_cpu_path_reaches_no_kernel_constants(rng, monkeypatch):
    """A CPU tensor takes the plain chain: no kernel library, no twiddle
    table, whatever the ``fft_length``."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")
    monkeypatch.setattr(tfused._cuda, "load", no_build)
    monkeypatch.setattr(tfused, "_fft_consts_on", no_build)
    x = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))
    for fft in (512, 400):
        fb = tops.create_mel_filter(32, 16000, 0.0, None, fft // 2 + 1)
        out = tops.fused_melspectrogram(x, fb, fft, 128)
        assert out.shape == (2, 32, 1 + (4096 - fft) // 128)


# ---- the filterbank's bands: the tables, the banded products, the choice -----

def _fb(kind):
    """``(filterbank (n_freqs, mels) float64, fft_length)`` of a kind: the
    mel filterbanks of configs 2 and 3, of 40 and 80 mels at 16 kHz, htk
    and slaney, with ``f_min > 0`` and ``f_max`` below Nyquist; a linear
    one; a zero column, an all-zero filterbank, a dense learned one, one
    stray nonzero far from its band."""
    mel = tops.create_mel_filter
    if kind == "config2":
        return mel(128, 22050, 0.0, None, 1025).double(), 2048
    if kind == "config3":
        return mel(64, 16000, 0.0, None, 257).double(), 512
    if kind == "mels40_htk":
        return mel(40, 16000, 0.0, None, 257).double(), 512
    if kind == "mels80_slaney":
        return mel(80, 16000, 0.0, None, 513, mel_scale="slaney",
                   norm="slaney").double(), 1024
    if kind == "fmin_fmax":
        return mel(64, 16000, 300.0, 6000.0, 257).double(), 512
    if kind == "slaney_fmin":
        return mel(40, 22050, 50.0, 8000.0, 1025, mel_scale="slaney",
                   norm="slaney").double(), 2048
    if kind == "linear":
        return tops.create_linear_filter(48, 16000, 0.0, None,
                                         257).double(), 512
    fb = mel(64, 16000, 0.0, None, 257).double()
    if kind == "zero_column":
        fb[:, 10] = 0.0
    elif kind == "all_zero":
        fb.zero_()
    elif kind == "dense":
        fb = torch.from_numpy(np.random.default_rng(3).uniform(
            0.01, 1.0, (257, 64)))
    elif kind == "stray":
        fb[230, 3] = 1e-3        # mel 3's band lies below bin 10
    return fb, 512


FB_KINDS = ["config2", "config3", "mels40_htk", "mels80_slaney",
            "fmin_fmax", "slaney_fmin", "linear", "zero_column", "all_zero",
            "dense", "stray"]


@pytest.mark.parametrize("kind", FB_KINDS)
def test_band_tables_hold_every_nonzero(kind):
    """Each mel's band runs from its first to its last nonzero bin and each
    bin's from its first to its last nonzero mel; everything outside is
    exactly zero; the padding is empty."""
    fb, _ = _fb(kind)
    n_freqs, mels = fb.shape
    m_pad = -(-mels // 64) * 64
    mel_band, bin_band = tfused._fb_bands(fb, m_pad)
    f_pad = -(-n_freqs // 64) * 64
    assert mel_band.shape == (m_pad, 2) and bin_band.shape == (f_pad, 2)
    assert mel_band.dtype == bin_band.dtype == torch.int32
    empty = [tfused._BAND_EMPTY, 0]
    for m in range(m_pad):
        rows = (fb[:, m] != 0).nonzero().ravel().tolist() if m < mels else []
        assert mel_band[m].tolist() == ([rows[0], rows[-1] + 1] if rows
                                        else empty), m
    for k in range(f_pad):
        cols = (fb[k] != 0).nonzero().ravel().tolist() if k < n_freqs else []
        assert bin_band[k].tolist() == ([cols[0], cols[-1] + 1] if cols
                                        else empty), k
    inside = torch.zeros(fb.shape, dtype=torch.bool)
    for m in range(mels):
        lo, hi = mel_band[m].tolist()
        inside[lo:hi, m] = hi > lo
    assert not fb[~inside].any()


def test_band_tables_put_nan_and_inf_inside():
    """``!= 0``: NaN, inf and denormal entries are nonzero, -0.0 is zero."""
    fb = torch.zeros((129, 3))
    fb[5, 0], fb[40, 0] = float("nan"), 1e-40
    fb[7, 1], fb[9, 1] = float("inf"), -0.0
    mel_band, bin_band = tfused._fb_bands(fb, 64)
    assert mel_band[:3].tolist() == [
        [5, 41], [7, 8], [tfused._BAND_EMPTY, 0]]
    assert bin_band[40].tolist() == [0, 1] and bin_band[9].tolist() == [
        tfused._BAND_EMPTY, 0]


@pytest.mark.parametrize("kind", FB_KINDS)
def test_banded_products_equal_the_dense_ones(rng, kind):
    """The forward's mel product and the frame pass's dp over the bands
    leave out exact zero terms only: in float64 both equal the dense
    products to rounding, and in float32 to float32 rounding."""
    fb, _ = _fb(kind)
    n_freqs, mels = fb.shape
    m_pad = -(-mels // 64) * 64
    mel_band, bin_band = tfused._fb_bands(fb, m_pad)
    p = torch.from_numpy(rng.uniform(0.0, 2.0, (2, 9, n_freqs)))
    dmel = torch.from_numpy(rng.standard_normal((11, m_pad)))
    dmel[:, mels:] = 0.0
    for dt, tol in ((torch.float64, 1e-13), (torch.float32, 2e-6)):
        f, pp, dm = fb.to(dt), p.to(dt), dmel.to(dt)
        got = tfused._mel_product_banded(pp, f, mel_band)
        want = pp @ f
        assert got.dtype == dt and got.shape == want.shape
        got_dp = tfused._dp_banded(dm, f, bin_band)
        want_dp = dm[:, :mels] @ f.T
        assert got_dp.shape == want_dp.shape
        if kind == "all_zero":
            assert not got.any() and not got_dp.any()
            continue
        assert _rel(got, want) <= tol and _rel(got_dp, want_dp) <= tol


def _striped(rows_of, n_freqs, mels):
    """A filterbank of ones where ``rows_of(m)`` (a range of bins) says."""
    fb = torch.zeros((n_freqs, mels), dtype=torch.float64)
    for m in range(mels):
        fb[rows_of(m), m] = 1.0
    return fb


@pytest.mark.parametrize("width,banded", [(40, True), (44, False)])
def test_forward_takes_the_banded_product_below_its_share(rng, width,
                                                          banded):
    """fft 512, 64 mels: the dense product covers 260 bins (65 groups of 4)
    x 64 mels; bands of ``width`` bins aligned to 4 cover ``64·width``, on
    the banded side of ``_B1_BAND_SHARE`` (160 / 1024: 2 600) at 40 bins
    and past it at 44.  The plain forward takes the product the kernel
    would, and forcing either gives the other's values to rounding."""
    assert tfused._B1_BAND_SHARE == 160
    fb = _striped(lambda m: slice(4 * (m * (256 - width) // 252),
                                  4 * (m * (256 - width) // 252) + width),
                  257, 64)
    mel_band, bin_band = tfused._fb_bands(fb, 64)
    assert tfused._band_choice(mel_band, bin_band, 512, 64)[0] is banded
    x = torch.from_numpy(rng.standard_normal((2, 512 + 4 * 128)))
    args = (512, 128, "hann", None, False, 1.0, 1e-7)
    auto, _ = tfused._fwd_fft_plain(x, fb, *args)
    forced = {b: tfused._fwd_fft_plain(x, fb, *args, _banded=b)[0]
              for b in (True, False)}
    assert torch.equal(auto, forced[banded])
    assert _rel(forced[True], forced[False]) <= F64_TOL


@pytest.mark.parametrize("width,banded", [(32, True), (33, False)])
def test_frame_pass_takes_the_banded_dp_below_its_share(rng, width, banded):
    """fft 512, 64 mels: 256 lanes of one bin below Nyquist, 64 mels each
    dense; every bin's band of ``width`` mels sums to ``256·width``, on the
    banded side of ``_DP_BAND_SHARE`` (512 / 1024: 8 192) at 32 mels and
    past it at 33.  The plain backward takes the dp the kernel would, and
    forcing either gives the other's values to rounding."""
    assert tfused._DP_BAND_SHARE == 512
    fb = torch.zeros((257, 64), dtype=torch.float64)
    for k in range(257):
        lo = k * (64 - width) // 256
        fb[k, lo:lo + width] = 1.0 + k / 257
    mel_band, bin_band = tfused._fb_bands(fb, 64)
    assert tfused._band_choice(mel_band, bin_band, 512, 64)[1] is banded
    rows = 6
    dmel = torch.from_numpy(rng.standard_normal((rows, 64)))
    reim = torch.from_numpy(rng.standard_normal((rows, 5 * 128)))
    bargs = (fb, 512, "hann", None, True, False)
    auto, _ = tfused._bwd_fft_plain(dmel, reim, *bargs)
    forced = {b: tfused._bwd_fft_plain(dmel, reim, *bargs, _banded=b)[0]
              for b in (True, False)}
    assert torch.equal(auto, forced[banded])
    assert _rel(forced[True], forced[False]) <= F64_TOL


@pytest.mark.parametrize("kind,choice", [("config2", (True, True)),
                                         ("config3", (True, True)),
                                         ("linear", (True, True)),
                                         ("dense", (False, False)),
                                         ("all_zero", (True, True))])
def test_band_choice_of_the_cells_filterbanks(kind, choice):
    """The standard filterbanks take both banded products (config 2's
    bands cover 1.9 % of either dense product), a dense learned one takes
    neither, and an all-zero one sums nothing."""
    fb, fft = _fb(kind)
    m_pad = -(-fb.shape[1] // 64) * 64
    assert tfused._band_choice(*tfused._fb_bands(fb, m_pad), fft,
                               m_pad) == choice


@pytest.mark.parametrize("fft,hop,samples,mels,window,wl", CASES[::2])
def test_fft_plain_versions_agree_on_both_products(rng, fft, hop, samples,
                                                   mels, window, wl):
    """The step-by-step forward and backward, banded and dense: the same
    values to float64 rounding, and the op's rule takes the banded ones at
    these mel filterbanks."""
    x, fb, dmel = _inputs(rng, fft, hop, samples, mels, torch.float64)
    args = (fft, hop, window, wl, True, 1.0, 1e-7)
    outs = [tfused._fwd_fft_plain(x, fb, *args, save_spec=True, _banded=b)
            for b in (None, True, False)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert _rel(outs[1][0], outs[2][0]) <= F64_TOL
    reim = outs[0][1].reshape(dmel.shape[0], -1)
    bargs = (fb, fft, window, wl, True, True)
    grads = [tfused._bwd_fft_plain(dmel, reim, *bargs, _banded=b)
             for b in (None, True, False)]
    assert torch.equal(grads[0][0], grads[1][0])
    assert _rel(grads[1][0], grads[2][0]) <= F64_TOL
    assert torch.equal(grads[1][1], grads[2][1])     # dFB is dense


def test_band_counters_are_launch_counters():
    """``MEL_BAND_LAUNCHES`` is a host counter that a graph replay moves;
    the card's own (``B1_BANDED_LAUNCHES``, ``BWD_DP_BANDED_LAUNCHES``)
    are read with the rest and never moved by the host."""
    from torchaudio_contrib_tpu_torch.ops import _launches
    names = ["fused." + n for n in ("MEL_BAND_LAUNCHES",
                                    *tfused.CARD_COUNTERS)]
    before = _launches.counts()
    assert all(n in before for n in names)
    assert tfused.CARD_COUNTERS == ("B1_BANDED_LAUNCHES",
                                    "BWD_DP_BANDED_LAUNCHES")
    _launches.add({n: 3 for n in names}, 2)
    moved = _launches.delta(before)
    _launches.add({n: 3 for n in names}, -2)
    assert moved[names[0]] == 6 and moved[names[1]] == moved[names[2]] == 0


def test_wrappers_refuse_a_bad_banded_argument():
    """``_banded`` is None, True or False, and only on the FFT route; it is
    checked before anything else of the call."""
    fb = tops.create_mel_filter(32, 16000, 0.0, None, 257)
    x, dmel, reim = torch.zeros(2, 4096), torch.zeros(10, 64), torch.zeros(
        10, 640)
    for route, banded, what in ((None, 1, "_banded must be"),
                                ("fft", "yes", "_banded must be"),
                                ("dft", True, "FFT kernels'"),
                                ("dft", False, "FFT kernels'")):
        with pytest.raises(ValueError, match=what):
            tfused._fused_mel_fwd_cuda(x, fb, 512, 128, "hann", None, True,
                                       1.0, 1e-7, _route=route,
                                       _banded=banded)
        with pytest.raises(ValueError, match=what):
            tfused._fused_mel_bwd_cuda(dmel, reim, fb, 512, "hann", None,
                                       True, True, _route=route,
                                       _banded=banded)
