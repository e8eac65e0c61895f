"""The port's Griffin-Lim vs the JAX package (CPU).

* The ``fft`` and ``matmul`` loops are the same float32 arithmetic on both
  sides: a few iterations from zero phase agree to 1e-4 of peak.
* The fused path: on the CPU the port runs ``_gl_solve_plain``, the plain
  version of its CUDA kernels.  It is held against the JAX package in two
  ways, in both state layouts (B3 row-major, B4 tile-major):

  - against the JAX package's Pallas kernels run through the Pallas
    interpreter (``TAC_FUSED_INTERPRET=1``, as ``tests/test_griffinlim.py``
    runs them), one case per kernel (one iteration: the interpreter's cost
    is its tracing, seconds a call whatever the shape).  Those kernels keep
    state, ``prev`` and the frames in bfloat16 (8 bits of mantissa: 4e-3
    relative per rounding) and the port keeps float32, so the two sit
    bf16-grade apart: measured 1.6e-2 of peak after 1 iteration; the bar is
    twice that;
  - against :func:`jax_free_edge_gl`, the same free-edge solve written with
    the JAX package's plain float32 ops (``jnp.fft``, its ``frame_signal``,
    ``_overlap_add`` and ``cola_window_sum``), at every iteration count:
    both are float32 chains, held to ``WAVE_PARITY`` (1e-4 of peak).  The
    mutation tests show what that bar catches: without momentum, without
    the envelope, or with ``prev`` not starting at zero the solve lands
    more than 0.1 of peak away.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu import ops as jops
from torchaudio_contrib_tpu.ops.fused_griffinlim import _gl_pallas
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as tgl
from torchaudio_contrib_tpu_torch.ops.stft import _cached_on
import torchaudio_contrib_tpu_torch as tat

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

LOOP_PARITY = 1e-4          # fft / matmul loops vs JAX, of peak
WAVE_PARITY = 1e-4          # fused solve vs its float32 JAX reference
T = 11025                   # 0.5 s at 22.05 kHz: 44 frames at hop 256
FFT, HOP = 1024, 256


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _convergence(y, mag, fft, hop):
    """Spectral convergence ``‖|STFT(y)| − mag‖ / ‖mag‖``."""
    s = tops.stft(torch.as_tensor(np.array(y)), fft, hop).abs()
    return float((s - mag).norm() / mag.norm())


@pytest.fixture(scope="module")
def mag():
    x = np.random.default_rng(0).standard_normal((2, T)).astype(np.float32)
    return tops.stft(torch.from_numpy(x), FFT, HOP).abs()


# ---- the fft and matmul loops vs JAX -----------------------------------------

@pytest.mark.parametrize("method", ["fft", "matmul"])
@pytest.mark.parametrize("shape,fft,hop,kw", [
    ((2, 4000), 256, 64, {"n_iter": 3}),
    ((2, 2, 3000), 400, 160, {"n_iter": 2, "window": "hamming"}),
    ((2, 4000), 256, 128, {"n_iter": 4, "momentum": 0.5, "length": 4000}),
    ((1, 4000), 256, 64, {"n_iter": 2, "center": False,
                          "window": "hamming"}),
])
def test_loops_match_jax(rng, method, shape, fft, hop, kw):
    x = rng.standard_normal(shape).astype(np.float32)
    center = kw.get("center", True)
    m = tops.stft(torch.from_numpy(x), fft, hop, center=center,
                  window=kw.get("window")).abs()
    got = tops.griffin_lim(m, fft, hop, method=method, **kw).numpy()
    want = np.asarray(jops.griffin_lim(jnp.asarray(m.numpy()), fft, hop,
                                       method=method, **kw))
    assert got.shape == want.shape
    assert _rel(got, want) <= LOOP_PARITY


def test_defaults_and_momentum_check(rng):
    m = torch.from_numpy(rng.random((129, 20)).astype(np.float32))
    y = tops.griffin_lim(m, n_iter=2)          # fft 256, hop 64, centred
    assert y.shape == (19 * 64,)
    assert y.shape == jops.griffin_lim(jnp.asarray(m.numpy()),
                                       n_iter=2).shape
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError, match="momentum"):
            tops.griffin_lim(m, momentum=bad)
    assert tops.griffinlim is tops.griffin_lim


# ---- the fused solve's plain version vs the JAX package ---------------------

def jax_free_edge_gl(mag, fft, hop, n_iter, momentum, length, center=True,
                     window="hann"):
    """The free-edge momentum Griffin-Lim that the JAX package's Pallas
    kernels compute (``_gl_pallas``: zero initial phase, ``prev`` from
    zero, the clamped least-squares inverse envelope over the padded
    signal, no reflect padding per iteration, the final exact ``irfft``),
    in float32 from the JAX package's plain ops, as one jitted program."""
    from torchaudio_contrib_tpu.ops.stft import _overlap_add, frame_signal
    from torchaudio_contrib_tpu.ops.windows import cola_window_sum, get_window
    w = get_window(window, fft)
    n_frames = mag.shape[-1]
    n = (n_frames - 1) * hop + fft
    env = cola_window_sum(w, hop, n_frames, n)
    inv = jnp.asarray(np.where(env > 1e-3 * env.max(),
                               1.0 / np.maximum(env, 1e-8), 0.0), jnp.float32)
    wj = jnp.asarray(w, jnp.float32)

    @jax.jit
    def solve(mag_t):
        def synthesis(spec):
            frames = jnp.fft.irfft(spec, n=fft, axis=-1) * wj
            return _overlap_add(frames, fft, hop, n) * inv

        spec = mag_t.astype(jnp.complex64)
        prev = jnp.zeros_like(spec)
        for _ in range(n_iter):
            reim = jnp.fft.rfft(frame_signal(synthesis(spec), fft, hop) * wj,
                                axis=-1)
            upd = reim + momentum * (reim - prev)
            prev = reim
            spec = mag_t * upd / jnp.maximum(jnp.abs(upd), 1e-16)
        return synthesis(spec)

    y = np.array(solve(jnp.swapaxes(jnp.asarray(np.asarray(mag)), -1, -2)))
    if center:
        y = y[..., fft // 2:]
    if y.shape[-1] >= length:
        return y[..., :length]
    return np.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, length - y.shape[-1])])


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("TAC_FUSED_INTERPRET", "1")


@pytest.mark.parametrize("tile_major", [False, True], ids=["B3", "B4"])
@pytest.mark.parametrize("n_iter,measure,bar", [
    (1, _rel, 0.03), (2, _rel, 0.06), (3, _l2, 0.055)])
def test_plain_matches_pallas_interpret(request, mag, tile_major, n_iter,
                                        measure, bar):
    """One iteration against the interpreted Pallas kernel of each layout
    (at the bf16-grade bar); every iteration count against the float32 JAX
    reference at ``WAVE_PARITY``, and without momentum far outside it."""
    got = tgl._gl_plain(mag, FFT, HOP, "hann", n_iter, 0.99, T, True,
                        tile_major=tile_major).numpy()
    want = jax_free_edge_gl(mag, FFT, HOP, n_iter, 0.99, T)
    assert got.shape == want.shape == (2, T)
    assert _rel(got, want) <= WAVE_PARITY
    if n_iter == 1:
        request.getfixturevalue("interpret")
        kernel = np.asarray(_gl_pallas(jnp.asarray(mag.numpy()), FFT, HOP,
                                       "hann", 1, 0.99, T, True,
                                       tile_major=tile_major))
        assert measure(got, kernel) <= bar
    if n_iter == 3:
        # the bar has teeth: the same solve without momentum is outside it
        off = tgl._gl_plain(mag, FFT, HOP, "hann", 3, 0.0, T, True,
                            tile_major=tile_major).numpy()
        assert _rel(off, want) > 0.1


def test_bar_catches_a_missing_envelope_and_a_wrong_first_step(
        mag, monkeypatch):
    want = jax_free_edge_gl(mag, FFT, HOP, 1, 0.99, T)

    def plain():
        return tgl._gl_plain(mag, FFT, HOP, "hann", 1, 0.99, T,
                             True).numpy()

    assert _rel(plain(), want) <= WAVE_PARITY
    # (a) a flat envelope in place of the clamped inverse of the window sum
    with monkeypatch.context() as m:
        m.setattr(tgl, "_inv_envelope",
                  lambda w, hop, n, length: np.full(length, 1 / 1.5,
                                                    np.float32))
        _cached_on.cache_clear()
        assert _rel(plain(), want) > 0.1
    _cached_on.cache_clear()
    # (b) prev starting at the state instead of zero: the first step is no
    # longer a projection of (1 + momentum)·reim
    real_zeros = torch.zeros_like
    with monkeypatch.context() as m:
        m.setattr(torch, "zeros_like",
                  lambda t, **kw: t.clone() if t.ndim == 3 and not kw
                  else real_zeros(t, **kw))
        assert _rel(plain(), want) > 0.1


@pytest.mark.parametrize("tile_major", [False, True], ids=["B3", "B4"])
def test_convergence_matches_pallas_interpret(mag, tile_major):
    """8 iterations: the port lands where the JAX package's free-edge
    solve lands (the Pallas kernels' bf16 state does not change that:
    0.2590 interpreted, 0.2593 plain), near the matmul loop's."""
    y_j = jax_free_edge_gl(mag, FFT, HOP, 8, 0.99, T)
    y_t = tgl._gl_plain(mag, FFT, HOP, "hann", 8, 0.99, T, True,
                        tile_major=tile_major).numpy()
    c_j, c_t = (_convergence(y, mag, FFT, HOP) for y in (y_j, y_t))
    assert abs(c_j - c_t) <= 5e-3, (c_j, c_t)
    c_m = _convergence(tops.griffin_lim(mag, FFT, HOP, n_iter=8, length=T,
                                        method="matmul"), mag, FFT, HOP)
    assert c_t <= c_m + 0.05, (c_t, c_m)


def test_layouts_agree(mag):
    """Tile-major is the same math in another layout."""
    a = tgl._gl_plain(mag, FFT, HOP, "hann", 4, 0.99, T, True)
    b = tgl._gl_plain(mag, FFT, HOP, "hann", 4, 0.99, T, True,
                      tile_major=True)
    assert _rel(b.numpy(), a.numpy()) <= 1e-5
    ops = tgl._gl_prepare(mag, FFT, HOP, "hann")
    ops_tm = tgl._gl_prepare(mag, FFT, HOP, "hann", tile_major=True)
    assert ops[0].shape == (2, 44, 9 * 128) and ops[1].shape == (2, 44, 576)
    assert (ops_tm[0].shape == (2, 9, 44, 128)
            and ops_tm[1].shape == (2, 9, 44, 64))
    spec = tgl._unpack(ops[0], 513, False)
    assert torch.equal(spec, tgl._unpack(ops_tm[0], 513, True))
    assert torch.equal(spec.real, mag.transpose(1, 2)) and not spec.imag.any()


# ---- dispatch --------------------------------------------------------------

def test_pallas_method_on_cpu_runs_the_plain_solve(mag):
    before = tgl.GL_KERNEL_LAUNCHES
    y = tops.griffin_lim(mag, FFT, HOP, n_iter=8, length=T, method="pallas")
    want = tgl._gl_plain(mag, FFT, HOP, "hann", 8, 0.99, T, True)
    assert torch.equal(y, want)
    assert tgl.GL_KERNEL_LAUNCHES == before      # no kernel on the CPU
    assert _convergence(y, mag, FFT, HOP) <= 0.35   # the JAX test's bar
    # stereo leading dims, default length
    y2 = tops.griffin_lim(mag.reshape(1, 2, 513, 44), n_iter=1,
                          method="pallas")
    assert y2.shape == (1, 2, 43 * HOP)


def test_generator_gives_another_equally_converged_result(mag):
    y0 = tops.griffin_lim(mag, FFT, HOP, n_iter=8, length=T, method="pallas")
    gen = torch.Generator().manual_seed(7)
    y1 = tops.griffin_lim(mag, FFT, HOP, n_iter=8, length=T, method="pallas",
                          generator=gen)
    y1b = tops.griffin_lim(mag, FFT, HOP, n_iter=8, length=T,
                           method="pallas",
                           generator=torch.Generator().manual_seed(7))
    assert torch.equal(y1, y1b)
    assert (y1 - y0).abs().max().item() > 1e-3
    assert _convergence(y1, mag, FFT, HOP) <= 0.35
    for method in ("fft", "matmul"):
        ym = tops.griffin_lim(mag, FFT, HOP, n_iter=4, length=T,
                              method=method,
                              generator=torch.Generator().manual_seed(7))
        assert ym.shape == (2, T) and bool(torch.isfinite(ym).all())
        assert _convergence(ym, mag, FFT, HOP) <= 0.45


def test_fused_gl_supported_matrix():
    # the four shapes the JAX package's rule accepts
    assert tops.fused_gl_supported(1024, 256, 431)
    assert tops.fused_gl_supported(2048, 512, 216)
    assert tops.fused_gl_supported(1024, 512, 431)
    assert tops.fused_gl_supported(1024, 1024, 431)
    for shape in ((1024, 256, 431), (2048, 512, 216), (1024, 512, 431),
                  (1024, 1024, 431)):
        assert jops.fused_gl_supported(*shape)
    # wider than the TPU's rule: no multiples of 128, no fft % hop, no
    # on-chip memory cap
    assert tops.fused_gl_supported(400, 160, 431)
    assert tops.fused_gl_supported(1024, 160, 431)
    assert tops.fused_gl_supported(1024, 384, 431)
    assert tops.fused_gl_supported(2048, 512, 9000)
    # the port's own limits
    assert not tops.fused_gl_supported(255, 64, 10)      # odd fft
    assert not tops.fused_gl_supported(256, 300, 10)     # hop > fft
    assert not tops.fused_gl_supported(256, 0, 10)
    assert not tops.fused_gl_supported(256, 64, 0)


def test_ineligible_config_warns_and_runs_matmul(rng):
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    m = tops.stft(torch.from_numpy(x), 255, 64).abs()      # odd fft
    assert m.shape[-2] == 128
    with pytest.warns(UserWarning, match="fft_length even"):
        y = tops.griffin_lim(m, 255, 64, n_iter=2, length=3000,
                             method="pallas")
    want = tops.griffin_lim(m, 255, 64, n_iter=2, length=3000,
                            method="matmul")
    assert torch.equal(y, want)


def test_kernel_wrapper_refuses_cpu_tensors(mag):
    """The launch wrapper never computes another way: CPU operands
    raise."""
    ops = tgl._gl_prepare(mag, FFT, HOP, "hann")[:5]
    with pytest.raises(ValueError, match="CUDA"):
        tgl._gl_solve_cuda(*ops, FFT, HOP, 1, 0.99)
    with pytest.raises(ValueError, match="variant"):
        tgl._gl_solve_cuda(*ops, FFT, HOP, 1, 0.99, False, "nodma")
    with pytest.raises(ValueError, match="bins"):
        tgl._gl_prepare(mag[:, :500], FFT, HOP, "hann")


def test_bases(rng):
    """syn inverts ana on the window's support: frames → ana → syn is the
    window-squared weighted identity, and the padding is zero."""
    syn, w = tgl._syn_np(400, "hann")
    ana = tgl._gl_bases_on(torch.device("cpu"), 400, "hann")[1].numpy()
    assert syn.shape == (4 * 128, 448) and ana.shape == (400, 4 * 128)
    assert not syn[:, 400:].any()
    x = rng.standard_normal((5, 400)).astype(np.float32)
    back = (x @ ana) @ syn[:, :400]
    np.testing.assert_allclose(back, x * (w ** 2)[None, :], atol=2e-5)


# ---- layers ----------------------------------------------------------------

def test_griffinlim_layer(mag):
    layer = tat.GriffinLim(FFT, HOP, n_iter=2, length=T, method="pallas")
    assert not layer.state_dict()
    assert torch.equal(layer(mag), tops.griffin_lim(
        mag, FFT, HOP, n_iter=2, length=T, method="pallas"))
    gen = torch.Generator().manual_seed(3)
    y = layer(mag, generator=gen)
    assert torch.equal(y, tops.griffin_lim(
        mag, FFT, HOP, n_iter=2, length=T, method="pallas",
        generator=torch.Generator().manual_seed(3)))
    jl = jops.griffin_lim(jnp.asarray(mag.numpy()), FFT, HOP, n_iter=2,
                          length=T, method="fft")
    tl = tat.GriffinLim(FFT, HOP, n_iter=2, length=T)(mag)
    assert _rel(tl.numpy(), np.asarray(jl)) <= LOOP_PARITY
