"""The FFT route of the port's fused Griffin-Lim solve, on the CPU.

``_gl_solve_fft_plain`` repeats, step by step in PyTorch, the arithmetic of
the FFT kernels of ``csrc/fused_gl.cu``: synthesis as ``hermitian_point`` →
inverse Stockham transform → window, analysis as window → Stockham
transform → ``real_bin``, then the momentum step and the projection.  Here
it is held

* against ``_gl_solve_plain`` (both transforms as products with the dense
  bases) from the same numpy-seeded state, in float32 at the kernels' bars
  and in float64 to 1e-10, which proves the Hermitian / ``real_bin`` algebra
  and the DC / Nyquist weights without a card;
* against the JAX package: one iteration against its Pallas kernels run
  through the Pallas interpreter (one case per kernel, B3 and B4), at the
  shape and the bf16-grade bar of ``tests/test_torch_griffinlim.py``; and
  at every iteration count, in both layouts, against the same free-edge
  solve written with the JAX package's plain float32 ops
  (``jax_free_edge_gl`` of that file), at ``WAVE_PARITY``.

The route rule and what the launch wrapper refuses are checked too.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from torchaudio_contrib_tpu.ops.fused_griffinlim import _gl_pallas
from test_torch_griffinlim import jax_free_edge_gl
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import fused as tfused
from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as tgl
from torchaudio_contrib_tpu_torch.ops.stft import (_dft_matrices,
                                                   _idft_matrices)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

PRODUCT_PARITY = 1e-5       # prev after one iteration, of peak
STATE_PARITY = 1e-4         # the projected state (divides by |upd|)
WAVE_PARITY = 1e-4          # the 4-iteration waveform, of peak
F64_PARITY = 1e-10
SIZES = [256, 512, 1024, 2048]
HOPS = ["quarter", "half", "ragged"]        # fft/4, fft/2, fft % hop != 0
M = 0.99


def _hop(fft, kind):
    return {"quarter": fft // 4, "half": fft // 2,
            "ragged": 3 * fft // 8 + 4}[kind]


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _mag(rng, fft, hop, window, frames=9, clips=2):
    x = rng.standard_normal((clips, (frames - 1) * hop)).astype(np.float32)
    return tops.stft(torch.from_numpy(x), fft, hop, window=window).abs()


def _operands(mag, fft, hop, window, tile_major):
    """The operands of both routes and a generic complex start (the state
    two plain iterations reach)."""
    dft = tgl._gl_prepare(mag, fft, hop, window, None, tile_major, "dft")[:5]
    fft_ops = tgl._gl_prepare(mag, fft, hop, window, None, tile_major,
                              "fft")[:5]
    start, _ = tgl._gl_solve_plain(*dft, fft, hop, 2, M, tile_major)
    return (start,) + dft[1:], (start,) + fft_ops[1:]


def _bases64(fft, window):
    """``syn`` and ``ana`` of the DFT route in float64 (the package keeps
    them in float32)."""
    w = tgl._window_np(fft, window)
    n_freqs = fft // 2 + 1
    ft = -(-n_freqs // 64)
    pad = ft * 64 - n_freqs
    icr, ici = (np.pad(b * w[None, :], ((0, pad), (0, 0)))
                for b in _idft_matrices(fft))
    cos, msin = (np.pad(w[:, None] * b, ((0, 0), (0, pad)))
                 for b in _dft_matrices(fft, True))
    syn, ana = [], []
    for t in range(ft):
        s = slice(t * 64, (t + 1) * 64)
        syn += [icr[s], ici[s]]
        ana += [cos[:, s], msin[:, s]]
    return (torch.from_numpy(np.concatenate(syn, axis=0)),
            torch.from_numpy(np.concatenate(ana, axis=1)))


def _pads(t, fft, tile_major):
    """The padded bins ``n_freqs..ft·64`` of a state or ``prev``."""
    return tgl._row_major(t, tile_major)[:, :, -1, :, (fft // 2 + 1) % 64:]


# ---- against the DFT route's plain version -----------------------------------

@pytest.mark.parametrize("tile_major", [False, True],
                         ids=["row_major", "tile_major"])
@pytest.mark.parametrize("window", ["hann", "hamming"])
@pytest.mark.parametrize("hop_kind", HOPS)
@pytest.mark.parametrize("fft", SIZES)
def test_one_iteration_matches_the_dft_plain_version(rng, fft, hop_kind,
                                                     window, tile_major):
    hop = _hop(fft, hop_kind)
    mag = _mag(rng, fft, hop, window)
    dft, fft_ops = _operands(mag, fft, hop, window, tile_major)
    want_state, want_prev = tgl._gl_solve_plain(*dft, fft, hop, 1, M,
                                                tile_major)
    state, prev = tgl._gl_solve_fft_plain(*fft_ops, fft, hop, 1, M,
                                          tile_major)
    assert state.shape == want_state.shape and prev.shape == want_prev.shape
    assert state.is_contiguous() and prev.is_contiguous()
    assert _rel(prev, want_prev) <= PRODUCT_PARITY
    assert _rel(state, want_state) <= STATE_PARITY
    # the padded bins are exact zeros, as the DFT route's zero basis
    # columns leave them
    for t in (state, prev, want_state, want_prev):
        pads = _pads(t, fft, tile_major)
        assert pads.numel() > 0 and not pads.any()
    # and Nyquist, the last real bin, is not among them
    nyq = tgl._row_major(prev, tile_major)[:, :, -1, 0, (fft // 2) % 64]
    assert nyq.abs().min() > 0


@pytest.mark.parametrize("window", ["hann", "hamming"])
@pytest.mark.parametrize("hop_kind", HOPS)
@pytest.mark.parametrize("fft", SIZES)
def test_four_iteration_waveform_and_layouts(rng, fft, hop_kind, window):
    hop = _hop(fft, hop_kind)
    mag = _mag(rng, fft, hop, window)
    length = (mag.shape[-1] - 1) * hop
    args = (mag, fft, hop, window, 4, M, length, True)
    want = tgl._gl_plain(*args)
    got = tgl._gl_plain(*args, route="fft")
    assert got.shape == want.shape == (2, length)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= WAVE_PARITY
    # tile-major is the same arithmetic in another layout: the same bits
    assert torch.equal(tgl._gl_plain(*args, tile_major=True, route="fft"),
                       got)


@pytest.mark.parametrize("window", ["hann", "hamming"])
@pytest.mark.parametrize("hop_kind", HOPS)
@pytest.mark.parametrize("fft", SIZES)
def test_float64_proves_the_algebra(rng, fft, hop_kind, window):
    """In float64 the two versions agree to 1e-10 after one and after four
    iterations: the Hermitian pre-step, ``real_bin``, the ``1/N`` and the
    weights of DC and Nyquist are those of the windowed DFT bases."""
    hop = _hop(fft, hop_kind)
    mag = _mag(rng, fft, hop, window)
    dft, _ = _operands(mag, fft, hop, window, False)
    start, magT, inv_env = dft[0].double(), dft[1].double(), dft[4].double()
    # imaginary parts at DC and Nyquist (a rebuilt spectrum has none): both
    # versions must ignore them
    ri = tgl._row_major(start, False)
    ri[:, :, 0, 1, 0] = 0.5 * ri[:, :, 0, 0, 0]
    ri[:, :, -1, 1, (fft // 2) % 64] = -0.25 * ri[:, :, -1, 0, (fft // 2) % 64]
    syn, ana = _bases64(fft, window)
    w, tw = tfused._fft_consts(start, fft, window, None)
    assert w.dtype == torch.float64 and tw.dtype == torch.complex128
    for n_iter in (1, 4):
        want = tgl._gl_solve_plain(start, magT, syn, ana, inv_env, fft, hop,
                                   n_iter, M)
        got = tgl._gl_solve_fft_plain(start, magT, w, tw, inv_env, fft, hop,
                                      n_iter, M)
        assert _rel(got[1], want[1]) <= F64_PARITY
        assert _rel(got[0], want[0]) <= F64_PARITY * 10 ** n_iter


def test_dc_and_nyquist_imaginary_parts_are_ignored(rng):
    """``irfft`` semantics: changing Im(DC) and Im(Nyquist) of the state
    changes nothing (the transposed transform of the mel backward weighs
    them differently; this one drops them)."""
    fft, hop = 512, 128
    mag = _mag(rng, fft, hop, "hann")
    _, ops = _operands(mag, fft, hop, "hann", False)
    other = ops[0].clone()
    ri = tgl._row_major(other, False)
    ri[:, :, 0, 1, 0] += 3.0
    ri[:, :, -1, 1, (fft // 2) % 64] -= 2.0
    a = tgl._gl_solve_fft_plain(*ops, fft, hop, 1, M)
    b = tgl._gl_solve_fft_plain(other, *ops[1:], fft, hop, 1, M)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_quiet_frame_beside_a_loud_one_keeps_its_accuracy(rng):
    """Each frame is transformed alone, so a frame 60 dB above its
    neighbours does not leak its rounding into them.  With hop = fft the
    frames do not overlap, so the rebuilt spectrum of a quiet frame depends
    on that frame alone: in float32 it stays within 1e-5 of its own peak of
    the float64 result on every frame (two frames packed into one complex
    transform would put 1e-7 of the loud frame, 1e-4 of the quiet one,
    there)."""
    fft = hop = 1024
    frames = 12
    gain = np.where(np.arange(frames) % 4 == 0, 1.0, 1e-3)
    spec = (rng.standard_normal((1, frames, fft // 2 + 1))
            + 1j * rng.standard_normal((1, frames, fft // 2 + 1)))
    spec = torch.from_numpy(spec * gain[None, :, None])
    mag = spec.abs()
    ft = fft // 128 + 1
    state64, mag64 = tgl._pack(spec.real, spec.imag, mag, ft, False)
    inv_env = torch.from_numpy(tgl._inv_envelope_of(fft, "hamming", hop,
                                                    frames))
    w64, tw64 = tfused._fft_consts(state64, fft, "hamming", None)
    w32, tw32 = tfused._fft_consts(state64.float(), fft, "hamming", None)
    _, want = tgl._gl_solve_fft_plain(state64, mag64, w64, tw64,
                                      inv_env.double(), fft, hop, 1, M)
    _, got = tgl._gl_solve_fft_plain(state64.float(), mag64.float(), w32,
                                     tw32, inv_env, fft, hop, 1, M)
    peak = want.abs().amax(dim=-1)                      # per frame
    assert peak.max() / peak.min() > 500.0              # ~60 dB apart
    err = (got.double() - want).abs().amax(dim=-1) / peak
    assert err.max().item() <= 1e-5


def test_zero_iterations_and_momentum(rng):
    fft, hop = 256, 64
    mag = _mag(rng, fft, hop, "hann")
    dft, ops = _operands(mag, fft, hop, "hann", True)
    state, prev = tgl._gl_solve_fft_plain(*ops, fft, hop, 0, M, True)
    assert torch.equal(state, ops[0]) and not prev.any()
    for momentum in (0.0, 0.5):
        want = tgl._gl_solve_plain(*dft, fft, hop, 3, momentum, True)
        got = tgl._gl_solve_fft_plain(*ops, fft, hop, 3, momentum, True)
        assert _rel(got[1], want[1]) <= PRODUCT_PARITY * 10
        assert _rel(got[0], want[0]) <= STATE_PARITY


# ---- the route rule, the operands and what the wrapper refuses ---------------

def test_route_rule():
    for fft in SIZES:
        assert tfused._route_for(fft, None) == "fft"
    for fft in (400, 128, 4096, 1000, 2):
        assert tfused._route_for(fft, None) == "dft"
    assert tfused._route_for(1024, "dft") == "dft"
    with pytest.raises(ValueError, match="power of two"):
        tfused._route_for(400, "fft")
    with pytest.raises(ValueError, match="unknown route"):
        tfused._route_for(1024, "cufft")


@pytest.mark.parametrize("tile_major", [False, True],
                         ids=["row_major", "tile_major"])
def test_fft_route_operands_build_no_dense_basis(rng, tile_major):
    fft, hop = 2048, 512
    mag = _mag(rng, fft, hop, "hann", frames=5)
    tgl._syn_np.cache_clear()
    before = tfused._basis_np.cache_info().misses
    state0, magT, w, tw, inv_env, w64 = tgl._gl_prepare(
        mag, fft, hop, "hann", None, tile_major, "fft")
    assert tgl._syn_np.cache_info().currsize == 0
    assert tfused._basis_np.cache_info().misses == before
    assert w.shape == (fft,) and tw.shape == (fft, 2)
    assert w.dtype == tw.dtype == torch.float32
    assert w64.dtype == np.float64 and np.array_equal(
        w.numpy(), w64.astype(np.float32))
    assert inv_env.shape == ((mag.shape[-1] - 1) * hop + fft,)
    dft = tgl._gl_prepare(mag, fft, hop, "hann", None, tile_major)
    assert torch.equal(dft[0], state0) and torch.equal(dft[1], magT)
    assert torch.equal(dft[4], inv_env) and np.array_equal(dft[5], w64)
    assert dft[2].shape == (17 * 128, fft) and dft[3].shape == (fft, 17 * 128)


def test_fft_400_takes_the_dft_route_and_fft_route_raises(rng):
    mag = _mag(rng, 400, 160, "hann")
    with pytest.raises(ValueError, match="power of two"):
        tgl._gl_prepare(mag, 400, 160, "hann", route="fft")
    with pytest.raises(ValueError, match="power of two"):
        tgl._gl_plain(mag, 400, 160, "hann", 1, M, None, True, route="fft")
    ops = tgl._gl_prepare(mag, 400, 160, "hann")[:5]
    with pytest.raises(ValueError, match="power of two"):
        tgl._gl_solve_cuda(*ops, 400, 160, 1, M, _route="fft")
    with pytest.raises(ValueError, match="unknown route"):
        tgl._gl_solve_cuda(*ops, 400, 160, 1, M, _route="gemm")
    # the default route at 400 gets as far as the device check
    with pytest.raises(ValueError, match="state0 must be a contiguous "
                                         "float32 CUDA"):
        tgl._gl_solve_cuda(*ops, 400, 160, 1, M)


@pytest.mark.parametrize("route", ["fft", "dft", None])
def test_kernel_wrapper_refuses_cpu_tensors_on_both_routes(rng, route):
    fft, hop = 512, 128
    mag = _mag(rng, fft, hop, "hann")
    ops = tgl._gl_prepare(mag, fft, hop, "hann",
                          route=route or "fft")[:5]
    counts = (tgl.GL_KERNEL_LAUNCHES, tgl.GL_TILE_MAJOR_LAUNCHES,
              tgl.GL_FFT_LAUNCHES)
    with pytest.raises(ValueError, match="state0 must be a contiguous "
                                         "float32 CUDA"):
        tgl._gl_solve_cuda(*ops, fft, hop, 1, M, _route=route)
    with pytest.raises(ValueError, match="variant"):
        tgl._gl_solve_cuda(*ops, fft, hop, 1, M, False, "nodma",
                           _route=route)
    assert counts == (tgl.GL_KERNEL_LAUNCHES, tgl.GL_TILE_MAJOR_LAUNCHES,
                      tgl.GL_FFT_LAUNCHES)


def test_cpu_tensor_runs_the_dft_plain_version_at_an_fft_route_size(rng):
    """On the CPU ``griffin_lim(method="pallas")`` is ``_gl_solve_plain``
    whatever the size, and counts no launch."""
    fft, hop = 1024, 256
    mag = _mag(rng, fft, hop, "hann")
    length = (mag.shape[-1] - 1) * hop
    counts = (tgl.GL_KERNEL_LAUNCHES, tgl.GL_FFT_LAUNCHES)
    y = tops.griffin_lim(mag, fft, hop, n_iter=3, length=length,
                         method="pallas")
    assert torch.equal(y, tgl._gl_plain(mag, fft, hop, "hann", 3, M, length,
                                        True))
    assert counts == (tgl.GL_KERNEL_LAUNCHES, tgl.GL_FFT_LAUNCHES)


# ---- against the interpreted Pallas kernels ----------------------------------

T = 11025                   # 0.5 s at 22.05 kHz: 44 frames at hop 256
FFT, HOP = 1024, 256


def _l2(got, want):
    return (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("TAC_FUSED_INTERPRET", "1")


@pytest.fixture(scope="module")
def mag():
    x = np.random.default_rng(0).standard_normal((2, T)).astype(np.float32)
    return tops.stft(torch.from_numpy(x), FFT, HOP).abs()


@pytest.mark.parametrize("tile_major", [False, True], ids=["B3", "B4"])
@pytest.mark.parametrize("n_iter,measure,bar", [
    (1, _rel, 0.03), (2, _rel, 0.06), (3, _l2, 0.055)])
def test_fft_plain_matches_pallas_interpret(request, mag, tile_major,
                                            n_iter, measure, bar):
    """The FFT route's plain version against the float32 JAX reference of
    the free-edge solve at every iteration count, and after one iteration
    against the interpreted Pallas kernel of each layout: those keep state,
    ``prev`` and the frames in bfloat16 and the port float32, so they sit
    bf16-grade apart (the bar of ``tests/test_torch_griffinlim.py``, twice
    the measured distance).  Without momentum the port's solve is far
    outside the float32 bar."""
    got = tgl._gl_plain(mag, FFT, HOP, "hann", n_iter, M, T, True,
                        tile_major=tile_major, route="fft")
    want = torch.from_numpy(jax_free_edge_gl(mag, FFT, HOP, n_iter, M, T))
    assert got.shape == want.shape == (2, T)
    assert _rel(got, want) <= WAVE_PARITY
    if n_iter == 1:
        request.getfixturevalue("interpret")
        kernel = torch.from_numpy(np.array(_gl_pallas(
            jnp.asarray(mag.numpy()), FFT, HOP, "hann", 1, M, T, True,
            tile_major=tile_major)))
        assert measure(got, kernel) <= bar
    if n_iter == 3:
        off = tgl._gl_plain(mag, FFT, HOP, "hann", 3, 0.0, T, True,
                            tile_major=tile_major, route="fft")
        assert _rel(off, want) > 0.1


@pytest.mark.parametrize("tile_major", [False, True], ids=["B3", "B4"])
def test_fft_plain_converges_where_pallas_interpret_does(mag, tile_major):
    """8 iterations: the FFT route lands where the JAX package's free-edge
    solve does (the Pallas kernels land there too,
    ``tests/test_torch_griffinlim.py``), and where the DFT route does."""
    def convergence(y):
        s = tops.stft(y, FFT, HOP).abs()
        return float((s - mag).norm() / mag.norm())

    y_j = torch.from_numpy(jax_free_edge_gl(mag, FFT, HOP, 8, M, T))
    y_t = tgl._gl_plain(mag, FFT, HOP, "hann", 8, M, T, True,
                        tile_major=tile_major, route="fft")
    y_d = tgl._gl_plain(mag, FFT, HOP, "hann", 8, M, T, True,
                        tile_major=tile_major)
    c_j, c_t, c_d = convergence(y_j), convergence(y_t), convergence(y_d)
    assert abs(c_j - c_t) <= 5e-3, (c_j, c_t)
    assert abs(c_d - c_t) <= 1e-3, (c_d, c_t)
