"""Gradients of the port's fused mel op vs the JAX package.

The same numpy inputs and output cotangent go through ``jax.grad`` of the
JAX op (its chain and custom VJP on the CPU) and through the port:

* the public op on CPU tensors, whose gradient is autograd of the plain
  chain;
* ``_FusedMel``, the autograd function the GPU runs, driven here with the
  plain PyTorch versions of the two kernels (``_fwd_res_plain``, and
  ``_bwd_plain`` inside the op's backward ``_op_bwd_plain``) in the
  kernels' layouts: the dB gate, the residual layout, the overlap-add and
  leading dims are all on this path;
* the JAX package's own Pallas forward (``save_spec``) and backward
  kernels through the Pallas interpreter, at a hop that is not a multiple
  of 128 (128-aligned hops take 40 s or more interpreted).

Tolerances are max |port − JAX| / max |JAX| per gradient: 1e-4, the
BASELINE bar, which the JAX package's own backward tests also use.  The
CUDA kernels are held against the same plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu import ops as jops
from torchaudio_contrib_tpu.ops import fused as jfused
from torchaudio_contrib_tpu.ops.stft import _overlap_add as j_overlap_add
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import fused as tfused
from torchaudio_contrib_tpu_torch.ops.stft import (_overlap_add,
                                                   _pad_center, frame_signal)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

GRAD_TOL = 1e-4

# the shapes of test_torch_fused.py::test_plain_matches_jax
CASES = [
    ((2, 16384), 512, 128, 64, 16000, {}),
    ((2, 1, 16384), 512, 128, 64, 16000, {"center": True}),
    ((3, 2, 8192), 256, 128, 32, 16000, {"to_db": False}),
    ((2, 8192), 512, 128, 32, 16000, {"win_length": 300}),
    ((2, 16000), 400, 160, 80, 16000, {"precision": "auto"}),     # Whisper
    ((1, 3, 9000), 256, 100, 40, 22050, {"db_ref": 0.5, "amin": 1e-5}),
    ((2, 8000), 512, 200, 64, 16000, {"center": True,
                                      "pad_mode": "constant"}),
]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _inputs(rng, shape, fft, hop, mels, sr, kw):
    x = rng.standard_normal(shape).astype(np.float32)
    fb = tops.create_mel_filter(mels, sr, 0.0, None, fft // 2 + 1).numpy()
    t = x.shape[-1] + (2 * (fft // 2) if kw.get("center") else 0)
    n_frames = 1 + (t - fft) // hop
    g = rng.standard_normal(shape[:-1] + (mels, n_frames)).astype(np.float32)
    return x, fb, g


def _jax_grads(x, fb, g, fft, hop, kw):
    def loss(xv, fbv, gv):
        return jnp.sum(jops.fused_melspectrogram(xv, fbv, fft, hop, **kw)
                       * gv)
    # jit: one compile per config is ~10x cheaper than eager's first call
    dx, dfb = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(fb), jnp.asarray(g))
    return np.asarray(dx), np.asarray(dfb)


def _kernel_path(x, fb, fft, hop, center=False, pad_mode="reflect",
                 precision="auto", window="hann", win_length=None,
                 to_db=True, db_ref=1.0, amin=1e-7):
    """The public op's CUDA path with the kernels' plain versions."""
    if center:
        x = _pad_center(x, fft // 2, pad_mode)
    return tfused._fused_apply(x, fb, fft, hop, window, win_length, to_db,
                               db_ref, amin, tfused._fwd_res_plain,
                               tfused._op_bwd_plain)


def _torch_grads(fn, x, fb, g, fft, hop, kw, need=(True, True)):
    xt = torch.from_numpy(x).requires_grad_(need[0])
    fbt = torch.from_numpy(fb).requires_grad_(need[1])
    out = fn(xt, fbt, fft, hop, **kw)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach(), xt.grad, fbt.grad


# ---- plain chain (the CPU path) and _FusedMel vs jax.grad --------------------

@pytest.mark.parametrize("path", ["chain", "fused_autograd"])
@pytest.mark.parametrize("shape,fft,hop,mels,sr,kw", CASES)
def test_grads_match_jax(rng, path, shape, fft, hop, mels, sr, kw):
    x, fb, g = _inputs(rng, shape, fft, hop, mels, sr, kw)
    want_dx, want_dfb = _jax_grads(x, fb, g, fft, hop, kw)
    fn = tops.fused_melspectrogram if path == "chain" else _kernel_path
    out, dx, dfb = _torch_grads(fn, x, fb, g, fft, hop, kw)
    assert tuple(out.shape) == g.shape
    assert dx.shape == want_dx.shape and dfb.shape == want_dfb.shape
    assert _rel(dx, want_dx) <= GRAD_TOL
    assert _rel(dfb, want_dfb) <= GRAD_TOL


@pytest.mark.parametrize("need", [(False, True), (True, False)],
                         ids=["filterbank_only", "waveform_only"])
def test_backward_runs_only_what_is_needed(rng, monkeypatch, need):
    """The backward is asked only for the gradients ``needs_input_grad``
    wants, and so is the kernel inside it; with no waveform gradient there
    is no overlap-add either."""
    calls, kernel_calls = [], []
    plain_kernel = tfused._bwd_plain

    def spy(*args):
        calls.append(args[-2:])
        return tfused._op_bwd_plain(*args)

    def kernel_spy(*args):
        kernel_calls.append(args[-2:])
        return plain_kernel(*args)

    def no_ola(*args):
        raise AssertionError("overlap-add without a waveform gradient")

    def fn(xv, fbv, fft, hop):
        return tfused._fused_apply(xv, fbv, fft, hop, "hann", None, True,
                                   1.0, 1e-7, tfused._fwd_res_plain, spy)

    monkeypatch.setattr(tfused, "_bwd_plain", kernel_spy)
    if not need[0]:
        monkeypatch.setattr(tfused, "_overlap_add", no_ola)
    x, fb, g = _inputs(rng, (2, 1, 16000), 512, 128, 64, 16000, {})
    want = _jax_grads(x, fb, g, 512, 128, {})
    _, *got = _torch_grads(fn, x, fb, g, 512, 128, {}, need)
    assert calls == kernel_calls == [need]
    for grad, w, needed in zip(got, want, need):
        if needed:
            assert _rel(grad, w) <= GRAD_TOL
        else:
            assert grad is None


@pytest.mark.parametrize("path", ["chain", "fused_autograd"])
def test_silence_gives_exactly_zero(rng, path):
    """Every mel entry is clamped to amin: the dB gate (with its 1e-4
    relative tolerance) gives exactly zero gradients, as the chain does."""
    x = np.zeros((2, 8192), np.float32)
    fb = tops.create_mel_filter(32, 16000, 0.0, None, 257).numpy()
    g = rng.standard_normal((2, 32, 1 + (8192 - 512) // 128)).astype(
        np.float32)
    fn = tops.fused_melspectrogram if path == "chain" else _kernel_path
    _, dx, dfb = _torch_grads(fn, x, fb, g, 512, 128, {})
    assert not dx.any() and not dfb.any()
    want_dx, want_dfb = _jax_grads(x, fb, g, 512, 128, {})
    assert not want_dx.any() and not want_dfb.any()


def test_gradcheck_float64():
    """``_FusedMel`` with the plain kernels is the exact gradient of its
    own forward: finite differences in float64 at a tiny config."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 41), generator=gen, dtype=torch.float64)
    fb = torch.rand((9, 4), generator=gen, dtype=torch.float64) + 0.1

    def fn(xv, fbv):
        return tfused._fused_apply(xv, fbv, 16, 5, "hann", None, True, 1.0,
                                   1e-7, tfused._fwd_res_plain,
                                   tfused._op_bwd_plain)

    assert torch.autograd.gradcheck(
        fn, (x.requires_grad_(), fb.requires_grad_()), eps=1e-6, atol=1e-6)


# ---- the kernels' plain versions vs the JAX Pallas kernels -------------------

def _unpack_reim(reim, ft_count, tile, n_frames, n_freqs):
    """(streams, rows, ft·2·tile) with [re_t | im_t] per tile → complex
    (streams, n_frames, n_freqs)."""
    r = np.asarray(reim)
    r = r.reshape(r.shape[0], r.shape[1], ft_count, 2, tile)
    re = r[..., 0, :].reshape(r.shape[0], r.shape[1], -1)
    im = r[..., 1, :].reshape(r.shape[0], r.shape[1], -1)
    return (re + 1j * im)[:, :n_frames, :n_freqs]


def test_plain_kernels_match_pallas_interpret(rng, monkeypatch):
    """``_fwd_res_plain``'s residual and the backward through the plain
    kernels against the JAX package's ``_kernel_forward(save_spec=True)``
    and ``_kernel_backward`` (Pallas, interpreted) at fft 512 / hop 160,
    ``split6`` (f32-grade), two streams."""
    monkeypatch.setenv("TAC_FUSED_INTERPRET", "1")
    fft, hop, mels, t = 512, 160, 40, 4000
    x, fb, _ = _inputs(rng, (2, t), fft, hop, mels, 16000, {})
    n_frames, n_freqs = 1 + (t - fft) // hop, fft // 2 + 1
    g = rng.standard_normal((2, mels, n_frames)).astype(np.float32)
    args = (fft, hop, "hann", True, 1.0, 1e-7, "split6", None)
    jout, (y_raw, reim_raw) = jfused._kernel_forward(
        jnp.asarray(x), jnp.asarray(fb), *args, save_spec=True)
    jdx, jdfb = jfused._kernel_backward(
        jnp.asarray(g), jnp.asarray(x), jnp.asarray(fb), y_raw, reim_raw,
        *args)

    out, reim = tfused._fwd_res_plain(torch.from_numpy(x),
                                      torch.from_numpy(fb), fft, hop,
                                      "hann", None, True, 1.0, 1e-7,
                                      save_spec=True)
    assert _rel(out, jout) <= 2e-5
    spec = _unpack_reim(reim, -(-n_freqs // 64), 64, n_frames, n_freqs)
    jspec = _unpack_reim(reim_raw, -(-n_freqs // 128), 128, n_frames,
                         n_freqs)
    assert spec.shape == jspec.shape == (2, n_frames, n_freqs)
    assert _rel(spec, jspec) <= 2e-5

    _, dx, dfb = _torch_grads(_kernel_path, x, fb, g, fft, hop, {})
    assert _rel(dx, jdx) <= GRAD_TOL
    assert _rel(dfb, jdfb) <= GRAD_TOL


def test_plain_forward_matches_chain(rng):
    """The kernel-layout forward is the chain the CPU path runs."""
    x = torch.from_numpy(rng.standard_normal((3, 9000)).astype(np.float32))
    fb = tops.create_mel_filter(33, 16000, 0.0, None, 126)
    want = tfused._reference(x, fb, 250, 77, "hann", 2.0, True, 0.5, 1e-6,
                             200)
    got, reim = tfused._fwd_res_plain(x, fb, 250, 77, "hann", 200, True, 0.5,
                                      1e-6)
    assert reim is None and got.shape == want.shape
    assert _rel(got, want) <= 2e-6


# ---- overlap-add --------------------------------------------------------------

@pytest.mark.parametrize("fft,hop,t", [(16, 5, 61), (16, 16, 64),
                                       (8, 12, 50), (512, 160, 4000),
                                       (7, 3, 30), (400, 160, 1000)])
def test_overlap_add_is_adjoint_of_framing(rng, fft, hop, t):
    x = torch.from_numpy(rng.standard_normal((2, 3, t)))
    frames = frame_signal(x, fft, hop)
    g = torch.from_numpy(rng.standard_normal(tuple(frames.shape)))
    full = (frames.shape[-2] - 1) * hop + fft
    y = _overlap_add(g, fft, hop, full)
    assert y.shape == (2, 3, full)
    np.testing.assert_allclose(float((frames * g).sum()),
                               float((x[..., :full] * y).sum()),
                               rtol=1e-12, atol=1e-9)
    # the JAX package computes in float32
    want = np.asarray(j_overlap_add(jnp.asarray(g.numpy()), fft, hop, full))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6)


# ---- dispatch ------------------------------------------------------------------

def test_cpu_backward_builds_nothing(rng, monkeypatch):
    """Gradients of a CPU tensor come from autograd of the plain chain:
    no kernel library is loaded and no counter moves."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")
    monkeypatch.setattr(tfused._cuda, "load", no_build)
    before = (tfused.KERNEL_LAUNCHES, tfused.BWD_KERNEL_LAUNCHES)
    x = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))
    fb = tops.create_mel_filter(32, 16000, 0.0, None, 257)
    x.requires_grad_()
    fb.requires_grad_()
    tops.fused_melspectrogram(x, fb, 512, 128).sum().backward()
    assert x.grad is not None and fb.grad is not None
    assert (tfused.KERNEL_LAUNCHES, tfused.BWD_KERNEL_LAUNCHES) == before


def test_bwd_wrapper_refuses_cpu_tensors():
    """The backward launch wrapper takes CUDA tensors only."""
    fb = tops.create_mel_filter(32, 16000, 0.0, None, 257)
    with pytest.raises(ValueError, match="CUDA"):
        tfused._fused_mel_bwd_cuda(torch.zeros(10, 64), torch.zeros(10, 640),
                                   fb, 512, "hann", None, True, True)


def test_dfb_splits_cover_the_rows():
    for rows, tiles in ((1, 1), (39904, 5), (41216, 34), (100, 50),
                        (257, 2), (10 ** 6, 1)):
        n, per = tfused._dfb_splits(rows, tiles)
        assert per % 16 == 0 and n * per >= rows > (n - 1) * per
        assert 1 <= n <= 264
    # the dFB pass's grid, from the shapes alone: config 2 and config 3
    # fill two blocks on each of 132 SMs; fft 256 / 512 / 2048 fold the
    # Nyquist bin, fft 400 (201 bins) and fft 2 (2) keep a partial tile;
    # the residual is read once up to 128 padded mels
    cases = {(41216, 1025, 128): (8, True), (39904, 257, 64): (2, True),
             (3, 257, 64): (2, True), (9354, 257, 64): (2, True),
             (318, 129, 64): (1, True), (249, 1025, 192): (24, False),
             (96000, 201, 128): (2, True), (100, 2, 64): (1, True),
             (40, 2049, 704): (176, False), (5000, 513, 256): (8, False)}
    for (rows, n_freqs, m_pad), (tiles, one_read) in cases.items():
        grid = tfused._dfb_grid(rows, n_freqs, m_pad)
        assert grid == tfused._dfb_grid(rows, n_freqs, m_pad)
        n, per, got_tiles, got_one_read = grid
        assert (got_tiles, got_one_read) == (tiles, one_read)
        assert per % 16 == 0 and 1 <= n <= 65535
        splits = [range(s * per, min(rows, (s + 1) * per)) for s in range(n)]
        assert all(len(r) > 0 for r in splits)
        assert [i for r in splits for i in r] == list(range(rows))
        if (rows, n_freqs, m_pad) in ((41216, 1025, 128), (39904, 257, 64)):
            assert n * tiles >= 264
