"""Parity of the port's room acoustics (``ops/rir.py``:
``simulate_rir_ism``; ``ops/raytrace.py``: ``ray_tracing``) with the JAX
package, on the CPU.

The image-source responses are held to ``F32`` (1e-5 of the reference's
peak) against the JAX package and against the float64 per-image loop of
``tests/test_rir.py``; the ray-traced histograms to ``F32`` against the
JAX package (the geometry is elementwise on both sides, so every ray takes
the same bins; only the order of the histogram's sums differs).  The
physical properties of ``tests/test_rir.py`` and ``tests/test_raytrace.py``
run on the port's side.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torchaudio_contrib_tpu as tac
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import raytrace as trt
from test_rir import _oracle

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

F32 = 1e-5
C = 343.0
ROOM = np.array([6.0, 5.0, 4.0])
SRC = np.array([1.0, 2.5, 2.0])


def _cpu(a):
    """``a`` as a CPU tensor: the port computes on the device of
    ``mic_array`` when it is a tensor (a list goes to the card)."""
    return torch.as_tensor(np.asarray(a, np.float64))


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


# ---- simulate_rir_ism ----------------------------------------------------------

def _jax_rir(room, src, mics, **kw):
    """The JAX package's responses as one compiled program (op by op it
    compiles each of its ops, seconds a call)."""
    return jax.jit(lambda m: tac.simulate_rir_ism(room, src, m, **kw))(
        jnp.asarray(mics, jnp.float32))


@pytest.mark.parametrize("max_order,absorption", [
    (0, 0.9), (1, 0.2), (3, [0.1, 0.2, 0.3, 0.05, 0.4, 0.25])])
def test_rir_matches_jax_and_loop_oracle(max_order, absorption):
    """Against the JAX package to F32 of peak; against the float64 loop
    (orders 0 and 1, as ``tests/test_rir.py``) to its bar, 1e-5 absolute
    on a 0.03 peak."""
    room, src = [4.0, 5.0, 3.0], [1.0, 2.0, 1.5]
    mics = [[2.5, 3.5, 1.2], [3.0, 1.0, 2.0]]
    kw = dict(max_order=max_order, absorption=absorption,
              output_length=1200, delay_filter_length=41)
    got = tops.simulate_rir_ism(room, src, _cpu(mics), **kw)
    assert got.shape == (2, 1200) and got.dtype == torch.float32
    assert _rel(got, _jax_rir(room, src, mics, **kw)) <= F32
    if max_order <= 1:
        ref = _oracle(room, src, mics, max_order, absorption, 1200, 41)
        assert np.abs(got.numpy() - ref).max() <= 1e-5


def test_rir_default_length_and_tensor_mics_match_jax():
    """The default length (the host's bound on the farthest image) and the
    device taken from a tensor ``mic_array``."""
    mics = torch.tensor([[3.0, 1.0, 2.0]])
    got = tops.simulate_rir_ism([4.0, 3.0, 2.5], [1.0, 1.5, 1.0], mics,
                                max_order=2)
    assert got.device.type == "cpu"
    want = _jax_rir([4.0, 3.0, 2.5], [1.0, 1.5, 1.0], mics.numpy(),
                    max_order=2)
    assert _rel(got, want) <= F32


def test_rir_direct_path_and_validation():
    d = 100.0 * C / 16000.0
    rir = tops.simulate_rir_ism([10.0, 10.0, 10.0], [1.0, 1.0, 1.0],
                                _cpu([[1.0 + d, 1.0, 1.0]]), max_order=0,
                                absorption=0.9, output_length=400)[0]
    assert int(rir.argmax()) == 100
    assert abs(float(rir.max()) - 1 / (4 * np.pi * d)) <= 1e-4
    kw = dict(max_order=1)
    for bad in (dict(absorption=[0.1] * 7), dict(absorption=1.0),
                dict(delay_filter_length=80)):
        with pytest.raises(ValueError):
            tops.simulate_rir_ism([4.0, 3.0, 2.5], [1.0, 1.5, 1.0],
                                  _cpu([[3.0, 1.0, 1.8]]), **{**kw, **bad})
    with pytest.raises(ValueError, match="max_order"):
        tops.simulate_rir_ism([4.0, 3.0, 2.5], [1.0, 1.5, 1.0],
                              _cpu([[3.0, 1.0, 1.8]]), max_order=-1)


def test_rir_symmetry_and_reverb_composition():
    rir = tops.simulate_rir_ism([4.0, 4.0, 4.0], [2.0, 2.0, 2.0],
                                _cpu([[1.0, 2.0, 2.0], [3.0, 2.0, 2.0]]),
                                max_order=2, output_length=2000,
                                delay_filter_length=41)
    assert (rir[0] - rir[1]).abs().max() <= 1e-5
    dry = torch.from_numpy(np.random.default_rng(0).standard_normal(4000)
                           .astype(np.float32))
    wet = tops.fftconvolve(dry[None], rir[:1])
    assert wet.shape == (1, 5999) and float((wet[0, 4000:] ** 2).sum()) > 0


# ---- ray_tracing ---------------------------------------------------------------

RT_CASES = [
    ("two_mics_walls_absorb", dict(mic_array=[[2.0, 2.5, 2.0],
                                              [4.0, 2.5, 2.0]],
                                   absorption=1.0, mic_radius=0.25)),
    ("bands_scattering", dict(mic_array=[[4.0, 1.5, 1.0], [2.0, 4.0, 3.0]],
                              absorption=np.array([[0.1] * 6, [0.5] * 6,
                                                   [0.1, 0.9, 0.3, 0.3, 0.6,
                                                    0.2]]),
                              scattering=0.4)),
]


@pytest.mark.parametrize("name,kw", RT_CASES, ids=[c[0] for c in RT_CASES])
def test_ray_tracing_matches_jax(name, kw):
    common = dict(num_rays=2000, time_thres=0.08, hist_bin_size=0.001)
    got = tops.ray_tracing(ROOM, SRC, **common,
                           **{**kw, "mic_array": _cpu(kw["mic_array"])})
    want = tac.ray_tracing(ROOM, SRC, **common, **kw)
    assert got.shape == np.asarray(want).shape
    assert float(got.sum()) > 0
    assert _rel(got, want) <= F32


def test_ray_tracing_physics():
    """Direct path only under fully absorbing walls; the inverse-square law
    from ray statistics; less late energy with more absorption."""
    mic = _cpu([4.0, 2.5, 2.0])
    kw = dict(time_thres=0.08, hist_bin_size=0.001)
    h = tops.ray_tracing(ROOM, SRC, mic, 20000, absorption=1.0, **kw)
    bin_expect = int(np.linalg.norm(mic.numpy() - SRC) / (C * 0.001))
    nz = set(np.nonzero(h[0, 0].numpy())[0])
    assert nz and nz <= {bin_expect, bin_expect + 1}
    mics = _cpu([[2.0, 2.5, 2.0], [5.0, 2.5, 2.0]])
    e = tops.ray_tracing(ROOM, SRC, mics, 80000, absorption=1.0,
                         mic_radius=0.25, **kw).sum(dim=(1, 2))
    assert 16 * 0.7 < float(e[0] / e[1]) < 16 * 1.3
    live = tops.ray_tracing(ROOM, SRC, mic, 20000, absorption=0.1, **kw)
    dead = tops.ray_tracing(ROOM, SRC, mic, 20000, absorption=0.7, **kw)
    assert dead[0, 0, bin_expect + 2:].sum() < live[0, 0, bin_expect + 2:].sum()


def test_ray_tracing_validates():
    mic = _cpu([1.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="inside"):
        tops.ray_tracing(ROOM, [7.0, 1.0, 1.0], mic, 10)
    with pytest.raises(ValueError, match="scattering"):
        tops.ray_tracing(ROOM, SRC, mic, 10, scattering=1.0)
    with pytest.raises(ValueError, match="absorption"):
        tops.ray_tracing(ROOM, SRC, mic, 10, absorption=np.zeros((2, 5)))
    with pytest.raises(ValueError, match="num_rays"):
        tops.ray_tracing(ROOM, SRC, mic, 0)


def test_fibonacci_sphere_matches_jax():
    from torchaudio_contrib_tpu.ops import raytrace as jrt
    np.testing.assert_array_equal(trt._fibonacci_sphere(101),
                                  jrt._fibonacci_sphere(101))
    assert jnp.allclose(jnp.linalg.norm(trt._fibonacci_sphere(64), axis=1),
                        1.0)
