"""MFCC, LFCC, the DCT basis and the linear filterbank: the port vs the
JAX package on the same numpy inputs.

Values are held to 1e-5 of the peak coefficient and waveform gradients
(``jax.grad`` of a fixed cotangent's inner product) to 1e-4 of the peak
gradient, the bar of the fused op's own gradient tests.  With
``use_fused=True`` the port's CPU path is the fused op's plain version
(autograd of the chain); the JAX package's is its chain and custom VJP.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu import ops as jops
from torchaudio_contrib_tpu_torch import ops as tops

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("n_mfcc,n_input,norm", [(20, 128, "ortho"),
                                                 (13, 40, None),
                                                 (1, 1, "ortho")])
def test_create_dct_matches_jax(n_mfcc, n_input, norm):
    got = tops.create_dct(n_mfcc, n_input, norm)
    want = np.asarray(jops.create_dct(n_mfcc, n_input, norm))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert tops.create_dct(4, 8, dtype=torch.float64).dtype == torch.float64
    with pytest.raises(ValueError, match="norm"):
        tops.create_dct(4, 8, "bogus")


@pytest.mark.parametrize("args", [(128, 22050, 0.0, None, 1025),
                                  (40, 16000, 100.0, 7000.0, 257),
                                  (3, 8000, 0.0, None, 9)])
def test_create_linear_filter_matches_jax(args):
    got = tops.create_linear_filter(*args)
    want = np.asarray(jops.create_linear_filter(*args))
    assert tuple(got.shape) == want.shape == (args[4], args[0])
    np.testing.assert_array_equal(got.numpy(), want)


# name, port fn, JAX fn, count kwarg, filter-count kwarg
FNS = [("mfcc", tops.mfcc, jops.mfcc, "n_mfcc", "num_mels"),
       ("lfcc", tops.lfcc, jops.lfcc, "n_lfcc", "n_filter")]


@pytest.mark.parametrize("name,tfn,jfn,n_kw,f_kw", FNS,
                         ids=[f[0] for f in FNS])
@pytest.mark.parametrize("use_fused,kw", [
    (False, {}),
    (False, {"top_db": 60.0, "center": False}),
    (True, {}),
    (True, {"precision": "split6", "center": False}),
])
def test_cepstra_match_jax(rng, name, tfn, jfn, n_kw, f_kw, use_fused, kw):
    """Values and waveform gradients, (2, 1, 6000) at 16 kHz, fft 512,
    hop 160, 13 coefficients over 40 filters."""
    x = rng.standard_normal((2, 1, 6000)).astype(np.float32)
    args = dict(sample_rate=16000, fft_length=512, hop_length=160,
                use_fused=use_fused, **{n_kw: 13, f_kw: 40}, **kw)
    def fn(v):
        return jfn(v, **args)

    shape = jax.eval_shape(fn, jax.ShapeDtypeStruct(x.shape, jnp.float32))
    g = rng.standard_normal(shape.shape).astype(np.float32)
    # one jitted program for value and gradient: ~5x cheaper than eager
    want, want_dx = map(np.asarray, jax.jit(lambda v, gv: (
        fn(v), jax.grad(lambda u: jnp.sum(fn(u) * gv))(v)))(
            jnp.asarray(x), jnp.asarray(g)))

    xt = torch.from_numpy(x).requires_grad_()
    got = tfn(xt, **args)
    (got * torch.from_numpy(g)).sum().backward()
    assert tuple(got.shape) == want.shape
    assert _rel(got.detach(), want) <= VALUE_TOL
    assert _rel(xt.grad, want_dx) <= GRAD_TOL


@pytest.mark.parametrize("tfn", [tops.mfcc, tops.lfcc])
def test_engine_rules(tfn):
    x = torch.zeros((1, 4096))
    with pytest.raises(ValueError, match="top_db"):
        tfn(x, use_fused=True, top_db=80.0)
    with pytest.raises(ValueError, match="use_fused=True"):
        tfn(x, precision="split3")
