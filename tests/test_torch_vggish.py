"""Parity of the port's VGGish (``models/vggish.py``: the model and its
input processor) with the JAX package's, on the CPU.

VGGish has no width to cut (its first linear takes the fixed 6·4·512
features), so the model runs at its one size on 2 patches.  Random JAX
parameters (drawn with NumPy into ``jax.eval_shape(init)``, scaled per
layer so the activations stay of order 1) go through
``utils.convert.vggish_from_jax_params``; the port's ``state_dict``
(``torchvggish`` names) goes through the JAX ``import_vggish`` the other
way.  Bars: embeddings 1e-4 abs and 1e-5 of peak; gradients within 1e-4
of the whole gradient's peak of ``jax.grad``'s; the processor's log-mel
patches 1e-4 abs (a float64 mel matrix on both sides).  The JAX
references run under ``jax.jit``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.models.vggish import (
    VGGish as JVGGish, VGGishInputProcessor as JProcessor)
from torchaudio_contrib_tpu.utils.import_torch import import_vggish
from torchaudio_contrib_tpu_torch import models as M
from torchaudio_contrib_tpu_torch.utils import (vggish_from_jax_params,
                                                vggish_from_torch_state_dict)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

ABS = 1e-4
PEAK = 1e-5
GRAD = 1e-4
LOGMEL_ATOL = 1e-4


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _params(seed):
    """He-scaled kernels (the activations stay of order 1 through the 9
    ReLU layers) and biases of 0.1."""
    shapes = jax.eval_shape(JVGGish().init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 0
        scale = np.sqrt(2.0 / fan_in) if fan_in else 0.1
        return jnp.asarray((scale * rng.standard_normal(s.shape))
                           .astype(np.float32))
    return jax.tree_util.tree_map(draw, shapes)


def _check(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= ABS and err <= PEAK * float(np.abs(want).max()), err


@pytest.fixture(scope="module")
def pair():
    jm = JVGGish()
    params = _params(1)
    tm = M.VGGish(device="cpu")
    tm.load_state_dict(vggish_from_jax_params(_np_tree(params)))
    return jm, params, tm


def test_model_matches_jax_both_ways(pair):
    """(N, 96, 64) and (N, 1, 96, 64) patches; the port's ``state_dict``
    through ``import_vggish`` gives the same embeddings."""
    jm, params, tm = pair
    x = np.random.default_rng(2).standard_normal((2, 96, 64)).astype(
        np.float32)
    apply = jax.jit(jm.apply)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        assert got.shape == (2, 128) and float(got.abs().max()) > 0.1
        _check(got, apply(params, jnp.asarray(x)))
        _check(tm(torch.from_numpy(x[:, None])),
               apply(import_vggish(tm.state_dict(), jm), jnp.asarray(x)))
    sd = vggish_from_torch_state_dict(tm.state_dict(), tm)
    assert all(torch.equal(sd[k], v) for k, v in tm.state_dict().items())
    with pytest.raises(ValueError, match="patches"):
        tm(torch.zeros(1, 95, 64))


def test_gradients_match_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 96, 64)).astype(np.float32)
    w = rng.standard_normal((1, 128)).astype(np.float32)
    jg = jax.jit(jax.grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * w)))(params)
    want = vggish_from_jax_params(_np_tree(jg))
    tm.zero_grad()
    (tm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    peak = max(float(v.abs().max()) for v in want.values())
    for name, p in tm.named_parameters():
        err = float((p.grad - want[name]).abs().max())
        assert err <= GRAD * peak, (name, err, peak)


@pytest.mark.parametrize("shape", [(16000,), (2, 33000), (15900,)])
def test_input_processor_matches_jax(shape):
    """Mono and stereo (averaged) 16 kHz waveforms: 1 + (T − 400) // 160
    frames, cut into whole 96-frame patches."""
    x = (0.3 * np.random.default_rng(len(shape)).standard_normal(shape)) \
        .astype(np.float32)
    got = M.VGGishInputProcessor()(torch.from_numpy(x))
    want = JProcessor()(jnp.asarray(x))
    frames = 1 + (shape[-1] - 400) // 160
    assert got.shape == tuple(want.shape) == (frames // 96, 96, 64)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) \
        <= LOGMEL_ATOL


def test_input_processor_rejects_short_input():
    proc = M.VGGishInputProcessor()
    with pytest.raises(ValueError, match="too short"):
        proc(torch.zeros(15000))
    with pytest.raises(ValueError, match="at least"):
        proc(torch.zeros(300))
