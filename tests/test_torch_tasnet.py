"""Parity of the port's ConvTasNet (``models/tasnet.py``) with the JAX
package's, on the CPU, at a toy width (X = R = 2: the dilations, the
residual paths and the last block's skip-only path all run).

Random JAX parameters (drawn with NumPy into ``jax.eval_shape(init)``, no
bias, norm or PReLU at its initial value) go through
``utils.convert.conv_tasnet_from_jax_params`` into the port; the port's
``state_dict`` (torchaudio's names) goes through the JAX package's
``import_conv_tasnet`` the other way.  Bars: separated waveforms 1e-4
abs and 1e-5 of peak; gradients of a weighted sum of the outputs within
1e-4 of the whole gradient's peak of ``jax.grad``'s; an SGD step on
negative SI-SNR (``ops.metrics.si_snr`` in both packages), losses 1e-5
relative.  The JAX references run under ``jax.jit``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torchaudio_contrib_tpu as tac
from torchaudio_contrib_tpu.models.tasnet import ConvTasNet as JConvTasNet
from torchaudio_contrib_tpu.utils.import_torch import import_conv_tasnet
from torchaudio_contrib_tpu_torch import models as M
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.utils import (
    conv_tasnet_from_jax_params, conv_tasnet_from_torch_state_dict)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

ABS = 1e-4
PEAK = 1e-5
GRAD = 1e-4
LOSS_REL = 1e-5
TOY = dict(num_sources=2, enc_kernel=8, enc_filters=16, bottleneck=8,
           hidden=12, tcn_kernel=3, num_blocks=2, num_repeats=2)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _params(jm, seed, scale=0.3):
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(scale * rng.standard_normal(s.shape)
                              .astype(np.float32)), shapes)


def _check(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= ABS and err <= PEAK * float(np.abs(want).max()), err


def _port(params):
    tm = M.ConvTasNet(**TOY, device="cpu")
    tm.load_state_dict(conv_tasnet_from_jax_params(_np_tree(params)))
    return tm


@pytest.fixture(scope="module")
def pair():
    jm = JConvTasNet(**TOY)
    return jm, _params(jm, 1), jax.jit(jm.apply)


@pytest.mark.parametrize("t", [203, 5, 64])
def test_forward_matches_jax(pair, t):
    """Any length: padded to a multiple of L/2 (at least L), cropped
    back."""
    jm, params, apply = pair
    x = np.random.default_rng(t).standard_normal((2, t)).astype(np.float32)
    got = _port(params)(torch.from_numpy(x))
    assert got.shape == (2, 2, t)
    _check(got, apply(params, jnp.asarray(x)))


def test_state_dict_loads_into_jax(pair):
    """The port's ``state_dict`` (torchaudio's names) through the JAX
    ``import_conv_tasnet`` gives the same separation; the torch-checkpoint
    path passes it through unchanged."""
    jm, _, apply = pair
    tm = M.ConvTasNet(**TOY, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    x = np.random.default_rng(4).standard_normal((1, 150)).astype(np.float32)
    _check(tm(torch.from_numpy(x)),
           apply(import_conv_tasnet(tm.state_dict(), jm), jnp.asarray(x)))
    sd = conv_tasnet_from_torch_state_dict(tm.state_dict(), tm)
    assert all(torch.equal(sd[k], v) for k, v in tm.state_dict().items())
    with pytest.raises(KeyError, match="res_out"):
        bad = dict(tm.state_dict())
        del bad["mask_generator.conv_layers.0.res_out.weight"]
        conv_tasnet_from_torch_state_dict(bad, tm)
    # the last block has the skip path only, as torchaudio's
    assert "mask_generator.conv_layers.3.res_out.weight" not in sd


def test_gradients_match_jax(pair):
    jm, params, _ = pair
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 120)).astype(np.float32)
    w = rng.standard_normal((2, 2, 120)).astype(np.float32)
    jg = jax.jit(jax.grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * w)))(params)
    want = conv_tasnet_from_jax_params(_np_tree(jg))
    tm = _port(params)
    (tm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    peak = max(float(v.abs().max()) for v in want.values())
    for name, p in tm.named_parameters():
        err = float((p.grad - want[name]).abs().max())
        assert err <= GRAD * peak, (name, err, peak)


def test_si_snr_step_matches_jax(pair):
    """One SGD step on negative SI-SNR against two planted sources: the
    loss and the updated separation agree."""
    jm, params, _ = pair
    rng = np.random.default_rng(6)
    src = rng.standard_normal((2, 2, 160)).astype(np.float32)
    mix = src.sum(1)
    lr = 1e-3

    def jloss(p):
        est = jm.apply(p, jnp.asarray(mix))
        return -jnp.mean(tac.ops.si_snr(est, jnp.asarray(src)))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    jnew = jax.tree_util.tree_map(lambda a, g: a - lr * g, params, jg)
    tm = _port(params)
    loss = -tops.si_snr(tm(torch.from_numpy(mix)),
                        torch.from_numpy(src)).mean()
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_REL * abs(float(jl))
    with torch.no_grad():
        for p in tm.parameters():
            p -= lr * p.grad
    _check(tm(torch.from_numpy(mix)), jm.apply(jnew, jnp.asarray(mix)))


def test_base_factory_geometry():
    """``conv_tasnet_base`` (N 512, L 16, B 128, H 512, P 3, X 8, R 3) has
    the JAX model's parameter shapes, carried by the converter."""
    shapes = jax.eval_shape(JConvTasNet().init, jax.random.PRNGKey(0))
    want = conv_tasnet_from_jax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    tm = M.conv_tasnet_base(device="meta")
    assert {n: tuple(v.shape) for n, v in tm.state_dict().items()} \
        == {n: tuple(v.shape) for n, v in want.items()}
    with pytest.raises(ValueError, match="even"):
        M.ConvTasNet(enc_kernel=5, device="cpu")
    with pytest.raises(ValueError, match="batch, time"):
        M.ConvTasNet(**TOY, device="cpu")(torch.zeros(1, 1, 40))
