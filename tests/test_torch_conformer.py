"""Parity of the port's Conformer (``models/conformer.py``: ``Conformer``,
``ConformerTranscriber``) with the JAX package, on the CPU.

The JAX modules' parameters cross through ``utils.convert``; the same
numpy inputs go through the JAX function (under ``jax.jit``) and the
port, for both conv-module norms (``"layernorm"``, ``"affine"``) and both
block orders, with and without ``lengths``: outputs to 1e-5 of peak.
Dropout, which the JAX model drops, acts in training mode only.  Toy
widths: 2 layers, d 16, 2 heads.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.models.conformer import (
    Conformer as JConformer, ConformerTranscriber as JTranscriber)
from torchaudio_contrib_tpu_torch.models import (Conformer,
                                                 ConformerTranscriber)
from torchaudio_contrib_tpu_torch.utils import conformer_from_jax_params
from torchaudio_contrib_tpu_torch.utils.convert import (
    _conformer_transcriber_sd)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

OUT = 1e-5
CFG = dict(d_model=16, num_layers=2, num_heads=2, conv_kernel=5,
           max_distance=4)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _rel(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(conv_norm, convolution_first, seed, dropout=0.0):
    jm = JConformer(6, conv_norm=conv_norm,
                    convolution_first=convolution_first, **CFG)
    params = jm.init(jax.random.PRNGKey(seed))
    # a non-trivial norm, so that "affine" and the conv module's norm
    # weights are exercised away from their identity start
    for lp in params["layers"]:
        lp["conv"]["norm"] = {
            "g": 1.0 + 0.3 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                               (CFG["d_model"],)),
            "b": 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 2),
                                         (CFG["d_model"],))}
    tm = Conformer(6, conv_norm=conv_norm,
                   convolution_first=convolution_first, dropout=dropout,
                   **CFG, device="cpu")
    tm.load_state_dict(conformer_from_jax_params(_np_tree(params)))
    return jm, params, tm.eval()


@pytest.mark.parametrize("convolution_first", [False, True])
@pytest.mark.parametrize("conv_norm", ["layernorm", "affine"])
def test_conformer_matches_jax(rng, conv_norm, convolution_first):
    jm, params, tm = _pair(conv_norm, convolution_first,
                           int(rng.integers(1 << 20)))
    x = rng.standard_normal((3, 11, 6)).astype(np.float32)
    lengths = np.array([11, 4, 8])
    apply = jax.jit(jm.apply)
    want = apply(params, jnp.asarray(x), jnp.asarray(lengths))
    got = tm(torch.from_numpy(x), torch.from_numpy(lengths))
    assert _rel(got, want) <= OUT
    assert not got[1, 4:].any()
    assert _rel(tm(torch.from_numpy(x)), apply(params, jnp.asarray(x))) \
        <= OUT


def test_padding_does_not_reach_valid_frames(rng):
    """What lies past a sample's length changes none of its valid frames,
    and a sample of length 0 (every key masked: a uniform row, not NaN)
    stays finite."""
    _, _, tm = _pair("layernorm", False, 3)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    y = x.copy()
    y[0, 5:] = 100.0
    lengths = torch.tensor([5, 0])
    a = tm(torch.from_numpy(x), lengths)
    b = tm(torch.from_numpy(y), lengths)
    torch.testing.assert_close(a[0, :5], b[0, :5], rtol=0, atol=1e-6)
    assert torch.isfinite(a).all() and not a[1].any()


def test_dropout_acts_in_training_only(rng):
    jm, params, tm = _pair("layernorm", True, 5, dropout=0.3)
    x = torch.from_numpy(rng.standard_normal((2, 7, 6)).astype(np.float32))
    want = jax.jit(jm.apply)(params, jnp.asarray(x.numpy()))
    assert _rel(tm(x), want) <= OUT
    tm.train()
    torch.manual_seed(0)
    assert _rel(tm(x), want) > 1e-2


TCFG = dict(input_dim=5, output_dim=12, time_reduction_stride=3,
            conformer_input_dim=16, conformer_ffn_dim=32,
            conformer_num_layers=2, conformer_num_heads=2,
            conformer_depthwise_conv_kernel_size=5)


def test_transcriber_matches_jax(rng):
    """Frame stacking drops the remainder (T = 14 at stride 3 → 4 frames)
    and the lengths come back as ``lengths // 3``."""
    jm = JTranscriber(**TCFG)
    params = _np_tree(jm.init(jax.random.PRNGKey(11)))
    tm = ConformerTranscriber(**TCFG, device="cpu")
    tm.load_state_dict(_conformer_transcriber_sd(params))
    x = rng.standard_normal((2, 14, 5)).astype(np.float32)
    lengths = np.array([14, 9])
    want, wl = jax.jit(jm.apply)(params, jnp.asarray(x),
                                 jnp.asarray(lengths))
    got, gl = tm(torch.from_numpy(x), torch.from_numpy(lengths))
    assert _rel(got, want) <= OUT
    assert gl.tolist() == np.asarray(wl).tolist() == [4, 3]


def test_checks_its_arguments():
    with pytest.raises(ValueError, match="conv_norm"):
        Conformer(6, conv_norm="batchnorm", device="cpu")
    with pytest.raises(ValueError, match="odd"):
        Conformer(6, conv_kernel=4, device="cpu")
    with pytest.raises(ValueError):
        Conformer(6, d_model=15, num_heads=4, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        ConformerTranscriber(**{**TCFG, "conformer_ffn_dim": 20},
                             device="cpu")
    tm = ConformerTranscriber(**TCFG, device="cpu")
    with pytest.raises(ValueError, match="at least 3"):
        tm(torch.zeros((1, 2, 5)))
    with pytest.raises(ValueError):
        tm(torch.zeros((1, 9, 4)))
