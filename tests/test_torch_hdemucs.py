"""Parity of the port's Hybrid Demucs models (``models/hdemucs_ta.py``,
torchaudio's layout; ``models/hdemucs.py``, the JAX package's redesign)
with the JAX package's, on the CPU, at toy widths.

``HDemucsTA`` runs at nfft 256 and depth 4 with ``dconv_lstm`` and
``dconv_attn`` at 2, so the BiLSTM and LocalState sit in the last
frequency layer and in the time layer, and ``lstm_max_steps`` 6 forces
the framed BiLSTM; ``HDemucs`` at nfft 64, depth 2 and two shared layers
with an attention window of 3 steps.  Random JAX parameters (drawn with
NumPy into ``jax.eval_shape(init)``) go through ``utils.convert``; the
``HDemucsTA`` ``state_dict`` (torchaudio's names) goes through the JAX
``import_hdemucs`` the other way.  Bars: waveforms 1e-4 abs and 1e-5 of
peak; gradients within 1e-4 of the whole gradient's peak of
``jax.grad``'s.  Two traps are pinned: the house model's GELU is the tanh
form (the exact one misses the bar) and the normalized STFT at nfft 4096
/ hop 1024 with its Nyquist row and edge frames restored as zeros agrees
with the JAX ``ops.stft``/``ops.istft``.  The JAX references run under
``jax.jit``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.models import factories as jfactories
from torchaudio_contrib_tpu.models.hdemucs import HDemucs as JHDemucs
from torchaudio_contrib_tpu.models.hdemucs_ta import HDemucsTA as JHDemucsTA
from torchaudio_contrib_tpu.utils.import_torch import import_hdemucs
from torchaudio_contrib_tpu_torch import models as M
from torchaudio_contrib_tpu_torch.models import hdemucs as thdemucs
from torchaudio_contrib_tpu_torch.utils import (
    hdemucs_from_jax_params, hdemucs_from_torch_state_dict,
    hdemucs_ta_from_jax_params)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

ABS = 1e-4
PEAK = 1e-5
GRAD = 1e-4
TA = dict(sources=("a", "b"), audio_channels=2, channels=4, nfft=256,
          depth=4, norm_starts=2, dconv_lstm=2, dconv_attn=2,
          lstm_max_steps=6, attn_heads=2, attn_ndecay=2)
HOUSE = dict(sources=("a", "b"), audio_channels=2, channels=4, depth=2,
             shared_depth=2, nfft=64, attn_window=3)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _params(jm, seed, scale=0.2):
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(scale * rng.standard_normal(s.shape)
                              .astype(np.float32)), shapes)


def _err(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def _check(got, want):
    err, peak = _err(got, want)
    assert err <= ABS and err <= PEAK * peak, (err, peak)


def _check_grads(tm, want):
    """Port gradients against the JAX gradient carried by the converter;
    an LSTM's ``bias_hh`` (zero in the conversion) has ``bias_ih``'s."""
    peak = max(float(v.abs().max()) for v in want.values())
    for name, p in tm.named_parameters():
        ref = want[name.replace("bias_hh", "bias_ih")]
        err = float((p.grad - ref).abs().max())
        assert err <= GRAD * peak, (name, err, peak)


@pytest.fixture(scope="module")
def ta():
    jm = JHDemucsTA(**TA)
    params = _params(jm, 1)
    tm = M.HDemucsTA(**TA, device="cpu")
    tm.load_state_dict(hdemucs_ta_from_jax_params(_np_tree(params)))
    return jm, params, jax.jit(jm.apply), tm


@pytest.fixture(scope="module")
def house():
    jm = JHDemucs(**HOUSE)
    params = _params(jm, 2, 0.3)
    tm = M.HDemucs(**HOUSE, device="cpu")
    tm.load_state_dict(hdemucs_from_jax_params(_np_tree(params)))
    return jm, params, jax.jit(jm.apply), tm


def test_ta_layout_reaches_every_branch(ta):
    jm, _, _, tm = ta
    assert [s["freq"] for s in tm.enc_specs] == [True, True, True, False]
    assert [s["lstm"] for s in tm.enc_specs] == [False, False, True, True]
    assert tm.tenc_specs[-1]["empty"] and len(tm.tencoder) == 3
    assert tm.enc_specs == jm.enc_specs and tm.dec_specs == jm.dec_specs


@pytest.mark.parametrize("t", [1100, 777])
def test_ta_forward_matches_jax(ta, t):
    """``T`` not a multiple of the hop; the BiLSTM framed (18 and 13
    frames > 6 steps)."""
    _, params, apply, tm = ta
    x = np.random.default_rng(t).standard_normal((2, 2, t)).astype(
        np.float32)
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 2, 2, t)
    _check(got, apply(params, jnp.asarray(x)))


def test_ta_state_dict_loads_into_jax(ta):
    jm, _, apply, _ = ta
    own = M.HDemucsTA(**TA, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    x = np.random.default_rng(4).standard_normal((1, 2, 900)).astype(
        np.float32)
    _check(own(torch.from_numpy(x)),
           apply(import_hdemucs(own.state_dict(), jm), jnp.asarray(x)))
    sd = hdemucs_from_torch_state_dict(own.state_dict(), own)
    assert all(torch.equal(sd[k], v) for k, v in own.state_dict().items())
    with pytest.raises(ValueError, match="HDemucsTA"):
        hdemucs_from_torch_state_dict(own.state_dict(),
                                      M.HDemucs(**HOUSE, device="cpu"))


def test_ta_gradients_match_jax(ta):
    jm, params, _, tm = ta
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 2, 700)).astype(np.float32)
    w = rng.standard_normal((1, 2, 2, 700)).astype(np.float32)
    jg = jax.jit(jax.grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * w)))(params)
    tm.zero_grad()
    (tm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    _check_grads(tm, hdemucs_ta_from_jax_params(_np_tree(jg)))


@pytest.mark.parametrize("t", [500, 256])
def test_house_forward_matches_jax(house, t):
    _, params, apply, tm = house
    x = np.random.default_rng(t).standard_normal((2, 2, t)).astype(
        np.float32)
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 2, 2, t)
    _check(got, apply(params, jnp.asarray(x)))


def test_house_gradients_match_jax(house):
    jm, params, _, tm = house
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 2, 300)).astype(np.float32)
    w = rng.standard_normal((1, 2, 2, 300)).astype(np.float32)
    jg = jax.jit(jax.grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * w)))(params)
    tm.zero_grad()
    (tm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    _check_grads(tm, hdemucs_from_jax_params(_np_tree(jg)))


def test_house_gelu_is_the_tanh_form(house, monkeypatch):
    """``jax.nn.gelu`` defaults to the tanh approximation: the exact GELU
    in its place misses the bar more than tenfold."""
    _, params, apply, tm = house
    x = np.random.default_rng(7).standard_normal((1, 2, 500)).astype(
        np.float32)
    want = apply(params, jnp.asarray(x))
    _check(tm(torch.from_numpy(x)), want)
    monkeypatch.setattr(thdemucs, "_gelu", torch.nn.functional.gelu)
    err, peak = _err(tm(torch.from_numpy(x)), want)
    assert err > 10 * PEAK * peak, (err, peak)


def test_normalized_stft_at_4096_matches_jax():
    """``HDemucsTA``'s spectral plumbing at the HIGH bundle's nfft 4096
    (hop 1024, reflect pre-pad, ``normalized=True``), and its inverse with
    the Nyquist row and the edge frames restored as zeros."""
    cfg = dict(nfft=4096, depth=1, channels=4)
    jm, tm = JHDemucsTA(**cfg), M.HDemucsTA(**cfg, device="cpu")
    x = np.random.default_rng(8).standard_normal((1, 2, 9000)).astype(
        np.float32)
    want = jax.jit(jm._spec)(jnp.asarray(x))
    got = tm._spec(torch.from_numpy(x))
    assert got.shape == tuple(want.shape) == (1, 2, 2048, 9)
    for part in ("real", "imag"):
        _check(getattr(got, part), getattr(want, part))
    _check(tm._ispec(got, 9000),
           jax.jit(jm._ispec, static_argnums=1)(want, 9000))


@pytest.mark.parametrize("name", ["hdemucs_low", "hdemucs_medium",
                                  "hdemucs_high"])
@pytest.mark.parametrize("compat", [None, "torchaudio"])
def test_factory_geometry_on_meta(name, compat):
    jm = getattr(jfactories, name)(compat=compat)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    conv = (hdemucs_ta_from_jax_params if compat
            else hdemucs_from_jax_params)
    want = conv(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    tm = getattr(M, name)(compat=compat, device="meta")
    assert type(tm).__name__ == type(jm).__name__
    assert {n: tuple(v.shape) for n, v in tm.state_dict().items()} \
        == {n: tuple(v.shape) for n, v in want.items()}


def test_istft_drops_the_edge_bins_imaginary_parts():
    """A model's spectrum need not have real DC and Nyquist bins: the
    inverse uses their real parts alone (cuFFT's ``irfft`` would not drop
    the rest; the CPU's does), as the JAX ``istft``."""
    from torchaudio_contrib_tpu import ops as jops
    from torchaudio_contrib_tpu_torch import ops as tops
    from torchaudio_contrib_tpu_torch.ops.stft import _real_edges
    rng = np.random.default_rng(9)
    z = (rng.standard_normal((2, 129, 12))
         + 1j * rng.standard_normal((2, 129, 12))).astype(np.complex64)
    edges = _real_edges(torch.from_numpy(z).transpose(-1, -2), 256)
    assert not edges.imag[..., 0].any() and not edges.imag[..., -1].any()
    assert torch.equal(edges.imag[..., 1:-1],
                       torch.from_numpy(z.imag).transpose(-1, -2)[..., 1:-1])
    got = tops.istft(torch.from_numpy(z), 64, window="hann")
    want = jops.istft(jnp.asarray(z), 64, window="hann")
    _check(got, want)
