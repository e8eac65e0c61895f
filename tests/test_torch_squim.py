"""Parity of the port's Squim models (``models/squim.py``: the house
``SquimObjective`` and ``SquimSubjective``, torchaudio's
``SquimObjectiveTA``) with the JAX package's, on the CPU, at toy widths
with 2 DPRNN blocks each.

Random JAX parameters (drawn with NumPy into ``jax.eval_shape(init)``)
go through ``utils.convert``; the TA model's ``state_dict`` (torchaudio's
names) goes through the JAX ``import_squim_objective`` the other way.
Bars: every output 1e-4 abs and 1e-5 of peak; gradients of a weighted
sum of the outputs within 1e-4 of the whole gradient's peak of
``jax.grad``'s.  Two traps are pinned: the house LSTMs' gates are i, f,
o, u in the JAX parameters (carried unpermuted into ``nn.LSTM``'s i, f,
g, o they miss the bar) and the house GELUs are the tanh form.  The JAX
references run under ``jax.jit``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.models import factories as jfactories
from torchaudio_contrib_tpu.models.squim import (
    SquimObjective as JObjective, SquimObjectiveTA as JObjectiveTA,
    SquimSubjective as JSubjective)
from torchaudio_contrib_tpu.utils.import_torch import import_squim_objective
from torchaudio_contrib_tpu_torch import models as M
from torchaudio_contrib_tpu_torch.models import squim as tsquim
from torchaudio_contrib_tpu_torch.utils import convert
from torchaudio_contrib_tpu_torch.utils import (
    squim_objective_from_jax_params, squim_objective_from_torch_state_dict,
    squim_objective_ta_from_jax_params, squim_subjective_from_jax_params)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

ABS = 1e-4
PEAK = 1e-5
GRAD = 1e-4
HOUSE = dict(d_model=8, enc_kernel=16, enc_stride=8, hidden=6, num_blocks=2,
             chunk=5)
TA = dict(feat_dim=8, win_len=16, d_model=8, nhead=2, hidden_dim=6,
          num_blocks=2, chunk_size=7)
CASES = {
    "objective": (JObjective, M.SquimObjective, HOUSE,
                  squim_objective_from_jax_params),
    "objective_ta": (JObjectiveTA, M.SquimObjectiveTA, TA,
                     squim_objective_ta_from_jax_params),
    "subjective": (JSubjective, M.SquimSubjective, HOUSE,
                   squim_subjective_from_jax_params),
}


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _params(jm, seed, scale=0.1):
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


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 700)).astype(np.float32),
            rng.standard_normal((2, 500)).astype(np.float32))


def _outs(name, out):
    return [out] if name == "subjective" else list(out)


@pytest.fixture(scope="module")
def pairs():
    made = {}
    for i, (name, (jcls, tcls, cfg, conv)) in enumerate(CASES.items()):
        jm = jcls(**cfg)
        params = _params(jm, i)
        tm = tcls(**cfg, device="cpu")
        tm.load_state_dict(conv(_np_tree(params)))
        made[name] = (jm, params, jax.jit(jm.apply), tm)
    return made


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(pairs, name):
    jm, params, apply, tm = pairs[name]
    x, r = _inputs(1)
    args = (x, r) if name == "subjective" else (x,)
    want = _outs(name, apply(params, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = _outs(name, tm(*map(torch.from_numpy, args)))
    assert len(got) == (1 if name == "subjective" else 3)
    for g, w in zip(got, want):
        assert g.shape == (2,)
        _check(g, w)
    # the outputs lie inside their ranges, away from saturation
    if name != "subjective":
        assert 0.0 < float(got[0].min()) and float(got[0].max()) < 1.0
        assert 1.0 < float(got[1].min()) and float(got[1].max()) < 4.5
    else:
        assert 1.0 < float(got[0].min()) and float(got[0].max()) < 5.0


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(pairs, name):
    jm, params, _, tm = pairs[name]
    x, r = _inputs(2)
    args = (x, r) if name == "subjective" else (x,)
    w = np.random.default_rng(3).standard_normal((3, 2)).astype(np.float32)

    def jloss(p):
        outs = _outs(name, jm.apply(p, *map(jnp.asarray, args)))
        return sum(jnp.sum(o * w[i]) for i, o in enumerate(outs))

    want = CASES[name][3](_np_tree(jax.jit(jax.grad(jloss))(params)))
    tm.zero_grad()
    outs = _outs(name, tm(*map(torch.from_numpy, args)))
    sum((o * torch.from_numpy(w[i])).sum() for i, o in enumerate(outs)) \
        .backward()
    peak = max(float(v.abs().max()) for v in want.values())
    for pname, p in tm.named_parameters():
        ref = want[pname.replace("bias_hh", "bias_ih")]
        err = float((p.grad - ref).abs().max())
        assert err <= GRAD * peak, (pname, err, peak)


def test_ta_state_dict_loads_into_jax(pairs):
    jm, _, apply, _ = pairs["objective_ta"]
    own = M.SquimObjectiveTA(**TA, device="cpu",
                             generator=torch.Generator().manual_seed(4))
    x, _ = _inputs(5)
    want = apply(import_squim_objective(own.state_dict(), jm),
                 jnp.asarray(x))
    for g, w in zip(own(torch.from_numpy(x)), want):
        _check(g, w)
    sd = squim_objective_from_torch_state_dict(own.state_dict(), own)
    assert all(torch.equal(sd[k], v) for k, v in own.state_dict().items())
    with pytest.raises(ValueError, match="SquimObjectiveTA"):
        squim_objective_from_torch_state_dict(
            own.state_dict(), M.SquimObjective(**HOUSE, device="cpu"))


def test_house_lstm_gates_are_permuted(pairs, monkeypatch):
    """The house LSTMs order their gates i, f, o, u: carried into
    ``nn.LSTM`` without the permutation, the model misses the bar."""
    jm, params, apply, _ = pairs["objective"]
    x, _ = _inputs(6)
    want = apply(params, jnp.asarray(x))
    monkeypatch.setattr(convert, "_gate_ifou_to_ifgo",
                        lambda w: np.asarray(w, np.float32))
    tm = M.SquimObjective(**HOUSE, device="cpu")
    tm.load_state_dict(squim_objective_from_jax_params(_np_tree(params)))
    errs = [_err(g, w) for g, w in zip(tm(torch.from_numpy(x)), want)]
    assert max(e / p for e, p in errs) > 10 * PEAK, errs


def test_house_gelu_is_the_tanh_form(pairs, monkeypatch):
    """At unit-scale weights (the GELUs see inputs of order 1), the exact
    GELU in place of the tanh form moves SI-SDR past the bar."""
    jm, _, apply, _ = pairs["objective"]
    params = _params(jm, 8, scale=1.0)
    tm = M.SquimObjective(**HOUSE, device="cpu")
    tm.load_state_dict(squim_objective_from_jax_params(_np_tree(params)))
    x, _ = _inputs(7)
    want = apply(params, jnp.asarray(x))[2]
    _check(tm(torch.from_numpy(x))[2], want)
    monkeypatch.setattr(tsquim, "_gelu", torch.nn.functional.gelu)
    err, peak = _err(tm(torch.from_numpy(x))[2], want)
    assert err > 10 * PEAK * peak, (err, peak)


@pytest.mark.parametrize("name,compat", [("squim_objective_base", None),
                                         ("squim_objective_base",
                                          "torchaudio"),
                                         ("squim_subjective_base", None)])
def test_factory_geometry(name, compat):
    kw = {} if compat is None else {"compat": compat}
    jm = getattr(jfactories, name)(**kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    conv = {"SquimObjective": squim_objective_from_jax_params,
            "SquimObjectiveTA": squim_objective_ta_from_jax_params,
            "SquimSubjective": squim_subjective_from_jax_params}[
                type(jm).__name__]
    want = conv(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    tm = getattr(M, name)(device="meta", **kw)
    assert type(tm).__name__ == type(jm).__name__
    assert {n: tuple(v.shape) for n, v in tm.state_dict().items()} \
        == {n: tuple(v.shape) for n, v in want.items()}
