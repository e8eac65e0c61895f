"""Parity of the port's CTC path (``ops/ctcloss.py``, ``ops/align.py``,
``ops/edit.py``, ``ops/ctcdecode.py``) with the JAX package, on the CPU.

Bars: loss values 1e-5 relative; gradients with respect to ``log_probs``
1e-4 of the JAX gradient's peak (normalised and un-normalised inputs:
the JAX package's gradient is the true ``d loss / d log_probs``, which
``torch.nn.functional.ctc_loss``'s backward is not); alignment paths,
edit distances, greedy and beam tokens equal; frame and beam scores
within 1e-5.  The JAX references run under ``jax.jit`` at short lengths.
"""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

import torchaudio_contrib_tpu as tac
from torchaudio_contrib_tpu_torch import ops as tops

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

REL = 1e-5
GRAD = 1e-4


def _emissions(rng, b, t, c, normalised=True, scale=2.0):
    x = scale * rng.standard_normal((b, t, c))
    if normalised:
        x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return x.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# name: (batch, time, classes, L, input_lengths, target_lengths, blank);
# targets never hold the blank
CTC_CASES = {
    "full lengths": (2, 24, 6, 5, None, None, 0),
    "ragged": (3, 30, 7, 6, [30, 22, 13], [6, 3, 1], 0),
    "blank last": (2, 20, 5, 4, [20, 17], [4, 2], 4),
    "blank -1": (2, 20, 5, 4, [20, 15], [3, 4], -1),
    "repeats": (2, 26, 4, 6, [26, 26], [6, 5], 0),
    "infeasible and empty": (3, 12, 5, 6, [12, 4, 9], [6, 5, 0], 0),
}


def _ctc_inputs(rng, name, normalised=True):
    b, t, c, L, il, tl, blank = CTC_CASES[name]
    lp = _emissions(rng, b, t, c, normalised)
    blank_idx = blank % c
    tg = rng.integers(0, c - 1, (b, L))
    tg = np.where(tg >= blank_idx, tg + 1, tg)
    if name == "repeats":
        tg[:, 1::2] = tg[:, ::2][:, :tg[:, 1::2].shape[1]]
    return lp, tg, il, tl, blank


@functools.lru_cache(maxsize=None)
def _jax_ctc(reduction, zero_infinity, blank):
    return jax.jit(lambda lp, tg, il, tl: tac.ops.ctc_loss(
        lp, tg, il, tl, blank=blank, reduction=reduction,
        zero_infinity=zero_infinity))


def _lens(lengths, b, full):
    return np.full((b,), full) if lengths is None else np.asarray(lengths)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("name", list(CTC_CASES))
def test_ctc_loss_values_match_jax(rng, name, reduction):
    lp, tg, il, tl, blank = _ctc_inputs(rng, name)
    b, t = lp.shape[:2]
    il_, tl_ = _lens(il, b, t), _lens(tl, b, tg.shape[1])
    for zi in (False, True):
        want = np.asarray(_jax_ctc(reduction, zi, blank)(
            lp, tg, il_, tl_))
        got = tops.ctc_loss(_t(lp), _t(tg), il and _t(il_),
                            tl and _t(tl_), blank=blank,
                            reduction=reduction, zero_infinity=zi)
        np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=0)
    if name == "infeasible and empty":
        none = tops.ctc_loss(_t(lp), _t(tg), _t(il_), _t(tl_),
                             reduction="none")
        assert float(none[1]) >= 0.5e30          # ~1e30, not inf
        assert float(tops.ctc_loss(_t(lp), _t(tg), _t(il_), _t(tl_),
                                   reduction="none",
                                   zero_infinity=True)[1]) == 0.0


@pytest.mark.parametrize("normalised", [True, False])
@pytest.mark.parametrize("name", ["ragged", "blank last", "repeats",
                                  "infeasible and empty"])
def test_ctc_loss_gradient_matches_jax(rng, name, normalised):
    lp, tg, il, tl, blank = _ctc_inputs(rng, name, normalised)
    b, t = lp.shape[:2]
    il_, tl_ = _lens(il, b, t), _lens(tl, b, tg.shape[1])
    zi = name == "infeasible and empty"
    loss = _jax_ctc("mean", zi, blank)
    want = np.asarray(jax.jit(jax.grad(loss))(lp, tg, il_, tl_))
    x = _t(lp).requires_grad_(True)
    tops.ctc_loss(x, _t(tg), _t(il_), _t(tl_), blank=blank,
                  zero_infinity=zi).backward()
    err = np.abs(x.grad.numpy() - want).max() / np.abs(want).max()
    assert err <= GRAD, err


def test_ctc_gradient_is_not_torch_native_on_unnormalised_inputs(rng):
    """On log-probs that are not normalised, torch's own ``ctc_loss``
    backward (softmax − occupancy, right only through a ``log_softmax``)
    is far from the true gradient that the port and the JAX package
    give; its values agree."""
    lp, tg, il, tl, blank = _ctc_inputs(rng, "ragged", normalised=False)
    x = _t(lp).requires_grad_(True)
    tops.ctc_loss(x, _t(tg), _t(il), _t(tl), reduction="sum").backward()
    y = _t(lp).requires_grad_(True)
    native = F.ctc_loss(y.transpose(0, 1), _t(tg), _t(il), _t(tl),
                        reduction="sum")
    native.backward()
    want = np.asarray(jax.grad(_jax_ctc("sum", False, 0))(
        lp, tg, np.asarray(il), np.asarray(tl)))
    assert np.abs(x.grad.numpy() - want).max() <= GRAD * np.abs(want).max()
    assert np.abs(y.grad.numpy() - want).max() > 0.1 * np.abs(want).max()
    torch.testing.assert_close(
        tops.ctc_loss(_t(lp), _t(tg), _t(il), _t(tl), reduction="sum"),
        native.detach(), rtol=REL, atol=0)


# ---- forced alignment --------------------------------------------------

@pytest.mark.parametrize("name", ["full lengths", "ragged", "blank last",
                                  "repeats"])
def test_forced_align_matches_jax(rng, name):
    lp, tg, il, tl, blank = _ctc_inputs(rng, name)
    b, t = lp.shape[:2]
    il_, tl_ = _lens(il, b, t), _lens(tl, b, tg.shape[1])
    blank_idx = blank % lp.shape[-1]
    ja, js = jax.jit(lambda *a: tac.ops.forced_align(*a, blank=blank_idx))(
        lp, tg, il_, tl_)
    ta, ts = tops.forced_align(_t(lp), _t(tg), _t(il_), _t(tl_),
                               blank=blank_idx)
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5)
    for i in range(b):
        got = tops.merge_tokens(ta[i], ts[i], blank=blank_idx)
        want = tac.ops.merge_tokens(np.asarray(ja[i]), np.asarray(js[i]),
                                    blank=blank_idx)
        assert [(s.token, s.start, s.end) for s in got] \
            == [(s.token, s.start, s.end) for s in want]
        np.testing.assert_allclose([s.score for s in got],
                                   [s.score for s in want], atol=1e-5)
        assert got == [tops.TokenSpan(s.token, s.start, s.end, s.score)
                       for s in want]
        toks = [s.token for s in got]
        assert toks == [int(v) for v in tg[i, :tl_[i]]]


def test_merge_tokens_rejects_batches():
    with pytest.raises(ValueError):
        tops.merge_tokens(torch.zeros((2, 5)), torch.zeros((2, 5)))


# ---- edit distance ------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_edit_distance_batched_matches_jax(seed):
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (6, 9))
    hyps = rng.integers(0, 4, (6, 7))
    rl = np.array([9, 0, 5, 3, 9, 1])
    hl = np.array([7, 4, 0, 0, 2, 7])
    want = np.asarray(jax.jit(tac.ops.edit_distance_batched)(
        refs, hyps, rl, hl))
    got = tops.edit_distance_batched(_t(refs), _t(hyps), _t(rl), _t(hl))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    full = tops.edit_distance_batched(_t(refs), _t(hyps))
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(tac.ops.edit_distance_batched(refs, hyps)))
    for i in range(6):
        assert int(got[i]) == tac.ops.edit_distance(
            refs[i, :rl[i]].tolist(), hyps[i, :hl[i]].tolist())


@pytest.mark.parametrize("a,b", [("kitten", "sitting"), ("", "abc"),
                                 ("abc", ""), ("", ""),
                                 ("the cat sat".split(),
                                  "the cat sat down".split())])
def test_edit_distance_host_matches_jax(a, b):
    assert tops.edit_distance(a, b) == tac.ops.edit_distance(a, b)


# ---- decoders -----------------------------------------------------------

def test_greedy_decode_matches_jax(rng):
    lp = _emissions(rng, 4, 40, 6)
    lp[0, 10:20] = lp[0, 10:11]               # repeats to collapse
    il = np.array([40, 31, 7, 0])
    jt, jl, js = jax.jit(tac.ops.ctc_greedy_decode)(lp, il)
    tt, tl, ts = tops.ctc_greedy_decode(_t(lp), _t(il))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=REL,
                               atol=1e-6)


def _finite_slots_equal(got, want):
    """Tokens and lengths equal and scores within 1e-5 on the slots of
    finite score (unused slots carry -inf, whose order may differ)."""
    (tt, tl, ts), (jt, jl, js) = got, [np.asarray(a) for a in want]
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts.numpy()), fin)
    np.testing.assert_array_equal(tl.numpy()[fin], jl[fin])
    np.testing.assert_array_equal(tt.numpy()[fin], jt[fin])
    np.testing.assert_allclose(ts.numpy()[fin], js[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize("beam,blank,max_tokens", [(4, 0, None), (8, 0, None),
                                                   (6, 5, 5)])
def test_beam_decode_matches_jax(rng, beam, blank, max_tokens):
    lp = _emissions(rng, 3, 18, 6)
    il = np.array([18, 11, 3])
    want = tac.ops.ctc_beam_decode(lp, il, beam_width=beam, blank=blank,
                                   max_tokens=max_tokens)
    got = tops.ctc_beam_decode(_t(lp), _t(il), beam_width=beam, blank=blank,
                               max_tokens=max_tokens)
    assert got[0].shape == np.asarray(want[0]).shape
    _finite_slots_equal(got, want)


@pytest.mark.parametrize("beam", [1, 3, 8])
def test_prefix_beam_search_matches_jax_and_device_beam(rng, beam):
    lp = _emissions(rng, 1, 15, 5)[0]
    want = tac.ops.ctc_prefix_beam_search(lp, beam_width=beam, nbest=beam)
    got = tops.ctc_prefix_beam_search(_t(lp), beam_width=beam, nbest=beam)
    assert [h.tokens for h in got] == [h.tokens for h in want]
    np.testing.assert_allclose([h.score for h in got],
                               [h.score for h in want], rtol=1e-12)
    tt, tl, ts = tops.ctc_beam_decode(_t(lp)[None], beam_width=beam)
    for k, h in enumerate(got):
        assert tt[0, k, :tl[0, k]].tolist() == h.tokens
        assert abs(float(ts[0, k]) - h.score) <= 1e-4
