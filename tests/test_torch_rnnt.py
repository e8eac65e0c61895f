"""Parity of the port's transducer loss (``ops/rnnt.py``: ``rnnt_loss``
on the lattice's anti-diagonals, ``rnnt_loss_fused`` with its
checkpointed chunks of the joint; ``models.transforms.RNNTLoss``) with the
JAX package, on the CPU.

Bars: values 1e-5 relative; gradients 1e-4 of the JAX gradient's peak
(float32 inputs).  A bfloat16 input is upcast on both sides, so its loss
keeps the float32 bar; its gradient comes back in bfloat16, held to one
bfloat16 step (2**-8) of peak.  ``clamp`` clips the logits' gradient:
the clamped gradient is the unclamped one clipped, exactly.  The JAX
references run under ``jax.jit`` at T <= 16, U <= 5, V <= 8.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torchaudio_contrib_tpu as tac
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.models import transforms as ttr

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

REL = 1e-5
GRAD = 1e-4
BF16_GRAD = 2.0 ** -8


def _t(a):
    return torch.from_numpy(np.asarray(a))


# name: (batch, T, U, V, logit_lengths, target_lengths, kwargs)
CASES = {
    "blank -1": (2, 9, 3, 6, None, None, {}),
    "blank 0, ragged": (3, 12, 4, 7, [12, 8, 5], [4, 2, 0], {"blank": 0}),
    "positive blank": (2, 10, 3, 5, [10, 7], [3, 3], {"blank": 2}),
    "clamp": (2, 10, 4, 6, [10, 9], [4, 3], {"clamp": 0.05}),
    "log-probs in": (2, 8, 3, 5, None, [3, 1],
                     {"fused_log_softmax": False}),
    "U = 0": (2, 7, 0, 4, [7, 5], None, {}),
    "sum": (2, 8, 3, 5, None, None, {"reduction": "sum"}),
    "none": (3, 8, 5, 8, [8, 6, 2], [5, 4, 3], {"reduction": "none"}),
}


def _inputs(rng, name):
    b, t, u, v, ll, tl, kw = CASES[name]
    logits = rng.standard_normal((b, t, u + 1, v)).astype(np.float32)
    if not kw.get("fused_log_softmax", True):
        logits = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    blank = kw.get("blank", -1) % v
    tg = rng.integers(0, v - 1, (b, u))
    tg = np.where(tg >= blank, tg + 1, tg)
    ll = np.full((b,), t) if ll is None else np.asarray(ll)
    tl = np.full((b,), u) if tl is None else np.asarray(tl)
    return logits, tg, ll, tl, kw


@functools.lru_cache(maxsize=None)
def _jax_loss(items):
    kw = dict(items)
    return jax.jit(lambda lg, tg, ll, tl: tac.ops.rnnt_loss(
        lg, tg, ll, tl, **kw))


def _jax_value_and_grad(logits, tg, ll, tl, kw):
    loss = _jax_loss(tuple(sorted(kw.items())))
    value = loss(logits, tg, ll, tl)
    grad = jax.grad(lambda lg: jnp.sum(loss(lg, tg, ll, tl)))(logits)
    return np.asarray(value), np.asarray(grad)


def _port_value_and_grad(logits, tg, ll, tl, kw):
    x = torch.tensor(logits).requires_grad_(True)
    value = tops.rnnt_loss(x, _t(tg), _t(ll), _t(tl), **kw)
    value.sum().backward()
    return value.detach(), x.grad


def _grad_err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_rnnt_loss_matches_jax(rng, name):
    logits, tg, ll, tl, kw = _inputs(rng, name)
    want, want_g = _jax_value_and_grad(logits, tg, ll, tl, kw)
    got, got_g = _port_value_and_grad(logits, tg, ll, tl, kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=0)
    assert _grad_err(got_g.numpy(), want_g) <= GRAD


def test_clamp_clips_the_gradient_exactly(rng):
    logits, tg, ll, tl, kw = _inputs(rng, "clamp")
    _, clamped = _port_value_and_grad(logits, tg, ll, tl, kw)
    _, free = _port_value_and_grad(logits, tg, ll, tl, {})
    c = kw["clamp"]
    assert float(free.abs().max()) > c          # the clamp bites
    assert torch.equal(clamped, free.clamp(-c, c))


def test_bfloat16_input_is_upcast(rng):
    logits, tg, ll, tl, _ = _inputs(rng, "blank 0, ragged")
    kw = {"blank": 0}
    lg16 = jnp.asarray(logits, jnp.bfloat16)
    loss = _jax_loss(tuple(sorted(kw.items())))
    want = np.asarray(loss(lg16, tg, ll, tl))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(loss(a, tg, ll, tl)))(
        lg16).astype(jnp.float32))
    x = torch.tensor(logits).bfloat16().requires_grad_(True)
    got = tops.rnnt_loss(x, _t(tg), _t(ll), _t(tl), **kw)
    assert got.dtype == torch.float32
    got.backward()
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=REL, atol=0)
    assert _grad_err(x.grad.float().numpy(), want_g) <= BF16_GRAD


def test_rnnt_loss_checks_shapes():
    with pytest.raises(ValueError):
        tops.rnnt_loss(torch.zeros((2, 3, 4, 5)), torch.zeros((2, 2)))
    with pytest.raises(ValueError):
        tops.rnnt_loss(torch.zeros((2, 3, 4, 5)), torch.zeros((2, 3)),
                       reduction="max")


# ---- the fused loss -----------------------------------------------------

def _fused_inputs(rng, b=3, t=11, u=4, j=8, v=6):
    enc = rng.standard_normal((b, t, j)).astype(np.float32)
    pred = rng.standard_normal((b, u + 1, j)).astype(np.float32)
    w = (rng.standard_normal((j, v)) / np.sqrt(j)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(v)).astype(np.float32)
    tg = rng.integers(0, v - 1, (b, u))
    ll = np.array([t, t - 3, 4][:b])
    tl = np.array([u, 2, 0][:b])
    return enc, pred, w, bias, tg, ll, tl


@pytest.mark.parametrize("time_chunk", [None, 4, 5, 11, 64])
@pytest.mark.parametrize("clamp", [-1.0, 0.05])
def test_fused_matches_unfused_and_jax(rng, time_chunk, clamp):
    """Against the port's ``rnnt_loss`` on the materialised joint (same
    values and gradients of enc, pred and the joiner), and against the
    JAX ``rnnt_loss_fused``; chunks of 4 and 5 do not divide T = 11."""
    enc, pred, w, bias, tg, ll, tl = _fused_inputs(rng)
    kw = dict(blank=-1, clamp=clamp, reduction="mean")
    leaves = [torch.tensor(a).requires_grad_(True)
              for a in (enc, pred, w, bias)]
    e, p, wt, bt = leaves
    fused = tops.rnnt_loss_fused(e, p, {"w": wt, "b": bt}, _t(tg),
                                 logit_lengths=_t(ll),
                                 target_lengths=_t(tl),
                                 time_chunk=time_chunk, **kw)
    fused.backward()
    got_g = [a.grad.clone() for a in leaves]
    leaves2 = [torch.tensor(a).requires_grad_(True)
               for a in (enc, pred, w, bias)]
    e, p, wt, bt = leaves2
    joint = torch.relu(e[:, :, None] + p[:, None]) @ wt + bt
    plain = tops.rnnt_loss(joint, _t(tg), _t(ll), _t(tl), **kw)
    plain.backward()
    np.testing.assert_allclose(fused.item(), plain.item(), rtol=REL)
    for g, h in zip(got_g, leaves2):
        assert _grad_err(g.numpy(), h.grad.numpy()) <= GRAD

    def jloss(enc, pred, w, bias):
        return tac.ops.rnnt_loss_fused(
            enc, pred, {"w": w, "b": bias}, tg, logit_lengths=ll,
            target_lengths=tl, time_chunk=time_chunk, **kw)

    want, want_g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))(
        enc, pred, w, bias)
    np.testing.assert_allclose(fused.item(), float(want), rtol=REL)
    for g, h in zip(got_g, want_g):
        assert _grad_err(g.numpy(), np.asarray(h)) <= GRAD


def test_fused_with_another_activation_and_reduction(rng):
    enc, pred, w, bias, tg, ll, tl = _fused_inputs(rng, b=2, t=9, u=3)
    got = tops.rnnt_loss_fused(_t(enc), _t(pred), {"w": _t(w), "b": _t(bias)},
                               _t(tg), act=torch.tanh, reduction="none",
                               time_chunk=4)
    want = tac.ops.rnnt_loss_fused(enc, pred, {"w": w, "b": bias}, tg,
                                   act=jnp.tanh, reduction="none",
                                   time_chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL)


# ---- the layer ----------------------------------------------------------

@pytest.mark.parametrize("name", ["blank 0, ragged", "clamp", "none"])
def test_rnnt_loss_layer_matches_jax(rng, name):
    logits, tg, ll, tl, kw = _inputs(rng, name)
    layer = ttr.RNNTLoss(**kw)
    want = np.asarray(tac.models.RNNTLoss(**kw)(jnp.asarray(logits), tg,
                                                ll, tl))
    got = layer(_t(logits), _t(tg), _t(ll), _t(tl))
    np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=0)
    assert list(layer.state_dict()) == []
