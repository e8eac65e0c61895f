"""Parity of the port's Tacotron2 (``models/tacotron2.py``) with the JAX
package's, on the CPU, at a toy width.

Random JAX parameters (no bias or BatchNorm affine at its initial
value) go through ``utils.convert.tacotron2_from_jax_params``
into the port's module in eval mode; the port's own ``state_dict`` goes
through the JAX package's ``import_tacotron2`` the other way.  Bars, all
relative to the peak of what is compared: teacher-forced ``apply``'s four
outputs and ``infer``'s five 1e-4 (``infer``'s lengths equal); a clip's
valid outputs alone and inside a padded batch 1e-5; the gradient of a
teacher-forced L1 loss against ``jax.grad`` 1e-4 of the whole gradient's
peak.  The JAX references run under ``jax.jit``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.models.tacotron2 import Tacotron2 as JTacotron2
from torchaudio_contrib_tpu.utils.import_torch import import_tacotron2
from torchaudio_contrib_tpu_torch.models import Tacotron2
from torchaudio_contrib_tpu_torch.utils import tacotron2_from_jax_params

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

OUT = 1e-4
PAD = 1e-5
GRAD = 1e-4

TOY = dict(n_symbols=12, n_mels=8, embed_dim=16, encoder_dim=16,
           attention_dim=8, attention_filters=4, attention_kernel=5,
           decoder_dim=16, prenet_dim=8, postnet_dim=16)
TOKENS = (3, 7)          # batch, symbols
FRAMES = 10
STEPS = 12


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _params(jm, seed, scale=0.3):
    """Random parameters in the JAX model's tree, drawn with NumPy into
    ``jax.eval_shape(jm.init)`` (the JAX ``init`` run eagerly costs
    seconds to tens of seconds on the CPU): no bias and no BatchNorm
    affine at its initial value."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(scale * rng.standard_normal(s.shape)
                              .astype(np.float32)), shapes)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its perturbed params, jitted apply, jitted infer, the
    port's module carrying the same weights)."""
    jm = JTacotron2(**TOY)
    params = _params(jm, 1)
    tm = Tacotron2(**TOY, device="cpu").eval()
    tm.load_state_dict(tacotron2_from_jax_params(_np_tree(params)))
    apply = jax.jit(jm.apply)
    infer = jax.jit(jm.infer, static_argnums=(3,))
    return jm, params, apply, infer, tm


def _inputs(rng):
    tokens = rng.integers(1, TOY["n_symbols"], TOKENS)
    lengths = np.array([TOKENS[1], 4, 1])
    mels = rng.standard_normal((TOKENS[0], TOY["n_mels"], FRAMES)) \
        .astype(np.float32)
    return tokens, lengths, mels


def test_apply_matches_jax(rng, pair):
    jm, params, apply, _, tm = pair
    tokens, lengths, mels = _inputs(rng)
    want = apply(params, jnp.asarray(tokens), jnp.asarray(lengths),
                 jnp.asarray(mels))
    got = tm.apply(torch.from_numpy(tokens), torch.from_numpy(lengths),
                   torch.from_numpy(mels))
    assert [tuple(g.shape) for g in got] == [
        (3, 8, FRAMES), (3, 8, FRAMES), (3, FRAMES), (3, FRAMES, 7)]
    for g, w in zip(got, want):
        assert _rel(g, w) <= OUT
    # a clip's alignments sum to 1 over its own tokens, 0 past them
    ali = got[3].detach()
    assert torch.allclose(ali.sum(-1), torch.ones(3, FRAMES), atol=1e-5)
    assert float(ali[1, :, 4:].abs().max()) == 0.0


def test_infer_matches_jax(rng, pair):
    """``max_steps=12``: the five outputs, with the stop bias moved so
    that the clips stop at different steps inside the horizon."""
    jm, params, _, infer, tm = pair
    tokens, lengths, _ = _inputs(rng)
    args = (jnp.asarray(tokens), jnp.asarray(lengths))
    stop = np.asarray(infer(params, *args, STEPS)[2])
    params = dict(params)
    params["stop"] = {"w": params["stop"]["w"],
                      "b": params["stop"]["b"] - float(np.median(stop))}
    want = infer(params, *args, STEPS)
    tm = Tacotron2(**TOY, device="cpu").eval()
    tm.load_state_dict(tacotron2_from_jax_params(_np_tree(params)))
    got = tm.infer(torch.from_numpy(tokens), torch.from_numpy(lengths),
                   max_steps=STEPS)
    for g, w in zip(got[:4], want[:4]):
        assert _rel(g, w) <= OUT
    assert got[4].tolist() == np.asarray(want[4]).tolist()
    assert len(set(got[4].tolist())) > 1 or got[4].max() < STEPS


def test_valid_outputs_do_not_depend_on_padding(rng, pair):
    *_, tm = pair
    tokens, lengths, mels = _inputs(rng)
    with torch.no_grad():
        batch = tm(torch.from_numpy(tokens), torch.from_numpy(lengths),
                   torch.from_numpy(mels))
        n = int(lengths[1])
        alone = tm(torch.from_numpy(tokens[1:2, :n]),
                   torch.from_numpy(lengths[1:2]),
                   torch.from_numpy(mels[1:2]))
    for i, (b, a) in enumerate(zip(batch, alone)):
        b = b[1:2, ..., :n] if i == 3 else b[1:2]
        assert _rel(b, a) <= PAD


def test_gradient_matches_jax(rng, pair):
    """d/dθ of mean|postnet − target| + mean|mel − target| (teacher
    forced): the JAX gradient carried into the port's names by the same
    converter; each LSTM's ``bias_hh`` gets the summed bias's gradient."""
    jm, params, _, _, tm = pair
    tokens, lengths, mels = _inputs(rng)
    target = rng.standard_normal(mels.shape).astype(np.float32)

    def loss(p):
        mel, post, _, _ = jm.apply(p, jnp.asarray(tokens),
                                   jnp.asarray(lengths), jnp.asarray(mels))
        return (jnp.abs(post - target).mean()
                + jnp.abs(mel - target).mean())

    want = tacotron2_from_jax_params(_np_tree(jax.jit(jax.grad(loss))(
        params)))
    tm.zero_grad()
    mel, post, _, _ = tm(torch.from_numpy(tokens), torch.from_numpy(lengths),
                         torch.from_numpy(mels))
    t = torch.from_numpy(target)
    ((post - t).abs().mean() + (mel - t).abs().mean()).backward()
    # the stop projection is not in the loss: no gradient (JAX's zeros)
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in tm.named_parameters()}
    assert set(got) == {n for n in want if "running" not in n
                        and "num_batches" not in n}
    for n in got:
        if "bias_hh" in n:
            want[n] = want[n.replace("bias_hh", "bias_ih")]
    peak = max(float(w.abs().max()) for n, w in want.items() if n in got)
    err = max(float((got[n] - want[n]).abs().max()) for n in got)
    assert err <= GRAD * peak, (err, peak)


def test_jax_importer_loads_the_port_weights(rng, pair):
    jm, _, apply, _, _ = pair
    tm = Tacotron2(**TOY, device="cpu",
                   generator=torch.Generator().manual_seed(5)).eval()
    params = import_tacotron2(tm.state_dict(), jm)
    tokens, lengths, mels = _inputs(rng)
    want = apply(params, jnp.asarray(tokens), jnp.asarray(lengths),
                 jnp.asarray(mels))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens), torch.from_numpy(lengths),
                 torch.from_numpy(mels))
    for g, w in zip(got, want):
        assert _rel(g, w) <= OUT


def test_published_geometry_on_meta():
    """The default widths: the JAX model's parameter count (≈28 M) and
    every parameter's shape, without building either at full size."""
    jm = JTacotron2()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    sd = tacotron2_from_jax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    tm = Tacotron2(device="meta")
    want = {n: tuple(v.shape) for n, v in sd.items()}
    assert {n: tuple(v.shape) for n, v in tm.state_dict().items()} == want
    n = sum(p.numel() for p in tm.parameters())
    assert 27e6 < n < 29e6
