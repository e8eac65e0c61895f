"""Parity of the port's Emformer family (``models/emformer.py``:
``Emformer`` in both builds, ``ConvEmformer``, ``EmformerTranscriber``)
with the JAX package, on the CPU.

The JAX modules' parameters cross through ``utils.convert``; the same
numpy inputs go through the JAX function (under ``jax.jit``) and the
port.  Outputs are held to 1e-5 of peak.  Streaming is held inside the
port, as the JAX tests hold it (``tests/test_emformer.py``): chunkwise
``infer`` equals the one-shot ``forward`` at ``atol=2e-5``, with ragged
lengths and a short final chunk, and ``infer`` leaves the state it was
given as it was.  Toy widths: 2 layers, d 16–32, 2–4 heads.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.models.emformer import (
    ConvEmformer as JConvEmformer, Emformer as JEmformer,
    EmformerTranscriber as JTranscriber)
from torchaudio_contrib_tpu_torch.models import (ConvEmformer, Emformer,
                                                 EmformerTranscriber)
from torchaudio_contrib_tpu_torch.utils import emformer_from_jax_params
from torchaudio_contrib_tpu_torch.utils.convert import (
    _emformer_transcriber_sd)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

OUT = 1e-5
STREAM_ATOL = 2e-5
D, S, L, R = 16, 4, 3, 2

# name → (JAX class, port class, keyword arguments)
BUILDS = {
    "house": (JEmformer, Emformer,
              dict(max_memory_size=2, tanh_on_mem=True)),
    "house gelu, no memory": (JEmformer, Emformer,
                              dict(activation="gelu")),
    "compat": (JEmformer, Emformer,
               dict(activation="gelu", compat="torchaudio",
                    tanh_on_mem=True)),
    "compat, clipped memory": (JEmformer, Emformer,
                               dict(compat="torchaudio", max_memory_size=2)),
    "conv": (JConvEmformer, ConvEmformer,
             dict(max_memory_size=2, kernel_size=3, activation="silu")),
}


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _rel(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=list(BUILDS))
def pair(request):
    jcls, tcls, kw = BUILDS[request.param]
    jm = jcls(D, 2, 32, 2, S, left_context_length=L,
              right_context_length=R, **kw)
    params = jm.init(jax.random.PRNGKey(len(request.param)))
    tm = tcls(D, 2, 32, 2, S, left_context_length=L,
              right_context_length=R, **kw, device="cpu")
    tm.load_state_dict(emformer_from_jax_params(_np_tree(params)))
    return jm, params, tm.eval()


def _ragged(rng, lengths, T, d=D, r=R):
    x = rng.standard_normal((len(lengths), T + r, d)).astype(np.float32)
    for b, n in enumerate(lengths):
        if n < T:
            x[b, n:] = 0.0
    return x


def test_forward_matches_jax(pair, rng):
    """Ragged lengths and a length that is no segment multiple."""
    jm, params, tm = pair
    lengths = np.array([11, 11, 6])
    x = _ragged(rng, lengths, 11)
    want, wl = jax.jit(jm.apply)(params, jnp.asarray(x),
                                 jnp.asarray(lengths))
    got, gl = tm(torch.from_numpy(x), torch.from_numpy(lengths))
    assert _rel(got, want) <= OUT
    assert gl.tolist() == np.asarray(wl).tolist()


def _stream(model, x, lengths, T, S, R, stride=1):
    """Feed ``x (B, T+R, D)`` a segment a call; the stitched output."""
    B = x.shape[0]
    nseg = -(-T // S)
    ext = torch.nn.functional.pad(x, (0, 0, 0, nseg * S - T))
    ext_len = lengths + np.where(lengths == T, R, 0)
    state = model.init_state(B)
    outs = []
    for i in range(nseg):
        base, rc_start = i * S, min(i * S + S, T)
        chunk = torch.cat([ext[:, base:base + S],
                           ext[:, rc_start:rc_start + R]], 1)
        utt_len = np.clip(lengths - base, 0, S)
        o, ol, state = model.infer(chunk, state, torch.from_numpy(utt_len),
                                   torch.from_numpy(np.clip(
                                       ext_len - rc_start, 0, R)))
        assert ol.tolist() == (utt_len // stride).tolist()
        outs.append(o)
    return torch.cat(outs, 1), state


@pytest.mark.parametrize("lengths,T", [((11, 11, 6), 11), ((8, 3), 8)])
def test_streaming_equals_one_shot(pair, rng, lengths, T):
    """T = 11: the last chunk holds 3 of 4 frames; T = 8: full chunks and a
    sample that ends in the first."""
    _, _, tm = pair
    lengths = np.array(lengths)
    x = torch.from_numpy(_ragged(rng, lengths, T))
    with torch.no_grad():
        full, _ = tm(x, torch.from_numpy(lengths))
        streamed, _ = _stream(tm, x, lengths, T, S, R)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(streamed[b, :n].numpy(),
                                   full[b, :n].numpy(), atol=STREAM_ATOL)


def test_infer_matches_jax_and_leaves_its_state(pair, rng):
    """Two steps of the port's ``infer`` against the JAX package's, and a
    replay of the second step from the same state: the same output, and
    the state's tensors unchanged."""
    jm, params, tm = pair
    x = rng.standard_normal((2, 2 * (S + R), D)).astype(np.float32)
    jstate, tstate = jm.init_state(2), tm.init_state(2)
    utt_len = np.array([S, S - 1])
    infer = jax.jit(jm.infer)
    for i in range(2):
        chunk = x[:, i * (S + R):(i + 1) * (S + R)]
        want, _, jstate = infer(params, jnp.asarray(chunk), jstate,
                                jnp.asarray(utt_len))
        before = jax.tree_util.tree_map(
            lambda a: a.clone() if torch.is_tensor(a) else a, tstate)
        with torch.no_grad():
            got, _, new = tm.infer(torch.from_numpy(chunk), tstate,
                                   torch.from_numpy(utt_len))
            again, _, _ = tm.infer(torch.from_numpy(chunk), tstate,
                                   torch.from_numpy(utt_len))
        assert _rel(got, want) <= OUT
        assert torch.equal(got, again)
        for a, b in zip(jax.tree_util.tree_leaves(before),
                        jax.tree_util.tree_leaves(tstate)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        tstate = new
    assert tstate["seg"].tolist() == [2, 2]
    assert tstate["seen"].tolist() == (2 * utt_len).tolist()


# the transcriber at stride 2: segment 4 and right context 2 input frames
TCFG = dict(input_dim=6, output_dim=20, segment_length=4,
            right_context_length=2, time_reduction_input_dim=8,
            time_reduction_stride=2, num_heads=2, ffn_dim=24, num_layers=2,
            left_context_length=3)


@pytest.fixture(scope="module")
def transcriber():
    jm = JTranscriber(**TCFG)
    params = jm.init(jax.random.PRNGKey(7))
    tm = EmformerTranscriber(**TCFG, device="cpu")
    tm.load_state_dict(_emformer_transcriber_sd(_np_tree(params)))
    return jm, params, tm.eval()


def test_transcriber_matches_jax_and_streams(transcriber, rng):
    jm, params, tm = transcriber
    T = 12                               # input frames, a stride multiple
    lengths = np.array([12, 8])
    x = _ragged(rng, lengths, T, d=6, r=2)
    want, wl = jax.jit(jm.apply)(params, jnp.asarray(x),
                                 jnp.asarray(lengths))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got, gl = tm(xt, torch.from_numpy(lengths))
        streamed, _ = _stream(tm, xt, lengths, T, 4, 2, stride=2)
    assert _rel(got, want) <= OUT
    assert gl.tolist() == np.asarray(wl).tolist() == [6, 4]
    for b, n in enumerate(lengths // 2):
        np.testing.assert_allclose(streamed[b, :n].numpy(),
                                   got[b, :n].numpy(), atol=STREAM_ATOL)


def test_checks_its_arguments(transcriber):
    _, _, tm = transcriber
    with pytest.raises(ValueError, match="multiple of the time-reduction"):
        tm(torch.zeros((1, 11 + 2, 6)))
    with pytest.raises(ValueError, match="chunk must have 6"):
        tm.infer(torch.zeros((1, 5, 6)), tm.init_state(1))
    with pytest.raises(ValueError, match="divisible by"):
        EmformerTranscriber(**{**TCFG, "segment_length": 5}, device="cpu")
    with pytest.raises(ValueError):
        Emformer(15, 2, 8, 1, 4, device="cpu")
    with pytest.raises(ValueError):
        Emformer(16, 2, 8, 1, 4, compat="keras", device="cpu")
    with pytest.raises(ValueError):
        ConvEmformer(16, 2, 8, 1, 4, kernel_size=0, device="cpu")
