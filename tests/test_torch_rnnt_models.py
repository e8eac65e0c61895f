"""Parity of the port's transducer models (``models/rnnt.py``,
``models/factories.py``, ``pipelines``) with the JAX package, and of the
slice as a whole, on the CPU.

Three builds at toy widths (2 layers, d 16–32, vocabulary 11–13): the
house Emformer-RNNT, the torchaudio-layout Emformer-RNNT and the
Conformer-RNNT.  The JAX models' parameters cross through
``utils.convert``; the compat build's ``state_dict`` also crosses back
through the JAX package's own ``import_emformer_rnnt``.  Bars: predictors,
transcriptions and joint logits 1e-5 of peak; ``RNNT.loss`` 1e-5
relative, its gradients 1e-4 of the gradient's peak; greedy grids equal;
beams (the host path, the fixed-width path, the JAX package's) the same
n-best by sequence with scores within 1e-4.  The decoders are compared on
the JAX package's encodings carried across, so that an encoder's rounding
cannot hide a decoder fault.  Streaming is held inside the port: chunkwise
greedy and beam equal one-shot.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu import models as JM
from torchaudio_contrib_tpu import pipelines as jpipe
from torchaudio_contrib_tpu.models.rnnt import (
    LayerNormLSTMPredictor as JLNPredictor, RNNTPredictor as JPredictor)
from torchaudio_contrib_tpu.utils.import_torch import import_emformer_rnnt
from torchaudio_contrib_tpu_torch import models as M
from torchaudio_contrib_tpu_torch import pipelines as tpipe
from torchaudio_contrib_tpu_torch.utils import (
    conformer_rnnt_from_jax_params, emformer_rnnt_from_jax_params)
from torchaudio_contrib_tpu_torch.utils.convert import _predictor_sd

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

OUT = 1e-5
LOSS_REL = 1e-5
GRAD = 1e-4
SCORE_ATOL = 1e-4

EMF = dict(num_heads=2, ffn_dim=24, num_layers=2, left_context_length=3,
           predictor_embed_dim=10, predictor_hidden_dim=12,
           predictor_layers=2)
BUILDS = {
    # the JAX package's own stack: 16-wide Emformer, memory bank 2
    "house": dict(input_dim=16, num_symbols=11, segment_length=4,
                  right_context_length=2, max_memory_size=2,
                  joiner_dim=20, **EMF),
    # torchaudio's layout at stride 2 (segment 4, right context 2 input
    # frames), layer-norm LSTM predictor with eps 1e-3
    "compat": dict(input_dim=6, encoding_dim=20, num_symbols=13,
                   segment_length=4, right_context_length=2,
                   max_memory_size=0, time_reduction_input_dim=8,
                   time_reduction_stride=2, lstm_layer_norm=True,
                   lstm_layer_norm_epsilon=1e-3, **EMF),
    "conformer": dict(input_dim=6, encoding_dim=20, time_reduction_stride=2,
                      conformer_input_dim=16, conformer_ffn_dim=32,
                      conformer_num_layers=2, conformer_num_heads=2,
                      conformer_depthwise_conv_kernel_size=5,
                      num_symbols=11, symbol_embedding_dim=10,
                      num_lstm_layers=2, lstm_hidden_dim=12),
}


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _build(name):
    cfg = BUILDS[name]
    if name == "conformer":
        jm = JM.conformer_rnnt_model(**cfg)
        params = jm.init(jax.random.PRNGKey(3))
        tm = M.conformer_rnnt_model(**cfg, device="cpu")
        tm.load_state_dict(conformer_rnnt_from_jax_params(_np_tree(params)))
        return jm, params, tm.eval()
    jm = JM.emformer_rnnt_model(**cfg)
    params = jm.init(jax.random.PRNGKey(len(name)))
    if name == "compat":
        # torchaudio's layout has no enc_proj: the JAX model carries the
        # identity, as import_emformer_rnnt gives it
        d = cfg["encoding_dim"]
        params["enc_proj"] = {"w": jnp.eye(d), "b": jnp.zeros((d,))}
    tm = M.emformer_rnnt_model(**cfg, device="cpu")
    tm.load_state_dict(emformer_rnnt_from_jax_params(_np_tree(params)))
    return jm, params, tm.eval()


@pytest.fixture(scope="module", params=list(BUILDS))
def built(request):
    """(name, JAX model, params, port model, x, lengths, the JAX
    package's encodings and their lengths)."""
    name = request.param
    jm, params, tm = _build(name)
    x, lengths = _inputs(np.random.default_rng(len(name)), name)
    enc, out_len = jax.jit(jm.transcribe)(params, jnp.asarray(x),
                                          jnp.asarray(lengths))
    return name, jm, params, tm, x, lengths, np.array(enc), np.array(out_len)


@pytest.fixture(scope="module")
def compat():
    return _build("compat")


def _inputs(rng, name, B=2):
    """(x, lengths) in the build's input units: 16 frames (+ the right
    context for the Emformers), the second sample ragged."""
    cfg = BUILDS[name]
    R = cfg.get("right_context_length", 0) if name != "conformer" else 0
    lengths = np.array([16, 10][:B] + [12] * (B - 2))
    x = rng.standard_normal((B, 16 + R, cfg["input_dim"])).astype(np.float32)
    for b, n in enumerate(lengths):
        x[b, n:16] = 0.0
    return x, lengths


def _targets(rng, V, B=2, U=5):
    tg = rng.integers(1, V, (B, U)).astype(np.int32)
    tl = np.array([U, U - 2][:B] + [3] * (B - 2), np.int32)
    return tg, tl


# ---- predictors ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lstm", "layer norm", "no layer norm"])
def test_predictors_match_jax(rng, kind):
    """``forward`` over a label sequence and ``step`` by step."""
    if kind == "lstm":
        jp = JPredictor(9, 6, 8, 10, num_layers=2)
        tp = M.RNNTPredictor(9, 6, 8, 10, num_layers=2, device="cpu")
    else:
        ln = kind == "layer norm"
        jp = JLNPredictor(9, 6, 8, 10, num_layers=2, layer_norm=ln,
                          layer_norm_eps=1e-3)
        tp = M.LayerNormLSTMPredictor(9, 6, 8, 10, num_layers=2,
                                      layer_norm=ln, layer_norm_eps=1e-3,
                                      device="cpu")
    p = jp.init(jax.random.PRNGKey(int(rng.integers(1 << 20))))
    if kind == "no layer norm":          # a bias that is not zero
        for lp in p["layers"]:
            lp["bx"] = 0.5 * jax.random.normal(jax.random.PRNGKey(1),
                                               lp["bx"].shape)
    sd = {}
    _predictor_sd(sd, _np_tree(p))
    tp.load_state_dict({k[len("predictor."):]: v for k, v in sd.items()})
    tg = rng.integers(1, 9, (3, 6))
    assert _rel(tp(torch.from_numpy(tg)),
                jax.jit(jp.apply)(p, jnp.asarray(tg, jnp.int32))) <= OUT
    jstate, tstate = jp.init_state(3), tp.init_state(3)
    for u in range(3):
        want, jstate = jp.step(p, jnp.asarray(tg[:, u], jnp.int32), jstate)
        got, tstate = tp.step(torch.from_numpy(tg[:, u]), tstate)
        assert _rel(got, want) <= OUT


# ---- the models ------------------------------------------------------------

def test_joint_logits_match_jax(built, rng):
    name, jm, params, tm, x, lengths, jenc, _ = built
    tg, tl = _targets(rng, BUILDS[name]["num_symbols"])
    want, wl = jax.jit(jm.joint_logits)(params, jnp.asarray(x),
                                        jnp.asarray(tg),
                                        jnp.asarray(lengths), jnp.asarray(tl))
    got, gl = tm(torch.from_numpy(x), torch.from_numpy(tg),
                 torch.from_numpy(lengths), torch.from_numpy(tl))
    assert _rel(got, want) <= OUT
    assert gl.tolist() == np.asarray(wl).tolist()
    enc, _ = tm.transcribe(torch.from_numpy(x), torch.from_numpy(lengths))
    assert _rel(enc, jenc) <= OUT


def test_loss_and_gradients_match_jax(rng):
    """``RNNT.loss`` (the fused path) of the Conformer-RNNT and its
    gradient with respect to every parameter, carried back through the
    same converter."""
    name = "conformer"
    jm, params, tm = _build(name)
    x, lengths = _inputs(rng, name, B=3)
    tg, tl = _targets(rng, BUILDS[name]["num_symbols"], B=3)

    def jloss(p):
        return jm.loss(p, jnp.asarray(x), jnp.asarray(tg),
                       jnp.asarray(lengths), jnp.asarray(tl), time_chunk=3)

    want, grads = jax.jit(jax.value_and_grad(jloss))(params)
    loss = tm.loss(torch.from_numpy(x), torch.from_numpy(tg),
                   torch.from_numpy(lengths), torch.from_numpy(tl),
                   time_chunk=3)
    loss.backward()
    assert abs(loss.item() - float(want)) / abs(float(want)) <= LOSS_REL
    want_g = conformer_rnnt_from_jax_params(_np_tree(grads))
    got_g = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got_g) == set(want_g)
    peak = max(v.abs().max().item() for v in want_g.values())
    err = max((got_g[k] - want_g[k]).abs().max().item() for k in want_g)
    assert err / peak <= GRAD


def test_greedy_matches_jax(built):
    """The greedy frame loop on the JAX package's encodings (the same
    ``(B, T', max_symbols)`` grid); ``greedy_decode`` end to end gives its
    tokens."""
    _, jm, params, tm, x, lengths, enc, out_len = built
    want, _ = jm._greedy_on_enc(params, jnp.asarray(enc),
                                jnp.asarray(out_len), 3,
                                jm.greedy_init_state(params, 2))
    got, _ = tm._greedy_on_enc(torch.from_numpy(enc),
                               torch.from_numpy(out_len), 3,
                               tm.greedy_init_state(2))
    assert got.tolist() == np.asarray(want).tolist()
    assert tm.greedy_decode(torch.from_numpy(x), torch.from_numpy(lengths),
                            max_symbols=3) == [
        [t for t in row if t != 0]
        for row in np.asarray(want).reshape(2, -1).tolist()]


def _same_nbest(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [t for t, _ in g] == [t for t, _ in w], (g, w)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=SCORE_ATOL)


def test_beams_match_jax(built):
    """On the JAX package's encodings: the port's host beam = its
    fixed-width beam = the JAX package's host and fixed-width beams."""
    _, jm, params, tm, _, _, enc, out_len = built
    jsearch = JM.RNNTBeamSearch(jm, beam_width=3, max_symbols=2)
    tsearch = M.RNNTBeamSearch(tm, beam_width=3, max_symbols=2)
    want, _ = jsearch.infer(params, enc, out_len,
                            jsearch.init_state(params, 2))
    want_b, _ = jsearch.infer_batched(
        params, enc, out_len,
        jsearch.init_batched_state(params, 2, 2 * enc.shape[1]))
    te, tl = torch.from_numpy(enc), torch.from_numpy(out_len)
    got, _ = tsearch.infer(te, tl, tsearch.init_state(2))
    got_b, _ = tsearch.infer_batched(
        te, tl, tsearch.init_batched_state(2, 2 * enc.shape[1]))
    _same_nbest(want_b, want)
    _same_nbest(got, want)
    _same_nbest(got_b, want)


# ---- streaming (the torchaudio-layout Emformer-RNNT) ------------------------

def _chunks(x, lengths, T, S, R):
    """(chunk, utt_lengths, rc_lengths) a segment, in input units."""
    nseg = -(-T // S)
    ext = torch.nn.functional.pad(x, (0, 0, 0, nseg * S - T))
    ext_len = lengths + np.where(lengths == T, R, 0)
    for i in range(nseg):
        base, rc = i * S, min(i * S + S, T)
        yield (torch.cat([ext[:, base:base + S], ext[:, rc:rc + R]], 1),
               torch.from_numpy(np.clip(lengths - base, 0, S)),
               torch.from_numpy(np.clip(ext_len - rc, 0, R)))


def test_streaming_equals_one_shot(compat, rng):
    """Greedy and the fixed-width beam fed a segment a call (the last one
    short) equal their one-shot runs; the host beam's streaming path
    equals its one-shot call."""
    _, _, tm = compat
    T, S, R = 12, 4, 2
    lengths = np.array([12, 6])
    x = torch.from_numpy(
        rng.standard_normal((2, T + R, 6)).astype(np.float32))
    x[1, 6:T] = 0.0
    lt = torch.from_numpy(lengths)
    search = M.RNNTBeamSearch(tm, beam_width=3, max_symbols=2)
    grid = tm.greedy_decode(x, lt, max_symbols=3, compact=False)
    beam = search.decode_batched(x, lt, max_tokens=2 * T // 2)
    host = search(x, lt)
    state = tm.init_stream_state(2)
    carry = search.init_batched_state(2, 2 * T // 2)
    host_state = search.init_state(2)
    grids, enc_state = [], tm.transcriber.init_state(2)
    for chunk, ul, rl in _chunks(x, lengths, T, S, R):
        g, _, state = tm.stream_greedy_step(chunk, state, max_symbols=3,
                                            utt_lengths=ul, rc_lengths=rl)
        grids.append(g)
        with torch.no_grad():
            feats, ol, enc_state = tm.stream_transcribe(
                chunk, enc_state, utt_lengths=ul, rc_lengths=rl)
        streamed, carry = search.infer_batched(feats, ol, carry)
        streamed_host, host_state = search.infer(feats, ol, host_state)
    assert torch.equal(torch.cat(grids, 1)[:, :grid.shape[1]], grid)
    _same_nbest(streamed, beam)
    _same_nbest(streamed_host, host)


def test_compat_state_dict_loads_into_jax(compat, rng):
    """The port's torchaudio-named ``state_dict`` through the JAX
    package's own importer: the same joint logits."""
    jm, _, _ = compat
    own = M.emformer_rnnt_model(**BUILDS["compat"], device="cpu",
                                generator=torch.Generator().manual_seed(5))
    own.eval()
    params = import_emformer_rnnt(own.state_dict(), jm)
    x, lengths = _inputs(rng, "compat")
    tg, tl = _targets(rng, BUILDS["compat"]["num_symbols"])
    want, _ = jax.jit(jm.joint_logits)(params, jnp.asarray(x),
                                       jnp.asarray(tg), jnp.asarray(lengths),
                                       jnp.asarray(tl))
    got, _ = own(torch.from_numpy(x), torch.from_numpy(tg),
                 torch.from_numpy(lengths), torch.from_numpy(tl))
    assert _rel(got, want) <= OUT


def test_compat_converter_rejects_a_projection(compat):
    jm, params, _ = compat
    p = _np_tree(params)
    p["enc_proj"]["w"] = p["enc_proj"]["w"] * 2.0
    with pytest.raises(ValueError, match="no enc_proj"):
        emformer_rnnt_from_jax_params(p)


def test_models_check_their_arguments():
    with pytest.raises(ValueError, match="tanh or relu"):
        M.RNNT(M.Conformer(4, 8, 1, 2, conv_kernel=3, device="cpu"), 5, 8,
               joiner_activation="gelu", device="cpu")
    with pytest.raises(ValueError, match="encoding_dim"):
        M.emformer_rnnt_model(input_dim=8, encoding_dim=16, num_symbols=5,
                              segment_length=4, right_context_length=0,
                              device="cpu")
    with pytest.raises(ValueError, match="time_reduction_input_dim"):
        M.emformer_rnnt_model(input_dim=8, num_symbols=5, segment_length=4,
                              right_context_length=0,
                              time_reduction_stride=2, device="cpu")
    conf = M.conformer_rnnt_model(**BUILDS["conformer"], device="cpu")
    with pytest.raises(TypeError, match="init_state"):
        conf.init_stream_state(1)


# ---- factories and the bundle at full geometry ------------------------------

def _n_jax(model):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        shapes))


def _n(model):
    return sum(p.numel() for p in model.parameters())


def test_factories_have_the_jax_geometry():
    """The published configurations: parameter counts equal the JAX
    package's, but for what the layouts add or drop: ``nn.LSTM``'s second
    bias (2 layers × 4 · 512) in the house build, the JAX model's 1024 ×
    1024 ``enc_proj`` in the torchaudio-layout build."""
    assert _n(M.conformer_rnnt_base(device="cpu")) \
        == _n_jax(JM.conformer_rnnt_base())
    assert _n(M.emformer_rnnt_base(device="cpu")) \
        == _n_jax(JM.emformer_rnnt_base()) + 2 * 4 * 512


def test_bundle_weights_and_features(rng, tmp_path):
    bundle = tpipe.EMFORMER_RNNT_BASE_LIBRISPEECH
    with pytest.raises(ValueError, match="generator"):
        bundle.get_model(device="cpu")
    # checkpoint= reads a JAX parameter file (tests/test_torch_w2v2_bundles.py
    # loads one into this bundle's class); a missing file raises
    with pytest.raises(FileNotFoundError):
        bundle.get_model(checkpoint=str(tmp_path / "none.npz"),
                         device="cpu")
    model = bundle.get_model(torch.Generator().manual_seed(1), device="cpu")
    enc_proj = 1024 * 1024 + 1024
    assert _n(model) == _n_jax(JM.emformer_rnnt_base(
        compat="torchaudio")) - enc_proj == 76738049
    sd = model.state_dict()
    torch.save(sd, tmp_path / "rnnt.pt")
    again = bundle.get_model(torch_checkpoint=str(tmp_path / "rnnt.pt"),
                             device="cpu")
    assert all(torch.equal(v, sd[k]) for k, v in again.state_dict().items())
    assert isinstance(bundle.get_decoder(model), M.RNNTBeamSearch)

    wave = rng.standard_normal((2, 16000)).astype(np.float32) * 0.1
    wave[1, 8000:] = 0.0                 # silence: the x / e branch
    want = jpipe.EMFORMER_RNNT_BASE_LIBRISPEECH.get_feature_extractor()(
        jnp.asarray(wave))
    got = bundle.get_feature_extractor(device="cpu")(torch.from_numpy(wave))
    assert got.shape == (2, 101, 80)
    assert _rel(got, want) <= OUT
