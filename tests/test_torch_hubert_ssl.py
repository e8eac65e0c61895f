"""Parity of the port's SSL models (``models/hubert.py``,
``models/conformer_w2v2.py``, ``models/emformer_hubert.py`` and the
factories in ``models/factories.py``) with the JAX package, on the CPU.

``span_mask`` draws from a ``torch.Generator`` where the JAX package draws
from a key, so it is held by statistics (coverage against the closed form
and against the JAX sampler's) and by its length rule, exactly at
``mask_prob`` 0 and 1; model parity passes one explicit ``frame_mask`` to
both packages.  Toy widths: d 16, 2 layers, 2 heads.  The JAX parameters,
perturbed so that no bias is zero, cross through ``utils.convert``
(``hubert_pretrain_from_jax_params``, ``conformer_wav2vec2_from_jax_params``,
``emformer_hubert_from_jax_params``); the JAX functions run under
``jax.jit``.  Bars: values ≤ 1e-4 absolute and ≤ 1e-5 of the output's
peak, losses ≤ 1e-5 relative, gradients ≤ 1e-4 of each parameter's peak
(the key biases, whose gradient is 0 exactly, to 1e-4 of their layer's
key-weight gradient).  Streaming is held inside the port: chunkwise
``EmformerHuBERT.infer`` equals the one-shot forward at ``atol=2e-5``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu import models as JM
from torchaudio_contrib_tpu.models.hubert import span_mask as j_span_mask
from torchaudio_contrib_tpu_torch import models as M
from torchaudio_contrib_tpu_torch.utils import (
    conformer_wav2vec2_from_jax_params, emformer_hubert_from_jax_params,
    hubert_pretrain_from_jax_params)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

ATOL = 1e-4
OUT = 1e-5
LOSS_REL = 1e-5
GRAD = 1e-4
STREAM_ATOL = 2e-5

W2V = dict(extractor_conv_layers=((8, 10, 5), (8, 3, 2), (8, 2, 2)),
           d_model=16, num_layers=2, num_heads=2, ff_dim=32,
           pos_conv_kernel=8, pos_conv_groups=4,
           extractor_mode="group_norm", layer_norm_first=False)
CONF = dict(feature_dim=6, stride=2, d_model=16, num_layers=2, num_heads=2,
            ff_ratio=2, conv_kernel=3)
EMF = dict(feature_dim=6, stride=2, d_model=16, num_heads=2, ffn_dim=32,
           num_layers=2, segment_length=4, left_context_length=3,
           right_context_length=2, max_memory_size=2)
HEAD = dict(num_classes=5, final_dim=8)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _perturb(params, seed):
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x))
                    .astype(np.float32)) for x in leaves])


def _check(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= ATOL and err <= OUT * np.abs(want).max(), \
        (err, np.abs(want).max())


def _check_grads(module, want: dict):
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] is not None, k
        err = (got[k] - w).abs().max().item()
        if k.endswith("k_proj.bias"):      # 0 exactly: rounding on both
            peak = want[k.replace(".bias", ".weight")].abs().max().item()
            assert got[k].abs().max().item() <= GRAD * peak, k
        else:
            peak = w.abs().max().item()
        assert err <= GRAD * peak, (k, err, peak)


# -- span_mask ---------------------------------------------------------------

def test_span_mask_coverage_matches_closed_form_and_jax():
    """Interior coverage of independent starts at p over a span of n:
    1 - (1 - p)^n (0.4886 at the defaults), for the port's sampler and the
    JAX package's."""
    b, t, p, n = 256, 200, 0.065, 10
    want = 1 - (1 - p) ** n
    got = M.span_mask(torch.Generator().manual_seed(0), b, t, None, p, n,
                      device="cpu")
    ref = np.asarray(j_span_mask(jax.random.PRNGKey(0), b, t, None, p, n))
    assert got.shape == (b, t) and got.dtype == torch.bool
    port_cov = got[:, n:t - n].float().mean().item()
    jax_cov = ref[:, n:t - n].mean()
    assert abs(port_cov - want) < 0.02, port_cov
    assert abs(jax_cov - want) < 0.02, jax_cov
    # no span starts where it would not fit: the last n - 1 frames are
    # masked only as a continuation of an earlier frame
    tail = got[:, t - n + 1:]
    assert (tail <= got[:, t - n:t - 1]).all()


def _runs(row):
    """(start, end) of each run of True."""
    row = np.concatenate([[False], row, [False]])
    d = np.diff(row.astype(int))
    return list(zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)))


@pytest.mark.parametrize("lengths", [[60, 40, 9, 10, 25], None])
def test_span_mask_length_rule(lengths):
    """Masks stay inside each clip's length, every run is at least a span
    long; at p = 1 every frame of a clip at least a span long is masked
    (the JAX package gives the same), at p = 0 none."""
    b, t, n = 5, 60, 10
    lens = torch.tensor(lengths) if lengths else None
    m = M.span_mask(torch.Generator().manual_seed(1), b, t, lens, 0.2, n,
                    device="cpu").numpy()
    limit = lengths or [t] * b
    for row, ln in zip(m, limit):
        assert not row[ln:].any()
        assert all(e - s >= n for s, e in _runs(row))
    full = M.span_mask(torch.Generator(), b, t, lens, 1.0, n, device="cpu")
    want = np.asarray(j_span_mask(jax.random.PRNGKey(1), b, t,
                                  None if lens is None
                                  else jnp.asarray(lengths), 1.0, n))
    np.testing.assert_array_equal(full.numpy(), want)
    assert full.numpy().tolist() == [[i < ln and ln >= n for i in range(t)]
                                     for ln in limit]
    assert not M.span_mask(torch.Generator(), b, t, lens, 0.0, n,
                           device="cpu").any()


# -- HuBERT pretraining over the wav2vec2 encoder ----------------------------

@pytest.fixture(scope="module", params=["masked only", "unmasked weight 0.5"])
def hubert(request):
    w_u = 0.0 if request.param == "masked only" else 0.5
    jm = JM.HuBERTPretrainModel(JM.Wav2Vec2(**W2V), **HEAD,
                                unmasked_weight=w_u)
    params = _perturb(jm.init(jax.random.PRNGKey(2)), 7)
    tm = M.HuBERTPretrainModel(M.Wav2Vec2(**W2V, device="cpu"), **HEAD,
                               unmasked_weight=w_u, device="cpu")
    tm.load_state_dict(hubert_pretrain_from_jax_params(_np_tree(params)))
    return jm, params, tm


def _batch(rng, b=3, samples=400, frames=19, classes=5):
    x = rng.standard_normal((b, samples)).astype(np.float32)
    lengths = np.array([400, 300, 200][:b])
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    mask = rng.random((b, frames)) < 0.4
    labels = rng.integers(0, classes, (b, frames))
    labels[0, :3] = -1                          # ignored frames
    return x, lengths, mask, labels


def test_hubert_logits_loss_and_gradients_match_jax(hubert, rng):
    jm, params, tm = hubert
    x, lengths, mask, labels = _batch(rng)
    args = (jnp.asarray(x), jnp.asarray(labels), jnp.asarray(lengths),
            jnp.asarray(mask))
    logits = jax.jit(lambda p: jm.apply(p, None, args[0], args[2],
                                        args[3])[0])(params)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, None, *args)))(params)
    got_logits, got_mask, got_len, _ = tm.apply(
        torch.from_numpy(x), torch.from_numpy(lengths),
        torch.from_numpy(mask))
    _check(got_logits, logits)
    assert torch.equal(got_mask, torch.from_numpy(mask))
    assert got_len.tolist() == [19, 14, 9]
    tm.zero_grad()
    out = tm.loss(torch.from_numpy(x), torch.from_numpy(labels),
                  torch.from_numpy(lengths), torch.from_numpy(mask))
    out.backward()
    assert abs(out.item() - float(loss)) <= LOSS_REL * abs(float(loss))
    _check_grads(tm, hubert_pretrain_from_jax_params(_np_tree(grads)))


def test_hubert_generator_draws_the_mask(hubert, rng):
    _, _, tm = hubert
    x, lengths, _, labels = _batch(rng)
    args = (torch.from_numpy(x), torch.from_numpy(labels),
            torch.from_numpy(lengths))
    a = tm.loss(*args, generator=torch.Generator().manual_seed(4))
    b = tm.loss(*args, generator=torch.Generator().manual_seed(4))
    assert torch.isfinite(a) and a.item() == b.item()
    _, mask, out_len, _ = tm(args[0], args[2],
                             generator=torch.Generator().manual_seed(4))
    frames = torch.arange(mask.shape[1])[None]
    assert not (mask & (frames >= out_len[:, None])).any()
    with pytest.raises(ValueError, match="generator"):
        tm.loss(*args)


# -- ConformerWav2Vec2 ---------------------------------------------------------

@pytest.fixture(scope="module")
def conformer():
    jm = JM.ConformerWav2Vec2(**CONF, aux_out=5)
    params = _perturb(jm.init(jax.random.PRNGKey(3)), 8)
    tm = M.ConformerWav2Vec2(**CONF, aux_out=5, device="cpu")
    tm.load_state_dict(conformer_wav2vec2_from_jax_params(_np_tree(params)))
    return jm, params, tm.eval()


def _features(rng, b=3, t=21, f=6):
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    lengths = np.array([21, 14, 7][:b])
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    return x, lengths


def test_conformer_wav2vec2_forward_hooks_and_gradients(conformer, rng):
    jm, params, tm = conformer
    x, lengths = _features(rng)
    mask = rng.random((3, 10)) < 0.4
    emb = rng.standard_normal(16).astype(np.float32)
    g = rng.standard_normal((3, 10, 5)).astype(np.float32)

    def run(p, x):
        y, n, f = jm.apply(p, x, jnp.asarray(lengths),
                           frame_mask=jnp.asarray(mask),
                           mask_embedding=jnp.asarray(emb),
                           return_features=True)
        return jnp.sum(y * g) + jnp.sum(f), (y, n, f)

    (_, (want, wl, wf)), grads = jax.jit(jax.value_and_grad(
        run, has_aux=True))(params, jnp.asarray(x))
    tm.zero_grad()
    y, gl, f = tm(torch.from_numpy(x), torch.from_numpy(lengths),
                  frame_mask=torch.from_numpy(mask),
                  mask_embedding=torch.from_numpy(emb), return_features=True)
    ((y * torch.from_numpy(g)).sum() + f.sum()).backward()
    assert gl.tolist() == np.asarray(wl).tolist() == [10, 7, 3]
    _check(y, want)
    _check(f, wf)
    _check_grads(tm, conformer_wav2vec2_from_jax_params(_np_tree(grads)))


def test_conformer_pretrain_wrapper_and_hubert_over_it(rng):
    """The masked-forward wrapper and HuBERT composed over the
    Conformer encoder, with one explicit mask."""
    jw = JM.conformer_wav2vec2_pretrain_model(**CONF)
    pw = _perturb(jw.init(jax.random.PRNGKey(4)), 9)
    tw = M.conformer_wav2vec2_pretrain_model(**CONF, device="cpu")
    tw.load_state_dict(conformer_wav2vec2_from_jax_params(_np_tree(pw)))
    x, lengths = _features(rng)
    mask = rng.random((3, 10)) < 0.4
    want = jax.jit(lambda p: jw.apply(p, None, jnp.asarray(x),
                                      jnp.asarray(lengths),
                                      jnp.asarray(mask)))(pw)
    got = tw.eval().apply(torch.from_numpy(x), torch.from_numpy(lengths),
                          torch.from_numpy(mask))
    _check(got[0], want[0])
    assert got[1].tolist() == np.asarray(want[1]).tolist()
    _check(got[3], want[3])
    drawn = tw.apply(torch.from_numpy(x), torch.from_numpy(lengths),
                     generator=torch.Generator().manual_seed(2))[2]
    assert drawn.shape == (3, 10)
    assert not (drawn & (torch.arange(10)[None]
                         >= torch.tensor([10, 7, 3])[:, None])).any()

    jh = JM.HuBERTPretrainModel(JM.ConformerWav2Vec2(**CONF), **HEAD)
    ph = _perturb(jh.init(jax.random.PRNGKey(5)), 10)
    th = M.HuBERTPretrainModel(M.ConformerWav2Vec2(**CONF, device="cpu"),
                               **HEAD, device="cpu")
    th.load_state_dict(hubert_pretrain_from_jax_params(_np_tree(ph)))
    labels = rng.integers(0, 5, (3, 10))
    loss = jax.jit(lambda p: jh.loss(p, None, jnp.asarray(x),
                                     jnp.asarray(labels),
                                     jnp.asarray(lengths),
                                     jnp.asarray(mask)))(ph)
    got = th.loss(torch.from_numpy(x), torch.from_numpy(labels),
                  torch.from_numpy(lengths), torch.from_numpy(mask))
    assert abs(got.item() - float(loss)) <= LOSS_REL * abs(float(loss))


# -- EmformerHuBERT --------------------------------------------------------------

@pytest.fixture(scope="module")
def emformer():
    jm = JM.EmformerHuBERT(**EMF, aux_out=5)
    params = _perturb(jm.init(jax.random.PRNGKey(6)), 11)
    tm = M.EmformerHuBERT(**EMF, aux_out=5, device="cpu")
    tm.load_state_dict(emformer_hubert_from_jax_params(_np_tree(params)))
    return jm, params, tm.eval()


def test_emformer_hubert_forward_and_hooks_match_jax(emformer, rng):
    """(12 + 2) · 2 feature frames: 12 utterance frames and a lookahead of
    2; ragged lengths and a frame mask."""
    jm, params, tm = emformer
    x = rng.standard_normal((3, 28, 6)).astype(np.float32)
    lengths = np.array([28, 20, 11])
    mask = rng.random((3, 12)) < 0.4
    emb = rng.standard_normal(16).astype(np.float32)
    want = jax.jit(lambda p: jm.apply(
        p, jnp.asarray(x), jnp.asarray(lengths),
        frame_mask=jnp.asarray(mask), mask_embedding=jnp.asarray(emb),
        return_features=True))(params)
    got = tm(torch.from_numpy(x), torch.from_numpy(lengths),
             frame_mask=torch.from_numpy(mask),
             mask_embedding=torch.from_numpy(emb), return_features=True)
    assert got[1].tolist() == np.asarray(want[1]).tolist() == [12, 8, 3]
    _check(got[0], want[0])
    _check(got[2], want[2])
    assert tm.output_length(28) == jm.output_length(28) == 12
    assert tm.output_length(torch.tensor([28, 3])).tolist() == [12, 0]


def test_emformer_hubert_streaming_equals_one_shot(emformer, rng):
    jm, params, tm = emformer
    S, R, stride = tm.encoder.S, tm.encoder.R, tm.stride
    nseg = 3
    x = torch.from_numpy(rng.standard_normal(
        (2, (nseg * S + R) * stride, 6)).astype(np.float32))
    full, _ = tm(x)
    state = tm.init_state(2)
    outs = []
    with torch.no_grad():
        for i in range(nseg):
            chunk = x[:, i * S * stride:(i * S + S + R) * stride]
            o, ol, state = tm.infer(chunk, state)
            assert ol.tolist() == [S, S]
            outs.append(o)
    streamed = torch.cat(outs, 1)
    assert (streamed - full).abs().max().item() <= STREAM_ATOL
    want = jax.jit(jm.apply)(params, jnp.asarray(x.numpy()))[0]
    _check(streamed, want)


def test_hubert_over_emformer_matches_jax(rng):
    jh = JM.HuBERTPretrainModel(JM.EmformerHuBERT(**EMF), **HEAD)
    ph = _perturb(jh.init(jax.random.PRNGKey(7)), 12)
    th = M.HuBERTPretrainModel(M.EmformerHuBERT(**EMF, device="cpu"),
                               **HEAD, device="cpu")
    th.load_state_dict(hubert_pretrain_from_jax_params(_np_tree(ph)))
    x = rng.standard_normal((2, 28, 6)).astype(np.float32)
    mask = rng.random((2, 12)) < 0.4
    labels = rng.integers(0, 5, (2, 12))
    loss = jax.jit(lambda p: jh.loss(p, None, jnp.asarray(x),
                                     jnp.asarray(labels), None,
                                     jnp.asarray(mask)))(ph)
    got = th.loss(torch.from_numpy(x), torch.from_numpy(labels), None,
                  torch.from_numpy(mask))
    assert abs(got.item() - float(loss)) <= LOSS_REL * abs(float(loss))


# -- factories -------------------------------------------------------------------

def _jax_count(model) -> int:
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


FACTORIES = ["wav2vec2_base", "wav2vec2_large", "wav2vec2_large_lv60k",
             "hubert_base", "hubert_large", "hubert_xlarge", "wavlm_base",
             "wavlm_large", "wav2vec2_xlsr_300m", "wav2vec2_xlsr_1b",
             "wav2vec2_xlsr_2b", "hubert_pretrain_base",
             "hubert_pretrain_large", "hubert_pretrain_xlarge",
             "conformer_wav2vec2_base", "conformer_wav2vec2_pretrain_base",
             "conformer_wav2vec2_pretrain_large", "emformer_hubert_base"]


@pytest.mark.parametrize("name", FACTORIES)
def test_factory_matches_jax_geometry(name, monkeypatch):
    """The same parameter count and configuration as the JAX factory;
    built on the meta device (no memory, no weights drawn), where the
    factories' moves between devices have nothing to copy."""
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
    with torch.device("meta"):
        tm = getattr(M, name)()
    jm = getattr(JM, name)()
    assert sum(p.numel() for p in tm.parameters()) == _jax_count(jm)
    enc_t = getattr(tm, "encoder", tm) if "pretrain" in name else tm
    enc_j = getattr(jm, "encoder", jm) if "pretrain" in name else jm
    for attr in ("extractor", "extractor_mode", "conv_bias",
                 "layer_norm_first", "num_buckets", "stride", "d_model"):
        if hasattr(enc_j, attr):
            assert getattr(enc_t, attr) == getattr(enc_j, attr), attr
