"""Parity of the port's wav2vec2-family bundles (``pipelines``:
``Wav2Vec2Bundle``, ``Wav2Vec2ASRBundle``, ``Wav2Vec2FABundle``, the 24
constants and ``MMS_FA``), its HF-checkpoint loader
(``utils.convert.wav2vec2_from_torch_state_dict``) and its parameter files
(``utils.checkpoint``) with the JAX package, on the CPU.

The bundles' own factories build full-width models; the tests run the
same bundle classes over toy factories (d 16, 2 layers), so that every
path of ``get_model`` (generator, ``torch_checkpoint=``, ``checkpoint=``)
runs in milliseconds.  Bars: values ≤ 1e-4 absolute and ≤ 1e-5 of the
output's peak; labels, decoded text, words and aligned spans equal; span
scores ≤ 1e-5; parameter files bit for bit.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu import models as JM
from torchaudio_contrib_tpu import pipelines as jpipe
from torchaudio_contrib_tpu.utils import checkpoint as jckpt
from torchaudio_contrib_tpu.utils.import_torch import import_wav2vec2
from torchaudio_contrib_tpu_torch import models as M
from torchaudio_contrib_tpu_torch import pipelines as tpipe
from torchaudio_contrib_tpu_torch.utils import (
    emformer_rnnt_from_jax_params, load_params, save_params,
    wav2vec2_from_jax_params, wav2vec2_from_torch_state_dict)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

ATOL = 1e-4
OUT = 1e-5
SPAN_SCORE = 1e-5

TOY = dict(extractor_conv_layers=((8, 10, 5), (8, 3, 2), (8, 2, 2)),
           d_model=16, num_layers=2, num_heads=2, ff_dim=32,
           pos_conv_kernel=8, pos_conv_groups=4,
           extractor_mode="group_norm", layer_norm_first=False)

FAMILY = ["WAV2VEC2_BASE", "WAV2VEC2_LARGE", "HUBERT_BASE", "HUBERT_LARGE",
          "WAVLM_BASE", "WAVLM_LARGE", "WAV2VEC2_XLSR_300M",
          "WAV2VEC2_ASR_BASE_960H", "HUBERT_ASR_LARGE",
          "WAV2VEC2_LARGE_LV60K", "WAV2VEC2_XLSR53", "WAV2VEC2_XLSR_1B",
          "WAV2VEC2_XLSR_2B", "HUBERT_XLARGE", "WAVLM_BASE_PLUS",
          "WAV2VEC2_ASR_BASE_10M", "WAV2VEC2_ASR_BASE_100H",
          "WAV2VEC2_ASR_LARGE_10M", "WAV2VEC2_ASR_LARGE_100H",
          "WAV2VEC2_ASR_LARGE_960H", "WAV2VEC2_ASR_LARGE_LV60K_10M",
          "WAV2VEC2_ASR_LARGE_LV60K_100H", "WAV2VEC2_ASR_LARGE_LV60K_960H",
          "HUBERT_ASR_XLARGE"]


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
    assert err <= ATOL and err <= OUT * np.abs(want).max(), err


def _toy(aux_out=None, *, device="cuda", generator=None):
    return M.Wav2Vec2(**TOY, aux_out=aux_out, device=device,
                      generator=generator)


@pytest.fixture(scope="module")
def jax_asr():
    """The JAX toy CTC model (29 labels), its perturbed params and its
    compiled forward."""
    jm = JM.Wav2Vec2(**TOY, aux_out=29)
    params = _perturb(jm.init(jax.random.PRNGKey(0)), 1)
    return jm, params, jax.jit(jm.apply)


def _wave(rng, b=2):
    x = rng.standard_normal((b, 400)).astype(np.float32)
    x[1, 300:] = 0.0
    return x, np.array([400, 300][:b])


# -- the constants ---------------------------------------------------------

@pytest.mark.parametrize("name", FAMILY)
def test_constant_pins_the_jax_architecture(name):
    got, want = getattr(tpipe, name), getattr(jpipe, name)
    assert type(got).__name__ == type(want).__name__
    assert got._factory.__name__ == want._factory.__name__
    assert got.sample_rate == want.sample_rate == 16000
    if hasattr(want, "labels"):
        assert got.get_labels() == want.get_labels()


def test_mms_fa_labels_and_dict_match_jax():
    for kw in ({}, {"star": None}, {"star": "#", "blank": "<b>"}):
        assert tpipe.MMS_FA.get_labels(**kw) == jpipe.MMS_FA.get_labels(**kw)
    assert tpipe.MMS_FA.get_dict() == jpipe.MMS_FA.get_dict()
    assert tpipe.MMS_FA.get_dict(star=None) == \
        jpipe.MMS_FA.get_dict(star=None)


# -- ASR bundle: labels, decode, lexicon decoder ------------------------------

def test_decode_matches_jax(rng):
    bundle, jbundle = tpipe.WAV2VEC2_ASR_BASE_960H, jpipe.WAV2VEC2_ASR_BASE_960H
    for ids in ([], [0, 0], [3, 3, 0, 3, 1, 4, 4, 1, 0, 5],
                rng.integers(0, 29, 60).tolist()):
        assert bundle.decode(ids) == jbundle.decode(ids)
        assert bundle.decode(torch.tensor(ids, dtype=torch.long)) == \
            jbundle.decode(ids)


def test_get_decoder_matches_jax():
    """Peaky emissions of "THE|CAT|": the port's lexicon decoder and the
    JAX bundle's return the same words, tokens and score."""
    labels = list(tpipe.WAV2VEC2_ASR_BASE_960H.get_labels())
    lexicon = {"THE": list("THE") + ["|"], "CAT": list("CAT") + ["|"],
               "HAT": list("HAT") + ["|"], "AT": list("AT") + ["|"]}
    seq = list("THE|CAT|")
    lp = np.full((1, 3 * len(seq), 29), -6.0, np.float32)
    for i, s in enumerate(seq):
        lp[0, 3 * i:3 * i + 2, labels.index(s)] = -0.05
        lp[0, 3 * i + 2, 0] = -0.05
    got = tpipe.WAV2VEC2_ASR_BASE_960H.get_decoder(lexicon, beam_size=8)(
        torch.from_numpy(lp))
    want = jpipe.WAV2VEC2_ASR_BASE_960H.get_decoder(lexicon, beam_size=8)(lp)
    assert got[0][0].words == want[0][0].words == ["THE", "CAT"]
    assert list(got[0][0].tokens) == list(want[0][0].tokens)
    assert abs(got[0][0].score - want[0][0].score) <= 1e-6 * max(
        1.0, abs(want[0][0].score))


# -- weights in: generator, HF state_dict, parameter files ----------------------

def test_get_model_needs_weights_and_defaults_to_the_card():
    bundle = tpipe.Wav2Vec2ASRBundle(_toy)
    with pytest.raises(ValueError, match="generator"):
        bundle.get_model()
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            bundle.get_model(torch.Generator())
    a = bundle.get_model(torch.Generator().manual_seed(3), device="cpu")
    b = bundle.get_model(torch.Generator().manual_seed(3), device="cpu")
    assert a.aux_out == 29
    assert all(torch.equal(a.state_dict()[k], v)
               for k, v in b.state_dict().items())


def _hf(sd: dict, fold: str) -> dict:
    """The port's ``state_dict`` in HF's ``Wav2Vec2ForCTC`` shape: a
    ``wav2vec2.`` prefix, the head as ``lm_head``, the positional conv
    weight-normed over its kernel axis, and pretraining leftovers."""
    out = {}
    for k, v in sd.items():
        if k.startswith("aux."):
            out["lm_head" + k[3:]] = v
        elif k == "encoder.pos_conv_embed.conv.weight":
            g = torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True)
            v3 = 3.0 * v                        # any scale: w = g·v/|v|
            base = "wav2vec2.encoder.pos_conv_embed.conv."
            if fold == "weight_g":
                out[base + "weight_g"], out[base + "weight_v"] = g, v3
            else:
                out[base + "parametrizations.weight.original0"] = g
                out[base + "parametrizations.weight.original1"] = v3
        else:
            out["wav2vec2." + k] = v
    out["wav2vec2.masked_spec_embed"] = torch.ones(16)
    out["quantizer.codevectors"] = torch.ones(1, 8, 4)
    out["project_q.weight"] = torch.ones(4, 4)
    return out


@pytest.mark.parametrize("fold", ["weight_g", "parametrizations"])
def test_hf_state_dict_loads_into_the_bundle(jax_asr, rng, tmp_path, fold):
    """An HF-layout dict (and the same saved to a file) → the port's
    bundle; the JAX importer reads the same dict into the JAX model, and
    both forwards agree."""
    own = _toy(29, device="cpu", generator=torch.Generator().manual_seed(1))
    hf = _hf(own.state_dict(), fold)
    bundle = tpipe.Wav2Vec2ASRBundle(_toy)
    got = bundle.get_model(torch_checkpoint=hf, device="cpu")
    path = tmp_path / "hf.pt"
    torch.save({"state_dict": hf}, path)
    from_file = bundle.get_model(torch_checkpoint=str(path), device="cpu")
    jm, _, fwd = jax_asr
    params = import_wav2vec2(hf, jm)
    x, lengths = _wave(rng)
    want = fwd(params, jnp.asarray(x), jnp.asarray(lengths))[0]
    for model in (got, from_file, own):
        _check(model(torch.from_numpy(x), torch.from_numpy(lengths))[0],
               want)


def test_hf_loader_names_what_is_missing():
    own = _toy(29, device="cpu")
    hf = _hf(own.state_dict(), "weight_g")
    del hf["lm_head.weight"]
    with pytest.raises(KeyError, match="lm_head|aux"):
        wav2vec2_from_torch_state_dict(hf, own)


def test_parameter_files_cross_both_ways(jax_asr, rng, tmp_path):
    """JAX ``save_params`` → the port's ``load_params`` (structure from the
    file) → the bundle's ``checkpoint=``; the port's ``save_params`` → the
    JAX ``load_params`` with its own structure check."""
    jm, params, fwd = jax_asr
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_params(jpath, params)
    tree = load_params(jpath)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(_np_tree(params))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    model = tpipe.Wav2Vec2ASRBundle(_toy).get_model(checkpoint=jpath,
                                                    device="cpu")
    x, lengths = _wave(rng)
    _check(model(torch.from_numpy(x), torch.from_numpy(lengths))[0],
           fwd(params, jnp.asarray(x), jnp.asarray(lengths))[0])

    ppath = str(tmp_path / "port.npz")
    torch_tree = jax.tree_util.tree_map(torch.tensor, _np_tree(params))
    save_params(ppath, torch_tree)
    back = jckpt.load_params(ppath, params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    again = load_params(ppath, _np_tree(params))
    assert wav2vec2_from_jax_params(again).keys() == \
        model.state_dict().keys()


def test_load_params_checks_like_jax(jax_asr, tmp_path):
    _, params, _ = jax_asr
    path = str(tmp_path / "p.npz")
    save_params(path, _np_tree(params))
    bad = _np_tree(params)
    bad["proj"]["w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_params(path, bad)
    fewer = _np_tree(params)
    del fewer["aux"]
    with pytest.raises(ValueError, match="leaves"):
        load_params(path, fewer)
    renamed = _np_tree(params)
    renamed["zz"] = renamed.pop("aux")
    with pytest.raises(ValueError, match="structure"):
        load_params(path, renamed)


def test_rnnt_bundle_reads_a_jax_checkpoint(tmp_path):
    """``RNNTBundle.get_model(checkpoint=)``: the JAX torchaudio-layout
    Emformer-RNNT's params (identity ``enc_proj``) saved by the JAX
    package, read into the port's model (toy widths, through a bundle
    subclass that builds them)."""
    cfg = dict(input_dim=6, encoding_dim=20, num_symbols=13,
               segment_length=4, right_context_length=2, max_memory_size=0,
               time_reduction_input_dim=8, time_reduction_stride=2,
               lstm_layer_norm=True, lstm_layer_norm_epsilon=1e-3,
               num_heads=2, ffn_dim=24, num_layers=2, left_context_length=3,
               predictor_embed_dim=10, predictor_hidden_dim=12,
               predictor_layers=2)

    class Tiny(tpipe.RNNTBundle):
        def _model(self, device, generator):
            return M.emformer_rnnt_model(**cfg, device=device,
                                         generator=generator)

    jm = JM.emformer_rnnt_model(**cfg)
    params = jm.init(jax.random.PRNGKey(2))
    params["enc_proj"] = {"w": jnp.eye(20), "b": jnp.zeros((20,))}
    path = str(tmp_path / "rnnt.npz")
    jckpt.save_params(path, params)
    model = Tiny().get_model(checkpoint=path, device="cpu")
    want = emformer_rnnt_from_jax_params(_np_tree(params))
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())


# -- forced alignment ---------------------------------------------------------------

@pytest.mark.parametrize("with_star", [True, False])
def test_fa_emissions_match_jax(jax_asr, rng, with_star):
    """The emission model over a toy base with the 28 labels: log-softmax
    plus the zero star column, against the JAX bundle's wrapper."""
    jm = JM.Wav2Vec2(**TOY, aux_out=28)
    params = _perturb(jm.init(jax.random.PRNGKey(4)), 5)

    class Tiny(tpipe.Wav2Vec2FABundle):
        def _build(self, device, generator):
            return _toy(28, device=device, generator=generator)

    model = Tiny().get_model(with_star=with_star,
                             generator=torch.Generator(), device="cpu")
    model.model.load_state_dict(wav2vec2_from_jax_params(_np_tree(params)))
    x, lengths = _wave(rng)
    want, wl = jpipe._FAEmissionModel(jm, with_star).apply(
        params, jnp.asarray(x), jnp.asarray(lengths))
    got, gl = model(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.shape[-1] == 28 + with_star
    _check(got, want)
    assert gl.tolist() == np.asarray(wl).tolist()
    if with_star:
        assert not got[..., -1].any()
    np.testing.assert_allclose(got[..., :28].exp().sum(-1).detach(), 1.0,
                               atol=1e-5)


def test_aligner_spans_match_jax(rng):
    """Emissions peaked on a planted path of 5 tokens (star column
    included): the port's aligner and the JAX bundle's give the same
    spans."""
    t, v = 40, 29
    tokens = [3, 7, 7, 2, 11]
    lp = rng.standard_normal((t, v)).astype(np.float32)
    for i, tok in enumerate(tokens):
        lp[4 + 7 * i:8 + 7 * i, tok] += 6.0
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    got = tpipe.MMS_FA.get_aligner()(torch.from_numpy(lp), tokens)
    want = jpipe.MMS_FA.get_aligner()(jnp.asarray(lp), tokens)
    assert [(s.token, s.start, s.end) for s in got] == \
        [(s.token, s.start, s.end) for s in want]
    assert [s.token for s in got] == tokens
    for a, b in zip(got, want):
        assert abs(a.score - b.score) <= SPAN_SCORE
    with pytest.raises(ValueError):
        tpipe.MMS_FA.get_aligner()(torch.from_numpy(lp[None]), tokens)
