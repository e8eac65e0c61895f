"""Parity of the port's TTS bundles (``pipelines``: ``Tacotron2TTSBundle``,
``HiFiGANVocoderBundle``, ``Tacotron2GriffinLimBundle``, the phone
bundles and the five constants) and of ``datasets.CMUDict`` with the JAX
package, on the CPU.

The text processors give equal ids (a ``cmudict-0.7b`` of a few words is
written by the test); HiFi-GAN's log-mel transform lands within 1e-4 of
the JAX one; the Griffin-Lim vocoder from zero phase within 5e-4 of peak
of the JAX one after a few iterations (the bar of ``mel_to_audio``'s own
parity test), with equal lengths.  The bundles' ``get_tacotron2``/
``get_vocoder`` run over toy models for every source of weights
(generator, ``torch_checkpoint=``, ``checkpoint=``); their published
geometries are checked on the meta device.  The slice: text → the
processor → Tacotron2 ``infer`` → the Griffin-Lim vocoder, in both
packages from the same weights (1e-4 of peak for the mel; the waveform
to the vocoder's bar from the JAX vocoder on the same mel).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu import models as JM
from torchaudio_contrib_tpu import pipelines as jpipe
from torchaudio_contrib_tpu.utils import checkpoint as jckpt
from torchaudio_contrib_tpu_torch import datasets as tdata
from torchaudio_contrib_tpu_torch import models as M
from torchaudio_contrib_tpu_torch import pipelines as tpipe
from torchaudio_contrib_tpu_torch.utils import tacotron2_from_jax_params

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

OUT = 1e-4
LOGMEL_ATOL = 1e-4
GL_REL = 5e-4
GL_ITER = 3

CMUDICT = """;;; a few entries of the CMU Pronouncing Dictionary
!EXCLAMATION-POINT  EH2 K S K L AH0 M EY1 SH AH0 N P OY2 N T
'BOUT  B AW1 T
HELLO  HH AH0 L OW1
HELLO(1)  HH EH0 L OW1
WORLD  W ER1 L D
THE  DH AH0
CAT  K AE1 T
SAT  S AE1 T
ON  AA1 N
MAT  M AE1 T
YES  Y EH1 S
"""

TEXTS = ["Hello, world!", "the CAT sat on the mat.", "'bout yes", "x"]
TOY = dict(embed_dim=16, encoder_dim=16, attention_dim=8,
           attention_filters=4, attention_kernel=5, decoder_dim=16,
           prenet_dim=8, postnet_dim=16)


@pytest.fixture()
def cmudict(tmp_path):
    (tmp_path / "cmudict-0.7b").write_text(CMUDICT, encoding="latin-1")
    return str(tmp_path)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _params(jm, seed, scale=0.3):
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(scale * rng.standard_normal(s.shape)
                              .astype(np.float32)), shapes)


@pytest.mark.parametrize("texts", [TEXTS, "a bare string", ["", "?!"]])
def test_char_processor_matches_jax(texts):
    got = tpipe.TACOTRON2_WAVERNN_CHAR_LJSPEECH.get_text_processor()(texts)
    want = jpipe.TACOTRON2_WAVERNN_CHAR_LJSPEECH.get_text_processor()(texts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_cmudict_matches_jax(cmudict):
    from torchaudio_contrib_tpu.datasets import CMUDict as JCMUDict
    for punct in (True, False):
        got, want = tdata.CMUDict(cmudict, punct), JCMUDict(cmudict, punct)
        assert len(got) == len(want)
        assert [got[i] for i in range(len(got))] \
            == [want[i] for i in range(len(want))]
    with pytest.raises(FileNotFoundError):
        tdata.CMUDict(cmudict + "/missing")


@pytest.mark.parametrize("bundle", ["TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH",
                                    "TACOTRON2_WAVERNN_PHONE_LJSPEECH"])
def test_phone_processor_matches_jax(cmudict, bundle):
    got = getattr(tpipe, bundle).get_text_processor(root=cmudict)
    want = getattr(jpipe, bundle).get_text_processor(root=cmudict)
    assert got.symbols == want.symbols and len(got.symbols) == 96
    for g, w in zip(got(TEXTS[:3]), want(TEXTS[:3])):
        assert np.array_equal(g, w)
    # "hello, world!" by hand: the first pronunciation, the comma and the
    # bang as symbols, a space between words
    idx = {s: i for i, s in enumerate(got.symbols)}
    hand = [idx[p] for p in "HH AH0 L OW1".split()] + [idx[","], idx[" "]] \
        + [idx[p] for p in "W ER1 L D".split()] + [idx["!"]]
    ids, n = got("Hello, world!")
    assert ids[0, :n[0]].tolist() == hand
    with pytest.raises(KeyError):
        got("hello unknownword")
    skip = getattr(tpipe, bundle).get_text_processor(root=cmudict,
                                                     oov="skip")
    wskip = getattr(jpipe, bundle).get_text_processor(root=cmudict,
                                                      oov="skip")
    for g, w in zip(skip(["hello unknownword cat"]),
                    wskip(["hello unknownword cat"])):
        assert np.array_equal(g, w)
    with pytest.raises(ValueError):
        getattr(tpipe, bundle).get_text_processor()


def test_hifigan_mel_transform_matches_jax(rng):
    x = (0.3 * rng.standard_normal((2, 5000))).astype(np.float32)
    got = tpipe.HIFIGAN_VOCODER_V3_LJSPEECH.get_mel_transform(
        device="cpu")(torch.from_numpy(x))
    want = jpipe.HIFIGAN_VOCODER_V3_LJSPEECH.get_mel_transform()(
        jnp.asarray(x))
    assert got.shape == (2, 80, 5000 // 256) == tuple(want.shape)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) \
        <= LOGMEL_ATOL


def test_griffinlim_vocoder_matches_jax(rng):
    """From zero phase (no generator, no key), a few iterations at the
    vocoder's fft 1024 / hop 256; ``lengths`` in frames become samples,
    clamped to the waveform."""
    mel = (rng.standard_normal((2, 80, 12)) - 4.0).astype(np.float32)
    kw = dict(n_iter=GL_ITER)
    got, glen = tpipe._GriffinLimVocoder(**kw)(torch.from_numpy(mel),
                                               [12, 5])
    want, wlen = jpipe._GriffinLimVocoder(**kw)(jnp.asarray(mel), [12, 5])
    assert got.shape == tuple(want.shape) == (2, 11 * 256)
    assert _rel(got, want) <= GL_REL
    assert glen.tolist() == np.asarray(wlen).tolist() == [11 * 256, 5 * 256]
    voc = tpipe.TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH.get_vocoder()
    assert voc.hop_length == 256 and voc.kw["n_iter"] == 60
    with pytest.raises(ValueError):
        tpipe.TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH.get_vocoder(
            torch.Generator())


class _ToyTTS(tpipe.Tacotron2TTSBundle):
    def _tacotron2(self, device, generator):
        return M.Tacotron2(n_symbols=38, n_mels=self.n_mels, **TOY,
                           device=device, generator=generator)


class _ToyGL(tpipe.Tacotron2GriffinLimBundle):
    _tacotron2 = _ToyTTS._tacotron2


def test_tacotron2_bundle_weight_sources(tmp_path, rng):
    """``generator=`` (eval mode, on the device asked for), a
    ``torch_checkpoint=`` (a ``state_dict`` and a path) and a
    ``checkpoint=`` (the JAX params saved by the JAX ``save_params``) give
    the same module; no source raises."""
    b = _ToyTTS()
    own = b.get_tacotron2(torch.Generator().manual_seed(0), device="cpu")
    assert not own.training
    assert own.embedding.weight.device.type == "cpu"
    path = tmp_path / "taco.pt"
    torch.save(own.state_dict(), path)
    for src in (own.state_dict(), str(path)):
        m = b.get_tacotron2(torch_checkpoint=src, device="cpu")
        assert all(torch.equal(a, c) for a, c in
                   zip(m.state_dict().values(), own.state_dict().values()))
    jm = JM.Tacotron2(n_symbols=38, **TOY)
    params = _params(jm, 2)
    jckpt.save_params(str(tmp_path / "taco.npz"), params)
    m = b.get_tacotron2(checkpoint=str(tmp_path / "taco.npz"), device="cpu")
    want = tacotron2_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                            params))
    assert all(torch.equal(m.state_dict()[k], want[k]) for k in want)
    with pytest.raises(ValueError):
        b.get_tacotron2()


def test_vocoder_bundles_weight_sources():
    voc = tpipe.HIFIGAN_VOCODER_V3_LJSPEECH.get_vocoder(
        torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(voc, M.HiFiGANVocoder) and not voc.training
    again = tpipe.HIFIGAN_VOCODER_V3_LJSPEECH.get_vocoder(
        torch_checkpoint=voc.state_dict(), device="cpu")
    assert all(torch.equal(a, c) for a, c in
               zip(again.state_dict().values(), voc.state_dict().values()))
    wr = tpipe.TACOTRON2_WAVERNN_CHAR_LJSPEECH.get_vocoder(
        torch.Generator().manual_seed(0), device="meta")
    assert isinstance(wr, M.WaveRNN) and wr.hop == 275 and not wr.training


@pytest.mark.parametrize("name", ["TACOTRON2_WAVERNN_CHAR_LJSPEECH",
                                  "TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH",
                                  "TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH",
                                  "TACOTRON2_WAVERNN_PHONE_LJSPEECH"])
def test_bundle_tacotron2_geometry_on_meta(name):
    """Each bundle's Tacotron2 (38 characters or 96 phones) has the JAX
    bundle's parameter shapes, carried by the converter."""
    jb = getattr(jpipe, name)
    n_symbols = 96 if "PHONE" in name else 38
    shapes = jax.eval_shape(JM.Tacotron2(n_symbols=n_symbols).init,
                            jax.random.PRNGKey(0))
    sd = tacotron2_from_jax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    tm = getattr(tpipe, name)._tacotron2("meta", None)
    assert jb.n_mels == tm.n_mels == 80
    assert {n: tuple(v.shape) for n, v in tm.state_dict().items()} \
        == {n: tuple(v.shape) for n, v in sd.items()}


def test_tts_slice_matches_jax(rng):
    """Text → character ids → Tacotron2 ``infer`` (12 steps) → the
    Griffin-Lim vocoder, in both packages from the same weights."""
    jm = JM.Tacotron2(n_symbols=38, **TOY)
    params = _params(jm, 3)
    tm = _ToyGL().get_tacotron2(torch.Generator(), device="cpu")
    tm.load_state_dict(tacotron2_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    ids, lengths = tpipe.TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH \
        .get_text_processor()(TEXTS[:2])
    want = jax.jit(jm.infer, static_argnums=(3,))(
        params, jnp.asarray(ids), jnp.asarray(lengths), 12)
    with torch.inference_mode():
        got = tm.infer(torch.from_numpy(ids), torch.from_numpy(lengths), 12)
    assert _rel(got[1], want[1]) <= OUT
    assert got[4].tolist() == np.asarray(want[4]).tolist()
    kw = dict(n_iter=GL_ITER)
    wave, wl = tpipe._GriffinLimVocoder(**kw)(got[1], got[4])
    # the JAX vocoder on the port's mel: the mels agree to 1e-4 of peak,
    # and Griffin-Lim amplifies such a difference past its own bar
    jwave, jwl = jpipe._GriffinLimVocoder(**kw)(jnp.asarray(got[1].numpy()),
                                                want[4])
    assert _rel(wave, jwave) <= GL_REL
    assert wl.tolist() == np.asarray(jwl).tolist()
