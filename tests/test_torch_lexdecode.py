"""Parity of the port's lexicon + LM CTC decoders (``models/decoder.py``,
the host search; ``ops/lexdecode.py``, the device search) with the JAX
package, on the CPU, on the synthetic lexicon and bigram ARPA LM of
``tests/test_lexdecode.py``.

Bars: the host decoders' n-best lists equal (words, tokens, timesteps)
with scores within 1e-9 (both float64 NumPy); the device search equal to
the host search built with ``beam_threshold=math.inf`` (words, tokens,
timesteps; scores within 1e-5 relative: float32 on the device) and to the
JAX device search; the same loud errors for the host-only features.
"""
import math

import numpy as np
import pytest
import torch

import torchaudio_contrib_tpu as tac
from torchaudio_contrib_tpu.models import decoder as jdecoder
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.models import decoder as tdecoder
from test_lexdecode import ARPA, LEXICON, TOKENS

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

SCORE_REL = 1e-5


def _emissions(rng, b, t, scale=1.0):
    lp = rng.standard_normal((b, t, len(TOKENS))) * scale
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    return lp.astype(np.float32)


def _decoders(mod, lm=None, **kw):
    kw.setdefault("beam_size", 8)
    kw.setdefault("nbest", 4)
    kw.setdefault("beam_threshold", math.inf)
    if lm == "arpa":
        lm = mod.ARPALM(ARPA)
    return mod.ctc_decoder(kw.pop("lexicon", LEXICON), TOKENS, lm=lm, **kw)


def _key(h):
    return (tuple(h.words), tuple(h.tokens), tuple(h.timesteps))


def _same(got, want, rel):
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        assert [_key(h) for h in gb] == [_key(h) for h in wb]
        np.testing.assert_allclose([h.score for h in gb],
                                   [h.score for h in wb], rtol=rel,
                                   atol=rel)


SETTINGS = {
    "zero LM": dict(word_score=-0.3, sil_score=0.1),
    "bigram LM": dict(lm="arpa", lm_weight=1.7, word_score=0.2),
    "bigram, beam 4": dict(lm="arpa", beam_size=4, nbest=2),
    "no silence token": dict(sil_token=None,
                             lexicon=["ab a b", "abc a b c", "cd c d",
                                      "da d a"]),
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_host_decoder_matches_jax(rng, name):
    lp = _emissions(rng, 2, 16)
    lengths = [16, 11]
    got = _decoders(tdecoder, **SETTINGS[name])(torch.from_numpy(lp),
                                                torch.tensor(lengths))
    want = _decoders(jdecoder, **SETTINGS[name])(lp, lengths)
    _same(got, want, 1e-9)


def test_host_decoder_with_threshold_and_unk_matches_jax(rng):
    """The host-only features: a finite beam threshold, ``log_add``
    merging and ``unk`` words."""
    lp = _emissions(rng, 2, 14, scale=2.0)
    kw = dict(lm="arpa", beam_threshold=3.0, log_add=True, unk_score=-4.0,
              lexicon=LEXICON[:4])
    got = _decoders(tdecoder, **kw)(lp)
    want = _decoders(jdecoder, **kw)(lp)
    _same(got, want, 1e-9)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_device_decoder_matches_host_and_jax(rng, name):
    lp = _emissions(rng, 3, 18)
    lengths = [18, 12, 5]
    host = _decoders(tdecoder, **SETTINGS[name])
    dev = tops.device_ctc_decoder(host)
    got = dev(torch.from_numpy(lp), torch.tensor(lengths))
    _same(got, host(lp, lengths), SCORE_REL)
    jdev = tac.ops.device_ctc_decoder(_decoders(jdecoder, **SETTINGS[name]))
    _same(got, jdev(lp, lengths), SCORE_REL)


def test_device_decoder_recovers_planted_words():
    """Peaky emissions of "ab|cad|": the device search, the host search
    and the JAX device search all return those words first."""
    seq = ["a", "b", "|", "c", "a", "d", "|"]
    t_per = 3
    lp = np.full((1, len(seq) * t_per, len(TOKENS)), -6.0, np.float32)
    for i, s in enumerate(seq):
        lp[0, i * t_per:(i + 1) * t_per - 1, TOKENS.index(s)] = -0.05
        lp[0, (i + 1) * t_per - 1, 0] = -0.05
    host = _decoders(tdecoder, lm="arpa")
    got = tops.device_ctc_decoder(host)(torch.from_numpy(lp))
    assert got[0][0].words == ["ab", "cad"]
    _same(got, host(lp), SCORE_REL)


def test_compiled_tables_match_jax():
    host = _decoders(tdecoder, lm="arpa")
    got = tops.compile_lexicon_tables(host)
    want = tac.ops.compile_lexicon_tables(_decoders(jdecoder, lm="arpa"))
    assert got.words == want.words
    for a, b in zip(got.tables, want.tables):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lexicon_beam_decode_matches_jax(rng):
    """The functional form: every output of the batched search, slot by
    slot, on slots of finite score."""
    lp = _emissions(rng, 2, 15)
    host = _decoders(tdecoder, lm="arpa")
    kw = dict(beam_width=6, blank=0, sil=1, lm_weight=1.5, word_score=0.1,
              max_tokens=10)
    got = tops.ctc_lexicon_beam_decode(
        torch.from_numpy(lp), tops.compile_lexicon_tables(host), [15, 9],
        **kw)
    want = tac.ops.ctc_lexicon_beam_decode(
        lp, tac.ops.compile_lexicon_tables(_decoders(jdecoder, lm="arpa")),
        np.array([15, 9]), **kw)
    want = [np.asarray(a) for a in want]
    fin = np.isfinite(want[-1])
    assert fin.sum() > 2
    np.testing.assert_array_equal(np.isfinite(got[-1].numpy()), fin)
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g.numpy()[fin], w[fin])
    np.testing.assert_allclose(got[-1].numpy()[fin], want[-1][fin],
                               rtol=SCORE_REL)


def test_device_decoder_loud_errors():
    with pytest.raises(NotImplementedError, match="log_add"):
        tops.device_ctc_decoder(_decoders(tdecoder, log_add=True))
    with pytest.raises(NotImplementedError, match="unk"):
        tops.device_ctc_decoder(_decoders(tdecoder, unk_score=-5.0))
    trigram = ARPA[:3] + ["ngram 3=1"] + ARPA[3:-2] + [
        "", "\\3-grams:", "-0.1\t<s> ab ba", ""] + ARPA[-2:]
    lm = tdecoder.ARPALM(trigram)
    assert lm.order == 3
    with pytest.raises(NotImplementedError, match="order"):
        tops.device_ctc_decoder(_decoders(tdecoder, lm=lm))
    dev = tops.device_ctc_decoder(_decoders(tdecoder))
    with pytest.raises(ValueError, match="tokens"):
        tops.ctc_lexicon_beam_decode(torch.zeros((1, 4, 3)), dev.tables)
