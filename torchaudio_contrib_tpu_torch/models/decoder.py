"""Lexicon-constrained CTC beam decoder with n-gram LM fusion.

Port of ``torchaudio_contrib_tpu/models/decoder.py``, a copy: the search
is host-side NumPy in float64, as the JAX package and torchaudio's CPU
binding keep it (a dict-of-growing-prefixes algorithm with no static
shape).  :class:`CTCDecoder` takes the emissions as a tensor on any device
(or an array) and copies them to the host; the device counterpart of the
search is ``ops.lexdecode.device_ctc_decoder``.

Pieces:

* :class:`CTCDecoderLM` — the LM interface (``start``/``score``/
  ``finish`` over *words*), matching flashlight's contract.
* :class:`ZeroLM` — no-LM stand-in.
* :class:`ARPALM` — pure-Python ARPA n-gram reader with Katz
  backoff; scores are log10 like KenLM's.
* :func:`ctc_decoder` — builds a :class:`CTCDecoder`: trie-constrained
  beam search over (trie node, previous token, LM state) with
  blank/repeat CTC transitions, word emission on the silence token,
  optional hypothesis merging by ``logaddexp`` (``log_add=True``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "CTCDecoderLM", "ZeroLM", "ARPALM",
    "CTCDecoder", "CTCDecoderOutput", "ctc_decoder",
]


# ---------------------------------------------------------------- LMs
class CTCDecoderLM:
    """Word-level LM interface: opaque ``state`` threaded through
    ``start() -> state``, ``score(state, word) -> (state, logp)``,
    ``finish(state) -> logp``.  Scores are log10 (KenLM convention);
    the decoder multiplies them by ``lm_weight``."""

    def start(self):
        raise NotImplementedError

    def score(self, state, word: str):
        raise NotImplementedError

    def finish(self, state) -> float:
        return 0.0


class ZeroLM(CTCDecoderLM):
    """Scores everything 0 — pure acoustic + lexicon decoding."""

    def start(self):
        return ()

    def score(self, state, word):
        return (), 0.0


class ARPALM(CTCDecoderLM):
    """Backoff n-gram LM from an ARPA file (text or pre-parsed dict).

    ``score`` implements the standard recursive Katz query: return the
    highest-order matching n-gram's logprob, else the context's
    backoff weight plus the shortened query.  Out-of-vocabulary words
    score as ``<unk>`` when the model has one, else ``unk_score``.
    """

    def __init__(self, path_or_lines, unk_score: float = -10.0):
        if isinstance(path_or_lines, str):
            if path_or_lines.endswith(".gz"):
                import gzip
                with gzip.open(path_or_lines, "rt",
                               encoding="utf-8") as f:
                    lines = f.read().splitlines()
            else:
                with open(path_or_lines, encoding="utf-8") as f:
                    lines = f.read().splitlines()
        else:
            lines = list(path_or_lines)
        self._probs: Dict[Tuple[str, ...], float] = {}
        self._backoffs: Dict[Tuple[str, ...], float] = {}
        self.order = 0
        self.unk_score = float(unk_score)
        cur = None
        for raw in lines:
            line = raw.strip()
            if not line or line.startswith(("\\data\\", "ngram ")):
                continue
            if line == "\\end\\":
                break
            if line.startswith("\\") and line.endswith("-grams:"):
                cur = int(line[1:line.index("-")])
                self.order = max(self.order, cur)
                continue
            if cur is None:
                continue
            parts = line.split("\t") if "\t" in line else line.split()
            logp = float(parts[0])
            if "\t" in line:
                words = tuple(parts[1].split())
                backoff = float(parts[2]) if len(parts) > 2 else None
            else:
                words = tuple(parts[1:1 + cur])
                backoff = (float(parts[1 + cur])
                           if len(parts) > 1 + cur else None)
            self._probs[words] = logp
            if backoff is not None:
                self._backoffs[words] = backoff
        if not self._probs:
            raise ValueError("no n-grams found in ARPA input")
        self.vocab = {w[0] for w in self._probs if len(w) == 1}

    def _score(self, ngram: Tuple[str, ...]) -> float:
        if ngram in self._probs:
            return self._probs[ngram]
        if len(ngram) == 1:
            if "<unk>" in self.vocab:
                return self._probs[("<unk>",)]
            return self.unk_score
        return (self._backoffs.get(ngram[:-1], 0.0)
                + self._score(ngram[1:]))

    def start(self):
        return ("<s>",) if "<s>" in self.vocab else ()

    def score(self, state, word: str):
        if word not in self.vocab and "<unk>" in self.vocab:
            word = "<unk>"
        ngram = state + (word,)
        ngram = ngram[-self.order:]
        logp = self._score(ngram)
        new_state = ngram[-(self.order - 1):] if self.order > 1 else ()
        return new_state, logp

    def finish(self, state) -> float:
        if "</s>" not in self.vocab:
            return 0.0
        return self.score(state, "</s>")[1]


# ------------------------------------------------------------- decoder
class CTCDecoderOutput:
    """One n-best entry: ``tokens`` (list[int] token indices),
    ``words`` (list[str]), ``score`` (float), ``timesteps``
    (list[int], the frame each token was first emitted)."""

    __slots__ = ("tokens", "words", "score", "timesteps")

    def __init__(self, tokens, words, score, timesteps):
        self.tokens = list(tokens)
        self.words = list(words)
        self.score = float(score)
        self.timesteps = list(timesteps)

    def __repr__(self):
        return (f"CTCDecoderOutput(words={self.words}, "
                f"score={self.score:.4f})")


class _TrieNode:
    __slots__ = ("children", "words")

    def __init__(self):
        self.children: Dict[int, "_TrieNode"] = {}
        self.words: List[str] = []


def _load_pairs(source) -> List[Tuple[str, List[str]]]:
    """Lexicon as path / dict / iterable of 'word sp e l l i n g'."""
    if isinstance(source, dict):
        out = []
        for w, sp in source.items():
            for s in (sp if isinstance(sp[0], (list, tuple))
                      else [sp]):
                out.append((w, list(s)))
        return out
    if isinstance(source, str):
        with open(source, encoding="utf-8") as f:
            lines = f.read().splitlines()
    else:
        lines = list(source)
    out = []
    for line in lines:
        parts = line.split()
        if parts:
            out.append((parts[0], parts[1:]))
    return out


class CTCDecoder:
    """Built by :func:`ctc_decoder`; call with ``emissions
    (batch, time, classes)`` (or unbatched ``(time, classes)``)
    log-softmax outputs, a tensor on any device (copied to the host) or
    an array → ``List[List[CTCDecoderOutput]]`` (outer list = batch,
    inner = n-best)."""

    def __init__(self, *, trie, lm, tokens, nbest, beam_size,
                 beam_size_token, beam_threshold, lm_weight,
                 word_score, unk_score, sil_score, log_add,
                 blank_idx, sil_idx, unk_word):
        self._trie = trie
        self._lm = lm
        self.tokens = tokens
        self.nbest = nbest
        self.beam_size = beam_size
        self.beam_size_token = beam_size_token or len(tokens)
        self.beam_threshold = beam_threshold
        self.lm_weight = lm_weight
        self.word_score = word_score
        self.unk_score = unk_score
        self.sil_score = sil_score
        self.log_add = log_add
        self.blank_idx = blank_idx
        self.sil_idx = sil_idx
        self.unk_word = unk_word

    def idxs_to_tokens(self, idxs: Sequence[int]) -> List[str]:
        return [self.tokens[i] for i in idxs]

    # -- core search over one clip --------------------------------
    def _decode_one(self, lp: np.ndarray) -> List[CTCDecoderOutput]:
        lm = self._lm
        root = self._trie
        # hypothesis key: (trie node id, prev token, lm state)
        # value: (score, node, lm_state, tokens, timesteps, words)
        start = lm.start()
        beams = {(id(root), -1, start):
                 (0.0, root, start, (), (), ())}

        def _merge(d, key, cand):
            old = d.get(key)
            if old is None:
                d[key] = cand
            elif self.log_add:
                s = np.logaddexp(old[0], cand[0])
                d[key] = ((s,) + (cand[1:] if cand[0] >= old[0]
                                  else old[1:]))
            elif cand[0] > old[0]:
                d[key] = cand

        for t in range(lp.shape[0]):
            row = lp[t]
            # beam_size_token: only the top-k emissions expand
            top = np.argsort(row)[::-1][:self.beam_size_token]
            top_set = set(int(c) for c in top)
            new = {}
            for (nid, prev, _lms_key), \
                    (score, node, lms, toks, times, words) \
                    in beams.items():
                # 1) blank: keep everything, clear prev-repeat merge
                _merge(new, (nid, -1, _lms_key),
                       (score + row[self.blank_idx], node, lms, toks,
                        times, words))
                # 2) repeat previous non-blank token (no new emission)
                if prev >= 0 and prev in top_set:
                    _merge(new, (nid, prev, _lms_key),
                           (score + row[prev], node, lms, toks,
                            times, words))
                # 3) silence token: emit finished words at this node
                if self.sil_idx is not None and self.sil_idx != prev \
                        and self.sil_idx in top_set:
                    base = score + row[self.sil_idx] + self.sil_score
                    completions = node.words
                    if completions:
                        for w in completions:
                            s2, wlp = lm.score(lms, w)
                            _merge(new, (id(root), self.sil_idx, s2),
                                   (base + self.lm_weight * wlp
                                    + self.word_score, root, s2,
                                    toks + (self.sil_idx,),
                                    times + (t,), words + (w,)))
                    elif node is root:
                        # consecutive silence between words
                        _merge(new, (id(root), self.sil_idx, _lms_key),
                               (base, root, lms, toks + (self.sil_idx,),
                                times + (t,), words))
                    elif self.unk_word is not None \
                            and self.unk_score > -math.inf:
                        s2, wlp = lm.score(lms, self.unk_word)
                        _merge(new, (id(root), self.sil_idx, s2),
                               (base + self.lm_weight * wlp
                                + self.unk_score, root, s2,
                                toks + (self.sil_idx,), times + (t,),
                                words + (self.unk_word,)))
                # 4) advance the trie with a non-blank token
                for c, child in node.children.items():
                    if c == prev or c not in top_set:
                        continue
                    _merge(new, (id(child), c, _lms_key),
                           (score + row[c], child, lms, toks + (c,),
                            times + (t,), words))
            if not new:
                break
            ranked = sorted(new.items(), key=lambda kv: -kv[1][0])
            best = ranked[0][1][0]
            beams = dict(
                kv for kv in ranked[:self.beam_size]
                if kv[1][0] > best - self.beam_threshold)

        # finish: flush words completed at the current node (one
        # hypothesis PER homophone, as the in-loop silence path
        # does), then add the LM end-of-sentence score
        final = {}

        def _final(score, lms, toks, times, words):
            score = score + self.lm_weight * lm.finish(lms)
            key = (tuple(words), tuple(toks))
            if key not in final or final[key][0] < score:
                final[key] = (score, toks, times, words)

        for (nid, prev, _lms_key), \
                (score, node, lms, toks, times, words) in beams.items():
            if node.words:
                for w in node.words:
                    s2, wlp = lm.score(lms, w)
                    _final(score + self.lm_weight * wlp
                           + self.word_score, s2, toks, times,
                           words + (w,))
            elif node is not self._trie and self.unk_word is not None \
                    and self.unk_score > -math.inf:
                s2, wlp = lm.score(lms, self.unk_word)
                _final(score + self.lm_weight * wlp + self.unk_score,
                       s2, toks, times, words + (self.unk_word,))
            elif node is self._trie:
                _final(score, lms, toks, times, words)
            # else: dead-end partial word — dropped

        ranked = sorted(final.values(), key=lambda v: -v[0])
        return [CTCDecoderOutput(toks, words, score, times)
                for score, toks, times, words in ranked[:self.nbest]]

    def __call__(self, emissions, lengths=None
                 ) -> List[List[CTCDecoderOutput]]:
        if isinstance(emissions, torch.Tensor):
            emissions = emissions.detach().cpu().double().numpy()
        if isinstance(lengths, torch.Tensor):
            lengths = lengths.detach().cpu().tolist()
        lp = np.asarray(emissions, np.float64)
        squeeze = lp.ndim == 2
        if squeeze:
            lp = lp[None]
        if lp.ndim != 3:
            raise ValueError(
                "emissions must be (batch, time, classes)")
        if lengths is None:
            lengths = [lp.shape[1]] * lp.shape[0]
        out = [self._decode_one(lp[i, :int(lengths[i])])
               for i in range(lp.shape[0])]
        return out


def ctc_decoder(lexicon, tokens,
                lm: Optional[CTCDecoderLM] = None,
                nbest: int = 1,
                beam_size: int = 50,
                beam_size_token: Optional[int] = None,
                beam_threshold: float = 50.0,
                lm_weight: float = 2.0,
                word_score: float = 0.0,
                unk_score: float = -math.inf,
                sil_score: float = 0.0,
                log_add: bool = False,
                blank_token: str = "-",
                sil_token: Optional[str] = "|",
                unk_word: str = "<unk>") -> CTCDecoder:
    """Build a lexicon-constrained CTC beam decoder
    (torchaudio's ``models.decoder.ctc_decoder`` surface).

    ``lexicon``: path to a ``word sp e l l i n g`` file, a
    ``{word: spelling or [spellings]}`` dict, or an iterable of
    lines.  ``tokens``: the emission alphabet as a list or a path
    (one token per line; must contain ``blank_token``).  Pass
    ``sil_token=None`` for alphabets without a silence/word-boundary
    token (e.g. wordpieces, where boundaries live in the lexicon
    spellings); a non-``None`` ``sil_token`` must be in ``tokens``.
    ``lm`` defaults to :class:`ZeroLM`; pass :class:`ARPALM` (or any
    :class:`CTCDecoderLM`) for LM fusion with weight ``lm_weight``.
    """
    if isinstance(tokens, str):
        with open(tokens, encoding="utf-8") as f:
            tokens = [ln.strip() for ln in f if ln.strip()]
    tokens = list(tokens)
    tok_idx = {s: i for i, s in enumerate(tokens)}
    if blank_token not in tok_idx:
        raise ValueError(f"blank token {blank_token!r} not in tokens")
    if sil_token is not None and sil_token not in tok_idx:
        raise ValueError(f"sil token {sil_token!r} not in tokens")

    root = _TrieNode()
    for word, spelling in _load_pairs(lexicon):
        node = root
        for s in spelling:
            if s not in tok_idx:
                raise ValueError(
                    f"lexicon token {s!r} (word {word!r}) not in "
                    "tokens")
            node = node.children.setdefault(tok_idx[s], _TrieNode())
        node.words.append(word)
    if not root.children:
        raise ValueError("empty lexicon")

    return CTCDecoder(
        trie=root, lm=lm if lm is not None else ZeroLM(),
        tokens=tokens, nbest=nbest, beam_size=beam_size,
        beam_size_token=beam_size_token,
        beam_threshold=beam_threshold, lm_weight=lm_weight,
        word_score=word_score, unk_score=unk_score,
        sil_score=sil_score, log_add=log_add,
        blank_idx=tok_idx[blank_token],
        sil_idx=None if sil_token is None else tok_idx[sil_token],
        unk_word=unk_word)
