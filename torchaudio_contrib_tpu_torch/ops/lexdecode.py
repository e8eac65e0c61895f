"""Device-side lexicon-constrained CTC beam search.

Port of ``torchaudio_contrib_tpu/ops/lexdecode.py``.
``models/decoder.py::CTCDecoder`` is the host search (flashlight's
dict-of-hypotheses algorithm); this module is its device counterpart: the
trie is flattened on the host into tables, and the search becomes one step
of tensor ops per frame over the whole batch with a fixed beam, like
``ops/ctcdecode.py::ctc_beam_decode``:

* ``child (N, V)`` — trie node × token → child id (−1);
* ``words_at (N, W)`` — word ids completable at a node (W = most
  homophones, padded −1);
* an order-≤2 n-gram LM compiled to dense ``lm_score (S, Nw)`` /
  ``lm_finish (S,)`` tables over LM *states* (start + one per word —
  exact for unigram/bigram ARPA models and ZeroLM; higher orders keep
  the host decoder, whose state space is no longer word-indexed).

A hypothesis per (clip, beam slot) is ``(trie node, previous token, LM
state, score)`` — the host's dict key — plus bounded token / word /
timestep buffers.  Each frame every slot fans out into ``3 + W + V``
candidates (blank, repeat, root silence, W silence word completions, V
trie advances); candidates with equal keys are max-merged (ties to the
lowest index) before ``torch.topk`` keeps K, as the host's
``log_add=False`` merge does.

Boundaries (loud errors, as the host's): ``log_add`` merging, ``unk_word``
emission and LM order > 2 are host-only; ``beam_threshold`` is ignored
(pure top-K keeps a superset of the thresholded beam — compare against a
host decoder built with ``beam_threshold=math.inf``).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .ctcdecode import _take
from .ctcloss import _lengths

__all__ = ["LexiconTables", "CompiledLexicon", "compile_lexicon_tables",
           "ctc_lexicon_beam_decode", "DeviceCTCDecoder",
           "device_ctc_decoder"]

_NEG = -math.inf


class LexiconTables(NamedTuple):
    """Tensor half of a compiled (trie, LM) pair (LM state 0 is always
    the start state)."""
    child: torch.Tensor        # (N, V) int64, -1 = no child
    words_at: torch.Tensor     # (N, W) int64 word ids, -1 pad
    lm_score: torch.Tensor     # (S, Nw) f32 log10 P(word | state)
    lm_finish: torch.Tensor    # (S,) f32 log10 P(</s> | state)
    word_state: torch.Tensor   # (Nw,) int64 LM state after a word

    def to(self, device) -> "LexiconTables":
        return LexiconTables(*(t.to(device) for t in self))


class CompiledLexicon(NamedTuple):
    """:func:`compile_lexicon_tables` result: the tables (CPU tensors)
    plus the host-side word-id → string map."""
    tables: LexiconTables
    words: tuple


def compile_lexicon_tables(decoder) -> CompiledLexicon:
    """Flatten a host :class:`~..models.decoder.CTCDecoder`'s trie and
    LM into :class:`LexiconTables`, on the host.  The LM must be ZeroLM
    or an ARPA model of order ≤ 2 (bigram) — those have a word-indexed
    state space that fits a dense table."""
    from ..models.decoder import ZeroLM
    root = decoder._trie
    lm = decoder._lm
    V = len(decoder.tokens)

    # BFS node ids (root = 0)
    nodes, ids = [root], {id(root): 0}
    for node in nodes:
        for c in sorted(node.children):
            ch = node.children[c]
            if id(ch) not in ids:
                ids[id(ch)] = len(nodes)
                nodes.append(ch)
    N = len(nodes)
    child = np.full((N, V), -1, np.int64)
    W = max((len(n.words) for n in nodes), default=0) or 1
    words_at = np.full((N, W), -1, np.int64)
    word_list: List[str] = []
    word_id = {}
    for ni, node in enumerate(nodes):
        for c, ch in node.children.items():
            child[ni, c] = ids[id(ch)]
        for wi, w in enumerate(node.words):
            if w not in word_id:
                word_id[w] = len(word_list)
                word_list.append(w)
            words_at[ni, wi] = word_id[w]
    Nw = max(len(word_list), 1)

    order = getattr(lm, "order", 1 if isinstance(lm, ZeroLM) else None)
    if order is None or order > 2:
        raise NotImplementedError(
            f"device lexicon decode compiles LM states to a dense "
            f"table — ZeroLM or ARPA order <= 2 only (got order="
            f"{order}); use the host CTCDecoder for higher orders")

    # LM states: start + the (context-independent, order <= 2) post-word
    # state of every lexicon word
    start = lm.start()
    states = [start]
    state_id = {start: 0}
    word_state = np.zeros((Nw,), np.int64)
    for wi, w in enumerate(word_list):
        s2, _ = lm.score(start, w)
        if s2 not in state_id:
            state_id[s2] = len(states)
            states.append(s2)
        word_state[wi] = state_id[s2]
    S = len(states)
    lm_score = np.zeros((S, Nw), np.float32)
    lm_finish = np.zeros((S,), np.float32)
    for si, st in enumerate(states):
        lm_finish[si] = lm.finish(st)
        for wi, w in enumerate(word_list):
            lm_score[si, wi] = lm.score(st, w)[1]

    return CompiledLexicon(
        tables=LexiconTables(*(torch.from_numpy(a) for a in (
            child, words_at, lm_score, lm_finish, word_state))),
        words=tuple(word_list))


def _merge_dedup(key: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Max-merge candidates of equal ``key`` ``(B, C)``: keep the best
    (ties → lowest index), mark the rest ``-inf``."""
    idx = torch.arange(scores.shape[1], device=scores.device)
    better = (scores[:, None, :] > scores[:, :, None]) | (
        (scores[:, None, :] == scores[:, :, None])
        & (idx[None, :] < idx[:, None]))
    drop = ((key[:, :, None] == key[:, None, :]) & better).any(-1)
    return torch.where(drop, _NEG, scores)


def _append(buf, n, value, ok, pos):
    """Write ``value`` at position ``n`` of each slot's buffer where
    ``ok``; returns the buffer and the new lengths."""
    hit = (pos == n[..., None]) & ok[..., None]
    return torch.where(hit, value[..., None], buf), n + ok


@torch.no_grad()
def _lex_beam_run(log_probs, in_len, tables: LexiconTables, K: int, L: int,
                  blank: int, sil: int, lm_weight: float, word_score: float,
                  sil_score: float, pad_value: int):
    B, T, V = log_probs.shape
    N, W = tables.words_at.shape
    S = tables.lm_score.shape[0]
    C = 3 + W + V
    dev = log_probs.device
    full_i = lambda v, *shape: torch.full(shape, v, dtype=torch.long,
                                          device=dev)

    node = full_i(0, B, K)
    prev = full_i(-1, B, K)
    lmst = full_i(0, B, K)                   # state 0 = start
    score = torch.full((B, K), _NEG, dtype=log_probs.dtype, device=dev)
    score[:, 0] = 0.0
    toks, times, wids = (full_i(pad_value, B, K, L), full_i(-1, B, K, L),
                         full_i(-1, B, K, L))
    lens, wlens = full_i(0, B, K), full_i(0, B, K)
    tok_ids = torch.arange(V, device=dev).expand(B, K, V)
    pos = torch.arange(L, device=dev)
    sil_i = max(sil, 0)

    for t in range(T):
        row = log_probs[:, t]
        ext_child = tables.child[node]                       # (B,K,V)
        node_words = tables.words_at[node]                   # (B,K,W)
        wid_safe = node_words.clamp(min=0)

        # candidates (B, K, C): 0 blank, 1 repeat, 2 root silence,
        # 3..3+W silence word completions, 3+W.. trie advances
        c_blank = score + row[:, blank, None]
        c_rep = torch.where(prev >= 0, score + row.gather(
            1, prev.clamp(min=0)), _NEG)
        if sil >= 0:
            sil_ok = prev != sil
            sil_base = score + row[:, sil, None] + sil_score
        else:
            sil_ok = torch.zeros_like(prev, dtype=torch.bool)
            sil_base = score + sil_score
        c_root = torch.where(sil_ok & (node == 0)
                             & (node_words < 0).all(-1), sil_base, _NEG)
        wlp = tables.lm_score[lmst[..., None], wid_safe]     # (B,K,W)
        c_word = torch.where(
            (node_words >= 0) & sil_ok[..., None],
            sil_base[..., None] + lm_weight * wlp + word_score, _NEG)
        ext_ok = (ext_child >= 0) & (tok_ids != prev[..., None])
        c_ext = torch.where(ext_ok, score[..., None] + row[:, None], _NEG)
        full = (lens >= L)[..., None]      # buffers full: no emission
        cscore = torch.cat([
            c_blank[..., None], c_rep[..., None],
            torch.where(full, _NEG, torch.cat([c_root[..., None], c_word,
                                               c_ext], -1))], -1)
        cnode = torch.cat([node[..., None], node[..., None],
                           full_i(0, B, K, 1 + W), ext_child.clamp(min=0)],
                          -1)
        cprev = torch.cat([full_i(-1, B, K, 1), prev[..., None],
                           full_i(sil_i, B, K, 1 + W), tok_ids], -1)
        clmst = torch.cat([lmst[..., None].expand(B, K, 3),
                           tables.word_state[wid_safe],
                           lmst[..., None].expand(B, K, V)], -1)
        ctok = torch.cat([full_i(-1, B, K, 2), full_i(sil_i, B, K, 1 + W),
                          tok_ids], -1)
        cword = torch.cat([full_i(-1, B, K, 3), wid_safe,
                           full_i(-1, B, K, V)], -1)
        cword = torch.where(cscore > _NEG, cword, -1)

        # exact max-merge by key (node, prev, LM state), then top-K
        key = ((cnode * (V + 1) + cprev + 1) * S + clmst).reshape(B, K * C)
        fscore = _merge_dedup(key, cscore.reshape(B, K * C))
        top, idx = fscore.topk(K, 1)
        g = lambda a: a.reshape(B, K * C).gather(1, idx)
        src = idx // C
        tok_sel, word_sel = g(ctok), g(cword)
        alive = top > _NEG
        ok = (tok_sel >= 0) & alive
        n_lens = _take(lens, src)
        hit = (pos == n_lens[..., None]) & ok[..., None]
        n_toks = torch.where(hit, tok_sel[..., None], _take(toks, src))
        n_times = torch.where(hit, t, _take(times, src))
        n_lens = n_lens + ok
        n_wids, n_wlens = _append(_take(wids, src), _take(wlens, src),
                                  word_sel, (word_sel >= 0) & alive, pos)

        v = (t < in_len)[:, None]
        node = torch.where(v, g(cnode), node)
        prev = torch.where(v, g(cprev), prev)
        lmst = torch.where(v, g(clmst), lmst)
        score = torch.where(v, top, score)
        toks = torch.where(v[..., None], n_toks, toks)
        times = torch.where(v[..., None], n_times, times)
        lens = torch.where(v, n_lens, lens)
        wids = torch.where(v[..., None], n_wids, wids)
        wlens = torch.where(v, n_wlens, wlens)

    # final flush: complete words at the node, LM </s>
    node_words = tables.words_at[node]                       # (B,K,W)
    wid_safe = node_words.clamp(min=0)
    wlp = tables.lm_score[lmst[..., None], wid_safe]
    fin_w = torch.where(
        node_words >= 0,
        score[..., None] + lm_weight * (
            wlp + tables.lm_finish[tables.word_state[wid_safe]])
        + word_score, _NEG)                                  # (B,K,W)
    fin_root = torch.where(
        (node == 0) & (node_words < 0).all(-1),
        score + lm_weight * tables.lm_finish[lmst], _NEG)    # (B,K)
    fscores = torch.cat([fin_root[..., None], fin_w], -1).reshape(
        B, K * (1 + W))
    top, idx = fscores.topk(K, 1)
    src = idx // (1 + W)
    slot = idx % (1 + W)                      # 0 = root, 1.. = word w
    toks, times, wids = _take(toks, src), _take(times, src), _take(wids, src)
    lens, wlens = _take(lens, src), _take(wlens, src)
    add_w = torch.cat([full_i(-1, B, K, 1), wid_safe], -1).reshape(
        B, K * (1 + W)).gather(1, idx)
    wids, wlens = _append(wids, wlens, add_w, (slot > 0) & (top > _NEG), pos)
    toks = torch.where(pos < lens[..., None], toks, pad_value)
    return (toks.int(), times.int(), lens.int(), wids.int(), wlens.int(),
            top)


def ctc_lexicon_beam_decode(log_probs, tables: LexiconTables,
                            input_lengths=None, *,
                            beam_width: int = 16, blank: int = 0,
                            sil: Optional[int] = None,
                            lm_weight: float = 2.0,
                            word_score: float = 0.0,
                            sil_score: float = 0.0,
                            max_tokens: Optional[int] = None,
                            pad_value: int = -1):
    """Lexicon + LM beam search over a whole batch, on the device of
    ``log_probs`` (the tables are moved there).

    ``log_probs (batch, time, classes)`` log-softmax emissions.
    Returns ``(tokens, timesteps, lengths, word_ids, word_lengths,
    scores)``, each leading ``(batch, beam_width)``, ranked by final
    score (``-inf`` = dead/unused slot; word ids index
    ``CompiledLexicon.words``).  Scores are Viterbi-style max-merged — the
    host :class:`~..models.decoder.CTCDecoder` default (``log_add=False``).
    """
    log_probs = torch.as_tensor(log_probs)
    if log_probs.ndim != 3:
        raise ValueError("log_probs must be (batch, time, classes)")
    B, T, V = log_probs.shape
    if isinstance(tables, CompiledLexicon):
        tables = tables.tables
    if tables.child.shape[1] != V:
        raise ValueError(
            f"tables were compiled for {tables.child.shape[1]} "
            f"tokens, emissions have {V}")
    dev = log_probs.device
    if tables.child.device != dev:
        tables = tables.to(dev)
    in_len = _lengths(input_lengths, B, T, dev)
    L = T if max_tokens is None else int(max_tokens)
    return _lex_beam_run(
        log_probs, in_len, tables, int(beam_width), L, int(blank),
        -1 if sil is None else int(sil), float(lm_weight),
        float(word_score), float(sil_score), int(pad_value))


class DeviceCTCDecoder:
    """Device counterpart of the host :class:`~..models.decoder.CTCDecoder`
    (build it with :func:`device_ctc_decoder`): the same ``__call__``
    contract, returning the same ``CTCDecoderOutput`` n-best lists.  The
    search runs on the device of ``emissions`` in float32; the n-best
    lists are read back on the host."""

    def __init__(self, compiled, *, nbest, beam_size, lm_weight,
                 word_score, sil_score, blank_idx, sil_idx):
        self.tables = compiled.tables
        self.words = compiled.words
        self.nbest = nbest
        self.beam_size = beam_size
        self.lm_weight = lm_weight
        self.word_score = word_score
        self.sil_score = sil_score
        self.blank_idx = blank_idx
        self.sil_idx = sil_idx

    def __call__(self, emissions, lengths=None):
        from ..models.decoder import CTCDecoderOutput
        lp = torch.as_tensor(emissions).float()
        if lp.ndim == 2:
            lp = lp[None]
        out_t = ctc_lexicon_beam_decode(
            lp, self.tables, input_lengths=lengths,
            beam_width=self.beam_size, blank=self.blank_idx,
            sil=self.sil_idx, lm_weight=self.lm_weight,
            word_score=self.word_score, sil_score=self.sil_score)
        toks, times, lens, wids, wlens, scores = (a.cpu().numpy()
                                                  for a in out_t)
        out = []
        for b in range(toks.shape[0]):
            hyps, seen = [], set()
            for k in range(toks.shape[1]):
                if not np.isfinite(scores[b, k]) \
                        or len(hyps) >= self.nbest:
                    continue
                n, wn = int(lens[b, k]), int(wlens[b, k])
                tk = tuple(toks[b, k, :n].tolist())
                wd = tuple(wids[b, k, :wn].tolist())
                if (tk, wd) in seen:   # the host's _final dedups by key
                    continue
                seen.add((tk, wd))
                hyps.append(CTCDecoderOutput(
                    list(tk), [self.words[i] for i in wd],
                    float(scores[b, k]), times[b, k, :n].tolist()))
            out.append(hyps)
        return out


def device_ctc_decoder(decoder) -> DeviceCTCDecoder:
    """Compile a host :class:`~..models.decoder.CTCDecoder` into its
    device form.  Raises for the host-only features (``log_add``
    merging, enabled ``unk``, LM order > 2); ``beam_threshold`` is
    ignored (top-K keeps a superset)."""
    if decoder.log_add:
        raise NotImplementedError(
            "device lexicon decode merges with max (log_add=False); "
            "use the host CTCDecoder for log_add")
    if decoder.unk_word is not None \
            and decoder.unk_score > -math.inf:
        raise NotImplementedError(
            "unk-word emission is host-only (unbounded state); build "
            "the decoder with unk_score=-math.inf")
    compiled = compile_lexicon_tables(decoder)
    return DeviceCTCDecoder(
        compiled, nbest=decoder.nbest, beam_size=decoder.beam_size,
        lm_weight=decoder.lm_weight, word_score=decoder.word_score,
        sil_score=decoder.sil_score, blank_idx=decoder.blank_idx,
        sil_idx=decoder.sil_idx)
