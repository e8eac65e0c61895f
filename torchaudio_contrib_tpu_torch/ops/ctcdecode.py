"""CTC decoding: batched greedy and beam search on the device, prefix beam
search on the host.

Port of ``torchaudio_contrib_tpu/ops/ctcdecode.py``:

* :func:`ctc_greedy_decode` — argmax, collapse repeats, drop blanks, all
  on the device of the emissions: the collapse is a keep-mask and a cumsum
  compaction scatter.
* :func:`ctc_beam_decode` — prefix beam search with a fixed beam and a
  fixed token buffer, one step of tensor ops per frame over the whole
  batch; the prefix merge is the (child, parent) one-token-extension mask
  of the JAX package (:func:`_ctc_beam_frame`).
* :func:`ctc_prefix_beam_search` — the dict-of-prefixes search over one
  clip in float64 on the host, as the JAX package keeps it: its input is
  copied to the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.trace import span
from .ctcloss import _lengths

__all__ = ["ctc_greedy_decode", "ctc_prefix_beam_search",
           "ctc_beam_decode", "CTCHypothesis"]


def ctc_greedy_decode(log_probs, input_lengths=None, blank: int = 0,
                      pad_value: int = -1):
    """Best-path CTC decode, batched, on the device of ``log_probs``.

    ``log_probs`` ``(batch, time, classes)``; frames past
    ``input_lengths`` are ignored.  Returns ``(tokens, lengths,
    scores)``: ``tokens`` ``(batch, time)`` int32 holds each clip's
    collapsed label sequence left-packed and padded with ``pad_value``;
    ``lengths`` ``(batch,)`` int32 the number of valid labels; ``scores``
    ``(batch,)`` the summed frame log-probs of the best path.  Marked as
    the span ``ctc.greedy`` (``utils.trace``).
    """
    with span("ctc.greedy"):
        return _greedy(torch.as_tensor(log_probs), input_lengths, blank,
                       pad_value)


def _greedy(log_probs, input_lengths, blank, pad_value):
    if log_probs.ndim != 3:
        raise ValueError("log_probs must be (batch, time, classes)")
    b, t_max, _ = log_probs.shape
    dev = log_probs.device
    in_len = _lengths(input_lengths, b, t_max, dev)

    best, path = log_probs.max(-1)                          # (B, T)
    inside = torch.arange(t_max, device=dev)[None, :] < in_len[:, None]
    scores = torch.where(inside, best, torch.zeros_like(best)).sum(-1)
    prev = torch.cat([torch.full((b, 1), -1, dtype=path.dtype, device=dev),
                      path[:, :-1]], 1)
    keep = (path != blank) & (path != prev) & inside
    pos = keep.long().cumsum(-1) - 1                        # target slot
    lengths = keep.sum(-1).int()
    # dropped frames go to a scratch column past the output
    cols = torch.where(keep, pos, torch.full_like(pos, t_max))
    out = torch.full((b, t_max + 1), pad_value, dtype=torch.long,
                     device=dev)
    out.scatter_(1, cols, torch.where(keep, path, torch.zeros_like(path)))
    return out[:, :t_max].int(), lengths, scores


class CTCHypothesis:
    """One beam-search result: ``tokens`` (list[int]) and its total
    log-probability ``score`` (sum over all alignments)."""

    __slots__ = ("tokens", "score")

    def __init__(self, tokens, score):
        self.tokens, self.score = list(tokens), float(score)

    def __repr__(self):
        return f"CTCHypothesis(tokens={self.tokens}, score={self.score:.4f})"


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[b, idx[b, k], ...]``: rows of ``a (B, K, ...)`` by slot."""
    if a.ndim == 2:
        return a.gather(1, idx)
    return a.gather(1, idx[..., None].expand(-1, -1, a.shape[-1]))


def _ctc_beam_frame(carry, row, valid, blank: int, L: int):
    """Advance every clip's prefix beam by one frame (batched over clips
    and beam slots; one step of :func:`ctc_prefix_beam_search`).

    A merge of two prefixes can only happen between "extend prefix p by
    token c" and a beam entry j with ``prefix_j == prefix_p + (c,)`` (two
    distinct prefixes' extensions differ once their last token is
    dropped), so the host's dict merge is the (child, parent)
    one-token-extension mask over the current beam.
    """
    toks, lens, pb, pnb = carry            # (B,K,L) (B,K) (B,K) (B,K)
    B, K = lens.shape
    V = row.shape[-1]
    dev = row.device
    # a fill on the device, not a host copy: the step runs inside a CUDA
    # graph capture (utils.device_loop)
    neg = torch.full((), -math.inf, dtype=row.dtype, device=dev)
    total = torch.logaddexp(pb, pnb)
    has = lens > 0
    last = toks.gather(2, (lens - 1).clamp(min=0)[..., None])[..., 0]

    # parent_mask[b, j, p]: prefix_j extends prefix_p by exactly one token
    pos = torch.arange(L, device=dev)
    len_ok = lens[:, :, None] == lens[:, None, :] + 1       # (B,Kc,Kp)
    inside_p = pos[None, None, None, :] < lens[:, None, :, None]
    same_tok = toks[:, :, None, :] == toks[:, None, :, :]   # (B,Kc,Kp,L)
    parent_mask = len_ok & (same_tok | ~inside_p).all(-1)

    # each parent p extended by c = last_j
    row_c = row.gather(1, last)                              # (B,Kc)
    par_rep = has[:, None, :] & (last[:, None, :] == last[:, :, None])
    base = torch.where(par_rep, pb[:, None, :], total[:, None, :])
    contrib = torch.where(parent_mask, base + row_c[..., None], neg)
    parent_contrib = torch.logsumexp(contrib, -1)            # (B,Kc)

    # "same prefix" candidates; structural duplicates (only ever filler
    # of -inf mass) drop to -inf so that no prefix's mass lands twice
    eq = (lens[:, :, None] == lens[:, None, :]) & same_tok.all(-1)
    dup = torch.tril(eq, -1).any(-1)                         # (B,K)
    pb_s = torch.where(dup, neg, total + row[:, None, blank])
    pnb_s = torch.where(dup, neg, torch.logaddexp(
        torch.where(has, pnb + row_c, neg), parent_contrib))
    score_s = torch.logaddexp(pb_s, pnb_s)

    # extensions (B, K, V): repeating the last token needs a blank between
    ext_rep = (torch.arange(V, device=dev)[None, None, :] == last[..., None]) \
        & has[..., None]
    ext = torch.where(ext_rep, pb[..., None], total[..., None]) \
        + row[:, None, :]
    ext[..., blank] = neg
    # an extension that is already a beam entry was folded into its pnb
    killed = (parent_mask[..., None]
              & (torch.arange(V, device=dev) == last[..., None])[:, :, None]
              & has[:, :, None, None]).any(1)                # (B,Kp,V)
    ext = torch.where(killed | (lens >= L)[..., None], neg, ext)

    top, idx = torch.cat([score_s, ext.reshape(B, K * V)], 1).topk(K, 1)
    is_same = idx < K
    src = torch.where(is_same, idx, (idx - K) // V)
    tok_c = (idx - K) % V
    new_toks = _take(toks, src)
    new_lens = _take(lens, src)
    hit = (pos[None, None, :] == new_lens[..., None]) & ~is_same[..., None]
    new_toks = torch.where(hit, tok_c[..., None], new_toks)
    new_pb = torch.where(is_same, _take(pb_s, src), neg)
    new_pnb = torch.where(is_same, _take(pnb_s, src), top)
    new_lens = torch.where(is_same, new_lens, (new_lens + 1).clamp(max=L))

    v = valid[:, None]
    return (torch.where(v[..., None], new_toks, toks),
            torch.where(v, new_lens, lens), torch.where(v, new_pb, pb),
            torch.where(v, new_pnb, pnb))


@torch.no_grad()
def ctc_beam_decode(log_probs, input_lengths=None,
                    beam_width: int = 16, blank: int = 0,
                    max_tokens: int | None = None,
                    pad_value: int = -1):
    """Batched prefix beam search on the device of ``log_probs`` (the
    counterpart of :func:`ctc_prefix_beam_search` — same algorithm, fixed
    beam width, the whole batch one frame at a time).

    ``log_probs`` ``(batch, time, classes)`` log-softmax emissions;
    frames past ``input_lengths`` are ignored.  Returns ``(tokens,
    lengths, scores)``: ``tokens`` ``(batch, beam_width, max_tokens)``
    int32 label sequences ranked by posterior (padded with
    ``pad_value``), ``lengths`` ``(batch, beam_width)`` int32, ``scores``
    ``(batch, beam_width)`` — the log TOTAL label-sequence probability,
    summed over alignments (``-inf`` marks unused beam slots).
    ``max_tokens`` bounds output length (default: ``time``).  Slots of
    equal score (``-inf`` ones above all) may come in another order than
    the JAX package's ``lax.top_k`` gives.
    """
    log_probs = torch.as_tensor(log_probs)
    if log_probs.ndim != 3:
        raise ValueError("log_probs must be (batch, time, classes)")
    B, T, V = log_probs.shape
    dev = log_probs.device
    in_len = _lengths(input_lengths, B, T, dev)
    if blank < 0:
        blank += V
    K, L = int(beam_width), (T if max_tokens is None else int(max_tokens))
    toks = torch.zeros((B, K, L), dtype=torch.long, device=dev)
    lens = torch.zeros((B, K), dtype=torch.long, device=dev)
    pb = torch.full((B, K), -math.inf, dtype=log_probs.dtype, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full_like(pb, -math.inf)
    carry = (toks, lens, pb, pnb)
    for t in range(T):
        carry = _ctc_beam_frame(carry, log_probs[:, t], t < in_len,
                                blank, L)
    toks, lens, pb, pnb = carry
    scores, order = torch.logaddexp(pb, pnb).sort(dim=1, descending=True,
                                                  stable=True)
    toks, lens = _take(toks, order), _take(lens, order)
    toks = torch.where(torch.arange(L, device=dev) < lens[..., None], toks,
                       pad_value)
    return toks.int(), lens.int(), scores


def ctc_prefix_beam_search(log_probs, beam_width: int = 16,
                           blank: int = 0, nbest: int = 1,
                           input_length=None):
    """Prefix beam search over one clip's emissions (host, float64).

    ``log_probs`` ``(time, classes)`` log-softmax emissions, a tensor on
    any device (copied to the host) or an array.  Returns the ``nbest``
    highest-posterior label sequences as :class:`CTCHypothesis` (score =
    log of the TOTAL probability of the label sequence, summed over
    alignments — not a single best path).
    """
    if isinstance(log_probs, torch.Tensor):
        log_probs = log_probs.detach().cpu().double().numpy()
    lp = np.asarray(log_probs, np.float64)
    if lp.ndim != 2:
        raise ValueError("log_probs must be (time, classes)")
    if input_length is not None:
        lp = lp[:int(input_length)]
    t_max, n_classes = lp.shape
    if blank < 0:
        blank += n_classes

    # prefix -> [log p(ending in blank), log p(ending in non-blank)]
    beams = {(): [0.0, -math.inf]}
    for t in range(t_max):
        row = lp[t]
        new = {}

        def _add(prefix, which, val):
            cur = new.setdefault(prefix, [-math.inf, -math.inf])
            cur[which] = np.logaddexp(cur[which], val)

        for prefix, (pb, pnb) in beams.items():
            total = np.logaddexp(pb, pnb)
            _add(prefix, 0, total + row[blank])          # extend blank
            if prefix:
                # repeat last symbol without a blank: merges into the
                # SAME prefix only from the non-blank mass
                _add(prefix, 1, pnb + row[prefix[-1]])
            for c in range(n_classes):
                if c == blank:
                    continue
                ext = prefix + (c,)
                if prefix and c == prefix[-1]:
                    # need a blank in between: only the blank mass
                    _add(ext, 1, pb + row[c])
                else:
                    _add(ext, 1, total + row[c])
        beams = dict(sorted(
            new.items(),
            key=lambda kv: -np.logaddexp(kv[1][0], kv[1][1])
        )[:beam_width])

    ranked = sorted(
        ((np.logaddexp(pb, pnb), prefix)
         for prefix, (pb, pnb) in beams.items()), key=lambda x: -x[0])
    return [CTCHypothesis(prefix, score)
            for score, prefix in ranked[:nbest]]
