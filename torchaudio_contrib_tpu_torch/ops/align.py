"""CTC forced alignment (Viterbi over the blank-interleaved lattice).

Port of ``torchaudio_contrib_tpu/ops/align.py``: align a known transcript
to emission log-probs, any batch size (torchaudio's needs ``batch == 1``).

* The forward Viterbi pass is one loop over frames of tensor ops on
  ``(batch, S)`` (``S = 2L+1`` blank-interleaved states): a max over
  stay / advance / skip with its argmax (ties to the first, as
  ``jnp.argmax``) as an int8 back-pointer.
* The traceback is a second loop over frames, in reverse, that gathers
  each clip's back-pointer at its current state: both loops run on the
  device of ``log_probs``.
* ``input_lengths``/``target_lengths`` mask the padded lattice.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .ctcloss import _NEG, _labels, _lengths

__all__ = ["forced_align", "merge_tokens", "TokenSpan"]


@torch.no_grad()
def _viterbi(log_probs, targets, in_len, tgt_len, blank: int):
    """``(alignment (B, T) int32, scores (B, T))`` of the best paths."""
    b, t_max, n_classes = log_probs.shape
    dev = log_probs.device
    lab, idx, can_skip = _labels(targets, blank, n_classes)
    s_max = lab.shape[1]
    states = torch.arange(s_max, device=dev)
    alive = states < (2 * tgt_len + 1)[:, None]                  # (B, S)
    emit = log_probs.gather(2, idx[:, None, :].expand(b, t_max, s_max))
    emit_t = emit.transpose(0, 1)                                # (T, B, S)
    neg = torch.tensor(_NEG, dtype=emit.dtype, device=dev)

    delta = torch.where(states == 0, emit_t[0], neg)
    delta = torch.where(alive, delta, neg)
    if s_max > 1:
        delta = torch.where((states == 1) & (tgt_len > 0)[:, None],
                            emit_t[0], delta)
    deltas = torch.empty((t_max, b, s_max), dtype=emit.dtype, device=dev)
    bp = torch.zeros((t_max, b, s_max), dtype=torch.int8, device=dev)
    deltas[0] = delta
    for t in range(1, t_max):
        pad = F.pad(delta, (2, 0), value=_NEG)
        skip = torch.where(can_skip, pad[:, :-2], neg)
        best, choice = torch.stack([delta, pad[:, 1:-1], skip]).max(0)
        bp[t] = choice
        delta = torch.where(alive, best + emit_t[t], neg)
        deltas[t] = delta

    rows = torch.arange(b, device=dev)
    last = deltas[(in_len - 1).clamp(min=0), rows]               # (B, S)
    end_blank = 2 * tgt_len
    end_tok = (2 * tgt_len - 1).clamp(min=0)
    s = torch.where(last[rows, end_blank] >= last[rows, end_tok],
                    end_blank, end_tok)

    # traceback: past a clip's length its state stays at the end state
    path = torch.empty((t_max, b), dtype=torch.long, device=dev)
    inside = torch.arange(t_max, device=dev)[:, None] < in_len[None, :]
    for t in range(t_max - 1, 0, -1):
        path[t] = s
        step = bp[t].gather(1, s[:, None])[:, 0].long() * inside[t]
        s = (s - step).clamp(0, s_max - 1)
    path[0] = s
    path = path.T                                                # (B, T)
    inside = inside.T
    alignment = torch.where(inside, lab.gather(1, path), blank)
    scores = torch.where(inside, emit.gather(2, path[..., None])[..., 0],
                         torch.zeros((), dtype=emit.dtype, device=dev))
    return alignment.int(), scores


def forced_align(log_probs, targets, input_lengths=None,
                 target_lengths=None, blank: int = 0):
    """Align transcripts to CTC emissions (Viterbi, batched).

    ``log_probs`` is ``(batch, time, n_classes)`` log-softmax emissions;
    ``targets`` ``(batch, L)`` token ids (``blank`` must not appear);
    lengths default to the full padded sizes.  Returns ``(alignments
    (batch, time) int32, scores (batch, time))`` — the blank-expanded
    frame labels of the best path and each frame's emission log-prob
    (``blank`` / 0 past ``input_lengths``), on the device of
    ``log_probs``.
    """
    log_probs = torch.as_tensor(log_probs)
    dev = log_probs.device
    targets = torch.as_tensor(targets, device=dev).long()
    if log_probs.ndim != 3 or targets.ndim != 2:
        raise ValueError(
            "log_probs must be (batch, time, classes), targets "
            "(batch, length)")
    b, t_max, _ = log_probs.shape
    in_len = _lengths(input_lengths, b, t_max, dev)
    tgt_len = _lengths(target_lengths, b, targets.shape[1], dev)
    return _viterbi(log_probs, targets, in_len, tgt_len, blank)


class TokenSpan:
    """One aligned token occurrence: ``token`` over frames
    ``[start, end)`` with the mean of its frame ``score`` s."""

    __slots__ = ("token", "start", "end", "score")

    def __init__(self, token, start, end, score):
        self.token, self.start = int(token), int(start)
        self.end, self.score = int(end), float(score)

    def __len__(self):
        return self.end - self.start

    def __repr__(self):
        return (f"TokenSpan(token={self.token}, start={self.start}, "
                f"end={self.end}, score={self.score:.4f})")

    def __eq__(self, other):
        return (isinstance(other, TokenSpan)
                and (self.token, self.start, self.end)
                == (other.token, other.start, other.end))


def merge_tokens(tokens, scores, blank: int = 0):
    """Collapse a frame-level alignment into ``TokenSpan`` s.

    ``tokens``/``scores`` are one sequence's ``(time,)`` outputs of
    :func:`forced_align` (tensors on any device, or arrays); they are
    copied to the host, where the spans are built (a variable-length
    output).  Consecutive equal non-blank frames form one span; a span's
    ``score`` is the mean of its frame scores.
    """
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.detach().cpu()
    if isinstance(scores, torch.Tensor):
        scores = scores.detach().cpu()
    tokens = np.asarray(tokens)
    scores = np.asarray(scores)
    if tokens.ndim != 1 or scores.shape != tokens.shape:
        raise ValueError("merge_tokens takes one sequence: tokens and "
                         "scores must both be (time,)")
    t_len = tokens.shape[0]
    spans = []
    start = None
    for t in range(t_len + 1):
        here = int(tokens[t]) if t < t_len else blank
        if start is not None and (t == t_len or here != int(tokens[start])):
            spans.append(TokenSpan(tokens[start], start, t,
                                   scores[start:t].mean()))
            start = None
        if t < t_len and here != blank and start is None:
            start = t
    return spans
