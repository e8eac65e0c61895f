"""Levenshtein edit distance (the WER/CER building block).

Port of ``torchaudio_contrib_tpu/ops/edit.py``.  :func:`edit_distance` is
the host DP over two sequences of any element type, as torchaudio's.
:func:`edit_distance_batched` scores a padded batch on the device of its
input: one step per reference token, in which the row recurrence

    new[j] = min(row[j] + 1, row[j-1] + cost_j, new[j-1] + 1)

has its sequential insertion chain (``new[j-1] + 1``) solved in closed
form, ``new[j] = j + cummin_{k<=j}(tmp[k] - k)``, by ``torch.cummin``.
"""
from __future__ import annotations

import numpy as np
import torch

from .ctcloss import _lengths

__all__ = ["edit_distance", "edit_distance_batched"]


def edit_distance(seq1, seq2) -> int:
    """Levenshtein distance between two sequences (host-side, eager).

    Accepts any element type with ``!=`` (token ids, chars, words),
    like torchaudio's version.  Unit costs for insert/delete/substitute.
    """
    a = list(seq1)
    b = list(seq2)
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    b_arr = np.empty(m, object)
    b_arr[:] = b
    js = np.arange(m + 1)
    row = js.copy()
    for i in range(1, n + 1):
        cost = (b_arr != a[i - 1]).astype(np.int64)
        tmp = np.minimum(row[1:] + 1, row[:-1] + cost)
        g = np.concatenate([[i], tmp - js[1:]])
        row = np.minimum.accumulate(g) + js
    return int(row[m])


def edit_distance_batched(refs, hyps, ref_lengths=None, hyp_lengths=None):
    """Batched Levenshtein distance, on the device of ``refs``.

    ``refs`` ``(batch, N)`` / ``hyps`` ``(batch, M)`` padded int token
    ids; lengths default to the padded sizes.  Returns ``(batch,)``
    int32: one step of a few tensor ops per reference position.
    """
    refs = torch.as_tensor(refs)
    hyps = torch.as_tensor(hyps, device=refs.device)
    if refs.ndim != 2 or hyps.ndim != 2:
        raise ValueError("refs and hyps must be (batch, length)")
    b, n = refs.shape
    m = hyps.shape[1]
    dev = refs.device
    refs, hyps = refs.long(), hyps.long()
    ref_len = _lengths(ref_lengths, b, n, dev)
    hyp_len = _lengths(hyp_lengths, b, m, dev)
    js = torch.arange(m + 1, device=dev)
    row = js.expand(b, m + 1)
    for i in range(n):
        cost = (refs[:, i:i + 1] != hyps).long()
        tmp = torch.minimum(row[:, 1:] + 1, row[:, :-1] + cost)
        g = torch.cat([torch.full((b, 1), i + 1, device=dev),
                       tmp - js[1:]], 1)
        new = torch.cummin(g, 1).values + js
        row = torch.where((i < ref_len)[:, None], new, row)
    out = row.gather(1, hyp_len.clamp(0, m)[:, None])[:, 0]
    return out.int()
