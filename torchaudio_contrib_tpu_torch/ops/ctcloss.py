"""CTC loss: the forward algorithm on the blank-interleaved lattice.

Port of ``torchaudio_contrib_tpu/ops/ctcloss.py``.  The ``S = 2L+1``
lattice in the log-semiring, batched over clips:

    alpha[t, s] = logsumexp(alpha[t-1, s], alpha[t-1, s-1],
                            alpha[t-1, s-2 if skippable]) + emit[t, s]

is one loop over time of a few tensor ops on ``(batch, S)`` (no state
depends on another of its own frame), with length masks that freeze a
clip's row past its ``input_lengths``.  Gradients come from autograd
through the loop: the true ``d loss / d log_probs`` (minus the occupancy),
as the JAX package's autodiff gives, whatever ``log_probs`` hold.
``torch.nn.functional.ctc_loss`` is not used: its backward returns
softmax minus occupancy, which is right only when chained through a
``log_softmax``, and it gives ``inf`` where the lattice here gives the JAX
package's ``~1e30`` for an infeasible clip.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ctc_loss"]

# the lattice's "impossible": finite, so that logaddexp of two of them has a
# finite gradient (with -inf it is NaN), as in the JAX package
_NEG = -1e30


def _lengths(lengths, batch: int, full: int, device) -> torch.Tensor:
    """Per-clip lengths as a long tensor on ``device``; ``None`` means
    ``full`` for every clip."""
    if lengths is None:
        return torch.full((batch,), full, dtype=torch.long, device=device)
    return torch.as_tensor(lengths, device=device).long()


def _labels(targets: torch.Tensor, blank: int, n_classes: int):
    """``(lab, gather_idx, can_skip)`` of the ``(batch, 2L+1)`` lattice:
    blank at even states, the targets at odd ones; the index into the
    classes (negative ids wrap, others clamp, as a JAX gather does; such
    states are dead); whether a state may be entered from two back."""
    b, l_max = targets.shape
    lab = torch.full((b, 2 * l_max + 1), blank, dtype=torch.long,
                     device=targets.device)
    lab[:, 1::2] = targets
    prev2 = torch.full_like(lab, blank)
    prev2[:, 2:] = lab[:, :-2]
    odd = torch.arange(lab.shape[1], device=lab.device) % 2 == 1
    can_skip = odd & (lab != prev2)
    idx = torch.where(lab < 0, lab + n_classes, lab).clamp(0, n_classes - 1)
    return lab, idx, can_skip


def _ctc_nll(log_probs, targets, in_len, tgt_len, blank: int):
    """Negative log-likelihood per clip, ``(batch,)``."""
    b, t_max, n_classes = log_probs.shape
    lab, idx, can_skip = _labels(targets, blank, n_classes)
    s_max = lab.shape[1]
    states = torch.arange(s_max, device=log_probs.device)
    alive = states < (2 * tgt_len + 1)[:, None]                  # (B, S)
    emit = log_probs.gather(2, idx[:, None, :].expand(b, t_max, s_max))
    emit = emit.transpose(0, 1)                                  # (T, B, S)
    neg = torch.tensor(_NEG, dtype=emit.dtype, device=emit.device)

    init = torch.where(states == 0, emit[0], neg)
    if s_max > 1:
        init = torch.where((states == 1) & (tgt_len > 0)[:, None],
                           emit[0], init)
    alpha = torch.where(alive, init, neg)
    # a dead state's alpha stays _NEG, so one mask per frame does both of
    # the JAX step's: dead states and frames past the clip's length
    frames = torch.arange(1, t_max, device=log_probs.device)
    update = alive & (frames[:, None, None] < in_len[None, :, None])
    for t in range(1, t_max):
        pad = F.pad(alpha, (2, 0), value=_NEG)
        skip = torch.where(can_skip, pad[:, :-2], neg)
        new = torch.logaddexp(torch.logaddexp(alpha, pad[:, 1:-1]), skip) \
            + emit[t]
        alpha = torch.where(update[t - 1], new, alpha)
    end_blank = alpha.gather(1, (2 * tgt_len)[:, None])[:, 0]
    end_tok = alpha.gather(1, (2 * tgt_len - 1).clamp(min=0)[:, None])[:, 0]
    end_tok = torch.where(tgt_len > 0, end_tok, neg)
    return -torch.logaddexp(end_blank, end_tok)


def ctc_loss(log_probs, targets, input_lengths=None,
             target_lengths=None, blank: int = 0,
             reduction: str = "mean", zero_infinity: bool = False):
    """Connectionist temporal classification loss (batched, differentiable).

    ``log_probs`` ``(batch, time, classes)`` log-softmax emissions
    (batch-first, the library convention — torch's is time-first);
    ``targets`` ``(batch, max_target_len)`` token ids without ``blank``.
    ``reduction`` matches torch: ``"mean"`` divides each sequence loss by
    its target length before averaging; ``zero_infinity`` zeroes
    infeasible-path losses (e.g. targets longer than inputs allow), which
    are otherwise ``~1e30``.  Runs on the device of ``log_probs``.
    """
    log_probs = torch.as_tensor(log_probs)
    dev = log_probs.device
    targets = torch.as_tensor(targets, device=dev).long()
    if log_probs.ndim != 3 or targets.ndim != 2:
        raise ValueError("log_probs must be (batch, time, classes), "
                         "targets (batch, max_target_len)")
    if reduction not in ("none", "mean", "sum"):
        raise ValueError(f"unknown reduction {reduction!r}")
    b, t_max, n_classes = log_probs.shape
    blank_idx = blank % n_classes
    in_len = _lengths(input_lengths, b, t_max, dev)
    tgt_len = _lengths(target_lengths, b, targets.shape[1], dev)

    losses = _ctc_nll(log_probs, targets, in_len, tgt_len, blank_idx)
    if zero_infinity:
        losses = torch.where(losses >= -0.5 * _NEG,
                             torch.zeros_like(losses), losses)
    if reduction == "mean":
        return (losses / tgt_len.clamp(min=1).to(losses.dtype)).mean()
    if reduction == "sum":
        return losses.sum()
    return losses
