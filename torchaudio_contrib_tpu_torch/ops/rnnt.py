"""RNN-T (transducer) loss on the lattice's anti-diagonals.

Port of ``torchaudio_contrib_tpu/ops/rnnt.py`` (Graves 2012's forward
variable):

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + emit[t, u-1])

Both terms of a cell lie on the anti-diagonal ``t + u = d - 1``, so the
lattice is solved one anti-diagonal at a time: ``T + U`` steps of a few
tensor ops on ``(batch, U+1)``, from blank and emit planes skewed once so
that diagonal ``d`` is a contiguous row (the JAX package scans the rows
over T and solves each row's within-row dependency with an
``associative_scan``; PyTorch has no scan).  Gradients come from autograd
through the loop; ``clamp`` clips the logits' gradient with an identity
whose backward clamps (:class:`_ClampGrad`), as torchaudio's does.

:func:`rnnt_loss_fused` computes the two planes straight from the
encoder / predictor encodings, a chunk of frames at a time under
``torch.utils.checkpoint``: the ``(B, T, U+1, V)`` joint is never stored.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .ctcloss import _lengths

__all__ = ["rnnt_loss", "rnnt_loss_fused"]

# the lattice's "impossible": finite, as in the JAX package (logaddexp of
# two -inf has a NaN gradient)
_NEG = -1e30


class _ClampGrad(torch.autograd.Function):
    """Identity forward; the incoming gradient clamped to ``[-c, c]``."""

    @staticmethod
    def forward(ctx, x, clamp: float):
        ctx.clamp = clamp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-ctx.clamp, ctx.clamp), None


def _rnnt_from_lps(blank_lp, emit_lp, in_len, tgt_len):
    """Negative log-likelihood per clip from the two planes the recursion
    needs: ``blank_lp (B, T, U+1)`` and ``emit_lp (B, T, U)`` (the target
    token's log-prob at each ``(t, u)``)."""
    b, t_max, u1 = blank_lp.shape
    u_max = u1 - 1
    dev = blank_lp.device
    u = torch.arange(u1, device=dev)
    neg = torch.tensor(_NEG, dtype=blank_lp.dtype, device=dev)
    # emit[t, u-1] at column u: the emission that enters (t, u) from the
    # left; column 0 has none
    emit = torch.where(u[None, None, :u_max] < tgt_len[:, None, None],
                       emit_lp, neg)
    emit = F.pad(emit, (1, 0), value=_NEG)                # (B, T, U+1)
    n_diag = t_max + u_max
    d = torch.arange(n_diag, device=dev)[:, None]
    t = d - u[None, :]                                    # (D, U+1)
    on_grid = (t >= 0) & (t < t_max)
    tc = t.clamp(0, t_max - 1)
    blank_d = blank_lp[:, tc, u.expand_as(tc)].transpose(0, 1)  # (D,B,U+1)
    emit_d = emit[:, tc, u.expand_as(tc)].transpose(0, 1)

    # alpha on diagonal d from diagonal d-1: from above (t-1, u) with
    # diagonal d-1's blank at u, from the left (t, u-1) with this
    # diagonal's emission at u
    alpha = torch.where(u == 0, torch.zeros((), dtype=neg.dtype,
                                            device=dev), neg).expand(b, u1)
    alphas = [alpha]
    for k in range(1, n_diag):
        up = alpha + blank_d[k - 1]
        left = F.pad(alpha[:, :-1], (1, 0), value=_NEG) + emit_d[k]
        alpha = torch.where(on_grid[k], torch.logaddexp(up, left), neg)
        alphas.append(alpha)
    alphas = torch.stack(alphas)                          # (D, B, U+1)

    t_end = (in_len - 1).clamp(0, t_max - 1)
    u_end = tgt_len.clamp(0, u_max)
    rows = torch.arange(b, device=dev)
    return -(alphas[t_end + u_end, rows, u_end]
             + blank_lp[rows, t_end, u_end])


def _reduce(losses: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return losses.mean()
    if reduction == "sum":
        return losses.sum()
    return losses


def _upcast(x: torch.Tensor) -> torch.Tensor:
    """Floats narrower than float32 as float32: the lattice accumulates
    over T + U steps, which bf16's 8-bit mantissa cannot."""
    if x.is_floating_point() and torch.finfo(x.dtype).bits < 32:
        return x.float()
    return x


def _planes(lp: torch.Tensor, targets: torch.Tensor, blank: int):
    """``(blank (B, T', U+1), emit (B, T', U))`` of log-probs ``lp (B, T',
    U+1, V)``.  Target ids out of range (padding past a clip's length,
    whose cells the recursion masks) wrap or clamp, as a JAX gather."""
    u_max, n_classes = lp.shape[2] - 1, lp.shape[3]
    idx = torch.where(targets < 0, targets + n_classes, targets)
    idx = idx.clamp(0, n_classes - 1)
    emit = lp[:, :, :u_max].gather(
        3, idx[:, None, :, None].expand(-1, lp.shape[1], -1, 1))[..., 0]
    return lp[..., blank], emit


def rnnt_loss(logits, targets, logit_lengths=None, target_lengths=None,
              blank: int = -1, clamp: float = -1.0,
              reduction: str = "mean", fused_log_softmax: bool = True):
    """Transducer loss (batched, differentiable), on the device of
    ``logits``.

    ``logits`` is ``(batch, time, max_target_len + 1, n_classes)`` joint
    network output; ``targets`` ``(batch, max_target_len)`` token ids
    (must not contain ``blank``); lengths default to the padded sizes.
    ``blank`` may be negative (torchaudio's default ``-1`` = last
    class).  ``reduction`` in {"none", "mean", "sum"} over the batch.
    Set ``fused_log_softmax=False`` if ``logits`` are already
    log-probabilities.  Inputs narrower than float32 are upcast for the
    lattice.  Returns the loss (``(batch,)`` for "none").
    """
    logits = torch.as_tensor(logits)
    dev = logits.device
    targets = torch.as_tensor(targets, device=dev).long()
    if logits.ndim != 4 or targets.ndim != 2:
        raise ValueError("logits must be (batch, time, max_target_len+1, "
                         "classes), targets (batch, max_target_len)")
    b, t_max, u1, n_classes = logits.shape
    if targets.shape != (b, u1 - 1):
        raise ValueError(
            f"targets must be (batch, {u1 - 1}) to match logits' "
            f"target axis of {u1}; got {tuple(targets.shape)}")
    if reduction not in ("none", "mean", "sum"):
        raise ValueError(f"unknown reduction {reduction!r}")
    blank_idx = blank % n_classes
    in_len = _lengths(logit_lengths, b, t_max, dev)
    tgt_len = _lengths(target_lengths, b, u1 - 1, dev)

    if clamp is not None and clamp > 0:
        logits = _ClampGrad.apply(logits, float(clamp))
    logits = _upcast(logits)
    lp = torch.log_softmax(logits, -1) if fused_log_softmax else logits
    blank_lp, emit_lp = _planes(lp, targets, blank_idx)
    return _reduce(_rnnt_from_lps(blank_lp, emit_lp, in_len, tgt_len),
                   reduction)


def rnnt_loss_fused(enc, pred, joiner, targets, *,
                    act=torch.relu,
                    logit_lengths=None, target_lengths=None,
                    blank: int = -1, clamp: float = -1.0,
                    reduction: str = "mean", time_chunk=None):
    """Transducer loss straight from the encoder/predictor encodings —
    the ``(B, T, U+1, V)`` joint grid is never stored.

    The recursion needs only two planes — the blank log-prob and the
    target token's log-prob at each ``(t, u)`` — so the joint
    (``act(enc + pred) @ w + b`` → log-softmax) is computed
    ``time_chunk`` frames at a time under ``torch.utils.checkpoint``: the
    forward keeps ``(B, T, 2U+1)`` floats, and the backward recomputes
    each chunk's joint.  Equal to ``rnnt_loss(join(...))``, values and
    gradients.

    ``enc (B, T, J)``, ``pred (B, U+1, J)``, ``joiner`` =
    ``{"w": (J, V), "b": (V,)}``; other args as :func:`rnnt_loss`.
    ``time_chunk`` bounds the transient joint block
    (``B·time_chunk·(U+1)·V`` floats); ``None`` picks ``max(4, 512 //
    B)``, the JAX package's default.  A last chunk shorter than the
    others is computed as it is (the JAX package pads it).
    """
    enc = torch.as_tensor(enc)
    dev = enc.device
    pred = torch.as_tensor(pred)
    targets = torch.as_tensor(targets, device=dev).long()
    if enc.ndim != 3 or pred.ndim != 3 or targets.ndim != 2:
        raise ValueError("enc must be (batch, time, J), pred (batch, "
                         "max_target_len+1, J), targets (batch, "
                         "max_target_len)")
    B, T, J = enc.shape
    u1 = pred.shape[1]
    if targets.shape != (B, u1 - 1):
        raise ValueError(
            f"targets must be (batch, {u1 - 1}) to match pred's "
            f"target axis of {u1}; got {tuple(targets.shape)}")
    if reduction not in ("none", "mean", "sum"):
        raise ValueError(f"unknown reduction {reduction!r}")
    w, bias = joiner["w"], joiner["b"]
    blank_idx = blank % w.shape[-1]
    in_len = _lengths(logit_lengths, B, T, dev)
    tgt_len = _lengths(target_lengths, B, u1 - 1, dev)
    if time_chunk is None:
        time_chunk = max(4, 512 // B)
    c = max(1, min(int(time_chunk), T))

    def chunk_planes(enc_c, pred, w, bias):
        logits = act(enc_c[:, :, None, :] + pred[:, None]) @ w + bias
        if clamp is not None and clamp > 0:
            logits = _ClampGrad.apply(logits, float(clamp))
        # the products follow the input dtype, the lattice at least float32
        lp = torch.log_softmax(_upcast(logits), -1)
        return _planes(lp, targets, blank_idx)

    planes = [checkpoint(chunk_planes, enc_c, pred, w, bias,
                         use_reentrant=False)
              for enc_c in enc.split(c, 1)]
    blank_lp = torch.cat([p[0] for p in planes], 1)
    emit_lp = torch.cat([p[1] for p in planes], 1)
    return _reduce(_rnnt_from_lps(blank_lp, emit_lp, in_len, tgt_len),
                   reduction)
