"""Plain mel front end + three-block CNN classifier: forward, mean
cross-entropy, gradients and plain SGD steps.

The model: the log-mel of :mod:`.logmel` with a trainable filterbank,
averaged over channels, three 3x3 stride-2 convolutions with XLA's
``padding="SAME"`` (the odd pixel of the padding on the high side) and
ReLU, a global mean and a linear head.  Parameters are a dict under the
measured model's ``state_dict`` names; gradients come from
``torch.autograd.grad`` of these plain ops, and a step is
``p <- p - lr * grad``.  It imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .logmel import logmel


def same_pad(size: int, kernel: int = 3, stride: int = 2) -> tuple:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def param_names(n_convs: int) -> list:
    names = ["frontend.0.filterbank"]
    for i in range(n_convs):
        names += [f"convs.{i}.weight", f"convs.{i}.bias"]
    return names + ["head.weight", "head.bias"]


def forward(p: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``x (B, C, T)`` -> logits ``(B, classes)``."""
    a = cfg["args"]
    h = logmel(x, p["frontend.0.filterbank"], a["fft_length"],
               a["hop_length"]).mean(dim=1, keepdim=True)
    for i in range(len(a["channels"])):
        ph, pw = same_pad(h.shape[-2]), same_pad(h.shape[-1])
        h = F.pad(h, (pw[0], pw[1], ph[0], ph[1]))
        h = F.relu(F.conv2d(h, p[f"convs.{i}.weight"], p[f"convs.{i}.bias"],
                            stride=2))
    return h.mean(dim=(-2, -1)) @ p["head.weight"].t() + p["head.bias"]


def loss(p: dict, x: torch.Tensor, labels: torch.Tensor, cfg: dict):
    return F.cross_entropy(forward(p, x, cfg), labels.long())


def grads(p: dict, x, labels, cfg: dict) -> tuple:
    """``(loss, {name: gradient})`` at ``p``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    value = loss(leaves, x, labels, cfg)
    g = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, g))


def sgd_steps(p0: dict, batches, lr: float, cfg: dict) -> tuple:
    """Plain SGD from ``p0`` over ``batches`` of ``(x, labels)``.
    Returns ``(losses, first gradient, parameters after the last step)``,
    each loss before its step."""
    p, losses, first = dict(p0), [], None
    for x, labels in batches:
        value, g = grads(p, x, labels, cfg)
        losses.append(value)
        first = g if first is None else first
        with torch.no_grad():
            p = {k: v - lr * g[k] for k, v in p.items()}
    return losses, first, p
