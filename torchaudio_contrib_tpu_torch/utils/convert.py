"""Parameter conversion from the JAX package.

:func:`from_jax_params` turns the parameter pytree of
``torchaudio_contrib_tpu.models.MelFrontendClassifier`` (with its leaves
converted to NumPy arrays) into a ``state_dict`` for this package's
:class:`~..models.frontend.MelFrontendClassifier`.  It does not import JAX.
The inverse path (ISTFT, Griffin-Lim, mel inversion, the vocoder ops) has no
parameters, so it needs no conversion.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_params"]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def from_jax_params(params_np: dict) -> dict:
    """``{"conv": [{"w", "b"}, ...], "head": {"w", "b"}[, "frontend"]}``
    → ``state_dict``.

    * conv ``w (3, 3, cin, cout)`` (HWIO) → ``convs.{i}.weight
      (cout, cin, 3, 3)`` (OIHW);
    * head ``w (cin, classes)`` → ``head.weight (classes, cin)``;
    * ``"frontend"`` is the JAX pipeline's per-stage tuple: ``(fb,)`` for
      the fused front end, ``(None, None, fb, None)`` for the chain; each
      non-None entry ``i`` becomes ``frontend.{i}.filterbank``.
    """
    sd = {}
    for i, layer in enumerate(params_np["conv"]):
        sd[f"convs.{i}.weight"] = _t(np.transpose(layer["w"], (3, 2, 0, 1)))
        sd[f"convs.{i}.bias"] = _t(layer["b"])
    sd["head.weight"] = _t(np.transpose(params_np["head"]["w"]))
    sd["head.bias"] = _t(params_np["head"]["b"])
    for i, leaf in enumerate(params_np.get("frontend") or ()):
        if leaf is not None:
            sd[f"frontend.{i}.filterbank"] = _t(leaf)
    return sd
