"""Parameter conversion from the JAX package.

Each function turns the parameter pytree of a JAX model (with its leaves
converted to NumPy arrays) into a ``state_dict`` for this package's model
of the same name: :func:`from_jax_params` for ``MelFrontendClassifier``,
:func:`wav2letter_from_jax_params` for ``Wav2Letter`` and
:func:`deepspeech_from_jax_params` for ``DeepSpeech``.  None imports JAX.
The other way, the JAX package's ``utils.import_torch`` importers
(``import_wav2letter``, ``import_deepspeech``) load the port's
``state_dict`` s, whose names are torchaudio's.  The inverse path (ISTFT,
Griffin-Lim, mel inversion, the vocoder ops) has no parameters, so it needs
no conversion.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_params", "wav2letter_from_jax_params",
           "deepspeech_from_jax_params"]


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


def wav2letter_from_jax_params(params_np: dict) -> dict:
    """``{"layers": [{"w", "b"}, ...]}`` of the JAX ``Wav2Letter`` (either
    ``compat``) → ``state_dict`` of the port's, whose names are
    torchaudio's: conv ``w (k, cin, cout)`` (TIO) → ``weight (cout, cin,
    k)``.  The waveform model has 12 layers (its first is the 250-tap,
    stride-160 head, ``acoustic_model.0.0``; the rest are
    ``acoustic_model.1.{2i}``), the feature models 11
    (``acoustic_model.{2i}``)."""
    layers = params_np["layers"]
    if len(layers) == 12:
        names = ["acoustic_model.0.0"] + [f"acoustic_model.1.{2 * i}"
                                          for i in range(11)]
    elif len(layers) == 11:
        names = [f"acoustic_model.{2 * i}" for i in range(11)]
    else:
        raise ValueError(f"a Wav2Letter has 11 or 12 conv layers, got "
                         f"{len(layers)}")
    sd = {}
    for name, layer in zip(names, layers):
        sd[f"{name}.weight"] = _t(np.transpose(layer["w"], (2, 1, 0)))
        sd[f"{name}.bias"] = _t(layer["b"])
    return sd


def deepspeech_from_jax_params(params_np: dict) -> dict:
    """Params of the JAX ``DeepSpeech`` → ``state_dict`` of the port's
    (torchaudio's names): dense ``w (cin, cout)`` → ``weight (cout,
    cin)``; each RNN direction's ``wx``/``wh`` → ``weight_ih_l0`` /
    ``weight_hh_l0`` (``_reverse`` for ``bwd``), its one ``b`` →
    ``bias_ih_l0``, with ``bias_hh_l0`` zero (torch adds the two)."""
    sd = {}
    for name, key in (("fc1.fc", "fc1"), ("fc2.fc", "fc2"),
                      ("fc3.fc", "fc3"), ("fc4.fc", "fc4"), ("out", "out")):
        sd[f"{name}.weight"] = _t(np.transpose(params_np[key]["w"]))
        sd[f"{name}.bias"] = _t(params_np[key]["b"])
    for sfx, key in (("", "fwd"), ("_reverse", "bwd")):
        d = params_np["rnn"][key]
        sd[f"bi_rnn.weight_ih_l0{sfx}"] = _t(np.transpose(d["wx"]))
        sd[f"bi_rnn.weight_hh_l0{sfx}"] = _t(np.transpose(d["wh"]))
        sd[f"bi_rnn.bias_ih_l0{sfx}"] = _t(d["b"])
        sd[f"bi_rnn.bias_hh_l0{sfx}"] = torch.zeros(np.shape(d["b"]))
    return sd
