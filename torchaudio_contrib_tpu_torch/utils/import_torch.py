"""PyTorch ``state_dict`` importers under the JAX package's names.

Port of ``torchaudio_contrib_tpu/utils/import_torch.py``.  The JAX package
turns a PyTorch checkpoint (torchaudio's layout; HF's for the wav2vec2
family and HiFi-GAN; ``torchvggish``'s for VGGish) into its parameter
pytrees.  The port's models carry those names already, so here each
``import_X(state_dict, model)`` returns the ``state_dict`` that
``model.load_state_dict(strict=True)`` takes:

* where the layouts differ, through the converter :mod:`.convert` has:
  wav2vec2 (a task prefix stripped, the weight-normed positional conv
  folded, ``lm_head``), HiFi-GAN (weight norm folded, ``ups.``), and the
  checked pass-through of ConvTasNet, HDemucs, the Squim objective model
  and VGGish (keys the model has no use for, such as an HF checkpoint's
  pretraining heads, are ignored there, as the JAX importers ignore them);
* the Conformer: torchaudio's BatchNorm folded into the port's frozen
  affine (as the JAX package's ``_fold_bn`` does), the input projection
  the identity and the relative-position table zero (torchaudio's
  Conformer has neither);
* WaveRNN, Tacotron2, the Emformer RNN-T, Wav2Letter and DeepSpeech: the
  checkpoint as it is.

Each result is checked against ``model.state_dict()``, the counterpart of
the JAX package's ``_check_tree``: the converters build it from the
model's names and raise on a missing weight or a size that differs; the
others raise on a missing or unexpected key or a shape that differs.
Unlike the JAX importers, these keep torchaudio's BatchNorm statistics and
both LSTM biases as they are (the JAX package folds the first and sums the
second): the model computes the same function from them.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .convert import (_tensors, conv_tasnet_from_torch_state_dict,
                      hdemucs_from_torch_state_dict,
                      hifigan_from_torch_state_dict,
                      squim_objective_from_torch_state_dict,
                      vggish_from_torch_state_dict,
                      wav2vec2_from_torch_state_dict)

__all__ = [
    "load_torch_state_dict",
    "import_wav2vec2", "import_hifigan", "import_lstm",
    "import_conv_tasnet", "import_wavernn", "import_gru",
    "import_tacotron2", "import_conformer",
    "import_wav2letter", "import_deepspeech",
    "import_vggish", "import_emformer_rnnt",
    "import_squim_objective", "import_hdemucs",
]

_BN_EPS = 1e-5


def load_torch_state_dict(path) -> Dict[str, object]:
    """Load a ``.pt``/``.pth``/``.bin`` checkpoint on the host CPU and
    unwrap the common ``{"state_dict": …}`` / ``{"model": …}``
    nesting."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and key in obj \
                and isinstance(obj[key], dict):
            obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"{path} does not contain a state dict")
    return obj


def _checked(sd: dict, model, what: str) -> dict:
    """``sd`` against ``model.state_dict()``: no key missing, none
    unexpected, every shape the same; raises ``ValueError`` otherwise.
    Returned in the model's key order."""
    ref = model.state_dict()
    missing = sorted(set(ref) - set(sd))
    extra = sorted(set(sd) - set(ref))
    if missing or extra:
        raise ValueError(
            f"{what}: the state_dict does not match the model — missing "
            f"{missing[:6]}{'…' if len(missing) > 6 else ''}, unexpected "
            f"{extra[:6]}{'…' if len(extra) > 6 else ''}")
    bad = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in ref.items()
           if tuple(sd[k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"{what}: shape mismatches (key, checkpoint, "
                         f"model) {bad[:6]}")
    return {k: sd[k] for k in ref}


def _rooted(state_dict: Mapping[str, object], prefix: str) -> dict:
    """The entries under ``prefix``, with the prefix removed."""
    dot = "." if prefix and not prefix.endswith(".") else ""
    pre = prefix + dot
    return {k[len(pre):]: v for k, v in _tensors(state_dict).items()
            if k.startswith(pre)}


# ----------------------------------------------------------------- #
# through the converters                                            #
# ----------------------------------------------------------------- #

def import_wav2vec2(state_dict: Mapping[str, object], model) -> dict:
    """HF-layout wav2vec2/HuBERT/WavLM ``state_dict`` (or a task model's
    around one) → ``state_dict`` of the port's ``Wav2Vec2``/``WavLM``:
    :func:`~.convert.wav2vec2_from_torch_state_dict`."""
    return wav2vec2_from_torch_state_dict(state_dict, model)


def import_hifigan(state_dict: Mapping[str, object], model) -> dict:
    """HiFi-GAN generator ``state_dict`` (HF ``SpeechT5HifiGan`` or the
    original repo's names) → ``state_dict`` of the port's
    ``HiFiGANVocoder``: :func:`~.convert.hifigan_from_torch_state_dict`."""
    return hifigan_from_torch_state_dict(state_dict, model)


def import_conv_tasnet(state_dict: Mapping[str, object], model) -> dict:
    """torchaudio ``models.ConvTasNet`` ``state_dict`` → the port's
    ``ConvTasNet``'s: :func:`~.convert.conv_tasnet_from_torch_state_dict`."""
    return conv_tasnet_from_torch_state_dict(state_dict, model)


def import_hdemucs(state_dict: Mapping[str, object], model) -> dict:
    """torchaudio ``models.HDemucs`` ``state_dict`` → the port's
    ``HDemucsTA``'s (the house ``HDemucs`` raises):
    :func:`~.convert.hdemucs_from_torch_state_dict`."""
    return hdemucs_from_torch_state_dict(state_dict, model)


def import_squim_objective(state_dict: Mapping[str, object], model) -> dict:
    """torchaudio ``models.SquimObjective`` ``state_dict`` → the port's
    ``SquimObjectiveTA``'s (the house build raises):
    :func:`~.convert.squim_objective_from_torch_state_dict`."""
    return squim_objective_from_torch_state_dict(state_dict, model)


def import_vggish(state_dict: Mapping[str, object], model) -> dict:
    """``torchvggish`` ``state_dict`` (torchaudio's prototype VGGISH
    bundle's) → the port's ``VGGish``'s:
    :func:`~.convert.vggish_from_torch_state_dict`."""
    return vggish_from_torch_state_dict(state_dict, model)


# ----------------------------------------------------------------- #
# torchaudio's names as they are                                    #
# ----------------------------------------------------------------- #

def import_wavernn(state_dict: Mapping[str, object], model) -> dict:
    """torchaudio ``models.WaveRNN`` ``state_dict`` → the port's
    ``WaveRNN``'s (the same names: BatchNorms, GRUs and all)."""
    return _checked(_tensors(state_dict), model, "import_wavernn")


def import_tacotron2(state_dict: Mapping[str, object], model) -> dict:
    """torchaudio ``models.Tacotron2`` ``state_dict`` → the port's
    ``Tacotron2``'s (the same names)."""
    return _checked(_tensors(state_dict), model, "import_tacotron2")


def import_deepspeech(state_dict: Mapping[str, object], model) -> dict:
    """torchaudio ``models.DeepSpeech`` ``state_dict`` → the port's
    ``DeepSpeech``'s (the same names)."""
    return _checked(_tensors(state_dict), model, "import_deepspeech")


def import_wav2letter(state_dict: Mapping[str, object], model) -> dict:
    """torchaudio ``models.Wav2Letter`` ``state_dict`` → the port's
    ``Wav2Letter``'s (the same names).  The model must be built with
    ``compat="torchaudio"``: the other build pads its convolutions
    otherwise and would compute another function from the same
    weights."""
    if getattr(model, "compat", None) != "torchaudio":
        raise ValueError(
            "import_wav2letter needs a model built with compat='torchaudio' "
            "(torch conv geometry + output log-softmax); got compat="
            f"{getattr(model, 'compat', None)!r}")
    return _checked(_tensors(state_dict), model, "import_wav2letter")


def import_emformer_rnnt(state_dict: Mapping[str, object], model) -> dict:
    """torchaudio-layout ``models.RNNT`` (``emformer_rnnt_base`` family)
    ``state_dict`` → the port's torchaudio-layout build's
    (``emformer_rnnt_model(..., time_reduction_stride>1)``: an
    ``EmformerTranscriber`` and a ``LayerNormLSTMPredictor``, no
    ``enc_proj``), whose names are torchaudio's."""
    from ..models.emformer import EmformerTranscriber
    from ..models.rnnt import LayerNormLSTMPredictor
    trans = getattr(model, "transcriber", None)
    pred = getattr(model, "predictor", None)
    if not isinstance(trans, EmformerTranscriber) or \
            not isinstance(pred, LayerNormLSTMPredictor):
        raise ValueError(
            "import_emformer_rnnt needs the torchaudio-compatible build — "
            "emformer_rnnt_model(..., time_reduction_stride>1) or "
            "emformer_rnnt_base(compat='torchaudio'); got "
            f"transcriber={type(trans).__name__}, "
            f"predictor={type(pred).__name__}")
    return _checked(_tensors(state_dict), model, "import_emformer_rnnt")


def import_conformer(state_dict: Mapping[str, object], model,
                     prefix: str = "") -> dict:
    """torchaudio ``models.Conformer`` ``state_dict`` → the port's
    ``Conformer``'s.

    ``prefix`` roots the Conformer's entries in a larger checkpoint
    (``""``: whatever uniform prefix stands before
    ``conformer_layers.``).  Each layer's BatchNorm
    (``conv_module.sequential.3``) becomes the frozen affine ``g = w /
    √(running_var + eps)``, ``b = bias − running_mean·g`` (in float64, as
    the JAX package folds it); ``input_projection`` is the identity and
    each ``self_attn.rel_bias`` zero, since torchaudio's Conformer has
    neither.  The model must be built with ``conv_norm="affine"`` and
    ``input_dim == d_model``; a ``use_group_norm=True`` checkpoint (no
    running statistics) raises ``NotImplementedError``."""
    from ..models.conformer import _Affine
    layers = model.conformer_layers
    if not all(isinstance(l.conv_module.sequential[3], _Affine)
               for l in layers):
        raise ValueError("import_conformer needs a model built with "
                         "conv_norm='affine' (BatchNorm1d's inference "
                         "form)")
    if model.input_dim != model.d_model:
        raise ValueError(
            "torchaudio's Conformer has no input projection — build with "
            f"input_dim == d_model (got {model.input_dim} vs "
            f"{model.d_model})")
    if not prefix:
        marker = "conformer_layers."
        prefix = next((k[:k.find(marker)] for k in state_dict
                       if marker in k), "")
    sd = _rooted(state_dict, prefix)
    for i in range(len(layers)):
        bn = f"conformer_layers.{i}.conv_module.sequential.3"
        if f"{bn}.running_mean" not in sd:
            raise NotImplementedError(
                "use_group_norm=True Conformer checkpoints are not "
                "importable (GroupNorm is not a frozen affine); missing "
                f"'{bn}.running_mean'")
        w, b, mean, var = (sd.pop(f"{bn}.{n}").float().numpy()
                           .astype(np.float64)
                           for n in ("weight", "bias", "running_mean",
                                     "running_var"))
        sd.pop(f"{bn}.num_batches_tracked", None)
        g = w / np.sqrt(var + _BN_EPS)
        sd[f"{bn}.weight"] = torch.from_numpy(g.astype(np.float32))
        sd[f"{bn}.bias"] = torch.from_numpy((b - mean * g)
                                            .astype(np.float32))
        rel = f"conformer_layers.{i}.self_attn.rel_bias"
        sd[rel] = torch.zeros_like(layers[i].self_attn.rel_bias,
                                   device="cpu")
    sd["input_projection.weight"] = torch.eye(model.d_model)
    sd["input_projection.bias"] = torch.zeros(model.d_model)
    return _checked(sd, model, "import_conformer")


# ----------------------------------------------------------------- #
# recurrent layers                                                  #
# ----------------------------------------------------------------- #

def import_lstm(state_dict: Mapping[str, object], prefix: str,
                num_layers: int) -> dict:
    """The ``nn.LSTM`` weights of layers ``0..num_layers-1`` under
    ``prefix``, re-rooted (``weight_ih_l0``, …), both biases as they are:
    what a port model's ``nn.LSTM`` of that depth loads (the port's house
    LSTMs are ``nn.LSTM``: gates i, f, g, o)."""
    sd = _rooted(state_dict, prefix)
    names = [f"{w}_l{i}" for i in range(num_layers)
             for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    missing = [n for n in names if n not in sd]
    if missing:
        raise KeyError(f"import_lstm: no {missing[:4]} under {prefix!r}")
    return {n: sd[n] for n in names}


def import_gru(state_dict: Mapping[str, object], prefix: str) -> dict:
    """The one-layer ``nn.GRU`` under ``prefix``, re-rooted
    (``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0``;
    gates r, z, n, the biases kept apart: the ``n`` gate applies the reset
    gate to ``W_hn·h + b_hn``)."""
    sd = _rooted(state_dict, prefix)
    names = ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"]
    missing = [n for n in names if n not in sd]
    if missing:
        raise KeyError(f"import_gru: no {missing} under {prefix!r}")
    return {n: sd[n] for n in names}
