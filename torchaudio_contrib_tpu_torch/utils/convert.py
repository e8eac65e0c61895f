"""Parameter conversion from the JAX package.

Each function turns the parameter pytree of a JAX model (with its leaves
converted to NumPy arrays) into a ``state_dict`` for this package's model
of the same name: :func:`from_jax_params` for ``MelFrontendClassifier``,
:func:`wav2letter_from_jax_params` for ``Wav2Letter``,
:func:`deepspeech_from_jax_params` for ``DeepSpeech``,
:func:`emformer_from_jax_params` and :func:`conformer_from_jax_params` for
the encoders, :func:`emformer_rnnt_from_jax_params` (the house and the
torchaudio-layout build) and :func:`conformer_rnnt_from_jax_params` for
the transducers; :func:`wav2vec2_from_jax_params` (``Wav2Vec2`` and
``WavLM``), :func:`hubert_pretrain_from_jax_params`,
:func:`conformer_wav2vec2_from_jax_params` and
:func:`emformer_hubert_from_jax_params` for the wav2vec2 family;
:func:`tacotron2_from_jax_params`, :func:`wavernn_from_jax_params` and
:func:`hifigan_from_jax_params` for the TTS family;
:func:`conv_tasnet_from_jax_params`, :func:`hdemucs_from_jax_params`,
:func:`hdemucs_ta_from_jax_params`, :func:`squim_objective_from_jax_params`,
:func:`squim_objective_ta_from_jax_params`,
:func:`squim_subjective_from_jax_params` and :func:`vggish_from_jax_params`
for the separation, assessment and embedding models.  None imports JAX.  The other way, the JAX package's ``utils.import_torch``
importers (``import_wav2letter``, ``import_deepspeech``,
``import_emformer_rnnt``, ``import_wav2vec2``, ``import_tacotron2``,
``import_wavernn``, ``import_hifigan``, ``import_conv_tasnet``,
``import_hdemucs``, ``import_squim_objective``, ``import_vggish``) load the
port's
``state_dict`` s, whose names are torchaudio's (HF's for the wav2vec2
family).  :func:`wav2vec2_from_torch_state_dict` reads an HF-layout
checkpoint (a task prefix, ``lm_head``, a weight-normed positional conv,
pretraining leftovers) into the port's names, and
:func:`hifigan_from_torch_state_dict` a HiFi-GAN generator's;
:func:`conv_tasnet_from_torch_state_dict`,
:func:`hdemucs_from_torch_state_dict`,
:func:`squim_objective_from_torch_state_dict` and
:func:`vggish_from_torch_state_dict` check a torchaudio (``torchvggish``)
checkpoint against the model, whose names it already has, and pass it
through.  The inverse path (ISTFT,
Griffin-Lim, mel inversion, the vocoder ops) has no parameters, so it needs
no conversion.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["from_jax_params", "wav2letter_from_jax_params",
           "deepspeech_from_jax_params", "emformer_from_jax_params",
           "conformer_from_jax_params", "emformer_rnnt_from_jax_params",
           "conformer_rnnt_from_jax_params", "wav2vec2_from_jax_params",
           "hubert_pretrain_from_jax_params",
           "conformer_wav2vec2_from_jax_params",
           "emformer_hubert_from_jax_params",
           "wav2vec2_from_torch_state_dict", "tacotron2_from_jax_params",
           "wavernn_from_jax_params", "hifigan_from_jax_params",
           "hifigan_from_torch_state_dict", "conv_tasnet_from_jax_params",
           "hdemucs_from_jax_params", "hdemucs_ta_from_jax_params",
           "squim_objective_from_jax_params",
           "squim_objective_ta_from_jax_params",
           "squim_subjective_from_jax_params", "vggish_from_jax_params",
           "conv_tasnet_from_torch_state_dict",
           "hdemucs_from_torch_state_dict",
           "squim_objective_from_torch_state_dict",
           "vggish_from_torch_state_dict"]


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


def _linear(sd: dict, name: str, p: dict, w: str = "w", b: str = "b"):
    """Dense ``p[w] (cin, cout)`` (and ``p[b]``) → ``name.weight (cout,
    cin)`` (and ``name.bias``)."""
    sd[f"{name}.weight"] = _t(np.transpose(p[w]))
    if b in p:
        sd[f"{name}.bias"] = _t(p[b])


def _norm(sd: dict, name: str, p: dict):
    sd[f"{name}.weight"] = _t(p["g"])
    sd[f"{name}.bias"] = _t(p["b"])


def _emformer_sd(sd: dict, pre: str, p: dict):
    for i, lp in enumerate(p["layers"]):
        n = f"{pre}emformer_layers.{i}."
        _norm(sd, n + "layer_norm_input", lp["ln1"])
        _linear(sd, n + "attention.emb_to_query", lp, "wq", "bq")
        sd[n + "attention.emb_to_key_value.weight"] = _t(
            np.concatenate([np.transpose(lp["wk"]), np.transpose(lp["wv"])]))
        sd[n + "attention.emb_to_key_value.bias"] = _t(
            np.concatenate([lp["bk"], lp["bv"]]))
        _linear(sd, n + "attention.out_proj", lp, "wo", "bo")
        _norm(sd, n + "pos_ff.0", lp["ln2"])
        _linear(sd, n + "pos_ff.1", lp, "w1", "b1")
        _linear(sd, n + "pos_ff.4", lp, "w2", "b2")
        if "ln3" in lp:
            _norm(sd, n + "layer_norm_output", lp["ln3"])
        if "conv" in lp:
            c = lp["conv"]
            _norm(sd, n + "conv_module.layer_norm", c["ln"])
            _linear(sd, n + "conv_module.pointwise_conv1", c, "pw1", "pb1")
            sd[n + "conv_module.depthwise_conv.weight"] = _t(
                np.transpose(c["dw"], (2, 1, 0)))
            _linear(sd, n + "conv_module.pointwise_conv2", c, "pw2", "pb2")
    if "ln_out" in p:
        _norm(sd, pre + "output_layer_norm", p["ln_out"])


def _conformer_sd(sd: dict, pre: str, p: dict):
    _linear(sd, pre + "input_projection", p, "proj", "proj_b")
    for i, lp in enumerate(p["layers"]):
        n = f"{pre}conformer_layers.{i}."
        for ffn in ("ffn1", "ffn2"):
            _norm(sd, f"{n}{ffn}.sequential.0", lp[ffn]["ln"])
            _linear(sd, f"{n}{ffn}.sequential.1", lp[ffn], "w1", "b1")
            _linear(sd, f"{n}{ffn}.sequential.4", lp[ffn], "w2", "b2")
        a = lp["attn"]
        _norm(sd, n + "self_attn_layer_norm", a["ln"])
        sd[n + "self_attn.in_proj_weight"] = _t(np.transpose(a["wqkv"]))
        sd[n + "self_attn.in_proj_bias"] = _t(a["bqkv"])
        _linear(sd, n + "self_attn.out_proj", a, "wo", "bo")
        sd[n + "self_attn.rel_bias"] = _t(a["rel"])
        c = lp["conv"]
        m = n + "conv_module."
        _norm(sd, m + "layer_norm", c["ln"])
        sd[m + "sequential.0.weight"] = _t(np.transpose(c["pw1"])[..., None])
        sd[m + "sequential.0.bias"] = _t(c["pb1"])
        sd[m + "sequential.2.weight"] = _t(np.transpose(c["dw"], (2, 1, 0)))
        sd[m + "sequential.2.bias"] = _t(c["db"])
        _norm(sd, m + "sequential.3", c["norm"])
        sd[m + "sequential.5.weight"] = _t(np.transpose(c["pw2"])[..., None])
        sd[m + "sequential.5.bias"] = _t(c["pb2"])
        _norm(sd, n + "final_layer_norm", lp["out_ln"])


def emformer_from_jax_params(params_np: dict) -> dict:
    """Params of the JAX ``Emformer`` or ``ConvEmformer`` (either build)
    → ``state_dict`` of the port's: ``wq`` → ``attention.emb_to_query``,
    ``wk``/``wv`` stacked as ``attention.emb_to_key_value`` (keys first),
    ``wo`` → ``attention.out_proj``, ``ln1``/``ln2``/``ln3`` →
    ``layer_norm_input``/``pos_ff.0``/``layer_norm_output``,
    ``w1``/``w2`` → ``pos_ff.1``/``pos_ff.4``, ``ln_out`` →
    ``output_layer_norm``; a ConvEmformer's ``conv`` → ``conv_module``
    (depthwise ``(K, 1, D)`` → ``(D, 1, K)``)."""
    sd = {}
    _emformer_sd(sd, "", params_np)
    return sd


def conformer_from_jax_params(params_np: dict) -> dict:
    """Params of the JAX ``Conformer`` → ``state_dict`` of the port's
    (torchaudio's names): ``proj`` → ``input_projection``; a layer's FFNs
    → ``ffn{1,2}.sequential.{0,1,4}``, ``attn`` → ``self_attn_layer_norm``
    and ``self_attn`` (``wqkv`` → ``in_proj_weight``, ``rel`` →
    ``rel_bias``), ``conv`` → ``conv_module.layer_norm`` and
    ``conv_module.sequential.{0,2,3,5}`` (pointwise kernels as ``(cout,
    cin, 1)``, depthwise ``(K, 1, D)`` → ``(D, 1, K)``), ``out_ln`` →
    ``final_layer_norm``."""
    sd = {}
    _conformer_sd(sd, "", params_np)
    return sd


def _predictor_sd(sd: dict, p: dict):
    sd["predictor.embedding.weight"] = _t(p["emb"])
    if "in_ln" in p:                             # LayerNormLSTMPredictor
        _norm(sd, "predictor.input_layer_norm", p["in_ln"])
        for i, lp in enumerate(p["layers"]):
            n = f"predictor.lstm_layers.{i}."
            _linear(sd, n + "x2g", lp, "wx", "bx")
            _linear(sd, n + "p2g", lp, "wh")
            if "g_ln" in lp:
                _norm(sd, n + "g_norm", lp["g_ln"])
                _norm(sd, n + "c_norm", lp["c_ln"])
        _linear(sd, "predictor.linear", p["out"])
        _norm(sd, "predictor.output_layer_norm", p["out_ln"])
        return
    for i, lp in enumerate(p["layers"]):         # RNNTPredictor
        sd[f"predictor.lstm.weight_ih_l{i}"] = _t(np.transpose(lp["wi"]))
        sd[f"predictor.lstm.weight_hh_l{i}"] = _t(np.transpose(lp["wh"]))
        sd[f"predictor.lstm.bias_ih_l{i}"] = _t(lp["b"])
        sd[f"predictor.lstm.bias_hh_l{i}"] = torch.zeros(np.shape(lp["b"]))
    _norm(sd, "predictor.layer_norm", p["ln"])
    _linear(sd, "predictor.linear", p["out"])


def _rnnt_sd(params_np: dict, transcriber_sd: dict, enc_proj: bool) -> dict:
    sd = {f"transcriber.{k}": v for k, v in transcriber_sd.items()}
    _predictor_sd(sd, params_np["predictor"])
    if enc_proj:
        _linear(sd, "enc_proj", params_np["enc_proj"])
    _linear(sd, "joiner.linear", params_np["joiner"])
    return sd


def emformer_rnnt_from_jax_params(params_np: dict) -> dict:
    """Params of the JAX ``emformer_rnnt_model`` → ``state_dict`` of the
    port's, in either build (told apart by the transcriber's params).

    The torchaudio-layout build (``time_reduction_stride > 1``) has no
    ``enc_proj``: its encodings go to the joiner as they are, as in
    torchaudio and as ``import_emformer_rnnt`` sets the JAX model's
    ``enc_proj`` (identity).  Such params with any other ``enc_proj``
    raise ``ValueError``."""
    p = params_np["transcriber"]
    if "in_lin" not in p:                        # the house build
        return _rnnt_sd(params_np, emformer_from_jax_params(p), True)
    w, b = (np.asarray(params_np["enc_proj"][k]) for k in ("w", "b"))
    if not (np.array_equal(w, np.eye(*w.shape)) and not b.any()):
        raise ValueError(
            "the torchaudio-layout Emformer-RNNT has no enc_proj: its JAX "
            "params must carry the identity (as import_emformer_rnnt "
            "gives), not a trained or random projection")
    return _rnnt_sd(params_np, _emformer_transcriber_sd(p), False)


def _emformer_transcriber_sd(p: dict) -> dict:
    """The JAX ``EmformerTranscriber``'s params → the port's
    ``state_dict``."""
    sd = {"input_linear.weight": _t(np.transpose(p["in_lin"]["w"]))}
    _emformer_sd(sd, "transformer.", p["emformer"])
    _linear(sd, "output_linear", p["out_lin"])
    _norm(sd, "layer_norm", p["out_ln"])
    return sd


def conformer_rnnt_from_jax_params(params_np: dict) -> dict:
    """Params of the JAX ``conformer_rnnt_model`` → ``state_dict`` of the
    port's: the transcriber's ``conformer`` as
    :func:`conformer_from_jax_params` under ``transcriber.conformer.``,
    ``out_lin``/``out_ln`` → ``output_linear``/``layer_norm``, the
    layer-norm LSTM predictor under torchaudio's names, ``enc_proj`` and
    ``joiner.linear``."""
    return _rnnt_sd(params_np,
                    _conformer_transcriber_sd(params_np["transcriber"]),
                    True)


def _conformer_transcriber_sd(p: dict) -> dict:
    """The JAX ``ConformerTranscriber``'s params → the port's
    ``state_dict``."""
    sd = {}
    _conformer_sd(sd, "conformer.", p["conformer"])
    _linear(sd, "output_linear", p["out_lin"])
    _norm(sd, "layer_norm", p["out_ln"])
    return sd


# -- the wav2vec2 family ---------------------------------------------------

def _conv1d(p) -> torch.Tensor:
    """A JAX conv kernel ``(k, cin, cout)`` (TIO) → ``(cout, cin, k)``."""
    return _t(np.transpose(p, (2, 1, 0)))


def _w2v2_sd(sd: dict, pre: str, p: dict):
    for i, lp in enumerate(p["extractor"]):
        n = f"{pre}feature_extractor.conv_layers.{i}."
        sd[n + "conv.weight"] = _conv1d(lp["w"])
        if "b" in lp:
            sd[n + "conv.bias"] = _t(lp["b"])
        for key in ("n", "gn"):
            if key in lp:
                _norm(sd, n + "layer_norm", lp[key])
    _norm(sd, pre + "feature_projection.layer_norm", p["proj_ln"])
    _linear(sd, pre + "feature_projection.projection", p["proj"])
    sd[pre + "encoder.pos_conv_embed.conv.weight"] = _conv1d(p["pos_conv"])
    sd[pre + "encoder.pos_conv_embed.conv.bias"] = _t(p["pos_b"])
    _norm(sd, pre + "encoder.layer_norm", p["enc_ln"])
    for i, lp in enumerate(p["layers"]):
        n = f"{pre}encoder.layers.{i}."
        w = np.asarray(lp["wqkv"])
        b = np.asarray(lp["bqkv"])
        d = w.shape[0]
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            sd[f"{n}attention.{name}.weight"] = _t(
                np.transpose(w[:, j * d:(j + 1) * d]))
            sd[f"{n}attention.{name}.bias"] = _t(b[j * d:(j + 1) * d])
        _linear(sd, n + "attention.out_proj", lp, "wo", "bo")
        _norm(sd, n + "layer_norm", lp["ln1"])
        _linear(sd, n + "feed_forward.intermediate_dense", lp, "w1", "b1")
        _linear(sd, n + "feed_forward.output_dense", lp, "w2", "b2")
        _norm(sd, n + "final_layer_norm", lp["ln2"])
        if "gru_w" in lp:
            _linear(sd, n + "attention.gru_rel_pos_linear", lp, "gru_w",
                    "gru_b")
            sd[n + "attention.gru_rel_pos_const"] = _t(
                np.reshape(lp["gru_const"], (1, -1, 1, 1)))
    if "rel_embed" in p:
        sd[pre + "encoder.layers.0.attention.rel_attn_embed.weight"] = _t(
            p["rel_embed"])
    if "aux" in p:
        _linear(sd, pre + "aux", p["aux"])


def wav2vec2_from_jax_params(params_np: dict) -> dict:
    """Params of the JAX ``Wav2Vec2`` or ``WavLM`` → ``state_dict`` of the
    port's (HF names): the extractor's convs ``(k, cin, cout)`` →
    ``feature_extractor.conv_layers.{i}.conv (cout, cin, k)``, its norms
    (``n`` or ``gn``) → ``.layer_norm``; ``proj_ln``/``proj`` →
    ``feature_projection.*``; ``pos_conv``/``pos_b`` →
    ``encoder.pos_conv_embed.conv``; ``enc_ln`` → ``encoder.layer_norm``;
    a layer's ``wqkv`` split in ``(q, k, v)`` blocks → ``attention.{q,k,v}
    _proj``, ``wo`` → ``attention.out_proj``, ``ln1``/``ln2`` →
    ``layer_norm``/``final_layer_norm``, ``w1``/``w2`` →
    ``feed_forward.intermediate_dense``/``output_dense``; WavLM's
    ``gru_*`` → ``attention.gru_rel_pos_linear``/``gru_rel_pos_const (1,
    H, 1, 1)`` and ``rel_embed`` → ``encoder.layers.0.attention
    .rel_attn_embed``; ``aux`` → ``aux``."""
    sd = {}
    _w2v2_sd(sd, "", params_np)
    return sd


def _ssl_encoder_sd(sd: dict, pre: str, p: dict):
    """An SSL encoder's params under ``pre``, told apart by their keys."""
    if "extractor" in p:
        _w2v2_sd(sd, pre, p)
        return
    _norm(sd, pre + "proj_ln", p["proj_ln"])
    _linear(sd, pre + "proj", p["proj"])
    if "ffn1" in p["encoder"]["layers"][0]:
        _conformer_sd(sd, pre + "encoder.", p["encoder"])
    else:
        _emformer_sd(sd, pre + "encoder.", p["encoder"])
    if "aux" in p:
        _linear(sd, pre + "aux", p["aux"])


def hubert_pretrain_from_jax_params(params_np: dict) -> dict:
    """Params of the JAX ``HuBERTPretrainModel`` → ``state_dict`` of the
    port's: the encoder (a ``Wav2Vec2``/``WavLM``, a ``ConformerWav2Vec2``
    or an ``EmformerHuBERT``) under ``encoder.``, ``mask_emb`` →
    ``mask_embedding``, ``final_proj`` → ``final_proj``, ``label_emb`` →
    ``label_embeddings``."""
    sd = {}
    _ssl_encoder_sd(sd, "encoder.", params_np["encoder"])
    sd["mask_embedding"] = _t(params_np["mask_emb"])
    _linear(sd, "final_proj", params_np["final_proj"])
    sd["label_embeddings"] = _t(params_np["label_emb"])
    return sd


def conformer_wav2vec2_from_jax_params(params_np: dict) -> dict:
    """Params of the JAX ``ConformerWav2Vec2`` → ``state_dict`` of the
    port's: ``proj_ln``, ``proj``, the Conformer under ``encoder.`` as
    :func:`conformer_from_jax_params` names it, ``aux``.  Params of the
    JAX ``ConformerWav2Vec2PretrainModel`` (``{"encoder", "mask_emb"}``)
    give the wrapper's: the same under ``encoder.`` and
    ``mask_embedding``."""
    sd = {}
    if "mask_emb" in params_np:
        _ssl_encoder_sd(sd, "encoder.", params_np["encoder"])
        sd["mask_embedding"] = _t(params_np["mask_emb"])
    else:
        _ssl_encoder_sd(sd, "", params_np)
    return sd


def emformer_hubert_from_jax_params(params_np: dict) -> dict:
    """Params of the JAX ``EmformerHuBERT`` → ``state_dict`` of the port's:
    ``proj_ln``, ``proj``, the house Emformer under ``encoder.`` as
    :func:`emformer_from_jax_params` names it, ``aux``."""
    sd = {}
    _ssl_encoder_sd(sd, "", params_np)
    return sd


def _fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``w = g · v / ||v||``, the norm over every axis where ``g`` is
    broadcast (size 1): torch's ``dim=`` recovered from the shapes."""
    axes = tuple(i for i, n in enumerate(g.shape) if n == 1)
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=axes, keepdims=True))
    return (g * (v / norm)).astype(np.float32)


def _tensors(state_dict) -> dict:
    return {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v)))
            for k, v in state_dict.items()}


def _folded(sd: dict, name: str) -> torch.Tensor:
    """``sd[name]``, or a weight-normed weight (``weight_g``/``weight_v`` or
    ``parametrizations.weight.original0/1``) folded into the plain one."""
    if name in sd:
        return sd[name]
    if name.endswith(".weight"):
        base = name[:-len(".weight")]
        for g, v in ((base + ".parametrizations.weight.original0",
                      base + ".parametrizations.weight.original1"),
                     (base + ".weight_g", base + ".weight_v")):
            if g in sd:
                return torch.from_numpy(_fold_weight_norm(
                    sd[g].float().numpy(), sd[v].float().numpy()))
    raise KeyError(f"the state_dict has no {name!r} (nor a weight-norm "
                   "parametrization of it)")


def wav2vec2_from_torch_state_dict(state_dict, model) -> dict:
    """An HF-layout ``state_dict`` (``Wav2Vec2Model``/``HubertModel``/
    ``WavLMModel``, or a task model around one) → a ``state_dict`` for the
    port's ``model`` (a ``Wav2Vec2`` or ``WavLM``), as the JAX package's
    ``import_wav2vec2`` reads one:

    * a uniform prefix before ``feature_extractor.conv_layers`` (``wav2vec2
      .``, ``hubert.``, ``wavlm.``, ``model.``) is stripped;
    * a weight-normed weight (``weight_g``/``weight_v`` or
      ``parametrizations.weight.original0/1``, the positional conv's) is
      folded into the plain weight;
    * ``lm_head`` (or ``aux``) is the CTC head, required iff
      ``model.aux_out`` is set;
    * keys the model has no use for (``masked_spec_embed``, quantizer and
      projection heads of pretraining) are ignored.

    Raises ``KeyError`` naming the first weight the checkpoint lacks."""
    sd = _tensors(state_dict)
    marker = "feature_extractor.conv_layers"
    prefix = next((k[:k.find(marker)] for k in sd if marker in k), "")
    if prefix:
        sd = {k[len(prefix):] if k.startswith(prefix) else k: v
              for k, v in sd.items()}

    get = functools.partial(_folded, sd)
    out = {}
    for name, want in model.state_dict().items():
        if name.startswith("aux."):
            head = "lm_head" if "lm_head" + name[3:] in sd else "aux"
            got = get(head + name[3:])
        else:
            got = get(name)
        out[name] = got.reshape(want.shape).to(want.dtype)
    return out


# -- the TTS family ----------------------------------------------------------

_BN_EPS = 1e-5


def _bn(sd: dict, name: str, p: dict):
    """A frozen BatchNorm affine ``{g, b}`` → ``nn.BatchNorm1d`` whose eval
    form is exactly ``y·g + b``: running mean 0, running variance
    ``1 − eps`` (``(1 − eps) + eps`` is 1.0 in float32)."""
    _norm(sd, name, p)
    n = np.shape(p["g"])
    sd[f"{name}.running_mean"] = torch.zeros(n)
    sd[f"{name}.running_var"] = torch.full(n, 1.0 - _BN_EPS)
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _lstm(sd: dict, name: str, p: dict, suffix: str = ""):
    """The JAX LSTM ``{wx, wh, b}`` (one summed bias) → ``weight_ih``,
    ``weight_hh``, ``bias_ih`` = b and ``bias_hh`` = 0."""
    sd[f"{name}.weight_ih{suffix}"] = _t(np.transpose(p["wx"]))
    sd[f"{name}.weight_hh{suffix}"] = _t(np.transpose(p["wh"]))
    sd[f"{name}.bias_ih{suffix}"] = _t(p["b"])
    sd[f"{name}.bias_hh{suffix}"] = torch.zeros(np.shape(p["b"]))


def _conv_bn_stack(sd: dict, name: str, convs: list):
    for i, c in enumerate(convs):
        sd[f"{name}.{i}.0.weight"] = _conv1d(c["w"])
        sd[f"{name}.{i}.0.bias"] = _t(c["b"])
        _bn(sd, f"{name}.{i}.1", c["n"])


def tacotron2_from_jax_params(params_np: dict) -> dict:
    """The JAX ``Tacotron2`` params → the port's ``state_dict`` (the names
    ``import_tacotron2`` reads): conv kernels ``(k, in, out)`` →
    ``(out, in, k)``, dense kernels transposed, the frozen BatchNorm
    affines as ``nn.BatchNorm1d`` (:func:`_bn`), each LSTM's summed bias
    into ``bias_ih``; ``enc_bwd`` is ``encoder.lstm``'s ``_reverse``
    direction."""
    p = params_np
    sd = {"embedding.weight": _t(p["embedding"])}
    _conv_bn_stack(sd, "encoder.convolutions", p["enc_convs"])
    _lstm(sd, "encoder.lstm", p["enc_fwd"], "_l0")
    _lstm(sd, "encoder.lstm", p["enc_bwd"], "_l0_reverse")
    _linear(sd, "decoder.prenet.layers.0", p["prenet1"])
    _linear(sd, "decoder.prenet.layers.1", p["prenet2"])
    _lstm(sd, "decoder.attention_rnn", p["att_rnn"])
    att = "decoder.attention_layer."
    sd[att + "query_layer.weight"] = _t(np.transpose(p["att_query"]))
    sd[att + "memory_layer.weight"] = _t(np.transpose(p["att_memory"]))
    sd[att + "v.weight"] = _t(np.transpose(p["att_v"]))
    sd[att + "location_layer.location_conv.weight"] = _conv1d(
        p["att_loc_conv"])
    sd[att + "location_layer.location_dense.weight"] = _t(
        np.transpose(p["att_loc_fc"]))
    _lstm(sd, "decoder.decoder_rnn", p["dec_rnn"])
    _linear(sd, "decoder.linear_projection", p["mel_out"])
    _linear(sd, "decoder.gate_layer", p["stop"])
    _conv_bn_stack(sd, "postnet.convolutions", p["postnet"])
    return sd


def wavernn_from_jax_params(params_np: dict) -> dict:
    """The JAX ``WaveRNN`` params → the port's ``state_dict`` (the names
    ``import_wavernn`` reads): the MelResNet's convs and frozen BatchNorm
    affines into ``upsample.resnet.melresnet_model.{0,1,3…}``, each
    smoothing kernel ``(K, 1, 1)`` into ``upsample.upsample_layers.{2i+1}``
    as ``(1, 1, 1, K)``, the GRUs' ``{wx, wh, bx, bh}`` into ``rnn1``/
    ``rnn2``."""
    p = params_np
    r = p["resnet"]
    mm = "upsample.resnet.melresnet_model"
    sd = {f"{mm}.0.weight": _conv1d(r["conv_in"])}
    _bn(sd, f"{mm}.1", r["ln_in"])
    for i, blk in enumerate(r["blocks"]):
        rb = f"{mm}.{3 + i}.resblock_model"
        sd[f"{rb}.0.weight"] = _conv1d(blk["c1"])
        _bn(sd, f"{rb}.1", blk["n1"])
        sd[f"{rb}.3.weight"] = _conv1d(blk["c2"])
        _bn(sd, f"{rb}.4", blk["n2"])
    last = f"{mm}.{3 + len(r['blocks'])}"
    sd[f"{last}.weight"] = _conv1d(r["conv_out"])
    sd[f"{last}.bias"] = _t(r["out_b"])
    for i, w in enumerate(p["upsample"]):
        sd[f"upsample.upsample_layers.{2 * i + 1}.weight"] = _t(
            np.reshape(w, (1, 1, 1, -1)))
    _linear(sd, "fc", p["fc_in"])
    for name in ("rnn1", "rnn2"):
        g = p["gru1" if name == "rnn1" else "gru2"]
        sd[f"{name}.weight_ih_l0"] = _t(np.transpose(g["wx"]))
        sd[f"{name}.weight_hh_l0"] = _t(np.transpose(g["wh"]))
        sd[f"{name}.bias_ih_l0"] = _t(g["bx"])
        sd[f"{name}.bias_hh_l0"] = _t(g["bh"])
    for name in ("fc1", "fc2", "fc3"):
        _linear(sd, name, p[name])
    return sd


def hifigan_from_jax_params(params_np: dict) -> dict:
    """The JAX ``HiFiGANVocoder`` params → the port's ``state_dict`` (HF
    ``SpeechT5HifiGan`` names, which ``import_hifigan`` reads): conv
    kernels ``(k, in, out)`` → ``(out, in, k)``; a transposed conv's
    ``(k, out, in)`` (``transpose_kernel=True`` TIO) → ``(in, out, k)``;
    resblock ``r = stage · n_kernels + kernel``, type 1 (``w2`` present)
    as ``convs1``/``convs2``, type 2 as ``convs``."""
    p = params_np
    sd = {"conv_pre.weight": _conv1d(p["pre"]["w"]),
          "conv_pre.bias": _t(p["pre"]["b"])}
    r = 0
    for i, (up, layer) in enumerate(zip(p["ups"], p["mrf"])):
        sd[f"upsampler.{i}.weight"] = _t(np.transpose(up["w"], (2, 1, 0)))
        sd[f"upsampler.{i}.bias"] = _t(up["b"])
        for convs in layer:
            for j, blk in enumerate(convs):
                if "w2" in blk:
                    pairs = (("convs1", "w1", "b1"), ("convs2", "w2", "b2"))
                else:
                    pairs = (("convs", "w1", "b1"),)
                for name, w, b in pairs:
                    sd[f"resblocks.{r}.{name}.{j}.weight"] = _conv1d(blk[w])
                    sd[f"resblocks.{r}.{name}.{j}.bias"] = _t(blk[b])
            r += 1
    sd["conv_post.weight"] = _conv1d(p["post"]["w"])
    sd["conv_post.bias"] = _t(p["post"]["b"])
    return sd


def hifigan_from_torch_state_dict(state_dict, model) -> dict:
    """A HiFi-GAN generator ``state_dict`` in HF ``SpeechT5HifiGan`` or the
    original repo's naming (``ups.{i}`` for ``upsampler.{i}``) → a
    ``state_dict`` for the port's ``model``, as ``import_hifigan`` reads
    one: weight-norm parametrizations folded, the input-normalisation
    buffers ``mean``/``scale`` ignored (feed unnormalised log-mels).  Raises
    ``KeyError`` naming the first weight the checkpoint lacks."""
    sd = _tensors(state_dict)
    out = {}
    for name, want in model.state_dict().items():
        try:
            got = _folded(sd, name)
        except KeyError:
            if not name.startswith("upsampler."):
                raise
            got = _folded(sd, "ups." + name[len("upsampler."):])
        out[name] = got.reshape(want.shape).to(want.dtype)
    return out


# -- separation, assessment and embedding ------------------------------------

def _as_is(sd: dict, name: str, p: dict):
    """Parameters the JAX model keeps in torch's layout: ``{w, b}`` →
    ``weight``, ``bias``."""
    sd[f"{name}.weight"] = _t(p["w"])
    sd[f"{name}.bias"] = _t(p["b"])


def _pointwise_sd(sd: dict, name: str, p: dict):
    """A dense ``{w (cin, cout), b}`` → a kernel-1 conv ``(cout, cin, 1)``."""
    sd[f"{name}.weight"] = _t(np.transpose(p["w"])[:, :, None])
    sd[f"{name}.bias"] = _t(p["b"])


def _gate_ifou_to_ifgo(w) -> np.ndarray:
    """The house LSTMs' gate blocks i, f, o, u (last axis) → torch's i, f,
    g, o (g is the JAX ``u``)."""
    i, f, o, u = np.split(np.asarray(w, np.float32), 4, axis=-1)
    return np.concatenate([i, f, u, o], axis=-1)


def _torch_lstm(sd: dict, name: str, p: dict, suffix: str,
                house: bool = False):
    """A JAX LSTM direction ``{wi (cin, 4H), wh (H, 4H), b}`` as
    :func:`_lstm` carries it; ``house``: the gates permuted from i, f, o, u
    to i, f, g, o first."""
    fix = _gate_ifou_to_ifgo if house else np.asarray
    _lstm(sd, name, {"wx": fix(p["wi"]), "wh": fix(p["wh"]),
                     "b": fix(p["b"])}, suffix)


def conv_tasnet_from_jax_params(params_np: dict) -> dict:
    """The JAX ``ConvTasNet`` params → the port's ``state_dict``
    (torchaudio's names, which ``import_conv_tasnet`` reads): conv kernels
    ``(k, cin, cout)`` → ``(cout, cin, k)`` (the depthwise ``(P, 1, H)``
    → ``(H, 1, P)``), the decoder's ``(L, 1, N)`` (``transpose_kernel``
    TIO) → ``(N, 1, L)``, the gLN ``(1, C)`` affines → ``(C,)``."""
    p = params_np
    mg = "mask_generator"

    def c1(name, q):
        sd[f"{name}.weight"] = _conv1d(q["w"])
        sd[f"{name}.bias"] = _t(q["b"])

    def gln(name, q):
        sd[f"{name}.weight"] = _t(np.reshape(q["g"], -1))
        sd[f"{name}.bias"] = _t(np.reshape(q["b"], -1))

    sd = {"encoder.weight": _conv1d(p["enc"])}
    gln(f"{mg}.input_norm", p["ln_in"])
    c1(f"{mg}.input_conv", p["bottleneck"])
    for i, blk in enumerate(p["blocks"]):
        pre = f"{mg}.conv_layers.{i}"
        c1(f"{pre}.conv_layers.0", blk["in"])
        sd[f"{pre}.conv_layers.1.weight"] = _t(blk["a1"])
        gln(f"{pre}.conv_layers.2", blk["n1"])
        c1(f"{pre}.conv_layers.3", blk["dw"])
        sd[f"{pre}.conv_layers.4.weight"] = _t(blk["a2"])
        gln(f"{pre}.conv_layers.5", blk["n2"])
        if "res" in blk:
            c1(f"{pre}.res_out", blk["res"])
        c1(f"{pre}.skip_out", blk["skip"])
    sd[f"{mg}.output_prelu.weight"] = _t(p["mask_a"])
    c1(f"{mg}.output_conv", p["mask"])
    sd["decoder.weight"] = _t(np.transpose(p["dec"], (2, 1, 0)))
    return sd


def _hdemucs_ta_dconv(sd: dict, pre: str, blocks: list):
    for d, b in enumerate(blocks):
        base = f"{pre}.layers.{d}"
        _as_is(sd, f"{base}.0", b["conv1"])
        _norm(sd, f"{base}.1", b["gn1"])
        j = 3
        if "lstm" in b:
            for k, layer in enumerate(b["lstm"]["l"]):
                _torch_lstm(sd, f"{base}.{j}.lstm", layer["fwd"], f"_l{k}")
                _torch_lstm(sd, f"{base}.{j}.lstm", layer["bwd"],
                            f"_l{k}_reverse")
            _linear(sd, f"{base}.{j}.linear", b["lstm"]["proj"])
            j += 1
        if "attn" in b:
            for mine, theirs in (("content", "content"), ("query", "query"),
                                 ("key", "key"), ("query_decay", "qdecay"),
                                 ("proj", "proj")):
                _pointwise_sd(sd, f"{base}.{j}.{mine}", b["attn"][theirs])
            j += 1
        _as_is(sd, f"{base}.{j}", b["conv2"])
        _norm(sd, f"{base}.{j + 1}", b["gn2"])
        sd[f"{base}.{j + 3}.scale"] = _t(b["scale"])


def hdemucs_ta_from_jax_params(params_np: dict) -> dict:
    """The JAX ``HDemucsTA`` params → the port's ``state_dict`` (torchaudio's
    ``models.HDemucs`` names, which ``import_hdemucs`` reads).  Convs and
    transposed convs are already in torch's layouts; the LocalState 1×1
    dense kernels ``(cin, cout)`` → ``(cout, cin, 1)``, the BiLSTM
    projection transposed, each LSTM direction's summed bias into
    ``bias_ih`` (the gate order is torch's already)."""
    p = params_np
    sd = {"freq_emb.embedding.weight": _t(p["freq_emb"]["w"])}
    for branch in ("encoder", "tencoder"):
        for i, layer in enumerate(p[branch]):
            pre = f"{branch}.{i}"
            _as_is(sd, f"{pre}.conv", layer["conv"])
            if "rewrite" not in layer:
                continue
            _as_is(sd, f"{pre}.rewrite", layer["rewrite"])
            for n in ("norm1", "norm2"):
                if n in layer:
                    _norm(sd, f"{pre}.{n}", layer[n])
            _hdemucs_ta_dconv(sd, f"{pre}.dconv", layer["dconv"])
    for branch in ("decoder", "tdecoder"):
        for i, layer in enumerate(p[branch]):
            pre = f"{branch}.{i}"
            _as_is(sd, f"{pre}.conv_tr", layer["conv_tr"])
            for n in ("rewrite",):
                if n in layer:
                    _as_is(sd, f"{pre}.{n}", layer[n])
            for n in ("norm1", "norm2"):
                if n in layer:
                    _norm(sd, f"{pre}.{n}", layer[n])
    return sd


def _tconv_flip(w) -> torch.Tensor:
    """A ``lax.conv_transpose`` kernel ``(k, cin, cout)`` without
    ``transpose_kernel`` → ``nn.ConvTranspose1d``'s ``(cin, cout, k)``,
    the taps reversed."""
    return _t(np.ascontiguousarray(np.transpose(np.asarray(w)[::-1], (1, 2, 0))))


def _hdemucs_encoder(sd: dict, pre: str, p: dict):
    sd[f"{pre}.conv.weight"] = _conv1d(p["w"])
    _norm(sd, f"{pre}.norm", p["n"])
    for d, b in enumerate(p["dconv"]):
        base = f"{pre}.dconv.{d}"
        sd[f"{base}.conv1.weight"] = _conv1d(b["w1"])
        _norm(sd, f"{base}.norm1", b["n1"])
        if "lstm" in b:
            q = b["lstm"]
            for half, suffix in ((0, "_l0"), (1, "_l0_reverse")):
                direction = {k: np.split(np.asarray(q[k]), 2, axis=-1)[half]
                             for k in ("wi", "wh")}
                direction["b"] = np.split(np.asarray(q["bi"]), 2)[half]
                _torch_lstm(sd, f"{base}.lstm.lstm", direction, suffix,
                            house=True)
            sd[f"{base}.lstm.proj.weight"] = _t(np.transpose(q["proj"]))
        if "attn" in b:
            a = b["attn"]
            _norm(sd, f"{base}.attn.norm", a["n"])
            sd[f"{base}.attn.qkv.weight"] = _t(np.transpose(a["wqkv"]))
            sd[f"{base}.attn.out.weight"] = _t(np.transpose(a["wo"]))
        sd[f"{base}.conv2.weight"] = _conv1d(b["w2"])
        _norm(sd, f"{base}.norm2", b["n2"])
        sd[f"{base}.scale"] = _t(b["scale"])
    sd[f"{pre}.gate.weight"] = _conv1d(p["wg"])
    _norm(sd, f"{pre}.gate_norm", p["ng"])


def hdemucs_from_jax_params(params_np: dict) -> dict:
    """The JAX ``HDemucs`` (the house redesign) params → the port's
    ``state_dict``: conv kernels ``(k, cin, cout)`` → ``(cout, cin, k)``;
    the decoders' and the unmerge's transposed kernels reversed
    (:func:`_tconv_flip`); the merge kernel ``(Fm, C, C)`` → a ``(Fm, 1)``
    Conv2d; each BiLSTM's fused ``wi``/``wh``/``bi`` split into the two
    directions with the gates permuted (:func:`_gate_ifou_to_ifgo`)."""
    p = params_np
    sd = {"freq_emb": _t(p["freq_emb"])}
    for branch in ("enc_t", "enc_f", "enc_s"):
        for i, layer in enumerate(p[branch]):
            _hdemucs_encoder(sd, f"{branch}.{i}", layer)
    for branch in ("dec_s", "dec_t", "dec_f"):
        for i, layer in enumerate(p[branch]):
            pre = f"{branch}.{i}"
            sd[f"{pre}.gate.weight"] = _conv1d(layer["wg"])
            _norm(sd, f"{pre}.gate_norm", layer["ng"])
            sd[f"{pre}.conv_tr.weight"] = _tconv_flip(layer["w"])
    sd["merge.weight"] = _conv1d(p["merge"]["w"])[..., None]
    sd["unmerge.weight"] = _tconv_flip(p["unmerge"]["w"])[..., None]
    return sd


def _squim_house_encoder(sd: dict, p: dict):
    sd["encoder.conv.weight"] = _conv1d(p["enc"]["w"])
    _norm(sd, "encoder.norm", p["enc"]["n"])
    for i, blk in enumerate(p["blocks"]):
        pre = f"encoder.blocks.{i}"
        for part, norm in (("intra", "n1"), ("inter", "n2")):
            q = blk[part]
            _torch_lstm(sd, f"{pre}.{part}.lstm", q["f"], "_l0", house=True)
            _torch_lstm(sd, f"{pre}.{part}.lstm", q["b"], "_l0_reverse",
                        house=True)
            sd[f"{pre}.{part}.proj.weight"] = _t(np.transpose(q["proj"]))
            _norm(sd, f"{pre}.{norm}", blk[norm])


def _squim_pool_head(sd: dict, pool: str, head: str, pp: dict, hp: dict):
    sd[f"{pool}.wq.weight"] = _t(np.transpose(pp["wq"]))
    sd[f"{pool}.q"] = _t(pp["q"])
    _linear(sd, f"{head}.fc1", hp, "w1", "b1")
    _linear(sd, f"{head}.fc2", hp, "w2", "b2")


def squim_objective_from_jax_params(params_np: dict) -> dict:
    """The JAX ``SquimObjective`` (the house build) params → the port's
    ``state_dict``: the encoder conv ``(k, 1, d)`` → ``(d, 1, k)``, dense
    kernels transposed, each BiLSTM direction's gates permuted from i, f,
    o, u to torch's i, f, g, o (:func:`_torch_lstm`)."""
    p = params_np
    sd = {}
    _squim_house_encoder(sd, p)
    for m in ("stoi", "pesq", "si_sdr"):
        _squim_pool_head(sd, f"pool.{m}", f"head.{m}", p["pool"][m],
                         p["head"][m])
    return sd


def squim_subjective_from_jax_params(params_np: dict) -> dict:
    """The JAX ``SquimSubjective`` params → the port's ``state_dict`` (the
    shared encoder as :func:`squim_objective_from_jax_params`, the
    cross-attention's ``wq``/``wk``/``wv`` and norm, the pooled head over
    both representations)."""
    p = params_np
    sd = {}
    _squim_house_encoder(sd, p)
    for name in ("wq", "wk", "wv"):
        sd[f"cross_{name[1]}.weight"] = _t(np.transpose(p["cross"][name]))
    _norm(sd, "cross_norm", p["cross"]["n"])
    _squim_pool_head(sd, "pool", "head", p["pool"], p["head"])
    return sd


def squim_objective_ta_from_jax_params(params_np: dict) -> dict:
    """The JAX ``SquimObjectiveTA`` params → the port's ``state_dict``
    (torchaudio's names, which ``import_squim_objective`` reads): the
    encoder conv ``(k, 1, F)`` → ``(F, 1, k)``; each ``SingleRNN``'s two
    directions into ``rnn`` (``_l0``, ``_l0_reverse``; the summed bias into
    ``bias_ih``) and its ``proj``; the output 1×1 conv ``(F, d)`` →
    ``(d, F, 1, 1)``; each branch's attention, FFN, norms, AutoPool
    ``alpha`` and PReLU head, in (stoi, pesq, si_sdr) order."""
    p = params_np
    sd = {"encoder.conv1d.weight": _conv1d(p["enc"]["w"])}
    for i, blk in enumerate(p["blocks"]):
        for part in ("row", "col"):
            pre = f"dprnn.{part}_rnn.{i}"
            _torch_lstm(sd, f"{pre}.rnn", blk[part]["fwd"], "_l0")
            _torch_lstm(sd, f"{pre}.rnn", blk[part]["bwd"], "_l0_reverse")
            _linear(sd, f"{pre}.proj", blk[part]["proj"])
            _norm(sd, f"dprnn.{part}_norm.{i}", blk[f"{part}_n"])
    oc = p["out_conv"]
    sd["dprnn.conv.0.weight"] = _t(np.transpose(oc["w"])[:, :, None, None])
    sd["dprnn.conv.0.bias"] = _t(oc["b"])
    sd["dprnn.conv.1.weight"] = _t(np.reshape(oc["p"], -1))
    for bi, m in enumerate(("stoi", "pesq", "si_sdr")):
        q, pre = p["branches"][m], f"branches.{bi}"
        a = q["attn"]
        sd[f"{pre}.0.self_attn.in_proj_weight"] = _t(np.transpose(a["in_w"]))
        sd[f"{pre}.0.self_attn.in_proj_bias"] = _t(a["in_b"])
        _linear(sd, f"{pre}.0.self_attn.out_proj", a, "out_w", "out_b")
        _norm(sd, f"{pre}.0.norm1", q["ln1"])
        _linear(sd, f"{pre}.0.linear1", q["ff"], "w1", "b1")
        _linear(sd, f"{pre}.0.linear2", q["ff"], "w2", "b2")
        _norm(sd, f"{pre}.0.norm2", q["ln2"])
        sd[f"{pre}.1.alpha"] = _t(np.reshape(q["alpha"], -1))
        _linear(sd, f"{pre}.2.0", q["head"], "w1", "b1")
        sd[f"{pre}.2.1.weight"] = _t(np.reshape(q["head"]["p"], -1))
        _linear(sd, f"{pre}.2.2", q["head"], "w2", "b2")
    return sd


def vggish_from_jax_params(params_np: dict) -> dict:
    """The JAX ``VGGish`` params → the port's ``state_dict`` (``torchvggish``
    names, which ``import_vggish`` reads): conv kernels HWIO ``(3, 3, in,
    out)`` → OIHW at ``features.{0,3,6,8,11,13}``, dense kernels
    transposed at ``embeddings.{0,2,4}``.  Both models flatten in (H, W, C)
    order, so the first linear needs no permutation."""
    sd = {}
    for i, c in zip((0, 3, 6, 8, 11, 13), params_np["convs"]):
        sd[f"features.{i}.weight"] = _t(np.transpose(c["w"], (3, 2, 0, 1)))
        sd[f"features.{i}.bias"] = _t(c["b"])
    for i, fc in zip((0, 2, 4), params_np["fcs"]):
        _linear(sd, f"embeddings.{i}", fc)
    return sd


def _checked(state_dict, model, what: str) -> dict:
    """``state_dict`` checked against ``model``'s names and sizes and
    returned in the model's shapes and dtypes (keys the model has no use
    for are ignored).  Raises ``KeyError`` naming the first weight the
    checkpoint lacks, ``ValueError`` on a size that differs."""
    sd = _tensors(state_dict)
    out = {}
    for name, want in model.state_dict().items():
        if name not in sd:
            raise KeyError(f"{what}: the state_dict has no {name!r}")
        got = sd[name]
        if got.numel() != want.numel():
            raise ValueError(f"{what}: {name} has shape {tuple(got.shape)}, "
                             f"the model {tuple(want.shape)}")
        out[name] = got.reshape(want.shape).to(want.dtype)
    return out


def conv_tasnet_from_torch_state_dict(state_dict, model) -> dict:
    """A torchaudio ``models.ConvTasNet`` ``state_dict`` (the checkpoint
    ``import_conv_tasnet`` reads) → a ``state_dict`` for the port's
    ``ConvTasNet``, whose names are torchaudio's: checked and passed
    through."""
    return _checked(state_dict, model, "conv_tasnet_from_torch_state_dict")


def hdemucs_from_torch_state_dict(state_dict, model) -> dict:
    """A torchaudio ``models.HDemucs`` ``state_dict`` (the
    ``HDEMUCS_HIGH_MUSDB*`` checkpoints ``import_hdemucs`` reads) → a
    ``state_dict`` for the port's ``HDemucsTA``: checked and passed
    through.  The house ``HDemucs`` cannot load it and raises."""
    from ..models.hdemucs_ta import HDemucsTA
    if not isinstance(model, HDemucsTA):
        raise ValueError(
            "hdemucs_from_torch_state_dict needs the torchaudio layout, "
            f"HDemucsTA (hdemucs_*(compat='torchaudio')); got "
            f"{type(model).__name__}")
    return _checked(state_dict, model, "hdemucs_from_torch_state_dict")


def squim_objective_from_torch_state_dict(state_dict, model) -> dict:
    """A torchaudio ``models.SquimObjective`` ``state_dict`` (the
    ``SQUIM_OBJECTIVE`` checkpoint ``import_squim_objective`` reads) → a
    ``state_dict`` for the port's ``SquimObjectiveTA``: checked and passed
    through (both LSTM biases kept)."""
    from ..models.squim import SquimObjectiveTA
    if not isinstance(model, SquimObjectiveTA):
        raise ValueError(
            "squim_objective_from_torch_state_dict needs the torchaudio "
            "layout, SquimObjectiveTA (squim_objective_base("
            f"compat='torchaudio')); got {type(model).__name__}")
    return _checked(state_dict, model,
                    "squim_objective_from_torch_state_dict")


def vggish_from_torch_state_dict(state_dict, model) -> dict:
    """A ``torchvggish`` ``state_dict`` (the checkpoint ``import_vggish``
    reads) → a ``state_dict`` for the port's ``VGGish``: checked and
    passed through."""
    return _checked(state_dict, model, "vggish_from_torch_state_dict")
