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
:func:`emformer_hubert_from_jax_params` for the wav2vec2 family.  None
imports JAX.  The other way, the JAX package's ``utils.import_torch``
importers (``import_wav2letter``, ``import_deepspeech``,
``import_emformer_rnnt``, ``import_wav2vec2``) load the port's
``state_dict`` s, whose names are torchaudio's (HF's for the wav2vec2
family).  :func:`wav2vec2_from_torch_state_dict` reads an HF-layout
checkpoint (a task prefix, ``lm_head``, a weight-normed positional conv,
pretraining leftovers) into the port's names.  The inverse path (ISTFT,
Griffin-Lim, mel inversion, the vocoder ops) has no parameters, so it needs
no conversion.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_params", "wav2letter_from_jax_params",
           "deepspeech_from_jax_params", "emformer_from_jax_params",
           "conformer_from_jax_params", "emformer_rnnt_from_jax_params",
           "conformer_rnnt_from_jax_params", "wav2vec2_from_jax_params",
           "hubert_pretrain_from_jax_params",
           "conformer_wav2vec2_from_jax_params",
           "emformer_hubert_from_jax_params",
           "wav2vec2_from_torch_state_dict"]


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
    sd = {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
              else torch.as_tensor(np.asarray(v)))
          for k, v in state_dict.items()}
    marker = "feature_extractor.conv_layers"
    prefix = next((k[:k.find(marker)] for k in sd if marker in k), "")
    if prefix:
        sd = {k[len(prefix):] if k.startswith(prefix) else k: v
              for k, v in sd.items()}

    def get(name: str) -> torch.Tensor:
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

    out = {}
    for name, want in model.state_dict().items():
        if name.startswith("aux."):
            head = "lm_head" if "lm_head" + name[3:] in sd else "aux"
            got = get(head + name[3:])
        else:
            got = get(name)
        out[name] = got.reshape(want.shape).to(want.dtype)
    return out
