"""The port's ``utils.import_torch`` against the JAX package's, on the CPU.

For each of the 14 importers, one torchaudio-layout (HF's for wav2vec2 and
HiFi-GAN, ``torchvggish``'s for VGGish) ``state_dict`` at toy widths,
taken from a port model built from a seeded generator, with its BatchNorm
statistics and its LSTMs' hidden biases drawn away from their initial
values: the JAX ``import_X`` followed by the port's ``X_from_jax_params``
gives the port's ``import_X`` tensor for tensor (``import_lstm`` and
``import_gru`` through a one-layer ``nn.LSTM``/``nn.GRU``).  The JAX
importers fold each BatchNorm into its inference affine and sum each
LSTM's (and DeepSpeech's RNN's) two biases, where the port's keep the
checkpoint as it is; the port's result is compared in that folded form,
computed with the JAX package's float64 arithmetic.  A missing key, an
extra key and a wrong shape raise; ``load_torch_state_dict`` unwraps both
nestings.  The model pairs (toy configurations and JAX classes) are the
ones the per-family parity files hold.
"""
import functools

import numpy as np
import pytest
import torch
import jax

from torchaudio_contrib_tpu.utils import import_torch as jimp
from torchaudio_contrib_tpu_torch import models as M
from torchaudio_contrib_tpu_torch.utils import convert
from torchaudio_contrib_tpu_torch.utils import import_torch as timp

import test_torch_asr_models as tasr
import test_torch_conformer as tconf
import test_torch_hdemucs as thd
import test_torch_rnnt_models as trnnt
import test_torch_squim as tsq
import test_torch_tacotron2 as ttaco
import test_torch_tasnet as ttas
import test_torch_vggish as tvgg
import test_torch_vocoders as tvoc
import test_torch_wav2vec2 as tw2v

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

BN_EPS = 1e-5


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _checkpoint(sd, seed):
    """``sd`` with every BatchNorm's running statistics and every hidden
    bias of an LSTM, GRU or RNN drawn away from their initial values."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        if k.endswith("running_mean") or "bias_hh" in k:
            v = torch.from_numpy(0.1 * rng.standard_normal(v.shape)
                                 .astype(np.float32))
        elif k.endswith("running_var"):
            v = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32))
        out[k] = v
    return out


def _as_jax_reads(sd, sums_biases):
    """``sd`` in the form the JAX route gives: each BatchNorm folded into
    its inference affine (``g = w / √(var + eps)``, ``b = bias − mean·g``
    in float64, as the JAX ``_fold_bn``) with mean 0, variance ``1 − eps``
    (as ``convert._bn`` writes a frozen affine), and, where the JAX
    importer sums them, each ``bias_hh`` added into its ``bias_ih``."""
    out = dict(sd)
    for k in [k for k in sd if k.endswith(".running_var")]:
        bn = k[:-len(".running_var")]
        w, b, mean, var = (sd[f"{bn}.{n}"].numpy().astype(np.float64)
                           for n in ("weight", "bias", "running_mean",
                                     "running_var"))
        g = w / np.sqrt(var + BN_EPS)
        out[f"{bn}.weight"] = torch.from_numpy(g.astype(np.float32))
        out[f"{bn}.bias"] = torch.from_numpy((b - mean * g)
                                             .astype(np.float32))
        out[f"{bn}.running_mean"] = torch.zeros(g.shape)
        out[f"{bn}.running_var"] = torch.full(g.shape, 1.0 - BN_EPS)
        out[f"{bn}.num_batches_tracked"] = torch.tensor(0)
    if sums_biases:
        for k in [k for k in sd if "bias_hh" in k]:
            ih = k.replace("bias_hh", "bias_ih")
            out[ih] = torch.from_numpy(sd[ih].numpy() + sd[k].numpy())
            out[k] = torch.zeros(sd[k].shape)
    return out


# -- the cases: (torchaudio-layout state_dict, port model, JAX model) ---------

def _wav2vec2():
    jcls, tcls, kw = tw2v.BUILDS["group_norm, pre-LN, kernel 9, aux"]
    tm = tcls(**tw2v.TOY, **kw, device="cpu", generator=_gen(1))
    return tm.state_dict(), tm, jcls(**tw2v.TOY, **kw)


def _hifigan():
    cfg = dict(in_channels=8, **tvoc.HTOY["v1"])
    tm = M.HiFiGANVocoder(**cfg, device="cpu", generator=_gen(2))
    return tm.state_dict(), tm, tvoc.jhifigan.HiFiGANVocoder(**cfg)


def _conv_tasnet():
    tm = M.ConvTasNet(**ttas.TOY, device="cpu", generator=_gen(3))
    return tm.state_dict(), tm, ttas.JConvTasNet(**ttas.TOY)


def _hdemucs():
    tm = M.HDemucsTA(**thd.TA, device="cpu", generator=_gen(4))
    return tm.state_dict(), tm, thd.JHDemucsTA(**thd.TA)


def _squim_objective():
    tm = M.SquimObjectiveTA(**tsq.TA, device="cpu", generator=_gen(5))
    return tm.state_dict(), tm, tsq.JObjectiveTA(**tsq.TA)


def _vggish():
    tm = M.VGGish(device="cpu", generator=_gen(6))
    return tm.state_dict(), tm, tvgg.JVGGish()


def _wavernn():
    tm = M.WaveRNN(**tvoc.WTOY, device="cpu", generator=_gen(7))
    return tm.state_dict(), tm, tvoc.JWaveRNN(**tvoc.WTOY)


def _tacotron2():
    tm = M.Tacotron2(**ttaco.TOY, device="cpu", generator=_gen(8))
    return tm.state_dict(), tm, ttaco.JTacotron2(**ttaco.TOY)


def _emformer_rnnt():
    cfg = trnnt.BUILDS["compat"]
    tm = M.emformer_rnnt_model(**cfg, device="cpu", generator=_gen(9))
    return tm.state_dict(), tm, trnnt.JM.emformer_rnnt_model(**cfg)


def _wav2letter():
    cfg = dict(num_classes=29, input_type="mfcc", num_features=13,
               compat="torchaudio")
    tm = M.Wav2Letter(**cfg, device="cpu", generator=_gen(10))
    return tm.state_dict(), tm, tasr.JWav2Letter(**cfg)


def _deepspeech():
    tm = M.DeepSpeech(10, 24, 7, device="cpu", generator=_gen(11))
    return tm.state_dict(), tm, tasr.JDeepSpeech(n_feature=10, n_hidden=24,
                                                 n_class=7)


def _conformer():
    """torchaudio's Conformer layout from the port's: no input projection
    and no relative-position table, and a BatchNorm after the depthwise
    convolution (its affine the port's, its statistics drawn later)."""
    d = tconf.CFG["d_model"]
    tm = M.Conformer(d, conv_norm="affine", **tconf.CFG, device="cpu",
                     generator=_gen(12))
    sd = {}
    for k, v in tm.state_dict().items():
        if k.startswith("input_projection.") or k.endswith("rel_bias"):
            continue
        sd[k] = v
        if k.endswith("conv_module.sequential.3.bias"):
            bn = k[:-len(".bias")]
            sd[f"{bn}.running_mean"] = torch.zeros(d)
            sd[f"{bn}.running_var"] = torch.ones(d)
            sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
    return sd, tm, tconf.JConformer(d, conv_norm="affine", **tconf.CFG)


def _rnn(cls, prefix):
    rnn = cls(5, 7)
    rng = np.random.default_rng(13)
    with torch.no_grad():
        for p in rnn.parameters():
            p.copy_(torch.from_numpy(0.3 * rng.standard_normal(p.shape)
                                     .astype(np.float32)))
    sd = {f"{prefix}.{k}": v for k, v in rnn.state_dict().items()}
    sd["head.weight"] = torch.ones(3, 7)      # outside the prefix
    return sd, rnn


def _lstm_from_jax(layers):
    """The JAX ``import_lstm`` layers ``{wi, wh, b}`` → ``nn.LSTM``
    names, the one bias into ``bias_ih`` (as ``convert._predictor_sd``)."""
    out = {}
    for i, lp in enumerate(layers):
        out[f"weight_ih_l{i}"] = torch.tensor(np.asarray(lp["wi"]).T)
        out[f"weight_hh_l{i}"] = torch.tensor(np.asarray(lp["wh"]).T)
        out[f"bias_ih_l{i}"] = torch.tensor(np.asarray(lp["b"]))
        out[f"bias_hh_l{i}"] = torch.zeros(np.shape(lp["b"]))
    return out


def _gru_from_jax(g):
    """The JAX ``import_gru`` dict ``{wx, wh, bx, bh}`` → ``nn.GRU``
    names (as ``convert.wavernn_from_jax_params``)."""
    return {"weight_ih_l0": torch.tensor(np.asarray(g["wx"]).T),
            "weight_hh_l0": torch.tensor(np.asarray(g["wh"]).T),
            "bias_ih_l0": torch.tensor(np.asarray(g["bx"])),
            "bias_hh_l0": torch.tensor(np.asarray(g["bh"]))}


# name → (the case's maker, JAX importer, the port's converter from its params,
# the JAX importer sums the recurrent biases)
MODELS = {
    "wav2vec2": (_wav2vec2, jimp.import_wav2vec2,
                 convert.wav2vec2_from_jax_params, False),
    "hifigan": (_hifigan, jimp.import_hifigan,
                convert.hifigan_from_jax_params, False),
    "conv_tasnet": (_conv_tasnet, jimp.import_conv_tasnet,
                    convert.conv_tasnet_from_jax_params, False),
    "hdemucs": (_hdemucs, jimp.import_hdemucs,
                convert.hdemucs_ta_from_jax_params, True),
    "squim_objective": (_squim_objective, jimp.import_squim_objective,
                        convert.squim_objective_ta_from_jax_params, True),
    "vggish": (_vggish, jimp.import_vggish, convert.vggish_from_jax_params,
               False),
    "wavernn": (_wavernn, jimp.import_wavernn,
                convert.wavernn_from_jax_params, False),
    "tacotron2": (_tacotron2, jimp.import_tacotron2,
                  convert.tacotron2_from_jax_params, True),
    "emformer_rnnt": (_emformer_rnnt, jimp.import_emformer_rnnt,
                      convert.emformer_rnnt_from_jax_params, False),
    "wav2letter": (_wav2letter, jimp.import_wav2letter,
                   convert.wav2letter_from_jax_params, False),
    "deepspeech": (_deepspeech, jimp.import_deepspeech,
                   convert.deepspeech_from_jax_params, True),
    "conformer": (_conformer, jimp.import_conformer,
                  convert.conformer_from_jax_params, False),
}
# the importers that read torchaudio's names as they are (or fold them, the
# Conformer): every key of the checkpoint must be the model's
AS_IS = ("wavernn", "tacotron2", "emformer_rnnt", "wav2letter", "deepspeech",
         "conformer")


@functools.lru_cache(maxsize=None)
def _built(name):
    sd, tm, jm = MODELS[name][0]()
    return _checkpoint(sd, len(name)), tm, jm


def _import(name, sd):
    _, tm, _ = _built(name)
    return getattr(timp, f"import_{name}")(sd, tm)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(
            got[k].to(want[k].dtype), want[k]), k


def test_all_names_are_the_jax_modules():
    assert timp.__all__ == jimp.__all__
    assert sorted(list(MODELS) + ["gru", "lstm"]) == sorted(
        n[len("import_"):] for n in jimp.__all__ if n.startswith("import_"))


@pytest.mark.parametrize("name", list(MODELS))
def test_importer_is_the_jax_importer_then_the_converter(name):
    _, jimport, from_jax, sums = MODELS[name]
    sd, tm, jm = _built(name)
    got = _import(name, sd)
    want = from_jax(_np_tree(jimport(sd, jm)))
    _assert_same(_as_jax_reads(got, sums), want)
    tm.load_state_dict(got, strict=True)


@pytest.mark.parametrize("name", ["lstm", "gru"])
def test_recurrent_importers_are_the_jax_ones(name):
    cls = torch.nn.LSTM if name == "lstm" else torch.nn.GRU
    sd, rnn = _rnn(cls, "enc.rnn")
    if name == "lstm":
        got = timp.import_lstm(sd, "enc.rnn", 1)
        want = _lstm_from_jax(jimp.import_lstm(sd, "enc.rnn", 1))
        _assert_same(_as_jax_reads(got, True), want)
    else:
        got = timp.import_gru(sd, "enc.rnn.")
        _assert_same(got, _gru_from_jax(jimp.import_gru(sd, "enc.rnn.")))
    cls(5, 7).load_state_dict(got, strict=True)
    with pytest.raises(KeyError):
        (timp.import_lstm(sd, "enc.rnn", 2) if name == "lstm"
         else timp.import_gru(sd, "dec.rnn"))


def _first_weight(sd):
    return next(k for k in sd if k.endswith("weight"))


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_importer_rejects_a_bad_checkpoint(name, fault):
    sd = dict(_built(name)[0])
    k = _first_weight(sd)
    if fault == "missing":
        del sd[k]
    else:
        sd[k] = torch.zeros(sd[k].numel() + 1)
    with pytest.raises((KeyError, ValueError, RuntimeError)):
        _import(name, sd)


@pytest.mark.parametrize("name", AS_IS)
def test_importer_rejects_an_unexpected_key(name):
    sd = dict(_built(name)[0])
    sd["conformer_layers.9.extra.weight" if name == "conformer"
       else "extra.weight"] = torch.zeros(2)
    with pytest.raises(ValueError, match="unexpected"):
        _import(name, sd)


def test_importers_refuse_the_other_builds():
    with pytest.raises(ValueError, match="compat='torchaudio'"):
        timp.import_wav2letter({}, M.Wav2Letter(num_classes=5,
                                                input_type="mfcc",
                                                num_features=4,
                                                device="cpu"))
    with pytest.raises(ValueError, match="conv_norm='affine'"):
        timp.import_conformer({}, M.Conformer(16, **tconf.CFG,
                                              device="cpu"))
    sd = {k: v for k, v in _built("conformer")[0].items()
          if "running" not in k}
    with pytest.raises(NotImplementedError, match="use_group_norm"):
        _import("conformer", sd)


@pytest.mark.parametrize("nesting", [None, "state_dict", "model"])
def test_load_torch_state_dict_unwraps(tmp_path, nesting):
    sd = {"a.weight": torch.arange(3.0), "b.bias": torch.ones(2)}
    path = tmp_path / "ck.pt"
    torch.save(sd if nesting is None else {nesting: sd, "epoch": 3}, path)
    got = timp.load_torch_state_dict(path)
    assert sorted(got) == sorted(sd)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    torch.save([1, 2], path)
    with pytest.raises(ValueError, match="state dict"):
        timp.load_torch_state_dict(path)
