"""Parity of the port's ASR models (``models/asr.py``: ``Wav2Letter``,
``DeepSpeech``) and of the ASR slice as a whole with the JAX package, on
the CPU.

The weights cross both ways: the JAX models' parameters through
``utils.convert`` into the port's, and the port's ``state_dict`` (whose
names are torchaudio's) through the JAX package's own importers
(``import_wav2letter``, ``import_deepspeech``) into the JAX models.
Outputs are held to 1e-5 of peak.  The slice: waveform → ``mfcc`` (plain
path) → Wav2Letter → ``ctc_loss`` → 2 SGD steps → ``ctc_greedy_decode``
→ ``edit_distance_batched`` in both packages from the same weights:
losses 1e-5 relative, parameters within 1e-4 of the update, decoded
tokens and distances equal.  Wav2Letter runs at a toy width (its body's
channel table patched on both classes alike) except in one full-width
forward.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torchaudio_contrib_tpu as tac
from torchaudio_contrib_tpu.models.asr import (DeepSpeech as JDeepSpeech,
                                               Wav2Letter as JWav2Letter)
from torchaudio_contrib_tpu.utils.import_torch import (import_deepspeech,
                                                       import_wav2letter)
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.models import DeepSpeech, Wav2Letter
from torchaudio_contrib_tpu_torch.utils import (deepspeech_from_jax_params,
                                                wav2letter_from_jax_params)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

OUT = 1e-5
LOSS_REL = 1e-5
STEP = 1e-4
TOY_BODY = [(7, 1, 16)] * 7 + [(32, 1, 24), (1, 1, 24)]


@pytest.fixture()
def toy(monkeypatch):
    monkeypatch.setattr(JWav2Letter, "_BODY", TOY_BODY)
    monkeypatch.setattr(Wav2Letter, "_BODY", TOY_BODY)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


INPUTS = {"waveform": (1, (2, 9600)), "mfcc": (13, (2, 13, 40)),
          "power_spectrum": (9, (3, 9, 33))}


@pytest.mark.parametrize("compat", ["tpu", "torchaudio"])
@pytest.mark.parametrize("input_type", list(INPUTS))
def test_wav2letter_matches_jax_both_ways(rng, toy, compat, input_type):
    nf, shape = INPUTS[input_type]
    jm = JWav2Letter(num_classes=7, input_type=input_type, num_features=nf,
                     compat=compat)
    params = jm.init(jax.random.PRNGKey(int(rng.integers(1 << 30))))
    tm = Wav2Letter(num_classes=7, input_type=input_type, num_features=nf,
                    compat=compat, device="cpu")
    tm.load_state_dict(wav2letter_from_jax_params(_np_tree(params)))
    x = rng.standard_normal(shape).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x))
    assert _rel(tm(torch.from_numpy(x)), want) <= OUT
    if compat == "torchaudio":
        own = Wav2Letter(num_classes=7, input_type=input_type,
                         num_features=nf, compat=compat, device="cpu",
                         generator=torch.Generator().manual_seed(3))
        back = import_wav2letter(own.state_dict(), jm)
        assert _rel(own(torch.from_numpy(x)),
                    jm.apply(back, jnp.asarray(x))) <= OUT


def test_wav2letter_full_width_matches_jax(rng):
    """The published channel table (250 and 2000 channels, ~23 M
    parameters) at a few frames."""
    jm = JWav2Letter(num_classes=29, input_type="mfcc", num_features=13)
    params = jm.init(jax.random.PRNGKey(0))
    tm = Wav2Letter(num_classes=29, input_type="mfcc", num_features=13,
                    device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(params))
    tm.load_state_dict(wav2letter_from_jax_params(_np_tree(params)))
    x = rng.standard_normal((1, 13, 24)).astype(np.float32)
    assert _rel(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x))) \
        <= OUT


def test_wav2letter_checks_its_arguments():
    with pytest.raises(ValueError):
        Wav2Letter(input_type="bogus", device="cpu")
    with pytest.raises(ValueError):
        Wav2Letter(input_type="waveform", num_features=3, device="cpu")
    with pytest.raises(ValueError):
        Wav2Letter(compat="keras", device="cpu")
    m = Wav2Letter(num_classes=5, input_type="mfcc", num_features=4,
                   device="cpu")
    with pytest.raises(ValueError):
        m(torch.zeros((2, 3, 10)))
    with pytest.raises(ValueError):
        wav2letter_from_jax_params({"layers": [{}] * 5})


@pytest.mark.parametrize("log_probs", [False, True])
def test_deepspeech_matches_jax_both_ways(rng, log_probs):
    jm = JDeepSpeech(n_feature=10, n_hidden=24, n_class=7)
    params = jm.init(jax.random.PRNGKey(int(rng.integers(1 << 30))))
    tm = DeepSpeech(10, 24, 7, device="cpu")
    tm.load_state_dict(deepspeech_from_jax_params(_np_tree(params)))
    x = rng.standard_normal((3, 13, 10)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x), log_probs=log_probs)
    assert _rel(tm(torch.from_numpy(x), log_probs=log_probs), want) <= OUT
    own = DeepSpeech(10, 24, 7, device="cpu",
                     generator=torch.Generator().manual_seed(5))
    back = import_deepspeech(own.state_dict(), jm)
    assert _rel(own(torch.from_numpy(x), log_probs=log_probs),
                jm.apply(back, jnp.asarray(x), log_probs=log_probs)) <= OUT
    with pytest.raises(ValueError):
        tm(torch.zeros((3, 13, 4)))


def test_deepspeech_gradients_match_jax(rng):
    jm = JDeepSpeech(n_feature=6, n_hidden=16, n_class=5)
    params = jm.init(jax.random.PRNGKey(7))
    tm = DeepSpeech(6, 16, 5, device="cpu")
    tm.load_state_dict(deepspeech_from_jax_params(_np_tree(params)))
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    g = rng.standard_normal((2, 9, 5)).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * g))(
        params)
    (tm(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    got = dict(tm.named_parameters())
    pairs = [("fc1.fc.weight", want["fc1"]["w"].T),
             ("fc3.fc.bias", want["fc3"]["b"]),
             ("bi_rnn.weight_hh_l0", want["rnn"]["fwd"]["wh"].T),
             ("bi_rnn.weight_ih_l0_reverse", want["rnn"]["bwd"]["wx"].T),
             ("bi_rnn.bias_ih_l0_reverse", want["rnn"]["bwd"]["b"]),
             ("bi_rnn.bias_hh_l0", want["rnn"]["fwd"]["b"]),
             ("out.weight", want["out"]["w"].T)]
    for name, w in pairs:
        assert _rel(got[name].grad, w) <= STEP, name


# ---- the slice as a whole ---------------------------------------------------

def test_asr_slice_trains_and_decodes_as_jax(rng, toy):
    sr, classes, lr = 16000, 8, 0.05
    wave = (0.3 * rng.standard_normal((2, 12000))).astype(np.float32)
    targets = rng.integers(1, classes, (2, 6))
    tgt_len = np.array([6, 4])
    feat_kw = dict(sample_rate=sr, n_mfcc=13, num_mels=40, fft_length=512,
                   hop_length=160)
    jfeat = tac.ops.mfcc(jnp.asarray(wave), **feat_kw)
    tfeat = tops.mfcc(torch.from_numpy(wave), **feat_kw)
    assert _rel(tfeat, jfeat) <= 1e-4

    jm = JWav2Letter(num_classes=classes, input_type="mfcc", num_features=13)
    params = jm.init(jax.random.PRNGKey(11))
    tm = Wav2Letter(num_classes=classes, input_type="mfcc", num_features=13,
                    device="cpu")
    tm.load_state_dict(wav2letter_from_jax_params(_np_tree(params)))

    def jloss(p):
        lp = jax.nn.log_softmax(jm.apply(p, jfeat), -1)
        return tac.ops.ctc_loss(lp, targets, None, tgt_len)

    step = jax.jit(jax.value_and_grad(jloss))
    opt = torch.optim.SGD(tm.parameters(), lr=lr)
    start = _np_tree(params)
    for _ in range(2):
        jl, jg = step(params)
        params = jax.tree_util.tree_map(lambda w, g: w - lr * g, params, jg)
        opt.zero_grad()
        lp = torch.log_softmax(tm(tfeat), -1)
        tl = tops.ctc_loss(lp, torch.from_numpy(targets), None,
                           torch.from_numpy(tgt_len))
        tl.backward()
        opt.step()
        np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_REL)
    after = wav2letter_from_jax_params(_np_tree(params))
    before = wav2letter_from_jax_params(start)
    for name, p in tm.state_dict().items():
        update = np.abs(after[name].numpy() - before[name].numpy()).max()
        assert update > 0, name
        assert np.abs(p.numpy() - after[name].numpy()).max() \
            <= STEP * update, name

    jlp = jax.nn.log_softmax(jm.apply(params, jfeat), -1)
    with torch.no_grad():
        tlp = torch.log_softmax(tm(tfeat), -1)
    jt, jn, _ = tac.ops.ctc_greedy_decode(jlp)
    tt, tn, _ = tops.ctc_greedy_decode(tlp)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn.sum()) > 0
    jd = tac.ops.edit_distance_batched(targets, jt, tgt_len, jn)
    td = tops.edit_distance_batched(torch.from_numpy(targets), tt,
                                    torch.from_numpy(tgt_len), tn)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# -- the models' cuDNN precision (every model the port has) ------------------

@functools.lru_cache(maxsize=1)
def _c1_cases():
    """(name, model, the conv or RNN to hook, a call through the model's
    outermost entry point), every model at a toy width on the CPU."""
    from torchaudio_contrib_tpu_torch import models as M
    g = torch.Generator().manual_seed(0)
    w2l = Wav2Letter(num_classes=5, input_type="mfcc", num_features=4,
                     device="cpu", generator=g)
    ds = DeepSpeech(4, n_hidden=8, n_class=5, device="cpu", generator=g)
    conf = M.Conformer(6, d_model=8, num_layers=1, num_heads=2,
                       conv_kernel=3, device="cpu", generator=g)
    emf = M.ConvEmformer(8, 2, 16, 1, 4, kernel_size=3, device="cpu",
                         generator=g)
    w2v = M.Wav2Vec2(extractor_conv_layers=((8, 10, 5), (8, 3, 2)),
                     d_model=8, num_layers=1, num_heads=2, ff_dim=16,
                     pos_conv_kernel=4, pos_conv_groups=2, device="cpu",
                     generator=g)
    clf = M.MelFrontendClassifier(num_classes=3, num_mels=16,
                                  channels=(4,), generator=g)
    pred = M.RNNTPredictor(9, 6, 8, 10, device="cpu", generator=g)
    taco = M.Tacotron2(n_symbols=10, n_mels=8, embed_dim=8, encoder_dim=8,
                       attention_dim=4, attention_filters=2,
                       attention_kernel=3, decoder_dim=8, prenet_dim=4,
                       postnet_dim=8, device="cpu", generator=g).eval()
    wrnn = M.WaveRNN(upsample_scales=(2, 3), hop_length=6, n_res_block=1,
                     n_rnn=8, n_fc=8, n_freq=4, n_hidden=4, n_output=4,
                     n_classes=8, device="cpu", generator=g).eval()
    hifi = M.HiFiGANVocoder(in_channels=4, upsample_initial_channel=32,
                            device="cpu", generator=g)
    tok, tl = torch.tensor([[1, 2, 3]]), torch.tensor([3])
    spec = torch.randn(1, 4, 6, generator=g)
    return [
        ("Wav2Letter", w2l, w2l.acoustic_model[0],
         lambda: w2l(torch.randn(1, 4, 20))),
        ("DeepSpeech", ds, ds.bi_rnn, lambda: ds(torch.randn(1, 5, 4))),
        ("Conformer", conf, conf.conformer_layers[0].conv_module
         .sequential[2], lambda: conf(torch.randn(1, 7, 6))),
        ("ConvEmformer.forward", emf,
         emf.emformer_layers[0].conv_module.pointwise_conv1,
         lambda: emf(torch.randn(1, 8, 8), torch.tensor([8]))),
        ("ConvEmformer.infer", emf,
         emf.emformer_layers[0].conv_module.pointwise_conv1,
         lambda: emf.infer(torch.randn(1, 4, 8), emf.init_state(1))),
        ("Wav2Vec2 extractor", w2v,
         w2v.feature_extractor.conv_layers[0].conv,
         lambda: w2v(torch.randn(1, 400))),
        ("Wav2Vec2 positional conv", w2v, w2v.encoder.pos_conv_embed.conv,
         lambda: w2v(torch.randn(1, 400))),
        ("MelFrontendClassifier", clf, clf.convs[0],
         lambda: clf(torch.randn(2, 1, 2000))),
        ("MelFrontendClassifier.train_step", clf, clf.convs[0],
         lambda: clf.train_step(torch.randn(2, 1, 2000),
                                torch.tensor([0, 1]))),
        ("RNNTPredictor", pred, pred.lstm,
         lambda: pred(torch.tensor([[1, 2, 3]]))),
        ("Tacotron2.forward", taco, taco.encoder.lstm,
         lambda: taco(tok, tl, torch.randn(1, 8, 3))),
        ("Tacotron2.infer", taco, taco.postnet.convolutions[0][0],
         lambda: taco.infer(tok, tl, max_steps=2)),
        ("WaveRNN.forward", wrnn, wrnn.rnn1,
         lambda: wrnn(torch.zeros(1, 12), spec)),
        ("WaveRNN.infer", wrnn, wrnn.upsample.resnet.melresnet_model[0],
         lambda: wrnn.infer(spec)),
        ("HiFiGANVocoder", hifi, hifi.conv_pre,
         lambda: hifi(torch.randn(1, 4, 3))),
    ]


@pytest.mark.parametrize("case", range(15))
def test_models_pin_cudnn_to_fp32(case):
    """Inside every model's forward (and ``infer``/``train_step``) cuDNN
    runs without TF32 while the global flag allows it, and the flags the
    pin does not concern keep their values; after the call the global
    flags are as they were."""
    name, _, module, call = _c1_cases()[case]
    c = torch.backends.cudnn
    saved = (c.allow_tf32, c.benchmark, c.deterministic)
    seen = []

    def hook(mod, args):
        seen.append((c.allow_tf32, c.benchmark, c.deterministic, c.enabled))

    handle = module.register_forward_pre_hook(hook)
    try:
        c.allow_tf32, c.benchmark, c.deterministic = True, True, True
        call()
        after = (c.allow_tf32, c.benchmark, c.deterministic)
    finally:
        handle.remove()
        c.allow_tf32, c.benchmark, c.deterministic = saved
    assert seen, f"{name}: the hooked module did not run"
    assert all(s == (False, True, True, True) for s in seen), (name, seen)
    assert after == (True, True, True), name
