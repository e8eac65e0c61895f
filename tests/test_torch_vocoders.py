"""Parity of the port's neural vocoders (``models/wavernn.py``,
``models/hifigan.py``) with the JAX package's, on the CPU, at toy widths.

Random JAX parameters (no bias or BatchNorm affine at its initial
value) go through ``utils.convert`` into the port's modules
in eval mode; the port's own ``state_dict`` goes through the JAX
package's ``import_wavernn``/``import_hifigan`` the other way.  Bars:
logits and waveforms 1e-4 of peak.  WaveRNN's ``infer`` draws from
another random stream than the JAX package's, so it is held with ``fc3``
made confident (its weight times 1e4: a step's top-2 logit margin is
then above 20, where the Gumbel noise that picks a class is a few units):
each step's class is then the argmax in both packages, and the classes
must be equal (the sample values 2c/(n − 1) − 1 to 1e-6, since XLA turns
the division into a product by the reciprocal).  The JAX references run
under ``jax.jit``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from torch.nn.utils.parametrizations import weight_norm

from torchaudio_contrib_tpu.models import hifigan as jhifigan
from torchaudio_contrib_tpu.models.wavernn import WaveRNN as JWaveRNN
from torchaudio_contrib_tpu.utils.import_torch import (import_hifigan,
                                                       import_wavernn)
from torchaudio_contrib_tpu_torch import models as M
from torchaudio_contrib_tpu_torch.utils import (
    hifigan_from_jax_params, hifigan_from_torch_state_dict,
    wavernn_from_jax_params)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

OUT = 1e-4
SAMPLE_ATOL = 1e-6
CONFIDENT = 1e4

WTOY = dict(upsample_scales=(2, 3), hop_length=6, n_res_block=2, n_rnn=16,
            n_fc=16, n_freq=8, n_hidden=8, n_output=8, n_classes=32)
T_MEL = 7                                    # 6·(7 − 5 + 1) = 18 samples


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _params(jm, seed, scale=0.3):
    """Random parameters in the JAX model's tree, drawn with NumPy into
    ``jax.eval_shape(jm.init)`` (the JAX ``init`` run eagerly costs
    seconds to tens of seconds on the CPU): no bias and no BatchNorm
    affine at its initial value."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(scale * rng.standard_normal(s.shape)
                              .astype(np.float32)), shapes)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _wavernn(params):
    tm = M.WaveRNN(**WTOY, device="cpu").eval()
    tm.load_state_dict(wavernn_from_jax_params(_np_tree(params)))
    return tm


@pytest.fixture(scope="module")
def wpair():
    jm = JWaveRNN(**WTOY)
    params = _params(jm, 1)
    return jm, params, jax.jit(jm.apply), jax.jit(jm.infer)


def _confident(params):
    params = dict(params)
    params["fc3"] = {"w": params["fc3"]["w"] * CONFIDENT,
                     "b": params["fc3"]["b"]}
    return params


def _spec(rng):
    """A loud spectrogram: at this toy width a quiet one conditions every
    step to the same class."""
    return 5.0 * rng.standard_normal((2, 8, T_MEL)).astype(np.float32)


def _classes(samples, n):
    return np.rint((np.asarray(samples) + 1.0) * (n - 1) / 2).astype(int)


def test_wavernn_apply_matches_jax(rng, wpair):
    jm, params, apply, _ = wpair
    spec = rng.standard_normal((2, 8, T_MEL)).astype(np.float32)
    wav = rng.uniform(-1, 1, (2, 18)).astype(np.float32)
    want = apply(params, jnp.asarray(wav), jnp.asarray(spec))
    got = _wavernn(params).apply(torch.from_numpy(wav),
                                 torch.from_numpy(spec))
    assert got.shape == (2, 18, 32)
    assert _rel(got, want) <= OUT
    with pytest.raises(ValueError, match="waveform length"):
        _wavernn(params)(torch.zeros(2, 17), torch.from_numpy(spec))


def test_wavernn_infer_matches_jax_when_confident(rng, wpair):
    jm, params, _, infer = wpair
    params = _confident(params)
    spec = _spec(rng)
    want = np.asarray(infer(params, jnp.asarray(spec),
                            jax.random.PRNGKey(3)))
    got = _wavernn(params).infer(torch.from_numpy(spec),
                                 torch.Generator().manual_seed(4)).numpy()
    assert got.shape == want.shape == (2, 18)
    assert np.array_equal(_classes(got, 32), _classes(want, 32))
    assert np.abs(got - want).max() <= SAMPLE_ATOL
    assert len(np.unique(_classes(got, 32))) > 1


@pytest.mark.parametrize("confident", [True, False])
def test_wavernn_infer_is_apply_on_its_own_history(rng, wpair, confident):
    """Teacher-forced ``apply`` on the generated history gives the logits
    ``infer`` drew from: with ``fc3`` confident each sample is their
    argmax; without, each sample is a class centre and the draw follows
    the generator (the same seed, the same samples)."""
    _, params, _, _ = wpair
    tm = _wavernn(_confident(params) if confident else params)
    spec = torch.from_numpy(_spec(rng))
    out = tm.infer(spec, torch.Generator().manual_seed(7))
    cls = _classes(out.numpy(), 32)
    assert np.allclose(out.numpy(), 2.0 * cls / 31 - 1.0, atol=SAMPLE_ATOL)
    again = tm.infer(spec, torch.Generator().manual_seed(7))
    assert torch.equal(out, again)
    if confident:
        history = torch.cat([torch.zeros(2, 1), out[:, :-1]], 1)
        with torch.no_grad():
            logits = tm(history, spec)
        assert np.array_equal(logits.argmax(-1).numpy(), cls)
        top2 = logits.topk(2, -1).values
        assert float((top2[..., 0] - top2[..., 1]).min()) > 20.0


def test_jax_importer_loads_the_wavernn_weights(rng, wpair):
    jm, _, apply, _ = wpair
    tm = M.WaveRNN(**WTOY, device="cpu",
                   generator=torch.Generator().manual_seed(2)).eval()
    spec = rng.standard_normal((2, 8, T_MEL)).astype(np.float32)
    wav = rng.uniform(-1, 1, (2, 18)).astype(np.float32)
    want = apply(import_wavernn(tm.state_dict(), jm), jnp.asarray(wav),
                 jnp.asarray(spec))
    with torch.no_grad():
        got = tm(torch.from_numpy(wav), torch.from_numpy(spec))
    assert _rel(got, want) <= OUT


# -- HiFi-GAN ------------------------------------------------------------------

# the published v1 / v2 / v3 topologies at small channel counts
HTOY = {
    "v1": dict(upsample_initial_channel=32),
    "v2": dict(upsample_initial_channel=16),
    "v3": dict(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
               upsample_initial_channel=32, resblock_kernel_sizes=(3, 5, 7),
               resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)),
               resblock_type=2),
}


@pytest.mark.parametrize("name", list(HTOY))
def test_hifigan_matches_jax(rng, name):
    jm = jhifigan.HiFiGANVocoder(in_channels=8, **HTOY[name])
    params = _params(jm, 1, 0.1)
    apply = jax.jit(jm.apply)
    tm = M.HiFiGANVocoder(in_channels=8, **HTOY[name], device="cpu")
    tm.load_state_dict(hifigan_from_jax_params(_np_tree(params)))
    mel = rng.standard_normal((2, 8, 5)).astype(np.float32)
    want = apply(params, jnp.asarray(mel))
    with torch.no_grad():
        got = tm(torch.from_numpy(mel))
        assert tm(torch.from_numpy(mel[0])).shape == (1, 5 * 256)
    assert got.shape == (2, 1, 5 * 256) == tuple(want.shape)
    assert _rel(got, want) <= OUT
    # the other way: the JAX importer reads the port's HF names
    own = M.HiFiGANVocoder(in_channels=8, **HTOY[name], device="cpu",
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        own_out = own(torch.from_numpy(mel))
    back = apply(import_hifigan(own.state_dict(), jm), jnp.asarray(mel))
    assert _rel(own_out, back) <= OUT


@pytest.mark.parametrize("frames", [1, 3, 8])
def test_hifigan_output_length(frames):
    tm = M.HiFiGANVocoder(in_channels=4, **HTOY["v3"], device="cpu")
    rates = tm.rates
    with torch.no_grad():
        y = tm(torch.zeros(1, 4, frames))
    assert y.shape == (1, 1, frames * int(np.prod(rates)))


def test_hifigan_torch_state_dict_with_weight_norm(rng):
    """An original-repo checkpoint: weight-normed convs, ``ups.{i}`` for
    ``upsampler.{i}`` and the HF normalisation buffers, read back to the
    same function."""
    tm = M.HiFiGANVocoder(in_channels=8, **HTOY["v3"], device="cpu",
                          generator=torch.Generator().manual_seed(1))
    normed = M.HiFiGANVocoder(in_channels=8, **HTOY["v3"], device="cpu")
    normed.load_state_dict(tm.state_dict())
    for mod in normed.modules():
        if isinstance(mod, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            weight_norm(mod)
    sd = {k.replace("upsampler.", "ups."): v
          for k, v in normed.state_dict().items()}
    sd["mean"], sd["scale"] = torch.zeros(8), torch.ones(8)
    loaded = M.HiFiGANVocoder(in_channels=8, **HTOY["v3"], device="cpu")
    loaded.load_state_dict(hifigan_from_torch_state_dict(sd, loaded))
    mel = torch.from_numpy(rng.standard_normal((1, 8, 4)).astype(np.float32))
    with torch.no_grad():
        assert _rel(loaded(mel), tm(mel)) <= 1e-5


@pytest.mark.parametrize("factory", ["hifigan_vocoder_v1",
                                     "hifigan_vocoder_v2",
                                     "hifigan_vocoder_v3"])
def test_hifigan_factories_geometry_on_meta(factory):
    """The published geometries: every parameter's shape equals the JAX
    factory's, carried by the converter (no weights are made)."""
    jm = getattr(jhifigan, factory)()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    sd = hifigan_from_jax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    tm = getattr(M, factory)(device="meta")
    assert {n: tuple(v.shape) for n, v in tm.state_dict().items()} \
        == {n: tuple(v.shape) for n, v in sd.items()}
    assert M.hifigan_vocoder(upsample_initial_channel=8,
                             device="meta").upsample_factor == 256


def test_wavernn_bundle_geometry_on_meta():
    """The bundle's WaveRNN (n_rnn 512, 80 mels, hop 275 as 5·5·11): every
    parameter's shape equals the JAX model's."""
    kw = dict(upsample_scales=(5, 5, 11), hop_length=275, n_freq=80)
    shapes = jax.eval_shape(JWaveRNN(**kw).init, jax.random.PRNGKey(0))
    sd = wavernn_from_jax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    tm = M.WaveRNN(**kw, device="meta")
    assert {n: tuple(v.shape) for n, v in tm.state_dict().items()} \
        == {n: tuple(v.shape) for n, v in sd.items()}
