"""Parity of the port's ``models/wav2vec2.py`` (``Wav2Vec2`` in both
extractor modes and both layer-norm orders, ``WavLM``) with the JAX
package, on the CPU.

Toy widths (the JAX tests' extractor ``((8, 10, 5), (8, 3, 2), (8, 2,
2))``, d 16, 2 layers, 2 heads, FFN 32, positional kernels 8 and 9 in 4
groups).  The JAX parameters, every leaf perturbed so that no bias is zero
(a zero bias hides a padding leak), cross through
``utils.convert.wav2vec2_from_jax_params``; the same numpy inputs go
through the JAX function (under ``jax.jit``, compiled once per module
fixture) and the port.  Bars: values ≤ 1e-4 absolute (BASELINE's bar) and
≤ 1e-5 of the output's peak; gradients ≤ 1e-4 of each parameter's peak,
except the key biases', which are 0 exactly (softmax does not see a shift
common to a query's logits): both packages give rounding there, held to
1e-4 of the same layer's key-weight gradient.
The other way, ``import_wav2vec2(port.state_dict(), jax_model)`` loads a
port model into the JAX one unchanged.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.models.wav2vec2 import (
    Wav2Vec2 as JWav2Vec2, WavLM as JWavLM, wavlm_buckets as j_buckets)
from torchaudio_contrib_tpu.utils.import_torch import import_wav2vec2
from torchaudio_contrib_tpu_torch.models import Wav2Vec2, WavLM, wavlm_buckets
from torchaudio_contrib_tpu_torch.models.wav2vec2 import _bucket_grid
from torchaudio_contrib_tpu_torch.utils import wav2vec2_from_jax_params

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

ATOL = 1e-4      # values, absolute
OUT = 1e-5       # values, relative to the output's peak
GRAD = 1e-4      # gradients, relative to each parameter's peak

TOY = dict(extractor_conv_layers=((8, 10, 5), (8, 3, 2), (8, 2, 2)),
           d_model=16, num_layers=2, num_heads=2, ff_dim=32,
           pos_conv_groups=4)
WAVLM = dict(num_buckets=8, max_distance=20)
# name → (JAX class, port class, keyword arguments)
BUILDS = {
    "group_norm, post-LN, kernel 8": (
        JWav2Vec2, Wav2Vec2, dict(extractor_mode="group_norm",
                                  layer_norm_first=False,
                                  pos_conv_kernel=8)),
    "group_norm, pre-LN, kernel 9, aux": (
        JWav2Vec2, Wav2Vec2, dict(extractor_mode="group_norm",
                                  layer_norm_first=True, pos_conv_kernel=9,
                                  aux_out=5)),
    "layer_norm, pre-LN, kernel 8": (
        JWav2Vec2, Wav2Vec2, dict(extractor_mode="layer_norm",
                                  layer_norm_first=True, pos_conv_kernel=8)),
    "layer_norm, post-LN, kernel 9, conv bias off": (
        JWav2Vec2, Wav2Vec2, dict(extractor_mode="layer_norm",
                                  layer_norm_first=False, pos_conv_kernel=9,
                                  conv_bias=False)),
    "WavLM group_norm, post-LN, kernel 8, aux": (
        JWavLM, WavLM, dict(extractor_mode="group_norm",
                            layer_norm_first=False, pos_conv_kernel=8,
                            aux_out=5, **WAVLM)),
    "WavLM layer_norm, pre-LN, kernel 9": (
        JWavLM, WavLM, dict(extractor_mode="layer_norm",
                            layer_norm_first=True, pos_conv_kernel=9,
                            **WAVLM)),
}
SAMPLES = 400                  # 19 frames at the toy extractor
LENGTHS = np.array([400, 250, 15])   # the last: output_length 0


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _perturb(params, seed):
    """Every leaf plus 0.1 of a standard normal draw: biases (conv,
    LayerNorm, projection, positional conv) become nonzero."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x))
                    .astype(np.float32)) for x in leaves])


def _check(got, want, peak_rel=OUT):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= ATOL, err
    assert err <= peak_rel * np.abs(want).max(), \
        (err, np.abs(want).max())


@pytest.fixture(scope="module", params=list(BUILDS))
def pair(request):
    jcls, tcls, kw = BUILDS[request.param]
    jm = jcls(**TOY, **kw)
    params = _perturb(jm.init(jax.random.PRNGKey(3)), len(request.param))
    tm = tcls(**TOY, **kw, device="cpu")
    tm.load_state_dict(wav2vec2_from_jax_params(_np_tree(params)))
    # one compiled JAX function per build: padded batch, SSL hooks
    def fwd(p, x, lengths, frame_mask, mask_emb):
        return jm.apply(p, x, lengths, frame_mask=frame_mask,
                        mask_embedding=mask_emb, return_features=True)
    return jm, params, tm.eval(), jax.jit(fwd)


def _inputs(rng, b=3):
    x = rng.standard_normal((b, SAMPLES)).astype(np.float32)
    x[1, LENGTHS[1]:] = 0.0
    x[2, LENGTHS[2]:] = 0.0
    mask = rng.random((b, 19)) < 0.3
    emb = rng.standard_normal(16).astype(np.float32)
    return x, mask, emb


def test_padded_batch_with_ssl_hooks_matches_jax(pair, rng):
    """Lengths (one clip with ``output_length`` 0: its attention rows are
    all masked, uniform and finite), a frame mask and the features."""
    jm, params, tm, fwd = pair
    x, mask, emb = _inputs(rng)
    want, wl, wf = fwd(params, jnp.asarray(x), jnp.asarray(LENGTHS),
                       jnp.asarray(mask), jnp.asarray(emb))
    got, gl, gf = tm(torch.from_numpy(x), torch.from_numpy(LENGTHS),
                     frame_mask=torch.from_numpy(mask),
                     mask_embedding=torch.from_numpy(emb),
                     return_features=True)
    assert gl.tolist() == np.asarray(wl).tolist() == [19, 12, 0]
    assert torch.isfinite(got).all()
    _check(got, want)
    _check(gf, wf)


def test_full_batch_without_lengths_matches_jax(pair, rng):
    """No lengths: nothing masked, every frame valid."""
    jm, params, tm, _ = pair
    x = rng.standard_normal((2, SAMPLES)).astype(np.float32)
    want, wl = jax.jit(jm.apply)(params, jnp.asarray(x))
    got, gl = tm(torch.from_numpy(x))
    assert gl.tolist() == np.asarray(wl).tolist() == [19, 19]
    _check(got, want)


def test_gradients_of_every_parameter_match_jax(pair, rng):
    """d(sum(out · g))/d(every parameter): the JAX gradient tree carried
    over by the same bridge as the parameters."""
    jm, params, tm, _ = pair
    x, mask, emb = _inputs(rng)
    t_out = jm.aux_out or 16
    g = rng.standard_normal((3, 19, t_out)).astype(np.float32)

    def loss(p, x):
        y, _, f = jm.apply(p, x, jnp.asarray(LENGTHS),
                           frame_mask=jnp.asarray(mask),
                           mask_embedding=jnp.asarray(emb),
                           return_features=True)
        return jnp.sum(y * g) + jnp.sum(f)

    want = wav2vec2_from_jax_params(_np_tree(jax.jit(jax.grad(loss))(
        params, jnp.asarray(x))))
    tm.zero_grad()
    y, _, f = tm(torch.from_numpy(x), torch.from_numpy(LENGTHS),
                 frame_mask=torch.from_numpy(mask),
                 mask_embedding=torch.from_numpy(emb), return_features=True)
    ((y * torch.from_numpy(g)).sum() + f.sum()).backward()
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] is not None, k
        err = (got[k] - w).abs().max().item()
        if k.endswith("k_proj.bias"):
            peak = want[k.replace(".bias", ".weight")].abs().max().item()
            assert got[k].abs().max().item() <= GRAD * peak, (k, peak)
        else:
            peak = w.abs().max().item()
        assert err <= GRAD * peak, (k, err, peak)


def test_encoder_layer_is_public_and_matches_jax(pair, rng):
    jm, params, tm, _ = pair
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    pad = np.array([[True] * 7, [True] * 4 + [False] * 3])
    bias = None
    if isinstance(tm, WavLM):
        table = np.asarray(params["rel_embed"])
        bias = np.transpose(table[_bucket_grid(7, 8, 20)], (2, 0, 1))
    want = jm.encoder_layer(params["layers"][1], jnp.asarray(x),
                            jnp.asarray(pad),
                            None if bias is None else jnp.asarray(bias))
    got = tm.encoder_layer(tm.encoder.layers[1], torch.from_numpy(x),
                           torch.from_numpy(pad),
                           None if bias is None else torch.from_numpy(bias))
    _check(got, want)


def test_state_dict_loads_into_jax_through_import_wav2vec2(pair, rng):
    """The port's own weights (from a generator) → the JAX package's
    importer, unchanged → the JAX forward equals the port's."""
    jm, _, _, fwd = pair
    jcls, tcls, kw = next(v for v in BUILDS.values() if v[0] is type(jm)
                          and v[2]["pos_conv_kernel"] == jm.pos_k
                          and v[2]["extractor_mode"] == jm.extractor_mode)
    own = tcls(**TOY, **kw, device="cpu",
               generator=torch.Generator().manual_seed(5)).eval()
    params = import_wav2vec2(own.state_dict(), jm)
    x, mask, emb = _inputs(rng)
    want = fwd(params, jnp.asarray(x), jnp.asarray(LENGTHS),
               jnp.asarray(mask), jnp.asarray(emb))[0]
    got = own(torch.from_numpy(x), torch.from_numpy(LENGTHS),
              frame_mask=torch.from_numpy(mask),
              mask_embedding=torch.from_numpy(emb))[0]
    _check(got, want)


@pytest.mark.parametrize("t,nb,md", [(19, 8, 20), (300, 320, 800),
                                     (64, 32, 40)])
def test_wavlm_buckets_equal_jax(t, nb, md):
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]
    np.testing.assert_array_equal(wavlm_buckets(rel, nb, md),
                                  j_buckets(rel, nb, md))
    np.testing.assert_array_equal(_bucket_grid(t, nb, md),
                                  j_buckets(rel, nb, md))
    # the 1-D offset range the sequence-parallel path indexes
    r1 = np.arange(-t + 1, t)
    np.testing.assert_array_equal(wavlm_buckets(r1, nb, md),
                                  j_buckets(r1, nb, md))


@pytest.mark.parametrize("n", [400, 333, 1000, 10, 15, 16])
def test_output_length_matches_jax(n):
    jm = JWav2Vec2(**TOY)
    tm = Wav2Vec2(**TOY, device="cpu")
    assert tm.output_length(n) == jm.output_length(n)
    assert tm.output_length(torch.tensor([n])).tolist() == \
        np.asarray(jm.output_length(jnp.asarray([n]))).tolist()


def test_positional_conv_pads_asymmetrically():
    """Kernel 8: 4 frames on the left, 3 on the right — a lone impulse at
    frame t reaches frames t-3 … t+4 of the positional conv's output."""
    tm = Wav2Vec2(**TOY, pos_conv_kernel=8, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    conv = tm.encoder.pos_conv_embed.conv
    x = torch.zeros(1, 16, 12)
    x[0, :, 6] = 1.0
    with torch.no_grad():
        conv.bias.zero_()
        y = conv(torch.nn.functional.pad(x, (4, 3)))
    assert y.shape[-1] == 12
    hit = (y[0].abs().sum(0) > 0).nonzero().flatten().tolist()
    assert hit == list(range(3, 11))


def test_card_default_and_validation():
    if not torch.cuda.is_available():
        # the default device is the card: no CPU fallback
        with pytest.raises((AssertionError, RuntimeError)):
            Wav2Vec2(**TOY)
    with pytest.raises(ValueError):
        Wav2Vec2(**{**TOY, "d_model": 15}, device="cpu")
    with pytest.raises(ValueError):
        Wav2Vec2(**TOY, extractor_mode="batch_norm", device="cpu")
    with pytest.raises(ValueError):
        WavLM(**TOY, num_buckets=7, device="cpu")
    tm = Wav2Vec2(**TOY, device="cpu")
    with pytest.raises(ValueError):
        tm(torch.zeros(2, 100, 1))
    with pytest.raises(ValueError, match="mask_embedding"):
        tm(torch.zeros(1, 400), frame_mask=torch.zeros(1, 19, dtype=bool))
