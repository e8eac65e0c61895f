"""``MelFrontendClassifier``: the port's forward vs the JAX model's, with
the JAX model's own parameters loaded through ``from_jax_params``."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torchaudio_contrib_tpu.models import MelFrontendClassifier as JModel
from torchaudio_contrib_tpu_torch.models import MelFrontendClassifier as TModel
from torchaudio_contrib_tpu_torch.models.frontend import _same_pad
from torchaudio_contrib_tpu_torch.utils import from_jax_params

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

CFG = dict(num_classes=10, num_mels=64, sample_rate=16000, fft_length=512,
           hop_length=128)


def _pair(fused, trainable=True):
    jm = JModel(fused=fused, trainable_frontend=trainable, **CFG)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    tm = TModel(fused=fused, trainable_frontend=trainable, **CFG)
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n_samples", [16000, 16128, 16100])
def test_logits_match_jax(rng, fused, n_samples):
    """Batch 2 × ~1 s.  16000 samples give an even mel/frame grid at every
    conv (64 mels; 126 frames center=True, 122 center=False), where XLA's
    SAME padding is (0, 1): padding (1, 1) would shift every output.
    16128/16100 give odd frame counts ((1, 1) padding)."""
    jm, params, tm = _pair(fused)
    x = rng.standard_normal((2, 1, n_samples)).astype(np.float32)
    want = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, params),
                               jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_features_match_jax(rng):
    jm, params, tm = _pair(fused=False, trainable=False)
    x = rng.standard_normal((2, 2, 8000)).astype(np.float32)
    want = np.asarray(jm.features(jax.tree_util.tree_map(jnp.asarray,
                                                         params),
                                  jnp.asarray(x)))
    with torch.no_grad():
        got = tm.features(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 64, 1 + 8000 // 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_same_padding_matches_xla():
    # XLA SAME at stride 2, kernel 3: even sizes pad (0, 1), odd (1, 1)
    assert _same_pad(64, 3, 2) == (0, 1)
    assert _same_pad(126, 3, 2) == (0, 1)
    assert _same_pad(127, 3, 2) == (1, 1)
    assert _same_pad(1, 3, 2) == (1, 1)
    for size in (1, 2, 5, 8, 31, 64):
        x = jnp.ones((1, size, 1, 1))
        w = jnp.ones((3, 1, 1, 1))
        y = jax.lax.conv_general_dilated(
            x, w, (2, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        lo, hi = _same_pad(size, 3, 2)
        want = np.convolve(np.pad(np.ones(size), (lo, hi)), np.ones(3),
                           "valid")[::2]
        np.testing.assert_array_equal(np.asarray(y).ravel(), want)


def test_converted_state_dict_layout():
    _, params, tm = _pair(fused=False)
    sd = from_jax_params(params)
    assert set(sd) == set(tm.state_dict())
    assert "frontend.2.filterbank" in sd
    assert tuple(sd["convs.1.weight"].shape) == (64, 32, 3, 3)
    assert tuple(sd["head.weight"].shape) == (10, 128)
    _, params_f, tm_f = _pair(fused=True)
    assert set(from_jax_params(params_f)) == set(tm_f.state_dict())
    assert "frontend.0.filterbank" in tm_f.state_dict()


def _train_inputs(rng):
    x = rng.standard_normal((2, 1, 8000)).astype(np.float32)
    return x, np.array([3, 7], dtype=np.int32)


@pytest.mark.parametrize("fused", [True, False])
def test_loss_matches_jax(rng, fused):
    jm, params, tm = _pair(fused)
    x, labels = _train_inputs(rng)
    want = float(jm.loss_fn(jax.tree_util.tree_map(jnp.asarray, params),
                            jnp.asarray(x), jnp.asarray(labels)))
    with torch.no_grad():
        got = float(tm.loss_fn(torch.from_numpy(x), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("steps,tol", [(1, 1e-4), (3, 1e-3)])
def test_train_steps_match_jax(rng, fused, steps, tol):
    """``steps`` plain SGD steps at lr 1e-3 from the same parameters.  The
    loss of every step agrees within 1e-5 relative.  Every parameter after
    the steps (filterbank included) agrees within ``tol`` of the largest
    change the JAX steps made to it: ~6e-6 is measured after one step;
    the third step's loss jumps ~30x (dB features at lr 1e-3), which
    amplifies the f32 rounding of the gradients to ~4e-4."""
    jm, params, tm = _pair(fused)
    x, labels = _train_inputs(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    xj, lj = jnp.asarray(x), jnp.asarray(labels)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    for _ in range(steps):
        jp, jloss = jm.train_step(jp, xj, lj, 1e-3)
        tloss = tm.train_step(xt, lt, lr=1e-3)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    start = from_jax_params(params)
    got = tm.state_dict()
    assert set(got) == set(want)
    assert any(k.endswith("filterbank") for k in got)
    for name, value in want.items():
        update = np.abs(np.asarray(value) - np.asarray(start[name])).max()
        err = np.abs(got[name].numpy() - np.asarray(value)).max()
        assert update > 0, name
        assert err <= tol * update, (name, err, update)


def test_seeded_init_is_deterministic():
    a = TModel(fused=True, generator=torch.Generator().manual_seed(3), **CFG)
    b = TModel(fused=True, generator=torch.Generator().manual_seed(3), **CFG)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert not a.convs[0].bias.detach().any()
