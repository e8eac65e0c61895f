"""The port's mixed-precision helpers (``utils/precision.py``) against the
JAX package's contract, on the CPU: the five cases of the JAX package's
``tests/test_precision.py`` mirrored (dtype routing of ``cast_floats``;
``mixed_precision``'s float32 gradients, its loss near the float32 loss
at the JAX test's 2e-2 bar, integer arguments untouched, ``cast_args``
off), plus the bfloat16 loss of a toy Wav2Vec2 against the JAX
``mixed_precision`` on the same weights (2e-2 relative) and a module's
parameters through ``torch.func.functional_call``.
"""
import numpy as np
import torch
import jax
import jax.numpy as jnp

import torchaudio_contrib_tpu as tac
from torchaudio_contrib_tpu.utils import mixed_precision as jmixed
from torchaudio_contrib_tpu_torch import models as M
from torchaudio_contrib_tpu_torch.utils import (cast_floats, mixed_precision,
                                                wav2vec2_from_jax_params)

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

BF16_REL = 2e-2
TINY = dict(extractor_conv_layers=((8, 10, 5), (8, 3, 2)), d_model=16,
            num_layers=2, num_heads=2, ff_dim=32, pos_conv_kernel=8,
            pos_conv_groups=2)


def _tiny_w2v(seed):
    return M.Wav2Vec2(**TINY, device="cpu",
                      generator=torch.Generator().manual_seed(seed))


def _wave(seed):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        (2, 400)) * 0.1).astype(np.float32))


def _loss_fn(model):
    def loss(params, v):
        out = torch.func.functional_call(model, params, (v,))[0]
        return out.square().mean(), out.dtype
    return loss


def test_cast_floats_routes_dtypes():
    tree = {"w": torch.ones(2, 2), "idx": torch.arange(3, dtype=torch.int32),
            "flag": torch.tensor(True), "z": torch.ones(2, dtype=torch.cfloat),
            "py": 3.5, "none": None, "seq": [torch.ones(1), (torch.ones(1),)]}
    out = cast_floats(tree, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["idx"].dtype == torch.int32
    assert out["flag"].dtype == torch.bool
    assert out["z"].dtype == torch.complex64
    assert out["py"] == 3.5 and out["none"] is None
    assert out["seq"][0].dtype == out["seq"][1][0].dtype == torch.bfloat16
    assert isinstance(out["seq"], list) and isinstance(out["seq"][1], tuple)


def test_mixed_precision_grads_stay_f32():
    """A module's float32 parameters through ``functional_call``: the
    compute is bfloat16, the gradients float32 and finite."""
    model = _tiny_w2v(0)
    params = dict(model.named_parameters())
    loss = _loss_fn(model)
    val, dtype = mixed_precision(loss, output_dtype=None)(params, _wave(0))
    assert dtype == torch.bfloat16 and val.dtype == torch.bfloat16
    val.float().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               and torch.isfinite(p.grad).all() for p in params.values())


def test_mixed_precision_loss_close_to_f32():
    model = _tiny_w2v(1)
    params = {k: v.detach() for k, v in model.named_parameters()}
    x = _wave(1)
    l32 = float(_loss_fn(model)(params, x)[0])
    l16, _ = mixed_precision(_loss_fn(model))(params, x)
    assert l16.dtype == torch.float32
    assert abs(float(l16) - l32) / max(abs(l32), 1e-9) < BF16_REL
    raw, _ = mixed_precision(_loss_fn(model), output_dtype=None)(params, x)
    assert raw.dtype == torch.bfloat16


def test_mixed_precision_skips_integer_args():
    def loss(pp, labels, scale=None):
        assert labels.dtype == torch.int32
        assert scale.dtype == torch.bfloat16
        return (pp["w"] * scale).sum() + 0.0 * labels.sum()

    p = {"w": torch.ones(2)}
    out = mixed_precision(loss)(p, torch.arange(3, dtype=torch.int32),
                                scale=torch.ones(2))
    assert out.dtype == torch.float32


def test_mixed_precision_cast_args_off():
    def loss(pp, v):
        assert v.dtype == torch.float32
        return pp["w"].sum() + v.sum()

    p = {"w": torch.ones(2)}
    out = mixed_precision(loss, cast_args=False)(p, torch.ones(3))
    assert out.dtype == torch.float32


def test_bf16_loss_matches_jax_mixed_precision():
    """The same toy Wav2Vec2 weights in both packages: the bfloat16 losses
    agree with each other and with the float32 loss at 2e-2."""
    jm = tac.Wav2Vec2(**TINY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(0.2 * rng.standard_normal(s.shape)
                              .astype(np.float32)), shapes)
    tm = M.Wav2Vec2(**TINY, device="cpu")
    tm.load_state_dict(wav2vec2_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    x = _wave(3)

    def jloss(pp, v):
        return jnp.mean(jnp.square(jm.apply(pp, v)[0]))

    j16 = float(jax.jit(jmixed(jloss))(params, jnp.asarray(x.numpy())))
    j32 = float(jax.jit(jloss)(params, jnp.asarray(x.numpy())))
    tparams = {k: v.detach() for k, v in tm.named_parameters()}
    t16, _ = mixed_precision(_loss_fn(tm))(tparams, x)
    assert abs(j32 - float(_loss_fn(tm)(tparams, x)[0])) <= 1e-5 * abs(j32)
    assert abs(float(t16) - j16) <= BF16_REL * abs(j16)
    assert abs(float(t16) - j32) <= BF16_REL * abs(j32)
