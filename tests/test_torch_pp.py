"""The port's pipeline parallelism (``parallel/pp.py``) on a 4-rank gloo
world of CPU processes: the GPipe schedule equals the sequential stack,
forward and gradients, with pytree activations, on 1-, 2- and 4-stage
meshes and on a (pipe 2, data 2) mesh, and through a wav2vec2 encoder
stack; the JAX package's ``test_pp.py`` cases, and the same stacks against
the JAX package at 1e-4.

One world runs every check (``_world``); each case reads its own check.
Bars: the JAX tests' (forward 1e-6, gradients 1e-5; the wav2vec2 stack
1e-5) against the port's unsharded stack.  The wav2vec2 weights are the
JAX model's, crossed through ``utils.convert.wav2vec2_from_jax_params``.
"""
import os

import numpy as np
import pytest
import torch

from _torch_world import check, run_world, value

torch.set_num_threads(2)

WORLD = 4
D = 16
W2V = dict(extractor_conv_layers=((8, 10, 5), (8, 3, 2)), d_model=16,
           num_layers=8, num_heads=2, ff_dim=32, pos_conv_kernel=8,
           pos_conv_groups=2, layer_norm_first=False)


def _dense_layers(n, d, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (0.5 * rng.standard_normal((d, d))).astype(np.float32),
             "b": np.full((d,), 0.01, np.float32)} for _ in range(n)]


def _torch_layers(layers, grad=False):
    return [{k: torch.tensor(v, requires_grad=grad) for k, v in l.items()}
            for l in layers]


def _dense_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _masked_fn(p, act):
    x, m = act
    return (torch.tanh(x @ p["w"] + p["b"]) * m, m)


def _sequential(layers, fn, x):
    for p in layers:
        x = fn(p, x)
    return x


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _mask():
    return np.repeat((np.arange(8.0)[None, :] < 5).astype(np.float32), 8, 0)


# ---------------------------------------------------------------- worker

def _worker(rank, world, tmpdir):
    from torch.distributed.device_mesh import DeviceMesh
    from torchaudio_contrib_tpu_torch.models import Wav2Vec2
    from torchaudio_contrib_tpu_torch.parallel import (
        build_pipeline, pipeline_apply, pipeline_shard, stack_pipeline,
        unstack_pipeline)

    ranks = torch.arange(world)
    pipe4 = DeviceMesh("cpu", ranks, mesh_dim_names=("pipe",))
    pipe2 = DeviceMesh("cpu", ranks.reshape(2, 2),
                       mesh_dim_names=("pipe", "data"))
    pipe1 = DeviceMesh("cpu", ranks.reshape(1, 4),
                       mesh_dim_names=("pipe", "data"))
    res = {}

    def forward_4_stages():
        layers = _torch_layers(_dense_layers(8, D, 0))
        stacked = pipeline_shard(stack_pipeline(layers, 4), pipe4)
        x = torch.tensor(_x(0, (8, D)))
        return (pipeline_apply(_dense_fn, stacked, x, mesh=pipe4,
                               n_microbatches=4),
                pipeline_apply(_dense_fn, stacked, x, mesh=pipe4,
                               n_microbatches=2),
                _sequential(layers, _dense_fn, x))

    def single_stage():
        layers = _torch_layers(_dense_layers(4, 8, 1))
        x = torch.tensor(_x(1, (4, 8)))
        out = pipeline_apply(_dense_fn, stack_pipeline(layers, 1), x,
                             mesh=pipe1, n_microbatches=2)
        return out, _sequential(layers, _dense_fn, x)

    def gradients(mesh, data_axis):
        layers = _torch_layers(_dense_layers(4, 8, 2), grad=True)
        ref_layers = _torch_layers(_dense_layers(4, 8, 2), grad=True)
        x = torch.tensor(_x(2, (8, 8)), requires_grad=True)
        xr = x.detach().clone().requires_grad_()
        stacked = stack_pipeline(layers, 2)
        y = pipeline_apply(_dense_fn, stacked, x, mesh=mesh,
                           data_axis=data_axis, n_microbatches=2)
        (y ** 2).sum().backward()
        (_sequential(ref_layers, _dense_fn, xr) ** 2).sum().backward()
        _, idx, _ = _axis(mesh, "pipe")
        mine = stacked[idx]
        got = [(l["w"].grad, l["b"].grad) for l in mine]
        want = [(l["w"].grad, l["b"].grad)
                for l in ref_layers[2 * idx:2 * idx + 2]]
        return y.detach(), x.grad, got, want, xr.grad

    def pytree_activation():
        layers = _torch_layers(_dense_layers(4, 8, 3))
        stacked = stack_pipeline(layers, 4)
        x = torch.tensor(_x(3, (8, 8)))
        m = torch.tensor(_mask())
        out = pipeline_apply(_masked_fn, stacked, (x, m), mesh=pipe4,
                             n_microbatches=4)
        return out, _sequential(layers, _masked_fn, (x, m))

    def two_d_mesh():
        layers = _torch_layers(_dense_layers(4, 8, 4))
        x = torch.tensor(_x(4, (16, 8)))
        out = pipeline_apply(_dense_fn, stack_pipeline(layers, 2), x,
                             mesh=pipe2, data_axis="data",
                             n_microbatches=4)
        try:
            pipeline_apply(_dense_fn, stack_pipeline(layers, 2), x,
                           mesh=pipe2, data_axis="nope", n_microbatches=4)
            raised = None
        except ValueError as e:
            raised = str(e)
        return out, _sequential(layers, _dense_fn, x), raised

    def stage_count():
        layers = _torch_layers(_dense_layers(4, 8, 0))
        try:
            pipeline_apply(_dense_fn, stack_pipeline(layers, 2),
                           torch.zeros(4, 8), mesh=pipe4)
        except ValueError as e:
            return str(e)
        return None

    def wav2vec2_stack():
        model = Wav2Vec2(**W2V, device="cpu")
        model.load_state_dict(torch.load(os.path.join(tmpdir, "w2v.pt")))
        x = torch.tensor(_x(5, (8, 12, 16)))
        stacked = pipeline_shard(stack_pipeline(model.encoder.layers, 4),
                                 pipe4)
        with torch.no_grad():
            out = pipeline_apply(model.encoder_layer, stacked, x,
                                 mesh=pipe4, n_microbatches=4)
            ref = model._encode(x, None)
        return out, ref, len(unstack_pipeline(stacked))

    def reuses_callable():
        return build_pipeline(_dense_fn, pipe2, n_microbatches=2) is \
            build_pipeline(_dense_fn, pipe2, n_microbatches=2)

    check(res, "forward_4_stages", forward_4_stages)
    check(res, "single_stage", single_stage)
    check(res, "gradients", gradients, pipe2, None)
    check(res, "gradients_2d", gradients, pipe2, "data")
    check(res, "pytree_activation", pytree_activation)
    check(res, "two_d_mesh", two_d_mesh)
    check(res, "stage_count", stage_count)
    check(res, "wav2vec2_stack", wav2vec2_stack)
    check(res, "reuses_callable", reuses_callable)
    return res


def _axis(mesh, name):
    from torchaudio_contrib_tpu_torch.parallel._comm import axis_group
    return axis_group(mesh, name)


# ---------------------------------------------------------------- parent

@pytest.fixture(scope="module")
def jax_w2v():
    import jax
    from torchaudio_contrib_tpu.models import Wav2Vec2 as JWav2Vec2
    model = JWav2Vec2(**W2V)
    params = model.init(jax.random.PRNGKey(5))
    return model, params


@pytest.fixture(scope="module")
def world(jax_w2v, tmp_path_factory):
    import jax
    from torchaudio_contrib_tpu_torch.utils import wav2vec2_from_jax_params
    tmp = tmp_path_factory.mktemp("pp_world")
    _, params = jax_w2v
    torch.save(wav2vec2_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)), tmp / "w2v.pt")
    return run_world("test_torch_pp:_worker", WORLD, tmp)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def _jax_sequential(layers, x, masked=False):
    import jax.numpy as jnp
    act = (jnp.asarray(x[0]), jnp.asarray(x[1])) if masked \
        else jnp.asarray(x)
    for p in layers:
        if masked:
            xx, m = act
            act = (jnp.tanh(xx @ p["w"] + p["b"]) * m, m)
        else:
            act = jnp.tanh(act @ p["w"] + p["b"])
    return act


def test_stack_microbatch_round_trips():
    from torchaudio_contrib_tpu_torch.parallel import (
        microbatch, stack_pipeline, unmicrobatch, unstack_pipeline)
    layers = _torch_layers(_dense_layers(8, 4, 0))
    stacked = stack_pipeline(layers, 4)
    assert len(stacked) == 4 and all(len(b) == 2 for b in stacked)
    back = unstack_pipeline(stacked)
    assert len(back) == 8
    for a, b in zip(layers, back):
        assert torch.equal(a["w"], b["w"])
    x = torch.arange(24.0).reshape(12, 2)
    assert microbatch(x, 4).shape == (4, 3, 2)
    assert torch.equal(unmicrobatch(microbatch(x, 4)), x)
    with pytest.raises(ValueError, match="stages"):
        stack_pipeline(layers, 3)
    with pytest.raises(ValueError, match="microbatches"):
        microbatch(x, 5)
    modules = stack_pipeline([torch.nn.Linear(2, 2) for _ in range(4)], 2)
    assert isinstance(modules, torch.nn.ModuleList)
    assert len(list(modules.parameters())) == 8


def test_pipeline_matches_sequential(world):
    for rank in world:
        out4, out2, ref = value(rank, "forward_4_stages")
        _close(out4, ref, 1e-6)
        _close(out2, ref, 1e-6)   # n_micro < n_stages still drains
    _close(out4, _jax_sequential(_dense_layers(8, D, 0), _x(0, (8, D))),
           1e-4)


def test_pipeline_single_stage_degenerates(world):
    out, ref = value(world[0], "single_stage")
    _close(out, ref, 1e-6)


def test_pipeline_gradients_match_sequential(world):
    for rank in world:
        y, gx, got, want, gx_ref = value(rank, "gradients")
        _close(gx, gx_ref, 1e-5)
        for (gw, gb), (ww, wb) in zip(got, want):
            _close(gw, ww, 1e-5)
            _close(gb, wb, 1e-5)


def test_pipeline_gradients_on_2d_mesh(world):
    """With data_axis the stage's parameters get their gradients summed
    over the data ranks, the input its whole gradient."""
    for rank in world:
        y, gx, got, want, gx_ref = value(rank, "gradients_2d")
        _close(gx, gx_ref, 1e-5)
        for (gw, gb), (ww, wb) in zip(got, want):
            _close(gw, ww, 1e-5)
            _close(gb, wb, 1e-5)


def test_pipeline_gradients_match_jax():
    import jax
    import jax.numpy as jnp
    layers = _dense_layers(4, 8, 2)
    x = _x(2, (8, 8))
    jl = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]

    def loss(ls, v):
        return jnp.sum(_jax_sequential(ls, v) ** 2)

    g_ls, g_x = jax.grad(loss, argnums=(0, 1))(jl, jnp.asarray(x))
    tl = _torch_layers(layers, grad=True)
    xt = torch.tensor(x, requires_grad=True)
    (_sequential(tl, _dense_fn, xt) ** 2).sum().backward()
    _close(xt.grad, g_x, 1e-4)
    for t, j in zip(tl, g_ls):
        _close(t["w"].grad, j["w"], 1e-4)


def test_pipeline_pytree_activation(world):
    for rank in world:
        (out, m_out), (ref, _) = value(rank, "pytree_activation")
        _close(out, ref, 1e-6)
        assert torch.equal(m_out, torch.tensor(_mask()))
    jref, _ = _jax_sequential(_dense_layers(4, 8, 3),
                              (_x(3, (8, 8)), _mask()), masked=True)
    _close(out, jref, 1e-4)


def test_pipeline_2d_mesh_with_data_parallel(world):
    for rank in world:
        out, ref, raised = value(rank, "two_d_mesh")
        _close(out, ref, 1e-6)
        assert raised is not None and "axis" in raised
    _close(out, _jax_sequential(_dense_layers(4, 8, 4), _x(4, (16, 8))),
           1e-4)


def test_pipeline_validates_stage_count(world):
    msg = value(world[0], "stage_count")
    assert msg is not None and "stages" in msg


def test_pipeline_wav2vec2_encoder_stack(world, jax_w2v):
    import jax
    import jax.numpy as jnp
    model, params = jax_w2v
    want = jax.jit(lambda p, x: model._encode(p, x, pad_mask=None))(
        params, jnp.asarray(_x(5, (8, 12, 16))))
    for rank in world:
        out, ref, n_local = value(rank, "wav2vec2_stack")
        assert n_local == 2
        _close(out, ref, 1e-5)
    _close(out, want, 1e-4)


def test_build_pipeline_reuses_callable(world):
    assert value(world[0], "reuses_callable") is True


def test_workers_import_no_jax(world):
    for rank in world:
        assert rank["_jax_modules"] == []
