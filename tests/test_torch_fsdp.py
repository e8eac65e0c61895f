"""The port's FSDP (``parallel/fsdp.py``) and sharded checkpoints
(``utils.save_checkpoint``/``load_checkpoint``, torch.distributed.checkpoint)
on a 4-rank gloo world of CPU processes: the largest-divisible-dim rule and
``min_size`` against the JAX package's ``fsdp_specs`` on the same model, a
sharded train step equal to the replicated one, FSDP + TP on a (data 2,
model 2) mesh, ``base_specs``/``override``, the optimizer state on the
shards, and a checkpoint saved from a 2-way FSDP layout loaded on one
process and the reverse, bitwise; the JAX package's ``test_fsdp.py`` and
``test_checkpoint.py`` (orbax) cases.

One world runs every check; each case reads its own.  Bars: the JAX
tests' (loss 1e-6, gradients 3e-5, forward 2e-5) against the port's
replicated model; 1e-4 against the JAX package (its gradients crossed
through ``utils.convert.wav2vec2_from_jax_params``, which also carries the
weights).
"""
import os

import numpy as np
import pytest
import torch

from _torch_world import check, run_world, value

torch.set_num_threads(2)

WORLD = 4
TINY = dict(extractor_conv_layers=((8, 10, 5), (8, 3, 2)), d_model=16,
            num_layers=2, num_heads=2, ff_dim=32, pos_conv_kernel=8,
            pos_conv_groups=2)


def _wav(seed, b):
    return np.random.default_rng(seed).standard_normal((b, 400)) \
        .astype(np.float32)


class _Leaves(torch.nn.Module):
    def __init__(self, **shapes):
        super().__init__()
        for k, s in shapes.items():
            self.register_parameter(k, torch.nn.Parameter(torch.zeros(s)))


# ---------------------------------------------------------------- worker

def _worker(rank, world, tmpdir):
    from torch.distributed.tensor import DTensor
    from torchaudio_contrib_tpu_torch.models import Wav2Vec2
    from torchaudio_contrib_tpu_torch.parallel import (
        fsdp_init, fsdp_shard, fsdp_specs, fsdp_state_specs, make_mesh,
        shard_params, tensor_parallel_specs)
    from torchaudio_contrib_tpu_torch.utils import (load_checkpoint,
                                                    save_checkpoint)

    flat = make_mesh(4, 1, device="cpu")
    square = make_mesh(2, 2, device="cpu")
    res = {}

    def load(name="w2v.pt"):
        m = Wav2Vec2(**TINY, device="cpu")
        m.load_state_dict(torch.load(os.path.join(tmpdir, name)))
        return m

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def specs():
        m = load()
        return fsdp_specs(m, flat, min_size=0), fsdp_specs(m, flat)

    def train_step():
        ref = load()
        wav = torch.tensor(_wav(0, 8))
        ref_loss = (ref(wav)[0] ** 2).mean()
        ref_loss.backward()
        model = fsdp_shard(load(), flat, min_size=0)
        q = dict(model.named_parameters())[
            "encoder.layers.0.attention.q_proj.weight"]
        local_shape = tuple(q.to_local().shape)
        loss = (model(wav.chunk(4)[rank])[0] ** 2).mean()
        loss.backward()
        total = loss.detach().clone()
        torch.distributed.all_reduce(total)
        grads = {n: full(p.grad) for n, p in model.named_parameters()}
        placements = {n: str(p.grad.placements)
                      for n, p in model.named_parameters()}
        return (float(total) / 4, float(ref_loss), grads,
                {n: p.grad for n, p in ref.named_parameters()}, local_shape,
                placements)

    def fsdp_tp():
        ref = load()
        wav = torch.tensor(_wav(3, 4))
        with torch.no_grad():
            want, _ = ref(wav)
        model = load()
        tp = tensor_parallel_specs(model, square)
        both = fsdp_specs(model, square, base_specs=tp, min_size=0)
        shard_params(model, square)
        fsdp_shard(model, square, base_specs=tp, min_size=0)
        d = square.get_local_rank("data")
        with torch.no_grad():
            out, _ = model(wav.chunk(2)[d])
        opt = fsdp_init(lambda ps: torch.optim.Adam(ps, 1e-3), model)
        (model(wav.chunk(2)[d])[0] ** 2).mean().backward()
        opt.step()
        state = fsdp_state_specs(opt, model)
        return both, out, want.chunk(2)[d], state

    def optimizer_layout():
        model = fsdp_shard(load(), flat, min_size=0)
        opt = fsdp_init(lambda ps: torch.optim.Adam(ps, 1e-3), model)
        (model(torch.tensor(_wav(4, 4)).chunk(4)[rank])[0] ** 2) \
            .mean().backward()
        opt.step()
        q = dict(model.named_parameters())[
            "encoder.layers.0.attention.q_proj.weight"]
        mu = opt.state[q]["exp_avg"]
        return (str(mu.placements), tuple(mu.to_local().shape),
                fsdp_state_specs(opt, model))

    def rules():
        toy = _Leaves(odd=(7, 9), big=(8, 24), w=(8, 16), a=(8, 8),
                      b=(8, 8))
        plain = fsdp_specs(toy, flat, min_size=0)

        def force(name, p):
            return ("data", None) if name == "big" else None

        forced = fsdp_specs(toy, flat, min_size=0, override=force)
        mismatch = []
        for base in ({"a": ("model",)}, {"a": (), "x": ()}):
            try:
                fsdp_specs(toy, flat, base_specs=base)
            except ValueError as e:
                mismatch.append(str(e))
        base = {n: () for n, _ in toy.named_parameters()}
        base["w"] = ("data",)
        left = fsdp_specs(toy, flat, base_specs=base, min_size=0)
        once = fsdp_specs(toy, flat, min_size=0)
        twice = fsdp_specs(toy, flat, base_specs=once, min_size=0)
        return plain, forced, mismatch, left, once, twice

    def base_placements():
        """A placement in ``base_specs`` shards the mesh's other axis; a
        1-D mesh has none, and says so."""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard
        toy = _Leaves(w=(8, 16), a=(8, 8))
        placed = fsdp_specs(toy, flat, base_specs={"w": Shard(1),
                                                   "a": Replicate()},
                            min_size=0)
        line = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        try:
            fsdp_specs(toy, line, base_specs={"w": Shard(1), "a": ()})
        except ValueError as e:
            return placed, str(e)
        return placed, None

    def checkpoints():
        # the parent's one-process checkpoint onto the 2-way FSDP layout
        model = fsdp_shard(load(), square, min_size=0)
        load_checkpoint(os.path.join(tmpdir, "ck_parent"), model)
        loaded = {n: full(p).detach().clone()
                  for n, p in model.named_parameters()}
        # one SGD step, then this layout's checkpoint for the parent
        model = fsdp_shard(load(), square, min_size=0)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        d = square.get_local_rank("data")
        (model(torch.tensor(_wav(5, 4)).chunk(2)[d])[0] ** 2) \
            .mean().backward()
        opt.step()
        save_checkpoint(os.path.join(tmpdir, "ck_world"), model)
        saved = {n: full(p).detach().clone()
                 for n, p in model.named_parameters()}
        return loaded, saved

    check(res, "specs", specs)
    check(res, "train_step", train_step)
    check(res, "fsdp_tp", fsdp_tp)
    check(res, "optimizer_layout", optimizer_layout)
    check(res, "rules", rules)
    check(res, "base_placements", base_placements)
    check(res, "checkpoints", checkpoints)
    return res


# ---------------------------------------------------------------- parent

def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_model():
    import jax
    import torchaudio_contrib_tpu as tac
    model = tac.Wav2Vec2(**TINY)
    return model, model.init(jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def world(jax_model, tmp_path_factory):
    from torchaudio_contrib_tpu_torch.models import Wav2Vec2
    from torchaudio_contrib_tpu_torch.utils import (save_checkpoint,
                                                    wav2vec2_from_jax_params)
    tmp = tmp_path_factory.mktemp("fsdp_world")
    sd = wav2vec2_from_jax_params(_np(jax_model[1]))
    torch.save(sd, tmp / "w2v.pt")
    parent = Wav2Vec2(**TINY, device="cpu")
    parent.load_state_dict({k: v + 0.5 for k, v in sd.items()})
    save_checkpoint(str(tmp / "ck_parent"), parent)
    return run_world("test_torch_fsdp:_worker", WORLD, tmp), tmp, parent


def _close(a, b, atol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


def _jax_fsdp_specs(jax_model, n_data, n_model=1, **kw):
    import jax
    from jax.sharding import Mesh
    from torchaudio_contrib_tpu.parallel import fsdp_specs
    mesh = Mesh(np.asarray(jax.devices()[:n_data * n_model])
                .reshape(n_data, n_model), ("data", "model"))
    return fsdp_specs(jax_model[1], mesh, **kw)


def _jax_spec_of(spec, ndim, dims):
    """A JAX spec's axis names on the torch dims ``dims[j]``."""
    out = [None] * ndim
    for j, name in enumerate(tuple(spec)):
        if name is not None:
            out[dims[j]] = name
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _leaf_dims(jax_model):
    """torch parameter name → (JAX leaf path, torch dim of each JAX dim)."""
    import jax
    from torchaudio_contrib_tpu_torch.utils import wav2vec2_from_jax_params
    flat, treedef = jax.tree_util.tree_flatten_with_path(jax_model[1])
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(l), i + 1, np.float32)
                  for i, (_, l) in enumerate(flat)])
    out = {}
    for tname, t in wav2vec2_from_jax_params(marked).items():
        i = int(t.reshape(-1)[0]) - 1
        nd = len(np.shape(flat[i][1]))
        dims = list(range(nd - 1, -1, -1)) if nd >= 2 else [0]
        out[tname] = (jax.tree_util.keystr(flat[i][0]), dims)
    return out


def _expected(jax_model, jspecs):
    import jax
    flat = jax.tree_util.tree_flatten_with_path(jax_model[1])[0]
    sflat = jax.tree_util.tree_leaves(jspecs,
                                      is_leaf=lambda s: hasattr(s, "spec"))
    by_path = {jax.tree_util.keystr(p): s.spec for (p, _), s in
               zip(flat, sflat)}
    return {t: _jax_spec_of(by_path[path], len(dims), dims)
            for t, (path, dims) in _leaf_dims(jax_model).items()}


def test_specs_shard_largest_divisible_dim(world, jax_model):
    res = world[0][0]
    got, _ = value(res, "specs")
    s0 = "encoder.layers.0."
    # q_proj (16, 16): a tie goes to the output dim, JAX's last of wqkv
    assert got[s0 + "attention.q_proj.weight"] == ("data",)
    assert got[s0 + "attention.out_proj.weight"] == ("data",)
    assert got[s0 + "attention.q_proj.bias"] == ("data",)
    assert got[s0 + "layer_norm.weight"] == ("data",)
    want = _expected(jax_model, _jax_fsdp_specs(jax_model, 4, min_size=0))
    for name in want:
        assert got[name] == want[name], (name, got[name], want[name])


def test_min_size_replicates_small_leaves(world, jax_model):
    from torchaudio_contrib_tpu_torch.parallel.fsdp import fsdp_min_size
    _, got = value(world[0][0], "specs")
    assert fsdp_min_size == 1024
    assert sum(spec == () for spec in got.values()) > 0
    want = _expected(jax_model, _jax_fsdp_specs(jax_model, 4))
    for name in want:
        assert got[name] == want[name], (name, got[name], want[name])


def test_fsdp_train_step_equals_replicated(world, jax_model):
    import jax
    import jax.numpy as jnp
    from torchaudio_contrib_tpu_torch.utils import wav2vec2_from_jax_params
    for r in world[0]:
        loss, ref_loss, grads, ref_grads, local, places = \
            value(r, "train_step")
        assert abs(loss - ref_loss) <= 1e-6
        for n in ref_grads:
            _close(grads[n], ref_grads[n], 3e-5)
        # the weights are really sharded: a quarter of q_proj a rank
        assert local == (4, 16)
        assert places["encoder.layers.0.attention.q_proj.weight"] == \
            "(Shard(dim=0),)"
    model, params = jax_model

    def loss_fn(p, x):
        out, _ = model.apply(p, x)
        return jnp.mean(out * out)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params,
                                                  jnp.asarray(_wav(0, 8)))
    assert abs(loss - float(jl)) <= 1e-4
    want = wav2vec2_from_jax_params(_np(jg))
    for n, g in want.items():
        _close(grads[n], g, 1e-4)


def test_fsdp_composes_with_tp(world, jax_model):
    import jax
    import jax.numpy as jnp
    both, _, _, _ = value(world[0][0], "fsdp_tp")
    s0 = "encoder.layers.0."
    # TP puts 'model' on q_proj's output dim 0; FSDP 'data' on dim 1
    assert both[s0 + "attention.q_proj.weight"] == ("model", "data")
    assert both[s0 + "attention.out_proj.weight"] == ("data", "model")
    from torchaudio_contrib_tpu.parallel import tensor_parallel_specs
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    tp = tensor_parallel_specs(jax_model[1], mesh)
    want = _expected(jax_model, _jax_fsdp_specs(jax_model, 2, 2,
                                                base_specs=tp, min_size=0))
    for name in (s0 + "attention.out_proj.weight",
                 s0 + "feed_forward.intermediate_dense.weight",
                 s0 + "feed_forward.output_dense.weight"):
        assert both[name] == want[name], (name, both[name], want[name])
    for r in world[0]:
        _, out, ref, _ = value(r, "fsdp_tp")
        _close(out, ref, 2e-5)
    model, params = jax_model
    jout, _ = jax.jit(model.apply)(params, jnp.asarray(_wav(3, 4)))
    got = torch.cat([value(r, "fsdp_tp")[1] for r in world[0][::2]])
    _close(got, np.asarray(jout), 1e-4)


def test_indivisible_leaves_replicate_and_override_forces(world):
    plain, forced, _, _, _, _ = value(world[0][0], "rules")
    assert plain["odd"] == ()                 # nothing divides 4
    assert plain["big"] == (None, "data")     # 24 is the largest
    assert forced["big"] == ("data",)


def test_base_specs_treedef_mismatch_raises(world):
    _, _, mismatch, _, _, _ = value(world[0][0], "rules")
    assert len(mismatch) == 2 and all("base_specs" in m for m in mismatch)


def test_base_already_using_axis_is_left_alone(world):
    _, _, _, left, once, twice = value(world[0][0], "rules")
    assert left["w"] == ("data",)
    assert once == twice


def test_base_placement_shards_the_other_axis(world):
    placed, err = value(world[0][0], "base_placements")
    assert placed == {"w": ("data", "model"), "a": ("data",)}
    assert err is not None and "2-D mesh" in err


def test_state_specs_inherit_tp_axes(world):
    both, _, _, state = value(world[0][0], "fsdp_tp")
    name = "encoder.layers.0.attention.q_proj.weight"
    assert state[name]["exp_avg"] == both[name] == ("model", "data")
    assert state[name]["exp_avg_sq"] == both[name]
    assert state[name]["step"] == ()


def test_optimizer_state_gets_zero_layout(world):
    for r in world[0]:
        placements, local, state = value(r, "optimizer_layout")
        assert placements == "(Shard(dim=0),)"
        assert local == (4, 16)
        assert state["encoder.layers.0.attention.q_proj.weight"]["step"] \
            == ()


def test_checkpoint_from_one_process_loads_on_fsdp(world):
    _, tmp, parent = world
    want = dict(parent.named_parameters())
    for r in world[0]:
        loaded, _ = value(r, "checkpoints")
        for n, t in loaded.items():
            assert torch.equal(t, want[n].detach()), n


def test_checkpoint_from_fsdp_loads_on_one_process(world):
    from torchaudio_contrib_tpu_torch.models import Wav2Vec2
    from torchaudio_contrib_tpu_torch.utils import load_checkpoint
    res, tmp, _ = world
    _, saved = value(res[0], "checkpoints")
    model = Wav2Vec2(**TINY, device="cpu")
    load_checkpoint(str(tmp / "ck_world"), model)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), saved[n]), n
    # a dict of tensors as the target layout
    like = {n: torch.zeros_like(t) for n, t in model.state_dict().items()}
    out = load_checkpoint(str(tmp / "ck_world"), like)
    assert torch.equal(out["encoder.layers.0.attention.q_proj.weight"],
                       saved["encoder.layers.0.attention.q_proj.weight"])


def test_workers_import_no_jax(world):
    for r in world[0]:
        assert r["_jax_modules"] == []
