"""The port's tensor parallelism (``parallel/tp.py``) on a 4-rank gloo world
of CPU processes: the placement rules against the JAX package's
``tensor_parallel_specs`` on the same models (each JAX leaf mapped to its
torch parameters with the dims transposed), the divisibility fallback and
``override``, Megatron's pairs (wav2vec2's attention holds its rank's
heads, WavLM's, whose gates and bucket table read every head, does not),
and sharded = replicated for wav2vec2, WavLM, an RNN-T train step on a
(data 2, model 2) mesh and HiFi-GAN; the JAX package's ``test_tp.py``
cases, and the same models against the JAX package at 1e-4.

One world runs every check; each case reads its own.  Bars: 2e-5 forward
and 3e-5 gradients against the port's replicated model (the JAX tests'),
1e-4 against the JAX package's unsharded ``model.apply``.  Weights cross
through ``utils.convert``.
"""
import os
import re

import numpy as np
import pytest
import torch

from _torch_world import check, run_world, value

torch.set_num_threads(2)

WORLD = 4
TINY = dict(extractor_conv_layers=((8, 10, 5), (8, 3, 2)), d_model=16,
            num_layers=2, num_heads=2, ff_dim=32, pos_conv_kernel=8,
            pos_conv_groups=2)
WAVLM = dict(TINY, num_buckets=16, max_distance=30)
ODD = dict(extractor_conv_layers=((8, 10, 5),), d_model=18, num_layers=1,
           num_heads=2, ff_dim=36, pos_conv_kernel=8, pos_conv_groups=2)
CONF = dict(input_dim=8, d_model=16, num_layers=1, num_heads=2,
            conv_kernel=3)
RNNT = dict(num_symbols=6, encoding_dim=16, joiner_dim=16,
            predictor_embed_dim=8, predictor_hidden_dim=16)
HIFI = dict(in_channels=8, upsample_rates=(4, 2),
            upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),))


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _targets():
    return np.random.default_rng(2).integers(1, 6, (4, 2)).astype(np.int64)


def _specs_str(specs):
    from torch.distributed.tensor import Shard
    return {n: f"Shard(dim={p.dim})" if isinstance(p, Shard)
            else "Replicate()" for n, p in specs.items()}


# ---------------------------------------------------------------- worker

def _worker(rank, world, tmpdir):
    import torch.distributed as dist
    from torchaudio_contrib_tpu_torch.models import (
        Conformer, HiFiGANVocoder, RNNT as TRNNT, Wav2Vec2, WavLM)
    from torchaudio_contrib_tpu_torch.ops import rnnt_loss
    from torchaudio_contrib_tpu_torch.parallel import (
        make_mesh, shard_params, tensor_parallel_specs)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = make_mesh(2, 2, device="cpu")                 # (data, model)
    wide = make_mesh(1, 4, device="cpu")
    d_rank = mesh.get_local_rank("data")
    res = {}

    def load(cls, kw, name, *args):
        m = cls(*args, **kw, device="cpu")
        m.load_state_dict(torch.load(os.path.join(tmpdir, name)))
        return m.eval()

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def w2v(cls, kw, name):
        model = load(cls, kw, name)
        specs = _specs_str(tensor_parallel_specs(model, mesh))
        wav = torch.tensor(_rand(0, (4, 400)))
        with torch.no_grad():
            ref, _ = model(wav)
        shard_params(model, mesh)
        mine = wav.chunk(2)[d_rank]
        with torch.no_grad():
            out, _ = model(mine)
        return specs, out, ref.chunk(2)[d_rank]

    def odd_and_override():
        odd = Wav2Vec2(**ODD, device="cpu")
        specs = _specs_str(tensor_parallel_specs(odd, wide))
        model = load(Wav2Vec2, TINY, "w2v.pt")

        def override(name, p):
            return Replicate() if re.search(r"[qkv]_proj\.weight$", name) \
                else None

        forced = _specs_str(tensor_parallel_specs(model, mesh,
                                                  override=override))
        return specs, forced

    def rnnt_step():
        from torchaudio_contrib_tpu_torch.models.conformer import Conformer
        enc = Conformer(**CONF, device="cpu")
        model = TRNNT(enc, **RNNT, device="cpu")
        model.load_state_dict(torch.load(os.path.join(tmpdir, "rnnt.pt")))
        ref = TRNNT(Conformer(**CONF, device="cpu"), **RNNT, device="cpu")
        ref.load_state_dict(torch.load(os.path.join(tmpdir, "rnnt.pt")))
        x = torch.tensor(_rand(1, (4, 6, 8)))
        tgt = torch.tensor(_targets())

        def loss_fn(m, xx, tt):
            logits, lens = m.joint_logits(xx, tt)
            return rnnt_loss(logits, tt, lens, blank=0, reduction="sum")

        ref_loss = loss_fn(ref, x, tgt)
        ref_loss.backward()
        specs = _specs_str(tensor_parallel_specs(model, mesh))
        shard_params(model, mesh)
        loss = loss_fn(model, x.chunk(2)[d_rank], tgt.chunk(2)[d_rank])
        loss.backward()
        # the batch's data-parallel half: sum the loss and the gradients
        # over the data axis, as a data-parallel step does
        total = loss.detach().clone()
        dist.all_reduce(total, group=mesh.get_group("data"))
        grads = {}
        for n, p in model.named_parameters():
            g = full(p.grad).clone()
            dist.all_reduce(g, group=mesh.get_group("data"))
            grads[n] = g
        return (specs, float(total), float(ref_loss), grads,
                {n: p.grad for n, p in ref.named_parameters()})

    def depthwise_dp_grad():
        enc = load(Conformer, CONF, "conf.pt")
        x = torch.tensor(_rand(1, (4, 6, 8)))
        (enc(x.chunk(2)[d_rank]) ** 2).sum().backward()
        g = enc.conformer_layers[0].conv_module.sequential[2].weight.grad
        g = g.clone()
        dist.all_reduce(g, group=mesh.get_group("data"))
        enc.zero_grad()
        (enc(x) ** 2).sum().backward()
        return g, enc.conformer_layers[0].conv_module.sequential[2] \
            .weight.grad

    def hifigan():
        net = load(HiFiGANVocoder, HIFI, "hifi.pt")
        mel = torch.tensor(_rand(4, (4, 8, 12)))
        with torch.no_grad():
            ref = net(mel)
        specs = _specs_str(tensor_parallel_specs(net, mesh))
        shard_params(net, mesh)
        with torch.no_grad():
            out = net(mel.chunk(2)[d_rank])
        return specs, out, ref.chunk(2)[d_rank]

    def w2v_train_step():
        """Sharded = replicated gradients through the paired heads."""
        model = load(Wav2Vec2, TINY, "w2v.pt")
        ref = load(Wav2Vec2, TINY, "w2v.pt")
        wav = torch.tensor(_rand(0, (4, 400)))
        (ref(wav)[0] ** 2).mean().backward()
        shard_params(model, wide)
        (model(wav)[0] ** 2).mean().backward()
        return ({n: full(p.grad) for n, p in model.named_parameters()},
                {n: p.grad for n, p in ref.named_parameters()})

    def widths():
        """The width each pair's first GEMM hands on: a paired one keeps
        its rank's share (d_model 16, ff_dim 32 over 2 ranks)."""
        out = {}
        for cls, kw, name in ((Wav2Vec2, TINY, "w2v.pt"),
                              (WavLM, WAVLM, "wavlm.pt")):
            for tag, m in (("square", mesh), ("wide", wide)):
                model = shard_params(load(cls, kw, name), m)
                layer = model.encoder.layers[0]
                x = torch.zeros(1, 3, 16)
                with torch.no_grad():
                    out[cls.__name__, tag] = (
                        layer.attention.q_proj(x).shape[-1],
                        layer.feed_forward.intermediate_dense(x).shape[-1])
        return out

    check(res, "widths", widths)
    check(res, "w2v", w2v, Wav2Vec2, TINY, "w2v.pt")
    check(res, "wavlm", w2v, WavLM, WAVLM, "wavlm.pt")
    check(res, "odd_and_override", odd_and_override)
    check(res, "rnnt_step", rnnt_step)
    check(res, "depthwise_dp_grad", depthwise_dp_grad)
    check(res, "hifigan", hifigan)
    check(res, "w2v_train_step", w2v_train_step)
    return res


# ---------------------------------------------------------------- parent

def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_models():
    import jax
    import torchaudio_contrib_tpu as tac
    out = {}
    for name, cls, kw, seed in (("w2v", tac.Wav2Vec2, TINY, 1),
                                ("wavlm", tac.WavLM, WAVLM, 1)):
        m = cls(**kw)
        out[name] = (m, m.init(jax.random.PRNGKey(seed)))
    enc = tac.Conformer(**CONF)
    rnnt = tac.RNNT(enc, **RNNT)
    out["rnnt"] = (rnnt, rnnt.init(jax.random.PRNGKey(2)))
    out["conf"] = (enc, enc.init(jax.random.PRNGKey(0)))
    net = tac.HiFiGANVocoder(**HIFI)
    out["hifi"] = (net, net.init(jax.random.PRNGKey(3)))
    return out


def _state_dict(name, params):
    from torchaudio_contrib_tpu_torch.utils import convert
    p = _np(params)
    if name in ("w2v", "wavlm"):
        return convert.wav2vec2_from_jax_params(p)
    if name == "conf":
        return convert.conformer_from_jax_params(p)
    if name == "hifi":
        return convert.hifigan_from_jax_params(p)
    return convert._rnnt_sd(p, convert.conformer_from_jax_params(
        p["transcriber"]), True)


@pytest.fixture(scope="module")
def world(jax_models, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_world")
    for name, (_, params) in jax_models.items():
        torch.save(_state_dict(name, params), tmp / f"{name}.pt")
    return run_world("test_torch_tp:_worker", WORLD, tmp)


def _close(a, b, atol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


def _leaf_map(name, params):
    """torch parameter name → (JAX leaf path, torch dim of each JAX dim),
    found by pushing leaf-index markers through ``utils.convert``."""
    import jax
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(l), i + 1, np.float32)
                  for i, (_, l) in enumerate(flat)])
    sd = _state_dict(name, marked)
    out = {}
    for tname, t in sd.items():
        i = int(t.reshape(-1)[0]) - 1
        if i < 0:
            continue
        jshape = np.shape(flat[i][1])
        nd = len(jshape)
        same = tuple(t.shape) == tuple(jshape) and \
            len(set(jshape)) == nd and nd >= 2
        dims = list(range(nd)) if same or nd < 2 \
            else list(range(nd - 1, -1, -1))
        out[tname] = (jax.tree_util.keystr(flat[i][0]), dims)
    return out


def _jax_specs(name, jax_models, n_data, n_model):
    import jax
    from jax.sharding import Mesh
    from torchaudio_contrib_tpu.parallel import tensor_parallel_specs
    _, params = jax_models[name]
    mesh = Mesh(np.asarray(jax.devices()[:n_data * n_model])
                .reshape(n_data, n_model), ("data", "model"))
    specs = tensor_parallel_specs(params, mesh)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    sflat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: hasattr(s, "spec"))
    return {jax.tree_util.keystr(p): s.spec for (p, _), s in
            zip(flat, sflat)}


def _expected(name, jax_models, n_model=2):
    """The torch placement each JAX spec maps to."""
    jspecs = _jax_specs(name, jax_models, 4, n_model)
    out = {}
    for tname, (path, dims) in _leaf_map(name, jax_models[name][1]).items():
        spec = tuple(jspecs[path])
        place = "Replicate()"
        for j, axis in enumerate(spec):
            if axis == "model":
                place = f"Shard(dim={dims[j]})"
        out[tname] = place
    return out


@pytest.mark.parametrize("name", ["w2v", "wavlm", "rnnt", "hifi"])
def test_specs_follow_the_jax_rules(world, jax_models, name):
    check_name = {"w2v": "w2v", "wavlm": "wavlm", "rnnt": "rnnt_step",
                  "hifi": "hifigan"}[name]
    got = value(world[0], check_name)[0]
    want = _expected(name, jax_models)
    for tname, place in want.items():
        assert got[tname] == place, (tname, got[tname], place)
    sharded = [n for n, p in got.items() if p != "Replicate()"]
    assert sharded, got


def test_specs_follow_rules(world):
    specs = value(world[0], "w2v")[0]
    l0 = "encoder.layers.0."
    assert specs[l0 + "attention.q_proj.weight"] == "Shard(dim=0)"
    assert specs[l0 + "feed_forward.intermediate_dense.weight"] == \
        "Shard(dim=0)"
    assert specs[l0 + "attention.out_proj.weight"] == "Shard(dim=1)"
    assert specs[l0 + "feed_forward.output_dense.weight"] == "Shard(dim=1)"
    assert specs[l0 + "attention.q_proj.bias"] == "Replicate()"
    assert specs["feature_projection.layer_norm.weight"] == "Replicate()"


def test_indivisible_dims_replicate(world):
    specs, _ = value(world[0], "odd_and_override")
    l0 = "encoder.layers.0."
    # ff_dim 36 divides 4, d_model 18 does not: out_proj replicates
    assert specs[l0 + "feed_forward.intermediate_dense.weight"] == \
        "Shard(dim=0)"
    assert specs[l0 + "attention.out_proj.weight"] == "Replicate()"


def test_override_wins(world):
    _, forced = value(world[0], "odd_and_override")
    l0 = "encoder.layers.0."
    assert forced[l0 + "attention.q_proj.weight"] == "Replicate()"
    assert forced[l0 + "feed_forward.intermediate_dense.weight"] == \
        "Shard(dim=0)"


def _jax_w2v_out(jax_models, name):
    import jax
    import jax.numpy as jnp
    model, params = jax_models[name]
    out, _ = jax.jit(model.apply)(params, jnp.asarray(_rand(0, (4, 400))))
    return np.asarray(out)


def test_wav2vec2_sharded_equals_replicated(world, jax_models):
    for r in world:
        _, out, ref = value(r, "w2v")
        _close(out, ref, 2e-5)
    got = torch.cat([value(r, "w2v")[1] for r in world[::2]])
    _close(got, _jax_w2v_out(jax_models, "w2v"), 1e-4)


def test_megatron_pairs_keep_inner_width_sharded(world):
    got = value(world[0], "widths")
    assert got["Wav2Vec2", "square"] == (8, 16)    # heads and FFN local
    assert got["WavLM", "square"] == (16, 16)      # its gates read all heads
    # 2 heads over 4 ranks: the attention gathers; the FFN still pairs
    assert got["Wav2Vec2", "wide"] == (16, 8)


def test_wav2vec2_sharded_gradients(world):
    for r in world:
        got, want = value(r, "w2v_train_step")
        for n in want:
            _close(got[n], want[n], 3e-5)


def test_wavlm_sharded_equals_replicated(world, jax_models):
    specs = value(world[0], "wavlm")[0]
    assert specs["encoder.layers.0.attention.rel_attn_embed.weight"] == \
        "Replicate()"
    assert specs["encoder.layers.0.attention.gru_rel_pos_linear.weight"] \
        == "Replicate()"
    assert specs["encoder.layers.0.attention.gru_rel_pos_const"] == \
        "Replicate()"
    for r in world:
        _, out, ref = value(r, "wavlm")
        _close(out, ref, 2e-5)
    got = torch.cat([value(r, "wavlm")[1] for r in world[::2]])
    _close(got, _jax_w2v_out(jax_models, "wavlm"), 1e-4)


def test_rnnt_sharded_train_step(world, jax_models):
    """DP batch + TP params: loss and gradients match the replicated run
    and the JAX package's."""
    import jax
    import jax.numpy as jnp
    import torchaudio_contrib_tpu as tac
    for r in world:
        _, loss, ref_loss, grads, ref_grads = value(r, "rnnt_step")
        assert abs(loss - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
        for n in ref_grads:
            _close(grads[n], ref_grads[n], 3e-5)
    model, params = jax_models["rnnt"]
    tgt = jnp.asarray(_targets().astype(np.int32))

    def loss_fn(p):
        logits, L = model.joint_logits(p, jnp.asarray(_rand(1, (4, 6, 8))),
                                       tgt)
        return tac.rnnt_loss(logits, tgt, L, blank=0, reduction="sum")

    jl = float(jax.jit(loss_fn)(params))
    assert abs(loss - jl) <= 1e-4 * max(1.0, abs(jl))


def test_depthwise_conv_grad_under_batch_sharding(world):
    for r in world:
        got, want = value(r, "depthwise_dp_grad")
        _close(got, want, 3e-5)


def test_hifigan_sharded_equals_replicated(world, jax_models):
    import jax
    import jax.numpy as jnp
    for r in world:
        _, out, ref = value(r, "hifigan")
        _close(out, ref, 2e-5)
    net, params = jax_models["hifi"]
    want = np.asarray(jax.jit(net.apply)(
        params, jnp.asarray(_rand(4, (4, 8, 12)))))
    got = torch.cat([value(r, "hifigan")[1] for r in world[::2]])
    _close(got.reshape(want.shape), want, 1e-4)


def test_contract_rule_picks_channel_dims_not_spatial(world):
    """Conv kernels shard their input-CHANNEL dim (torch dim 1), never a
    tap dim; the recurrent ``weight_hh`` replicates."""
    w2v = value(world[0], "w2v")[0]
    assert w2v["feature_extractor.conv_layers.1.conv.weight"] == \
        "Shard(dim=1)"
    hifi = value(world[0], "hifigan")[0]
    assert hifi["resblocks.0.convs2.0.weight"] == "Shard(dim=1)"
    rnnt = value(world[0], "rnnt_step")[0]
    assert rnnt["predictor.lstm.weight_hh_l0"] == "Replicate()"
    assert rnnt["predictor.lstm.weight_ih_l0"] == "Shard(dim=0)"


def test_workers_import_no_jax(world):
    for r in world:
        assert r["_jax_modules"] == []
