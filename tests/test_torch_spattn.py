"""The port's sequence parallelism (``parallel/spattn.py``) on a 4-rank
gloo world of CPU processes: ring attention equals full masked attention
(values, biases from global indices, gradients, fully masked rows, and
float32 accumulation of bfloat16 inputs), the time-sharded Conformer and
wav2vec2/WavLM forwards equal the unsharded models (gradients included),
the Conformer composes with the time-sharded mel; the JAX package's
``test_spattn.py`` cases, with the same models against the JAX package.

One world runs every check; each case reads its own.  Bars against the
port's unsharded result are the JAX tests' (ring 1e-5, models 2e-5,
gradients 3e-5); against the JAX package 1e-4, through its unsharded
``model.apply`` under ``jax.jit`` and, for the ring, through its own
``ring_attention`` under ``shard_map`` on 4 of the conftest's 8 CPU
devices.  Weights cross through ``utils.convert``.
"""
import os

import numpy as np
import pytest
import torch

from _torch_world import check, run_world, value

torch.set_num_threads(2)

WORLD = 4
CONF = dict(input_dim=16, d_model=32, num_layers=2, num_heads=2,
            conv_kernel=7, max_distance=6)
CONF_FIRST = dict(input_dim=8, d_model=16, num_layers=1, num_heads=2,
                  conv_kernel=7, convolution_first=True)
CONF_MEL = dict(input_dim=16, d_model=32, num_layers=1, num_heads=2,
                conv_kernel=7)
W2V = dict(extractor_conv_layers=((24, 10, 5), (24, 4, 2), (24, 4, 2)),
           d_model=32, num_layers=2, num_heads=2, ff_dim=64,
           pos_conv_kernel=16, pos_conv_groups=4)
W2V_BUILDS = {"group_norm": dict(extractor_mode="group_norm",
                                 layer_norm_first=False),
              "layer_norm": dict(extractor_mode="layer_norm",
                                 layer_norm_first=True)}
WAVLM = dict(extractor_mode="layer_norm", layer_norm_first=True,
             num_buckets=8, max_distance=20)
T_W2V = WORLD * 20 * 4          # 4 frames a rank: multi-hop halos
T_W2V_GRAD = WORLD * 20 * 2


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _full_attention(q, k, v, lengths=None, bias=None):
    """Masked MHA on unsharded ``(B, T, H, dh)`` (the port's reference)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias[None]
    if lengths is not None:
        valid = torch.arange(q.shape[1])[None] < lengths[:, None]
        s = s.masked_fill(~valid[:, None, None, :], -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _rel_table():
    return _rand(11, (2 * 5 + 1, 2))


def _rel_bias_fn(table):
    def bias_fn(qi, ki):
        dist = (ki[None, :] - qi[:, None]).clamp(-5, 5)
        return table[dist + 5].permute(2, 0, 1)
    return bias_fn


# ---------------------------------------------------------------- worker

def _worker(rank, world, tmpdir):
    from torch.distributed.device_mesh import DeviceMesh
    from torchaudio_contrib_tpu_torch.models import (Conformer, Wav2Vec2,
                                                     WavLM)
    from torchaudio_contrib_tpu_torch.parallel import (
        ring_attention, sp_conformer_apply, sp_wav2vec2_apply,
        time_sharded_melspectrogram)

    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("sp",))
    group = mesh.get_group("sp")
    res = {}

    def shard(x):
        n = x.shape[1] // world
        return x[:, rank * n:(rank + 1) * n]

    def load(cls, kw, name):
        m = cls(**kw, device="cpu")
        m.load_state_dict(torch.load(os.path.join(tmpdir, name)))
        return m.eval()

    def ring_full():
        q, k, v = (torch.tensor(_rand(s, (2, 32, 2, 8))) for s in (1, 2, 3))
        lengths = torch.tensor([29, 17])
        got = ring_attention(shard(q), shard(k), shard(v), group,
                             lengths=lengths)
        return got, shard(_full_attention(q, k, v, lengths))

    def ring_bias():
        q, k, v = (torch.tensor(_rand(s, (1, 24, 2, 4))) for s in (4, 5, 6))
        fn = _rel_bias_fn(torch.tensor(_rel_table()))
        got = ring_attention(shard(q), shard(k), shard(v), group,
                             bias_fn=fn)
        want = _full_attention(q, k, v,
                               bias=fn(torch.arange(24), torch.arange(24)))
        return got, shard(want)

    def ring_grads():
        qkv = [torch.tensor(_rand(s, (1, 16, 2, 4))) for s in (7, 8, 9)]
        lengths = torch.tensor([13])
        loc = [shard(a).clone().requires_grad_() for a in qkv]
        torch.tanh(ring_attention(*loc, group, lengths=lengths)) \
            .sum().backward()
        full = [a.clone().requires_grad_() for a in qkv]
        torch.tanh(_full_attention(*full, lengths)).sum().backward()
        return [a.grad for a in loc], [shard(a.grad) for a in full]

    def ring_masked_rows():
        q, k, v = (torch.tensor(_rand(s, (2, 16, 2, 4))) for s in (1, 2, 3))
        out = ring_attention(shard(q), shard(k), shard(v), group,
                             lengths=torch.tensor([0, 16]))
        return bool(torch.isfinite(out).all())

    def ring_bf16():
        q, k, v = (torch.tensor(_rand(s, (2, 64, 4, 16), 3.0))
                   for s in (21, 22, 23))
        got = ring_attention(shard(q).bfloat16(), shard(k).bfloat16(),
                             shard(v).bfloat16(), group)
        want = _full_attention(q.bfloat16().float(), k.bfloat16().float(),
                               v.bfloat16().float())
        return got.dtype, got.float(), shard(want)

    def conformer(kw, name, x, lengths):
        model = load(Conformer, kw, name)
        with torch.no_grad():
            got = sp_conformer_apply(model, torch.tensor(x), lengths,
                                     mesh=mesh, axis="sp")
            want = model(torch.tensor(x), lengths)
        return got.to_local(), shard(want), got.full_tensor()

    def conformer_grads():
        model = load(Conformer, CONF, "conf.pt")
        x = torch.tensor(_rand(31, (1, 32, 16)))
        lengths = torch.tensor([27])
        out = sp_conformer_apply(model, x, lengths, mesh=mesh, axis="sp")
        torch.tanh(out.to_local()).sum().backward()
        got = {n: p.grad.clone() for n, p in model.named_parameters()}
        model.zero_grad()
        torch.tanh(model(x, lengths)).sum().backward()
        return got, {n: p.grad for n, p in model.named_parameters()}

    def conformer_geometry():
        model = load(Conformer, CONF, "conf.pt")
        try:
            sp_conformer_apply(model, torch.zeros(1, 30, 16), mesh=mesh,
                               axis="sp")
        except ValueError as e:
            return str(e)
        return None

    def mel_then_conformer():
        wav = torch.tensor(_rand(41, (WORLD * 128 * 16,), 0.1))
        mel = time_sharded_melspectrogram(
            wav, mesh, axis="sp", num_mels=16, sample_rate=16000,
            fft_length=256, hop_length=128)          # (mels, frames_here)
        frames = [torch.zeros(1, dtype=torch.long) for _ in range(world)]
        torch.distributed.all_gather(frames,
                                     torch.tensor([mel.shape[-1]]))
        parts = [torch.zeros(16, int(f)) for f in frames]
        _gather_uneven(parts, mel)
        full = torch.cat(parts, -1)
        n = full.shape[-1] - full.shape[-1] % world
        feats = full[:, :n].T[None].contiguous()
        model = load(Conformer, CONF_MEL, "conf_mel.pt")
        with torch.no_grad():
            got = sp_conformer_apply(model, feats, mesh=mesh, axis="sp")
            want = model(feats)
        return got.full_tensor(), want

    def w2v(cls, kw, name, T, lengths):
        model = load(cls, kw, name)
        wav = torch.tensor(_rand(51, (2, T), 0.1))
        with torch.no_grad():
            got, got_len = sp_wav2vec2_apply(model, wav, lengths,
                                             mesh=mesh, axis="sp")
            want, want_len = model(wav, lengths)
        return got.full_tensor(), got_len, want, want_len

    def w2v_grads():
        model = load(Wav2Vec2, dict(W2V, **W2V_BUILDS["group_norm"]),
                     "w2v_group_norm.pt")
        wav = torch.tensor(_rand(52, (1, T_W2V_GRAD), 0.1))
        lengths = torch.tensor([T_W2V_GRAD - 60])
        n_valid = int(model.output_length(lengths)[0])
        out, _ = sp_wav2vec2_apply(model, wav, lengths, mesh=mesh,
                                   axis="sp")
        loc = out.to_local()
        pos = rank * loc.shape[1] + torch.arange(loc.shape[1])
        torch.tanh(torch.where((pos < n_valid)[None, :, None], loc, 0.0)) \
            .sum().backward()
        got = {n: p.grad.clone() for n, p in model.named_parameters()}
        model.zero_grad()
        full, _ = model(wav, lengths)
        torch.tanh(full[:, :n_valid]).sum().backward()
        return got, {n: p.grad for n, p in model.named_parameters()}

    def w2v_bad_length():
        model = load(Wav2Vec2, dict(W2V, **W2V_BUILDS["group_norm"]),
                     "w2v_group_norm.pt")
        try:
            sp_wav2vec2_apply(model, torch.zeros(1, 1601), mesh=mesh,
                              axis="sp")
        except ValueError as e:
            return str(e)
        return None

    check(res, "ring_full", ring_full)
    check(res, "ring_bias", ring_bias)
    check(res, "ring_grads", ring_grads)
    check(res, "ring_masked_rows", ring_masked_rows)
    check(res, "ring_bf16", ring_bf16)
    check(res, "conformer", conformer, CONF, "conf.pt",
          _rand(32, (2, 64, 16)), torch.tensor([64, 41]))
    check(res, "conformer_grads", conformer_grads)
    check(res, "conformer_first", conformer, CONF_FIRST, "conf_first.pt",
          _rand(33, (1, 32, 8)), None)
    check(res, "conformer_geometry", conformer_geometry)
    check(res, "mel_then_conformer", mel_then_conformer)
    for mode, kw in W2V_BUILDS.items():
        check(res, f"w2v_{mode}", w2v, Wav2Vec2, dict(W2V, **kw),
              f"w2v_{mode}.pt", T_W2V, torch.tensor([T_W2V, T_W2V - 135]))
    check(res, "w2v_grads", w2v_grads)
    check(res, "wavlm", w2v, WavLM, dict(W2V, **WAVLM), "wavlm.pt", T_W2V,
          torch.tensor([T_W2V, T_W2V - 200]))
    check(res, "w2v_bad_length", w2v_bad_length)
    return res


def _gather_uneven(parts, mel):
    """All-gather shards of unequal frame counts (the last is shorter)."""
    width = max(p.shape[-1] for p in parts)
    padded = [torch.zeros(16, width) for _ in parts]
    buf = torch.zeros(16, width)
    buf[:, :mel.shape[-1]] = mel
    torch.distributed.all_gather(padded, buf)
    for p, q in zip(parts, padded):
        p.copy_(q[:, :p.shape[-1]])


# ---------------------------------------------------------------- parent

def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_models():
    import jax
    from torchaudio_contrib_tpu.models import Conformer, Wav2Vec2, WavLM
    out = {}
    for name, kw, seed in (("conf", CONF, 0), ("conf_first", CONF_FIRST, 1),
                           ("conf_mel", CONF_MEL, 2)):
        m = Conformer(**kw)
        out[name] = (m, m.init(jax.random.PRNGKey(seed)))
    for mode, kw in W2V_BUILDS.items():
        m = Wav2Vec2(**W2V, **kw)
        out[f"w2v_{mode}"] = (m, m.init(jax.random.PRNGKey(3)))
    wl_kw = dict(WAVLM)
    m = WavLM(**W2V, **wl_kw)
    out["wavlm"] = (m, m.init(jax.random.PRNGKey(5)))
    return out


@pytest.fixture(scope="module")
def world(jax_models, tmp_path_factory):
    from torchaudio_contrib_tpu_torch.utils import (
        conformer_from_jax_params, wav2vec2_from_jax_params)
    tmp = tmp_path_factory.mktemp("spattn_world")
    for name, (_, params) in jax_models.items():
        conv = (conformer_from_jax_params if name.startswith("conf")
                else wav2vec2_from_jax_params)
        torch.save(conv(_np(params)), tmp / f"{name}.pt")
    return run_world("test_torch_spattn:_worker", WORLD, tmp)


def _close(a, b, atol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


def _jax_ring(q, k, v, lengths=None, bias_fn=None, dtype=None):
    """The JAX package's ring attention under shard_map on 4 CPU
    devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from torchaudio_contrib_tpu.parallel import ring_attention as jring
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("sp",))
    spec = P(None, "sp", None, None)
    args = [jnp.asarray(a, dtype or jnp.float32) for a in (q, k, v)]
    if lengths is None:
        fn = jax.shard_map(lambda a, b, c: jring(a, b, c, "sp",
                                                 bias_fn=bias_fn),
                           mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
        return fn(*args)
    fn = jax.shard_map(lambda a, b, c, ll: jring(a, b, c, "sp", lengths=ll,
                                                 bias_fn=bias_fn),
                       mesh=mesh, in_specs=(spec,) * 3 + (P(),),
                       out_specs=spec)
    return fn(*args, jnp.asarray(lengths))


def test_ring_attention_matches_full(world):
    for r in world:
        got, want = value(r, "ring_full")
        _close(got, want, 1e-5)
    q, k, v = (_rand(s, (2, 32, 2, 8)) for s in (1, 2, 3))
    jax_out = np.asarray(_jax_ring(q, k, v, np.array([29, 17])))
    got = torch.cat([value(r, "ring_full")[0] for r in world], 1)
    _close(got, jax_out, 1e-4)


def test_ring_attention_bias_from_global_indices(world):
    import jax
    import jax.numpy as jnp
    for r in world:
        got, want = value(r, "ring_bias")
        _close(got, want, 1e-5)
    table = jnp.asarray(_rel_table())

    def jbias(qi, ki):
        dist = jnp.clip(ki[None, :] - qi[:, None], -5, 5)
        return jnp.transpose(table[dist + 5], (2, 0, 1))

    # the JAX package's masked attention written out, unsharded (its ring
    # is held against it by its own tests)
    q, k, v = (jnp.asarray(_rand(s, (1, 24, 2, 4))) for s in (4, 5, 6))
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(4) \
        + jbias(jnp.arange(24), jnp.arange(24))[None]
    jax_out = np.asarray(jnp.einsum("bhqk,bkhd->bqhd",
                                    jax.nn.softmax(logits, -1), v))
    got = torch.cat([value(r, "ring_bias")[0] for r in world], 1)
    _close(got, jax_out, 1e-4)


def test_ring_attention_grads_match(world):
    for r in world:
        got, want = value(r, "ring_grads")
        for g, w in zip(got, want):
            _close(g, w, 1e-5)


def test_ring_attention_fully_masked_rows_finite(world):
    assert all(value(r, "ring_masked_rows") for r in world)


def test_ring_accumulates_bf16_inputs_in_float32(world):
    """Reference fault 4: the JAX ring's running max, normaliser and
    output take ``q.dtype``; the port's are float32.  On bfloat16 inputs
    the port lands within the bfloat16 rounding of its output (2^-8 of
    the peak) of a float32 attention on the same (rounded) inputs, and
    the JAX package's ring misses that bar."""
    import jax.numpy as jnp
    got = torch.cat([value(r, "ring_bf16")[1] for r in world], 1)
    want = torch.cat([value(r, "ring_bf16")[2] for r in world], 1)
    assert value(world[0], "ring_bf16")[0] == torch.bfloat16
    peak = float(want.abs().max())
    bar = peak * 2.0 ** -8
    port_err = float((got - want).abs().max())
    assert port_err <= bar, (port_err, bar)
    q, k, v = (_rand(s, (2, 64, 4, 16), 3.0) for s in (21, 22, 23))
    jax_out = np.asarray(_jax_ring(q, k, v, dtype=jnp.bfloat16)
                         .astype(jnp.float32))
    jax_err = float(np.abs(jax_out - want.numpy()).max())
    assert jax_err > bar, (jax_err, bar)


def _jax_apply(model, params, *args):
    import jax
    return jax.jit(model.apply)(params, *args)


def test_sp_conformer_matches_unsharded(world, jax_models):
    import jax.numpy as jnp
    for r in world:
        loc, want, _ = value(r, "conformer")
        _close(loc, want, 2e-5)
    model, params = jax_models["conf"]
    jout = _jax_apply(model, params, jnp.asarray(_rand(32, (2, 64, 16))),
                      jnp.asarray([64, 41]))
    _close(value(world[0], "conformer")[2], jout, 1e-4)


def test_sp_conformer_grads_match(world):
    for r in world:
        got, want = value(r, "conformer_grads")
        assert set(got) == set(want)
        for n in want:
            _close(got[n], want[n], 3e-5)


def test_sp_conformer_convolution_first(world, jax_models):
    import jax.numpy as jnp
    for r in world:
        loc, want, _ = value(r, "conformer_first")
        _close(loc, want, 2e-5)
    model, params = jax_models["conf_first"]
    jout = _jax_apply(model, params, jnp.asarray(_rand(33, (1, 32, 8))))
    _close(value(world[0], "conformer_first")[2], jout, 1e-4)


def test_sp_conformer_validates_geometry(world):
    msg = value(world[0], "conformer_geometry")
    assert msg is not None and "divide" in msg


def test_sp_conformer_composes_with_timeshard_mel(world):
    for r in world:
        got, want = value(r, "mel_then_conformer")
        _close(got, want, 2e-5)


@pytest.mark.parametrize("mode", list(W2V_BUILDS))
def test_sp_wav2vec2_matches_unsharded(world, jax_models, mode):
    import jax.numpy as jnp
    lengths = np.array([T_W2V, T_W2V - 135])
    for r in world:
        got, got_len, want, want_len = value(r, f"w2v_{mode}")
        assert torch.equal(got_len, want_len)
        for b in range(2):
            n = int(want_len[b])
            _close(got[b, :n], want[b, :n], 2e-5)
    model, params = jax_models[f"w2v_{mode}"]
    jout, jlen = _jax_apply(model, params,
                            jnp.asarray(_rand(51, (2, T_W2V), 0.1)),
                            jnp.asarray(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(jlen))
    for b in range(2):
        n = int(jlen[b])
        _close(got[b, :n], np.asarray(jout)[b, :n], 1e-4)


def test_sp_wav2vec2_grads_match(world):
    for r in world:
        got, want = value(r, "w2v_grads")
        for n in want:
            _close(got[n], want[n], 3e-5)


def test_sp_wavlm_matches_unsharded(world, jax_models):
    import jax.numpy as jnp
    for r in world:
        got, got_len, want, want_len = value(r, "wavlm")
        assert torch.equal(got_len, want_len)
        for b in range(2):
            n = int(want_len[b])
            _close(got[b, :n], want[b, :n], 2e-5)
    model, params = jax_models["wavlm"]
    jout, jlen = _jax_apply(model, params,
                            jnp.asarray(_rand(51, (2, T_W2V), 0.1)),
                            jnp.asarray([T_W2V, T_W2V - 200]))
    for b in range(2):
        n = int(jlen[b])
        _close(got[b, :n], np.asarray(jout)[b, :n], 1e-4)


def test_sp_wav2vec2_rejects_bad_length(world):
    msg = value(world[0], "w2v_bad_length")
    assert msg is not None and "multiple" in msg


def test_workers_import_no_jax(world):
    for r in world:
        assert r["_jax_modules"] == []
