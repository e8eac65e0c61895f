"""Parity of the port's separation, assessment and embedding bundles
(``pipelines``: ``SourceSeparationBundle``, ``SquimBundle``,
``VGGishBundle`` and their six constants) with the JAX package's, on the
CPU.

The bundles' ``get_model`` runs over toy factories (VGGish at its one
size) for every source of weights: ``generator=``, ``torch_checkpoint=``
(a ``state_dict`` and a path) and ``checkpoint=`` (the JAX params saved
by the JAX ``save_params``); the port model's ``state_dict`` through the
JAX ``import_*`` gives the JAX model the port's outputs (1e-4 abs, 1e-5
of peak).  The constants' published geometries are built on the meta
device.  The slices: a 16 kHz clip → ``VGGISH``'s processor → its model,
and a two-speaker mixture → ``CONVTASNET_BASE_LIBRI2MIX``'s (toy) model →
SI-SNR against the planted sources, in both packages from one
``save_params`` file.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torchaudio_contrib_tpu as tac
from torchaudio_contrib_tpu import models as JM
from torchaudio_contrib_tpu import pipelines as jpipe
from torchaudio_contrib_tpu.utils import checkpoint as jckpt
from torchaudio_contrib_tpu.utils import import_torch as jimport
from torchaudio_contrib_tpu_torch import models as M
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch import pipelines as tpipe

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

ABS = 1e-4
PEAK = 1e-5
TASNET = dict(num_sources=2, enc_kernel=8, enc_filters=16, bottleneck=8,
              hidden=12, tcn_kernel=3, num_blocks=2, num_repeats=2)
HDTA = dict(channels=4, nfft=256, depth=4, norm_starts=2, dconv_lstm=2,
            dconv_attn=2, lstm_max_steps=6, attn_heads=2, attn_ndecay=2)
SQUIM_TA = dict(feat_dim=8, win_len=16, d_model=8, nhead=2, hidden_dim=6,
                num_blocks=2, chunk_size=7)
SQUIM = dict(d_model=8, enc_kernel=16, enc_stride=8, hidden=6,
             num_blocks=2, chunk=5)

# bundle → (toy port factory, toy JAX model, JAX importer, input shapes)
TOYS = {
    "HDEMUCS_HIGH_MUSDB": (
        lambda **kw: M.HDemucsTA(**HDTA, **kw), lambda: JM.HDemucsTA(**HDTA),
        jimport.import_hdemucs, [(1, 2, 900)]),
    "HDEMUCS_HIGH_MUSDB_PLUS": (
        lambda **kw: M.HDemucsTA(**HDTA, **kw), lambda: JM.HDemucsTA(**HDTA),
        jimport.import_hdemucs, [(1, 2, 700)]),
    "CONVTASNET_BASE_LIBRI2MIX": (
        lambda **kw: M.ConvTasNet(**TASNET, **kw),
        lambda: JM.ConvTasNet(**TASNET), jimport.import_conv_tasnet,
        [(2, 300)]),
    "SQUIM_OBJECTIVE": (
        lambda **kw: M.SquimObjectiveTA(**SQUIM_TA, **kw),
        lambda: JM.SquimObjectiveTA(**SQUIM_TA),
        jimport.import_squim_objective, [(2, 700)]),
    "SQUIM_SUBJECTIVE": (
        lambda **kw: M.SquimSubjective(**SQUIM, **kw),
        lambda: JM.SquimSubjective(**SQUIM), None, [(2, 700), (2, 500)]),
}


def _params(jm, seed, scale=0.1):
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(scale * rng.standard_normal(s.shape)
                              .astype(np.float32)), shapes)


def _check(got, want):
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if not isinstance(want, tuple) else list(want)
    for g, w in zip(got, want, strict=True):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= ABS and err <= PEAK * float(np.abs(w).max()), err


def _same(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)


def test_constants_match_jax():
    for name in TOYS:
        t, j = getattr(tpipe, name), getattr(jpipe, name)
        assert t.sample_rate == j.sample_rate, name
        if hasattr(j, "sources"):
            assert t.sources == j.sources, name
    assert tpipe.VGGISH.sample_rate == jpipe.VGGISH.sample_rate == 16000


@pytest.mark.parametrize("name", list(TOYS))
def test_bundle_weight_sources(name, tmp_path):
    """generator, state_dict, path, ``save_params`` file; no source
    raises; the port's ``state_dict`` through the JAX importer gives the
    JAX model the port's outputs."""
    factory, jfactory, importer, shapes = TOYS[name]
    b = dataclasses.replace(getattr(tpipe, name), _factory=factory)
    own = b.get_model(torch.Generator().manual_seed(0), device="cpu")
    assert next(own.parameters()).device.type == "cpu"
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jm = jfactory()
    apply = jax.jit(jm.apply)
    if importer is None:
        with pytest.raises(NotImplementedError):
            b.get_model(torch_checkpoint=own.state_dict(), device="cpu")
    else:
        path = tmp_path / "model.pt"
        torch.save(own.state_dict(), path)
        for src in (own.state_dict(), str(path)):
            assert _same(b.get_model(torch_checkpoint=src, device="cpu"),
                         own)
        with torch.no_grad():
            got = own(*map(torch.from_numpy, xs))
        _check(got, apply(importer(own.state_dict(), jm),
                          *map(jnp.asarray, xs)))
    params = _params(jm, 2)
    jckpt.save_params(str(tmp_path / "model.npz"), params)
    m = b.get_model(checkpoint=str(tmp_path / "model.npz"), device="cpu")
    with torch.no_grad():
        got = m(*map(torch.from_numpy, xs))
    _check(got, apply(params, *map(jnp.asarray, xs)))
    with pytest.raises(ValueError, match="generator"):
        b.get_model()


@pytest.mark.parametrize("name,cls", [
    ("HDEMUCS_HIGH_MUSDB", "HDemucsTA"),
    ("HDEMUCS_HIGH_MUSDB_PLUS", "HDemucsTA"),
    ("CONVTASNET_BASE_LIBRI2MIX", "ConvTasNet"),
    ("SQUIM_OBJECTIVE", "SquimObjectiveTA"),
    ("SQUIM_SUBJECTIVE", "SquimSubjective"),
    ("VGGISH", "VGGish")])
def test_bundle_geometry_on_meta(name, cls):
    """Each constant's model has the JAX bundle's class and parameter
    count."""
    tm = getattr(tpipe, name).get_model(torch.Generator(), device="meta")
    assert type(tm).__name__ == cls
    if name == "VGGISH":
        jm = JM.VGGish()
    elif name.startswith("HDEMUCS"):
        jm = JM.hdemucs_high(compat="torchaudio")
    elif name.startswith("CONVTASNET"):
        jm = JM.conv_tasnet_base()
    elif name == "SQUIM_OBJECTIVE":
        jm = JM.squim_objective_base(compat="torchaudio")
    else:
        jm = JM.squim_subjective_base()
    assert type(jm).__name__ == cls
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes))
    # the port's LSTMs carry a second (zero) bias per direction
    n_hh = sum(p.numel() for n, p in tm.named_parameters()
               if "bias_hh" in n)
    assert sum(p.numel() for p in tm.parameters()) - n_hh == n_jax


def test_vggish_slice_matches_jax(tmp_path):
    """A 16 kHz clip → the bundle's processor → its model, in both
    packages from one ``save_params`` file."""
    jm = JM.VGGish()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray((np.sqrt(2.0 / max(np.prod(s.shape[:-1]), 1))
                               * rng.standard_normal(s.shape))
                              .astype(np.float32)), shapes)
    jckpt.save_params(str(tmp_path / "vggish.npz"), params)
    tm = tpipe.VGGISH.get_model(checkpoint=str(tmp_path / "vggish.npz"),
                                device="cpu")
    clip = (0.3 * rng.standard_normal(2 * 16000)).astype(np.float32)
    patches = tpipe.VGGISH.get_input_processor()(torch.from_numpy(clip))
    jpatches = jpipe.VGGISH.get_input_processor()(jnp.asarray(clip))
    assert patches.shape == (2, 96, 64)
    with torch.no_grad():
        got = tm(patches)
    _check(got, jax.jit(jm.apply)(params, jpatches))
    assert _same(tpipe.VGGISH.get_model(torch_checkpoint=tm.state_dict(),
                                        device="cpu"), tm)


def test_separation_slice_matches_jax(tmp_path):
    """A two-speaker mixture → the (toy) ConvTasNet bundle → SI-SNR
    against the planted sources, in both packages."""
    factory, jfactory, _, _ = TOYS["CONVTASNET_BASE_LIBRI2MIX"]
    b = dataclasses.replace(tpipe.CONVTASNET_BASE_LIBRI2MIX, _factory=factory)
    jm = jfactory()
    params = _params(jm, 4, scale=0.3)
    jckpt.save_params(str(tmp_path / "tasnet.npz"), params)
    tm = b.get_model(checkpoint=str(tmp_path / "tasnet.npz"), device="cpu")
    src = np.random.default_rng(5).standard_normal((2, 2, 400)).astype(
        np.float32)
    mix = src.sum(1)
    with torch.no_grad():
        got = tops.si_snr(tm(torch.from_numpy(mix)), torch.from_numpy(src))
    want = tac.ops.si_snr(jax.jit(jm.apply)(params, jnp.asarray(mix)),
                          jnp.asarray(src))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-3
