"""The port's meshes, batch data parallelism, multi-process setup,
time-sharded STFT/mel and the corpus preprocessor on a mesh
(``parallel/sharding.py``, ``multihost.py``, ``timeshard.py``,
``corpus.py``) on a 4-rank gloo world of CPU processes that joins through
``initialize_multihost`` from the JAX package's environment names; the
mesh-related cases of the JAX package's ``test_parallel.py`` and
``test_multihost_2proc.py``.  Also: the port's multi-device modules import
neither JAX nor the JAX package.

One world runs every check; each case reads its own.  Bars against the
port's unsharded result: 1e-5 of the output's peak (the JAX tests' 1e-5
for STFTs, their rtol 1e-5 for data parallelism); against the JAX package
1e-4 of peak, through its sharded ``time_sharded_*`` on 4 of the
conftest's CPU devices and its unsharded layers.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_world import check, run_world, value

torch.set_num_threads(2)

WORLD = 4
SR = 8000
N_FILES = 22


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _clips():
    return [_rand(100 + i, (1, SR), 0.1 + i) for i in range(N_FILES)]


def _peak_err(got, want):
    got = got.detach() if isinstance(got, torch.Tensor) else torch.tensor(
        np.asarray(got))
    want = want.detach() if isinstance(want, torch.Tensor) else \
        torch.tensor(np.asarray(want))
    return float((got - want).abs().max() / want.abs().max())


def _gather_frames(t, world):
    """All-gather a last-dim shard whose length differs by rank."""
    import torch.distributed as dist
    n = torch.tensor([t.shape[-1]])
    sizes = [torch.zeros(1, dtype=torch.long) for _ in range(world)]
    dist.all_gather(sizes, n)
    width = int(max(sizes))
    buf = torch.zeros(t.shape[:-1] + (width,), dtype=t.dtype)
    buf[..., :t.shape[-1]] = t
    parts = [torch.zeros_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    return torch.cat([p[..., :int(s)] for p, s in zip(parts, sizes)], -1)


# ---------------------------------------------------------------- worker

def _worker(rank, world, tmpdir):
    import torch.distributed as dist
    from torchaudio_contrib_tpu_torch import ops
    from torchaudio_contrib_tpu_torch.models import (FusedMelspectrogram,
                                                     Melspectrogram)
    from torchaudio_contrib_tpu_torch.parallel import (
        CorpusPreprocessor, data_parallel, initialize_multihost,
        make_mesh, make_pod_mesh, shard_batch, sharded_apply,
        time_sharded_melspectrogram, time_sharded_stft)

    res = {}

    def meshes():
        mesh = make_mesh(device="cpu")
        two = make_mesh(n_data=2, n_model=2, device="cpu")
        try:
            make_mesh(n_data=3, n_model=2, device="cpu")
            raised = None
        except ValueError as e:
            raised = str(e)
        pod = make_pod_mesh(n_model=2, device="cpu")
        initialize_multihost()            # already up: nothing to do
        return ((mesh.size(0), mesh.size(1)), (two.size(0), two.size(1)),
                raised, (pod.size(0), pod.size(1)), dist.get_world_size(),
                dist.get_rank())

    def data_parallel_layers():
        mesh = make_mesh(device="cpu")
        x = torch.tensor(_rand(1, (16, 1, 8000)))
        mel = Melspectrogram(num_mels=64, fft_length=512, hop_length=128,
                             sample_rate=16000)
        fused = FusedMelspectrogram(num_mels=32, sample_rate=16000,
                                    fft_length=512, hop_length=128)
        out = data_parallel(mel, mesh)(x)
        out_f = data_parallel(fused, mesh)(x)
        try:
            data_parallel(mel, mesh)(x[:6])
            raised = None
        except ValueError as e:
            raised = str(e)
        return (out.to_local(), mel(x).chunk(world)[rank],
                out_f.to_local(), fused(x).chunk(world)[rank],
                str(out.placements), tuple(out.shape), raised)

    def batches():
        mesh = make_mesh(device="cpu")
        x = torch.tensor(_rand(2, (8, 100)))
        s = shard_batch(x, mesh)
        doubled = sharded_apply(lambda v: v * 2.0, mesh)(
            torch.tensor(_rand(3, (8, 64))))
        return (str(s.placements), tuple(s.to_local().shape),
                doubled.full_tensor())

    def timesharded():
        mesh = make_mesh(device="cpu")
        x = torch.tensor(_rand(4, (2, WORLD * 128 * 16)))
        got = time_sharded_stft(x, mesh, "data", 512, 128)
        first = _gather_frames(got, world)
        again = _gather_frames(time_sharded_stft(x, mesh, "data", 512, 128),
                               world)
        ref = ops.stft(x, 512, 128, window="hann", center=False)
        # time over 'model' while the batch stays on 'data'
        two = make_mesh(n_data=2, n_model=2, device="cpu")
        y = torch.tensor(_rand(5, (4, 1, 2 * 64 * 32)))
        mine = y.chunk(2)[two.get_local_rank("data")]
        mel = time_sharded_melspectrogram(
            mine, two, "model", num_mels=32, sample_rate=16000,
            fft_length=256, hop_length=64)
        mel = _gather_model(mel, two)
        spec = ops.stft(mine, 256, 64, window="hann", center=False)
        fb = ops.create_mel_filter(32, 16000, 0.0, None, 129)
        mel_ref = ops.amplitude_to_db(
            ops.apply_filterbank(ops.complex_norm(spec, 2.0), fb), power=2.0)
        # the fused kernel's path (its plain version on the CPU)
        z = torch.tensor(_rand(6, (2, WORLD * 128 * 8)))
        fz = time_sharded_melspectrogram(
            z, mesh, "data", num_mels=32, sample_rate=16000, fft_length=256,
            hop_length=128, use_fused=True, precision="split3")
        fz = _gather_frames(fz, world)
        fb2 = ops.create_mel_filter(32, 16000, 0.0, None, 129)
        fz_ref = ops.fused_melspectrogram(z, fb2, 256, 128)
        try:
            time_sharded_stft(torch.zeros(2, 1000), mesh, "data", 256, 64)
            raised = None
        except ValueError as e:
            raised = str(e)
        return first, again, ref, mel, mel_ref, fz, fz_ref, raised

    def corpus(wire_format, use_fused):
        clips = _clips()
        rows = {}
        mesh = make_mesh(device="cpu")

        def loader(i):
            if i == 7:
                raise IOError("synthetic decode failure")
            return clips[i]

        pre = CorpusPreprocessor(
            loader, clip_samples=SR, batch_size=8, mesh=mesh, retries=0,
            use_fused=use_fused, wire_format=wire_format,
            sink=lambda i, m: rows.__setitem__(i, np.asarray(m)),
            fft_length=512, hop_length=128, num_mels=32, sample_rate=SR,
            frames_per_chunk=8)
        stats = pre.run(range(N_FILES))
        try:
            CorpusPreprocessor(loader, SR, 6, mesh=mesh)
            raised = None
        except ValueError as e:
            raised = str(e)
        return rows, (stats.files_done, stats.files_failed, stats.frames,
                      stats.seconds > 0), raised

    check(res, "meshes", meshes)
    check(res, "data_parallel", data_parallel_layers)
    check(res, "batches", batches)
    check(res, "timesharded", timesharded)
    check(res, "corpus_fused", corpus, "float32", True)
    check(res, "corpus_chain", corpus, "int16", False)
    return res


def _gather_model(t, mesh):
    import torch.distributed as dist
    group = mesh.get_group("model")
    n = dist.get_world_size(group)
    sizes = [torch.zeros(1, dtype=torch.long) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([t.shape[-1]]), group=group)
    width = int(max(sizes))
    buf = torch.zeros(t.shape[:-1] + (width,), dtype=t.dtype)
    buf[..., :t.shape[-1]] = t
    parts = [torch.zeros_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return torch.cat([p[..., :int(s)] for p, s in zip(parts, sizes)], -1)


# ---------------------------------------------------------------- parent

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_world")
    return run_world("test_torch_parallel:_worker", WORLD, tmp,
                     multihost=True)


def test_mesh_shapes(world):
    for r in world:
        mesh, two, raised, _, _, _ = value(r, "meshes")
        assert mesh == (4, 1) and two == (2, 2)
        assert raised is not None and "3x2" in raised


def test_multihost_world_from_jax_env_names(world):
    """Each process joined through ``initialize_multihost`` from
    ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``; the pod mesh
    keeps consecutive ranks on ``model``."""
    for rank, r in enumerate(world):
        _, _, _, pod, size, got_rank = value(r, "meshes")
        assert pod == (2, 2) and size == WORLD and got_rank == rank


def test_initialize_multihost_single_process_is_a_no_op():
    import torch.distributed as dist
    from torchaudio_contrib_tpu_torch.parallel import initialize_multihost
    was = dist.is_initialized()
    initialize_multihost(num_processes=1, device="cpu")
    assert dist.is_initialized() == was


def test_data_parallel_melspec_matches_local(world):
    import jax.numpy as jnp
    import torchaudio_contrib_tpu as tac
    for r in world:
        out, ref, _, _, places, shape, raised = value(r, "data_parallel")
        assert _peak_err(out, ref) <= 1e-5
        assert places == "(Shard(dim=0), Replicate())"
        assert shape[0] == 16
        assert raised is not None and "data axis" in raised
    x = _rand(1, (16, 1, 8000))
    jmel = tac.Melspectrogram(num_mels=64, fft_length=512, hop_length=128,
                              sample_rate=16000)
    want = np.asarray(jmel(jnp.asarray(x)))
    got = torch.cat([value(r, "data_parallel")[0] for r in world])
    assert _peak_err(got, want) <= 1e-4


def test_data_parallel_fused_layer(world):
    import jax.numpy as jnp
    from torchaudio_contrib_tpu import ops as jops
    for r in world:
        _, _, out, ref, _, _, _ = value(r, "data_parallel")
        assert _peak_err(out, ref) <= 1e-5
    x = _rand(1, (16, 1, 8000))
    got = torch.cat([value(r, "data_parallel")[2] for r in world])
    spec = jops.stft(jnp.asarray(x), 512, 128, center=False)
    jfb = jops.create_mel_filter(32, 16000, 0.0, None, 257)
    want = np.asarray(jops.amplitude_to_db(
        jops.apply_filterbank(jops.complex_norm(spec, 2.0), jfb),
        power=2.0))
    assert _peak_err(got, want) <= 1e-4


def test_shard_batch_placement(world):
    for r in world:
        places, local, _ = value(r, "batches")
        assert places == "(Shard(dim=0), Replicate())"
        assert local == (2, 100)


def test_sharded_apply(world):
    doubled = value(world[0], "batches")[2]
    np.testing.assert_allclose(doubled.numpy(), _rand(3, (8, 64)) * 2.0)


def _jax_time_sharded(fn, x, **kw):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(WORLD, 1),
                ("data", "model"))
    return np.asarray(fn(jnp.asarray(x), mesh, "data", **kw))


def test_time_sharded_stft_matches_oneshot(world):
    from torchaudio_contrib_tpu.parallel import time_sharded_stft as jts
    for r in world:
        got, again, ref, _, _, _, _, _ = value(r, "timesharded")
        assert got.shape == ref.shape
        assert _peak_err(torch.view_as_real(got),
                         torch.view_as_real(ref)) <= 1e-5
        assert torch.equal(got, again)            # repeated calls agree
    want = _jax_time_sharded(jts, _rand(4, (2, WORLD * 128 * 16)),
                             fft_length=512, hop_length=128)
    assert _peak_err(torch.view_as_real(got),
                     np.stack([want.real, want.imag], -1)) <= 1e-4


def test_time_sharded_mel_2d_mesh(world):
    for r in world:
        _, _, _, mel, mel_ref, _, _, _ = value(r, "timesharded")
        assert mel.shape == mel_ref.shape
        np.testing.assert_allclose(mel.numpy(), mel_ref.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_time_sharded_mel_fused_kernel(world):
    """The fused path on each shard after the halo equals the one-shot
    fused op, and the JAX package's sharded chain."""
    from torchaudio_contrib_tpu.parallel import \
        time_sharded_melspectrogram as jtm
    for r in world:
        _, _, _, _, _, fz, fz_ref, _ = value(r, "timesharded")
        assert fz.shape == fz_ref.shape
        assert _peak_err(fz, fz_ref) <= 1e-5
    want = _jax_time_sharded(jtm, _rand(6, (2, WORLD * 128 * 8)),
                             num_mels=32, sample_rate=16000, fft_length=256,
                             hop_length=128)
    assert _peak_err(fz, want) <= 1e-4


def test_time_sharded_validation(world):
    raised = value(world[0], "timesharded")[-1]
    assert raised is not None and "hop-aligned" in raised


def _one_rank_rows(wire_format, use_fused):
    from torchaudio_contrib_tpu_torch.parallel import CorpusPreprocessor
    clips = _clips()
    rows = {}

    def loader(i):
        if i == 7:
            raise IOError("synthetic decode failure")
        return clips[i]

    stats = CorpusPreprocessor(
        loader, clip_samples=SR, batch_size=8, retries=0,
        use_fused=use_fused, wire_format=wire_format, device="cpu",
        sink=lambda i, m: rows.__setitem__(i, np.asarray(m)),
        fft_length=512, hop_length=128, num_mels=32, sample_rate=SR,
        frames_per_chunk=8).run(range(N_FILES))
    return rows, stats


@pytest.mark.parametrize("check_name,wire,fused",
                         [("corpus_fused", "float32", True),
                          ("corpus_chain", "int16", False)])
def test_corpus_on_a_mesh_matches_one_rank(world, check_name, wire, fused):
    """Each rank's sink gets its own rows; their union is the one-rank
    run's rows and the stats are summed over the data ranks."""
    want, stats = _one_rank_rows(wire, fused)
    union = {}
    for r in world:
        rows, got_stats, raised = value(r, check_name)
        assert not set(rows) & set(union)
        union.update(rows)
        assert got_stats[:3] == (stats.files_done, stats.files_failed,
                                 stats.frames) and got_stats[3]
        assert raised is not None and "data axis" in raised
    assert sorted(union) == sorted(want) and 7 not in union
    for i in want:
        assert np.abs(union[i] - want[i]).max() <= \
            1e-5 * np.abs(want[i]).max(), i


def test_corpus_use_fused_sharded_matches_jax(world):
    import jax.numpy as jnp
    from torchaudio_contrib_tpu import ops as jops
    union = {}
    for r in world:
        union.update(value(r, "corpus_fused")[0])
    x0 = jnp.asarray(_clips()[3])
    spec = jops.stft(x0, 512, 128, center=False)
    fb = jops.create_mel_filter(32, SR, 0.0, None, 257)
    ref = jops.amplitude_to_db(
        jops.apply_filterbank(jops.complex_norm(spec, 2.0), fb), power=2.0)
    np.testing.assert_allclose(union[3], np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_workers_import_no_jax(world):
    for r in world:
        assert r["_jax_modules"] == []


def test_port_multidevice_modules_import_no_jax():
    """Every ``parallel`` module, ``utils.checkpoint`` and the layer's
    profile script in a fresh interpreter: neither JAX nor the JAX package
    is loaded."""
    code = (
        "import sys\n"
        "import torchaudio_contrib_tpu_torch.parallel as p\n"
        "from torchaudio_contrib_tpu_torch.parallel import (_comm, corpus,"
        " fsdp, multihost, pp, sharding, spattn, timeshard, tp)\n"
        "from torchaudio_contrib_tpu_torch.utils import checkpoint\n"
        "from torchaudio_contrib_tpu_torch.utils import save_checkpoint,"
        " load_checkpoint\n"
        "from torchaudio_contrib_tpu_torch.benchmarks import md_profile\n"
        "assert len(p.__all__) == 29, p.__all__\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith('jax.') or m == 'torchaudio_contrib_tpu' or"
        " m.startswith('torchaudio_contrib_tpu.'))\n"
        "print('BAD', bad)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


def test_parallel_names_match_the_jax_package():
    import torchaudio_contrib_tpu.parallel as jpar
    import torchaudio_contrib_tpu.utils as jutils
    import torchaudio_contrib_tpu_torch.parallel as tpar
    import torchaudio_contrib_tpu_torch.utils as tutils
    assert list(tpar.__all__) == list(jpar.__all__)
    for name in jpar.__all__:
        assert callable(getattr(tpar, name)) or isinstance(
            getattr(tpar, name), type), name
    for name in ("save_checkpoint", "load_checkpoint"):
        assert name in jutils.__all__ and name in tutils.__all__
