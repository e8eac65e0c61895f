"""The port's fused mel op vs the JAX package, and its dispatch contract.

On the CPU, ``torchaudio_contrib_tpu_torch.ops.fused_melspectrogram`` runs
its plain version (the stft → |·|² → mel → dB chain).  It is held against
the JAX op's chain path and against the JAX package's Pallas forward
kernel run through the Pallas interpreter (``TAC_FUSED_INTERPRET=1``, as
``tests/test_fused.py`` runs it), at hops that are not multiples of 128
(the 128-aligned in-kernel-framing variant takes tens of seconds
interpreted).  The CUDA kernel itself is checked against the plain
version by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from torchaudio_contrib_tpu import ops as jops
from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import fused as tfused

# the lane runs 6 test workers on 8 cores: torch's default of one
# thread per core oversubscribes them, so these tests run it on 2
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _fb(num_mels, sr, fft):
    return tops.create_mel_filter(num_mels, sr, 0.0, None, fft // 2 + 1)


# ---- (a) plain version vs the JAX op (chain path on the CPU) -----------------

@pytest.mark.parametrize("shape,fft,hop,mels,sr,kw", [
    ((2, 16384), 512, 128, 64, 16000, {}),
    ((2, 1, 16384), 512, 128, 64, 16000, {"center": True}),
    ((3, 2, 8192), 256, 128, 32, 16000, {"to_db": False}),
    ((2, 8192), 512, 128, 32, 16000, {"win_length": 300}),
    ((2, 16000), 400, 160, 80, 16000, {"precision": "auto"}),     # Whisper
    ((1, 3, 9000), 256, 100, 40, 22050, {"db_ref": 0.5, "amin": 1e-5}),
    ((2, 8000), 512, 200, 64, 16000, {"center": True,
                                      "pad_mode": "constant"}),
])
def test_plain_matches_jax(rng, shape, fft, hop, mels, sr, kw):
    x = rng.standard_normal(shape).astype(np.float32)
    fb = _fb(mels, sr, fft)
    got = tops.fused_melspectrogram(torch.from_numpy(x), fb, fft, hop, **kw)
    want = np.asarray(jops.fused_melspectrogram(
        jnp.asarray(x), jnp.asarray(fb.numpy()), fft, hop, **kw))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


# ---- (b) plain version vs the Pallas kernel, interpreted -------------------

@pytest.mark.parametrize("fft,hop,mels", [(256, 64, 16), (400, 160, 40)])
def test_plain_matches_pallas_interpret(rng, monkeypatch, fft, hop, mels):
    monkeypatch.setenv("TAC_FUSED_INTERPRET", "1")
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    fb = _fb(mels, 16000, fft)
    got = tops.fused_melspectrogram(torch.from_numpy(x), fb, fft, hop,
                                    precision="split3").numpy()
    want = np.asarray(jops.fused_melspectrogram(
        jnp.asarray(x), jnp.asarray(fb.numpy()), fft, hop,
        precision="split3"))
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= 2e-5, err


# ---- (c) dispatch contract -------------------------------------------------

def test_resolve_precision():
    rp = tfused.resolve_precision
    assert rp("auto", 2048, 128) == "split3"        # 8 bins/mel
    assert rp("auto", 400, 80) == "split6"          # Whisper
    assert rp("auto", 1024, 128) == "split6"        # 4 bins/mel
    assert rp("auto", 2048, 64) == "split3"
    for p in ("fast", "split3", "split6"):
        assert rp(p, 400, 80) == p
    with pytest.raises(ValueError, match="precision"):
        rp("split4", 2048, 128)
    for fft, mels in ((2048, 128), (400, 80), (1024, 128), (256, 64)):
        assert rp("auto", fft, mels) == jops.resolve_precision("auto", fft,
                                                                mels)


def test_supported_matrix():
    for fft, hop in ((2048, 512), (1024, 256), (512, 160), (2048, 500),
                     (2048, 2048), (400, 160), (250, 125), (512, 0),
                     (1, 1), (2, 1)):
        assert tops.fused_mel_supported(fft, hop) == \
            jops.fused_mel_supported(fft, hop), (fft, hop)


def test_bad_filterbank_rows(rng):
    x = torch.from_numpy(rng.standard_normal((1, 4096)).astype(np.float32))
    with pytest.raises(ValueError, match="rows"):
        tops.fused_melspectrogram(x, torch.zeros(100, 16), 256, 128)


def test_input_errors(rng):
    x = torch.from_numpy(rng.standard_normal((1, 200)).astype(np.float32))
    with pytest.raises(ValueError, match="too short"):
        tops.fused_melspectrogram(x, _fb(16, 16000, 256), 256, 128)
    with pytest.raises(ValueError, match="unsupported"):
        tops.fused_melspectrogram(x, _fb(16, 16000, 256), 256, 0)
    with pytest.raises(ValueError, match="precision"):
        tops.fused_melspectrogram(x, _fb(16, 16000, 128), 128, 64,
                                  precision="bf16")


def test_cpu_runs_plain_version_without_launching(rng, monkeypatch):
    """A CPU tensor takes the plain version and never reaches the kernel
    library (nothing is built)."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")
    monkeypatch.setattr(tfused._cuda, "load", no_build)
    before = tfused.KERNEL_LAUNCHES
    x = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))
    out = tops.fused_melspectrogram(x, _fb(32, 16000, 512), 512, 128)
    assert tuple(out.shape) == (2, 32, 1 + (4096 - 512) // 128)
    assert tfused.KERNEL_LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The launch wrapper takes CUDA tensors only: on anything else it
    raises instead of computing the result another way."""
    with pytest.raises(ValueError, match="CUDA"):
        tfused._fused_mel_fwd_cuda(torch.zeros(2, 4096), _fb(32, 16000, 512),
                                   512, 128, "hann", None, True, 1.0, 1e-7)


def test_basis_layout():
    """The kernel's basis is the JAX package's ``_basis_f32`` at a 64-bin
    tile: window folded in (centred when shorter than fft), ``[re | im]``
    per tile, zero columns past fft//2+1, zero rows past fft_length."""
    from torchaudio_contrib_tpu.ops.fused import _basis_f32
    fft, win = 250, 200
    basis, n_freqs, ft = tfused._basis_np(fft, "hann", win)
    want, j_freqs, j_ft, _ = _basis_f32(fft, "hann", win, 64)
    assert (n_freqs, ft) == (j_freqs, j_ft) == (126, 2)
    assert basis.shape == (256, ft * 2 * 64) and basis.dtype == np.float32
    np.testing.assert_array_equal(basis[:fft], want[:fft])
    assert not basis[fft:].any()
    last = basis[:, 128:]                          # bins 64..127
    assert not last[:, 62:64].any() and not last[:, 64 + 62:].any()


# ---- (d) the port imports no JAX -----------------------------------------

def test_import_pulls_in_no_jax():
    code = ("import sys, torchaudio_contrib_tpu_torch\n"
            "from torchaudio_contrib_tpu_torch.benchmarks import "
            "gl_bisect, gl_probe, gl_profile, mel_ab, mel_bisect, "
            "mel_profile, asr_profile, transducer_profile\n"
            "from torchaudio_contrib_tpu_torch.ops import (griffinlim, "
            "fused_griffinlim, melinv, pitch, resample, phase_vocoder, "
            "mulaw, features, augment, spectral, effects, convolve, "
            "metrics, chroma, cqt, pitchdetect, dsp, beamform)\n"
            "import torchaudio_contrib_tpu_torch.ops.iir, "
            "torchaudio_contrib_tpu_torch.ops.loudness, "
            "torchaudio_contrib_tpu_torch.ops.vad, "
            "torchaudio_contrib_tpu_torch.ops.modfx, "
            "torchaudio_contrib_tpu_torch.ops.kaldipitch, "
            "torchaudio_contrib_tpu_torch.ops.rir, "
            "torchaudio_contrib_tpu_torch.ops.raytrace, "
            "torchaudio_contrib_tpu_torch.compliance.kaldi\n"
            "from torchaudio_contrib_tpu_torch.ops import (ctcloss, align, "
            "edit, ctcdecode, lexdecode, rnnt)\n"
            "from torchaudio_contrib_tpu_torch.models import asr, decoder\n"
            "from torchaudio_contrib_tpu_torch.models import (_common, "
            "emformer, conformer, rnnt, factories, wav2vec2, hubert, "
            "conformer_w2v2, emformer_hubert, tacotron2, wavernn, "
            "hifigan)\n"
            "from torchaudio_contrib_tpu_torch import pipelines, datasets\n"
            "from torchaudio_contrib_tpu_torch.pipelines import ("
            "TACOTRON2_WAVERNN_CHAR_LJSPEECH, HIFIGAN_VOCODER_V3_LJSPEECH, "
            "TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH)\n"
            "from torchaudio_contrib_tpu_torch.utils import convert, "
            "checkpoint\n"
            "from torchaudio_contrib_tpu_torch.benchmarks import "
            "w2v2_profile\n"
            "from torchaudio_contrib_tpu_torch.pipelines import (MMS_FA, "
            "WAV2VEC2_ASR_BASE_960H, WAVLM_BASE)\n"
            "from torchaudio_contrib_tpu_torch import parallel\n"
            "from torchaudio_contrib_tpu_torch.parallel import corpus\n"
            "from torchaudio_contrib_tpu_torch.models import transforms\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'jaxlib' "
            "or m.startswith('torchaudio_contrib_tpu.') "
            "or m == 'torchaudio_contrib_tpu')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---- (e) the rules the CUDA path shares with the CPU path --------------------

@pytest.mark.parametrize("to_db", [True, False])
def test_power_other_than_two_takes_the_chain(rng, monkeypatch, to_db):
    """``power != 2`` computes the plain chain, as the JAX package's
    ``_kernel_eligible`` decides on every backend: the rule reads the
    arguments only, so no kernel wrapper is reached and no launch is
    counted (on the card too; ``tests/test_torch_cuda.py``)."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("power != 2 must not reach the kernels")
    monkeypatch.setattr(tfused, "_fused_apply", no_kernel)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    fb = _fb(32, 16000, 512)
    before = tfused.KERNEL_LAUNCHES
    got = tops.fused_melspectrogram(torch.from_numpy(x), fb, 512, 128,
                                    power=1.0, to_db=to_db)
    assert tfused.KERNEL_LAUNCHES == before
    want = np.asarray(jops.fused_melspectrogram(
        jnp.asarray(x), jnp.asarray(fb.numpy()), 512, 128, power=1.0,
        to_db=to_db))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_slabs_cover_the_streams_in_order():
    assert tfused._slabs(0) == []
    assert tfused._slabs(65535) == [(0, 65535)]
    assert tfused._slabs(65600) == [(0, 65535), (65535, 65600)]
    assert tfused._slabs(7, 3) == [(0, 3), (3, 6), (6, 7)]


def test_slab_split_is_exact_in_the_plain_versions(rng):
    """The wrappers launch a batch as slabs of streams (clips); each stream
    is independent, so the slabs' results, in order, are the batch's,
    bitwise: here through the kernels' plain versions, slabs of 3."""
    from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as tgl
    x = torch.from_numpy(rng.standard_normal((7, 3000)).astype(np.float32))
    fb = _fb(24, 16000, 256)
    args = (fb, 256, 64, "hann", None, True, 1.0, 1e-7)
    whole, reim = tfused._fwd_res_plain(x, *args, save_spec=True)
    parts = [tfused._fwd_res_plain(x[a:b], *args, save_spec=True)
             for a, b in tfused._slabs(7, 3)]
    assert torch.equal(whole, torch.cat([p[0] for p in parts]))
    assert torch.equal(reim, torch.cat([p[1] for p in parts]))
    mag = tops.stft(x, 256, 64).abs()
    ops = tgl._gl_prepare(mag, 256, 64, "hann")[:5]
    state, prev = tgl._gl_solve_plain(*ops, 256, 64, 2, 0.99)
    for a, b in tfused._slabs(7, 3):
        part = tgl._gl_solve_plain(ops[0][a:b], ops[1][a:b], *ops[2:], 256,
                                   64, 2, 0.99)
        assert torch.equal(part[0], state[a:b])
        assert torch.equal(part[1], prev[a:b])


def test_build_directory_variable(monkeypatch, tmp_path):
    """``TAC_TORCH_BUILD_DIR`` moves the build out of the package (which may
    be read-only): the library is looked for and compiled there.  Checked
    without building: the compiler's commands are captured, not run."""
    from torchaudio_contrib_tpu_torch.ops import _cuda
    monkeypatch.delenv(_cuda.BUILD_DIR_ENV, raising=False)
    assert _cuda.build_dir() == _cuda._PKG / "_build"
    target = tmp_path / "kernels"
    monkeypatch.setenv(_cuda.BUILD_DIR_ENV, str(target))
    assert _cuda.build_dir() == target
    seen = []

    def capture(cmds):
        seen.extend(cmds)
        raise RuntimeError("captured")
    monkeypatch.setattr(_cuda, "_find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_cuda, "_run_all", capture)
    with pytest.raises(RuntimeError, match="captured"):
        _cuda._build_and_load()
    outputs = [cmd[cmd.index("-o") + 1] for cmd in seen]
    assert outputs and all(o.startswith(str(target)) for o in outputs)
    assert target.is_dir() and not list(target.iterdir())
