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
            "mel_profile\n"
            "from torchaudio_contrib_tpu_torch.ops import (griffinlim, "
            "fused_griffinlim, melinv, pitch, resample, phase_vocoder, "
            "mulaw)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'jaxlib' "
            "or m.startswith('torchaudio_contrib_tpu.') "
            "or m == 'torchaudio_contrib_tpu')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
