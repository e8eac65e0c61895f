"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX (the GPU machine has none), so it runs there without
``tests/conftest.py``, which imports JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import fused as tfused
import torchaudio_contrib_tpu_torch as tat

PARITY = 1e-5    # max |kernel - plain| / max |plain|: both are f32 chains


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, shape, mels, sr, fft):
    x = np.random.default_rng(seed).standard_normal(shape)
    fb = tops.create_mel_filter(mels, sr, 0.0, None, fft // 2 + 1)
    return torch.from_numpy(x.astype(np.float32)), fb


@pytest.mark.cuda
@pytest.mark.parametrize("shape,fft,hop,mels,sr,kw", [
    ((2, 88200), 2048, 512, 128, 22050, {}),
    ((2, 48000), 400, 160, 80, 16000, {}),
    ((2, 2, 7000), 256, 64, 40, 16000, {}),
    ((2, 20000), 512, 128, 64, 16000, {"to_db": False}),
    ((3, 9000), 512, 200, 64, 16000, {"center": True}),
    ((2, 9000), 512, 128, 64, 16000, {"win_length": 300}),
    ((1, 100), 2, 1, 1, 16000, {}),
    # the largest mel accumulator the kernel's shared memory holds (704
    # padded mels), at ~2.9 linear bins per band like Whisper's 2.5
    ((1, 40000), 4096, 1024, 700, 16000, {"db_ref": 0.5}),
])
def test_kernel_matches_plain(cuda_device, shape, fft, hop, mels, sr, kw):
    x, fb = _inputs(len(shape) * fft + hop, shape, mels, sr, fft)
    want = tops.fused_melspectrogram(x, fb, fft, hop, **kw)
    before = tfused.KERNEL_LAUNCHES
    with torch.inference_mode():
        got = tops.fused_melspectrogram(x.to(cuda_device),
                                        fb.to(cuda_device), fft, hop, **kw)
        torch.cuda.synchronize()
    assert tfused.KERNEL_LAUNCHES == before + 1
    got = got.cpu()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= PARITY, err


@pytest.mark.cuda
def test_kernel_refuses_gradients(cuda_device):
    x = torch.zeros((1, 4096), device=cuda_device)
    fb = tops.create_mel_filter(16, 16000, 0.0, None, 129,
                                device=cuda_device).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="A2"):
        tops.fused_melspectrogram(x, fb, 256, 128)
    with torch.no_grad():
        assert tops.fused_melspectrogram(x, fb, 256, 128).shape == (1, 16, 31)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros((1, 4096), device=cuda_device)
    fb = tops.create_mel_filter(16, 16000, 0.0, None, 129,
                                device=cuda_device)
    with pytest.raises(ValueError, match="power=2"):
        tops.fused_melspectrogram(x, fb, 256, 128, power=1.0)
    with pytest.raises(ValueError, match="num_mels"):
        tops.fused_melspectrogram(
            x, torch.zeros((129, 800), device=cuda_device), 256, 128)
    with pytest.raises(ValueError, match="filterbank on"):
        tops.fused_melspectrogram(x, fb.cpu(), 256, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_classifier_on_card_matches_cpu(cuda_device, fused):
    model = tat.MelFrontendClassifier(
        fused=fused, generator=torch.Generator().manual_seed(1)).eval()
    x, _ = _inputs(7, (4, 1, 16000), 64, 16000, 512)
    with torch.inference_mode():
        want = model(x)
        before = tfused.KERNEL_LAUNCHES
        got = model.to(cuda_device)(x.to(cuda_device)).cpu()
    assert tfused.KERNEL_LAUNCHES == before + (1 if fused else 0)
    assert (got - want).abs().max().item() <= 1e-4
