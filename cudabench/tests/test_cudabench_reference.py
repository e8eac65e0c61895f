"""The plain reference (``cudabench/reference``) against the measured
package's CPU path at toy sizes: the filterbank, the log-mel and its
gradients, the classifier's logits, loss, gradients and SGD steps."""
import copy

import pytest
import torch

from cudabench.reference import logmel as RL
from cudabench.reference import mel_cnn as RC
from torchaudio_contrib_tpu_torch.models.frontend import MelFrontendClassifier
from torchaudio_contrib_tpu_torch.models.layers import FusedMelspectrogram
from torchaudio_contrib_tpu_torch.ops import create_mel_filter

torch.set_num_threads(2)


@pytest.mark.parametrize("mels,sr,fft", [(16, 8000, 256), (128, 22050, 2048),
                                         (64, 16000, 512)])
def test_filterbank(mels, sr, fft):
    ref = torch.as_tensor(RL.mel_filterbank(mels, sr, fft // 2 + 1))
    port = create_mel_filter(mels, sr, num_bins=fft // 2 + 1,
                             dtype=torch.float64)
    assert torch.allclose(ref, port, atol=1e-12)


def test_logmel_and_gradients():
    g = torch.Generator().manual_seed(0)
    x = (0.1 * torch.randn(2, 1, 4000, generator=g)).requires_grad_(True)
    layer = FusedMelspectrogram(num_mels=16, sample_rate=8000,
                                fft_length=256, hop_length=64,
                                trainable=True)
    y = layer(x)
    fb = torch.as_tensor(RL.mel_filterbank(16, 8000, 129),
                         dtype=torch.float32).requires_grad_(True)
    yr = RL.logmel(x, fb, 256, 64)
    assert yr.shape == y.shape
    assert (y - yr).abs().max() < 1e-4
    cot = torch.randn(y.shape, generator=g)
    dx, dfb = torch.autograd.grad(y, (x, layer.filterbank), cot)
    rx, rfb = torch.autograd.grad(yr, (x, fb), cot)
    assert torch.linalg.norm(dx - rx) / torch.linalg.norm(rx) < 1e-5
    assert torch.linalg.norm(dfb - rfb) / torch.linalg.norm(rfb) < 1e-5


def test_classifier_steps():
    cfg = {"args": {"num_classes": 5, "num_mels": 16, "sample_rate": 8000,
                    "fft_length": 256, "hop_length": 64,
                    "channels": [4, 8, 8], "fused": True,
                    "trainable_frontend": True}}
    g = torch.Generator().manual_seed(1)
    model = MelFrontendClassifier(**cfg["args"], generator=g)
    p0 = {k: v.detach().double().clone()
          for k, v in model.named_parameters()}
    p0["frontend.0.filterbank"] = torch.as_tensor(
        RL.mel_filterbank(16, 8000, 129))
    batches = [(0.1 * torch.randn(3, 1, 4000, generator=g),
                torch.randint(0, 5, (3,), generator=g)) for _ in range(3)]
    with torch.no_grad():
        logits = RC.forward(p0, batches[0][0].double(), cfg)
        assert torch.allclose(model(batches[0][0]).double(), logits,
                              rtol=1e-4, atol=1e-5)
    losses, g1, p3 = RC.sgd_steps(
        p0, [(x.double(), y) for x, y in batches], 1e-3, cfg)
    ref = copy.deepcopy(model)
    got = [ref.train_step(x, y, 1e-3).item() for x, y in batches]
    assert got == pytest.approx([v.item() for v in losses], rel=1e-5)
    for k, v in ref.named_parameters():
        d_port = (v.detach().double() - p0[k]).norm()
        d_ref = (p3[k] - p0[k]).norm()
        assert abs(d_port - d_ref) <= 1e-3 * d_ref + 1e-9, k
