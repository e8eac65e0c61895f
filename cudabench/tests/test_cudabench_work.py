"""The operation and byte counts of ``cudabench/work.py``.

Config 2 (32 x 661 500 samples, fft 2048, hop 512, 128 mels): 41 216
frames; forward 41 216 x 2.5 x 2048 x 11 = 2.32 GFLOP of transforms plus
2 x 41 216 x 1025 x 128 = 10.82 GFLOP of mel product, 13.1 GFLOP; bytes
4 x (21 168 000 + 131 200 + 5 275 648) = 106 MB.  Backward with both
gradients: one transform and two mel products, 24.0 GFLOP.

Config 3 (32 x 160 000 samples, fft 512, hop 128, 64 mels): 1 247 frames
a clip, 39 904 rows; forward 39 904 x 2.5 x 512 x 9 = 0.460 GFLOP plus 2 x
39 904 x 257 x 64 = 1.313 GFLOP, 1.772 GFLOP; the filterbank's gradient
alone one mel product, 1.313 GFLOP.  The CNN on (32, 1, 64, 1247): conv 1
to (32, 32, 624), 2 x 32 x 624 x 32 x 1 x 9 = 11.5 MFLOP a clip; conv 2 to
(64, 16, 312), 2 x 16 x 312 x 64 x 32 x 9 = 184.0 MFLOP; conv 3 to (128,
8, 156), 2 x 8 x 156 x 128 x 64 x 9 = 184.0 MFLOP; head 2 x 128 x 10; so
12.15 GFLOP forward for 32 clips and twice that backward (weights' and
inputs' gradients, the first convolution's input gradient included): a
training step is 1.772 + 1.313 + 3 x 12.15 = 39.5 GFLOP.
"""
import pytest

from cudabench import work
from cudabench.systems import fused_mel, mel_classifier

C2 = {"args": {"num_mels": 128, "sample_rate": 22050, "fft_length": 2048,
               "hop_length": 512}}
C3 = {"args": {"num_classes": 10, "num_mels": 64, "sample_rate": 16000,
               "fft_length": 512, "hop_length": 128,
               "channels": [32, 64, 128]}}


def test_peaks():
    assert work.PEAK_FP32 == 67e12 and work.PEAK_BYTES == 3.35e12


def test_config2_forward_and_backward():
    f = fused_mel.work(C2, 32, 661500, "grad")
    assert work.n_frames(661500, 2048, 512) == 1288
    assert f["b1"][0] == pytest.approx(13.14e9, rel=1e-3)
    assert f["b1"][1] == pytest.approx(106.3e6, rel=1e-3)
    assert f["b2"][0] == pytest.approx(23.95e9, rel=1e-3)
    assert f["step"] == f["b1"][0] + f["b2"][0]
    assert fused_mel.work(C2, 32, 661500, "forward")["step"] == f["b1"][0]
    # the forward is bound by its operations: 0.196 ms
    assert work.bound_s(*f["b1"]) == pytest.approx(0.196e-3, rel=1e-2)


def test_config3_step():
    w = mel_classifier.work(C3, 32, 160000, "train")
    assert work.n_frames(160000, 512, 128) == 1247
    assert w["b1"][0] == pytest.approx(1.772e9, rel=1e-3)
    assert w["b2"][0] == pytest.approx(1.313e9, rel=1e-3)
    cnn = work.cnn_fwd_flops(32, 64, 1247, (32, 64, 128), 10)
    assert cnn == pytest.approx(12.145e9, rel=1e-3)
    assert w["step"] == pytest.approx(39.52e9, rel=1e-3)


def test_bytes_count_each_input_and_output_once():
    flops, nbytes = work.logmel_bwd(2, 1000, 256, 64, 16, need_dx=False,
                                    need_dfb=True)
    rows = 2 * work.n_frames(1000, 256, 64)
    assert flops == 2.0 * rows * 129 * 16
    assert nbytes == 4 * (rows * 16 + 129 * 16 + 2 * 1000 + 129 * 16)
