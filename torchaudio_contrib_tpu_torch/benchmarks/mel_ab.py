"""Times of the fused mel kernels at config 2, for comparing two trees.

    PYTHONPATH=<tree> python <tree>/torchaudio_contrib_tpu_torch/benchmarks/mel_ab.py

(run as a file: ``python -m`` would put the working directory's package
first).  Prints one JSON line: the tree the package was imported from,
then, by CUDA events at 32 x 30 s (22.05 kHz, fft 2048, hop 512, 128
mels), two medians of 25 each for the forward kernel without and with its
residual, the backward's frame passes, the whole backward and (medians of
15) forward + backward through ``fused_melspectrogram``, and the peak
device memory.  To compare a change with its parent on one card, unpack
the parent beside the change and run parent, change, change, parent in one
command; the run-to-run spread of one tree is the yardstick.  Needs a CUDA
card.
"""
from __future__ import annotations

import json

import numpy as np
import torch

import torchaudio_contrib_tpu_torch as package
from torchaudio_contrib_tpu_torch.benchmarks import card, time_cuda_ms
from torchaudio_contrib_tpu_torch.ops import create_mel_filter, fused


def run(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    fft, hop, mels = 2048, 512, 128
    x = torch.from_numpy(rng.standard_normal(
        (32, 30 * 22050)).astype(np.float32)).cuda()
    fb = create_mel_filter(mels, 22050, 0.0, None, fft // 2 + 1,
                           device="cuda")
    args = (fft, hop, "hann", None, True, 1.0, 1e-7)
    out = {"tree": package.__file__, "card": card()}
    with torch.no_grad():
        y, reim = fused._fused_mel_fwd_cuda(x, fb, *args, save_spec=True)
        reim = reim.reshape(-1, reim.shape[-1])
        dmel = torch.from_numpy(rng.standard_normal(
            (reim.shape[0], mels)).astype(np.float32)).cuda()

        def bwd(need_dfb):
            return fused._fused_mel_bwd_cuda(dmel, reim, fb, fft, "hann",
                                             None, True, need_dfb)

        for turn in range(2):
            for name, call in (
                    ("forward", lambda: fused._fused_mel_fwd_cuda(
                        x, fb, *args)),
                    ("forward_residual", lambda: fused._fused_mel_fwd_cuda(
                        x, fb, *args, save_spec=True)),
                    ("frame_passes", lambda: bwd(False)),
                    ("backward", lambda: bwd(True))):
                out[f"{name}_ms_{turn}"] = time_cuda_ms(call, 3, 25)
    xg, fbg = x[:, None].clone().requires_grad_(), fb.clone().requires_grad_()
    g = torch.from_numpy(rng.standard_normal(
        (32, 1) + tuple(y.shape[1:])).astype(np.float32)).cuda()

    def fwd_bwd():
        return torch.autograd.grad(
            fused.fused_melspectrogram(xg, fbg, fft, hop), (xg, fbg), g)

    torch.cuda.reset_peak_memory_stats()
    for turn in range(2):
        out[f"fwd_bwd_ms_{turn}"] = time_cuda_ms(fwd_bwd, 3, 15)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    run()
