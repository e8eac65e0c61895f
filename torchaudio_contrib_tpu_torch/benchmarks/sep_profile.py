"""The separation, assessment and embedding family of ``chip_smoke.py``
phase 24 on the card: where each part's time goes.

    python -m torchaudio_contrib_tpu_torch.benchmarks.sep_profile

``trace_kernels`` with PyTorch's default precision flags (the models pin
their cuDNN calls to FP32), weights from a seeded generator, at phase 24's
shapes:

1. (a) ``HDEMUCS_HIGH_MUSDB`` on 2 stereo 10 s segments at 44.1 kHz and
   ``hdemucs_high()`` on the same mix, under ``torch.inference_mode()``;
2. (b) ``CONVTASNET_BASE_LIBRI2MIX`` on 8 x 10 s at 8 kHz, then one SGD
   step on -SI-SNR against two planted sources;
3. (c) ``SQUIM_OBJECTIVE`` on 8 x 10 s at 16 kHz;
4. (e) a ``hubert_pretrain_base(100)`` step on 8 x 10 s in float32 and
   under ``utils.mixed_precision`` (bfloat16).

Each prints the card's busy ms, the traced window and the idle share, and
its top kernels, as JSON lines with the card's name and power limit; a
last line gives the share of each part's busy time in GroupNorm's row
moments and in the cuDNN RNNs.  Needs a CUDA card.
"""
from __future__ import annotations

import json

import torch

from . import card, trace_kernels
from .. import models, ops, pipelines
from ..utils import mixed_precision


def _noise(gen, *shape):
    return 0.1 * torch.randn(shape, generator=gen).cuda()


def _shares(trace) -> dict:
    busy = trace["busy_ms"]
    norm = sum(ms for k, (ms, _) in trace["kernels"].items()
               if "RowwiseMoments" in k or "GroupNorm" in k)
    rnn = sum(ms for k, (ms, _) in trace["kernels"].items()
              if "RNN" in k or "LSTM" in k)
    return {"groupnorm_share": norm / busy, "rnn_share": rnn / busy}


class LossOf(torch.nn.Module):
    """``forward`` = ``model.loss``, for ``torch.func.functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, *args):
        return self.model.loss(*args)


def main() -> None:
    torch.backends.cudnn.allow_tf32 = True         # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    shares = {}

    def trace(part, call, calls=2):
        with torch.inference_mode():
            shares[part] = _shares(trace_kernels(call, calls=calls, warmup=1,
                                                 top=6, part=part))

    mix = _noise(gen, 2, 2, 441000)
    for part, model in (
            ("HDEMUCS_HIGH_MUSDB", pipelines.HDEMUCS_HIGH_MUSDB
             .get_model(gen)),
            ("hdemucs_high", models.hdemucs_high(generator=gen))):
        trace(part, lambda: model(mix))
        del model

    tasnet = pipelines.CONVTASNET_BASE_LIBRI2MIX.get_model(gen)
    src = _noise(gen, 8, 2, 80000)
    trace("CONVTASNET_BASE_LIBRI2MIX", lambda: tasnet(src.sum(1)))
    opt = torch.optim.SGD(tasnet.parameters(), lr=1e-3)

    def tasnet_step():
        loss = -ops.si_snr(tasnet(src.sum(1)), src).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()

    shares["tasnet step"] = _shares(trace_kernels(
        tasnet_step, calls=1, warmup=1, top=6, part="tasnet step"))
    del tasnet, opt

    squim = pipelines.SQUIM_OBJECTIVE.get_model(gen)
    clips = _noise(gen, 8, 160000)
    trace("SQUIM_OBJECTIVE", lambda: squim(clips))
    del squim

    hubert = LossOf(models.hubert_pretrain_base(100, generator=gen))
    x = _noise(gen, 8, 160000)
    t_out = int(hubert.model.encoder.output_length(160000))
    mask = models.span_mask(gen, 8, t_out, None, device="cuda")
    labels = torch.randint(0, 100, (8, t_out), generator=gen).cuda()
    params = dict(hubert.named_parameters())
    f32 = (lambda p, *a: torch.func.functional_call(hubert, p, a))
    for part, fn in (("hubert step float32", f32),
                     ("hubert step bfloat16", mixed_precision(f32))):
        def step(fn=fn):
            for p in params.values():
                p.grad = None
            fn(params, x, labels, None, mask).backward()
        shares[part] = _shares(trace_kernels(step, calls=1, warmup=1,
                                             top=6, part=part))
    print(json.dumps({"shares": shares, "card": card()}), flush=True)


if __name__ == "__main__":
    main()
