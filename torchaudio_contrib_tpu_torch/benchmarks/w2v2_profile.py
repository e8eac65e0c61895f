"""The wav2vec2 family of ``chip_smoke.py`` phase 22 on the card: where a
served batch's and a fine-tuning step's time goes.

    python -m torchaudio_contrib_tpu_torch.benchmarks.w2v2_profile

``trace_kernels`` (TF32 off) of, at phase 22's shapes, with weights from a
seeded generator:

1. (a) ``WAV2VEC2_ASR_BASE_960H`` serving 8 requests of 4-16 s at 16 kHz
   in one padded batch with ``lengths``, under ``torch.inference_mode()``;
   then the same batch's feature extractor alone (the 7 strided convs) and
   its positional conv alone (kernel 128, 16 groups);
2. (b) one SGD step of the same model on ``ctc_loss`` over 8 x 10 s with
   60-120 target tokens a clip.

Each prints the card's busy ms, the traced window and the idle share, and
its top kernels, as JSON lines with the card's name and power limit.  The
busy time is a sum over kernels, and cuDNN runs the positional conv as 16
kernels, one a group, at once: their sum exceeds the window (a negative
idle share).  So a last line gives the extractor's and the positional
conv's shares of (a) from CUDA-event times of the three calls (median of
7).  Needs a CUDA card.
"""
from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from . import card, time_cuda_ms, trace_kernels
from ..ops import ctc_loss
from ..pipelines import WAV2VEC2_ASR_BASE_960H as BUNDLE

SR = 16000
REQUEST_SECONDS = (4.0, 5.7, 7.4, 9.1, 10.9, 12.6, 14.3, 16.0)
TRAIN = dict(clips=8, seconds=10, targets=(60, 120), lr=1e-5)


def serving_batch(gen: torch.Generator):
    """``(waveforms (8, 16 s), lengths)``: noise, zero past each length."""
    lengths = torch.tensor([int(s * SR) for s in REQUEST_SECONDS])
    x = 0.1 * torch.randn((len(lengths), int(lengths.max())), generator=gen)
    x = x * (torch.arange(x.shape[1])[None] < lengths[:, None])
    return x, lengths


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    model = BUNDLE.get_model(gen).eval()
    x, lengths = serving_batch(gen)
    x, lengths = x.cuda(), lengths.cuda()
    with torch.inference_mode():
        feats = model._extract(x)
        pos_in = F.pad(torch.randn(feats.shape[0], model.d_model,
                                   feats.shape[1], device="cuda"),
                       (model.pos_k // 2, (model.pos_k - 1) // 2))
        fwd = trace_kernels(lambda: model(x, lengths), calls=3, warmup=2,
                            top=8, part="(a) 8 requests, 4-16 s, forward")
        ext = trace_kernels(lambda: model._extract(x), calls=3, warmup=1,
                            top=4, part="(a) the feature extractor alone")
        pos = trace_kernels(
            lambda: model.encoder.pos_conv_embed.conv(pos_in), calls=3,
            warmup=1, top=3, part="(a) the positional conv alone")
        times = {name: time_cuda_ms(call) for name, call in (
            ("forward", lambda: model(x, lengths)),
            ("extractor", lambda: model._extract(x)),
            ("pos_conv", lambda: model.encoder.pos_conv_embed.conv(pos_in)))}

    n, secs = TRAIN["clips"], TRAIN["seconds"]
    lo, hi = TRAIN["targets"]
    xt = (0.1 * torch.randn((n, secs * SR), generator=gen)).cuda()
    tl = torch.randint(lo, hi + 1, (n,), generator=gen).cuda()
    tg = torch.randint(1, 29, (n, hi), generator=gen).cuda()
    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=TRAIN["lr"])

    def step():
        logits, out_len = model(xt)
        loss = ctc_loss(torch.log_softmax(logits, -1), tg, out_len, tl)
        opt.zero_grad()
        loss.backward()
        opt.step()

    trace_kernels(step, calls=2, warmup=1, top=8,
                  part="(b) CTC fine-tuning SGD step, 8 x 10 s")
    print(json.dumps({
        "part": "(a) shares of the forward's time (CUDA events)",
        **{f"{k}_ms": v for k, v in times.items()},
        "extractor_share": times["extractor"] / times["forward"],
        "pos_conv_share": times["pos_conv"] / times["forward"],
        "summed_busy_ms": {"forward": fwd["busy_ms"],
                           "extractor": ext["busy_ms"],
                           "pos_conv": pos["busy_ms"]},
        "card": card()}), flush=True)


if __name__ == "__main__":
    main()
