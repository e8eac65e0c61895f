"""The transducer family of ``chip_smoke.py`` phase 21 on the card: where a
streamed segment's and a training step's time goes.

    python -m torchaudio_contrib_tpu_torch.benchmarks.transducer_profile

``trace_kernels`` (TF32 off) of, at phase 21's shapes:

1. one segment (16 + 4 input frames of 4 streams) of the Emformer-RNNT
   bundle (``EMFORMER_RNNT_BASE_LIBRISPEECH``, weights from a seeded
   generator) through ``stream_greedy_step``, replayed from the state after
   10 segments (``infer`` leaves its state as it was, so every call does
   the same work);
2. the same segment through ``stream_transcribe`` alone, and through
   ``stream_transcribe`` + ``RNNTBeamSearch.infer_batched`` (beam 8);
3. one SGD step of ``conformer_rnnt_base`` on ``RNNT.loss`` (8 x 10 s of
   the bundle's features, 60-100 target tokens).

Each prints the card's busy ms, the traced window and the idle share, and
its top kernels, as JSON lines with the card's name and power limit.
Needs a CUDA card.
"""
from __future__ import annotations

import torch

from . import trace_kernels
from ..models import conformer_rnnt_base
from ..pipelines import EMFORMER_RNNT_BASE_LIBRISPEECH as BUNDLE

STREAMS, SECONDS, SR, BEAM, MAX_SYMBOLS = 4, 10, 16000, 8, 4
TRAIN = dict(clips=8, targets=(60, 100), symbols=1024, lr=1e-5)


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    model = BUNDLE.get_model(gen).eval()
    extract = BUNDLE.get_feature_extractor()
    S, R = BUNDLE.segment_length, BUNDLE.right_context_length
    search = BUNDLE.get_decoder(model, beam_width=BEAM)
    wave = 0.1 * torch.randn((STREAMS, SECONDS * SR), generator=gen)
    with torch.inference_mode():
        feats = extract(wave.cuda())
        state = model.init_stream_state(STREAMS)
        for i in range(10):
            state = model.stream_greedy_step(feats[:, S * i:S * i + S + R],
                                             state, MAX_SYMBOLS)[2]
        chunk = feats[:, 10 * S:11 * S + R]
        t_red = feats.shape[1] // BUNDLE.time_reduction_stride
        carry = search.init_batched_state(STREAMS, t_red * MAX_SYMBOLS)

        def greedy():
            model.stream_greedy_step(chunk, state, MAX_SYMBOLS)[0].cpu()

        def encoder():
            model.stream_transcribe(chunk, state["enc"])[0].cpu()

        def beam():
            f, ol, _ = model.stream_transcribe(chunk, state["enc"])
            search.infer_batched(f, ol, carry)

        for name, call in (("greedy", greedy), ("encoder", encoder),
                           ("beam", beam)):
            trace_kernels(call, calls=3, warmup=2, top=5,
                          part=f"segment of {STREAMS} streams: {name}")

    lo, hi = TRAIN["targets"]
    n = TRAIN["clips"]
    with torch.no_grad():
        x = extract((0.1 * torch.randn((n, SECONDS * SR),
                                       generator=gen)).cuda())
    tl = torch.randint(lo, hi + 1, (n,), generator=gen).cuda()
    tg = torch.randint(1, TRAIN["symbols"], (n, hi), generator=gen).cuda()
    net = conformer_rnnt_base(TRAIN["symbols"], generator=gen)
    opt = torch.optim.SGD(net.parameters(), lr=TRAIN["lr"])

    def step():
        loss = net.loss(x, tg, None, tl)
        opt.zero_grad()
        loss.backward()
        opt.step()

    trace_kernels(step, calls=2, warmup=1, top=8,
                  part="conformer_rnnt_base SGD step, 8 x 10 s")


if __name__ == "__main__":
    main()
