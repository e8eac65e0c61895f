"""The ASR path of ``chip_smoke.py`` phase 20 on the card: where a step's
time goes, and how well conditioned its gradient is.

    python -m torchaudio_contrib_tpu_torch.benchmarks.asr_profile

At phase 20's shapes (16 x 10 s at 16 kHz, the fused MFCC, Wav2Letter at
full width with 29 classes, CTC against 60-120 tokens a clip):

1. ``trace_kernels`` of one training step (TF32 off), of ``rnnt_loss``
   forward + backward on logits (8, 250, 101, 1024) and of
   ``ctc_beam_decode`` (beam 16) on the step's emissions: the card's busy
   ms, the traced window and the idle share, the top kernels;
2. CUDA-event ms of the step, of Wav2Letter's forward + backward alone with
   TF32 off and on, and of ``ctc_loss`` forward and forward + backward;
3. step 0's parameter gradients on the card and in float32 on the CPU
   against the same step in float64 on the CPU (the same features):
   per tensor and over the whole gradient, max|diff| / max|float64|, and
   the ReLU inputs whose sign differs between the card and the CPU.

Prints JSON lines with the card's name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import copy
import json

import torch

from . import card, time_cuda_ms, trace_kernels
from .. import ops
from ..models import Wav2Letter

SHAPE = dict(clips=16, samples=160000, classes=29, targets=(60, 120))
MFCC = dict(sample_rate=16000, n_mfcc=13, num_mels=40, fft_length=512,
            hop_length=160)
RNNT = (8, 250, 100, 1024)


def _grads(model) -> dict:
    return {k: p.grad.detach().cpu().double()
            for k, p in model.named_parameters()}


def _errors(got: dict, want: dict) -> dict:
    per = {k: ((got[k] - want[k]).abs().max() / want[k].abs().max()).item()
           for k in want}
    peak = max(v.abs().max().item() for v in want.values())
    whole = max((got[k] - want[k]).abs().max().item() for k in want) / peak
    return {"per_tensor_max": max(per.values()), "whole": whole,
            "per_tensor": per}


def main() -> None:
    name = card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    n, t, classes = SHAPE["clips"], SHAPE["samples"], SHAPE["classes"]
    x = (0.1 * torch.randn((n, t), generator=gen)).cuda()
    lo, hi = SHAPE["targets"]
    tl = torch.randint(lo, hi + 1, (n,), generator=gen)
    tg = torch.randint(1, classes, (n, hi), generator=gen)
    model = Wav2Letter(classes, "mfcc", MFCC["n_mfcc"], device="cpu",
                       generator=gen)
    card_model = copy.deepcopy(model).cuda()
    opt = torch.optim.SGD(card_model.parameters(), lr=0.0)
    tgc, tlc = tg.cuda(), tl.cuda()
    with torch.no_grad():
        feats = ops.mfcc(x, **MFCC, use_fused=True)

    def loss_of(m, f, targets, lengths):
        return ops.ctc_loss(torch.log_softmax(m(f), -1), targets, None,
                            lengths)

    def step():
        with torch.no_grad():
            f = ops.mfcc(x, **MFCC, use_fused=True)
        opt.zero_grad()
        loss_of(card_model, f, tgc, tlc).backward()
        opt.step()

    def model_only():
        card_model.zero_grad()
        torch.log_softmax(card_model(feats), -1).sum().backward()

    trace_kernels(step, calls=2, top=8, part="Wav2Letter CTC step")
    with torch.no_grad():
        lp = torch.log_softmax(card_model(feats), -1)
    lp_g = lp.clone().requires_grad_()
    ms = {"step": time_cuda_ms(step, 1, 3),
          "model_fwd_bwd_tf32_off": time_cuda_ms(model_only, 1, 5),
          "ctc_fwd": time_cuda_ms(lambda: ops.ctc_loss(lp_g, tgc, None, tlc),
                                  1, 3),
          "ctc_fwd_bwd": time_cuda_ms(lambda: ops.ctc_loss(
              lp_g, tgc, None, tlc).backward(), 1, 3)}
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    ms["model_fwd_bwd_tf32_on"] = time_cuda_ms(model_only, 1, 5)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"part": "Wav2Letter CTC step", "ms": ms,
                      "card": name}), flush=True)

    b, frames, u, width = RNNT
    logits = torch.randn((b, frames, u + 1, width), generator=gen).cuda()
    logits.requires_grad_(True)
    rnnt_tg = torch.randint(0, width - 1, (b, u), generator=gen).cuda()

    def rnnt():
        ops.rnnt_loss(logits, rnnt_tg).backward()
        logits.grad = None

    trace_kernels(rnnt, calls=2, top=8, part="rnnt_loss fwd+bwd")
    del logits
    trace_kernels(lambda: ops.ctc_beam_decode(lp, beam_width=16), calls=1,
                  warmup=1, top=8, part="ctc_beam_decode beam 16")

    card_model.zero_grad()
    loss_of(card_model, feats, tgc, tlc).backward()
    f_cpu = feats.cpu()
    loss_of(model, f_cpu, tg, tl).backward()
    m64 = copy.deepcopy(model).double()
    m64.zero_grad()
    loss_of(m64, f_cpu.double(), tg, tl).backward()
    want = _grads(m64)
    flips = []
    with torch.no_grad():
        hc, hcpu = feats, f_cpu
        for layer_c, layer in zip(card_model.acoustic_model,
                                  model.acoustic_model):
            hc, hcpu = layer_c(hc), layer(hcpu)
            if isinstance(layer, torch.nn.Conv1d):
                flips.append(int(((hc.cpu() > 0) != (hcpu > 0)).sum()))
    print(json.dumps({"part": "step 0 gradient vs float64",
                      "card_vs_f64": _errors(_grads(card_model), want),
                      "cpu_f32_vs_f64": _errors(_grads(model), want),
                      "relu_sign_flips_per_conv": flips,
                      "relu_inputs_per_conv": [
                          n * lp.shape[1] * c for c in
                          [250] * 8 + [2000, 2000, classes]],
                      "card": name}), flush=True)


if __name__ == "__main__":
    main()
