"""The multi-device layer of ``chip_smoke.py`` phase 26 (c) and (d) on the
card: where the sequence-parallel and pipelined runs spend their time
against the models' own forwards.

    python -m torchaudio_contrib_tpu_torch.benchmarks.md_profile

``trace_kernels`` on a one-rank NCCL mesh (``parallel.make_mesh()``),
weights from a seeded generator, at phase 26's shapes, each part under
``torch.inference_mode()`` (the pipeline under ``torch.no_grad()``):

1. ``WAV2VEC2_ASR_BASE_960H``'s model on 2 x 60 s at 16 kHz, and
   ``sp_wav2vec2_apply`` of it on the same batch;
2. the house ``Conformer`` at ``conformer_rnnt_base``'s encoder width (d
   256, 16 layers, 4 heads, kernel 31) on 8 x 250 frames, and
   ``sp_conformer_apply`` of it;
3. the model's 12 encoder layers on (8, 500, 768) in sequence, and
   ``pipeline_apply(model.encoder_layer)`` over them in 8 microbatches.

Each prints its top kernels and a summary (busy ms, the traced window,
the idle share) as JSON lines with the card's name and power limit, then a
line of its busy time by kind of kernel (GEMMs, softmax, element-wise,
reductions, copies and concatenations, collectives, the rest) and its
launches per call.  Needs a CUDA card.
"""
from __future__ import annotations

import json

import torch

from . import card, trace_kernels
from .. import parallel as par
from ..models import Conformer
from ..pipelines import WAV2VEC2_ASR_BASE_960H

#: phase 26's shapes (``chip_smoke.MULTI``)
SHAPES = dict(sp_w2v2=(2, 960000), sp_conf=(8, 250),
              conf=dict(input_dim=320, d_model=256, num_layers=16,
                        num_heads=4, ff_ratio=4, conv_kernel=31,
                        convolution_first=True),
              pp=(8, 500), micro=8)

_KINDS = (("gemm", ("gemm", "xmma", "cutlass", "matmul", "cublas")),
          ("softmax", ("softmax", "SoftMax")),
          ("collective", ("nccl",)),
          ("copy_cat", ("copy", "cat", "Cat", "memcpy", "Memcpy")),
          ("reduce", ("reduce", "Reduce")),
          ("elementwise", ("elementwise", "Elementwise", "vectorized")))


def _kinds(trace) -> dict:
    out = {kind: 0.0 for kind, _ in _KINDS}
    out["other"] = 0.0
    for name, (ms, _) in trace["kernels"].items():
        for kind, keys in _KINDS:
            if any(k in name for k in keys):
                out[kind] += ms
                break
        else:
            out["other"] += ms
    return out


def main() -> None:
    name = card()
    gen = torch.Generator().manual_seed(0)
    mesh = par.make_mesh()

    def trace(part, call, no_grad=False):
        with torch.no_grad() if no_grad else torch.inference_mode():
            t = trace_kernels(call, calls=2, warmup=1, top=8, part=part)
        print(json.dumps({"part": part, "launches_per_call": sum(
            n for _, n in t["kernels"].values()),
            "busy_ms_by_kind": _kinds(t), "card": name}), flush=True)

    model = WAV2VEC2_ASR_BASE_960H.get_model(gen, device="cuda").eval()
    b, t = SHAPES["sp_w2v2"]
    x = 0.1 * torch.randn((b, t), generator=gen).cuda()
    trace("w2v2_forward", lambda: model(x))
    trace("sp_wav2vec2_apply",
          lambda: par.sp_wav2vec2_apply(model, x, mesh=mesh))
    del x

    conf = Conformer(**SHAPES["conf"], device="cpu", generator=gen).cuda()
    conf.eval()
    cb, ct = SHAPES["sp_conf"]
    f = torch.randn((cb, ct, SHAPES["conf"]["input_dim"]),
                    generator=gen).cuda()
    trace("conformer_forward", lambda: conf(f))
    trace("sp_conformer_apply",
          lambda: par.sp_conformer_apply(conf, f, mesh=mesh))
    del conf, f

    from torch.distributed.device_mesh import DeviceMesh
    pipe = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("pipe",))
    layers = list(model.encoder.layers)
    stacked = par.pipeline_shard(par.stack_pipeline(layers, 1), pipe)
    pb, pt = SHAPES["pp"]
    acts = torch.randn((pb, pt, model.d_model), generator=gen).cuda()

    def sequential():
        y = acts
        for layer in layers:
            y = model.encoder_layer(layer, y)
        return y

    trace("layers_in_sequence", sequential, no_grad=True)
    trace("pipeline_apply", lambda: par.pipeline_apply(
        model.encoder_layer, stacked, acts, mesh=pipe,
        n_microbatches=SHAPES["micro"]), no_grad=True)


if __name__ == "__main__":
    main()
