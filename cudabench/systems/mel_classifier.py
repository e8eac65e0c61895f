"""The trainable-front-end classifier, ``MelFrontendClassifier``: its
build from a configuration with weights drawn from the seed, its training
step, its counted work, its lower-precision control and the numbers that
hold it to the plain reference.

Configuration keys: ``args`` (the model's constructor arguments).  The
convolutions' and the head's weights are drawn here, on the device, as
the model initialises them (He-normal convolutions, ``N(0, 1/cin)`` head,
zero biases), and handed to the program and to the reference alike; the
filterbank is each side's own.
"""
from __future__ import annotations

import json
import math
import statistics

import torch

from .. import work as W
from ..reference import mel_cnn as R
from . import fused_mel


def _shapes(cfg: dict) -> dict:
    a = cfg["args"]
    shapes, cin = {}, 1
    for i, cout in enumerate(a["channels"]):
        shapes[f"convs.{i}.weight"] = ((cout, cin, 3, 3),
                                       math.sqrt(2.0 / (9 * cin)))
        shapes[f"convs.{i}.bias"] = ((cout,), 0.0)
        cin = cout
    shapes["head.weight"] = ((a["num_classes"], cin), math.sqrt(1.0 / cin))
    shapes["head.bias"] = ((a["num_classes"],), 0.0)
    return shapes


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """Every weight but the filterbank, from one draw of ``gen``."""
    shapes = _shapes(cfg)
    total = sum(math.prod(s) for s, _ in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, std) in shapes.items():
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * std).reshape(shape)
        at += n
    return out


def build(cfg: dict, gen: torch.Generator, device) -> tuple:
    from torchaudio_contrib_tpu_torch.models.frontend import \
        MelFrontendClassifier
    model = MelFrontendClassifier(**cfg["args"]).to(device)
    weights = make_weights(cfg, gen, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in weights:
                p.copy_(weights[name])
    return model, weights


def frames(cfg: dict, n_samples: int) -> int:
    return fused_mel.frames(cfg, n_samples)


def work(cfg: dict, streams: int, n_samples: int, mode: str) -> dict:
    """Counted work of one training step (``mode`` ``"train"``, the only
    call this system is driven with): ``b1`` (the front end's forward),
    ``b2`` (its backward: the filterbank's gradient alone, the waveform
    takes none), ``step`` (all operations, the convolutions and the head
    included)."""
    if mode != "train":
        raise ValueError(f"no counted work for mode {mode!r}")
    a = cfg["args"]
    fr = frames(cfg, n_samples)
    shape = (streams, n_samples, a["fft_length"], a["hop_length"],
             a["num_mels"])
    cnn = (streams, a["num_mels"], fr, a["channels"], a["num_classes"])
    b1 = W.logmel_fwd(*shape)
    b2 = W.logmel_bwd(*shape, need_dx=False, need_dfb=True)
    return {"b1": b1, "b2": b2,
            "step": b1[0] + b2[0] + W.cnn_fwd_flops(*cnn)
            + W.cnn_bwd_flops(*cnn)}


def params(prog) -> dict:
    return dict(prog.named_parameters())


def train_step(prog, x, labels, lr: float):
    return prog.train_step(x, labels, lr)


def ref_params(cfg: dict, given: dict, like: torch.Tensor) -> dict:
    p = {"frontend.0.filterbank": fused_mel.ref_filterbank(cfg, like)}
    p.update({k: v.to(like.dtype) for k, v in given.items()})
    return {k: p[k] for k in R.param_names(len(cfg["args"]["channels"]))}


class Control:
    """The reference in the program's place, in float32 with TF32 on."""

    def __init__(self, cfg: dict, weights: dict, device):
        self.cfg = cfg
        self.p = {k: v.clone() for k, v in ref_params(
            cfg, weights, torch.empty(0, device=device)).items()}
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def named_parameters(self):
        return iter(self.p.items())

    def train_step(self, x, labels, lr):
        value, g = R.grads(self.p, x, labels, self.cfg)
        with torch.no_grad():
            for k in self.p:
                self.p[k] -= lr * g[k]
        return value


def control(cfg: dict, gen, device) -> tuple:
    weights = make_weights(cfg, gen, device)
    return Control(cfg, weights, device), weights


def _norms(d: dict) -> dict:
    return {k: torch.linalg.norm(v.double()).item() for k, v in d.items()}


def check_train(cfg: dict, given: dict, rec: dict) -> dict:
    """``rec``: the program's parameters before the first step (``p0``),
    after it (``p1``) and after the third (``p3``), the three losses, the
    batches and ``lr``.  The reference takes the same three steps in
    float64 from the same weights.  Numbers compared:

    * ``loss_gap``: the relative gap of the first step's loss;
    * ``grad_gap``: the first gradient as the optimizer got it, ``(p0 -
      p1) / lr``, by the worst leaf: the gap between the program's and the
      reference's l2 norms, over the larger of the reference's norm of
      that leaf and of the median leaf;
    * ``change_gap``: the same gap for ``p3 - p0`` of the median leaf,
      over the leaves whose reference gradient is at least 1e-3 of the
      median leaf's.

    The later steps' losses and the worst leaf's change are printed beside
    them and not compared: once the first step has turned thousands of
    filterbank entries negative, some mels cancel towards zero and the
    dB's ``1/mel`` makes the filterbank's later steps, and the third
    step's loss, differ by up to its whole size between any two float32
    computations and float64, the plain reference in float32 included."""
    lr = rec["lr"]
    x0 = rec["batches"][0][0]
    p0r = ref_params(cfg, given, x0.double())
    batches = [(x.double(), y) for x, y in rec["batches"]]
    losses, g1, p3r = R.sgd_steps(p0r, batches, lr, cfg)
    loss_gaps = [abs(a - b.item()) / abs(b.item())
                 for a, b in zip(rec["losses"], losses)]
    gp = _norms({k: (rec["p0"][k].double() - rec["p1"][k].double()) / lr
                for k in p0r})
    gr = _norms(g1)
    g_med = statistics.median(gr.values())
    grad_gap = max(abs(gp[k] - gr[k]) / max(gr[k], g_med) for k in gr)
    live = [k for k in gr if gr[k] >= 1e-3 * g_med]
    dp = _norms({k: rec["p3"][k].double() - rec["p0"][k].double()
                for k in live})
    dr = _norms({k: p3r[k] - p0r[k] for k in live})
    d_med = statistics.median(dr.values())
    change = {k: abs(dp[k] - dr[k]) / max(dr[k], d_med) for k in live}
    print(json.dumps({"not_compared": {"loss_gap_by_step": loss_gaps,
                                       "change_gap_by_leaf": change}}),
          flush=True)
    return {"loss_gap": loss_gaps[0], "grad_gap": grad_gap,
            "change_gap": statistics.median(change.values())}
