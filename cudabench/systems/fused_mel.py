"""The fused log-mel layer, ``FusedMelspectrogram``: its build from a
configuration, its calls, its counted work, its lower-precision control
and the numbers that hold it to the plain reference.

Configuration keys: ``args`` (the layer's constructor arguments).
"""
from __future__ import annotations

import torch

from .. import work as W
from ..reference import logmel as R


def build(cfg: dict, gen: torch.Generator, device) -> tuple:
    """The program's layer on ``device``, and what the benchmark made and
    handed to it (nothing: the filterbank is the layer's own)."""
    from torchaudio_contrib_tpu_torch.models.layers import FusedMelspectrogram
    return FusedMelspectrogram(**cfg["args"]).to(device), {}


def frames(cfg: dict, n_samples: int) -> int:
    a = cfg["args"]
    return W.n_frames(n_samples, a["fft_length"], a["hop_length"])


def out_shape(cfg: dict, clips: int, channels: int, n_samples: int):
    return (clips, channels, cfg["args"]["num_mels"], frames(cfg, n_samples))


def work(cfg: dict, streams: int, n_samples: int, mode: str) -> dict:
    """Counted work of one call: ``b1`` (the forward), ``b2`` (the
    backward: both gradients), ``step`` (all operations)."""
    a = cfg["args"]
    shape = (streams, n_samples, a["fft_length"], a["hop_length"],
             a["num_mels"])
    b1 = W.logmel_fwd(*shape)
    if mode == "forward":
        return {"b1": b1, "step": b1[0]}
    b2 = W.logmel_bwd(*shape, need_dx=True, need_dfb=True)
    return {"b1": b1, "b2": b2, "step": b1[0] + b2[0]}


def forward(prog, x):
    return prog(x)


def backward(prog, x, y, g) -> tuple:
    """``(d/dwaveform, d/dfilterbank)`` of ``sum(y * g)``."""
    return torch.autograd.grad(y, (x, prog.filterbank), g)


def ref_filterbank(cfg: dict, like: torch.Tensor) -> torch.Tensor:
    a = cfg["args"]
    fb = R.mel_filterbank(a["num_mels"], a["sample_rate"],
                          a["fft_length"] // 2 + 1, a.get("f_min", 0.0),
                          a.get("f_max"))
    return torch.as_tensor(fb, dtype=like.dtype, device=like.device)


def ref_logmel(cfg: dict, x: torch.Tensor, fb: torch.Tensor):
    a = cfg["args"]
    return R.logmel(x, fb, a["fft_length"], a["hop_length"],
                    a.get("to_db", True), a.get("db_ref", 1.0),
                    a.get("amin", 1e-7))


class Control(torch.nn.Module):
    """The reference in the program's place, in float32 with TF32 on."""

    def __init__(self, cfg: dict, device):
        super().__init__()
        self.cfg = cfg
        self.filterbank = torch.nn.Parameter(
            ref_filterbank(cfg, torch.empty(0, device=device)))
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def forward(self, x):
        return ref_logmel(self.cfg, x, self.filterbank)


def control(cfg: dict, gen, device) -> tuple:
    return Control(cfg, device), {}


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.linalg.norm(a.double() - b) / torch.linalg.norm(b)).item()


def check_forward(cfg: dict, given: dict, kept: list) -> dict:
    """``kept``: ``(key, x, y)`` of calls of the window.  The widest gap in
    dB between the program's log-mel and the float64 reference's."""
    refs, gap = {}, 0.0
    for key, x, y in kept:
        if key not in refs:
            x64 = x.double()
            refs[key] = ref_logmel(cfg, x64, ref_filterbank(cfg, x64))
        gap = max(gap, (y.double() - refs[key]).abs().max().item())
    return {"logmel_db_gap": gap}


def check_grad(cfg: dict, given: dict, kept: list) -> dict:
    """``kept``: ``(key, x, g, y, dx, dfb)``.  The log-mel's widest gap in
    dB, and each gradient's l2 distance from the float64 reference's over
    the reference's l2 norm; the worst call of each."""
    refs = {}
    out = {"logmel_db_gap": 0.0, "dx_gap": 0.0, "dfb_gap": 0.0}
    for key, x, g, y, dx, dfb in kept:
        if key not in refs:
            x64 = x.detach().double().requires_grad_(True)
            fb64 = ref_filterbank(cfg, x64).requires_grad_(True)
            y64 = ref_logmel(cfg, x64, fb64)
            refs[key] = (y64.detach(),
                         *torch.autograd.grad(y64, (x64, fb64), g.double()))
            del x64, fb64, y64
        y64, dx64, dfb64 = refs[key]
        out["logmel_db_gap"] = max(out["logmel_db_gap"],
                                   (y.double() - y64).abs().max().item())
        out["dx_gap"] = max(out["dx_gap"], _rel_l2(dx, dx64))
        out["dfb_gap"] = max(out["dfb_gap"], _rel_l2(dfb, dfb64))
    return out
