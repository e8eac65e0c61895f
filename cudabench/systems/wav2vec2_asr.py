"""wav2vec 2.0 for CTC serving padded request batches
(``pipelines.WAV2VEC2_ASR_BASE_960H``, ``models.Wav2Vec2``): its build
from a configuration with weights drawn from the seed, its call (model,
log-softmax, greedy CTC decode on the device), its counted work, its
lower-precision control and the numbers that hold it to the plain
reference.

Configuration keys: ``bundle`` (a name in ``pipelines`` whose
``get_model`` builds the model) and ``args`` (the model's constructor
arguments and ``sample_rate``, which the bundle's model must equal).
The weights are the model's own init, drawn on the host from a CPU
``torch.Generator`` seeded with the run's seed; the reference gets the
same ``state_dict``.
"""
from __future__ import annotations

import torch

from .. import work as W
from ..reference import wav2vec2 as R


def _model_args(cfg: dict) -> dict:
    a = {k: v for k, v in cfg["args"].items() if k != "sample_rate"}
    a["extractor_conv_layers"] = tuple(
        tuple(int(v) for v in layer) for layer in a["extractor_conv_layers"])
    return a


def _geometry(model) -> dict:
    return {"extractor_conv_layers": model.extractor,
            "d_model": model.d_model, "num_layers": model.num_layers,
            "num_heads": model.num_heads, "ff_dim": model.ff_dim,
            "pos_conv_kernel": model.pos_k,
            "pos_conv_groups": model.pos_groups, "aux_out": model.aux_out,
            "extractor_mode": model.extractor_mode,
            "conv_bias": model.conv_bias,
            "layer_norm_first": model.layer_norm_first}


def make_model(cfg: dict, gen: torch.Generator, device):
    """The program's model on ``device``, in eval mode, its weights drawn
    from a CPU generator seeded as ``gen``."""
    from torchaudio_contrib_tpu_torch import pipelines
    host = torch.Generator().manual_seed(gen.initial_seed())
    args = _model_args(cfg)
    model = getattr(pipelines, cfg["bundle"]).get_model(host, device=device)
    built = _geometry(model)
    if built != args:
        raise ValueError(f"{cfg['bundle']} builds {built}, the "
                         f"configuration states {args}")
    return model.eval()


def _weights(model) -> dict:
    """The ``state_dict`` the reference takes, copied to the host."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def build(cfg: dict, gen: torch.Generator, device) -> tuple:
    model = make_model(cfg, gen, device)
    return model, _weights(model)


def frames(cfg: dict, n_samples: int) -> int:
    """Encoder frames of one request of ``n_samples`` (20 ms each at
    16 kHz)."""
    return R.output_length(n_samples, cfg["args"]["extractor_conv_layers"])


def work(cfg: dict, lengths, padded: int) -> dict:
    """Counted work of one padded batch: requests of ``lengths`` samples
    padded to ``padded``.  Per request, the work its answer needs: the
    first convolution over the padded length (the GroupNorm after it takes
    its statistics there), the other convolutions, the positional one, the
    products and attention over the request's valid frames alone.  Two
    operations a multiply-add; bytes are the weights once a call and each
    product's input and output once a request (q, k and v read and the
    context written for attention); norms, GELU, softmax and the decode
    are left out, so the bound stays a lower bound.  Keys: ``conv``,
    ``gemm`` (``(flops, bytes)``), ``step`` (all operations)."""
    a = cfg["args"]
    layers = a["extractor_conv_layers"]
    d, f, v = a["d_model"], a["ff_dim"], a["aux_out"]
    k, g, n_layers = a["pos_conv_kernel"], a["pos_conv_groups"], \
        a["num_layers"]
    c_out = layers[-1][0]
    conv_f = gemm_f = 0.0
    conv_b = W.F32 * (sum(c * cin * kk for (c, kk, _), cin in
                          zip(layers, [1] + [l[0] for l in layers[:-1]]))
                      + d * (d // g) * k)
    gemm_b = W.F32 * (c_out * d + n_layers * (4 * d * d + 2 * d * f)
                      + d * v)
    for n in lengths:
        t, cin = None, 1
        for i, (cout, kk, s) in enumerate(layers):
            t_in = padded if i == 0 else t
            t = (t_in - kk) // s + 1
            conv_f += 2.0 * t * cout * cin * kk
            conv_b += W.F32 * (t_in * cin + t * cout)
            if i == 0:
                t = (n - kk) // s + 1          # valid frames from here on
            cin = cout
        t = frames(cfg, n)
        conv_f += 2.0 * t * d * (d // g) * k
        conv_b += W.F32 * 2 * t * d
        per_frame = c_out * d + n_layers * (4 * d * d + 2 * d * f) + d * v
        gemm_f += 2.0 * t * per_frame + n_layers * 4.0 * t * t * d
        gemm_b += W.F32 * t * (c_out + d + n_layers * (12 * d + 2 * f) + v)
    return {"conv": (conv_f, conv_b), "gemm": (gemm_f, gemm_b),
            "step": conv_f + gemm_f}


def forward(prog, x, lengths) -> tuple:
    """One call: ``(emissions, log_probs, out_lengths, tokens,
    token_lengths)``, all on the device."""
    from torchaudio_contrib_tpu_torch.ops import ctc_greedy_decode
    emissions, out_lengths = prog(x, lengths)
    log_probs = emissions.log_softmax(-1)
    tokens, token_lengths, _ = ctc_greedy_decode(log_probs, out_lengths)
    return emissions, log_probs, out_lengths, tokens, token_lengths


class Control:
    """The reference in the program's place, in float32 with TF32 on."""

    def __init__(self, cfg: dict, weights: dict, device):
        self.args = cfg["args"]
        self.p = {k: v.to(device) for k, v in weights.items()}

    def __call__(self, x, lengths):
        return R.forward(self.p, x, lengths, self.args, tf32=True)


def control(cfg: dict, gen, device) -> tuple:
    weights = _weights(make_model(cfg, gen, "cpu"))
    return Control(cfg, weights, device), weights


def check_forward(cfg: dict, given: dict, kept: list) -> dict:
    """``kept``: ``(batch, x, lengths, emissions, log_probs, out_lengths,
    tokens, token_lengths)`` of calls of the window.  The reference runs
    in float64 on the same padded batch with the same weights.  Numbers
    compared:

    * ``emission_gap``: the worst request's l2 distance of its logits from
      the reference's over its valid frames, over the reference's l2 norm
      there;
    * ``decode_gap``: the requests whose output length differs from the
      reference's, or whose tokens or token count differ from the plain
      collapse of the best path (``.max(-1)``) of the log-probabilities
      the program's decode itself took, over the reference's valid
      frames."""
    refs, gaps, decode_gap = {}, [], 0
    p64 = None
    for key, x, lengths, y, logp, out_len, tokens, token_len in kept:
        if key not in refs:
            if p64 is None:
                p64 = {k: v.to(x.device, torch.float64)
                       for k, v in given.items()}
            with torch.no_grad():
                refs[key] = R.forward(p64, x.double(), lengths, cfg["args"])
        ref, ref_len = refs[key]
        path = logp.max(-1).indices
        for i, n in enumerate(ref_len.tolist()):
            want = ref[i, :n]
            gaps.append(torch.linalg.norm(y[i, :n].double() - want)
                        / torch.linalg.norm(want))
            best = R.collapse(path[i, :n])
            got = tokens[i, :int(token_len[i])].tolist()
            decode_gap += int(int(out_len[i]) != n or got != best)
    # the largest gap, or NaN where any is
    emission_gap = torch.stack(gaps).max().item() if gaps else 0.0
    return {"emission_gap": emission_gap, "decode_gap": float(decode_gap)}
