"""The Emformer-RNNT serving concurrent streams a segment a call
(``pipelines.EMFORMER_RNNT_BASE_LIBRISPEECH``, ``models.RNNTStreamPool``):
its build from a configuration with weights drawn from the seed, its
lower-precision control, its counted work and the numbers that hold it to
the plain reference.

Configuration keys: ``bundle`` (a name in ``pipelines`` whose
``get_model`` builds the model and whose ``get_stream_pool`` serves it)
and ``args`` (the geometry the bundle's model must have, the extractor's
``sample_rate``, ``n_mels``, ``fft_length`` and ``hop_length``, and
``max_symbols``, the greedy decode's symbols a frame).  The weights are
the model's own init, drawn on the host from a CPU ``torch.Generator``
seeded with the run's seed; the reference gets the same ``state_dict``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import work as W
from ..reference import emformer_rnnt as R
from ..reference.logmel import tf32

# decisions whose reference logits' top two lie closer than this are ties:
# float32 moves a logit by ~1e-5 at most here (PERF.md, section 2)
TIE = 1e-4


def _geometry(model) -> dict:
    tr, pr = model.transcriber, model.predictor
    em = tr.transformer
    cell = pr.lstm_layers[0]
    return {"time_reduction_input_dim": tr.input_linear.out_features,
            "time_reduction_stride": tr.stride, "d_model": em.d,
            "num_layers": em.n_layers, "num_heads": em.h,
            "ffn_dim": em.emformer_layers[0].pos_ff[1].out_features,
            "left_context_length": em.L, "segment_length": em.S,
            "right_context_length": em.R, "max_memory_size": em.M,
            "encoding_dim": tr.output_linear.out_features,
            "predictor_embed_dim": pr.embedding.embedding_dim,
            "predictor_hidden_dim": pr.h, "predictor_layers": pr.n_layers,
            "lstm_layer_norm_eps": cell.g_norm.eps,
            "num_symbols": model.v, "blank": model.blank}


def make_model(cfg: dict, gen: torch.Generator, device):
    """The program's model on ``device``, in eval mode, its weights drawn
    from a CPU generator seeded as ``gen``."""
    from torchaudio_contrib_tpu_torch import pipelines
    host = torch.Generator().manual_seed(gen.initial_seed())
    bundle = getattr(pipelines, cfg["bundle"])
    model = bundle.get_model(host, device=device).eval()
    built = _geometry(model)
    want = {k: cfg["args"][k] for k in built}
    extractor = {"sample_rate": bundle.sample_rate, "n_mels": bundle.n_mels,
                 "hop_length": bundle.hop_length}
    if built != want or any(cfg["args"][k] != v
                            for k, v in extractor.items()):
        raise ValueError(f"{cfg['bundle']} builds {built} with "
                         f"{extractor}, the configuration states "
                         f"{cfg['args']}")
    return bundle, model


def _weights(model) -> dict:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def build(cfg: dict, gen: torch.Generator, device) -> tuple:
    """``(program, weights)``; the program's stream pool is made for the
    caller's slot count (``Program.open``)."""
    bundle, model = make_model(cfg, gen, device)
    return Program(bundle, model, cfg["args"]["max_symbols"]), \
        _weights(model)


class Program:
    """The bundle's stream pool, made for a slot count on first use."""

    tf32 = False

    def __init__(self, bundle, model, max_symbols: int):
        self.bundle, self.model = bundle, model
        self.max_symbols = max_symbols
        self.pool = None

    def open(self, slots: int):
        self.pool = self.bundle.get_stream_pool(self.model, slots,
                                                self.max_symbols)
        return self

    def step(self, audio, start, length, segment, reset, mark=None):
        with tf32(self.tf32):
            return self.pool.step(audio, start, length, segment, reset,
                                  mark)


class Control(Program):
    """The program with cuBLAS and cuDNN in TF32: the nearest precision
    below the configuration's float32, in the program's place."""

    tf32 = True


def control(cfg: dict, gen, device) -> tuple:
    bundle, model = make_model(cfg, gen, device)
    return Control(bundle, model, cfg["args"]["max_symbols"]), \
        _weights(model)


def utterance_frames(cfg: dict, n_samples):
    return R.utterance_frames(n_samples, cfg["args"])


def work(cfg: dict, utt, rc, seen) -> dict:
    """Counted work of one call from per-slot host arrays: ``utt`` and
    ``rc`` the segment's utterance and lookahead frames (input units),
    ``seen`` the utterance frames before the segment.  What the model
    needs: the input linear and the features once a frame; in each layer,
    the projections and the FFN of each new row once (the segment's frames
    and its lookahead copies, which every layer recomputes by design), keys
    and values of a left-context row counted at the step it was new; the
    attention products over the left context (up to its length), the
    segment and the copies; the output linear once a frame; and
    ``max_symbols`` joiner and predictor steps a reduced frame (with random
    weights the greedy decode emits in nearly every round: PERF.md).  Two
    operations a multiply-add; bytes are the weights once a call and each
    product's input and output once.  Keys: ``gemm`` (``(flops, bytes)``),
    ``step`` (all operations, the features' FFTs and mel product too)."""
    a = cfg["args"]
    s = a["time_reduction_stride"]
    d, f, layers = a["d_model"], a["ffn_dim"], a["num_layers"]
    e, v, k = a["encoding_dim"], a["num_symbols"], a["max_symbols"]
    hid, emb = a["predictor_hidden_dim"], a["predictor_embed_dim"]
    n_mels, din = a["n_mels"], a["time_reduction_input_dim"]
    u = np.asarray(utt) // s
    r = np.asarray(rc) // s
    lc = np.minimum(a["left_context_length"], np.asarray(seen) // s)
    rows = float((u + r).sum())
    pairs = float(((u + r) * (lc + u + r)).sum())
    frames_in, frames = float(np.asarray(utt).sum()), float(u.sum())
    per_row = 2.0 * (4 * d * d + 2 * d * f)
    cell = 2.0 * 4 * hid * (emb + hid)
    pred = cell + 2.0 * 4 * hid * 2 * hid * (a["predictor_layers"] - 1) \
        + 2.0 * hid * e
    rounds = k * frames
    gemm_f = (2.0 * frames_in * n_mels * din + layers * rows * per_row
              + layers * 4.0 * d * pairs + 2.0 * frames * d * e
              + rounds * (2.0 * e * v + pred))
    weights = (n_mels * din + layers * (4 * d * d + 2 * d * f) + d * e
               + e * v + 4 * hid * (emb + hid)
               + 4 * hid * 2 * hid * (a["predictor_layers"] - 1) + hid * e)
    gemm_b = W.F32 * (weights + frames_in * (n_mels + din)
                      + layers * rows * (10 * d + 2 * f)
                      + frames * (d + e)
                      + rounds * (2 * e + v + 6 * hid
                                  + 8 * hid * a["predictor_layers"]))
    n_fft = a["fft_length"]
    feat_f = frames_in * (W.fft_flops(n_fft)
                          + 2.0 * (n_fft // 2 + 1) * n_mels)
    return {"gemm": (gemm_f, gemm_b), "step": gemm_f + feat_f}


def check_stream(cfg: dict, given: dict, kept: list) -> dict:
    """``kept``: ``(audio, encodings, grid)`` of whole utterances the
    program streamed: the utterance's samples, its encodings ``(T, J)``
    and its grid of symbols ``(T, max_symbols)`` as the calls returned
    them.  The reference runs in float64 on the card over each whole
    utterance with the same weights.  Numbers compared:

    * ``enc_gap``: the worst utterance's l2 distance of its encodings from
      the reference's over the reference's l2 norm;
    * ``decode_gap``: the decisions (a symbol emitted, or a frame left at
      a blank) where the program's token is not the argmax of the
      reference's joiner logits, taken along the program's own path (the
      reference's predictor fed the program's symbols), counted only where
      the reference's top two logits lie at least ``TIE`` apart."""
    if not kept:
        return {"enc_gap": float("nan"), "decode_gap": float("nan")}
    a = cfg["args"]
    dev = kept[0][0].device
    p = {k: v.to(dev, torch.float64) for k, v in given.items()}
    gaps, refs, paths = [], [], []
    with torch.no_grad():
        for audio, enc, grid in kept:
            x = audio.double()
            frames = int(R.utterance_frames(x.shape[0], a))
            ref = R.encode(p, R.features(x, a)[:frames], a)
            gaps.append(torch.linalg.norm(enc.double() - ref)
                        / torch.linalg.norm(ref))
            refs.append(ref)
            paths.append(R.decisions(grid.cpu(), a["blank"]))
        longest = max(sum(tok != a["blank"] for tok in taken)
                      for _, _, taken in paths)
        tokens = torch.full((len(kept), longest), a["blank"],
                            dtype=torch.long, device=dev)
        for b, (_, _, taken) in enumerate(paths):
            emitted = [tok for tok in taken if tok != a["blank"]]
            tokens[b, :len(emitted)] = torch.tensor(emitted,
                                                    dtype=torch.long)
        preds = R.predictions(p, tokens, a)
        decode_gap = 0
        for b, (frames, prefix, taken) in enumerate(paths):
            for lo in range(0, len(taken), 4096):
                t = torch.tensor(frames[lo:lo + 4096], device=dev)
                u = torch.tensor(prefix[lo:lo + 4096], device=dev)
                got = torch.tensor(taken[lo:lo + 4096], device=dev)
                logits = R.join(p, refs[b][t], preds[b, u])
                top = logits.topk(2, -1)
                clear = (top.values[:, 0] - top.values[:, 1]) >= TIE
                decode_gap += int(((top.indices[:, 0] != got)
                                   & clear).sum())
    return {"enc_gap": torch.stack(gaps).max().item(),
            "decode_gap": float(decode_gap)}
