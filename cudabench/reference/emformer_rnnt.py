"""Plain Emformer-RNNT (torchaudio's ``emformer_rnnt_base`` layout; Shi et
al. 2021, arXiv:2010.10759; Graves 2012, arXiv:1211.3711) over whole
utterances: the feature extractor, the encoder with block masks, the
layer-norm LSTM predictor, the joiner and greedy decoding.

* Features: ``center=True`` STFT (periodic Hann, reflect padding of
  ``fft // 2``), power, an HTK mel product (no area normalisation, 0 Hz to
  Nyquist), times the int16 gain ``32767²``, then torchaudio's
  piecewise-linear log (``log x`` above ``e``, ``x / e`` below).  An
  utterance of ``n`` samples has ``1 + n // hop`` frames, of which the
  first ``stride · ((1 + n // hop) // stride)`` are its frames (whole
  reduced frames).
* Encoder: a bias-free input linear, frames stacked ``stride`` at a time,
  then Emformer layers over the whole utterance at once.  The reduced
  frames fall into segments of ``segment_length``; each segment has its
  own copies of the ``right_context_length`` frames after it (those inside
  the utterance), which pass through every layer as that segment's rows.
  A row of segment ``i`` (its frames or its copies) attends to the
  ``left_context_length`` frames before the segment, to the segment's
  frames and to its own copies, all layer-normed (``layer_norm_input``);
  the layer is ``x + out_proj(attention)``, then ``+ FFN`` (LayerNorm,
  linear, exact GELU, linear), then ``layer_norm_output``.  An output
  linear and a LayerNorm close it.  The memory bank is left out: the
  configuration's ``max_memory_size`` is 0.
* Predictor: embedding, LayerNorm, LSTM cells whose summed gates
  ``x2g(x) + p2g(h)`` (no biases) and updated cell are layer-normed
  (``lstm_layer_norm_eps``), gates in the order i, f, g, o, then linear
  and LayerNorm; blank doubles as the start token.
* Joiner: ``linear(relu(encoding + prediction))``.
* Greedy: at most ``max_symbols`` symbols a frame, the frame left at the
  first blank.

Parameters are a dict under the measured model's ``state_dict`` names.
Every function runs in the dtype of its input and its parameters: float64
for the reference.  It imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .logmel import hann, mel_filterbank

GAIN = float(32767 ** 2)
LN_EPS = 1e-5


def utterance_frames(n_samples, args: dict):
    """The utterance's frames: whole reduced frames of ``1 + n // hop``."""
    s = args["time_reduction_stride"]
    return s * ((1 + n_samples // args["hop_length"]) // s)


def features(x: torch.Tensor, args: dict) -> torch.Tensor:
    """``x (n,)`` → ``(1 + n // hop, n_mels)``."""
    n_fft, hop = args["fft_length"], args["hop_length"]
    padded = F.pad(x[None, None], (n_fft // 2, n_fft // 2),
                   mode="reflect")[0, 0]
    spec = torch.stft(padded, n_fft, hop, window=hann(n_fft, x),
                      center=False, onesided=True, return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2               # (bins, frames)
    fb = torch.as_tensor(mel_filterbank(args["n_mels"], args["sample_rate"],
                                        n_fft // 2 + 1), dtype=x.dtype,
                         device=x.device)
    m = (power.T @ fb) * GAIN
    return torch.where(m > math.e, torch.log(m.clamp(min=math.e)),
                       m / math.e)


def _ln(x, p, name, eps=LN_EPS):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], eps)


def _linear(x, p, name):
    b = p.get(name + ".bias")
    y = x @ p[name + ".weight"].T
    return y if b is None else y + b


def _block_mask(T: int, args: dict, device):
    """Rows: the utterance's reduced frames, then each segment's copies of
    the frames after it.  Returns (the copies' frame indices, the
    ``(rows, rows)`` mask of the keys each row sees)."""
    S, L, R = (args["segment_length"], args["left_context_length"],
               args["right_context_length"])
    nseg = -(-T // S)
    seg = torch.arange(T, device=device) // S
    frame = torch.arange(T, device=device)
    copy_seg = torch.arange(nseg, device=device).repeat_interleave(R)
    copy_pos = (copy_seg + 1) * S + torch.arange(R, device=device).repeat(
        nseg)
    keep = copy_pos < T
    copy_seg, copy_pos = copy_seg[keep], copy_pos[keep]
    row_seg = torch.cat([seg, copy_seg])
    is_frame = torch.cat([torch.ones_like(seg, dtype=torch.bool),
                          torch.zeros_like(copy_seg, dtype=torch.bool)])
    key_pos = torch.cat([frame, copy_pos])
    q = row_seg[:, None]
    same = row_seg[None] == q
    left = (is_frame[None] & (key_pos[None] >= q * S - L)
            & (key_pos[None] < q * S))
    return copy_pos, same | left


def encode(p: dict, feats: torch.Tensor, args: dict) -> torch.Tensor:
    """``feats (T_in, n_mels)``, ``T_in`` a multiple of the stride →
    encodings ``(T_in / stride, encoding_dim)``."""
    s = args["time_reduction_stride"]
    y = _linear(feats, p, "transcriber.input_linear")
    x = y.reshape(-1, y.shape[-1] * s)
    T, d = x.shape
    h = args["num_heads"]
    dh = d // h
    copy_pos, mask = _block_mask(T, args, x.device)
    rows = torch.cat([x, x[copy_pos]])
    for i in range(args["num_layers"]):
        pre = f"transcriber.transformer.emformer_layers.{i}."
        n = _ln(rows, p, pre + "layer_norm_input")
        q = _linear(n, p, pre + "attention.emb_to_query")
        k, v = _linear(n, p, pre + "attention.emb_to_key_value").chunk(2, -1)
        q, k, v = (t.reshape(-1, h, dh).transpose(0, 1) for t in (q, k, v))
        logits = (q @ k.transpose(1, 2)) / math.sqrt(dh)
        w = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        ctx = (w @ v).transpose(0, 1).reshape(-1, d)
        rows = rows + _linear(ctx, p, pre + "attention.out_proj")
        f = _ln(rows, p, pre + "pos_ff.0")
        f = _linear(F.gelu(_linear(f, p, pre + "pos_ff.1")), p,
                    pre + "pos_ff.4")
        rows = _ln(rows + f, p, pre + "layer_norm_output")
    out = _linear(rows[:T], p, "transcriber.output_linear")
    return _ln(out, p, "transcriber.layer_norm")


def predictions(p: dict, tokens: torch.Tensor, args: dict) -> torch.Tensor:
    """``tokens (B, U)`` → the predictor's outputs ``(B, U + 1, J)``:
    position ``u`` has seen the start token and ``tokens[:, :u]``."""
    blank = args["blank"]
    eps = args["lstm_layer_norm_eps"]
    B = tokens.shape[0]
    seq = torch.cat([torch.full((B, 1), blank, dtype=torch.long,
                                device=tokens.device), tokens], 1)
    emb = p["predictor.embedding.weight"]
    xs = _ln(emb[seq], p, "predictor.input_layer_norm")
    hid = args["predictor_hidden_dim"]
    state = [(xs.new_zeros(B, hid), xs.new_zeros(B, hid))
             for _ in range(args["predictor_layers"])]
    outs = []
    for u in range(seq.shape[1]):
        x = xs[:, u]
        for i, (hh, c) in enumerate(state):
            pre = f"predictor.lstm_layers.{i}."
            g = _ln(_linear(x, p, pre + "x2g") + _linear(hh, p, pre + "p2g"),
                    p, pre + "g_norm", eps)
            gi, gf, gg, go = g.chunk(4, -1)
            c = _ln(torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg),
                    p, pre + "c_norm", eps)
            hh = torch.sigmoid(go) * torch.tanh(c)
            state[i] = (hh, c)
            x = hh
        outs.append(x)
    out = _linear(torch.stack(outs, 1), p, "predictor.linear")
    return _ln(out, p, "predictor.output_layer_norm")


def join(p: dict, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return _linear(torch.relu(enc + pred), p, "joiner.linear")


def greedy(p: dict, enc: torch.Tensor, args: dict,
           max_symbols: int) -> torch.Tensor:
    """Greedy decoding of one utterance's ``enc (T, J)`` → the ``(T,
    max_symbols)`` grid of symbols emitted (blank where none).  The
    predictor runs over the whole prefix at each decision: plain, and
    quadratic in the symbols emitted."""
    blank = args["blank"]
    tokens = torch.zeros((1, 0), dtype=torch.long, device=enc.device)
    grid = torch.full((enc.shape[0], max_symbols), blank, dtype=torch.long)
    for t in range(enc.shape[0]):
        for k in range(max_symbols):
            pred = predictions(p, tokens, args)[0, -1]
            tok = int(join(p, enc[t], pred).argmax())
            if tok == blank:
                break
            grid[t, k] = tok
            tokens = torch.cat([tokens, tokens.new_full((1, 1), tok)], 1)
    return grid


def decisions(grid: torch.Tensor, blank: int) -> tuple:
    """The decoder's decisions along a grid of emitted symbols ``(T,
    max_symbols)``: ``(frames, prefix lengths, tokens taken)``, one a
    symbol emitted and one a frame left at a blank (a frame that emits
    ``max_symbols`` symbols is left without one)."""
    frames, prefix, taken = [], [], []
    u = 0
    for t, row in enumerate(grid.tolist()):
        for tok in row:
            frames.append(t)
            prefix.append(u)
            taken.append(tok)
            if tok == blank:
                break
            u += 1
    return frames, prefix, taken
