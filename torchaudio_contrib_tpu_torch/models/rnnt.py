"""RNN-T (transducer) models: predictors, joiner, the model, greedy and
beam decoding.

Port of ``torchaudio_contrib_tpu/models/rnnt.py`` (Graves 2012).  The
transcriber is any module whose ``forward(x, lengths)`` returns
encodings or ``(encodings, lengths)``; :class:`~.emformer.Emformer`,
:class:`~.emformer.EmformerTranscriber` (streaming, with ``init_state`` /
``infer``) and :class:`~.conformer.ConformerTranscriber` qualify.

* A predictor's ``step`` is its one cell, used by decoding; ``forward``
  runs it over a label sequence (the plain predictor with ``nn.LSTM``).
  Blank doubles as the start-of-sequence token, so ``forward`` returns
  ``U + 1`` label contexts.  A predictor's state is a list of ``(h, c)``
  a layer.
* :meth:`RNNT.greedy_decode` walks the frames in a Python loop with
  ``max_symbols`` rounds a frame, masked where a sample is done (the JAX
  package's ``lax.scan`` of the same rounds): the ``(B, T, max_symbols)``
  grid of emissions is the same, and each round is a few launches.
* :class:`RNNTBeamSearch` has the JAX package's two paths: hypotheses
  kept on the host with the predictor and joiner batched on the device
  (``__call__``, ``infer``), and a fixed-width beam on the device
  (``decode_batched``, ``infer_batched``: top-K over K·V candidates,
  equal label sequences merged by logsumexp into their first occurrence,
  empty slots at ``-inf``).  ``torch.topk`` may order equal scores
  otherwise than ``lax.top_k``; the finite n-best is the same.
* Streaming: :meth:`RNNT.stream_greedy_step` (:meth:`RNNT.stream_encode`
  then :meth:`RNNT.stream_decode`) advances every stream of a batch by one
  chunk; :meth:`RNNT.reset_stream_slots` starts chosen streams afresh on
  the device, so a batch's streams may begin at different steps.
  :class:`RNNTStreamPool` serves a fixed number of slots from raw audio,
  its state in buffers of its own and its step replayed from two CUDA
  graphs (the port's own: the JAX package has none).

``state_dict`` names are torchaudio's ``models.RNNT``: ``transcriber``,
``predictor`` (``embedding``, ``input_layer_norm``,
``lstm_layers.{i}.{x2g,p2g,g_norm,c_norm}``, ``linear``,
``output_layer_norm`` for the layer-norm predictor) and
``joiner.linear``; ``enc_proj`` where the model has one (torchaudio's
Emformer-RNNT has none: build it with ``enc_proj=False``).  Modules take
``device=`` (the card unless the caller asks for the CPU) and
``generator=`` for their initial weights.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import _step_graph
from ._common import _dense, _fp32_cudnn, _glorot_
from ..ops.rnnt import rnnt_loss_fused
from ..utils import trace
from ..utils.trace import span

__all__ = ["RNNTPredictor", "LayerNormLSTMPredictor", "RNNT",
           "RNNTBeamSearch", "RNNTStreamPool"]


def _state_map(fn, *states):
    """``fn`` over the tensors of predictor states (lists of ``(h, c)``)."""
    return [tuple(fn(*xs) for xs in zip(*layers)) for layers in zip(*states)]


class _Predictor(nn.Module):
    """What both predictors share: the state, and ``forward`` as ``step``
    over the SOS-prefixed sequence."""

    def _device(self) -> torch.device:
        return self.embedding.weight.device

    def init_state(self, batch_size: int, device=None) -> list:
        dev = self._device() if device is None else device
        return [(torch.zeros((batch_size, self.h), device=dev),
                 torch.zeros((batch_size, self.h), device=dev))
                for _ in range(self.n_layers)]

    def _sos(self, targets: torch.Tensor) -> torch.Tensor:
        targets = torch.as_tensor(targets, device=self._device()).long()
        sos = torch.full((targets.shape[0], 1), self.blank,
                         dtype=torch.long, device=targets.device)
        return torch.cat([sos, targets], 1)


class RNNTPredictor(_Predictor):
    """LSTM label predictor: embedding → ``nn.LSTM`` (gates i, f, g, o;
    the JAX model's one bias is ``bias_ih``, ``bias_hh`` starts at 0) →
    LayerNorm → linear.  ``forward(targets (B, U))`` → ``(B, U+1, O)``:
    position ``u`` encodes ``y_1..y_u``, position 0 the SOS alone.
    Positions past a row's length depend on its padding and carry no
    contract (the loss masks them)."""

    def __init__(self, num_symbols: int, embed_dim: int, hidden_dim: int,
                 output_dim: int, num_layers: int = 1, blank: int = 0, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.h = hidden_dim
        self.n_layers = num_layers
        self.blank = blank
        self.embedding = nn.Embedding(num_symbols, embed_dim)
        with torch.no_grad():
            self.embedding.weight.normal_(generator=generator).mul_(0.1)
        self.lstm = nn.LSTM(embed_dim, hidden_dim, num_layers,
                            batch_first=True)
        cin = embed_dim
        for i in range(num_layers):
            _glorot_(getattr(self.lstm, f"weight_ih_l{i}"), cin,
                     4 * hidden_dim, generator)
            _glorot_(getattr(self.lstm, f"weight_hh_l{i}"), hidden_dim,
                     4 * hidden_dim, generator)
            nn.init.zeros_(getattr(self.lstm, f"bias_ih_l{i}"))
            nn.init.zeros_(getattr(self.lstm, f"bias_hh_l{i}"))
            cin = hidden_dim
        self.layer_norm = nn.LayerNorm(hidden_dim)
        self.linear = _dense(hidden_dim, output_dim, generator)
        self.to(device)

    def step(self, tokens: torch.Tensor, state: list):
        """One step: ``tokens (B,)`` → ``(out (B, O), state)``."""
        x = self.embedding(tokens)
        new_state = []
        for i, (h, c) in enumerate(state):
            gates = (F.linear(x, getattr(self.lstm, f"weight_ih_l{i}"),
                              getattr(self.lstm, f"bias_ih_l{i}"))
                     + F.linear(h, getattr(self.lstm, f"weight_hh_l{i}"),
                                getattr(self.lstm, f"bias_hh_l{i}")))
            gi, gf, gg, go = gates.chunk(4, -1)
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
            new_state.append((h, c))
            x = h
        return self.linear(self.layer_norm(x)), new_state

    @_fp32_cudnn
    def forward(self, targets: torch.Tensor, target_lengths=None):
        y, _ = self.lstm(self.embedding(self._sos(targets)))
        return self.linear(self.layer_norm(y))


class _CustomLSTM(nn.Module):
    """torchaudio's ``_CustomLSTM`` cell: ``x2g`` (bias only without layer
    norm), bias-free ``p2g``, a LayerNorm over the summed gates and one
    over the updated cell (``eps`` both); the normed cell is both the
    carry and the tanh input."""

    def __init__(self, cin: int, h: int, layer_norm: bool, eps: float,
                 generator):
        super().__init__()
        self.x2g = _dense(cin, 4 * h, generator, bias=not layer_norm)
        self.p2g = _dense(h, 4 * h, generator, bias=False)
        if layer_norm:
            self.g_norm = nn.LayerNorm(4 * h, eps=eps)
            self.c_norm = nn.LayerNorm(h, eps=eps)
        else:
            self.g_norm = self.c_norm = nn.Identity()

    def forward(self, x, h, c):
        gi, gf, gg, go = self.g_norm(self.x2g(x) + self.p2g(h)).chunk(4, -1)
        c = self.c_norm(torch.sigmoid(gf) * c
                        + torch.sigmoid(gi) * torch.tanh(gg))
        return torch.sigmoid(go) * torch.tanh(c), c


class LayerNormLSTMPredictor(_Predictor):
    """torchaudio's ``_Predictor``: embedding → ``input_layer_norm`` → a
    stack of :class:`_CustomLSTM` s → dropout → ``linear`` →
    ``output_layer_norm``.  ``layer_norm_eps`` is the cells' (1e-3 in the
    Emformer-RNNT bundle); the input and output norms keep 1e-5.
    ``dropout`` acts in training mode, as torchaudio's ``lstm_dropout``
    (the JAX model has none; the default 0 is the same model).  Same
    interface as :class:`RNNTPredictor`."""

    def __init__(self, num_symbols: int, embed_dim: int, hidden_dim: int,
                 output_dim: int, num_layers: int = 3, blank: int = 0,
                 layer_norm: bool = True, layer_norm_eps: float = 1e-5,
                 dropout: float = 0.0, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.h = hidden_dim
        self.n_layers = num_layers
        self.blank = blank
        self.embedding = nn.Embedding(num_symbols, embed_dim)
        with torch.no_grad():
            self.embedding.weight.normal_(generator=generator).mul_(0.1)
        self.input_layer_norm = nn.LayerNorm(embed_dim)
        self.lstm_layers = nn.ModuleList(
            _CustomLSTM(embed_dim if i == 0 else hidden_dim, hidden_dim,
                        layer_norm, layer_norm_eps, generator)
            for i in range(num_layers))
        self.dropout = nn.Dropout(dropout)
        self.linear = _dense(hidden_dim, output_dim, generator)
        self.output_layer_norm = nn.LayerNorm(output_dim)
        self.to(device)

    def _out(self, x):
        return self.output_layer_norm(self.linear(self.dropout(x)))

    def step(self, tokens: torch.Tensor, state: list):
        """One step: ``tokens (B,)`` → ``(out (B, O), state)``."""
        x = self.input_layer_norm(self.embedding(tokens))
        new_state = []
        for cell, (h, c) in zip(self.lstm_layers, state):
            h, c = cell(x, h, c)
            new_state.append((h, c))
            x = h
        return self._out(x), new_state

    def forward(self, targets: torch.Tensor, target_lengths=None):
        seq = self.input_layer_norm(self.embedding(self._sos(targets)))
        state = self.init_state(seq.shape[0])
        outs = []
        for u in range(seq.shape[1]):
            x = seq[:, u]
            for i, cell in enumerate(self.lstm_layers):
                x, c = cell(x, *state[i])
                state[i] = (x, c)
            outs.append(x)
        return self._out(torch.stack(outs, 1))


class _Joiner(nn.Module):
    """torchaudio's ``_Joiner``: ``linear(activation(enc + pred))``."""

    def __init__(self, joiner_dim: int, num_symbols: int, activation,
                 generator):
        super().__init__()
        self.linear = _dense(joiner_dim, num_symbols, generator)
        self.activation = activation

    def forward(self, enc, pred):
        return self.linear(self.activation(enc + pred))


class RNNT(nn.Module):
    """Transducer = transcriber ∘ predictor ∘ joiner.

    ``forward(x, targets, lengths, target_lengths)`` = :meth:`joint_logits`
    → ``(logits (B, T, U+1, V), out_lengths)``, ready for
    ``ops.rnnt_loss``; :meth:`loss` takes the fused path."""

    def __init__(self, transcriber: nn.Module, num_symbols: int,
                 encoding_dim: int, joiner_dim: int = 0,
                 predictor_embed_dim: int = 64,
                 predictor_hidden_dim: int = 128,
                 predictor_layers: int = 1, blank: int = 0,
                 joiner_activation: str = "tanh",
                 predictor: Optional[nn.Module] = None,
                 enc_proj: bool = True, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if joiner_activation not in ("tanh", "relu"):
            raise ValueError("joiner_activation must be tanh or relu")
        self.v = num_symbols
        self.blank = blank
        joiner_dim = joiner_dim or encoding_dim
        if not enc_proj and joiner_dim != encoding_dim:
            raise ValueError("without enc_proj the encodings must be "
                             "joiner_dim wide")
        self.act = torch.tanh if joiner_activation == "tanh" else torch.relu
        self.transcriber = transcriber
        # a custom predictor (LayerNormLSTMPredictor) must expose
        # init_state/step/forward and emit joiner_dim-wide encodings; the
        # predictor_* sizes are ignored then
        self.predictor = predictor if predictor is not None \
            else RNNTPredictor(num_symbols, predictor_embed_dim,
                               predictor_hidden_dim, joiner_dim,
                               predictor_layers, blank, device="cpu",
                               generator=generator)
        self.enc_proj = _dense(encoding_dim, joiner_dim, generator) \
            if enc_proj else None
        self.joiner = _Joiner(joiner_dim, num_symbols, self.act, generator)
        self.to(device)

    # -- pieces -----------------------------------------------------------
    def _project(self, feats):
        return feats if self.enc_proj is None else self.enc_proj(feats)

    def transcribe(self, x: torch.Tensor, lengths=None):
        """``x`` → ``(encodings (B, T', J), out_lengths)``."""
        out = self.transcriber(x, lengths)
        if isinstance(out, tuple):
            feats, out_lengths = out
        else:
            feats = out
            out_lengths = torch.as_tensor(lengths, device=x.device) \
                if lengths is not None else torch.full(
                    (x.shape[0],), feats.shape[1], dtype=torch.long,
                    device=x.device)
        return self._project(feats), out_lengths

    def join(self, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """``enc (..., J)`` + ``pred (..., J)`` → logits ``(..., V)``;
        broadcasting them is the caller's job."""
        return self.joiner(enc, pred)

    def joint_logits(self, x, targets, lengths=None, target_lengths=None):
        enc, out_lengths = self.transcribe(x, lengths)
        pred = self.predictor(targets, target_lengths)
        return self.join(enc[:, :, None], pred[:, None]), out_lengths

    forward = joint_logits

    def loss(self, x, targets, lengths=None, target_lengths=None, *,
             time_chunk=None, **kw):
        """Transducer loss through ``ops.rnnt_loss_fused``: the ``(B, T,
        U+1, V)`` joint is computed ``time_chunk`` frames at a time under
        ``torch.utils.checkpoint`` and never stored (``None``: ``max(4,
        512 // B)``).  ``kw`` forwards blank/clamp/reduction."""
        enc, out_lengths = self.transcribe(x, lengths)
        pred = self.predictor(targets, target_lengths)
        kw.setdefault("blank", self.blank)
        lin = self.joiner.linear
        return rnnt_loss_fused(
            enc, pred, {"w": lin.weight.t(), "b": lin.bias}, targets,
            act=self.act, logit_lengths=out_lengths,
            target_lengths=target_lengths, time_chunk=time_chunk, **kw)

    # -- greedy decoding ----------------------------------------------------
    def greedy_init_state(self, batch_size: int, device=None):
        """The greedy carry (last predictor output, predictor state),
        primed with the SOS step; carried through successive
        :meth:`_greedy_on_enc` calls, chunkwise decoding equals one-shot
        decoding by construction."""
        dev = self.joiner.linear.weight.device if device is None else device
        return self.predictor.step(
            torch.full((batch_size,), self.blank, dtype=torch.long,
                       device=dev),
            self.predictor.init_state(batch_size, dev))

    @torch.no_grad()
    def _greedy_on_enc(self, enc, out_lengths, max_symbols: int, carry):
        B, T = enc.shape[:2]
        pred, state = carry
        out_lengths = torch.as_tensor(out_lengths, device=enc.device)
        blank = torch.full((B,), self.blank, dtype=torch.long,
                           device=enc.device)
        grid = []
        for t in range(T):
            done = out_lengths <= t
            toks = []
            for _ in range(max_symbols):
                tok = self.join(enc[:, t], pred).argmax(-1)
                emit = ~done & (tok != self.blank)
                toks.append(torch.where(emit, tok, blank))
                new_pred, new_state = self.predictor.step(tok, state)
                m = emit[:, None]
                pred = torch.where(m, new_pred, pred)
                state = _state_map(lambda n, o: torch.where(m, n, o),
                                   new_state, state)
                done = done | ~emit
            grid.append(torch.stack(toks, 1))
        grid = torch.stack(grid, 1) if grid else torch.full(
            (B, 0, max_symbols), self.blank, dtype=torch.long,
            device=enc.device)
        return grid, (pred, state)

    def greedy_decode(self, x, lengths=None, max_symbols: int = 4,
                      compact: bool = True):
        """Greedy transducer decoding: a list of token lists a sample
        (``compact=True``) or the ``(B, T', max_symbols)`` grid of
        emissions (blank = none)."""
        with torch.no_grad():
            enc, out_lengths = self.transcribe(x, lengths)
        grid, _ = self._greedy_on_enc(enc, out_lengths, max_symbols,
                                      self.greedy_init_state(enc.shape[0]))
        if not compact:
            return grid
        return [[t for t in row if t != self.blank]
                for row in grid.reshape(grid.shape[0], -1).tolist()]

    # -- streaming ----------------------------------------------------------
    def init_stream_state(self, batch_size: int) -> dict:
        """The transcriber's streaming state, the greedy carry, and the
        carry a stream starts from (``dec_init``, kept for
        :meth:`reset_stream_slots`); the transcriber must have
        ``init_state``/``infer``."""
        if not hasattr(self.transcriber, "init_state"):
            raise TypeError(
                "streaming needs a transcriber with init_state/infer "
                f"(got {type(self.transcriber).__name__})")
        pred, carry = self.greedy_init_state(batch_size)
        # its own tensors: a pool updates the carry in place
        fresh = (pred.clone(), _state_map(torch.clone, carry))
        return {"enc": self.transcriber.init_state(batch_size),
                "dec": (pred, carry), "dec_init": fresh}

    def reset_stream_slots(self, state: dict, mask: torch.Tensor) -> dict:
        """A new state in which the streams where ``mask (B,)`` is set are
        fresh (their encoder state what ``init_state`` gives, their greedy
        carry what :meth:`greedy_init_state` gives) and the others are
        unchanged bit for bit: one masked select a tensor, no host sync,
        so that a server starts an utterance in a recycled slot inside a
        CUDA graph."""
        with span("rnnt.reset"):
            m = mask[:, None]

            def pick(fresh, kept):
                return torch.where(m, fresh, kept)
            (pred0, carry0), (pred, carry) = state["dec_init"], state["dec"]
            return {"enc": self.transcriber.reset_state(state["enc"], mask),
                    "dec": (pick(pred0, pred),
                            _state_map(pick, carry0, carry)),
                    "dec_init": state["dec_init"]}

    def stream_transcribe(self, chunk, enc_state, **infer_kwargs):
        """One transcriber step and the projection: ``chunk`` in the
        transcriber's ``infer`` format → ``(feats (B, S, J), out_lengths,
        enc_state)``."""
        feats, out_lengths, enc_state = self.transcriber.infer(
            chunk, enc_state, **infer_kwargs)
        return self._project(feats), out_lengths, enc_state

    @torch.no_grad()
    def stream_encode(self, chunk, state: dict, reset=None, **infer_kwargs):
        """The first half of :meth:`stream_greedy_step`: the streams where
        ``reset`` is set started afresh (:meth:`reset_stream_slots`), then
        one transcriber step → ``(feats, out_lengths, state)``, the state's
        greedy carry not yet advanced."""
        if reset is not None:
            state = self.reset_stream_slots(state, reset)
        with span("rnnt.encode"):
            feats, out_lengths, enc = self.stream_transcribe(
                chunk, state["enc"], **infer_kwargs)
        return feats, out_lengths, dict(state, enc=enc)

    def stream_decode(self, feats, out_lengths, state: dict,
                      max_symbols: int = 4):
        """The second half: greedy decoding of one chunk's encodings →
        ``(grid (B, S, max_symbols), state)``."""
        with span("rnnt.decode"):
            grid, dec = self._greedy_on_enc(feats, out_lengths, max_symbols,
                                            state["dec"])
        return grid, dict(state, dec=dec)

    def stream_greedy_step(self, chunk, state: dict, max_symbols: int = 4,
                           reset=None, **infer_kwargs):
        """Streaming greedy decoding, one chunk a call → ``(grid (B, S,
        max_symbols), out_lengths, state)``; every chunk fed reproduces
        :meth:`greedy_decode`'s grid.  ``reset (B,)`` bool starts the
        streams where it is set afresh before the chunk (a new utterance
        in a recycled slot; :meth:`reset_stream_slots`)."""
        feats, out_lengths, state = self.stream_encode(chunk, state, reset,
                                                       **infer_kwargs)
        grid, state = self.stream_decode(feats, out_lengths, state,
                                         max_symbols)
        return grid, out_lengths, state


class RNNTStreamPool:
    """``slots`` concurrent streams of one transducer, each advanced by one
    segment a call and decoded greedily, with every stream's state held on
    the device in buffers of its own: a streaming ASR server's step.

    ``step(audio, start, length, segment, reset)`` takes ``audio (N,)`` on
    the model's device, holding every slot's current utterance, and per
    slot on the host: where its utterance lies in ``audio`` (``start``,
    ``length`` samples), which segment of it this call advances
    (``segment``), and whether the utterance begins in this call
    (``reset``: the slot's state starts afresh, on the device).  It
    returns ``(grid (slots, S', max_symbols), out_lengths, encodings
    (slots, S', J))`` for the segment, ``S'`` its encoder frames.

    A slot's features at segment ``i`` are frames ``S·i … S·i + S + R −
    1`` of its whole utterance's features as ``extractor`` computes them
    (``center=True``, ``fft_length`` and ``hop_length`` its own): the
    window of samples the extractor is given reaches ``fft_length // 2``
    past each side of them, and the utterance's own edges are padded by
    reflection, as the whole utterance's computation pads them, so that the
    streamed encodings are the whole utterance's.  An utterance has
    ``stride · ((1 + length // hop) // stride)`` frames (whole reduced
    frames); the segments it does not fill and the lookahead past its end
    are masked (``utt_lengths``, ``rc_lengths``).

    A step is two stages, ``encode`` (the window, the features, the
    resets, ``Emformer.infer`` and the projection) and ``decode`` (the
    greedy frames and symbols), replayed from two CUDA graphs on the card
    from a signature's second call on (``_step_graph.run_stages``).  The
    step counts ``trace.RNNT_VALID_FRAMES`` (utterance frames advanced) and
    ``trace.RNNT_SLOT_RESETS`` (utterances begun) from the host's
    arguments.  ``mark``, if given, is called with each stage's name as
    it begins and with None after the last, in the order the card runs
    them (a caller timing the stages records a CUDA event there)."""

    STAGING = 4      # pinned host buffers the per-slot arguments cycle

    def __init__(self, model: RNNT, extractor: nn.Module, slots: int, *,
                 fft_length: int, hop_length: int, max_symbols: int = 4):
        tr = model.transcriber
        if not hasattr(tr, "stride"):
            raise TypeError("RNNTStreamPool needs an EmformerTranscriber-"
                            f"like transcriber (got {type(tr).__name__})")
        self.model, self.extractor = model, extractor
        self.slots, self.max_symbols = int(slots), int(max_symbols)
        self.hop, self.stride = int(hop_length), tr.stride
        self.S, self.R = tr.S_in, tr.R_in
        # frames of the window before the segment's first: its samples
        # reach fft_length // 2 before that frame's centre
        self.lead = -(-(fft_length // 2) // self.hop)
        self.window = (self.hop * (self.lead + self.S + self.R - 1)
                       + fft_length // 2)
        self.device = model.joiner.linear.weight.device
        with torch.no_grad():
            self.state = model.init_stream_state(self.slots)
        self._staged, self._turn = [], 0

    def frames(self, length) -> torch.Tensor:
        """Utterance frames of ``length`` samples (whole reduced frames)."""
        n = torch.as_tensor(length).long()
        return self.stride * ((1 + n // self.hop) // self.stride)

    def _meta(self, start, length, segment, reset) -> torch.Tensor:
        """The per-slot arguments and the frames they imply as one
        ``(6, slots)`` long tensor on the device, counted on the host."""
        start, length, segment = (torch.as_tensor(v).long()
                                  for v in (start, length, segment))
        reset = torch.as_tensor(reset).long()
        frames = self.frames(length)
        utt = (frames - self.S * segment).clamp(0, self.S)
        rc = (frames - self.S * (segment + 1)).clamp(0, self.R)
        meta = torch.stack([start, length, segment, utt, rc, reset])
        trace.RNNT_VALID_FRAMES += int(utt.sum())
        trace.RNNT_SLOT_RESETS += int(reset.sum())
        if self.device.type != "cuda":
            return meta.to(self.device)
        # a pinned buffer is written again only once its copy has run
        if len(self._staged) < self.STAGING:
            self._staged.append((torch.empty(meta.shape, dtype=meta.dtype,
                                             pin_memory=True),
                                 torch.cuda.Event()))
        host, done = self._staged[self._turn]
        self._turn = (self._turn + 1) % self.STAGING
        done.synchronize()
        host.copy_(meta)
        out = host.to(self.device, non_blocking=True)
        done.record()
        return out

    def _windows(self, audio, start, length, segment):
        """Each slot's window of samples, its utterance's edges reflected
        (``torch.nn.functional.pad``'s ``reflect``)."""
        pos = (segment[:, None] * (self.S * self.hop) - self.lead * self.hop
               + torch.arange(self.window, device=audio.device))
        last = length[:, None] - 1
        pos = torch.where(pos < 0, -pos, pos)
        pos = torch.where(pos > last, 2 * last - pos, pos)
        # past the reflected margin: frames masked as past the utterance
        pos = torch.minimum(pos.clamp(min=0), last)
        return audio[start[:, None] + pos]

    def _encode(self, audio, meta):
        start, length, segment, utt, rc, reset = meta.unbind(0)
        with span("rnnt.features"):
            x = self._windows(audio, start, length, segment)
            chunk = self.extractor(x)[:, self.lead:self.lead + self.S
                                      + self.R]
        feats, out_lengths, state = self.model.stream_encode(
            chunk, self.state, reset.bool(), utt_lengths=utt,
            rc_lengths=rc)
        _copy_into(self.state, state)
        return feats, out_lengths

    def _decode(self, feats, out_lengths):
        grid, state = self.model.stream_decode(feats, out_lengths,
                                               self.state, self.max_symbols)
        _copy_into(self.state["dec"], state["dec"])
        return grid, out_lengths, feats

    def _held(self):
        return (*self.model.parameters(), *self.model.buffers(),
                *self.extractor.buffers(), *_leaves(self.state))

    def step(self, audio: torch.Tensor, start, length, segment, reset,
             mark=None):
        with span("rnnt.step"), torch.no_grad():
            meta = self._meta(start, length, segment, reset)
            return _step_graph.run_stages(
                self, (("encode", functools.partial(self._encode, audio)),
                       ("decode", self._decode)),
                (meta,), (audio, *self._held()), "rnnt", mark)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for item in items for t in _leaves(item)]


def _copy_into(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst``, a state of the
    same structure (dicts, lists and tuples)."""
    for d, s in zip(_leaves(dst), _leaves(src)):
        if d is not s:
            d.copy_(s)


class RNNTBeamSearch:
    """Time-synchronous transducer beam search.

    Each frame runs up to ``max_symbols`` expansion rounds: every
    hypothesis is scored against all symbols; blank extensions become the
    frame's final candidates, the best non-blank extensions go on to the
    next round; equal label sequences merge by ``logaddexp``.  Returns the
    ``beam_width`` best hypotheses, ``[(tokens, score), ...]`` a sample.
    """

    def __init__(self, model: RNNT, beam_width: int = 8,
                 max_symbols: int = 4):
        self.model = model
        self.beam = beam_width
        self.max_symbols = max_symbols

    def _join(self, enc, pred):
        return torch.log_softmax(self.model.join(enc, pred), -1)

    # -- host path ----------------------------------------------------------
    @torch.no_grad()
    def __call__(self, x, lengths=None) -> List[List[Tuple[List[int],
                                                              float]]]:
        enc, out_lengths = self.model.transcribe(x, lengths)
        out = []
        for b, n in enumerate(out_lengths.tolist()):
            hyps, cache = self._init_hyps(enc.device)
            hyps, _ = self._advance(enc[b], n, hyps, cache)
            out.append(self._ranked(hyps))
        return out

    def init_state(self, batch_size: int, device=None) -> list:
        """Host decode state: a (hypotheses, predictor cache) pair a
        sample."""
        dev = self.model.joiner.linear.weight.device if device is None \
            else device
        return [self._init_hyps(dev) for _ in range(batch_size)]

    @torch.no_grad()
    def infer(self, feats, out_lengths, states):
        """The host beam over one chunk of projected encodings
        (``model.stream_transcribe``): ``feats (B, S, J)`` → (ranked
        hypotheses so far, new states); every chunk fed reproduces
        ``__call__``."""
        results, new_states = [], []
        for b, ((hyps, cache), n) in enumerate(
                zip(states, torch.as_tensor(out_lengths).tolist())):
            hyps, cache = self._advance(feats[b], n, hyps, cache)
            new_states.append((hyps, cache))
            results.append(self._ranked(hyps))
        return results, new_states

    @staticmethod
    def _ranked(hyps):
        return [(list(h[0]), float(h[1]))
                for h in sorted(hyps, key=lambda h: -h[1])]

    def _init_hyps(self, device):
        pred0, state0 = self.model.predictor.step(
            torch.full((1,), self.model.blank, dtype=torch.long,
                       device=device),
            self.model.predictor.init_state(1, device))
        # hyp = (tokens, score, predictor output (J,), state)
        hyps = [((), 0.0, pred0[0], _state_map(lambda a: a[0], state0))]
        # the predictor's output and state depend on the tokens alone, so
        # one cache serves every frame
        return hyps, {(): (hyps[0][2], hyps[0][3])}

    def _advance(self, enc, T, hyps, cache):
        blank = self.model.blank

        def _merge(d, key, val):
            d[key] = np.logaddexp(d[key], val) if key in d else val

        for t in range(T):
            finals = {}
            enc_t = enc[t][None]
            active = hyps
            for _ in range(self.max_symbols):
                if not active:
                    break
                lp = self._join(enc_t, torch.stack([h[2] for h in active]))
                lp = lp.cpu().numpy()
                nxt = {}
                for h, row in zip(active, lp):
                    _merge(finals, h[0], h[1] + float(row[blank]))
                    # only the top `beam` non-blank tokens can survive
                    k = min(self.beam + 1, row.size)
                    part = np.argpartition(row, row.size - k)[-k:]
                    kept = 0
                    for tok in part[np.argsort(row[part])[::-1]]:
                        if tok == blank:
                            continue
                        cand = h[0] + (int(tok),)
                        sc = h[1] + float(row[tok])
                        if cand in nxt:
                            nxt[cand] = (np.logaddexp(nxt[cand][0], sc),
                                         nxt[cand][1])
                        else:
                            nxt[cand] = (sc, h)
                        kept += 1
                        if kept >= self.beam:
                            break
                top = sorted(nxt.items(), key=lambda kv: -kv[1][0]
                             )[:self.beam]
                if not top:
                    # a blank-only vocabulary: these hypotheses' blank
                    # closes are merged already
                    active = []
                    break
                toks = torch.tensor([c[-1] for c, _ in top],
                                    device=enc.device)
                state = _state_map(lambda *a: torch.stack(a),
                                   *[v[1][3] for _, v in top])
                pred_out, new_state = self.model.predictor.step(toks, state)
                active = [(c, v[0], pred_out[i],
                           _state_map(lambda a, i=i: a[i], new_state))
                          for i, (c, v) in enumerate(top)]
                for h in active:
                    cache[h[0]] = (h[2], h[3])
            # the last round's survivors close with a blank too
            if active:
                lp = self._join(enc_t, torch.stack([h[2] for h in active]))
                for h, row in zip(active, lp.cpu().numpy()):
                    _merge(finals, h[0], h[1] + float(row[blank]))
            best = sorted(finals.items(), key=lambda kv: -kv[1]
                          )[:self.beam]
            hyps = [(key, score) + cache[key] for key, score in best] \
                or hyps
        # keep the cache to the sequences still alive
        return hyps, {h[0]: (h[2], h[3]) for h in hyps}

    # -- fixed-width beam on the device -------------------------------------
    def init_batched_state(self, batch_size: int, max_tokens: int,
                           device=None) -> dict:
        """The device beam's carry: slot 0 the empty hypothesis (score
        0), the other slots at ``-inf``."""
        K, B = self.beam, batch_size
        dev = self.model.joiner.linear.weight.device if device is None \
            else device
        with torch.no_grad():
            pred0, state0 = self.model.predictor.step(
                torch.full((B,), self.model.blank, dtype=torch.long,
                           device=dev),
                self.model.predictor.init_state(B, dev))
        scores = torch.full((B, K), -torch.inf, device=dev)
        scores[:, 0] = 0.0
        return {
            "scores": scores,
            "toks": torch.zeros((B, K, max_tokens), dtype=torch.long,
                                device=dev),
            "lens": torch.zeros((B, K), dtype=torch.long, device=dev),
            "pred": pred0[:, None].expand(-1, K, -1),
            "state": _state_map(lambda a: a[:, None].expand(-1, K, -1),
                                state0),
        }

    @staticmethod
    def _gather(a, idx):
        """``a (B, K, ...)`` at slots ``idx (B, K')`` along axis 1."""
        idx = idx.reshape(idx.shape + (1,) * (a.ndim - 2))
        return a.gather(1, idx.expand(idx.shape[:2] + a.shape[2:]))

    def _frame_step(self, carry: dict, enc_t, valid) -> dict:
        """Every sample's beam one frame on (batch and beam at once)."""
        K, blank = self.beam, self.model.blank
        B, _, L = carry["toks"].shape
        J = carry["pred"].shape[-1]
        g = self._gather

        def close(act):
            logp = self._join(enc_t[:, None], act["pred"])
            return act["scores"] + logp[..., blank], logp

        finals = []
        act = carry
        for _ in range(self.max_symbols):
            closed, logp = close(act)
            finals.append({**act, "scores": closed})
            # non-blank extensions: top-K over K·V candidates
            ext = act["scores"][..., None] + logp             # (B, K, V)
            ext[..., blank] = -torch.inf
            # a full token buffer takes no further symbol
            ext = ext.masked_fill((act["lens"] >= L)[..., None], -torch.inf)
            V = ext.shape[-1]
            top, idx = torch.topk(ext.reshape(B, K * V), K)
            parent = idx // V
            tok = idx % V
            lens = act["lens"].gather(1, parent)
            hit = torch.arange(L, device=lens.device) == lens[..., None]
            toks = torch.where(hit, tok[..., None], g(act["toks"], parent))
            state = _state_map(lambda a: g(a, parent).reshape(B * K, -1),
                               act["state"])
            pred_new, state_new = self.model.predictor.step(
                tok.reshape(B * K), state)
            act = {"scores": top, "toks": toks,
                   "lens": (lens + 1).clamp(max=L),
                   "pred": pred_new.reshape(B, K, J),
                   "state": _state_map(lambda a: a.reshape(B, K, -1),
                                       state_new)}
        closed, _ = close(act)                        # the post-loop close
        finals.append({**act, "scores": closed})

        f = {k: torch.cat([d[k] for d in finals], 1)
             for k in ("scores", "toks", "lens", "pred")}
        f["state"] = _state_map(lambda *a: torch.cat(a, 1),
                                *[d["state"] for d in finals])
        F_ = f["scores"].shape[1]
        # merge equal label sequences (the host `_merge`): equality of
        # (length, buffer), the mass to the first occurrence, later ones
        # to -inf
        eq = ((f["lens"][:, :, None] == f["lens"][:, None, :])
              & (f["toks"][:, :, None] == f["toks"][:, None]).all(-1))
        merged = torch.logsumexp(
            torch.where(eq, f["scores"][:, None, :], -torch.inf), -1)
        below = torch.ones((F_, F_), dtype=torch.bool,
                           device=eq.device).tril(-1)
        first = ~(eq & below).any(-1)
        top, sel = torch.topk(torch.where(first, merged, -torch.inf), K)
        new = {"scores": top, "toks": g(f["toks"], sel),
               "lens": f["lens"].gather(1, sel), "pred": g(f["pred"], sel),
               "state": _state_map(lambda a: g(a, sel), f["state"])}
        # padded frames leave the carry untouched
        keep = lambda n, o: torch.where(  # noqa: E731
            valid.reshape((B,) + (1,) * (n.ndim - 1)), n, o)
        out = {k: keep(new[k], carry[k])
               for k in ("scores", "toks", "lens", "pred")}
        out["state"] = _state_map(keep, new["state"], carry["state"])
        return out

    @torch.no_grad()
    def _run_batched(self, feats, out_lengths, carry):
        out_lengths = torch.as_tensor(out_lengths, device=feats.device)
        for t in range(feats.shape[1]):
            carry = self._frame_step(carry, feats[:, t], t < out_lengths)
        return carry

    @staticmethod
    def _ranked_from_carry(carry):
        scores = carry["scores"].cpu().numpy()
        toks = carry["toks"].cpu().numpy()
        lens = carry["lens"].cpu().numpy()
        out = []
        for b in range(scores.shape[0]):
            hyps = [(toks[b, k, :lens[b, k]].tolist(), float(scores[b, k]))
                    for k in range(scores.shape[1])
                    if np.isfinite(scores[b, k])]
            out.append(sorted(hyps, key=lambda h: -h[1]))
        return out

    def decode_batched(self, x, lengths=None,
                       max_tokens: Optional[int] = None):
        """The whole batch through the fixed-width beam: the same ranked
        ``[(tokens, score), ...]`` a sample as ``__call__``."""
        with torch.no_grad():
            enc, out_lengths = self.model.transcribe(x, lengths)
        if max_tokens is None:
            max_tokens = enc.shape[1] * self.max_symbols
        carry = self.init_batched_state(enc.shape[0], max_tokens,
                                        enc.device)
        return self._ranked_from_carry(
            self._run_batched(enc, out_lengths, carry))

    def infer_batched(self, feats, out_lengths, carry):
        """``decode_batched`` over one chunk of projected encodings
        (``model.stream_transcribe``) → (ranked hypotheses so far, new
        carry); every chunk fed reproduces ``decode_batched`` (the carry
        is the beam)."""
        carry = self._run_batched(feats, out_lengths, carry)
        return self._ranked_from_carry(carry), carry
