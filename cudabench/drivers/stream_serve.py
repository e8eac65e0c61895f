"""Closed loop of a streaming ASR server's steps: ``clips`` stream slots,
one caller, calls back to back; each call advances every slot by one
segment (the system's ``step``) and copies the segment's grid of symbols
and output lengths into pinned host buffers without a synchronise.

The mix's ``clip_seconds`` gives the shortest and the longest clip.  The
``pool`` clip lengths are drawn independently and uniformly from that
range once, from the mix's ``length_seed`` and not from the run's seed, so
that every seed serves the same clips; the seed draws their waveforms
(Gaussian, ``amplitude``, drawn on the device into one buffer), the
weights, each slot's order of the clips and where in its first clip the
slot starts: a slot's first utterance is that clip from a seeded offset
(at least ``clip_seconds[0]`` before its end), its later ones whole clips,
so that utterance ends are staggered from the first call.  A slot whose
utterance ends begins its next in the following call, its state reset on
the card (the step's ``reset``).  A call's ``frames`` are the valid
utterance frames it advanced (16 a full segment of 10 ms frames; segments
past an utterance's end, and its padding, not counted).

Set-up warms the step up (eager, captured, replayed), then restarts every
slot's schedule: the window's first call resets every slot.  ``keep``
slots are drawn from the seed among those whose second utterance ends
within the window's first ``keep_span`` calls; their outputs are copied
into buffers made in set-up until then, and after the window each of
their utterances that the window completed is held to the reference (the
system's ``check_stream``).

The window's summary adds ``rnnt_decode_share``: the percent of the
steps' device time, between CUDA events recorded as each stage of a call
begins and after the last (the program's ``mark``), that its ``decode``
stage took; on the card only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..loop import Closed, Spans

WARM_STEPS = 3


def draw_lengths(pool: int, shortest: int, longest: int,
                 length_seed: int) -> np.ndarray:
    """The pool's clip lengths in samples (module docstring)."""
    return np.random.default_rng(length_seed).integers(
        shortest, longest + 1, size=pool)


class Schedule:
    """Which utterance each slot plays and which of its segments a call
    advances, on the host."""

    def __init__(self, lengths, starts, slots: int, shortest: int,
                 seed: int, segments):
        self.lengths, self.starts = lengths, starts
        self.segments = segments          # samples -> segments
        rng = np.random.default_rng([seed, 3])
        self.order = np.argsort(rng.random((slots, len(lengths))), axis=1)
        first = lengths[self.order[:, 0]]
        self.offset = np.random.default_rng([seed, 4]).integers(
            0, first - shortest + 1)
        self.start, self.length, self.nseg = (
            np.zeros(slots, dtype=np.int64) for _ in range(3))
        self.restart()

    def restart(self) -> None:
        slots = len(self.order)
        self.k = np.zeros(slots, dtype=np.int64)      # utterance a slot
        self.seg = np.zeros(slots, dtype=np.int64)
        self.reset = np.ones(slots, dtype=np.int64)
        self._load(np.ones(slots, dtype=bool))

    def utterance(self, k, slots=None):
        """``(start, length)`` of utterance ``k`` of each slot."""
        slots = np.arange(len(self.order)) if slots is None else slots
        clip = self.order[slots, k % self.order.shape[1]]
        off = np.where(k == 0, self.offset[slots], 0)
        return self.starts[clip] + off, self.lengths[clip] - off

    def _load(self, which) -> None:
        idx = np.flatnonzero(which)
        s, n = self.utterance(self.k[idx], idx)
        self.start[idx], self.length[idx] = s, n
        self.nseg[idx] = self.segments(n)

    def advance(self) -> tuple:
        """This call's ``(start, length, segment, reset)``, then the
        schedule moved on by one segment."""
        out = (self.start.copy(), self.length.copy(), self.seg.copy(),
               self.reset.copy())
        self.seg += 1
        done = self.seg >= self.nseg
        self.k[done] += 1
        self.seg[done] = 0
        self.reset = done.astype(np.int64)
        self._load(done)
        return out

    def ends(self, utterances: int) -> np.ndarray:
        """The call after which each slot's first ``utterances`` have
        ended."""
        total = np.zeros(len(self.order), dtype=np.int64)
        for k in range(utterances):
            total += self.segments(self.utterance(np.full(
                len(self.order), k))[1])
        return total


class Runner(Closed):
    def __init__(self, ctx):
        self.ctx, sysm, t, mix = ctx, ctx.system, ctx.traffic, ctx.mix
        cfg = ctx.cfg
        self.device = dev = ctx.device
        prog, self.given = ctx.factory(cfg, ctx.gen, dev)
        self.prog = prog.open(t.clips)
        shortest, longest = min(t.samples), max(t.samples)
        self.lengths = draw_lengths(t.pool, shortest, longest,
                                    int(mix["length_seed"]))
        self.starts = np.concatenate([[0], np.cumsum(self.lengths)[:-1]])
        amp = float(mix.get("amplitude", 0.1))
        self.audio = torch.randn(int(self.lengths.sum()), generator=ctx.gen,
                                 device=dev) * amp
        seg_in = cfg["args"]["segment_length"] \
            * cfg["args"]["time_reduction_stride"]
        self.seg_in = seg_in

        def segments(n):
            return -(-sysm.utterance_frames(cfg, n) // seg_in)
        self.sched = Schedule(self.lengths, self.starts, t.clips, shortest,
                              t.seed, segments)
        self.host, self.kept_idx, self.keep_calls = None, None, 0
        self.calls, self.marks = 0, None
        self.frames, self.work = [], []
        for i in range(WARM_STEPS):
            self.step(i, Spans())
        self.sched.restart()
        self.frames, self.work = [], []
        pinned = torch.device(dev).type == "cuda"
        ms = cfg["args"]["max_symbols"]
        frames_out = seg_in // cfg["args"]["time_reduction_stride"]
        self.host = [(torch.empty((t.clips, frames_out, ms),
                                  dtype=torch.long, pin_memory=pinned),
                      torch.empty((t.clips,), dtype=torch.long,
                                  pin_memory=pinned)) for _ in range(4)]
        # the kept slots and the calls whose outputs they need
        ends = self.sched.ends(2)
        span = int(mix.get("keep_span", 256))
        able = np.flatnonzero(ends <= span)
        rng = np.random.default_rng([t.seed, 1])
        self.kept = np.sort(rng.choice(able, size=min(int(mix["keep"]),
                                                      len(able)),
                                       replace=False))
        self.keep_calls = int(ends[self.kept].max()) if len(self.kept) \
            else 0
        self.kept_idx = torch.as_tensor(self.kept, device=dev)
        self.kept_ends = [self.sched.segments(self.sched.utterance(
            np.full(len(self.kept), k), self.kept)[1]) for k in range(2)]
        enc_dim = cfg["args"]["encoding_dim"]
        self.kept_enc = torch.empty((self.keep_calls, len(self.kept),
                                     frames_out, enc_dim), device=dev)
        self.kept_grid = torch.empty((self.keep_calls, len(self.kept),
                                      frames_out, ms), dtype=torch.long,
                                     device=dev)
        self.calls = 0

    def _mark(self, stage) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.marks.append(e)

    def step(self, i, spans):
        start, length, seg, reset = self.sched.advance()
        sysm, cfg = self.ctx.system, self.ctx.cfg
        frames = sysm.utterance_frames(cfg, length)
        utt = np.clip(frames - self.seg_in * seg, 0, self.seg_in)
        rc = np.clip(frames - self.seg_in * (seg + 1), 0,
                     cfg["args"]["right_context_length"]
                     * cfg["args"]["time_reduction_stride"])
        mark = self._mark if self.marks is not None else None
        with spans("entry"):
            grid, out_lengths, enc = self.prog.step(
                self.audio, start, length, seg, reset, mark)
            if self.host is not None:
                g, n = self.host[i % len(self.host)]
                g.copy_(grid, non_blocking=True)
                n.copy_(out_lengths, non_blocking=True)
        if self.calls < self.keep_calls:
            with spans("keep"):
                self.kept_grid[self.calls].copy_(
                    grid.index_select(0, self.kept_idx))
                self.kept_enc[self.calls].copy_(
                    enc.index_select(0, self.kept_idx))
        self.calls += 1
        self.frames.append(int(utt.sum()))
        self.work.append(sysm.work(cfg, utt, rc, self.seg_in * seg))
        return len(self.frames) - 1

    def run(self, seconds, spans, start):
        """``Closed.run`` with the decode stage's share of the steps'
        device time (module docstring)."""
        on_card = torch.device(self.device).type == "cuda"
        self.marks = [] if on_card else None
        out = super().run(seconds, spans, start)
        if on_card and len(self.marks) >= 3:
            m = self.marks
            encode = sum(m[j].elapsed_time(m[j + 1])
                         for j in range(0, len(m) - 2, 3))
            decode = sum(m[j + 1].elapsed_time(m[j + 2])
                         for j in range(0, len(m) - 2, 3))
            out["rnnt_decode_share"] = 100.0 * decode / (encode + decode)
        self.marks = None
        return out

    def check(self) -> dict:
        self.prog = None
        kept = []
        done = min(self.calls, self.keep_calls)
        for j, slot in enumerate(self.kept.tolist()):
            first = 0
            for k in range(2):
                last = first + int(self.kept_ends[k][j])
                if last > done:
                    break
                s, n = self.sched.utterance(np.array([k]), np.array([slot]))
                frames = int(self.ctx.system.utterance_frames(
                    self.ctx.cfg, n[0]))
                T = frames // self.ctx.cfg["args"]["time_reduction_stride"]
                enc = self.kept_enc[first:last, j].reshape(
                    -1, self.kept_enc.shape[-1])[:T]
                grid = self.kept_grid[first:last, j].reshape(
                    -1, self.kept_grid.shape[-1])[:T]
                kept.append((self.audio[int(s[0]):int(s[0]) + int(n[0])],
                             enc, grid))
                first = last
        return self.ctx.system.check_stream(self.ctx.cfg, self.given, kept)
