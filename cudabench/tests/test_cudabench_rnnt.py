"""The ``rnnt_stream`` cell: its check driven through whole runs on the CPU
at a toy size (``cudabench/conftest.py``'s ``trnnt``/``tstream``), sound
and with faults planted under the timed path; the schedule of the slots;
the counted work against a hand count; the bundle's geometry against the
configuration.  On the card (``-m cuda``), at the cell's own size, the
planted faults on three seeds, each run's numbers printed:

    python -m pytest -m cuda cudabench/tests/test_cudabench_rnnt.py -s
"""
import json
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cudabench import harness
from cudabench.drivers import stream_serve
from cudabench.systems import emformer_rnnt as W
from cudabench.tests import toy

torch.set_num_threads(2)

CELL = "rnnt_stream"
SEEDS = (4100300011, 4100300012, 4100300013)
KINDS = ("joiner_bf16", "carry_kept", "no_reset", "altered")
# the toy's 11 symbols lie too far apart for bfloat16 to flip a decision
CPU_KINDS = ("carry_kept", "no_reset", "altered")
CARD_KINDS = ("joiner_bf16", "carry_kept", "no_reset")


class Faulty:
    """The program with one fault planted under the timed path:

    * ``joiner_bf16``: the joiner's product in bfloat16 (the decoder
      alone; the encodings are sound);
    * ``carry_kept``: a reset leaves the greedy carry as it was (the
      decoder alone: the encoder's state is reset);
    * ``no_reset``: a slot's state is never reset, so an utterance begun
      in a recycled slot starts from the last one's state;
    * ``altered``: one encoding of every slot moved by 1 where it is
      returned."""

    def __init__(self, prog, kind):
        self._prog, self._kind = prog, kind

    def open(self, slots):
        self._prog.open(slots)
        if self._kind == "joiner_bf16":
            lin = self._prog.model.joiner.linear

            def forward(x):
                return F.linear(x.bfloat16(), lin.weight.bfloat16(),
                                lin.bias.bfloat16()).float()
            lin.forward = forward
        elif self._kind == "carry_kept":
            model = self._prog.model
            reset = model.reset_stream_slots

            def kept(state, mask):
                return dict(reset(state, mask), dec=state["dec"])
            model.reset_stream_slots = kept
        return self

    def step(self, audio, start, length, segment, reset, mark=None):
        if self._kind == "no_reset":
            reset = np.zeros_like(reset)
        grid, lengths, enc = self._prog.step(audio, start, length, segment,
                                             reset, mark)
        if self._kind == "altered":
            enc = enc.clone()
            enc[:, 0, 0] += 1.0
        return grid, lengths, enc


def _plant(monkeypatch, kind):
    build = W.build

    def faulty(cfg, gen, device):
        prog, given = build(cfg, gen, device)
        return Faulty(prog, kind), given
    monkeypatch.setattr(W, "build", faulty)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    base = tmp_path_factory.mktemp("toy")
    return base, toy.write(base)


def _run(files, seed=2 ** 31 + 5, trace=False):
    base, bench = files
    return harness.run_cell(CELL, seed, 0.5, trace, 0.0, device="cpu",
                            bench=bench, base=base)


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 4100300099])
def test_sound_run_is_correct(files, seed):
    out = _run(files, seed)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["decode_gap"]["value"] == 0


@pytest.mark.parametrize("kind", CPU_KINDS)
def test_fault_is_not_correct(files, monkeypatch, kind):
    _plant(monkeypatch, kind)
    out = _run(files)
    assert not out["correct"], out["checks"]


def test_decoder_fault_leaves_the_encodings(files, monkeypatch):
    """A greedy carry left unreset fails on ``decode_gap`` alone."""
    _plant(monkeypatch, "carry_kept")
    checks = _run(files)["checks"]
    assert checks["enc_gap"]["value"] <= checks["enc_gap"]["limit"]
    assert checks["decode_gap"]["value"] > 0


def _schedule(seed, slots=40):
    lengths = stream_serve.draw_lengths(20, 32000, 480000, 0)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])

    def segments(n):
        return -(-(4 * ((1 + n // 160) // 4)) // 16)
    return stream_serve.Schedule(lengths, starts, slots, 32000, seed,
                                 segments), lengths, starts


def test_schedule_plays_each_utterance_whole_and_staggers_the_ends():
    sched, lengths, starts = _schedule(7)
    first = sched.utterance(np.zeros(40, dtype=np.int64))
    assert (first[1] >= 32000).all()
    assert (first[0] + first[1] == starts[sched.order[:, 0]]
            + lengths[sched.order[:, 0]]).all()
    played = [[] for _ in range(40)]
    resets = []
    for _ in range(300):
        start, length, seg, reset = sched.advance()
        resets.append(reset)
        for s in range(40):
            played[s].append((int(start[s]), int(length[s]), int(seg[s]),
                              int(reset[s])))
    assert resets[0].all() and not resets[1].any()
    ends = sched.ends(2)
    assert len(set(ends.tolist())) > 20           # staggered
    for s in range(40):
        calls = played[s]
        k_end = int(sched.segments(first[1][s]))
        # the first utterance's segments in order, then a reset
        assert [c[2] for c in calls[:k_end]] == list(range(k_end))
        assert calls[k_end][3] == 1 and calls[k_end][2] == 0
        start, length = sched.utterance(np.array([1]), np.array([s]))
        assert calls[k_end][:2] == (int(start[0]), int(length[0]))
        assert sum(c[3] for c in calls[:int(ends[s])]) == 2


def test_schedule_draws_follow_the_seed_alone():
    a, _, _ = _schedule(11)
    b, _, _ = _schedule(11)
    c, _, _ = _schedule(12)
    assert (a.order == b.order).all() and (a.offset == b.offset).all()
    assert not (a.order == c.order).all()


def test_work_against_a_hand_count():
    """One slot, one full segment (16 frames and 4 of lookahead) with 8
    frames seen: the cell's configuration counted by hand."""
    cfg = harness.load_json("configs", "emformer_rnnt_base")
    w = W.work(cfg, np.array([16]), np.array([4]), np.array([8]))
    d, f = 512, 2048
    rows, lc = 5, 2
    layer = rows * 2 * (4 * d * d + 2 * d * f) + 4 * d * rows * (lc + rows)
    pred = 2 * 4 * 512 * (512 + 512) * 3 + 2 * 512 * 1024
    want = (2 * 16 * 80 * 128 + 20 * layer + 2 * 4 * 512 * 1024
            + 16 * (2 * 1024 * 4097 + pred))
    assert w["gemm"][0] == pytest.approx(want)
    feats = 16 * (2.5 * 400 * np.log2(400) + 2 * 201 * 80)
    assert w["step"] == pytest.approx(want + feats)


def test_bundle_builds_the_configured_geometry():
    cfg = harness.load_json("configs", "emformer_rnnt_base")
    from torchaudio_contrib_tpu_torch import pipelines
    model = pipelines.EMFORMER_RNNT_BASE_LIBRISPEECH._model(
        "meta", torch.Generator())
    built = W._geometry(model)
    assert built == {k: cfg["args"][k] for k in built}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CARD_KINDS)
def test_fault_is_not_correct_on_the_card(monkeypatch, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _plant(monkeypatch, kind)
    for seed in SEEDS:
        out = harness.run_cell(CELL, seed, 4.0, False, time.perf_counter())
        print(json.dumps({"fault": kind, "seed": seed,
                          "checks": out["checks"]}), flush=True)
        assert not out["correct"], out["checks"]
        torch.cuda.empty_cache()
