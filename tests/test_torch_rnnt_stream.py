"""The transducer's streaming state per stream (``models/emformer.py``,
``models/rnnt.py``), the stream pool (``RNNTStreamPool``) and its two-stage
step graph (``models/_step_graph.run_stages``) on the CPU, against each
stream run alone, a fresh stream, the whole utterance's features and the
benchmark's plain reference (``cudabench/reference/emformer_rnnt.py``).

Toy widths: the torchaudio-layout Emformer-RNNT at stride 4 (segment 16
and lookahead 4 input frames, left context 5 reduced frames), d 24, 2
layers, 2 heads, a 2-layer predictor 8 wide, 11 symbols.  Every parameter
is moved by 0.1 of a normal draw, so that no bias is zero.  The card tests
(replay against eager, bit for bit) are in ``tests/test_torch_cuda.py``."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cudabench.reference import emformer_rnnt as R
from torchaudio_contrib_tpu_torch import pipelines
from torchaudio_contrib_tpu_torch.models import _step_graph
from torchaudio_contrib_tpu_torch.models import emformer_rnnt_model
from torchaudio_contrib_tpu_torch.utils import trace

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ENC = 1e-5          # streamed encodings against the reference, relative l2
S_IN, R_IN, STRIDE = 16, 4, 4
ARGS = dict(n_mels=80, sample_rate=16000, fft_length=400, hop_length=160,
            time_reduction_stride=STRIDE, segment_length=4,
            left_context_length=5, right_context_length=1, num_heads=2,
            num_layers=2, blank=0, lstm_layer_norm_eps=1e-3,
            predictor_hidden_dim=8, predictor_layers=2)


@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(5)
    m = emformer_rnnt_model(
        input_dim=80, encoding_dim=24, num_symbols=11, segment_length=S_IN,
        right_context_length=R_IN, left_context_length=5, num_heads=2,
        ffn_dim=16, num_layers=2, max_memory_size=0, predictor_embed_dim=8,
        predictor_hidden_dim=8, predictor_layers=2,
        time_reduction_input_dim=6, time_reduction_stride=STRIDE,
        transformer_activation="gelu", lstm_layer_norm=True,
        lstm_layer_norm_epsilon=1e-3, device="cpu", generator=g).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return m


def _pool(model, slots):
    return pipelines.EMFORMER_RNNT_BASE_LIBRISPEECH.get_stream_pool(
        model, slots)


def _audio(seed, n):
    return 0.1 * torch.randn(n, generator=torch.Generator().manual_seed(seed))


def _chunks(seed, steps, batch):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((batch, S_IN + R_IN, 80), generator=g)
            for _ in range(steps)]


def _step(model, chunk, state, reset=None):
    feats, lengths, state = model.stream_encode(chunk, state, reset)
    grid, state = model.stream_decode(feats, lengths, state)
    return feats, grid, state


def test_staggered_streams_equal_each_stream_alone(model):
    """Streams 1 and 2 begin (their slots reset) at steps 2 and 3 of a
    batch whose stream 0 began at step 0: each stream's encodings and grid
    equal those of the stream run alone from a fresh state."""
    steps, begins = 6, (0, 2, 3)
    chunks = _chunks(0, steps, 3)
    state = model.init_stream_state(3)
    got = [[] for _ in begins]
    with torch.no_grad():
        for i, chunk in enumerate(chunks):
            reset = torch.tensor([i == b for b in begins])
            feats, grid, state = _step(model, chunk, state, reset)
            for s, b in enumerate(begins):
                if i >= b:
                    got[s].append((feats[s], grid[s]))
        for s, b in enumerate(begins):
            alone = model.init_stream_state(1)
            for i, chunk in enumerate(chunks[b:]):
                feats, grid, alone = _step(model, chunk[s:s + 1], alone)
                want_f, want_g = got[s][i]
                torch.testing.assert_close(feats[0], want_f, rtol=1e-5,
                                           atol=1e-5)
                assert torch.equal(grid[0], want_g)
    assert state["enc"]["seg"].tolist() == [steps - b for b in begins]


def test_reset_slot_is_fresh_and_the_others_untouched(model):
    chunks = _chunks(1, 3, 3)
    reset = torch.tensor([False, True, False])
    with torch.no_grad():
        state = model.init_stream_state(3)
        for chunk in chunks[:2]:
            _, _, state = _step(model, chunk, state)
        fresh = model.init_stream_state(3)
        cleared = model.reset_stream_slots(state, reset)
        for c, s, f in zip(_leaves(cleared), _leaves(state),
                           _leaves(fresh)):
            assert torch.equal(c[1], f[1]) and torch.equal(c[0], s[0])
            assert torch.equal(c[2], s[2])
        f_reset, g_reset, s_reset = _step(model, chunks[2], state, reset)
        f_kept, g_kept, s_kept = _step(model, chunks[2], state)
        f_new, g_new, s_new = _step(model, chunks[2], fresh)
    for rows, want in (([0, 2], (f_kept, g_kept, s_kept)),
                       ([1], (f_new, g_new, s_new))):
        assert torch.equal(f_reset[rows], want[0][rows])
        assert torch.equal(g_reset[rows], want[1][rows])
        for a, b in zip(_leaves(s_reset), _leaves(want[2])):
            assert torch.equal(a[rows], b[rows])


def _leaves(tree):
    from torchaudio_contrib_tpu_torch.models.rnnt import _leaves as leaves
    return leaves(tree)


def test_stream_greedy_step_resets_and_keeps_its_grid(model):
    """``stream_greedy_step`` with ``reset`` is ``stream_encode`` then
    ``stream_decode``: the same grid and lengths."""
    chunks = _chunks(2, 2, 2)
    reset = torch.tensor([True, False])
    with torch.no_grad():
        state = model.init_stream_state(2)
        _, _, state = _step(model, chunks[0], state)
        grid, lengths, _ = model.stream_greedy_step(chunks[1], state,
                                                    reset=reset)
        _, want, _ = _step(model, chunks[1], state, reset)
    assert torch.equal(grid, want) and lengths.tolist() == [4, 4]


@pytest.mark.parametrize("n,segment", [(9000, 0), (20000, 3), (20000, 7),
                                       (7100, 2)])
def test_streamed_features_are_the_whole_utterances(model, n, segment):
    """A segment's window through the bundle's extractor gives frames
    ``16 i … 16 i + 19`` of the whole utterance's features, reflected at
    both of its edges; frames past the utterance's last are not
    compared."""
    pool = _pool(model, 1)
    audio = torch.cat([_audio(3, 500), _audio(4, n), _audio(5, 700)])
    start = torch.tensor([500])
    with torch.no_grad():
        window = pool._windows(audio, start, torch.tensor([n]),
                               torch.tensor([segment]))
        got = pool.extractor(window)[0, pool.lead:pool.lead + S_IN + R_IN]
        whole = pool.extractor(audio[None, 500:500 + n])[0]
    first = S_IN * segment
    want = whole[first:first + S_IN + R_IN]
    torch.testing.assert_close(got[:len(want)], want, rtol=1e-5, atol=1e-4)


def test_pool_equals_the_plain_reference(model):
    """Three slots, one recycled mid-run and two starting at once: each
    utterance's streamed encodings are within ``ENC`` of the reference's
    whole-utterance forward in float64, its greedy grid the reference's;
    the counters move by the frames and resets the host gave."""
    audio = _audio(6, 70000)
    utterances = [[(0, 9100), (9100, 21000)], [(30100, 20000)],
                  [(50100, 7000)]]
    pool = _pool(model, 3)
    nseg = [[-(-int(pool.frames(n)) // S_IN) for _, n in u]
            for u in utterances]
    streamed = [[[] for _ in u] for u in utterances]
    where = [[0, 0] for _ in utterances]           # utterance, segment
    before, frames0, resets = trace.counts(), trace.RNNT_VALID_FRAMES, 0
    want_frames = sum(int(pool.frames(n)) for u in utterances for _, n in u)
    for _ in range(sum(nseg[0])):
        start, length, seg, reset = [], [], [], []
        for s, u in enumerate(utterances):
            k, i = where[s]
            k = min(k, len(u) - 1)
            start.append(u[k][0])
            length.append(u[k][1])
            seg.append(i)
            reset.append(int(i == 0))
        resets += sum(reset)
        grid, lengths, enc = pool.step(audio, start, length, seg, reset)
        for s, u in enumerate(utterances):
            k, i = where[s]
            if k < len(u):
                streamed[s][k].append((enc[s], grid[s]))
                done = k + 1 == len(u)         # then past its last segment
                where[s] = [k, i + 1] if i + 1 < nseg[s][k] \
                    else [k + 1, i + 1 if done else 0]
            else:
                where[s] = [k, i + 1]
    assert trace.delta(before)["RNNT_SLOT_RESETS"] == resets == 4
    assert trace.RNNT_VALID_FRAMES - frames0 == want_frames
    p = {k: v.double() for k, v in model.state_dict().items()}
    for s, u in enumerate(utterances):
        for k, (a, n) in enumerate(u):
            x = audio[a:a + n].double()
            frames = int(R.utterance_frames(n, ARGS))
            ref = R.encode(p, R.features(x, ARGS)[:frames], ARGS)
            enc = torch.cat([e for e, _ in streamed[s][k]])[:len(ref)]
            grid = torch.cat([g for _, g in streamed[s][k]])[:len(ref)]
            gap = torch.linalg.norm(enc.double() - ref) / torch.linalg.norm(
                ref)
            assert gap <= ENC, (s, k, float(gap))
            assert torch.equal(grid, R.greedy(p, ref, ARGS, 4)), (s, k)


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; import cudabench.reference.emformer_rnnt; "
            "found = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'torchaudio_contrib_tpu', "
            "'torchaudio_contrib_tpu_torch'}); print(found); "
            "sys.exit(1 if found else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]


class _FakeStages:
    """Stands in for ``_capture_stages`` (and the stages' replay) on the
    CPU: records the captures, refuses them when told to, and replays as
    zeros shaped as an eager step's outputs."""

    def __init__(self, refuse=False):
        self.refuse, self.captures, self.replays = refuse, 0, 0
        self.outputs = None

    def capture(self, stages, inputs):
        self.captures += 1
        self.outputs = _step_graph._run_eager(stages, inputs, None)
        return None if self.refuse else self

    def replay(self, inputs, name, mark):
        for stage in ("encode", "decode"):
            if mark is not None:
                mark(stage)
            with trace.span(f"{name}.replay.{stage}"):
                pass
        if mark is not None:
            mark(None)
        self.replays += 1
        return tuple(torch.zeros_like(o) for o in self.outputs)


@pytest.fixture()
def fake(monkeypatch):
    f = _FakeStages()
    monkeypatch.setattr(_step_graph, "_stages_engage", lambda *a: True)
    monkeypatch.setattr(_step_graph, "_capture_stages", f.capture)
    return f


def _pool_call(pool, audio, marks=None):
    return pool.step(audio, [0, 9000], [9000, 12000], [0, 1], [1, 0],
                     None if marks is None else marks.append)


def test_pool_step_first_eager_second_captures_then_replays(model, fake):
    pool = _pool(model, 2)
    audio = _audio(7, 30000)
    marks = []
    first = _pool_call(pool, audio, marks)
    assert fake.captures == 0 and first[0].any()
    assert marks == ["encode", "decode", None]
    for _ in range(3):
        assert not _pool_call(pool, audio)[0].any()
    assert fake.captures == 1 and fake.replays == 3
    _pool_call(pool, _audio(7, 30000))     # another audio buffer: eager
    assert fake.captures == 1


def test_pool_step_spans(model, fake):
    pool = _pool(model, 2)
    audio = _audio(8, 30000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _pool_call(pool, audio)                # eager
        _pool_call(pool, audio)                # captured, then replayed
        _pool_call(pool, audio)                # replayed
    spans = [(e.name[len(trace.PREFIX):],
              e.cpu_parent.name[len(trace.PREFIX):] if e.cpu_parent else None)
             for e in prof.events() if e.name.startswith(trace.PREFIX)]
    eager = [("rnnt.step", None), ("rnnt.features", "rnnt.step"),
             ("rnnt.reset", "rnnt.step"), ("rnnt.encode", "rnnt.step"),
             ("rnnt.decode", "rnnt.step")]
    assert spans[:5] == eager
    assert spans[-3:] == [("rnnt.step", None),
                          ("rnnt.replay.encode", "rnnt.step"),
                          ("rnnt.replay.decode", "rnnt.step")]


def test_a_refused_pool_step_stays_eager(model, fake):
    fake.refuse = True
    pool = _pool(model, 2)
    audio = _audio(9, 30000)
    before = trace.counts()
    outs = [_pool_call(pool, audio)[0] for _ in range(4)]
    assert fake.captures == 1 and fake.replays == 0
    assert trace.delta(before)["STEP_GRAPH_REFUSED"] == 1
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_cpu_pool_never_captures(model):
    pool = _pool(model, 2)
    audio = _audio(10, 30000)
    before = trace.counts()
    for _ in range(3):
        _pool_call(pool, audio)
    moved = trace.delta(before)
    assert moved["STEP_GRAPH_CAPTURES"] == moved["STEP_GRAPH_REPLAYS"] == 0
    assert pool not in _step_graph._MODELS
    assert moved["RNNT_SLOT_RESETS"] == 3
    assert np.isclose(float(pool.frames(9000)), 4 * ((1 + 9000 // 160) // 4))
