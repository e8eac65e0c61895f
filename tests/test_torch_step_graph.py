"""``MelFrontendClassifier.train_step``'s CUDA graph (``models/_step_graph.py``)
on the CPU: a CPU step never captures, the signature is a pure function of
what a captured step depends on, and the bookkeeping (first call eager,
second captured, later replayed; a refused signature eager for good; the
least recently used graph out first) with the capture and the replay
stood in for.  The card tests are in ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from torchaudio_contrib_tpu_torch.models import _step_graph
from torchaudio_contrib_tpu_torch.models.frontend import MelFrontendClassifier
from torchaudio_contrib_tpu_torch.utils import trace

torch.set_num_threads(2)

STEP_GRAPH = ("STEP_GRAPH_CAPTURES", "STEP_GRAPH_REPLAYS",
              "STEP_GRAPH_REFUSED")


def _model(trainable=True):
    return MelFrontendClassifier(num_classes=5, num_mels=16, sample_rate=8000,
                                 fft_length=256, hop_length=64,
                                 channels=(4, 8, 8), fused=True,
                                 trainable_frontend=trainable,
                                 generator=torch.Generator().manual_seed(3))


def _batch(seed=0, clips=2, samples=4000, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((clips, 1, samples))).to(dtype)
    return x, torch.from_numpy(rng.integers(0, 5, clips))


def _step_graph_moves(before):
    moved = trace.delta(before)
    return {k: moved[k] for k in STEP_GRAPH}


@pytest.mark.parametrize("fused", [True, False])
def test_cpu_train_step_never_captures(fused):
    model = MelFrontendClassifier(num_classes=5, num_mels=16,
                                  sample_rate=8000, fft_length=256,
                                  hop_length=64, channels=(4, 8, 8),
                                  fused=fused)
    x, labels = _batch()
    before = trace.counts()
    losses = [model.train_step(x, labels, 1e-2) for _ in range(4)]
    assert _step_graph_moves(before) == dict.fromkeys(STEP_GRAPH, 0)
    assert model not in _step_graph._MODELS
    assert all(torch.isfinite(v) for v in losses)
    assert len({float(v) for v in losses}) == 4     # each step moved


def _changed(case, model, x, labels, lr):
    """``(model, x, labels, lr)`` with the one change ``case`` names."""
    if case == "lr":
        return model, x, labels, 2 * lr
    if case == "waveform shape":
        return model, x[:, :, :3000], labels, lr
    if case == "batch":
        return model, x[:1], labels[:1], lr
    if case == "waveform dtype":
        return model, x.double(), labels, lr
    if case == "labels dtype":
        return model, x, labels.int(), lr
    if case == "parameter identity":
        model.load_state_dict({k: v.clone()
                               for k, v in model.state_dict().items()},
                              assign=True)
        return model, x, labels, lr
    if case == "parameter storage":
        model.head.weight.data = model.head.weight.data.clone()
        return model, x, labels, lr
    if case == "requires_grad":
        model.head.bias.requires_grad_(False)
        return model, x, labels, lr
    if case == "parameter added":
        model.extra = nn.Parameter(torch.zeros(1))
        return model, x, labels, lr
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["lr", "waveform shape", "batch",
                                  "waveform dtype", "labels dtype",
                                  "parameter identity", "parameter storage",
                                  "requires_grad", "parameter added"])
def test_signature_changes_with(case):
    model = _model()
    x, labels = _batch()
    key = _step_graph.signature(model, x, labels, 1e-3)
    assert _step_graph.signature(*_changed(case, model, x, labels,
                                           1e-3)) != key


def test_signature_follows_a_buffer_and_the_flags():
    """A frozen filterbank is a buffer the graph reads; the grad mode and
    the flags the step's kernels are chosen under (cuDNN's, cuBLAS's TF32,
    deterministic algorithms, autocast)."""
    model = _model(trainable=False)
    x, labels = _batch()
    key = _step_graph.signature(model, x, labels, 1e-3)
    c = torch.backends.cudnn
    for flags in ({"enabled": not c.enabled}, {"benchmark": not c.benchmark},
                  {"deterministic": not c.deterministic}):
        with c.flags(**{"enabled": c.enabled, "benchmark": c.benchmark,
                        "deterministic": c.deterministic, **flags}):
            assert _step_graph.signature(model, x, labels, 1e-3) != key
    with torch.no_grad():
        assert _step_graph.signature(model, x, labels, 1e-3) != key
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not tf32
        assert _step_graph.signature(model, x, labels, 1e-3) != key
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    kept = torch.are_deterministic_algorithms_enabled()
    try:
        torch.use_deterministic_algorithms(not kept)
        assert _step_graph.signature(model, x, labels, 1e-3) != key
    finally:
        torch.use_deterministic_algorithms(kept)
    kept = torch.is_autocast_enabled("cuda")
    try:
        torch.set_autocast_enabled("cuda", not kept)
        assert _step_graph.signature(model, x, labels, 1e-3) != key
    finally:
        torch.set_autocast_enabled("cuda", kept)
    assert _step_graph.signature(model, x, labels, 1e-3) == key
    layer = model.get_submodule("frontend.0")
    layer.filterbank = layer.filterbank.clone()
    assert _step_graph.signature(model, x, labels, 1e-3) != key


@pytest.mark.parametrize("case", ["waveform values", "labels values",
                                  "parameters in place", "a step",
                                  "train mode", "same lr as int"])
def test_signature_keeps_with(case):
    """Nothing but what a captured step depends on changes the key: the
    batch's values, the parameters' values (updated in place, as a step
    and a copy into them do) and the module's mode do not."""
    model = _model()
    x, labels = _batch()
    lr = 1.0
    key = _step_graph.signature(model, x, labels, lr)
    if case == "waveform values":
        x = _batch(seed=1)[0]
    elif case == "labels values":
        labels = (labels + 1) % 5
    elif case == "parameters in place":
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(0.5)
    elif case == "a step":
        model.train_step(x, labels, lr)
    elif case == "train mode":
        model.eval()
    elif case == "same lr as int":
        lr = 1
    assert _step_graph.signature(model, x, labels, lr) == key


class _Fake:
    """Stands in for ``_capture`` (and the graph's replay) on the CPU:
    records the captures, refuses them when told to, and replays as a
    0-d tensor."""

    def __init__(self, refuse=False):
        self.refuse, self.captures, self.replays = refuse, [], 0

    def capture(self, step, waveform, labels, lr):
        self.captures.append(lr)
        return None if self.refuse else self

    def replay(self, waveform, labels):
        self.replays += 1
        return torch.zeros(())


@pytest.fixture()
def fake(monkeypatch):
    f = _Fake()
    monkeypatch.setattr(_step_graph, "_engages", lambda *a: True)
    monkeypatch.setattr(_step_graph, "_capture", f.capture)
    return f


def test_first_call_eager_second_captures_then_replays(fake):
    model = _model()
    x, labels = _batch()
    first = model.train_step(x, labels, 1e-3)
    assert fake.captures == [] and float(first) > 0
    for _ in range(3):
        assert float(model.train_step(x, labels, 1e-3)) == 0.0
    assert fake.captures == [1e-3] and fake.replays == 3


def test_replay_runs_under_the_replay_span(fake):
    model = _model()
    x, labels = _batch()
    model.train_step(x, labels, 1e-3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.train_step(x, labels, 1e-3)      # capture, then replay
        model.train_step(x, labels, 1e-3)
    spans = [(e.name[len(trace.PREFIX):],
              e.cpu_parent.name[len(trace.PREFIX):] if e.cpu_parent else None)
             for e in prof.events() if e.name.startswith(trace.PREFIX)]
    assert spans == [("classifier.step", None),
                     ("classifier.replay", "classifier.step")] * 2


def test_a_refused_signature_stays_eager(fake):
    fake.refuse = True
    model = _model()
    x, labels = _batch()
    before = trace.counts()
    losses = [float(model.train_step(x, labels, 1e-3)) for _ in range(4)]
    assert fake.captures == [1e-3] and fake.replays == 0
    assert _step_graph_moves(before)["STEP_GRAPH_REFUSED"] == 1
    assert all(v > 0 for v in losses)


def test_graphs_leave_least_recently_used_first(fake):
    model = _model()
    x, labels = _batch()
    n = _step_graph.MAX_GRAPHS
    rates = [1e-3 * (i + 1) for i in range(n + 1)]
    for lr in rates[:n]:
        model.train_step(x, labels, lr)
        model.train_step(x, labels, lr)
    model.train_step(x, labels, rates[0])      # now the most recent
    model.train_step(x, labels, rates[n])
    model.train_step(x, labels, rates[n])      # evicts rates[1]
    steps = _step_graph._MODELS[model]
    assert [k[2] for k in steps.graphs] == rates[2:n] + [rates[0], rates[n]]
    replays = fake.replays
    assert float(model.train_step(x, labels, rates[1])) > 0   # eager again
    assert fake.replays == replays
    model.train_step(x, labels, rates[1])
    assert fake.captures == rates + [rates[1]]


def test_signatures_seen_once_are_bounded(fake):
    model = _model()
    x, labels = _batch()
    n = _step_graph.MAX_SEEN
    rates = [1e-3 * (i + 1) for i in range(n + 1)]
    for lr in rates:
        model.train_step(x, labels, lr)
    steps = _step_graph._MODELS[model]
    assert list(k[2] for k in steps.seen) == rates[1:] and not steps.graphs
    model.train_step(x, labels, rates[0])      # forgotten: eager again
    assert fake.captures == []
    model.train_step(x, labels, rates[2])      # still seen: captured
    assert fake.captures == [rates[2]]
