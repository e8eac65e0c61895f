"""The port's spans and counters (``utils/trace.py``): a span is a shared
no-op while no profiler records; under a CPU ``torch.profiler`` the fused
op's autograd function (driven with the kernels' plain versions, as on the
card) and the classifier's training step emit their spans, nested as
documented, and change no result; the constants' caches count each upload
once."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.models.frontend import MelFrontendClassifier
from torchaudio_contrib_tpu_torch.ops import fused as tfused
from torchaudio_contrib_tpu_torch.utils import trace

torch.set_num_threads(2)

FFT, HOP, MELS, SR = 256, 64, 16, 8000
# the step graph's counters and the stream pool's resets, which no
# constant cache moves
STEP_GRAPH_STILL = {"STEP_GRAPH_CAPTURES": 0, "STEP_GRAPH_REPLAYS": 0,
                    "STEP_GRAPH_REFUSED": 0, "RNNT_SLOT_RESETS": 0}


def _spans(prof):
    """``[(name, parent span's name or None)]`` of the ``tac::`` spans, in
    order of their start."""
    out = []
    for e in prof.events():
        if not e.name.startswith(trace.PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(trace.PREFIX):
            p = p.cpu_parent
        out.append((e.name[len(trace.PREFIX):],
                    None if p is None else p.name[len(trace.PREFIX):]))
    return out


def _inputs(rng, need=(True, True)):
    x = torch.from_numpy(rng.standard_normal((2, 3000)).astype(np.float32))
    fb = torch.from_numpy(np.asarray(
        tops.create_mel_filter(MELS, SR, 0.0, None, FFT // 2 + 1),
        dtype=np.float32))
    return x.requires_grad_(need[0]), fb.requires_grad_(need[1])


def _fused(x, fb):
    """The op's CUDA route with the kernels' plain versions."""
    return tfused._fused_apply(x, fb, FFT, HOP, "hann", None, True, 1.0,
                               1e-7, tfused._fwd_res_plain,
                               tfused._op_bwd_plain)


def _grads(x, fb, g):
    y = _fused(x, fb)
    wrt = [t for t in (x, fb) if t.requires_grad]
    return (y.detach(), *torch.autograd.grad(y, wrt, g)) if wrt else (y,)


def test_span_is_a_shared_noop_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"recorded {name} with no profiler")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = trace.span("a"), trace.span("b")
    assert first is second
    with first:
        pass


def test_span_records_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(3).add_(1)
    assert _spans(prof) == [("outer", None), ("inner", "outer")]


@pytest.mark.parametrize("need", [(True, True), (True, False),
                                  (False, True)])
def test_fused_op_spans_nest(rng, need):
    x, fb = _inputs(rng, need)
    g = torch.ones(2, MELS, 1 + (3000 - FFT) // HOP)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _grads(x, fb, g)
    bwd = [("dmel", "bwd"), ("bwd_launch", "bwd")]
    if need[0]:
        bwd.append(("overlap_add", "bwd"))
    want = [("fwd", None), ("bwd", None)] + bwd
    assert _spans(prof) == [("fused_mel." + a, b and "fused_mel." + b)
                            for a, b in want]


def test_fused_op_without_grad_spans_its_launch(rng):
    x, fb = _inputs(rng, (False, False))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            _fused(x, fb)
    assert _spans(prof) == [("fused_mel.fwd", None)]


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_path_takes_no_span(rng, grad):
    x, fb = _inputs(rng, (grad, grad))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = tfused.fused_melspectrogram(x, fb, FFT, HOP)
        if grad:
            y.sum().backward()
    assert _spans(prof) == []


def test_spans_change_no_result(rng):
    x, fb = _inputs(rng)
    g = torch.from_numpy(rng.standard_normal(
        (2, MELS, 1 + (3000 - FFT) // HOP)).astype(np.float32))
    off = _grads(x, fb, g)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _grads(x, fb, g)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def _classifier():
    return MelFrontendClassifier(num_classes=5, num_mels=MELS,
                                 sample_rate=SR, fft_length=FFT,
                                 hop_length=HOP, channels=(4, 8, 8),
                                 fused=True,
                                 generator=torch.Generator().manual_seed(3))


STEP = [("classifier.step", None),
        ("classifier.forward", "classifier.step"),
        ("classifier.frontend", "classifier.forward"),
        ("classifier.conv0", "classifier.forward"),
        ("classifier.conv1", "classifier.forward"),
        ("classifier.conv2", "classifier.forward"),
        ("classifier.head", "classifier.forward"),
        ("classifier.loss", "classifier.step"),
        ("classifier.grad", "classifier.step"),
        ("classifier.update", "classifier.step")]


@pytest.mark.parametrize("steps", [1, 2])
def test_train_step_spans_nest(rng, steps):
    model = _classifier()
    x = torch.from_numpy(rng.standard_normal((2, 1, 4000)).astype(np.float32))
    labels = torch.tensor([1, 3])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            model.train_step(x, labels, 1e-3)
    assert _spans(prof) == STEP * steps


def test_forward_spans_nest(rng):
    model = _classifier()
    x = torch.from_numpy(rng.standard_normal((2, 1, 4000)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(x)
    assert _spans(prof) == [("classifier.forward", None)] + STEP[2:7]


def test_train_step_spans_change_no_result(rng):
    x = torch.from_numpy(rng.standard_normal((2, 1, 4000)).astype(np.float32))
    labels = torch.tensor([0, 4])
    off, on = _classifier(), _classifier()
    loss_off = off.train_step(x, labels, 1e-2)
    with profile(activities=[ProfilerActivity.CPU]):
        loss_on = on.train_step(x, labels, 1e-2)
    assert torch.equal(loss_off, loss_on)
    for (k, a), (_, b) in zip(off.named_parameters(), on.named_parameters()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("cache,tensors", [("_fft_consts_on", 2),
                                           ("_basis_on", 1)])
def test_const_uploads_count_each_new_constant_once(cache, tensors):
    fn = getattr(tfused, cache)
    fn.cache_clear()
    meta = torch.device("meta")
    before = trace.counts()
    first = fn(meta, 512, "hann", None)
    moved = trace.delta(before)
    consts = first if tensors == 2 else first[:1]
    assert moved == {"CONST_UPLOADS": tensors,
                     "CONST_UPLOAD_BYTES": sum(t.numel() * 4
                                               for t in consts),
                     **STEP_GRAPH_STILL}
    before = trace.counts()
    fn(meta, 512, "hann", None)                  # a cache hit
    assert trace.delta(before) == {"CONST_UPLOADS": 0,
                                   "CONST_UPLOAD_BYTES": 0,
                                   **STEP_GRAPH_STILL}
    fn(meta, 256, "hann", None)                  # a new constant
    assert trace.delta(before)["CONST_UPLOADS"] == tensors
    before = trace.counts()
    fn(torch.device("cpu"), 512, "hann", None)   # no copy to a device
    assert trace.delta(before)["CONST_UPLOADS"] == 0
    fn.cache_clear()
