"""``progtrace.read`` on hand-built events, ``devtrace.read`` left alone by
the program's spans, a toy run with the traced stretch read by both, and
on the card (``-m cuda``) the toy cells' stretches put down to the
program's spans:

    python -m pytest -m cuda cudabench/tests/test_cudabench_progtrace.py
"""
import json
from types import SimpleNamespace

import pytest
import torch

from cudabench import devtrace, harness, progtrace
from cudabench.tests import toy

torch.set_num_threads(2)

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
B1 = "void fused_mel_fft_fwd_kernel<2048, true>(float const*)"


def ev(name, t0, t1, *, device=CPU, thread=1, id=0, user=False):
    return SimpleNamespace(name=name, device_type=device, thread=thread,
                           time_range=SimpleNamespace(start=t0, end=t1),
                           id=id, is_user_annotation=user)


def _events():
    """One call: the harness's ``entry`` holds ``fused_mel`` > ``.fwd``
    (an aten pad launching a fill, then B1 launched from another thread);
    a keep copy outside any program span; an idle stretch inside
    ``fused_mel.fwd`` before B1, and some in the harness's spans.  A row
    shares its correlation id with the runtime call that launched it; an
    operator's id is of another count and may equal a row's."""
    return [
        ev("bench::stretch", 0, 1000, user=True),
        ev("bench::entry", 10, 500, id=1, user=True),
        ev("tac::fused_mel", 20, 400, id=2),
        ev("tac::fused_mel.fwd", 50, 300, id=3),
        ev("aten::constant_pad_nd", 60, 80, id=4),
        ev("cudaLaunchKernel", 62, 64, id=901),
        ev("void at::native::FillFunctor<float>", 100, 110, device=CUDA,
           id=901),
        ev("aten::empty", 150, 151, id=902, thread=2),
        ev("cudaLaunchKernel", 200, 205, id=902, thread=77),
        ev(B1, 210, 600, device=CUDA, id=902),
        ev("tac::fused_mel.fwd", 210, 600, device=CUDA, user=True),
        ev("bench::entry", 210, 600, device=CUDA, user=True),
        ev("bench::keep", 600, 700, id=5, user=True),
        ev("aten::copy_", 610, 650, id=6),
        ev("cudaMemcpyAsync", 620, 630, id=903),
        ev("Memcpy DtoD (Device -> Device)", 640, 690, device=CUDA, id=903),
    ]


def test_read_puts_each_row_and_gap_down():
    out = progtrace.read(_events(), {"calls": 1, "seconds": 1e-3})
    s = out["spans"]
    assert set(s) == {"tac::fused_mel", "tac::fused_mel.fwd",
                      "bench::keep", "loop"}
    fwd = s["tac::fused_mel.fwd"]
    # the fill (its runtime call's thread and time) and B1 (launched from
    # a thread with no span: the innermost span open on any thread)
    assert fwd["rows"] == 2 and fwd["device_ms"] == pytest.approx(0.4)
    assert [o[0] for o in fwd["ops"]] == [B1, "void at::native::"
                                          "FillFunctor<float>"]
    assert fwd["host_self_ms"] == pytest.approx(0.25)
    assert s["tac::fused_mel"]["host_self_ms"] == pytest.approx(0.13)
    assert s["tac::fused_mel"]["rows"] == 0
    assert s["bench::keep"]["rows"] == 1
    # gaps by their start: [0, 100) in no span, [110, 210) in
    # fused_mel.fwd, [600, 640) and [690, 1000) in the harness's keep
    assert fwd["idle_ms"] == pytest.approx(0.1)
    assert s["loop"]["idle_ms"] == pytest.approx(0.1)
    assert s["bench::keep"]["idle_ms"] == pytest.approx(0.35)
    assert out["rows"] == 3 and out["device_ms"] == pytest.approx(0.45)
    assert out["device_share"] == pytest.approx({"tac": 0.4 / 0.45,
                                                 "bench": 0.05 / 0.45})
    assert out["glue"] == {"ms_per_call": pytest.approx(0.01),
                           "launches_per_call": 1.0}


def test_read_without_device_rows():
    events = [e for e in _events() if e.device_type == CPU]
    out = progtrace.read(events, {"calls": 2, "seconds": 1.0}, {"X": 0})
    assert out["glue"] is None and out["rows"] == 0
    assert out["counters"] == {"X": 0} and out["calls_per_s"] == 2.0
    assert out["spans"]["tac::fused_mel.fwd"]["n"] == 0.5


def test_devtrace_reads_the_same_with_program_spans():
    """The program's spans are host records: ``devtrace.read`` gives the
    same output, key for key, with and without them."""
    run = {"calls": 1, "seconds": 1e-3, "work": {}}
    events = [e for e in _events() if e.device_type == CPU
              or not e.name.startswith(progtrace.TAC)]
    bare = [e for e in events if not e.name.startswith(progtrace.TAC)]
    assert len(bare) < len(events)
    assert devtrace.read(events, run) == devtrace.read(bare, run)


def test_toy_run_keeps_the_result_line(tmp_path, monkeypatch, capsys):
    """A toy run on the CPU with the stretch read by both readers: the
    result line keeps its keys, the program line its own."""
    bench = toy.write(tmp_path)
    monkeypatch.setattr(devtrace, "traced", progtrace.traced)
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.2)
    out = harness.run_cell("c3_train", 2 ** 31 + 11, 0.2, True, 0.0,
                           device="cpu", bench=bench, base=tmp_path)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    line = json.loads(capsys.readouterr().out.splitlines()[0])["program"]
    assert line["glue"] is None and line["rows"] == 0
    assert line["counters"] == {"CONST_UPLOADS": 0, "CONST_UPLOAD_BYTES": 0}
    assert line["spans"]["tac::classifier.step"]["n"] == 1.0
    assert line["spans"]["tac::classifier.update"]["host_self_ms"] > 0


def _stretch(tmp_path, monkeypatch, cell, spans_on):
    """A toy cell on the card: the traced stretch as both readers see it."""
    from torchaudio_contrib_tpu_torch.utils import trace
    bench = toy.write(tmp_path)
    seen = {}

    def keep(runner, seconds, start):
        seen["trace"] = progtrace.traced(runner, seconds, start)
        return seen["trace"]

    monkeypatch.setattr(devtrace, "traced", keep)
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.3)
    if not spans_on:
        monkeypatch.setattr(trace, "_recording", lambda: False)
    out = harness.run_cell(cell, 2 ** 31 + 17, 0.3, True, 0.0,
                           device="cuda", bench=bench, base=tmp_path)
    assert out["correct"], out["checks"]
    return seen["trace"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["c2_train", "c3_train"])
def test_card_rows_have_a_cause(tmp_path, monkeypatch, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    on = _stretch(tmp_path / "on", monkeypatch, cell, True)
    p = on["program"]
    print(json.dumps({"cell": cell, "program": p}))
    assert sum(s["rows"] for s in p["spans"].values()) * p["calls"] == \
        pytest.approx(on["events"])
    assert p["device_share"]["tac"] >= 0.99
    kernels = progtrace._kernel_pattern()
    fused = [s for k, s in p["spans"].items()
             if k.startswith("tac::fused_mel")]
    own = sum(n for s in fused for name, _, n in s["ops"]
              if kernels.search(name))
    assert p["glue"]["launches_per_call"] + own == \
        pytest.approx(sum(s["rows"] for s in fused))
    if cell == "c3_train":
        assert p["spans"]["tac::classifier.update"]["rows"] == 18
    off = _stretch(tmp_path / "off", monkeypatch, cell, False)
    assert off["program"]["device_share"].get("tac", 0) == 0
    # the same rows a call (a stretch's edges may cut one row off)
    assert round(on["events"] / on["calls"]) == \
        round(off["events"] / off["calls"])
