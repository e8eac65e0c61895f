"""The ``w2v2_asr_serve`` cell: its check driven through whole runs on the
CPU at a toy size (``conftest.py``'s ``tw2v2``/``tasr``), sound and with
faults planted under the timed path; the counted work against a hand
count; the traffic's one draw of lengths; the bundle's geometry against
the configuration.  On the card (``-m cuda``), at the cell's own size,
the planted faults on three seeds and the trace's kernel families:

    python -m pytest -m cuda cudabench/tests/test_cudabench_w2v2.py -s
"""
import json

import pytest
import torch

from cudabench import devtrace, harness
from cudabench.drivers import asr_serve
from cudabench.metrics import _library
from cudabench.systems import wav2vec2_asr as W
from cudabench.tests import toy

torch.set_num_threads(2)

CELL = "w2v2_asr_serve"
SEEDS = (4100000001, 4100000002, 4100000003)


class Faulty:
    """``faults.Faulty``'s ``half`` and ``altered`` for a model called as
    ``prog(x, lengths)``: half of the batch left out and answered with
    the other half's rows, or one logit moved by 1 where it is produced."""

    def __init__(self, prog, kind):
        self._prog, self._kind = prog, kind

    def __call__(self, x, lengths):
        if self._kind == "half":
            b = x.shape[0]
            h = b - b // 2
            y, n = self._prog(x[:h], lengths[:h])
            return torch.cat([y, y[:b - h]]), torch.cat([n, n[:b - h]])
        y, n = self._prog(x, lengths)
        y = y.clone()
        y[0, 0, 0] += 1.0
        return y, n


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


def _run(files, trace=False, seed=2 ** 31 + 5):
    base, bench = files
    return harness.run_cell(CELL, seed, 0.2, trace, 0.0, device="cpu",
                            bench=bench, base=base)


@pytest.mark.parametrize("kind", ["half", "altered"])
def test_fault_is_not_correct(files, monkeypatch, kind):
    _plant(monkeypatch, kind)
    out = _run(files)
    assert not out["correct"], out["checks"]
    assert out["checks"]["emission_gap"]["value"] > 1e-3


def test_sound_run_is_correct(files, monkeypatch):
    """A sound traced run is correct; its pad share is the window's valid
    frames over what the program's counter moved, ``batch · T'`` a call,
    counted here by hand from the same draw and the window's calls."""
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.2)
    base, bench = files
    cfg = harness.load_json("configs", "tw2v2", base)
    mix = harness.load_json("traffic", "tasr", base)
    seed = 2 ** 31 + 9
    out = harness.run_cell(CELL, seed, 0.2, True, 0.0, device="cpu",
                           bench=bench, base=base)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["decode_gap"]["value"] == 0
    rows = asr_serve.draw_lengths(mix["clips"], mix["pool"], 800, 4000,
                                  mix["length_seed"], seed)
    # the window's calls 0, 1, ... take batches 0, 1, 0, 1, ...
    batches = [i % mix["pool"] for i in range(out["attempted"])]
    valid = sum(W.frames(cfg, n) for b in batches for n in rows[b])
    padded = sum(len(rows[b]) * W.frames(cfg, max(rows[b]))
                 for b in batches)
    want = 100.0 * (1 - valid / padded)
    assert out["metrics"]["w2v2_pad_share"]["value"] == pytest.approx(
        want, rel=1e-9)
    assert out["metrics"]["step_mfu.w2v2"]["value"] > 0


def test_decode_gap_counts_a_changed_token(files):
    """The check's decode number counts each request whose tokens differ
    from the plain collapse of the log-probabilities the decode took."""
    base, _ = files
    cfg = harness.load_json("configs", "tw2v2", base)
    gen = torch.Generator().manual_seed(3)
    model, given = W.build(cfg, gen, "cpu")
    lengths = torch.tensor([4000, 2500, 900])
    x = 0.1 * torch.randn(3, 4000, generator=gen)
    x = torch.where(torch.arange(4000)[None] < lengths[:, None], x, 0.0)
    with torch.no_grad():
        out = [o.clone() for o in W.forward(model, x, lengths)]
    assert W.check_forward(cfg, given, [(0, x, lengths, *out)])[
        "decode_gap"] == 0
    tokens, token_lengths = out[3], out[4]
    tokens[1, 0] = (tokens[1, 0] + 1) % cfg["args"]["aux_out"]
    token_lengths[2] += 1
    assert W.check_forward(cfg, given, [(0, x, lengths, *out)])[
        "decode_gap"] == 2


def test_work_counted_by_hand():
    """BASE at one shape: requests of 4 s and 16 s padded to 16 s.

    Frames: 16 s → 799, 4 s → 199.  Conv 0 over the padded 256 000
    samples: 51 199 outputs × 512 × 10 × 2 = 524.3 MFLOP a request.  Convs
    1–6 over the valid frames (16 s: 25 599, 12 799, 6 399, 3 199, 1 599,
    799; 4 s: 6 399, 3 199, 1 599, 799, 399, 199), 2 · t · 512 · 512 · k.
    Positional: 2 · T' · 768 · 48 · 128.  Products a frame: 512 · 768 +
    12 · (4 · 768² + 2 · 768 · 3 072) + 768 · 29, twice; attention
    4 · T'² · 768 a layer."""
    cfg = harness.load_json("configs", "wav2vec2_asr_base")
    w = W.work(cfg, [256000, 64000], 256000)
    mac = 512 * 512 * 2
    conv = 2 * 2 * 51199 * 512 * 10
    conv += mac * 3 * (25599 + 12799 + 6399 + 3199) + mac * 2 * (1599 + 799)
    conv += mac * 3 * (6399 + 3199 + 1599 + 799) + mac * 2 * (399 + 199)
    conv += 2 * (799 + 199) * 768 * 48 * 128
    per_frame = 512 * 768 + 12 * (4 * 768 ** 2 + 2 * 768 * 3072) + 768 * 29
    gemm = 2 * (799 + 199) * per_frame + 12 * 4 * 768 * (799 ** 2 + 199 ** 2)
    assert w["conv"][0] == conv and w["gemm"][0] == gemm
    assert w["step"] == conv + gemm
    assert W.frames(cfg, 256000) == 799 and W.frames(cfg, 64000) == 199
    # the weights alone are 94.4 M floats; both keys carry them once
    assert w["conv"][1] + w["gemm"][1] > 4 * 94.0e6


def test_lengths_are_one_draw():
    """The pool's lengths are one draw of the mix's ``length_seed``,
    independent and uniform over 4–16 s: every seed gets the same batches
    and padded shapes, in its own order inside each batch."""
    lo, hi = 64000, 256000
    want = asr_serve.draw_lengths(8, 8, lo, hi, 0, SEEDS[0])
    orders = set()
    for seed in SEEDS:
        rows = asr_serve.draw_lengths(8, 8, lo, hi, 0, seed)
        assert rows == asr_serve.draw_lengths(8, 8, lo, hi, 0, seed)
        assert [sorted(r) for r in rows] == [sorted(r) for r in want]
        orders.add(tuple(map(tuple, rows)))
    assert len(orders) == len(SEEDS)
    flat = [n for row in want for n in row]
    assert lo <= min(flat) and max(flat) <= hi
    # batches are not made alike: their longest requests differ
    assert len({max(row) for row in want}) == 8
    other = asr_serve.draw_lengths(8, 8, lo, hi, 1, SEEDS[0])
    assert sorted(map(sorted, other)) != sorted(map(sorted, want))


def test_bundle_builds_the_configuration():
    cfg = harness.load_json("configs", "wav2vec2_asr_base")
    gen = torch.Generator().manual_seed(5)
    model = W.make_model(cfg, gen, "cpu")
    assert W._geometry(model) == W._model_args(cfg)
    assert sum(p.numel() for p in model.parameters()) == pytest.approx(
        94.4e6, rel=1e-2)
    wrong = dict(cfg, args=dict(cfg["args"], ff_dim=2048))
    with pytest.raises(ValueError):
        W.make_model(wrong, gen, "cpu")


# (name, family): the cell's own rows on the card (H100, torch 2.11) and
# the other names cuDNN and cuBLAS give their float32 kernels
NAMES = (
    ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, "
     "false, false, true>(int, int, int, float const*, int, float*)",
     "conv"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
     "tilesize32x32x8_stage3_warpsize1x2x1_g1_ffma_aligna4_alignc4_"
     "execute_kernel__5x_cudnn", "conv"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_"
     "warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas", "gemm"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_"
     "warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas", "gemm"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<float>", "conv"),
    ("void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>",
     "conv"),
    ("ampere_sgemm_128x64_tn", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>",
     "gemm"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float>", "gemm"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, float>",
     "gemm"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, "
     "float, 10, false, false>", None),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "GeluCUDAKernelImpl>", None),
)


@pytest.mark.parametrize("name,family", NAMES)
def test_kernel_families(name, family):
    conv = bool(_library.CONV.search(name))
    gemm = bool(_library.GEMM.search(name))
    assert (conv, gemm) == (family == "conv", family == "gemm")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["half", "altered"])
def test_card_fault_is_not_correct(monkeypatch, kind):
    _card()
    _plant(monkeypatch, kind)
    for seed in SEEDS:
        out = harness.run_cell(CELL, seed, 2.0, False, 0.0)
        print(json.dumps({"fault": kind, "seed": seed,
                          "checks": out["checks"]}), flush=True)
        assert not out["correct"], out["checks"]
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_card_trace_kernel_families(monkeypatch):
    """The traced stretch of the cell: no device row is of both families,
    both roofline shares are read and stay under 100 %."""
    _card()
    seen = {}
    traced = devtrace.traced

    def keep(runner, seconds, start):
        seen["trace"] = traced(runner, seconds, start)
        return seen["trace"]

    monkeypatch.setattr(devtrace, "traced", keep)
    out = harness.run_cell(CELL, SEEDS[0], 2.0, True, 0.0)
    ops = seen["trace"]["device_ops"]
    print(json.dumps({"ops": sorted(([k, v[0], v[1]] for k, v in
                                     ops.items()), key=lambda r: -r[1])}))
    assert out["correct"], out["checks"]
    both = [k for k in ops
            if _library.CONV.search(k) and _library.GEMM.search(k)]
    assert not both, both
    for name in ("w2v2_conv_roofline", "w2v2_gemm_roofline",
                 "w2v2_pad_share", "step_mfu.w2v2"):
        assert 0 < out["metrics"][name]["value"] < 100, name
    assert out["metrics"]["launches_per_call.w2v2"]["value"] > 0
    assert 0 <= out["metrics"]["idle_share.w2v2"]["value"] < 100
