"""Run one cell of ``BENCHMARK.json`` and print its result line.

Everything that belongs to a cell is found by name: the configuration in
``configs/<config>.json`` (its ``system`` names a module of ``systems/``),
the traffic mix in ``traffic/<traffic>.json`` (its ``driver`` names a
module of ``drivers/``; ``gen.Traffic`` reads the rest), each metric's
reader in ``metrics/<metric>.py`` (a metric ``<metric>.<part>`` is the
same quantity in the cells of another end-to-end metric, read by the same
reader) and the limits of the cell's compared numbers in
``limits/<workload>.json``.

A run: set-up (build the program, make the inputs on the device from the
seed, warm every shape up) -> the window (``--seconds`` of calls, closed
by a synchronise) -> with ``--trace 1`` a profiled stretch of
``TRACE_SECONDS`` -> the check against the plain reference -> the result.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRACE_SECONDS = 1.0
FORBIDDEN = ("jax", "jaxlib", "flax", "torchaudio_contrib_tpu")


class Context:
    """What a driver's runner gets: the configuration, the mix, the
    traffic, the system module, the device, the seeded generator and the
    factory that builds the program (``system.build``, or the control)."""

    def __init__(self, cfg, mix, traffic, system, device, gen, factory):
        self.cfg, self.mix, self.traffic = cfg, mix, traffic
        self.system, self.device, self.gen = system, device, gen
        self.factory = factory


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, base: Path = BENCH) -> dict:
    return json.loads((base / kind / f"{name}.json").read_text())


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The entries of ``bench[kind]`` that this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", control: bool = False,
             bench: dict | None = None, base: Path = BENCH,
             fault: str | None = None) -> dict:
    """One run of the cell; returns the result line's object.  ``control``
    puts the system's lower-precision control in the program's place;
    ``bench`` and ``base`` stand in for ``BENCHMARK.json`` and the folder
    of configurations, mixes and limits, and ``fault`` plants one of
    ``faults.KINDS`` under the timed path (tests)."""
    parts = {"start": time.perf_counter() - t_start}
    import torch

    from . import gen as G
    from .loop import Spans, synchronize
    from .work import PEAK_BYTES, PEAK_FP32
    parts["torch"] = time.perf_counter() - t_start
    from torchaudio_contrib_tpu_torch.ops import _launches
    parts["program_import"] = time.perf_counter() - t_start
    if device == "cuda":
        torch.zeros(1, device=device)
    parts["device_context"] = time.perf_counter() - t_start

    bench = bench or manifest()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = load_json("configs", cell["config"], base)
    mix = load_json("traffic", cell["traffic"], base)
    limits = load_json("limits", workload, base)
    tf32 = bool(cfg["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    system = importlib.import_module(f"cudabench.systems.{cfg['system']}")
    driver = importlib.import_module(f"cudabench.drivers.{mix['driver']}")
    traffic = G.Traffic(mix, cfg["args"]["sample_rate"], seed)
    factory = system.control if control else system.build
    if fault is not None:
        from .faults import wrap
        factory = wrap(fault, factory)
    ctx = Context(cfg, mix, traffic, system, device,
                  traffic.generator(device), factory)
    runner = driver.Runner(ctx)
    parts["runner"] = time.perf_counter() - t_start
    synchronize(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = _launches.counts()
    gc.collect()
    gc.disable()          # no collector pass inside the measured window
    setup_s = time.perf_counter() - t_start
    window = runner.run(seconds, Spans(), 0)
    gc.enable()
    launches = _launches.delta(before)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    tr = None
    if trace:
        from .devtrace import traced
        tr = traced(runner, TRACE_SECONDS, window["next"])
    print(json.dumps({"launches": launches, "calls": window["calls"],
                      "setup_parts_s": parts,
                      "card": card_line() if device == "cuda" else device,
                      "peaks": {"fp32_flops": PEAK_FP32,
                                "bytes_per_s": PEAK_BYTES}}),
          flush=True)
    numbers = runner.check()
    m = {"setup_s": setup_s, "window": window, "trace": tr}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry in cell_metrics(bench, workload, kind):
        reader = importlib.import_module(
            f"cudabench.metrics.{entry['name'].split('.')[0]}")
        value = reader.read(m)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    correct = (window["failed"] == 0 and bool(checks) and all(
        c["limit"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": window["calls"],
           "failed": window["failed"], "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = tr["breakdown"]
    out["checks"] = checks
    return out


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = manifest()
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), t_start, bench=bench)
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the run must not load: {found}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
