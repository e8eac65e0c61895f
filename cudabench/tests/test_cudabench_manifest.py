"""``BENCHMARK.json`` against the benchmark's contract, the harness's
lookup by name, its imports, its refusal without a card and its result
line's keys."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cudabench import harness
from cudabench.tests import toy

torch.set_num_threads(2)

ROOT = harness.ROOT
BENCH = harness.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_./-]+$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.fixture(scope="module")
def bench():
    return harness.manifest()


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert bench["command"] == ["python3", "cudabench/run.py"]
    assert bench["paths"] == ["cudabench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    assert 1 <= cells <= 24
    # a full check with 24 cells fits the driver's 43 200 s
    assert ((2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
        assert all(NAME.match(n) for n in names), names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}


def test_configs_and_cells_found_by_name(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"cudabench/configs/{c['name']}.json"
        body = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16 and set(c["reduced"]) <= set(body)
        assert _line(body["source"])
        assert body["precision"] == {"tf32": False}
        assert (BENCH / "systems" / f"{body['system']}.py").exists()
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = harness.load_json("traffic", w["traffic"])
        assert (BENCH / "drivers" / f"{mix['driver']}.py").exists()
        assert harness.load_json("limits", w["name"])
        e2e = harness.cell_metrics(bench, w["name"], "end_to_end")
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        per = harness.cell_metrics(bench, w["name"], "per_layer")
        assert per, w["name"]
        for m in per:
            assert m["moves"] in names, (w["name"], m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = m["name"].split(".")[0]
        assert (BENCH / "metrics" / f"{reader}.py").exists(), m["name"]


def test_committed_file_names():
    out = subprocess.run(["git", "ls-files", "--others", "--cached",
                          "--exclude-standard", "cudabench"], cwd=ROOT,
                         capture_output=True, text=True)
    if out.returncode != 0:
        pytest.skip("not a git checkout")
    for name in out.stdout.split():
        assert FILE.match(name), name


def _copy_bench(dst: Path) -> Path:
    shutil.copytree(BENCH, dst / "cudabench", ignore=shutil.ignore_patterns(
        ".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst / "cudabench"


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix, limits and a per-layer metric dropped in as
    new files, and a cell naming them, run without an edit to any file."""
    copy = _copy_bench(tmp_path)
    (copy / "configs" / "tmel_new.json").write_text(
        json.dumps(toy.CONFIGS["tmel"]))
    (copy / "traffic" / "tfwd_new.json").write_text(
        json.dumps(toy.MIXES["tfwd"]))
    (copy / "limits" / "toy_new.json").write_text(
        json.dumps({"logmel_db_gap": 1e-3}))
    (copy / "metrics" / "calls_in_window.py").write_text(
        "def read(m):\n    return float(m['window']['calls'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "toy_new", "config": "tmel_new",
                               "traffic": "tfwd_new", "chips": 1,
                               "why": "toy"})
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry and dispatch",
                               "moves": "frames_per_s",
                               "workloads": ["toy_new"]})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s" and "workloads" in m:
            m["workloads"].append("toy_new")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, torch; torch.set_num_threads(2);"
            "from cudabench import harness;"
            "out = harness.run_cell('toy_new', 3, 0.2, True, 0.0, "
            "device='cpu'); print(harness.__file__); print(json.dumps(out))")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-2].startswith(str(tmp_path))
    out = json.loads(lines[-1])
    assert out["metrics"]["calls_in_window"]["value"] == out["attempted"]
    assert out["correct"]


def test_run_imports_no_jax():
    """``run.py`` and every module of the harness, with the program's
    modules they load: no top-level module named like JAX or the JAX
    package (compared whole: the port's name begins with the latter)."""
    code = f"""
import importlib, importlib.util, pkgutil, sys
spec = importlib.util.spec_from_file_location("cudabench_run", {str(BENCH / 'run.py')!r})
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
import cudabench
for info in pkgutil.walk_packages(cudabench.__path__, "cudabench."):
    if ".tests" not in info.name:
        importlib.import_module(info.name)
import torchaudio_contrib_tpu_torch.models.frontend
import torchaudio_contrib_tpu_torch.models.layers
found = run.harness.forbidden_modules()
print(found)
sys.exit(1 if found else 0)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for cwd in (ROOT, _copy_bench(tmp_path).parent):
        res = subprocess.run(
            [sys.executable, "cudabench/run.py", "--workload", "c2_fwd",
             "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300)
        assert res.returncode != 0 and res.stdout == ""


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tmp_path, trace):
    bench = toy.write(tmp_path)
    out = harness.run_cell("c2_fwd", 11, 0.2, trace, 0.0, device="cpu",
                           bench=bench, base=tmp_path)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if trace else ["checks"]
    assert list(out) == keys
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["device"]) == (dev | {"busy_s", "window_s"} if trace
                                  else dev)
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)
