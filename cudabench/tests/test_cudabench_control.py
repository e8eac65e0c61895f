"""The lower-precision control of every cell, on the card at the cell's
own size: the plain reference in the program's place, in float32 with
TF32 on (the configurations state float32 with TF32 off), must come out
not correct on every seed.  Run on the GPU with

    python -m pytest -m cuda cudabench/tests/test_cudabench_control.py -s
"""
import json
import time

import pytest
import torch

from cudabench import harness

SEEDS = (4000009001, 4000009002, 4000009003)
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS:
        out = harness.run_cell(cell, seed, 2.0, False, time.perf_counter(),
                               control=True)
        print(json.dumps({"control": cell, "seed": seed,
                          "checks": out["checks"]}), flush=True)
        assert not out["correct"], out["checks"]
        torch.cuda.empty_cache()
