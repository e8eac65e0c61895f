"""Toy cells for the CPU tests: each real cell's system and driver at a
size the CPU runs in a second, written as files into a folder that
``harness.run_cell(base=...)`` reads.  On the CPU the program runs its
plain path, and the TF32 control equals the FP32 reference."""
from __future__ import annotations

import copy
import json
from pathlib import Path

from cudabench import harness

CONFIGS = {
    "tmel": {"source": "toy", "system": "fused_mel",
             "args": {"num_mels": 16, "sample_rate": 8000, "fft_length": 256,
                      "hop_length": 64, "to_db": True, "trainable": True},
             "precision": {"tf32": False}, "reduced": []},
    "tcnn": {"source": "toy", "system": "mel_classifier",
             "args": {"num_classes": 5, "num_mels": 16, "sample_rate": 8000,
                      "fft_length": 256, "hop_length": 64,
                      "channels": [4, 8, 8], "fused": True,
                      "trainable_frontend": True},
             "precision": {"tf32": False}, "reduced": []},
}
MIXES = {
    "tgrad": {"driver": "grad", "clips": 2, "clip_seconds": [0.5], "pool": 2,
              "keep": 3, "keep_span": 6},
    "tfwd": {"driver": "forward", "clips": 2, "clip_seconds": [0.5],
             "pool": 2, "keep": 3, "keep_span": 6},
    "ttrain": {"driver": "train_step", "clips": 4, "clip_seconds": [0.5],
               "pool": 4, "lr": 0.001},
}
# the toy stand-in of each cell, with the limits of its real cell
CELLS = {"c2_train": ("tmel", "tgrad"), "c3_train": ("tcnn", "ttrain"),
         "c2_fwd": ("tmel", "tfwd")}


def write(base: Path) -> dict:
    """Write the toy files under ``base``; returns a manifest whose cells
    are the real cells' names on the toy configurations and mixes."""
    for kind, items in (("configs", CONFIGS), ("traffic", MIXES)):
        (base / kind).mkdir(parents=True, exist_ok=True)
        for name, body in items.items():
            (base / kind / f"{name}.json").write_text(json.dumps(body))
    (base / "limits").mkdir(parents=True, exist_ok=True)
    bench = copy.deepcopy(harness.manifest())
    for cell in bench["workloads"]:
        cell["config"], cell["traffic"] = CELLS[cell["name"]]
        limits = harness.load_json("limits", cell["name"])
        (base / "limits" / f"{cell['name']}.json").write_text(
            json.dumps(limits))
    return bench
