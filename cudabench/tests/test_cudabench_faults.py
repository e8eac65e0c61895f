"""Each cell's check, driven through a whole run on the CPU at a toy size
with the chip's look skipped: sound, it comes out correct; with each fault
the cell can have planted under the timed path (``cudabench.faults``), it
comes out not correct.  The lower-precision control needs the card:
``test_cudabench_control.py``."""
import pytest
import torch

from cudabench import harness
from cudabench.tests import toy

torch.set_num_threads(2)

# faults each cell can have: a training step's state left unchanged only
# where there is state; no cell runs on more than one chip.  ``late`` (sound
# through set-up's warm-up steps, altered in the window) shows that the
# training cell checks the window's own steps
FAULTS = {"c2_train": ("half", "altered"),
          "c3_train": ("unchanged", "half", "altered", "late"),
          "c2_fwd": ("half", "altered")}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    base = tmp_path_factory.mktemp("toy")
    return base, toy.write(base)


def _run(files, cell, fault=None, seed=2 ** 31 + 5):
    base, bench = files
    return harness.run_cell(cell, seed, 0.2, False, 0.0, device="cpu",
                            bench=bench, base=base, fault=fault)


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_is_correct(files, cell):
    out = _run(files, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]])
def test_fault_is_not_correct(files, cell, fault):
    out = _run(files, cell, fault)
    assert not out["correct"], out["checks"]


def test_unchanged_state_reads_one(files):
    """A training step that leaves its state unchanged reads 1 on the
    first gradient and on the change, whatever the seed."""
    out = _run(files, "c3_train", "unchanged")
    assert out["checks"]["grad_gap"]["value"] == pytest.approx(1.0)
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)
