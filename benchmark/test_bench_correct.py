"""CPU tests of what decides ``correct``: a sound run passes, the control
fails, and a run with the timed path broken underneath fails, once for each
fault a cell can have (run: ``python -m pytest benchmark -n 6``).

The run skips only the look for a card: set-up, window and comparison are
the benchmark's own, on the host at a small size (``conftest.shrink``).
"""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.conftest import SEED, shrink
from benchmark.faults import FAULTS
from benchmark.run import run_cell

CELLS = ["pico-archive", "nano-archive", "pico-train"]
DRIVER = {"pico-archive": "archive", "nano-archive": "archive", "pico-train": "train"}


def run(workload, factory):
    return run_cell(workload, SEED, 1.0, False, device="cpu", cell_factory=factory)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload, small_cell):
    result = run(workload, small_cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_a_limit(workload):
    """The lower precision in the program's place (the program's int8 path
    for the bfloat16 cells, TF32 products for float32 training)."""
    entry = next(w for w in harness.load_benchmark()["workloads"]
                 if w["name"] == workload)
    ctx = shrink(harness.Context(workload, SEED, torch.device("cpu"),
                                 harness.load_json("configs", entry["config"]),
                                 harness.load_json("traffic", entry["traffic"])))
    cell = harness.load_module("drivers", ctx.traffic["driver"]).Cell(ctx)
    cell.setup()
    cell.window(0.5, harness.TraceWindow(False, None, ctx.device))
    cell.release()
    assert all(c.ok for c in cell.checks())
    control = cell.control()
    assert not all(c.ok for c in control), [(c.name, c.value) for c in control]


@pytest.mark.parametrize("workload,fault", [(w, f) for w in CELLS
                                            for f in sorted(FAULTS[DRIVER[w]])])
def test_a_planted_fault_is_not_correct(workload, fault, small_cell):
    with FAULTS[DRIVER[workload]][fault]():
        result = run(workload, small_cell)
    assert not result["correct"], result["checks"]


def test_logits_of_inverts_the_sigmoid():
    z = np.linspace(-8, 8, 33)
    s = (1 / (1 + np.exp(-z))).astype(np.float32)
    np.testing.assert_allclose(harness.logits_of(s), z, atol=1e-4)
