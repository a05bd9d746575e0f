"""CPU tests of the per-layer readers of the program's own spans and
counters (run: ``python -m pytest benchmark -n 6``).

Each reader gets a hand-built ``Trace`` and counters and gives the
hand-computed reading, and nothing where the spans or the counters are
missing, as on a program that records none.  A traced run of each kind of
cell on the host, at a small size, prints the readings.
"""

import pytest

from benchmark import harness, program_trace
from benchmark.conftest import SEED
from benchmark.run import run_cell
from btsbot_tpu_torch.utils import profiling

ARCHIVE = ["useful_rows_pct.score", "host_prep_ms_per_batch.score", "h2d_gbps.score"]
TRAIN = ["feed_ms_per_step.train", "step_enqueue_ms.train"]

# two scored batches: pads of 2 ms + 1 ms and 3 ms + 1 ms, HtoD copies of
# 0.020 s + 0.004 s on the card (a DtoH copy that does not count)
SCORE_TRACE = harness.Trace(
    window_s=1.0, kernels=[("convnext_block", 0.1, 0.01)],
    memcpys=[("Memcpy HtoD (Pageable -> Device)", 0.11, 0.020),
             ("Memcpy HtoD (Pageable -> Device)", 0.14, 0.004),
             ("Memcpy DtoH (Device -> Pageable)", 0.2, 0.5)],
    host=[("serve.batch", 0.1, 0.3), ("serve.pad", 0.1, 0.002), ("serve.h2d", 0.11, 0.02),
          ("serve.pad", 0.13, 0.001), ("aten::copy_", 0.11, 0.02),
          ("serve.batch", 0.5, 0.3), ("serve.pad", 0.5, 0.003), ("serve.pad", 0.6, 0.001)])
SCORE_COUNTS = {"serve.batches": 2, "serve.rows": 3500, "serve.padded_rows": 4000,
                "serve.h2d_bytes": 96_000_000}
# three steps of 40, 50 and 60 ms; feeds of 5 + 1 + 1 + 1 ms each
TRAIN_TRACE = harness.Trace(
    window_s=1.0, kernels=[], memcpys=[],
    host=[h for i, run in enumerate((0.040, 0.050, 0.060))
          for h in (("step.run", 0.2 * i, run), ("step.forward", 0.2 * i, 0.01),
                    ("feed.gather", 0.2 * i + 0.1, 0.005),
                    *[("feed.to_device", 0.2 * i + 0.11, 0.001)] * 3)])


def read(name, trace, counters, monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    run = harness.LayerRun(trace=trace, counters={}, cfg={})
    return harness.load_module("layer_metrics", name).read(run)


@pytest.mark.parametrize("name,want", [
    ("useful_rows_pct.score", 87.5),
    ("host_prep_ms_per_batch.score", 3.5),
    ("h2d_gbps.score", 4.0),
    ("feed_ms_per_step.train", 8.0),
    ("step_enqueue_ms.train", 50.0),
])
def test_each_reader_gives_the_hand_computed_reading(name, want, monkeypatch):
    trace, counts = (SCORE_TRACE, SCORE_COUNTS) if name.endswith(".score") else \
        (TRAIN_TRACE, {})
    assert read(name, trace, counts, monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("name", ARCHIVE + TRAIN)
def test_a_reader_gives_nothing_without_the_programs_records(name, monkeypatch):
    bare = harness.Trace(window_s=1.0, kernels=[("k", 0.0, 0.1)],
                         memcpys=[("Memcpy HtoD (Pageable -> Device)", 0.0, 0.02)],
                         host=[("aten::copy_", 0.0, 0.02)])
    full = SCORE_TRACE if name.endswith(".score") else TRAIN_TRACE
    assert read(name, None, SCORE_COUNTS, monkeypatch) is None
    if name in ("useful_rows_pct.score", "h2d_gbps.score"):  # counters missing
        assert read(name, full, {}, monkeypatch) is None
        monkeypatch.delattr(profiling, "counters")  # a program with no counters
        assert program_trace.counters() == {}
        assert harness.load_module("layer_metrics", name).read(
            harness.LayerRun(trace=full, counters={}, cfg={})) is None
    else:  # spans missing
        assert read(name, bare, SCORE_COUNTS, monkeypatch) is None


def test_no_copy_time_gives_no_rate(monkeypatch):
    no_copy = harness.Trace(window_s=1.0, kernels=[], memcpys=[], host=SCORE_TRACE.host)
    assert read("h2d_gbps.score", no_copy, SCORE_COUNTS, monkeypatch) is None


@pytest.mark.parametrize("workload,names", [("pico-archive", ARCHIVE[:2]),
                                            ("pico-train", TRAIN)])
def test_a_traced_run_on_the_host_prints_the_readings(workload, names, small_cell):
    profiling.reset_counters()
    result = run_cell(workload, SEED, 1.0, True, device="cpu", cell_factory=small_cell)
    for name in names:
        assert result["metrics"][name]["value"] > 0, name
    if workload == "pico-archive":  # the host has no host-to-device copies to time
        assert "h2d_gbps.score" not in result["metrics"]
        assert 0 < result["metrics"]["useful_rows_pct.score"]["value"] <= 100
