"""Shared helpers of the benchmark's CPU tests: a cell cut to a size the
host runs in seconds (the widths stay the configuration's)."""

import pytest

SMALL_TRAFFIC = {"pool_alerts": 256, "call_min": 40, "call_max": 200, "call_sizes": 8,
                 "set_alerts": 128}
SEED = 2**31 + 977


def shrink(ctx):
    """The context cut to the host: serving batch 64, training batch 32,
    small pools; the traced part of the window 1 s."""
    ctx.cfg = dict(ctx.cfg, serve_batch=64, model=dict(ctx.cfg["model"], batch_size=32))
    traffic = dict(ctx.traffic)
    traffic.update({k: v for k, v in SMALL_TRAFFIC.items() if k in traffic})
    if traffic.get("trace_seconds"):
        traffic["trace_seconds"] = 1
    ctx.traffic = traffic
    return ctx


@pytest.fixture
def small_cell():
    """``small_cell(ctx)`` → the cell's driver ``Cell`` on the shrunk
    context: pass it to ``run_cell(cell_factory=...)``."""
    from benchmark import harness

    def factory(ctx):
        shrink(ctx)
        return harness.load_module("drivers", ctx.traffic["driver"]).Cell(ctx)
    return factory
