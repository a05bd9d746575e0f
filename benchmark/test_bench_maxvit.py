"""CPU tests of the MaxViT cell (run: ``python -m pytest benchmark -n 6``):
a sound run is correct, the control fails a limit, each fault of
``faults_maxvit.py`` planted in the plain path is not correct, the work
arithmetic agrees with an independent tally, and the new readers read what
they should and nothing where the program records nothing.

The cell runs at a small size: the program's and the configuration's
MaxViT cut to the tests' spec (depths (1, 1), widths 32 / 64, stem 32,
64×64 input, window 2), a pool of 32 alerts, calls of 8-24, batch 16.
"""

import pytest
import torch

from benchmark import counts_maxvit, harness
from benchmark.conftest import SEED
from benchmark.faults_maxvit import FAULTS
from benchmark.run import run_cell

WORKLOAD = "maxvit-archive"
TINY = {"depths": (1, 1), "dims": (32, 64), "stem_width": 32}


@pytest.fixture
def tiny_cell(monkeypatch):
    """A factory of the cell cut to the host (module docstring)."""
    from benchmark.drivers import archive_maxvit
    from btsbot_tpu_torch.models import maxvit

    monkeypatch.setitem(maxvit.MAXVIT_CONFIGS, "maxvit_tiny", TINY)
    monkeypatch.setattr(archive_maxvit, "CALIBRATION_ALERTS", 16)

    def factory(ctx):
        ctx.cfg = dict(ctx.cfg, dims=list(TINY["dims"]), depths=list(TINY["depths"]),
                       stem_width=TINY["stem_width"], window=2, image_size=64, serve_batch=16,
                       model=dict(ctx.cfg["model"], model_kind="maxvit_tiny_rw_64.test"))
        ctx.traffic = dict(ctx.traffic, pool_alerts=32, call_min=8, call_max=24, call_sizes=4,
                           trace_seconds=1)
        return archive_maxvit.Cell(ctx)
    return factory


def _context():
    entry = next(w for w in harness.load_benchmark()["workloads"] if w["name"] == WORKLOAD)
    return harness.Context(WORKLOAD, SEED, torch.device("cpu"),
                           harness.load_json("configs", entry["config"]),
                           harness.load_json("traffic", entry["traffic"]))


def test_a_sound_run_is_correct(tiny_cell):
    result = run_cell(WORKLOAD, SEED, 1.0, False, device="cpu", cell_factory=tiny_cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"]["score_alerts_per_s"]["value"] > 0


def test_the_calibrated_logits_lie_where_a_float32_sigmoid_resolves_them(tiny_cell):
    """The drawn weights' logits over the calibration batch: mean 0 and
    spread ``LOGIT_STD``, well inside the ~16.6 at which a sigmoid reads 1."""
    from benchmark.drivers import archive_maxvit
    from benchmark.reference.mm_maxvit import LOGIT_STD, Reference

    cfg = tiny_cell(_context()).cfg
    weights = archive_maxvit.make_weights(cfg, SEED, torch.float32, torch.device("cpu"))
    images, meta = harness.make_pool(archive_maxvit.CALIBRATION_ALERTS,
                                     len(cfg["model"]["metadata_cols"]), SEED + 3, "cpu")
    with torch.no_grad():
        z = Reference(cfg).logits(weights, torch.from_numpy(images), torch.from_numpy(meta))
    assert abs(float(z.mean())) < 1e-4 * LOGIT_STD
    assert float(z.std()) == pytest.approx(LOGIT_STD, rel=1e-4)


def test_the_control_fails_a_limit(tiny_cell):
    """The reference with every product's operands at 4 mantissa bits."""
    cell = tiny_cell(_context())
    cell.setup()
    cell.window(0.5, harness.TraceWindow(False, None, cell.ctx.device))
    cell.release()
    assert all(c.ok for c in cell.checks())
    control = cell.control()
    assert not all(c.ok for c in control), [(c.name, c.value) for c in control]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault, tiny_cell):
    with FAULTS[fault]():
        result = run_cell(WORKLOAD, SEED, 1.0, False, device="cpu", cell_factory=tiny_cell)
    assert not result["correct"], result["checks"]


def test_the_forward_count_agrees_with_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from btsbot_tpu_torch.models.factory import build_model

    cfg = _context().cfg
    model = build_model(cfg["model"], device="cpu").eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.randn(1, 63, 63, 3), torch.randn(1, 25))
    assert counts_maxvit.forward_flops_per_alert(cfg) == pytest.approx(
        counter.get_total_flops(), rel=0.01)
    assert counts_maxvit.forward_flops_per_alert(cfg) == pytest.approx(10.6e9, rel=0.01)


def test_an_attention_launchs_work_by_hand():
    # stage 0 at batch 3072: 3072 · 56² tokens, C = 64 (2 heads), window 7
    tokens = 3072 * 56 * 56
    b, o = counts_maxvit.attention_work(3072, 56, 64, 7, 2)
    assert b == (tokens * 4 * 64 + 169 * 2) * 2 and o == 4 * 49 * 64 * tokens
    # 4.93 GB at 3.35 TB/s against 123 GFLOP at 989 TFLOP/s: bound by bytes
    assert b / 3.35e12 > o / 989e12


def _reader(name):
    return harness.load_module("layer_metrics", name).read


SCORE_TRACE = harness.Trace(window_s=2.0, kernels=[
    ("partition_attention_bf16_kernel", 0.1, 0.004), ("partition_attention_bf16_kernel", 0.2, 0.006),
    ("ln_mlp_bf16_kernel", 0.3, 0.5)], memcpys=[], host=[])


def test_the_readers_read_the_trace_and_the_programs_counter(monkeypatch):
    from btsbot_tpu_torch.utils import profiling

    cfg = _context().cfg
    monkeypatch.setattr(profiling, "counters", lambda: {"partition_attention.bytes": 5e8})
    run = harness.LayerRun(trace=SCORE_TRACE, counters={"forward_rows": [192, 3072],
                                                        "alerts_traced": 2000}, cfg=cfg)
    bound = sum(counts_maxvit.attention_bound_s(cfg, r, "bfloat16") for r in (192, 3072))
    assert _reader("partition_attention_roofline.score")(run) == pytest.approx(
        100 * bound / 0.010)
    assert _reader("partition_attention_gbps.score")(run) == pytest.approx(50.0)
    assert _reader("maxvit_mfu.score")(run) == pytest.approx(
        100 * counts_maxvit.forward_flops_per_alert(cfg) * 2000 / 2.0 / 989e12)
    # the parent's program: no such kernel, no counter
    bare = harness.Trace(window_s=2.0, kernels=[("ln_mlp_bf16_kernel", 0.3, 0.5)], memcpys=[],
                         host=[])
    monkeypatch.setattr(profiling, "counters", lambda: {})
    run = harness.LayerRun(trace=bare, counters={"forward_rows": [192]}, cfg=cfg)
    assert _reader("partition_attention_roofline.score")(run) is None
    assert _reader("partition_attention_gbps.score")(run) is None
    assert _reader("maxvit_mfu.score")(harness.LayerRun(None, {}, cfg)) is None


def test_a_traced_run_on_the_host_prints_the_forward_share(tiny_cell):
    from btsbot_tpu_torch.utils import profiling

    profiling.reset_counters()
    result = run_cell(WORKLOAD, SEED, 1.0, True, device="cpu", cell_factory=tiny_cell)
    assert result["metrics"]["maxvit_mfu.score"]["value"] > 0
    # the host runs no kernel: the kernel's readers find nothing
    assert "partition_attention_roofline.score" not in result["metrics"]
    assert "partition_attention_gbps.score" not in result["metrics"]
