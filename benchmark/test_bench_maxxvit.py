"""CPU tests of the MaxxViT cell (run: ``python -m pytest benchmark -n 6``):
a sound run is correct, the control fails a limit, each fault of
``faults_maxxvit.py`` planted in the plain path is not correct, the work
arithmetic agrees with an independent tally at the published widths, and
the new readers read what they should and nothing where the program
records nothing.

The cell runs at a small size: the program's and the configuration's
MaxxViT cut to the tests' spec (depths 1 / 1 / 1 / 1, widths 32 / 64 / 128 /
256, stem 16 → 32, 128×128 input, window 4: 16 tokens a partition, so the
bias table weighs in the scores), a pool of 32 alerts, calls of 8-24, batch
16.
"""

import pytest
import torch

from benchmark import counts, counts_ln_qkv, counts_maxvit, counts_maxxvit, harness
from benchmark.conftest import SEED
from benchmark.faults_maxxvit import FAULTS
from benchmark.run import run_cell

WORKLOAD = "maxxvit-archive"
TINY = {"depths": (1, 1, 1, 1), "dims": (32, 64, 128, 256), "stem_width": (16, 32)}


@pytest.fixture
def tiny_cell(monkeypatch):
    """A factory of the cell cut to the host (module docstring)."""
    from benchmark.drivers import archive_maxxvit
    from btsbot_tpu_torch.models import maxvit

    monkeypatch.setitem(maxvit.MAXXVIT_CONFIGS, "maxxvit_rmlp_small", TINY)
    monkeypatch.setattr(archive_maxxvit, "CALIBRATION_ALERTS", 16)

    def factory(ctx):
        ctx.cfg = dict(ctx.cfg, dims=list(TINY["dims"]), depths=list(TINY["depths"]),
                       stem_width=list(TINY["stem_width"]), window=4, image_size=128,
                       serve_batch=16,
                       model=dict(ctx.cfg["model"], model_kind="maxxvit_rmlp_small_rw_128.test"))
        ctx.traffic = dict(ctx.traffic, pool_alerts=32, call_min=8, call_max=24, call_sizes=4,
                           trace_seconds=1)
        return archive_maxxvit.Cell(ctx)
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


def test_the_drawn_weights_spread_the_tables_and_the_logits(tiny_cell):
    """Each table spreads ``TABLE_STD`` over its offsets; the calibration
    batch's logits have mean 0 and spread ``LOGIT_STD``."""
    from benchmark.drivers import archive_maxxvit
    from benchmark.reference.mm_maxxvit import LOGIT_STD, TABLE_STD, Reference

    cfg = tiny_cell(_context()).cfg
    weights = archive_maxxvit.make_weights(cfg, SEED, torch.float32, torch.device("cpu"))
    ref = Reference(cfg)
    heads = [n[:-len("attn.qkv.weight")] for n in weights if n.endswith("attn.qkv.weight")]
    assert len(heads) == 8
    for h in heads:
        spread = ref.table(weights, h).var(dim=0, unbiased=False).mean().sqrt()
        assert float(spread) == pytest.approx(TABLE_STD, rel=1e-4)
    images, meta = harness.make_pool(archive_maxxvit.CALIBRATION_ALERTS,
                                     len(cfg["model"]["metadata_cols"]), SEED + 3, "cpu")
    with torch.no_grad():
        z = ref.logits(weights, torch.from_numpy(images), torch.from_numpy(meta))
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
    """At the published widths: the count is the flop counter's (which also
    counts the 22 tables' MLPs, made once a forward)."""
    from torch.utils.flop_counter import FlopCounterMode

    from btsbot_tpu_torch.models.factory import build_model

    cfg = _context().cfg
    model = build_model(cfg["model"], device="cpu").eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.randn(1, 63, 63, 3), torch.randn(1, 25))
    # two halves a block, a multiply-add 2 operations
    tables = 2 * 2 * sum(cfg["depths"][s] * 225 * (2 * 512 + 512 * cfg["dims"][s] // 32)
                         for s in range(4))
    assert counts_maxxvit.forward_flops_per_alert(cfg) + tables == pytest.approx(
        counter.get_total_flops(), rel=1e-3)
    assert counts_maxxvit.forward_flops_per_alert(cfg) == pytest.approx(29.17e9, rel=1e-3)


def test_the_shapes_and_bounds_by_hand():
    cfg = _context().cfg
    assert counts_maxvit.stage_sides(cfg) == [64, 32, 16, 8]
    assert counts_maxxvit.block_shapes(cfg) == [(64, 96), (32, 192)] + [(16, 384)] * 4 + [
        (8, 768)]
    assert counts_maxxvit.strided_dw_shapes(cfg) == [(128, 96, 96), (64, 96, 192),
                                                     (32, 192, 384), (16, 384, 768)]
    assert counts_ln_qkv.ln_qkv_shapes(cfg) == [(64, 96)] * 4 + [(32, 192)] * 4 + [
        (16, 384)] * 10 + [(8, 768)] * 4
    # the first strided conv at batch 3072: 128² × 96 in, 64² × 96 out, bf16
    assert counts_maxxvit.strided_dw_bytes(3072, 128, 96, 96, 2) == \
        3072 * (128 * 128 * 96 + 64 * 64 * 96) * 2 + 50 * 96 * 2
    b, o = counts.block_work(3072, 64, 96, 384, 2)
    assert counts_maxxvit.blocks_bound_s(cfg, 3072, "bfloat16") > counts.bound_s(b, o, "bfloat16")


def _reader(name):
    return harness.load_module("layer_metrics", name).read


SCORE_TRACE = harness.Trace(window_s=2.0, kernels=[
    ("convnext_block_bf16_kernel<96, true, true>", 0.1, 0.004),
    ("convnext_block_bf16_kernel<384, true, false>", 0.2, 0.006),
    ("ln_mlp_bf16_kernel", 0.3, 0.5)], memcpys=[], host=[])


def test_the_readers_read_the_trace_and_the_programs_counter(monkeypatch):
    from btsbot_tpu_torch.utils import profiling

    cfg = _context().cfg
    dw = harness.load_module("layer_metrics", "strided_dw_roofline.score").KERNELS
    trace = harness.Trace(window_s=2.0, kernels=SCORE_TRACE.kernels + [
        (dw[0], 0.4, 0.002), (dw[-1], 0.5, 0.003)], memcpys=[], host=[])
    monkeypatch.setattr(profiling, "counters", lambda: {"maxxvit.relpos_tables": 44})
    run = harness.LayerRun(trace=trace, counters={"forward_rows": [192, 3072],
                                                  "alerts_traced": 2000}, cfg=cfg)
    blocks = sum(counts_maxxvit.blocks_bound_s(cfg, r, "bfloat16") for r in (192, 3072))
    assert _reader("maxxvit_block_roofline.score")(run) == pytest.approx(100 * blocks / 0.010)
    strided = sum(counts_maxxvit.strided_dw_bound_s(cfg, r, "bfloat16") for r in (192, 3072))
    assert _reader("strided_dw_roofline.score")(run) == pytest.approx(100 * strided / 0.005)
    assert _reader("relpos_tables_per_forward.score")(run) == 22
    assert _reader("maxxvit_mfu.score")(run) == pytest.approx(
        100 * counts_maxxvit.forward_flops_per_alert(cfg) * 2000 / 2.0 / 989e12)
    # the parent's program: no such kernel, no counter
    bare = harness.Trace(window_s=2.0, kernels=[("ln_mlp_bf16_kernel", 0.3, 0.5)], memcpys=[],
                         host=[])
    monkeypatch.setattr(profiling, "counters", lambda: {})
    run = harness.LayerRun(trace=bare, counters={"forward_rows": [192]}, cfg=cfg)
    for name in ("maxxvit_block_roofline.score", "strided_dw_roofline.score",
                 "relpos_tables_per_forward.score"):
        assert _reader(name)(run) is None
    assert _reader("maxxvit_mfu.score")(harness.LayerRun(None, {}, cfg)) is None


def test_a_traced_run_on_the_host_reads_the_tables_and_the_forward_share(tiny_cell):
    from btsbot_tpu_torch.utils import profiling

    profiling.reset_counters()
    result = run_cell(WORKLOAD, SEED, 1.0, True, device="cpu", cell_factory=tiny_cell)
    assert result["metrics"]["maxxvit_mfu.score"]["value"] > 0
    assert result["metrics"]["relpos_tables_per_forward.score"]["value"] == 8
    # the host runs no kernel: the kernels' readers find nothing
    for name in ("maxxvit_block_roofline.score", "strided_dw_roofline.score",
                 "partition_attention_roofline.score", "ln_qkv_roofline.score"):
        assert name not in result["metrics"]
