"""CPU tests of the benchmark harness (run: ``python -m pytest benchmark -n 6``).

They hold the layout that later cells extend, the names' grammar, the
seeded schedules, the work arithmetic, the reference against the program
at the configuration's widths, and the guard against JAX.
"""

import ast
import json
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import counts, harness
from benchmark.conftest import SEED
from benchmark.drivers import archive, train
from benchmark.reference.mm_convnext import Reference, param_spec

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_every_piece_is_found_by_name():
    for w in BENCH["workloads"]:
        cfg = harness.load_json("configs", w["config"])
        traffic = harness.load_json("traffic", w["traffic"])
        assert hasattr(harness.load_module("drivers", traffic["driver"]), "Cell")
        assert cfg["reduced"] == [] and "assumed" in cfg and cfg["source"].startswith("https://")
        assert "about" in traffic
    for c in BENCH["configs"]:
        assert Path(harness.ROOT / c["file"]).is_file()
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    for m in BENCH["per_layer"]:
        assert callable(harness.load_module("layer_metrics", m["name"]).read)
    # a name with no file of its own takes the reader named before its first dot
    shared = harness.load_module("layer_metrics", "device_idle_pct.train")
    assert Path(shared.__file__).name == "device_idle_pct.py"


def test_names_units_and_keys_keep_the_grammar():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = []
    for kind, keys in ENTRY_KEYS.items():
        for e in BENCH[kind]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}, (kind, e)
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] == 1
    metrics = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metrics["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in metrics.values())
    for m in BENCH["per_layer"]:
        moved = metrics[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    perf = (harness.ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:  # a layer of PERF.md's list, letter for letter
        assert f"| {m['layer']} |" in perf, m["layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", ["archive", "train"])
def test_each_mix_repeats_for_a_seed_and_keeps_its_work(name):
    traffic = harness.load_json("traffic", name)

    def schedule(seed):
        if name == "archive":
            rng = np.random.default_rng(seed + 2)
            sizes = archive.call_sizes(traffic, seed)
            return sizes, [rng.integers(0, traffic["pool_alerts"] - n + 1) for n in sizes]
        return (train.labels_for(1024, traffic["positive_share"], seed),
                train.epoch_order(1024, seed))

    a, b, c = schedule(SEED), schedule(SEED), schedule(SEED + 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.sort(a[0]), np.sort(c[0]))
    assert not np.array_equal(a[0], c[0])


def test_counts_match_a_hand_count_of_a_pico_block():
    m = 3072 * 15 * 15
    bytes_moved, ops = counts.block_work(3072, 15, 64, 256, 2)
    assert bytes_moved == 2 * m * 64 * 2 + (49 * 64 + 64 + 128 + 256 * 64 + 256 + 64 * 256 + 64
                                            + 64) * 2
    assert ops == 2 * m * 64 * 256 * 2 + 2 * 49 * m * 64
    # 0.177 GB at 3.35 TB/s against 49.6 GFLOP at 989 TFLOP/s: bound by bytes
    assert counts.bound_s(bytes_moved, ops, "bfloat16") == pytest.approx(bytes_moved / 3.35e12)
    assert ops / 989e12 < bytes_moved / 3.35e12
    cfg = harness.load_json("configs", "mm_convnext_pico")
    assert counts.forward_flops_per_alert(cfg) == pytest.approx(134.3e6, rel=0.01)
    nano = harness.load_json("configs", "mm_convnext_nano")
    assert counts.forward_flops_per_alert(nano) == pytest.approx(237e6, rel=0.02)


@pytest.mark.parametrize("config", ["mm_convnext_pico", "mm_convnext_nano"])
def test_reference_matches_the_program_on_the_host(config):
    from btsbot_tpu_torch.models.factory import build_model

    cfg = harness.load_json("configs", config)
    model = build_model(cfg["model"], device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {n: s for n, s, _, _ in param_spec(cfg)}
    weights = harness.make_weights(cfg, SEED, torch.float32, "cpu")
    model.load_state_dict(weights, strict=True)
    images, meta = harness.make_pool(8, len(cfg["model"]["metadata_cols"]), SEED, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(meta)).reshape(-1)
        want = Reference(cfg).logits(weights, torch.from_numpy(images), torch.from_numpy(meta))
    assert want.std() > 0.1  # the logits spread, so a gap in any layer shows
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    import btsbot_tpu_torch  # noqa: F401
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax.numpy"]
    monkeypatch.setitem(sys.modules, "btsbot_tpu", types.ModuleType("btsbot_tpu"))
    assert harness.forbidden_modules() == ["btsbot_tpu", "jax.numpy"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    import benchmark.run as run

    def fake_run_cell(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True, "checks": {}}
    monkeypatch.setattr(run, "run_cell", fake_run_cell)
    assert run.main(["--workload", "pico-archive", "--seed", "1", "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_the_reference_and_the_harness_import_nothing_forbidden():
    for path in harness.BENCH_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in harness.FORBIDDEN_MODULES, (path, mod)
                if path.parent.name == "reference":
                    assert top != "btsbot_tpu_torch", (path, mod)


def test_without_a_card_a_run_exits_and_prints_nothing(tmp_path):
    """Also from a tree that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark")
    for root in (harness.ROOT, tmp_path):
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pico-archive",
                            "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                           cwd=root, capture_output=True, text=True, timeout=120,
                           env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
        assert p.returncode != 0 and p.stdout == "", p.stderr


def test_a_later_cell_mix_and_metric_are_new_files_only(tmp_path):
    """A throwaway configuration, mix, per-layer metric and cell added to a
    copy of the benchmark, no existing file edited, run on the host."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark")
    bench = json.loads(json.dumps(BENCH))
    cfg = harness.load_json("configs", "mm_convnext_pico")
    cfg["model"]["model_kind"] = "convnext_atto.d2_in1k"
    cfg.update(dims=[40, 80, 160, 320], depths=[2, 2, 6, 2], serve_batch=64)
    (tmp_path / "benchmark/configs/throwaway.json").write_text(json.dumps(cfg))
    mix = dict(harness.load_json("traffic", "archive"), pool_alerts=128, call_min=20,
               call_max=100, call_sizes=4)
    (tmp_path / "benchmark/traffic/throwaway_mix.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/layer_metrics/calls_traced.throwaway.py").write_text(
        "def read(run):\n    return len(run.counters['forward_rows']) or None\n")
    bench["workloads"].append({"name": "throwaway-cell", "config": "throwaway",
                               "traffic": "throwaway_mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_traced.throwaway", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "scorer host path", "moves": "score_alerts_per_s",
                               "workloads": ["throwaway-cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "score_alerts_per_s":
            m["workloads"].append("throwaway-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]];"
            "from benchmark.run import run_cell;"
            "print(json.dumps(run_cell('throwaway-cell', 5, 1.0, True, device='cpu')))")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(harness.ROOT)],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["calls_traced.throwaway"]["value"] >= 1
    for path in harness.BENCH_DIR.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(harness.BENCH_DIR)
            assert (tmp_path / "benchmark" / rel).read_bytes() == path.read_bytes(), rel
