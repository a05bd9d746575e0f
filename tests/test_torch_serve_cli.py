"""The port's serving CLI (``python -m btsbot_tpu_torch.cli.serve``) against
the JAX package's on the same model directory (CPU).

The model directory is an HF-style snapshot both packages read:
``train_config.json`` + ``pytorch_model.bin`` written by the JAX package's
exporter from random ``convnext_atto`` variables.  Both CLIs serve in
bfloat16 (their default), so scores agree within 0.01 (bf16 rounding in two
frameworks); the wire format, the candids in order and the drop flags are
identical.  ``--temperature auto`` reads ``perf.json`` when it is there and
falls back to 1.0 with a notice when it is not.
"""

import base64
import json
import os

import numpy as np
import pytest

from btsbot_tpu.cli.serve import main as jax_serve_main
from btsbot_tpu.interop.export import save_torch_checkpoint
from btsbot_tpu_torch.cli.serve import main as serve_main
from btsbot_tpu_torch.data.synthetic import synthetic_avro_ocf
from btsbot_tpu_torch.metrics.calibration import calibrate_scores
from test_torch_model import atto_config, flax_variables
from test_torch_stream_daemon import _packets


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("snapshot")
    config = atto_config()
    save_torch_checkpoint(str(path / "pytorch_model.bin"), config, flax_variables(config))
    with open(path / "train_config.json", "w") as f:
        json.dump(dict(config), f)
    return str(path)


def _rows(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


def _serve_both(model_dir, tmp_path, source_args, port_extra=()):
    """(port rows, JAX rows) for the same source."""
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    serve_main([model_dir, *source_args, "--batch", "8", "--out", str(ours),
                "--device", "cpu", *port_extra])
    jax_serve_main([model_dir, *source_args, "--batch", "8", "--out", str(theirs)])
    return _rows(ours), _rows(theirs)


def _agree(got, want):
    assert [r["candid"] for r in got] == [r["candid"] for r in want]
    assert [r["dropped"] for r in got] == [r["dropped"] for r in want]
    for g, w in zip(got, want):
        assert (g["score"] is None) == (w["score"] is None) == g["dropped"]
        if g["score"] is not None:
            assert abs(g["score"] - w["score"]) <= 0.01


def test_synthetic_matches_jax(model_dir, tmp_path):
    got, want = _serve_both(model_dir, tmp_path, ["--synthetic", "12"])
    assert len(got) == 12 and not any(r["dropped"] for r in got)
    _agree(got, want)


def test_jsonl_wire_format_matches_jax(model_dir, tmp_path):
    packets = _packets(11, seed=21)
    src = tmp_path / "packets.jsonl"
    with open(src, "w") as f:
        for p in packets:
            wire = {"candid": p["candid"], "candidate": p["candidate"]}
            for key in ("cutoutScience", "cutoutTemplate", "cutoutDifference"):
                if p[key] is not None:
                    wire[key] = {"stampData": base64.b64encode(
                        p[key]["stampData"]).decode()}
            f.write(json.dumps(wire) + "\n")
    got, want = _serve_both(model_dir, tmp_path, ["--jsonl", str(src)])
    assert [r["dropped"] for r in got] == [i in (2, 7) for i in range(11)]
    _agree(got, want)


def test_avro_replay_matches_jax_with_and_without_bf16_transfer(model_dir, tmp_path):
    from btsbot_tpu_torch.data.avro import read_ocf, write_ocf

    meta_cols = atto_config()["metadata_cols"]
    schema, records = read_ocf(synthetic_avro_ocf(10, meta_cols, seed=5))
    records[3]["cutoutScience"]["stampData"] = b"not a gzip stream"  # a corrupt stamp
    path = tmp_path / "night.avro"
    path.write_bytes(write_ocf(schema, records, codec="deflate", block_records=3))
    got, want = _serve_both(model_dir, tmp_path, ["--avro", str(path)])
    assert [r["dropped"] for r in got] == [i == 3 for i in range(10)]
    _agree(got, want)
    wire, _ = _serve_both(model_dir, tmp_path, ["--avro", str(path)],
                          port_extra=["--bf16-transfer"])
    _agree(wire, got)


def test_auto_temperature_with_and_without_perf_json(model_dir, tmp_path, capsys):
    base = tmp_path / "t1.jsonl"
    serve_main([model_dir, "--synthetic", "8", "--batch", "8", "--out", str(base),
                "--device", "cpu", "--temperature", "auto"])
    assert "serving uncalibrated" in capsys.readouterr().err
    with open(os.path.join(model_dir, "perf.json"), "w") as f:
        json.dump({"calibration": {"temperature": 0.7}}, f)
    try:
        auto, fixed = tmp_path / "auto.jsonl", tmp_path / "fixed.jsonl"
        serve_main([model_dir, "--synthetic", "8", "--batch", "8", "--out", str(auto),
                    "--device", "cpu", "--temperature", "auto"])
        assert "calibration temperature 0.7" in capsys.readouterr().err
        serve_main([model_dir, "--synthetic", "8", "--batch", "8", "--out", str(fixed),
                    "--device", "cpu", "--temperature", "0.7"])
    finally:
        os.remove(os.path.join(model_dir, "perf.json"))
    s1 = np.array([r["score"] for r in _rows(base)])
    sa = np.array([r["score"] for r in _rows(auto)])
    assert sa.tolist() == [r["score"] for r in _rows(fixed)]
    np.testing.assert_allclose(sa, calibrate_scores(s1, 0.7), rtol=0, atol=1e-3)


def test_stats_line_and_compile_cache_flag(model_dir, tmp_path, capsys):
    """The final stats line on stderr has the JAX daemon's keys; --compile-cache
    points the kernel build directory (nothing is built on the CPU)."""
    from btsbot_tpu_torch.ops import _build
    from btsbot_tpu_torch.utils import compile_cache

    cache = tmp_path / "kernels"
    try:
        stats = serve_main([model_dir, "--synthetic", "5", "--batch", "8",
                            "--out", str(tmp_path / "s.jsonl"), "--device", "cpu",
                            "--compile-cache", str(cache)])
        assert _build.BUILD_DIR == cache.resolve()
    finally:
        compile_cache.disable()
    assert not cache.exists()
    last = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(stats))
    assert {"alerts_in", "alerts_scored", "dropped", "batches", "wall_s",
            "alerts_per_s", "latency_p50_ms", "latency_p99_ms",
            "score_hist"} == set(last)
    assert last["alerts_scored"] == 5
