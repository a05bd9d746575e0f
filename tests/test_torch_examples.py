"""The port's example data (btsbot_tpu_torch/example_data) and its examples
(examples/*_torch.py) on the CPU.

* ``synthesize_alerts`` draws the JAX package's alerts array for array, and
  the shipped ``usage_triplets.npy`` holds them;
* regenerating the example data reproduces the shipped files;
* the JAX package's shipped example model (``params.msgpack``, exported
  with ``variables_to_torch_state_dict``) scores the alerts in the port
  within 1e-5 of the JAX package's golden ``expected_scores``;
* each example runs in-process on ``--device cpu`` at a tiny size;
* none of them imports jax, flax or the JAX package.
"""

import csv
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from btsbot_tpu.example_data import make_example_data as jax_example
from btsbot_tpu.interop.export import variables_to_torch_state_dict
from btsbot_tpu_torch.example_data import make_example_data as example
from btsbot_tpu_torch.interop.hf import load_model_dir
from btsbot_tpu_torch.models.factory import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "btsbot_tpu_torch", "example_data")
JAX_DIR = os.path.join(REPO, "btsbot_tpu", "example_data")
EXAMPLES = {name: os.path.join(REPO, "examples", f"{name}_torch.py")
            for name in ("inference_example", "serving_daemon", "train_quickstart")}


def _example(name):
    spec = importlib.util.spec_from_file_location(f"{name}_torch", EXAMPLES[name])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_synthesize_alerts_matches_the_jax_package_and_the_shipped_file():
    trips, meta, labels = example.synthesize_alerts()
    jtrips, jmeta, jlabels = jax_example.synthesize_alerts()
    np.testing.assert_array_equal(trips, jtrips)
    np.testing.assert_array_equal(meta, jmeta)
    np.testing.assert_array_equal(labels, jlabels)
    assert example.META_COLS == jax_example.META_COLS
    assert example.EXAMPLE_CONFIG == jax_example.EXAMPLE_CONFIG
    shipped = np.load(os.path.join(PORT_DIR, "usage_triplets.npy"))
    assert shipped.dtype == np.float64
    np.testing.assert_array_equal(shipped, trips.astype(np.float64))
    np.testing.assert_array_equal(shipped, np.load(os.path.join(JAX_DIR, "usage_triplets.npy")))


def test_shipped_candidates_hold_the_jax_metadata():
    port, jax_rows = _rows(os.path.join(PORT_DIR, "usage_candidates.csv")), \
        _rows(os.path.join(JAX_DIR, "usage_candidates.csv"))
    assert list(port[0]) == list(jax_rows[0])
    for a, b in zip(port, jax_rows, strict=True):
        assert {k: v for k, v in a.items() if k != "expected_scores"} == \
            {k: v for k, v in b.items() if k != "expected_scores"}


def test_regenerating_reproduces_the_shipped_files(tmp_path):
    scores = example.write_example_data(str(tmp_path))
    for name in ("usage_triplets.npy", "train_config.json"):
        with open(tmp_path / name, "rb") as f, open(os.path.join(PORT_DIR, name), "rb") as g:
            assert f.read() == g.read(), name
    new, shipped = _rows(tmp_path / "usage_candidates.csv"), \
        _rows(os.path.join(PORT_DIR, "usage_candidates.csv"))
    for a, b in zip(new, shipped, strict=True):
        assert {k: v for k, v in a.items() if k != "expected_scores"} == \
            {k: v for k, v in b.items() if k != "expected_scores"}
        assert abs(float(a["expected_scores"]) - float(b["expected_scores"])) <= 1e-6
    sd_new = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
    sd_shipped = torch.load(os.path.join(PORT_DIR, "pytorch_model.bin"), weights_only=True)
    assert sd_new.keys() == sd_shipped.keys()
    assert all(torch.equal(sd_new[k], sd_shipped[k]) for k in sd_new)
    # the shipped golden scores are the shipped model's
    model, config = load_model_dir(PORT_DIR, device="cpu")
    meta, _, expected = example.read_candidates(os.path.join(PORT_DIR, "usage_candidates.csv"))
    trips = np.load(os.path.join(PORT_DIR, "usage_triplets.npy")).astype(np.float32)
    with torch.inference_mode():
        got = torch.sigmoid(model(torch.from_numpy(trips), torch.from_numpy(meta))).reshape(-1)
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-6)
    np.testing.assert_allclose(scores, expected, rtol=0, atol=1e-6)
    assert config["model_name"] == "mm_cnn"


def test_the_jax_example_model_scores_its_golden_scores_in_the_port():
    import flax.serialization

    with open(os.path.join(JAX_DIR, "params.msgpack"), "rb") as f:
        variables = flax.serialization.msgpack_restore(f.read())
    with open(os.path.join(JAX_DIR, "train_config.json")) as f:
        config = json.load(f)
    sd = variables_to_torch_state_dict(config, variables)
    model = build_model(config, device="cpu")
    model.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in sd.items()}, strict=True)
    meta, _, expected = example.read_candidates(os.path.join(JAX_DIR, "usage_candidates.csv"))
    trips = np.load(os.path.join(JAX_DIR, "usage_triplets.npy")).astype(np.float32)
    with torch.inference_mode():
        got = torch.sigmoid(model(torch.from_numpy(trips), torch.from_numpy(meta))).reshape(-1)
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-5)


def test_inference_example_local_on_the_cpu(capsys):
    out = _example("inference_example").main(["--local", "--device", "cpu"])
    assert out["scores"].shape == (16,)
    np.testing.assert_allclose(out["scores"], out["expected_scores"], rtol=0, atol=1e-6)
    assert "labels:" in capsys.readouterr().out


def test_serving_daemon_example_on_the_cpu(tmp_path):
    from btsbot_tpu_torch.ops import _build
    from btsbot_tpu_torch.utils import compile_cache

    try:
        stats = _example("serving_daemon").main(
            ["--synthetic", "150", "--batch", "64", "--max-wait-ms", "50", "--device", "cpu",
             "--out", str(tmp_path / "scores.jsonl"), "--compile-cache", str(tmp_path / "cache")])
        assert _build.BUILD_DIR == (tmp_path / "cache").resolve()
    finally:
        compile_cache.disable()
    assert stats["alerts_in"] == stats["alerts_scored"] == 150
    lines = (tmp_path / "scores.jsonl").read_text().splitlines()
    assert len(lines) == 150
    scores = [json.loads(line)["score"] for line in lines]
    assert all(s is not None and 0.0 < s < 1.0 for s in scores)


@pytest.mark.parametrize("model", ["mm_cnn", "mm_ConvNeXt"])
def test_train_quickstart_example_on_the_cpu(tmp_path, model):
    out = _example("train_quickstart").main(
        ["--model", model, "--epochs", "1", "--n", "64", "--out", str(tmp_path),
         "--device", "cpu"])
    assert out["scores"].shape == (256,) and np.all(np.isfinite(out["scores"]))
    assert 0.0 <= out["accuracy"] <= 1.0
    assert os.path.isfile(os.path.join(out["result"]["model_dir"], "best_model.pth"))


def test_the_example_modules_import_no_jax():
    code = (
        "import importlib.util, sys\n"
        "import btsbot_tpu_torch.example_data.make_example_data\n"
        f"for name, path in {EXAMPLES!r}.items():\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'btsbot_tpu', 'pandas')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=REPO)
    assert out.stdout.strip() == "[]", out.stdout
