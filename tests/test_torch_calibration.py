"""The port's calibration (``metrics/calibration.py``) and validation CLI
(``python -m btsbot_tpu_torch.cli.val``) against the JAX package's (CPU).

The calibration functions agree with JAX's within 1e-6 on the same numbers
(both are float64 numpy).  ``cli.val --calibrate`` runs on a run directory
that both packages read (report.json, the JAX package's ``best/``
checkpoint and ``best_model.pth`` holding the same random ``convnext_atto``
weights) over the same val split: ``perf.json`` has the JAX CLI's keys, the
loss agrees within rtol 1e-4 (float32 summation order over 48 alerts), the
calibration block within 1e-3 of JAX's (a temperature fitted by golden
section on logits that differ by ~1e-6).  ``--run-id`` takes a fake
tracking API.
"""

import csv
import json
import os
import re
import shutil

import numpy as np
import pytest

from btsbot_tpu.cli.val import main as jax_val_main
from btsbot_tpu.engine.checkpoint import save_model_variables
from btsbot_tpu.interop.export import save_torch_checkpoint
from btsbot_tpu.metrics import calibration as jax_cal
from btsbot_tpu_torch.cli.val import main as val_main
from btsbot_tpu_torch.metrics import calibration as cal
from test_torch_model import META_COLS, atto_config, flax_variables

N_VAL = 48


def _overconfident(n, true_t=3.0, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(scale=2.0, size=n)
    labels = (rng.random(n) < 1 / (1 + np.exp(-z / true_t))).astype(np.float32)
    return (1 / (1 + np.exp(-z))).astype(np.float32), labels


def test_calibration_functions_match_jax():
    scores, labels = _overconfident(4000, seed=1)
    scores[:3] = [0.0, 1.0, 0.5]  # the clip at both ends
    np.testing.assert_allclose(cal.scores_to_logits(scores),
                               jax_cal.scores_to_logits(scores), rtol=1e-6, atol=1e-6)
    logits = cal.scores_to_logits(scores)
    for t in (0.5, 1.0, 3.0):
        assert abs(cal.nll(logits, labels, t) - jax_cal.nll(logits, labels, t)) <= 1e-6
        np.testing.assert_allclose(cal.calibrate_scores(scores, t),
                                   jax_cal.calibrate_scores(scores, t), atol=1e-6)
    t = cal.fit_temperature(logits, labels)
    assert abs(t - jax_cal.fit_temperature(logits, labels)) <= 1e-6 and 2.0 < t < 4.0
    for bins in (10, 15):
        assert abs(cal.expected_calibration_error(scores, labels, bins)
                   - jax_cal.expected_calibration_error(scores, labels, bins)) <= 1e-6
    got, want = cal.calibration_report(scores, labels), jax_cal.calibration_report(
        scores, labels)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["nll_after"] <= got["nll_before"]


def _write_val_split(data_dir, seed=0):
    rng = np.random.default_rng(seed)
    labels = (rng.random(N_VAL) < 0.4).astype(np.int64)
    trips = rng.normal(size=(N_VAL, 63, 63, 3)).astype(np.float32)
    trips[labels == 1, 28:35, 28:35, :] += 2.0
    trips /= np.sqrt((trips ** 2).sum(axis=(1, 2), keepdims=True))
    np.save(os.path.join(data_dir, "val_triplets_v12_N100.npy"), trips)
    meta = rng.normal(size=(N_VAL, len(META_COLS))) + 0.5 * labels[:, None]
    magpsf = 17 + 2.5 * rng.random(N_VAL)
    with open(os.path.join(data_dir, "val_cand_v12_N100.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["objectId", "candid", "jd", "label", "magpsf"] + META_COLS)
        for i in range(N_VAL):
            w.writerow([f"ZTFv{i // 3:05d}", 10 ** 12 + i, 2459300.5 + i / 7,
                        labels[i], f"{magpsf[i]:.7g}"] + [f"{v:.7g}" for v in meta[i]])


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """(run directory read by both CLIs, data directory)."""
    root = tmp_path_factory.mktemp("val")
    config = atto_config()
    variables = flax_variables(config)
    model_dir = root / "mm_ConvNeXt_v12_N100_torch" / "m"
    os.makedirs(model_dir)
    save_model_variables(str(model_dir / "best"), variables["params"],
                         variables["batch_stats"])
    save_torch_checkpoint(str(model_dir / "best_model.pth"), config, variables)
    with open(model_dir / "report.json", "w") as f:
        json.dump({"train_config": {**config, "batch_size": 16}}, f)
    data_dir = root / "data"
    os.makedirs(data_dir)
    _write_val_split(str(data_dir))
    return str(model_dir), str(data_dir)


def _loss(out: str) -> float:
    return float(re.search(r"val loss ([0-9.eE+-]+)", out).group(1))


def _close(got, want, path=""):
    """Same keys everywhere; numbers within 1e-3 (relative above 1)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert abs(got - want) <= 1e-3 * max(1.0, abs(want)), (path, got, want)
    else:
        assert got == want, path


def test_val_calibrate_matches_the_jax_cli(run_dir, capsys):
    model_dir, data_dir = run_dir
    perf = os.path.join(model_dir, "perf.json")
    summary = val_main([model_dir, "--data-dir", data_dir, "--calibrate",
                        "--device", "cpu"])
    port_out = capsys.readouterr().out
    with open(perf) as f:
        got = json.load(f)
    jax_val_main([model_dir, "--data-dir", data_dir, "--calibrate"])
    jax_out = capsys.readouterr().out
    with open(perf) as f:
        want = json.load(f)
    assert json.loads(json.dumps(summary, default=float)) == got
    assert set(got["calibration"]) == {"temperature", "nll_before", "nll_after",
                                       "ece_before", "ece_after"}
    np.testing.assert_allclose(_loss(port_out), _loss(jax_out), rtol=1e-4)
    _close(got, want)


def test_val_run_id_uses_the_injected_api(run_dir, tmp_path, capsys):
    model_dir, data_dir = run_dir
    out_root = tmp_path / "models"
    logged = out_root / "mm_ConvNeXt_v12_N100_torch" / "logged"
    os.makedirs(logged)
    shutil.copy(os.path.join(model_dir, "best_model.pth"), logged)

    class _Run:
        config = {**atto_config(), "batch_size": 16}
        name = "logged"

        @staticmethod
        def history():
            return {"train_loss": [0.7, 0.6], "val_loss": [0.8, 0.7]}

    class _Api:
        asked = []

        def run(self, path):
            self.asked.append(path)
            return _Run()

    api = _Api()
    summary = val_main(["--run-id", "abc123", "--out-root", str(out_root),
                        "--data-dir", data_dir, "--device", "cpu"], api=api)
    assert api.asked == ["BTSbot/runs/abc123"]
    assert "re-validating logged run abc123 (logged)" in capsys.readouterr().out
    with open(logged / "perf.json") as f:
        assert json.load(f) == json.loads(json.dumps(summary, default=float))
    assert "calibration" not in summary and "roc_auc" in summary


def test_val_figure_is_not_ported(run_dir, monkeypatch):
    """The figure is ported now: ``--figure`` draws ``val_diagnostics.pdf``
    beside perf.json, and without matplotlib it raises ImportError naming
    ``--no-figure`` before it evaluates anything."""
    import importlib.util
    model_dir, data_dir = run_dir
    pdf = os.path.join(model_dir, "val_diagnostics.pdf")
    summary = val_main([model_dir, "--data-dir", data_dir, "--figure", "--device", "cpu"])
    assert "fig" not in summary and "roc_auc" in summary
    with open(pdf, "rb") as f:
        assert f.read(5) == b"%PDF-"
    os.remove(pdf)
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    with pytest.raises(ImportError, match="--no-figure"):
        val_main([model_dir, "--data-dir", data_dir, "--figure", "--device", "cpu"])
    assert not os.path.exists(pdf)
