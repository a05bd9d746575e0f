"""The port's 12-panel diagnostic figure against the JAX package's (CPU).

The port draws from a dict of numpy columns where the JAX package reads a
DataFrame; on the same inputs both give the same summary (exactly, NaN
included) and the same panels (titles, axis labels and the number of
curves in each).  ``run_training(make_figure=True)`` writes
``val_diagnostics.pdf`` into the run directory, ``cli.val --figure`` draws
it again from ``report.json``'s curves, and without matplotlib every entry
point raises ImportError naming ``--no-figure`` before it trains.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from btsbot_tpu.metrics.diagnostics import diagnostic_summary as jax_diagnostic_summary
from btsbot_tpu_torch.cli.train import main as train_main
from btsbot_tpu_torch.cli.val import _report_run_data
from btsbot_tpu_torch.cli.val import main as val_main
from btsbot_tpu_torch.engine.train import run_training
from btsbot_tpu_torch.metrics.diagnostics import diagnostic_summary
from test_torch_logging_sweep import _candidates
from test_torch_train import _quiet, train_config, write_split

RUN_DATA = {"run_name": "figure", "loss": [0.9, 0.7, 0.6], "accuracy": [0.5, 0.7, 0.8],
            "val_loss": [0.8, 0.75, 0.7], "val_accuracy": [0.6, 0.65, 0.7]}


def _panels(fig):
    axes = [a for a in fig.axes if a.get_label() != "<colorbar>"]
    return [(a.get_title(), a.get_xlabel(), a.get_ylabel(), len(a.lines)) for a in axes]


def test_figure_from_dict_columns_matches_jax(tmp_path):
    import matplotlib.pyplot as plt
    import pandas as pd
    cand, preds, labels = _candidates(n=200, seed=11)
    ours = diagnostic_summary(cand, preds, labels, run_data=RUN_DATA, make_figure=True,
                              fig_path=str(tmp_path / "port" / "val_diagnostics.pdf"))
    theirs = jax_diagnostic_summary(pd.DataFrame(cand), preds, labels, run_data=RUN_DATA,
                                    make_figure=True,
                                    fig_path=str(tmp_path / "jax" / "val_diagnostics.pdf"))
    fig, jax_fig = ours.pop("fig"), theirs.pop("fig")
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    assert len(_panels(fig)) == 12
    assert _panels(fig) == _panels(jax_fig)
    assert fig._suptitle.get_text() == "figure"
    with open(tmp_path / "port" / "val_diagnostics.pdf", "rb") as f:
        assert f.read(5) == b"%PDF-"
    plt.close(fig)
    plt.close(jax_fig)


UM_NN = {"model_name": "um_nn"}  # the figure is the same for every family; um_nn trains fast


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-epoch um_nn run with the figure on, and its data directory."""
    root = tmp_path_factory.mktemp("figure")
    data = str(root / "data")
    os.makedirs(data)
    write_split(data, "train", 32, seed=1)
    write_split(data, "val", 16, seed=2)
    result = run_training(train_config(**UM_NN), data_dir=data, out_root=str(root / "models"),
                          make_figure=True, log=_quiet, device="cpu")
    return result, data


def test_run_training_writes_the_figure(trained):
    result, _ = trained
    with open(os.path.join(result["model_dir"], "val_diagnostics.pdf"), "rb") as f:
        assert f.read(5) == b"%PDF-"
    assert "fig" not in result["summaries"]["val"]


def test_cli_val_figure_draws_from_report_curves(trained):
    result, data = trained
    model_dir = result["model_dir"]
    pdf = os.path.join(model_dir, "val_diagnostics.pdf")
    os.remove(pdf)
    summary = val_main([model_dir, "--data-dir", data, "--figure", "--device", "cpu"])
    with open(pdf, "rb") as f:
        assert f.read(5) == b"%PDF-"
    assert "fig" not in summary and summary["confusion"] == result["summaries"]["val"]["confusion"]
    curves = _report_run_data(model_dir)
    hist = result["history"]
    assert curves["run_name"] == "run"
    np.testing.assert_allclose(curves["loss"], hist["train_loss"], rtol=1e-15)
    np.testing.assert_allclose(curves["val_accuracy"], hist["val_accuracy"], rtol=1e-15)


def test_without_matplotlib_every_entry_point_raises_before_training(trained, tmp_path,
                                                                     monkeypatch):
    _, data = trained
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    out = tmp_path / "models"
    with pytest.raises(ImportError, match="--no-figure"):
        run_training(train_config(**UM_NN), data_dir=data, out_root=str(out),
                     make_figure=True, log=_quiet, device="cpu")
    config = tmp_path / "config.json"
    config.write_text(json.dumps(dict(train_config(epochs=1, **UM_NN))))
    with pytest.raises(ImportError, match="--no-figure"):
        train_main([str(config), "--data-dir", data, "--out-root", str(out), "--device", "cpu"])
    assert not out.exists()
    # --no-figure trains without it
    result = train_main([str(config), "--data-dir", data, "--out-root", str(out),
                         "--no-figure", "--device", "cpu"])
    assert "val_diagnostics.pdf" not in os.listdir(result["model_dir"])
