"""The port's experiment logger and sweep runner against the JAX package's
(CPU).

* the JSONL logger writes the JAX logger's lines byte for byte;
* ``summary_from_diagnostics`` gives the JAX keys and values on one
  diagnostic summary (the JAX package's own, from its candidates table);
* ``sample_trials`` draws the JAX trials for grid and random sweeps at the
  same seed (numpy's generator in both);
* ``run_sweep`` trains two trials on the host and logs each epoch and the
  summary; the wandb adapter drives a stub agent and run (both on um_nn: the
  sweep machinery is the same for every family, and it trains fast).
"""

import json

import numpy as np
import pytest

from btsbot_tpu.cli.sweep import sample_trials as jax_sample_trials
from btsbot_tpu.metrics.diagnostics import diagnostic_summary as jax_diagnostic_summary
from btsbot_tpu.utils.logging import JsonlLogger as JaxJsonlLogger
from btsbot_tpu.utils.logging import summary_from_diagnostics as jax_summary_from_diagnostics
from btsbot_tpu_torch.cli.sweep import main as sweep_main
from btsbot_tpu_torch.cli.sweep import run_sweep, run_wandb_agent, sample_trials
from btsbot_tpu_torch.metrics.diagnostics import diagnostic_summary
from btsbot_tpu_torch.utils.logging import (
    JsonlLogger,
    NullLogger,
    make_logger,
    summary_from_diagnostics,
)
from test_torch_train import _datasets, _quiet, train_config

SWEEPS = {
    "grid": {"method": "grid",
             "parameters": {"a": {"values": [1, 2, 3]}, "b": {"values": [10, 20]}}},
    "random": {"method": "random", "count": 7, "seed": 3,
               "parameters": {"lr": {"min": 1e-4, "max": 1e-3},
                              "c": {"values": [4, 8, 16]}}},
    "random_default_seed": {"method": "random",
                            "parameters": {"p": {"min": 0.0, "max": 1.0}}},
}


def test_jsonl_logger_writes_the_jax_lines(tmp_path):
    lines = []
    for cls, name in ((JsonlLogger, "port"), (JaxJsonlLogger, "jax")):
        path = str(tmp_path / name / "log.jsonl")
        logger = cls(path)
        logger.log({"train_loss": 0.5, "val_loss": np.float32(0.25)}, step=3)
        logger.log({"epoch": 1, "learning_rate": 1e-4}, step=4)
        logger.set_summary({"ROC_AUC": 0.99, "prod_p1_peakmag_bins": [17.0, 17.5]})
        logger.finish()
        lines.append(open(path).read())
    assert lines[0] == lines[1]
    parsed = [json.loads(line) for line in lines[0].splitlines()]
    assert parsed[0] == {"step": 3, "train_loss": 0.5, "val_loss": 0.25}
    assert parsed[2]["summary"]["ROC_AUC"] == 0.99


def test_make_logger_kinds(tmp_path):
    assert isinstance(make_logger("null"), NullLogger)
    assert isinstance(make_logger("jsonl", path=str(tmp_path / "x.jsonl")), JsonlLogger)
    assert isinstance(make_logger("wandb"), NullLogger)  # wandb is not installed
    with pytest.raises(ValueError, match="Unknown logger kind"):
        make_logger("tensorboard")


def _candidates(n=150, seed=7):
    rng = np.random.default_rng(seed)
    cand = {"objectId": np.asarray([f"ZTF{i // 5:03d}" for i in range(n)]),
            "jd": 2459300.5 + rng.random(n) * 30, "magpsf": 16.5 + rng.random(n) * 3,
            "peakmag": 16.5 + rng.random(n) * 2.5}
    labels = (np.repeat(rng.random(n // 5), 5) < 0.4).astype(int)
    preds = np.clip(labels * 0.6 + rng.random(n) * 0.5, 0, 1)
    return cand, preds, labels


@pytest.mark.parametrize("prefix", ["", "test_"])
def test_summary_from_diagnostics_matches_jax(prefix):
    import pandas as pd
    cand, preds, labels = _candidates()
    theirs = jax_diagnostic_summary(pd.DataFrame(cand), preds, labels)
    ours = diagnostic_summary(cand, preds, labels)
    got = summary_from_diagnostics(ours, prefix=prefix)
    want = jax_summary_from_diagnostics(theirs, prefix=prefix)
    assert list(got) == list(want)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert f"{prefix}alert_F1" in got and f"{prefix}ROC_AUC" in got


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sample_trials_match_jax(name):
    got, want = sample_trials(SWEEPS[name]), jax_sample_trials(SWEEPS[name])
    assert got == want
    assert json.dumps(got) == json.dumps(want)  # same types too


def test_sample_trials_reject_what_jax_rejects():
    for bad in ({"method": "grid", "parameters": {"a": {"min": 0, "max": 1}}},
                {"method": "bayes"}):
        with pytest.raises(ValueError) as ours:
            sample_trials(bad)
        with pytest.raises(ValueError) as theirs:
            jax_sample_trials(bad)
        assert str(ours.value) == str(theirs.value)


def test_run_sweep_trains_two_trials_and_logs_each(tmp_path):
    base = tmp_path / "base.json"
    base.write_text(json.dumps(dict(train_config(model_name="um_nn", epochs=2))))
    train_ds, val_ds = _datasets(n_train=32, n_val=16, seed=9)
    sweep = {"base_config": str(base), "method": "grid",
             "parameters": {"learning_rate": {"values": [1e-3, 3e-3]}}}
    out = tmp_path / "models"
    results = run_sweep(sweep, out_root=str(out), train_ds=train_ds, val_ds=val_ds,
                        log=_quiet, device="cpu")
    assert sorted(r["trial"] for r in results) == [0, 1]
    assert [r["best_val_loss"] for r in results] == sorted(r["best_val_loss"] for r in results)
    for r in results:
        assert np.isfinite(r["best_val_loss"])
        lines = [json.loads(x) for x in open(out / f"sweep{r['trial']:03d}_log.jsonl")]
        assert [x["step"] for x in lines[:-1]] == [0, 1]
        assert lines[0]["learning_rate"] == pytest.approx(
            r["overrides"]["learning_rate"] / 100)  # warm-up's first epoch
        assert "summary" in lines[-1]  # no objectId column: no summary keys


class _StubRun:
    def __init__(self, name, config):
        self.name, self.config = name, config
        self.summary, self.logged, self.closed = {}, [], False

    def log(self, metrics, step=None):
        self.logged.append((step, dict(metrics)))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.closed = True
        return False


class _StubWandb:
    """The surface run_wandb_agent touches: agent() pulls each trial's
    config from the 'sweep server' and calls the trial function."""

    def __init__(self, configs):
        self.configs, self.runs, self.agent_calls = list(configs), [], []

    def init(self, **_kw):
        run = _StubRun(f"stub-run-{len(self.runs)}", self.configs[len(self.runs)])
        self.runs.append(run)
        return run

    def agent(self, sweep_id, function, count, project):
        self.agent_calls.append((sweep_id, count, project))
        for _ in range(count):
            function()


def test_wandb_agent_adapter_logs_through_the_live_run(tmp_path):
    from test_torch_train import write_split
    data = tmp_path / "data"
    data.mkdir()
    write_split(str(data), "train", 32, seed=1)
    write_split(str(data), "val", 16, seed=2)
    base = dict(train_config(model_name="um_nn", epochs=2))
    api = _StubWandb([{**base, "learning_rate": 1e-3}, {**base, "learning_rate": 3e-3}])
    results = run_wandb_agent("sweep42", project="BTSbotv2", count=2, data_dir=str(data),
                              out_root=str(tmp_path / "m"), wandb_api=api, log=_quiet,
                              device="cpu")
    assert api.agent_calls == [("sweep42", 2, "BTSbotv2")]
    assert [r["run_name"] for r in results] == ["stub-run-0", "stub-run-1"]
    for run in api.runs:
        assert run.closed
        assert [step for step, _ in run.logged] == [0, 1]
        assert {"ROC_AUC", "bal_acc", "alert_F1"} <= set(run.summary)


def test_sweep_cli_rejects_a_json_with_a_wandb_id(tmp_path):
    cfg = tmp_path / "sweep.json"
    cfg.write_text("{}")
    with pytest.raises(SystemExit) as e:
        sweep_main([str(cfg), "--wandb-sweep-id", "abc123", "--device", "cpu"])
    assert e.value.code == 2
