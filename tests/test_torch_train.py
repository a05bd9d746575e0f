"""The port's trainer against the JAX package's, end to end (CPU).

Both ``run_training``s read the same split files (the reference's layout),
start from the same weights (the flax init, carried across by
``variables_to_torch_state_dict``), see the same batches (the same
``default_rng(seed + epoch)`` shuffle) and run in float32 with
augmentation and dropout off, at ``convnext_atto`` width.  Tolerances:

* per-epoch train and val losses rtol 1e-4 (float32 through two autograds
  that sum in other orders; Adam's normalised steps carry those last-bit
  differences from update to update);
* BatchNorm running statistics 1e-6 relative (they depend on the metadata
  batches alone);
* the port's ``best_model.pth`` read by the JAX package: logits 1e-5;
* candidate columns read by the ``csv`` module against pandas: floats
  rtol = atol = 1e-15 (pandas' default float parser is not correctly
  rounded, Python's ``float`` is), everything else exact;
* a resumed run against an uninterrupted one: exact (CPU arithmetic
  repeats bit for bit, and the step's randomness follows (seed, step)).
"""

import csv
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from btsbot_tpu import normalize_config
from btsbot_tpu.data.dataset import load_split as jax_load_split
from btsbot_tpu.engine.checkpoint import load_model_checkpoint as jax_load_model_checkpoint
from btsbot_tpu.engine.checkpoint import load_model_variables
from btsbot_tpu.engine.train import run_training as jax_run_training
from btsbot_tpu.interop.export import variables_to_torch_state_dict
from btsbot_tpu.models.factory import init_model
from btsbot_tpu_torch.cli.train import main as cli_train
from btsbot_tpu_torch.data.dataset import AlertDataset, load_split
from btsbot_tpu_torch.engine.checkpoint import LATEST, load_model_checkpoint
from btsbot_tpu_torch.engine.eval import predict_dataset
from btsbot_tpu_torch.engine.state import create_train_state
from btsbot_tpu_torch.engine.steps import make_train_step
from btsbot_tpu_torch.engine.train import run_training
from btsbot_tpu_torch.models.factory import build_model
from test_torch_model import META_COLS, atto_config

N_TRAIN, N_VAL = 48, 24


def train_config(**over):
    return normalize_config({
        **atto_config(), "learning_rate": 1e-3, "beta_1": 0.9, "beta_2": 0.999,
        "batch_size": 16, "epochs": 2, "patience": 3, "warmup_epochs": 1,
        "random_seed": 0, "pretrained": False, "init_scheme": "flax",
        "meta_dropout": 0.0, "comb_dropout": 0.0, "data_aug_h_flip": 0,
        "data_aug_v_flip": 0, "data_aug_rot": 0, **over})


def _quiet(_msg):
    pass


def write_split(data_dir, split, n, seed, nan_rows=()):
    """One split in the reference's layout: a candidate CSV (objectId, jd,
    magpsf, label, the metadata columns) and the NHWC triplets; positives
    carry a blob and shifted metadata."""
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.3).astype(int)
    images = rng.normal(0, 0.1, size=(n, 63, 63, 3)).astype(np.float32)
    images[labels == 1, 28:35, 28:35] += 1.0
    images[list(nan_rows), 0, 0, 0] = np.nan
    meta = rng.normal(size=(n, len(META_COLS))) + labels[:, None]
    np.save(os.path.join(data_dir, f"{split}_triplets_v12_N100.npy"), images)
    with open(os.path.join(data_dir, f"{split}_cand_v12_N100.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["objectId", "jd", "magpsf", "label"] + META_COLS)
        for i in range(n):
            w.writerow([f"ZTF21a{i // 3:05d}", 2459300.5 + i, 17 + 2 * rng.random(),
                        labels[i]] + [repr(float(v)) for v in meta[i]])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("data"))
    write_split(data, "train", N_TRAIN + 1, seed=1, nan_rows=(5,))  # row 5 dropped
    write_split(data, "val", N_VAL, seed=2)
    config = train_config()
    # the JAX package's own (eager) init, which its run_training repeats:
    # the second call finds every operation compiled
    jax_model, variables = init_model(config, rng=0)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    after_epoch0 = {}

    def jax_epoch0(epoch, _):
        if epoch == 0:
            latest = os.path.join(out_j, "mm_ConvNeXt_v12_N100_tpu", "run", "latest")
            after_epoch0["jax"] = load_model_variables(latest)["batch_stats"]

    def port_epoch0(epoch, _):
        if epoch == 0:
            latest = os.path.join(out_p, "mm_ConvNeXt_v12_N100_torch", "run", LATEST)
            after_epoch0["port"] = torch.load(latest, weights_only=True)["model"]

    out_j = str(tmp_path_factory.mktemp("jax"))
    out_p = str(tmp_path_factory.mktemp("port"))
    jax_result = jax_run_training(config, data_dir=data, out_root=out_j, make_figure=False,
                                  initial_variables=variables, log=_quiet,
                                  epoch_callback=jax_epoch0)
    port_result = run_training(config, data_dir=data, out_root=out_p,
                               initial_state_dict=variables_to_torch_state_dict(config, variables),
                               log=_quiet, epoch_callback=port_epoch0, device="cpu")
    return dict(config=config, data=data, jax=jax_result, port=port_result,
                jax_model=jax_model, after_epoch0=after_epoch0)


def test_per_epoch_losses_and_best_epoch_match_jax(runs):
    hj, hp = runs["jax"]["history"], runs["port"]["history"]
    assert len(hp["train_loss"]) == 2
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hp[key], hj[key], rtol=1e-4)
    for key in ("train_accuracy", "val_accuracy"):
        np.testing.assert_array_equal(hp[key], hj[key])
    best = [int(np.argmin(h["val_loss"])) for h in (hj, hp)]
    assert best[0] == best[1]


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_report_json_has_the_jax_keys(runs):
    reports = []
    for r in (runs["jax"], runs["port"]):
        with open(os.path.join(r["model_dir"], "report.json")) as f:
            reports.append(json.load(f))
    rj, rp = reports
    assert _keys(rp) == _keys(rj)
    assert rp["train_config"] == rj["train_config"]
    assert rp["Training history"]["train_loss"] == pytest.approx(
        rj["Training history"]["train_loss"], rel=1e-4)
    assert rp["val_summary"]["confusion"] == rj["val_summary"]["confusion"]
    assert runs["port"]["model_dir"].endswith(os.path.join("mm_ConvNeXt_v12_N100_torch", "run"))
    assert sorted(os.listdir(runs["port"]["model_dir"])) == ["best_model.pth", "latest.pt",
                                                             "report.json"]


def test_batchnorm_statistics_after_three_and_six_steps_match_jax(runs):
    """Three steps (epoch 1, read from each package's resume state) and six
    (the end): the flax rule, biased batch variance, momentum 0.9."""
    ends = [(runs["after_epoch0"]["jax"], runs["after_epoch0"]["port"]),
            (runs["jax"]["state"].batch_stats, runs["port"]["model"].state_dict())]
    for stats, sd in ends:
        bn = stats["metadata_branch"]["bn"]
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            got = sd[f"metadata_branch.0.{ours}"].numpy()
            np.testing.assert_allclose(got, np.asarray(bn[theirs]), rtol=1e-6, atol=1e-7)
    assert int(ends[1][1]["metadata_branch.0.num_batches_tracked"]) == 6


def test_jax_reads_the_ports_best_model(runs):
    config = runs["config"]
    model_dir = runs["port"]["model_dir"]
    val = load_split(config, "val", runs["data"])
    variables = jax_load_model_checkpoint(config, model_dir)
    apply = jax.jit(functools.partial(runs["jax_model"].apply, train=False))
    want = np.asarray(apply(variables, image_input=jnp.asarray(val.images),
                            metadata_input=jnp.asarray(val.metadata))).reshape(-1)
    best = build_model(config, device="cpu")
    best.load_state_dict(load_model_checkpoint(config, model_dir))
    logits, scores = predict_dataset(best, config, val)
    np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(scores, runs["port"]["best_val_scores"])


def test_load_split_matches_jax(runs):
    config = runs["config"]
    for split in ("train", "val"):
        ours = load_split(config, split, runs["data"])
        theirs = jax_load_split(config, split, runs["data"])
        for name in ("labels", "images", "metadata"):
            np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
        assert list(ours.candidates) == list(theirs.candidates.columns)
        for col, values in ours.candidates.items():
            want = theirs.candidates[col].to_numpy()
            if values.dtype.kind == "f":  # pandas' default parser is an ulp off
                np.testing.assert_allclose(values, want, rtol=1e-15, atol=1e-15)
            else:
                np.testing.assert_array_equal(values, want)
    assert len(ours.labels) == N_VAL and len(load_split(config, "train", runs["data"])) == N_TRAIN


def _datasets(n_train=32, n_val=16, seed=3):
    rng = np.random.default_rng(seed)

    def make(n):
        labels = (rng.random(n) < 0.4).astype(np.float32)
        images = rng.normal(0, 0.1, size=(n, 63, 63, 3)).astype(np.float32)
        images[labels == 1, 20:40, 20:40] += 0.5
        return AlertDataset(labels, images,
                            rng.normal(size=(n, len(META_COLS))).astype(np.float32))
    return make(n_train), make(n_val)


class _Interrupt(Exception):
    pass


def test_resume_after_epoch_one_equals_an_uninterrupted_run(tmp_path):
    """With augmentation and dropout on: the resumed run draws the same
    masks, because the step's generator follows (seed, step)."""
    config = train_config(meta_dropout=0.25, comb_dropout=0.2, data_aug_h_flip=1,
                          data_aug_v_flip=1, data_aug_rot=1, random_seed=4)
    train_ds, val_ds = _datasets()
    kw = dict(train_ds=train_ds, val_ds=val_ds, log=_quiet, device="cpu")
    whole = run_training(config, out_root=str(tmp_path / "whole"), **kw)

    def interrupt(epoch, _):
        if epoch == 0:
            raise _Interrupt
    with pytest.raises(_Interrupt):
        run_training(config, out_root=str(tmp_path / "cut"), epoch_callback=interrupt, **kw)
    resumed = run_training(config, out_root=str(tmp_path / "cut"), resume=True, **kw)
    for key, value in whole["history"].items():
        if key != "run_name":
            np.testing.assert_array_equal(resumed["history"][key], value)
    assert resumed["state"].step == whole["state"].step == 4
    for name, t in whole["model"].state_dict().items():
        torch.testing.assert_close(resumed["model"].state_dict()[name], t, rtol=0, atol=0)


def test_device_resident_data_path_matches_host_batches(tmp_path):
    train_ds, val_ds = _datasets(seed=5)
    histories = []
    for device_data in (False, True):
        r = run_training(train_config(device_data=device_data), train_ds=train_ds,
                         val_ds=val_ds, out_root=str(tmp_path / str(device_data)),
                         log=_quiet, device="cpu")
        histories.append(r["history"])
    for key in ("train_loss", "val_loss", "train_accuracy"):
        np.testing.assert_array_equal(histories[1][key], histories[0][key])


def test_cli_trains_and_its_best_model_scores_as_the_trainer_did(runs, tmp_path):
    config_path = tmp_path / "config.json"
    config_path.write_text(json.dumps(dict(train_config(epochs=1))))
    result = cli_train([str(config_path), "--data-dir", runs["data"], "--out-root",
                        str(tmp_path / "models"), "--run-name", "cli", "--device", "cpu"])
    model_dir = str(tmp_path / "models" / "mm_ConvNeXt_v12_N100_torch" / "cli")
    assert result["model_dir"] == model_dir
    config = train_config(epochs=1)
    model = build_model(config, device="cpu")
    model.load_state_dict(load_model_checkpoint(config, model_dir), strict=True)
    _, scores = predict_dataset(model, config, load_split(config, "val", runs["data"]))
    np.testing.assert_allclose(scores, result["best_val_scores"], rtol=0, atol=1e-6)


def test_bfloat16_step_keeps_float32_parameters_and_loss():
    """One step in bfloat16 compute from the float32 step's weights and
    batch: the loss within 1e-2 of float32's, every gradient float32."""
    train_ds, _ = _datasets(n_train=16, seed=6)
    losses = {}
    for dtype in ("float32", "bfloat16"):
        config = train_config(compute_dtype=dtype)
        model = build_model(config, device="cpu", seed=0)
        state = create_train_state(config, model, steps_per_epoch=1)
        m = make_train_step(config)(
            state, torch.from_numpy(train_ds.images), torch.from_numpy(train_ds.metadata),
            torch.from_numpy(train_ds.labels), train_ds.pos_weight)
        losses[dtype] = m["loss"]
        assert m["logits"].dtype == getattr(torch, dtype)
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())
    assert losses["bfloat16"].dtype == torch.float32
    assert abs(losses["bfloat16"].item() - losses["float32"].item()) <= 1e-2
