"""The port's distillation against the JAX package's (CPU).

A ``convnext_atto`` mm_ConvNeXt teacher (seeded, perturbed flax weights in
a reference-style run directory: report.json + best_model.pth) and an
``inceptionnext_atto`` student starting from the same weights in both
packages, float32, augmentation and dropout off (the packages' random
streams differ by design), 2 epochs on the same in-memory splits:

* per-epoch train and val losses within rtol 1e-4 of JAX
  ``distill_to_student`` (float32 through two autograds and Adam, as in
  tests/test_torch_train.py), on the host-batch path and on the
  device-resident one (which equals the host path exactly);
* the teacher's parameters and BatchNorm statistics bit-identical after the
  run (eval mode, no gradients, not in the optimizer);
* ``student_config_from_teacher`` equal to JAX's dict;
* ``load_teacher`` from an HF-style snapshot, a run directory of the port
  and a reference-style run directory: logits within rtol 1e-4 / atol 1e-5
  of the JAX package's ``load_teacher`` model, in eval mode, no gradients;
* the KD term: a step with ``distill_alpha`` 1 is a plain step;
* ``cli.distill --device cpu`` end to end on split files.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from btsbot_tpu.engine import train as jax_train
from btsbot_tpu.engine.distill import distill_to_student as jax_distill_to_student
from btsbot_tpu.engine.distill import load_teacher as jax_load_teacher
from btsbot_tpu.engine.distill import student_config_from_teacher as jax_student_config
from btsbot_tpu.interop.export import save_torch_checkpoint
from btsbot_tpu.models.factory import build_model as jax_build_model
from btsbot_tpu_torch.cli.distill import main as distill_main
from btsbot_tpu_torch.core.config import normalize_config
from btsbot_tpu_torch.engine.distill import (
    distill_to_student,
    load_teacher,
    student_config_from_teacher,
)
from btsbot_tpu_torch.engine.state import create_train_state
from btsbot_tpu_torch.engine.steps import make_train_step
from btsbot_tpu_torch.interop.weights import state_dict_from_jax
from btsbot_tpu_torch.models.factory import build_model
from test_torch_families import flax_variables
from test_torch_train import _datasets, _quiet, train_config, write_split

STUDENT = "inceptionnext_atto"


def _teacher_dir(root, config, variables):
    """A reference-style run directory: report.json + best_model.pth."""
    os.makedirs(root)
    save_torch_checkpoint(os.path.join(root, "best_model.pth"), config, variables)
    with open(os.path.join(root, "report.json"), "w") as f:
        json.dump({"train_config": dict(config)}, f)
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("distill")
    t_cfg = train_config(model_kind="convnext_atto.test")
    teacher_dir = _teacher_dir(str(root / "teacher"), t_cfg, flax_variables(t_cfg, seed=1))
    s_cfg = student_config_from_teacher(t_cfg, STUDENT, distill_alpha=0.3,
                                        distill_temperature=2.5)
    s_vars = flax_variables(s_cfg, seed=2)
    train_ds, val_ds = _datasets(n_train=32, n_val=16, seed=7)
    with pytest.MonkeyPatch.context() as mp:
        # the JAX trainer initialises eagerly and then takes initial_variables
        # in its place; hand it those at once (the slow part of its run)
        mp.setattr(jax_train, "init_model",
                   lambda config, rng=0, dtype=None: (jax_build_model(config, dtype=dtype),
                                                      s_vars))
        jax_result = jax_distill_to_student(
            teacher_dir=teacher_dir, student_config=s_cfg, train_ds=train_ds, val_ds=val_ds,
            out_root=str(root / "jax"), make_figure=False, log=_quiet, initial_variables=s_vars)
    teacher, _ = load_teacher(teacher_dir, device="cpu")
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    port = {}
    for device_data in (False, True):
        cfg = {**s_cfg, "device_data": device_data}
        port[device_data] = distill_to_student(
            teacher=teacher, student_config=cfg, train_ds=train_ds, val_ds=val_ds,
            out_root=str(root / f"port{device_data}"), log=_quiet, device="cpu",
            initial_state_dict=state_dict_from_jax(s_cfg, s_vars))
    return dict(root=root, t_cfg=t_cfg, s_cfg=s_cfg, teacher_dir=teacher_dir, jax=jax_result,
                port=port, teacher=teacher, before=before, train_ds=train_ds)


@pytest.mark.parametrize("device_data", [False, True], ids=["host_batches", "device_data"])
def test_distill_losses_match_jax(runs, device_data):
    hj, hp = runs["jax"]["history"], runs["port"][device_data]["history"]
    assert len(hp["train_loss"]) == 2
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hp[key], hj[key], rtol=1e-4)
    np.testing.assert_array_equal(hp["train_accuracy"], hj["train_accuracy"])
    # the device-resident path is the host path, bit for bit
    for key in ("train_loss", "val_loss"):
        np.testing.assert_array_equal(hp[key], runs["port"][False]["history"][key])


def test_teacher_is_untouched_by_the_run(runs):
    teacher = runs["teacher"]
    assert not teacher.training
    assert all(not p.requires_grad and p.grad is None for p in teacher.parameters())
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, runs["before"][k]), k
    assert any("running_mean" in k for k in runs["before"])
    # the student's checkpoint holds the student only
    sd = torch.load(os.path.join(runs["port"][False]["model_dir"], "best_model.pth"),
                    weights_only=True)
    assert any(".mixer." in k for k in sd) and not any(k.startswith("teacher") for k in sd)
    opt = runs["port"][False]["state"].optimizer
    ids = {id(p) for g in opt.param_groups for p in g["params"]}
    assert not ids & {id(p) for p in teacher.parameters()}


def test_student_config_from_teacher_matches_jax(runs):
    t_cfg = {**runs["t_cfg"], "pretrained": True, "backbone_checkpoint": "x.npz"}
    for kind, over in ((STUDENT, {}),
                       ("inceptionnext_pico.r2", {"epochs": 3, "distill_alpha": 0.7})):
        got = student_config_from_teacher(t_cfg, kind, **over)
        want = jax_student_config(t_cfg, kind, **over)
        assert dict(got) == dict(want)
        assert got["model_kind"] == kind and "backbone_checkpoint" not in got


_APPLY = {}


def _jax_logits(teacher_dir, img, meta):
    model, variables, config = jax_load_teacher(teacher_dir)
    key = config["model_kind"]
    if key not in _APPLY:  # one compile per architecture
        _APPLY[key] = jax.jit(functools.partial(model.apply, train=False))
    return np.asarray(_APPLY[key](variables, image_input=jnp.asarray(img),
                                  metadata_input=jnp.asarray(meta))).reshape(-1)


@pytest.mark.parametrize("form", ["hf_snapshot", "port_run", "reference_run"])
def test_load_teacher_reads_every_form_the_jax_package_does(runs, form, tmp_path):
    t_cfg = runs["t_cfg"]
    if form == "hf_snapshot":
        d = str(tmp_path / "snapshot")
        os.makedirs(d)
        save_torch_checkpoint(os.path.join(d, "pytorch_model.bin"), t_cfg,
                              flax_variables(t_cfg, seed=3))
        with open(os.path.join(d, "train_config.json"), "w") as f:
            json.dump(dict(t_cfg), f)
    elif form == "port_run":
        d = runs["port"][False]["model_dir"]  # a student run of the port
    else:
        d = runs["teacher_dir"]
    model, config = load_teacher(d, device="cpu")
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    assert next(model.parameters()).dtype == torch.float32
    img = runs["train_ds"].images[:5]
    meta = runs["train_ds"].metadata[:5]
    with torch.no_grad():
        got = model(image_input=torch.from_numpy(img),
                    metadata_input=torch.from_numpy(meta)).reshape(-1).numpy()
    want = _jax_logits(d, img, meta)
    assert np.std(want) > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if form == "port_run":
        assert config["model_kind"] == STUDENT


def test_alpha_one_is_a_plain_step_and_the_teacher_runs_on_the_batch(runs):
    """alpha 1: the loss is the plain BCE step's, bit for bit, and the
    teacher stays in eval mode after the student's step."""
    s_cfg = runs["s_cfg"]
    train_ds = runs["train_ds"]
    batch = (torch.from_numpy(train_ds.images[:8]), torch.from_numpy(train_ds.metadata[:8]),
             torch.from_numpy(train_ds.labels[:8]), train_ds.pos_weight)
    losses = {}
    for name, cfg, teacher in (("plain", s_cfg, None),
                               ("alpha1", normalize_config({**s_cfg, "distill_alpha": 1.0}),
                                runs["teacher"])):
        model = build_model(cfg, device="cpu", seed=4)
        state = create_train_state(cfg, model, steps_per_epoch=1)
        losses[name] = make_train_step(cfg, teacher=teacher)(state, *batch)["loss"].item()
    assert losses["alpha1"] == losses["plain"]
    assert not runs["teacher"].training


def test_cli_distill_end_to_end(runs, tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    write_split(str(data), "train", 16, seed=1)
    write_split(str(data), "val", 8, seed=2)
    result = distill_main([runs["teacher_dir"], "--student-kind", STUDENT, "--data-dir",
                           str(data), "--out-root", str(tmp_path / "out"), "--epochs", "1",
                           "--alpha", "0.3", "--no-figure", "--device", "cpu"])
    with open(os.path.join(result["model_dir"], "report.json")) as f:
        report = json.load(f)
    assert report["train_config"]["model_kind"] == STUDENT
    assert report["train_config"]["distill_alpha"] == 0.3
    assert report["train_config"]["epochs"] == 1
    assert result["model_dir"].endswith(os.path.join("mm_ConvNeXt_v12_N100_torch", "distill"))
    assert np.isfinite(result["history"]["train_loss"]).all()
