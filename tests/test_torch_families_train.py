"""Training the CNN and frozen-fusion families with the port, against the
JAX package's train step and branch loader (CPU).

Tolerances, each with its reason:

* losses over 3 steps rtol 1e-4 (float32 through convs, AdamW and the
  BatchNorm update, in another operation order; dropout and augmentation
  off, since the two packages' random streams differ);
* BatchNorm running statistics within 1e-6 of flax (float32 reductions);
* frozen branches bit-identical, and a resumed run equal to an
  uninterrupted one bit for bit (the generator follows (seed, step));
* ``load_fusion_branches`` equal to the JAX package's, value for value
  (the same files, no arithmetic).
"""

import json

import numpy as np
import pytest
import torch

import jax

from btsbot_tpu import normalize_config
from btsbot_tpu.engine.state import create_train_state as jax_create_train_state
from btsbot_tpu.engine.state import make_optimizer as jax_make_optimizer
from btsbot_tpu.engine.steps import make_train_step as jax_make_train_step
from btsbot_tpu.interop.export import variables_to_torch_state_dict
from btsbot_tpu.models.factory import build_model as jax_build_model
from btsbot_tpu.models.fusion import load_fusion_branches as jax_load_fusion_branches
from btsbot_tpu_torch.data.dataset import AlertDataset
from btsbot_tpu_torch.engine.checkpoint import load_model_checkpoint
from btsbot_tpu_torch.engine.state import create_train_state
from btsbot_tpu_torch.engine.steps import make_train_step
from btsbot_tpu_torch.engine.train import run_training
from btsbot_tpu_torch.models.fusion import FROZEN_PREFIXES, load_fusion_branches
from test_torch_families import (
    CONVNEXT_ATTO,
    FUSION_CNN,
    META_COLS,
    MM_CNN,
    UM_CNN,
    UM_NN,
    flax_variables,
    port_model,
)

_TRAIN = {"learning_rate": 1e-3, "beta_1": 0.9, "beta_2": 0.999, "batch_size": 8,
          "epochs": 1, "patience": 3, "warmup_epochs": 0, "random_seed": 0,
          "pretrained": False, "train_data_version": "v12", "data_aug_h_flip": 0,
          "data_aug_v_flip": 0, "data_aug_rot": 0}
_NO_DROP = {"conv_dropout1": 0.0, "conv_dropout2": 0.0, "meta_dropout": 0.0,
            "comb_dropout": 0.0, "dropout": 0.0}


def _quiet(_msg):
    pass


def _cfg(base, **over):
    return normalize_config({**base, **_TRAIN, **over})


def _no_dropout(base):
    out = {**base, **{k: v for k, v in _NO_DROP.items() if k in base}}
    for key in ("image_model_config", "meta_model_config"):
        if key in base:
            out[key] = _no_dropout(base[key])
    return out


def _batches(n_steps, bs, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        labels = (rng.random(bs) < 0.4).astype(np.float32)
        images = rng.normal(0, 0.3, size=(bs, 63, 63, 3)).astype(np.float32)
        meta = rng.normal(size=(bs, len(META_COLS))).astype(np.float32)
        out.append((images, meta, labels))
    return out


def _bn(model, config):
    if config["model_name"] == "frozen_fusion":
        return model.meta_branch.network[0]
    return model.metadata_branch[0]


@pytest.mark.parametrize("family", ["mm_cnn", "fusion_um_cnn", "fusion_ConvNeXt"])
def test_three_train_steps_match_the_jax_step(family):
    base = {"mm_cnn": MM_CNN, "fusion_um_cnn": FUSION_CNN,
            "fusion_ConvNeXt": {**FUSION_CNN, "image_model_config": CONVNEXT_ATTO}}[family]
    config = _cfg(_no_dropout(base))
    variables = flax_variables(config)
    batches = _batches(3, 8, seed=1)
    pos_weight = 1.5

    jax_model = jax_build_model(config)
    tx = jax_make_optimizer(config, steps_per_epoch=3)
    jstate = jax_create_train_state(config, jax.tree_util.tree_map(np.asarray, variables),
                                    tx, seed=0)
    jstep = jax_make_train_step(jax_model, tx, config)
    model = port_model(config, variables)
    state = create_train_state(config, model, steps_per_epoch=3, seed=0)
    step = make_train_step(config)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for images, meta, labels in batches:
        jstate, jm = jstep(jstate, images, meta, labels, pos_weight)
        m = step(state, torch.from_numpy(images), torch.from_numpy(meta),
                 torch.from_numpy(labels), pos_weight)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)

    key = "meta_branch" if family.startswith("fusion") else "metadata_branch"
    want = jstate.batch_stats[key]["bn"]
    bn = _bn(model, config)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want["var"]),
                               rtol=1e-6, atol=1e-6)
    after = model.state_dict()
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert any(k.startswith("combined_head.") for k in moved)
    if family.startswith("fusion"):
        params = {n for n, _ in model.named_parameters()}
        assert not [k for k in moved if k in params and k.startswith(FROZEN_PREFIXES)]
        assert all(not p.requires_grad for n, p in model.named_parameters()
                   if n.startswith(FROZEN_PREFIXES))
        assert sum(p.numel() for g in state.optimizer.param_groups for p in g["params"]) \
            == sum(p.numel() for p in model.combined_head.parameters())


def _datasets(seed, n_train=32, n_val=16):
    rng = np.random.default_rng(seed)

    def make(n):
        labels = (rng.random(n) < 0.4).astype(np.float32)
        images = rng.normal(0, 0.1, size=(n, 63, 63, 3)).astype(np.float32)
        images[labels == 1, 20:40, 20:40] += 0.5
        meta = (rng.normal(size=(n, len(META_COLS))) + labels[:, None]).astype(np.float32)
        return AlertDataset(labels, images, meta)
    return make(n_train), make(n_val)


class _Interrupt(Exception):
    pass


def _whole_and_resumed(config, tmp_path, datasets):
    kw = dict(train_ds=datasets[0], val_ds=datasets[1], log=_quiet, device="cpu")
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
    for name, t in whole["model"].state_dict().items():
        torch.testing.assert_close(resumed["model"].state_dict()[name], t, rtol=0, atol=0)
    return whole


def test_mm_cnn_resume_with_channel_dropout_equals_an_uninterrupted_run(tmp_path):
    """Dropout2d, dropout and augmentation on: the resumed run draws the
    same masks."""
    config = _cfg(MM_CNN, epochs=2, random_seed=3, data_aug_h_flip=1, data_aug_v_flip=1,
                  data_aug_rot=1)
    whole = _whole_and_resumed(config, tmp_path, _datasets(seed=2))
    assert whole["state"].step == 8


@pytest.fixture(scope="module")
def branch_runs(tmp_path_factory):
    """One-epoch port runs of um_cnn and um_nn, and the fusion config over
    their run directories."""
    root = tmp_path_factory.mktemp("branches")
    datasets = _datasets(seed=4)
    dirs = {}
    for base in (UM_CNN, UM_NN):
        r = run_training(_cfg(base), train_ds=datasets[0], val_ds=datasets[1],
                         out_root=str(root), log=_quiet, device="cpu")
        dirs[base["model_name"]] = r["model_dir"]
    fusion = _cfg({"model_name": "frozen_fusion", "metadata_cols": META_COLS,
                   "image_model_dir": dirs["um_cnn"], "meta_model_dir": dirs["um_nn"],
                   "comb_fc1_neurons": 8, "comb_fc2_neurons": 6, "comb_dropout": 0.2})
    return dict(dirs=dirs, fusion=fusion, datasets=datasets)


def test_load_fusion_branches_matches_jax(branch_runs):
    config = branch_runs["fusion"]
    variables = flax_variables(config)
    want = variables_to_torch_state_dict(config, jax_load_fusion_branches(
        config, jax.tree_util.tree_map(np.asarray, variables)))
    got = load_fusion_branches(config, port_model(config, variables).state_dict())
    assert sorted(got) == sorted(want)
    for k in want:
        if not k.endswith("num_batches_tracked"):  # JAX writes 0, the port the file's
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_load_fusion_branches_refuses_a_branch_that_does_not_fit(branch_runs):
    config = {**branch_runs["fusion"], "meta_model_dir": branch_runs["dirs"]["um_cnn"],
              "meta_model_config": dict(UM_NN)}
    model = port_model(branch_runs["fusion"], flax_variables(branch_runs["fusion"]))
    with pytest.raises(KeyError, match="does not fit"):
        load_fusion_branches(config, model.state_dict())


def test_frozen_fusion_run_keeps_its_branches_and_moves_its_head(branch_runs, tmp_path):
    config = normalize_config({**branch_runs["fusion"], "epochs": 2})
    datasets = branch_runs["datasets"]
    result = _whole_and_resumed(config, tmp_path, datasets)
    sd = result["model"].state_dict()
    branch = {"image_branch": load_model_checkpoint(None, branch_runs["dirs"]["um_cnn"]),
              "meta_branch": load_model_checkpoint(None, branch_runs["dirs"]["um_nn"])}
    params = {n for n, _ in result["model"].named_parameters()}
    for name in params:
        if name.startswith("image_branch."):
            assert torch.equal(sd[name], branch["image_branch"][name[len("image_branch."):]])
        elif name.startswith("meta_branch."):
            assert torch.equal(sd[name], branch["meta_branch"][name[len("meta_branch."):]])
    # train mode throughout: the metadata branch's BatchNorm statistics move
    assert not torch.equal(sd["meta_branch.network.0.running_mean"],
                           branch["meta_branch"]["network.0.running_mean"])
    fresh = run_training({**config, "epochs": 1}, train_ds=datasets[0], val_ds=datasets[1],
                         out_root=str(tmp_path / "one"), log=_quiet, device="cpu")
    start = load_fusion_branches(config, fresh["model"].state_dict())
    assert not torch.equal(sd["combined_head.0.weight"], start["combined_head.0.weight"])
    with open(f"{result['model_dir']}/report.json") as f:
        assert json.load(f)["train_config"]["model_name"] == "frozen_fusion"


@pytest.mark.parametrize("base", [UM_CNN, UM_NN], ids=["um_cnn", "um_nn"])
def test_single_modal_runs_train_and_report(base, tmp_path):
    datasets = _datasets(seed=5)
    r = run_training(_cfg(base, epochs=2), train_ds=datasets[0], val_ds=datasets[1],
                     out_root=str(tmp_path), log=_quiet, device="cpu")
    assert np.all(np.isfinite(r["history"]["train_loss"]))
    assert r["best_val_scores"].shape == (16,)


@pytest.mark.parametrize("base", [UM_NN, MM_CNN], ids=["um_nn", "mm_cnn"])
def test_bfloat16_step_keeps_float32_parameters(base):
    """A metadata-only model computes in the metadata's (cast) type."""
    config = _cfg(base, compute_dtype="bfloat16")
    model = port_model(config, flax_variables(config))
    state = create_train_state(config, model, steps_per_epoch=1)
    images, meta, labels = _batches(1, 8, seed=6)[0]
    m = make_train_step(config)(state, torch.from_numpy(images), torch.from_numpy(meta),
                                torch.from_numpy(labels), 1.0)
    assert m["logits"].dtype == torch.bfloat16 and m["loss"].dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())

