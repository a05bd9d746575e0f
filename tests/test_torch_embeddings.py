"""The port's penultimate features and embeddings against the JAX package's
(CPU).

* ``extract_features`` on the same (perturbed) weights and alerts, 21 of
  them at batch 8 so the last batch is ragged (both pad it), within rtol
  1e-5 / atol 1e-6 × max(1, the largest feature) of JAX
  ``extract_features`` for mm_ConvNeXt, um_cnn,
  um_nn, the image-only ConvNeXt and frozen_fusion.  The JAX package
  returns the first "penultimate" it finds; every family sows exactly one,
  the input of its final Dense(1) (for frozen_fusion the combined head's,
  the branches being head-stripped), which is what the port's hook reads;
* ``project_2d`` (PCA, UMAP not installed) equal to the JAX function's at
  rtol 1e-6, up to the sign of each axis;
* ``run_training(generate_embeddings=True)`` (um_nn, whose features the
  test above holds too) writes the JAX package's ``embeddings.csv``
  columns: the header pandas writes, the candids as the same float64
  values (a candid above 2**53 rounded alike), the projection of the same
  best model within 1e-4 of the largest coordinate, per-axis sign aside.
"""

import csv
import os

import numpy as np
import pytest
import torch


from btsbot_tpu.data.dataset import AlertDataset as JaxAlertDataset
from btsbot_tpu.engine.checkpoint import load_model_checkpoint as jax_load_model_checkpoint
from btsbot_tpu.metrics.embeddings import extract_features as jax_extract_features
from btsbot_tpu.metrics.embeddings import generate_embeddings as jax_generate_embeddings
from btsbot_tpu.metrics.embeddings import project_2d as jax_project_2d
from btsbot_tpu.models.factory import build_model as jax_build_model
from btsbot_tpu_torch.core.config import normalize_config
from btsbot_tpu_torch.data.dataset import AlertDataset
from btsbot_tpu_torch.engine.train import run_training
from btsbot_tpu_torch.metrics.embeddings import extract_features, final_linear, project_2d
from test_torch_families import (
    CONVNEXT_ATTO,
    FUSION_CONVNEXT,
    UM_CNN,
    UM_NN,
    flax_variables,
    inputs,
    port_model,
)
from test_torch_model import atto_config
from test_torch_train import _quiet, train_config

FAMILIES = {"mm_ConvNeXt": dict(atto_config()), "um_cnn": UM_CNN, "um_nn": UM_NN,
            "ConvNeXt": CONVNEXT_ATTO, "frozen_fusion": FUSION_CONVNEXT}
N, BATCH = 21, 8


def _align_signs(got, want):
    """``got`` with each column's sign flipped to agree with ``want``."""
    signs = np.sign(np.sum(got * want, axis=0))
    return got * np.where(signs == 0, 1, signs)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_extract_features_match_jax(family):
    config = normalize_config({**FAMILIES[family], "batch_size": BATCH})
    variables = flax_variables(config)
    img, meta = inputs(config, N, seed=9)
    labels = (np.arange(N) % 3 == 0).astype(np.float32)
    want = jax_extract_features(jax_build_model(config), config, variables["params"],
                                variables.get("batch_stats", {}),
                                JaxAlertDataset(labels, img, meta))
    model = port_model(config, variables)
    got = extract_features(model, config, AlertDataset(labels, img, meta))
    assert got.dtype == np.float32 and got.shape == want.shape == (N, final_linear(model).in_features)
    assert np.std(want) > 1e-3
    # atol 1e-6 of the features' scale (they reach ~2 here): float32 sums in
    # another order through 12 blocks leave ~1.5e-6 on a unit-size feature
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(want).max()))
    # the serving forward is untouched: no hook left behind
    assert not final_linear(model)._forward_pre_hooks


def test_fusion_features_are_the_combined_heads():
    config = normalize_config(FUSION_CONVNEXT)
    model = port_model(config, flax_variables(config))
    assert final_linear(model) is model.combined_head[-1]
    assert final_linear(model).in_features == config["comb_fc2_neurons"]


@pytest.mark.parametrize("shape", [(50, 8), (13, 40)])
def test_project_2d_is_the_jax_pca(shape):
    feats = np.random.default_rng(shape[0]).normal(size=shape)
    got, want = project_2d(feats), np.asarray(jax_project_2d(feats))
    assert got.shape == (shape[0], 2)
    np.testing.assert_allclose(_align_signs(got, want), want, rtol=1e-6, atol=1e-12)
    with pytest.raises(ImportError):
        project_2d(feats, method="umap")


def _split(n, seed):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.4).astype(np.float32)
    images = rng.normal(0, 0.1, size=(n, 63, 63, 3)).astype(np.float32)
    images[labels == 1, 20:40, 20:40] += 0.5
    meta = rng.normal(size=(n, 25)).astype(np.float32)
    cand = {"objectId": np.asarray([f"ZTF{seed}{i // 3:04d}" for i in range(n)]),
            "candid": 2 ** 60 + 3 * np.arange(n, dtype=np.int64),  # past 2**53
            "jd": 2459300.5 + np.arange(n) / 5, "magpsf": 17 + 2 * rng.random(n)}
    return AlertDataset(labels, images, meta, cand)


def test_run_training_writes_the_jax_embeddings_csv(tmp_path):
    import pandas as pd
    config = train_config(model_name="um_nn", epochs=1, generate_embeddings=True)
    train_ds, val_ds = _split(32, seed=1), _split(N, seed=2)
    result = run_training(config, train_ds=train_ds, val_ds=val_ds, out_root=str(tmp_path),
                          log=_quiet, device="cpu")
    path = os.path.join(result["model_dir"], "embeddings.csv")
    # the JAX package's embeddings of the same best model, written its way
    variables = jax_load_model_checkpoint(config, result["model_dir"])
    jax_ds = JaxAlertDataset(val_ds.labels, val_ds.images, val_ds.metadata,
                             pd.DataFrame(val_ds.candidates))
    emb = jax_generate_embeddings(jax_build_model(config), config, variables["params"],
                                  variables.get("batch_stats", {}), jax_ds,
                                  candids=jax_ds.candidates["candid"].to_numpy(), seed=0)
    want_path = str(tmp_path / "jax_embeddings.csv")
    pd.DataFrame(emb, columns=["umap_emb_1", "umap_emb_2", "candid"]).to_csv(want_path,
                                                                             index=False)
    tables = []
    for p in (path, want_path):
        with open(p, newline="") as f:
            rows = list(csv.reader(f))
        tables.append((rows[0], np.asarray(rows[1:], dtype=np.float64)))
    (head, got), (want_head, want) = tables
    assert head == want_head == ["umap_emb_1", "umap_emb_2", "candid"]
    assert got.shape == want.shape == (N, 3)
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    assert got[0, 2] == float(2 ** 60) and got[1, 2] == got[0, 2]  # rounded alike
    scale = np.abs(want[:, :2]).max()
    np.testing.assert_allclose(_align_signs(got[:, :2], want[:, :2]), want[:, :2],
                               rtol=0, atol=1e-4 * scale)


def test_embeddings_error_is_logged_not_raised(tmp_path, monkeypatch):
    """The reference's guard: a failure there skips the file, the run ends."""
    from btsbot_tpu_torch.metrics import embeddings
    monkeypatch.setattr(embeddings, "project_2d",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    logs = []
    result = run_training(train_config(model_name="um_nn", epochs=1,
                                       generate_embeddings=True),
                          train_ds=_split(16, seed=3), val_ds=_split(8, seed=4),
                          out_root=str(tmp_path), log=logs.append, device="cpu")
    assert "Error generating embeddings: boom; skipping." in logs
    assert "embeddings.csv" not in os.listdir(result["model_dir"])
    assert torch.isfinite(torch.as_tensor(result["history"]["val_loss"])).all()
