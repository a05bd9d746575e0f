"""HF snapshot loading and single-modal serving in the port, against the JAX
package (CPU, offline: no download path runs).

A snapshot is what the JAX package's exporter publishes: ``train_config.json``
+ ``pytorch_model.bin`` written by ``save_torch_checkpoint``.  Tolerances:
f32 logits rtol 1e-4 / atol 1e-5 (summation order); scorer scores within
1e-5 of the JAX scorers in f32.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btsbot_tpu import normalize_config
from btsbot_tpu.engine import serve as jax_serve
from btsbot_tpu.interop import hf as jax_hf
from btsbot_tpu.interop.export import save_torch_checkpoint
from btsbot_tpu.models import maxvit as jax_maxvit
from btsbot_tpu_torch.data.synthetic import synthetic_packets
from btsbot_tpu_torch.engine import serve
from btsbot_tpu_torch.interop import hf
from btsbot_tpu_torch.interop.weights import state_dict_from_jax
from btsbot_tpu_torch.models import maxvit as port_maxvit
from test_torch_families import (
    CONVNEXT_ATTO,
    META_COLS,
    MM_CNN,
    UM_CNN,
    UM_NN,
    flax_logits,
    flax_variables,
    inputs,
)

MM_META = {"metadata_cols": META_COLS, "meta_fc1_neurons": 16, "meta_fc2_neurons": 12,
           "meta_dropout": 0.2, "comb_fc1_neurons": 8, "comb_fc2_neurons": 6,
           "comb_dropout": 0.2, "train_data_version": "v12"}
SNAPSHOTS = {"mm_cnn": MM_CNN, "um_cnn": UM_CNN, "um_nn": UM_NN,
             "ConvNeXt": CONVNEXT_ATTO}


def _write_snapshot(model_dir, config, variables):
    os.makedirs(model_dir, exist_ok=True)
    save_torch_checkpoint(os.path.join(model_dir, "pytorch_model.bin"), config, variables)
    with open(os.path.join(model_dir, "train_config.json"), "w") as f:
        json.dump(dict(config), f)


@pytest.mark.parametrize("family", sorted(SNAPSHOTS))
def test_load_model_dir_reads_a_jax_exported_snapshot(family, tmp_path):
    config = normalize_config(SNAPSHOTS[family])
    variables = flax_variables(config)
    _write_snapshot(str(tmp_path), config, variables)
    model, got_config = hf.load_model_dir(str(tmp_path), device="cpu")
    assert got_config["model_name"] == config["model_name"] and not model.training
    img, meta = inputs(config, 3, seed=7)
    want = flax_logits(config, variables, img, meta)
    with torch.no_grad():
        got = model(None if img is None else torch.from_numpy(img),
                    None if meta is None else torch.from_numpy(meta)).reshape(-1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


_GRID = [(a, m, p) for a in ("convnext", "maxvit", "inceptionnext", "resnet")
         for m in (True, False) for p in ("imagenet", "galaxyzoo", "randinit", "zoo")]


@pytest.mark.parametrize("arch,multi_modal,pretrain", _GRID)
def test_hf_link_and_local_dir_agree_with_jax(arch, multi_modal, pretrain):
    try:
        want = (jax_hf.get_HF_model_link(arch, multi_modal, pretrain),
                jax_hf.get_local_model_dir(arch, multi_modal, pretrain, "root"))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            hf.get_HF_model_link(arch, multi_modal, pretrain)
        return
    assert (hf.get_HF_model_link(arch, multi_modal, pretrain),
            hf.get_local_model_dir(arch, multi_modal, pretrain, "root")) == want


def test_load_hf_model_uses_the_local_snapshot_and_never_downloads(tmp_path, monkeypatch):
    def no_download(*args, **kwargs):
        raise AssertionError("download attempted")
    monkeypatch.setattr(hf, "download_HF_model", no_download)
    config = normalize_config({**CONVNEXT_ATTO, "model_kind": "convnext_atto.d1_in1k"})
    variables = flax_variables(config)
    snap = hf.get_local_model_dir("convnext", False, "imagenet", str(tmp_path))
    assert snap.endswith("BTSbot-convnext-pico-in1k")
    _write_snapshot(snap, config, variables)
    model, _ = hf.load_HF_model("convnext", False, "imagenet", models_root=str(tmp_path),
                                device="cpu")
    want = state_dict_from_jax(config, variables)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)
    # the other two architectures of the grid, MaxViT at the JAX package's
    # test spec (tests/test_maxvit_parity.py:24-47)
    for module in (jax_maxvit, port_maxvit):
        monkeypatch.setitem(module.MAXVIT_CONFIGS, "maxvit_tiny",
                            {"depths": (1, 1), "dims": (32, 64), "stem_width": 32})
    for arch, config in (("maxvit", {**MM_META, "model_name": "mm_MaxViT",
                                     "model_kind": "maxvit_tiny_rw_64.test"}),
                         ("inceptionnext", {**MM_META, "model_name": "mm_ConvNeXt",
                                            "model_kind": "inceptionnext_atto.r2"})):
        config = normalize_config(config)
        variables = flax_variables(config)
        _write_snapshot(hf.get_local_model_dir(arch, True, "imagenet", str(tmp_path)),
                        config, variables)
        model, got_config = hf.load_HF_model(arch, True, "imagenet",
                                             models_root=str(tmp_path), device="cpu")
        assert got_config["model_kind"] == config["model_kind"]
        want = state_dict_from_jax(config, variables)
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)


def test_load_torch_checkpoint_drops_a_dataparallel_prefix(tmp_path):
    path = str(tmp_path / "m.pth")
    torch.save({"module.a.weight": torch.ones(2)}, path)
    assert list(hf.load_torch_checkpoint(path)) == ["a.weight"]


@pytest.mark.parametrize("family", ["um_nn", "um_cnn"])
def test_single_modal_alert_scorer_matches_jax(family):
    config = normalize_config({**SNAPSHOTS[family], "metadata_cols": META_COLS})
    variables = flax_variables(config)
    img, meta = inputs(config, 11, seed=8)
    want = jax_serve.AlertScorer(config, variables, batch_size=8,
                                 dtype=jnp.float32)(img, meta)
    scorer = serve.AlertScorer(config, state_dict_from_jax(config, variables),
                               batch_size=8, dtype=torch.float32, device="cpu")
    got = scorer(triplets=img, metadata=meta)
    assert got.shape == (11,) and np.std(got) > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    out = serve.verify_serving_parity(config, state_dict_from_jax(config, variables),
                                      img, meta, device="cpu")
    assert out["close"]


@pytest.mark.parametrize("family", ["um_nn", "um_cnn"])
def test_single_modal_stream_scorer_matches_jax(family):
    """um_nn decodes no stamps: a packet with a broken cutout is scored."""
    config = normalize_config({**SNAPSHOTS[family], "metadata_cols": META_COLS})
    variables = flax_variables(config)
    packets = list(synthetic_packets(7, META_COLS, seed=9, unique_stamps=True))
    packets[3]["cutoutScience"] = None
    want_s, want_d = jax_serve.AlertStreamScorer(config, variables, batch_size=4,
                                                 dtype=jnp.float32)(packets)
    got_s, got_d = serve.AlertStreamScorer(
        config, state_dict_from_jax(config, variables), batch_size=4,
        dtype=torch.float32, device="cpu")(packets)
    np.testing.assert_array_equal(got_d, want_d)
    assert got_d.tolist() == [family == "um_cnn" and i == 3 for i in range(7)]
    np.testing.assert_allclose(got_s[~got_d], want_s[~want_d], rtol=0, atol=1e-5)
