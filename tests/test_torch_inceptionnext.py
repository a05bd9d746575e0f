"""The port's ``inceptionnext_*`` kinds against the JAX package (CPU).

The InceptionNeXt block is the mixer (three depthwise convs on 3/8 of the
channels) followed by ``ops.ln_mlp.fused_ln_mlp``, whose plain version runs
on the CPU.  Weights cross through ``state_dict_from_jax`` and through the
JAX exporter's dict (loaded strict).  Tolerances: the mixer alone rtol 1e-5
/ atol 1e-6 (three float32 depthwise convs); logits rtol 1e-4 / atol 1e-5
(summation order); bf16 scores within 0.01 of the JAX package's bf16
(serving noise); train-step losses rtol 1e-4 and the metadata BatchNorm
statistics 1e-6, as tests/test_torch_train.py.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from btsbot_tpu import normalize_config
from btsbot_tpu.engine.state import create_train_state as jax_create_train_state
from btsbot_tpu.engine.state import make_optimizer as jax_make_optimizer
from btsbot_tpu.engine.steps import make_train_step as jax_make_train_step
from btsbot_tpu.interop.export import save_torch_checkpoint, variables_to_torch_state_dict
from btsbot_tpu.models.convnext import InceptionMixer as JaxInceptionMixer
from btsbot_tpu.models.factory import build_model as jax_build_model
from btsbot_tpu_torch.engine.state import create_train_state
from btsbot_tpu_torch.engine.steps import make_train_step
from btsbot_tpu_torch.interop import hf
from btsbot_tpu_torch.interop.weights import state_dict_from_jax
from btsbot_tpu_torch.models import convnext
from btsbot_tpu_torch.models.convnext import InceptionMixer, InceptionNeXtBlock
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.ops.ln_mlp import ln_mlp_reference
from test_torch_families import (
    META_COLS,
    UM_NN,
    _COMB,
    _HEAD,
    _META,
    flax_logits,
    flax_variables,
    inputs,
    port_model,
)
from test_torch_families_train import _batches, _cfg, _no_dropout

MM_ATTO = {"model_name": "mm_ConvNeXt", "model_kind": "inceptionnext_atto",
           "train_data_version": "v12", **_META, **_COMB}
MM_ATTO_R2 = {**MM_ATTO, "model_kind": "inceptionnext_atto.r2"}
IMAGE_ATTO = {"model_name": "ConvNeXt", "model_kind": "inceptionnext_atto.r2", **_HEAD,
              "metadata_cols": META_COLS}
FUSION = {"model_name": "frozen_fusion", "metadata_cols": META_COLS,
          "image_model_config": IMAGE_ATTO, "meta_model_config": UM_NN, **_COMB}
FAMILIES = {"mm_atto": MM_ATTO, "mm_atto_r2": MM_ATTO_R2, "image_atto_r2": IMAGE_ATTO,
            "fusion_atto_r2": FUSION}


@pytest.mark.parametrize("dim", [40, 64, 7])
def test_inception_mixer_matches_flax(dim):
    rng = np.random.default_rng(dim)
    x = rng.normal(size=(2, 9, 13, dim)).astype(np.float32)
    mixer = JaxInceptionMixer(dim)
    params = jax.tree_util.tree_map(np.asarray, mixer.init(jax.random.key(0), x))["params"]
    params = jax.tree_util.tree_map(
        lambda v: (v + rng.normal(size=v.shape) * 0.1).astype(np.float32), params)
    want = np.asarray(mixer.apply({"params": params}, x))
    port = InceptionMixer(dim)
    with torch.no_grad():
        for name in ("dw_square", "dw_band_w", "dw_band_h"):
            conv = getattr(port, name)
            conv.weight.copy_(torch.from_numpy(
                np.transpose(params[name]["kernel"], (3, 2, 0, 1)).copy()))
            conv.bias.copy_(torch.from_numpy(params[name]["bias"]))
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    g = max(1, dim // 8)
    np.testing.assert_array_equal(got[..., 3 * g:], x[..., 3 * g:])  # the identity 5/8
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_state_dict_from_jax_matches_exporter(family):
    config = normalize_config(FAMILIES[family])
    variables = flax_variables(config)
    got = state_dict_from_jax(config, variables)
    want = variables_to_torch_state_dict(config, variables)
    assert sorted(got) == sorted(want)
    assert any(".mixer.dw_band_h." in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("bridge", ["state_dict_from_jax", "exporter"])
def test_f32_logits_match_flax(family, bridge):
    config = normalize_config(FAMILIES[family])
    variables = flax_variables(config)
    img, meta = inputs(config, 3, seed=3)
    want = flax_logits(config, variables, img, meta)
    if bridge == "state_dict_from_jax":
        model = port_model(config, variables)
    else:
        model = build_model(config, device="cpu")
        model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in
                               variables_to_torch_state_dict(config, variables).items()},
                              strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(img),
                    None if meta is None else torch.from_numpy(meta)).reshape(-1).numpy()
    assert np.std(want) > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_mlp_ratio_sets_the_hidden_width():
    for kind, hidden in (("inceptionnext_atto", 160), ("inceptionnext_atto.r2", 80),
                         ("inceptionnext_pico.r1", 64), ("inceptionnext_pico.r3", 192)):
        model = build_model({**MM_ATTO, "model_kind": kind}, device="cpu")
        block = model.convnext_backbone.stages[0].blocks[0]
        assert isinstance(block, InceptionNeXtBlock)
        assert tuple(block.mlp.fc1.weight.shape) == (hidden, block.norm.weight.shape[0])


def test_every_block_goes_through_fused_ln_mlp(monkeypatch):
    """12 blocks, 12 calls of the kernel's wrapper; with its plain version
    patched in, none."""
    calls = []
    real = convnext.fused_ln_mlp

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(convnext, "fused_ln_mlp", counting)
    config = normalize_config(MM_ATTO_R2)
    model = port_model(config, flax_variables(config))
    img, meta = inputs(config, 2, seed=4)
    with torch.no_grad():
        out = model(torch.from_numpy(img), torch.from_numpy(meta))
        assert len(calls) == 12
        assert calls[0] == (2 * 15 * 15, 40) and calls[-1] == (2 * 1 * 1, 320)
        monkeypatch.setattr(convnext, "fused_ln_mlp", ln_mlp_reference)
        plain = model(torch.from_numpy(img), torch.from_numpy(meta))
    assert len(calls) == 12
    torch.testing.assert_close(plain, out, rtol=0, atol=0)


@pytest.mark.parametrize("family", ["mm_atto", "mm_atto_r2"])
def test_bf16_scores_close_to_jax_bf16(family):
    config = normalize_config(FAMILIES[family])
    variables = flax_variables(config)
    img, meta = inputs(config, 4, seed=5)
    jmodel = jax_build_model(config, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(functools.partial(jmodel.apply, train=False))(
        variables, image_input=jnp.asarray(img, jnp.bfloat16),
        metadata_input=jnp.asarray(meta, jnp.bfloat16)), np.float32).reshape(-1)
    model = port_model(config, variables, torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(img).bfloat16(),
                    torch.from_numpy(meta).bfloat16()).float().reshape(-1).numpy()
    d = np.abs(1 / (1 + np.exp(-got)) - 1 / (1 + np.exp(-want))).max()
    assert d < 0.01


def test_three_train_steps_match_the_jax_step():
    """inceptionnext_atto.r2 under autograd through ``fused_ln_mlp``'s plain
    version; dropout and augmentation off."""
    config = _cfg(_no_dropout(MM_ATTO_R2))
    variables = flax_variables(config)
    jax_model = jax_build_model(config)
    tx = jax_make_optimizer(config, steps_per_epoch=3)
    jstate = jax_create_train_state(config, jax.tree_util.tree_map(np.asarray, variables),
                                    tx, seed=0)
    jstep = jax_make_train_step(jax_model, tx, config)
    model = port_model(config, variables)
    state = create_train_state(config, model, steps_per_epoch=3, seed=0)
    step = make_train_step(config)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for images, meta, labels in _batches(3, 8, seed=1):
        jstate, jm = jstep(jstate, images, meta, labels, 1.5)
        m = step(state, torch.from_numpy(images), torch.from_numpy(meta),
                 torch.from_numpy(labels), 1.5)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
    bn = jstate.batch_stats["metadata_branch"]["bn"]
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(model.state_dict()[f"metadata_branch.0.{ours}"].numpy(),
                                   np.asarray(bn[theirs]), rtol=1e-6, atol=1e-6)
    after = model.state_dict()
    for k in ("convnext_backbone.stages.0.blocks.0.mixer.dw_band_w.weight",
              "convnext_backbone.stages.2.blocks.5.mlp.fc2.weight",
              "convnext_backbone.stages.3.blocks.1.gamma"):
        assert not torch.equal(after[k], before[k]), k


def test_load_hf_model_inceptionnext_from_an_offline_snapshot(tmp_path, monkeypatch):
    def no_download(*args, **kwargs):
        raise AssertionError("download attempted")
    monkeypatch.setattr(hf, "download_HF_model", no_download)
    config = normalize_config(MM_ATTO_R2)
    variables = flax_variables(config)
    snap = hf.get_local_model_dir("inceptionnext", True, "imagenet", str(tmp_path))
    assert snap.endswith("BTSbot-inceptionnext-pico-in1k-metadata")
    os.makedirs(snap)
    save_torch_checkpoint(os.path.join(snap, "pytorch_model.bin"), config, variables)
    with open(os.path.join(snap, "train_config.json"), "w") as f:
        json.dump(dict(config), f)
    model, _ = hf.load_HF_model("inceptionnext", True, "imagenet",
                                models_root=str(tmp_path), device="cpu")
    img, meta = inputs(config, 3, seed=6)
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(meta)).reshape(-1).numpy()
    np.testing.assert_allclose(got, flax_logits(config, variables, img, meta),
                               rtol=1e-4, atol=1e-5)
