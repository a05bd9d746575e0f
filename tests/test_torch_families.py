"""The port's CNN, MLP, image-only ConvNeXt and frozen-fusion models against
the flax models on the same weights (CPU).

Weights cross through ``btsbot_tpu_torch.interop.weights.state_dict_from_jax``
after every parameter leaf is perturbed with seeded noise and every
BatchNorm statistic redrawn (the flax init's zero biases, γ = 1e-6 and unit
statistics would hide mapping errors).  Tolerances: f32 logits rtol 1e-4 /
atol 1e-5 (summation order); the port's bf16 scores within 0.01 of its own
f32 scores (serving noise); the reference-trained checkpoint's scores rtol
1e-4 / atol 1e-5 (the reference's verify tolerance).
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
from btsbot_tpu.interop.export import variables_to_torch_state_dict
from btsbot_tpu.models.factory import build_model as jax_build_model
from btsbot_tpu.models.factory import example_inputs as jax_example_inputs
from btsbot_tpu_torch.interop.weights import nchw_flatten_perm, state_dict_from_jax
from btsbot_tpu_torch.models.cnn import CnnBackbone
from btsbot_tpu_torch.models.common import Dropout2d, set_dropout_generator
from btsbot_tpu_torch.models.factory import build_model, example_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "ref_trained_mm_cnn")
META_COLS = [f"m{i}" for i in range(25)]
_META = {"metadata_cols": META_COLS, "meta_fc1_neurons": 16, "meta_fc2_neurons": 12,
         "meta_dropout": 0.2}
_CONV = {"conv1_channels": 4, "conv2_channels": 8, "conv_kernel": 3,
         "conv_dropout1": 0.5, "conv_dropout2": 0.55}
_COMB = {"comb_fc1_neurons": 8, "comb_fc2_neurons": 6, "comb_dropout": 0.2}
_HEAD = {"fc1_neurons": 8, "fc2_neurons": 6, "dropout": 0.2}

MM_CNN = {"model_name": "mm_cnn", **_CONV, **_META, **_COMB}
UM_CNN = {"model_name": "um_cnn", **_CONV, **_HEAD, "metadata_cols": META_COLS}
UM_NN = {"model_name": "um_nn", **_META}
CONVNEXT_ATTO = {"model_name": "ConvNeXt", "model_kind": "convnext_atto.test", **_HEAD,
                 "metadata_cols": META_COLS}
CONVNEXT_PICO = {"model_name": "ConvNeXt", "model_kind": "convnext_pico.d1_in1k",
                 "fc1_neurons": 256, "fc2_neurons": 32, "dropout": 0.2,
                 "metadata_cols": META_COLS}
FUSION_CNN = {"model_name": "frozen_fusion", "metadata_cols": META_COLS,
              "image_model_config": UM_CNN, "meta_model_config": UM_NN, **_COMB}
FUSION_CONVNEXT = {**FUSION_CNN, "image_model_config": CONVNEXT_ATTO}
with open(os.path.join(REPO, "btsbot_tpu", "train_configs", "prod_config.json")) as _f:
    PROD = json.load(_f)

FAMILIES = {"mm_cnn": MM_CNN, "mm_cnn_prod": PROD, "um_cnn": UM_CNN, "um_nn": UM_NN,
            "ConvNeXt_atto": CONVNEXT_ATTO, "ConvNeXt_pico": CONVNEXT_PICO,
            "fusion_um_cnn": FUSION_CNN, "fusion_ConvNeXt": FUSION_CONVNEXT}


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "gamma":
            out[k] = (rng.normal(size=v.shape) * 0.5).astype(np.float32)
        else:
            out[k] = (np.asarray(v) + rng.normal(size=v.shape) * 0.05).astype(np.float32)
    return out


def _redraw_stats(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(size=v.shape).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _variables(key, seed):
    config = normalize_config(json.loads(key))
    model = jax_build_model(config)
    img, meta = jax_example_inputs(config)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree_util.tree_map(
        np.asarray, init(jax.random.key(seed), image_input=img, metadata_input=meta))
    rng = np.random.default_rng(seed)
    out = {"params": _perturb(variables["params"], rng)}
    if "batch_stats" in variables:
        out["batch_stats"] = _redraw_stats(variables["batch_stats"], rng)
    return out


def flax_variables(config, seed=0):
    """Flax variables for ``config``, every leaf randomised (numpy)."""
    return _variables(json.dumps(dict(config), sort_keys=True), seed)


def port_model(config, variables, dtype=torch.float32):
    model = build_model(config, dtype=dtype, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           state_dict_from_jax(config, variables).items()}, strict=True)
    return model


def inputs(config, n, seed):
    """Numpy (images, metadata) of the config's modality (None where the
    model takes none)."""
    config = normalize_config(config)
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n, 63, 63, 3)).astype(np.float32)
    meta = rng.normal(size=(n, len(config["metadata_cols"]))).astype(np.float32)
    return (img if config.need_triplets else None,
            meta if config.need_metadata else None)


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


def flax_logits(config, variables, img, meta):
    model = jax_build_model(normalize_config(config))
    apply = jax.jit(functools.partial(model.apply, train=False))
    return np.asarray(apply(variables,
                            image_input=None if img is None else jnp.asarray(img),
                            metadata_input=None if meta is None else jnp.asarray(meta))
                      ).reshape(-1)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_state_dict_from_jax_matches_exporter(family):
    config = normalize_config(FAMILIES[family])
    variables = flax_variables(config)
    got = state_dict_from_jax(config, variables)
    want = variables_to_torch_state_dict(config, variables)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_f32_logits_match_flax(family):
    config = normalize_config(FAMILIES[family])
    variables = flax_variables(config)
    img, meta = inputs(config, 3, seed=3)
    want = flax_logits(config, variables, img, meta)
    with torch.no_grad():
        got = port_model(config, variables)(_t(img), _t(meta)).reshape(-1).numpy()
    assert np.std(want) > 1e-3  # the check must see the inputs
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", ["mm_cnn", "um_cnn", "um_nn", "ConvNeXt_atto",
                                    "fusion_um_cnn", "fusion_ConvNeXt"])
def test_bf16_scores_close_to_f32(family):
    config = normalize_config(FAMILIES[family])
    variables = flax_variables(config)
    img, meta = inputs(config, 4, seed=5)
    with torch.no_grad():
        z32 = port_model(config, variables)(_t(img), _t(meta))
        z16 = port_model(config, variables, torch.bfloat16)(
            _t(img, torch.bfloat16), _t(meta, torch.bfloat16))
    assert z16.dtype == torch.bfloat16
    assert (torch.sigmoid(z16.float()) - torch.sigmoid(z32)).abs().max().item() < 0.01


def test_reference_trained_checkpoint_loads_strict_and_reproduces_its_scores():
    """The reference trainer's own best_model.pth, no converter: the port
    flattens in NCHW order as the reference does."""
    with open(os.path.join(FIXTURE, "report.json")) as f:
        config = normalize_config(json.load(f)["train_config"])
    model = build_model(config, device="cpu")
    sd = torch.load(os.path.join(FIXTURE, "best_model.pth"), weights_only=True)
    model.load_state_dict(sd, strict=True)
    bundle = np.load(os.path.join(FIXTURE, "in_distribution.npz"))
    with torch.no_grad():
        z = model(_t(bundle["images"]), _t(bundle["metadata"])).reshape(-1)
    expected = bundle["expected_scores"]
    assert expected.std() > 0.05
    np.testing.assert_allclose(torch.sigmoid(z).numpy(), expected, rtol=1e-4, atol=1e-5)


def test_nchw_flatten_perm_matches_the_jax_converter():
    from btsbot_tpu.interop.convert import nchw_flatten_perm as jax_perm

    for c, h, w in ((64, 7, 7), (8, 3, 5)):
        np.testing.assert_array_equal(nchw_flatten_perm(c, h, w), jax_perm(c, h, w))


def test_cnn_flattens_in_nchw_order():
    """Feature k of the flatten is channel k // 49 at pixel k % 49."""
    backbone = CnnBackbone(normalize_config(MM_CNN)).eval()
    x = torch.randn(2, 63, 63, 3)
    with torch.no_grad():
        feats = backbone(x)
        m = x
        for layer in backbone:
            m = layer(m)
    assert m.shape == (2, 7, 7, 8) and feats.shape == (2, 8 * 49)
    torch.testing.assert_close(feats, m.permute(0, 3, 1, 2).reshape(2, -1), rtol=0, atol=0)


def test_dropout2d_masks_are_constant_over_height_and_width():
    drop = Dropout2d(0.5).train()
    g = torch.Generator().manual_seed(0)
    set_dropout_generator(torch.nn.Sequential(drop), g)
    out = drop(torch.ones(4, 9, 7, 16))
    assert set(out.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(out, out[:, :1, :1, :].expand_as(out))
    assert 0 < (out[:, 0, 0, :] == 0).float().mean() < 1  # per channel, varied
    g.manual_seed(0)
    assert torch.equal(drop(torch.ones(4, 9, 7, 16)), out)  # drawn from the generator
    assert torch.equal(drop.eval()(out), out)


def test_dropout2d_sits_in_the_reference_positions():
    model = build_model(MM_CNN, device="cpu")
    assert [i for i, m in enumerate(model.conv_layers) if isinstance(m, Dropout2d)] == [5, 11]
    assert [n for n, p in model.conv_layers.named_parameters()] == [
        f"{i}.{w}" for i in (0, 2, 6, 8) for w in ("weight", "bias")]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_example_inputs_match_jax(family):
    config = normalize_config(FAMILIES[family])
    want = jax_example_inputs(config, batch_size=3)
    got = example_inputs(config, batch_size=3, device="cpu")
    for w, g in zip(want, got):
        assert (w is None and g is None) or tuple(w.shape) == tuple(g.shape)

