"""The port's ``init_scheme`` against the JAX package's (CPU).

``build_model`` initialises by the config's ``init_scheme`` as the JAX
``init_model`` does (models/factory.py:82-89 there).  The draws come from
different generators, so the tests hold the laws, not the values:

* ``"flax"``: zero biases and lecun_normal weights (a normal truncated at
  ±2σ, σ corrected so the drawn std is 1/√fan_in): for every Conv / Linear
  weight of at least 4,096 entries, std within 5 % of 1/√fan_in and no
  entry past the truncation, in both packages, layer for layer;
* ``"torch"``: every weight and bias within ±1/√fan_in, the std of every
  weight of at least 4,096 entries within 5 % of bound/√3, γ = 1e-6,
  LayerNorm / BatchNorm weight 1 and bias 0, MaxViT's relative-position
  tables std 0.02 ± 10 %;
* any other scheme raises the JAX package's ValueError.
"""

import functools
import math

import numpy as np
import pytest
import torch
from torch import nn

import jax

from btsbot_tpu.models.factory import build_model as jax_build_model
from btsbot_tpu.models.factory import example_inputs as jax_example_inputs
from btsbot_tpu.models.factory import init_model
from btsbot_tpu_torch.core.config import normalize_config
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.models.init import fan_in
from btsbot_tpu_torch.models import maxvit as port_maxvit
from test_torch_families import MM_CNN, UM_CNN, UM_NN
from test_torch_model import atto_config

BIG = 4096
PROD_CNN = {**MM_CNN, "conv1_channels": 32, "conv2_channels": 64, "conv_kernel": 5,
            "meta_fc1_neurons": 128, "meta_fc2_neurons": 128,
            "comb_fc1_neurons": 256, "comb_fc2_neurons": 32}
CONFIGS = {"mm_ConvNeXt_atto": dict(atto_config()), "mm_cnn": PROD_CNN,
           "um_cnn": {**UM_CNN, "conv1_channels": 32, "conv2_channels": 64, "conv_kernel": 5}}
# the InceptionNeXt mixer's convs too (the JAX init of that model is slow to
# compile on the host, so the JAX comparison stays with the three above)
PORT_CONFIGS = {**CONFIGS, "inceptionnext_atto": dict(atto_config(kind="inceptionnext_atto"))}


def _jax_kernels(config):
    """(fan_in, numel, std, max|w|) of every flax kernel, and every bias, of
    the JAX package's ``init_scheme: "flax"`` init: ``init_model`` returns
    the module's own ``init`` for that scheme (models/factory.py:82-89
    there), run here jitted, as its tests' fixtures do, to compile once."""
    config = normalize_config(config)
    model = jax_build_model(config)
    img, meta = jax_example_inputs(config)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(0), image_input=img, metadata_input=meta)
    kernels, biases = [], []

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "kernel" and v.ndim >= 2:
                w = np.asarray(v, np.float64)
                kernels.append((int(np.prod(w.shape[:-1])), w.size, w.std(), np.abs(w).max()))
            elif k == "bias":
                biases.append(np.asarray(v))
    walk(variables["params"])
    return kernels, biases


def _port_layers(model):
    return [m for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flax_scheme_draws_lecun_normal_and_zero_biases_as_jax(name):
    config = normalize_config({**CONFIGS[name], "init_scheme": "flax"})
    model = build_model(config, device="cpu", seed=3)
    ours = []
    for layer in _port_layers(model):
        w = layer.weight.detach().double()
        if layer.bias is not None:
            assert torch.count_nonzero(layer.bias) == 0
        ours.append((fan_in(w), w.numel(), w.std().item(), w.abs().max().item()))
    theirs, jax_biases = _jax_kernels(config)
    assert all(not b.any() for b in jax_biases)
    # the same layers: one (fan_in, entries) multiset
    assert sorted(o[:2] for o in ours) == sorted(t[:2] for t in theirs)
    checked = 0
    for fan, n, std, top in ours + theirs:
        bound = 1 / math.sqrt(fan)
        assert top <= 2 * bound / 0.87962566103423978 * (1 + 1e-6)
        if n >= BIG:
            assert abs(std / bound - 1) <= 0.05, (name, fan, n, std, bound)
            checked += 1
    assert checked >= 2


@pytest.mark.parametrize("name", sorted(PORT_CONFIGS))
def test_torch_scheme_is_the_uniform_closed_form(name):
    config = normalize_config(PORT_CONFIGS[name])
    assert config["init_scheme"] == "torch"
    model = build_model(config, device="cpu", seed=1)
    checked = 0
    for layer in _port_layers(model):
        bound = 1 / math.sqrt(fan_in(layer.weight))
        w = layer.weight.detach().double()
        assert w.abs().max().item() <= bound
        if layer.bias is not None:
            assert layer.bias.abs().max().item() <= bound
            assert torch.count_nonzero(layer.bias) > 0
        if w.numel() >= BIG:
            assert abs(w.std().item() / (bound / math.sqrt(3)) - 1) <= 0.05
            checked += 1
    assert checked >= 2
    for mod_name, module in model.named_modules():
        if isinstance(module, (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
            assert bool((module.weight == 1).all()) and bool((module.bias == 0).all()), mod_name
    gammas = [p for n, p in model.named_parameters() if n.endswith("gamma")]
    assert all(bool((g == 1e-6).all()) for g in gammas)
    if "ConvNeXt" in config["model_name"]:
        assert gammas


def test_depthwise_fan_in_is_the_kernel_area():
    """flax's (7, 7, 1, C) depthwise kernel has fan_in 49; so does the
    port's (C, 1, 7, 7) weight."""
    model = build_model(atto_config(), device="cpu")
    dw = model.convnext_backbone.stages[0].blocks[0].conv_dw.weight
    assert dw.shape[1:] == (1, 7, 7) and fan_in(dw) == 49


def test_maxvit_rel_pos_tables_and_norms(monkeypatch):
    """A cut MaxViT (one block a stage, 32 / 64 wide) at 224: window 7, the
    uncut tables' shape; 1,014 table entries."""
    monkeypatch.setitem(port_maxvit.MAXVIT_CONFIGS, "maxvit_tiny",
                        {"depths": (1, 1), "dims": (32, 64), "stem_width": 32})
    config = normalize_config({
        "model_name": "MaxViT", "model_kind": "maxvit_tiny_rw_224.sw_in1k",
        "train_data_version": "v12", "fc1_neurons": 16, "fc2_neurons": 8, "dropout": 0.1})
    model = build_model(config, device="cpu")
    tables = torch.cat([p.detach().reshape(-1) for n, p in model.named_parameters()
                        if n.endswith("relative_position_bias_table")])
    assert abs(tables.std().item() / 0.02 - 1) <= 0.10
    flax = build_model({**config, "init_scheme": "flax"}, device="cpu")
    again = torch.cat([p.detach().reshape(-1) for n, p in flax.named_parameters()
                       if n.endswith("relative_position_bias_table")])
    torch.testing.assert_close(again, tables, rtol=0, atol=0)  # not redrawn


def test_flax_scheme_is_seeded_and_reaches_the_mixer():
    config = {**atto_config(kind="inceptionnext_atto"), "init_scheme": "flax"}
    a, b, c = (build_model(config, device="cpu", seed=s).state_dict() for s in (5, 5, 6))
    key = "convnext_backbone.stem.0.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    mixer = "convnext_backbone.stages.2.blocks.0.mixer."
    for conv in ("dw_square", "dw_band_w", "dw_band_h"):
        assert torch.count_nonzero(a[mixer + conv + ".bias"]) == 0


def test_unknown_scheme_raises_the_jax_error():
    config = {**UM_NN, "train_data_version": "v12", "init_scheme": "he"}
    with pytest.raises(ValueError) as theirs:
        init_model(config, rng=0)
    with pytest.raises(ValueError) as ours:
        build_model(config, device="cpu")
    assert str(ours.value) == str(theirs.value)
