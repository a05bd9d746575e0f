"""The port's mm_ConvNeXt against the flax model on the same weights (CPU).

Weights cross through ``btsbot_tpu_torch.interop.weights.state_dict_from_jax``.
Every parameter leaf is perturbed with seeded noise first, and γ and the
BatchNorm statistics are redrawn: the flax init draws γ = 1e-6 (every block
an identity) and zero biases, which would hide errors in the MLP and in the
weight mapping.  Tolerances: f32 logits rtol 1e-4 / atol 1e-5 (summation
order across 12 blocks).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from btsbot_tpu import normalize_config
from btsbot_tpu.models.factory import build_model as jax_build_model
from btsbot_tpu_torch.interop.weights import state_dict_from_jax
from btsbot_tpu_torch.models.factory import build_model

META_COLS = [f"m{i}" for i in range(25)]


def atto_config(train_data_version="v12", kind="convnext_atto.test"):
    return normalize_config({
        "model_name": "mm_ConvNeXt", "model_kind": kind,
        "train_data_version": train_data_version, "metadata_cols": META_COLS,
        "meta_fc1_neurons": 16, "meta_fc2_neurons": 16, "meta_dropout": 0.2,
        "comb_fc1_neurons": 8, "comb_fc2_neurons": 8, "comb_dropout": 0.2,
    })


def pico_config():
    return normalize_config({
        **atto_config(), "model_kind": "convnext_pico.d1_in1k",
        "meta_fc1_neurons": 128, "meta_fc2_neurons": 128,
        "comb_fc1_neurons": 256, "comb_fc2_neurons": 32,
    })


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


@functools.lru_cache(maxsize=None)
def _flax_variables(config_items, seed):
    config = normalize_config(dict(config_items))
    model = jax_build_model(config)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = init(jax.random.key(seed), image_input=jnp.zeros((1, 63, 63, 3)),
                     metadata_input=jnp.zeros((1, len(config["metadata_cols"]))))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(seed)
    bn = variables["batch_stats"]["metadata_branch"]["bn"]
    return {
        "params": _perturb(variables["params"], rng),
        "batch_stats": {"metadata_branch": {"bn": {
            "mean": rng.normal(size=bn["mean"].shape).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, size=bn["var"].shape).astype(np.float32),
        }}},
    }


def flax_variables(config, seed=0):
    """Flax variables for ``config`` with every leaf randomised (numpy)."""
    items = tuple((k, tuple(v) if isinstance(v, list) else v)
                  for k, v in sorted(config.items()))
    return _flax_variables(items, seed)


def port_model(config, variables, dtype=torch.float32):
    model = build_model(config, dtype=dtype, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           state_dict_from_jax(config, variables).items()}, strict=True)
    return model


def flax_logits(config, variables, img, meta):
    model = jax_build_model(config)
    apply = jax.jit(functools.partial(model.apply, train=False))
    return np.asarray(apply(variables, image_input=jnp.asarray(img),
                            metadata_input=jnp.asarray(meta))).reshape(-1)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 63, 63, 3)).astype(np.float32),
            rng.normal(size=(n, 25)).astype(np.float32))


@pytest.mark.parametrize("tdv", ["v12", "LS_v12"])
def test_state_dict_from_jax_matches_exporter(tdv):
    from btsbot_tpu.interop.export import variables_to_torch_state_dict

    config = atto_config(tdv)
    variables = flax_variables(config)
    got = state_dict_from_jax(config, variables)
    want = variables_to_torch_state_dict(config, variables)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = build_model(config, device="cpu")
    assert set(model.state_dict()) == set(got)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in got.items()}, strict=True)


@pytest.mark.parametrize("tdv", ["v12", "LS_v12"])
def test_mm_convnext_f32_logits_match_flax(tdv):
    config = atto_config(tdv)
    variables = flax_variables(config, seed=1)
    img, meta = _inputs(3, seed=2)
    want = flax_logits(config, variables, img, meta)
    with torch.no_grad():
        got = port_model(config, variables)(torch.from_numpy(img),
                                            torch.from_numpy(meta)).numpy()
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got.reshape(-1), want, rtol=1e-4, atol=1e-5)


def test_mm_convnext_pico_full_width_matches_flax():
    config = pico_config()
    variables = flax_variables(config, seed=3)
    img, meta = _inputs(2, seed=4)
    want = flax_logits(config, variables, img, meta)
    with torch.no_grad():
        got = port_model(config, variables)(torch.from_numpy(img),
                                            torch.from_numpy(meta)).numpy()
    np.testing.assert_allclose(got.reshape(-1), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tdv", ["v12", "LS_v12"])
def test_fast_mm_convnext_logits_matches_jax(tdv):
    from btsbot_tpu.ops.pallas_mlp import fast_mm_convnext_logits as jax_fast
    from btsbot_tpu_torch.ops.ln_mlp import fast_mm_convnext_logits, fused_ln_mlp

    config = atto_config(tdv)
    variables = flax_variables(config, seed=5)
    img, meta = _inputs(3, seed=6)
    want = np.asarray(jax_fast(variables, jnp.asarray(img), jnp.asarray(meta), config,
                               interpret=True))
    sd = state_dict_from_jax(config, variables)
    before = fused_ln_mlp.launches
    with torch.no_grad():
        got = fast_mm_convnext_logits(sd, torch.from_numpy(img), torch.from_numpy(meta),
                                      config).numpy()
        module = port_model(config, variables)(torch.from_numpy(img),
                                               torch.from_numpy(meta)).numpy()
    assert fused_ln_mlp.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, module.reshape(-1), rtol=1e-4, atol=1e-5)


def test_convnext_block_module_matches_flax_block():
    from btsbot_tpu.models.convnext import ConvNeXtBlock as FlaxBlock
    from btsbot_tpu_torch.models.convnext import ConvNeXtBlock

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 15, 15, 8)).astype(np.float32)
    flax_block = FlaxBlock(dim=8)
    params = _perturb(jax.tree_util.tree_map(
        np.asarray, flax_block.init(jax.random.key(0), jnp.asarray(x)))["params"], rng)
    want = np.asarray(flax_block.apply({"params": params}, jnp.asarray(x)))
    block = ConvNeXtBlock(8)
    p = params
    sd = {"conv_dw.weight": np.transpose(p["conv_dw"]["kernel"], (3, 2, 0, 1)),
          "conv_dw.bias": p["conv_dw"]["bias"],
          "norm.weight": p["norm"]["scale"], "norm.bias": p["norm"]["bias"],
          "mlp.fc1.weight": p["mlp_fc1"]["kernel"].T, "mlp.fc1.bias": p["mlp_fc1"]["bias"],
          "mlp.fc2.weight": p["mlp_fc2"]["kernel"].T, "mlp.fc2.bias": p["mlp_fc2"]["bias"],
          "gamma": p["gamma"]}
    block.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
        plain = block(torch.from_numpy(x), plain=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_follows_the_jax_dtype_rule(dtype):
    from btsbot_tpu.models.common import gelu_exact
    from btsbot_tpu_torch.models.common import gelu

    x = np.linspace(-6, 6, 401).astype(np.float32)
    want = np.asarray(gelu_exact(jnp.asarray(x, dtype)).astype(jnp.float32))
    got = gelu(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    tol = 1e-6 if dtype == "float32" else 8e-3  # one bf16 rounding apart
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_bf16_model_scores_close_to_f32():
    config = atto_config()
    variables = flax_variables(config, seed=8)
    img, meta = _inputs(4, seed=9)
    with torch.no_grad():
        z32 = port_model(config, variables)(torch.from_numpy(img), torch.from_numpy(meta))
        z16 = port_model(config, variables, torch.bfloat16)(
            torch.from_numpy(img).bfloat16(), torch.from_numpy(meta).bfloat16())
    d = (torch.sigmoid(z16.float()) - torch.sigmoid(z32)).abs().max().item()
    assert d < 0.01


@pytest.mark.parametrize("name", ["MaxViT", "mm_MaxViT"])
def test_unported_families_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model({**atto_config(), "model_name": name}, device="cpu")


def test_inceptionnext_kind_raises():
    with pytest.raises(NotImplementedError, match="InceptionMixer"):
        build_model(atto_config(kind="inceptionnext_atto"), device="cpu")


def test_build_model_is_seeded_and_inits_like_torch():
    a = build_model(atto_config(), device="cpu", seed=3).state_dict()
    b = build_model(atto_config(), device="cpu", seed=3).state_dict()
    c = build_model(atto_config(), device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["combined_head.0.weight"], c["combined_head.0.weight"])
    assert torch.all(a["convnext_backbone.stages.0.blocks.0.gamma"] == 1e-6)
