"""The port's MaxViT / mm_MaxViT and a MaxViT fusion branch against the JAX
package (CPU).

The JAX package's MaxViT tests cut the spec to depths (1, 1), dims
(32, 64), stem 32 at native size 64 (window 2); both packages' spec table
is patched the same way here (tests/test_maxvit_parity.py:24-47).  One
case keeps the full widths (64/128/256/512, stem 64, window 7, 224 input)
with depths (1, 1, 1, 1).  Flax parameters get seeded noise, BatchNorm
statistics are redrawn and the bias tables drawn at std 0.5, so a wrong
mapping or index shows.  Tolerances, each with its reason:

* partitions and the bias index: exact (reshapes and integer math);
* ``resize_bilinear``: atol 1e-6 (float32 interpolation weights);
* f32 logits rtol 1e-4 / atol 1e-5 (summation order);
* bf16 scores within 0.01 of the JAX package's bf16 (two bf16 models that
  round in different places: serving noise);
* train-step losses rtol 1e-4, BatchNorm statistics 1e-6 (float32 through
  convs, AdamW and the BatchNorm update, in another operation order);
* bias-table resampling: the JAX package's function bit for bit, and a
  brute-force bilinear oracle at rtol 1e-5 / atol 1e-6.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from btsbot_tpu import normalize_config, torch_state_dict_to_variables
from btsbot_tpu.engine.state import create_train_state as jax_create_train_state
from btsbot_tpu.engine.state import make_optimizer as jax_make_optimizer
from btsbot_tpu.engine.steps import make_train_step as jax_make_train_step
from btsbot_tpu.interop import maxvit_convert as jax_convert
from btsbot_tpu.interop.export import save_torch_checkpoint, variables_to_torch_state_dict
from btsbot_tpu.models import maxvit as jax_maxvit
from btsbot_tpu.models.factory import build_model as jax_build_model
from btsbot_tpu.models.factory import example_inputs as jax_example_inputs
from btsbot_tpu.models.fusion import load_fusion_branches as jax_load_fusion_branches
from btsbot_tpu.ops.resize import resize_bilinear as jax_resize
from btsbot_tpu_torch.engine.checkpoint import load_model_checkpoint
from btsbot_tpu_torch.engine.state import create_train_state
from btsbot_tpu_torch.engine.steps import make_train_step
from btsbot_tpu_torch.interop import hf, maxvit_convert
from btsbot_tpu_torch.interop.weights import state_dict_from_jax
from btsbot_tpu_torch.models import maxvit
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.models.fusion import load_fusion_branches
from btsbot_tpu_torch.ops.resize import resize_bilinear
from test_torch_families import META_COLS, UM_NN, _perturb, _redraw_stats
from test_torch_families_train import _batches, _cfg, _no_dropout

TINY_SPEC = {"depths": (1, 1), "dims": (32, 64), "stem_width": 32}
FULL_WIDTH_SPEC = {"depths": (1, 1, 1, 1), "dims": (64, 128, 256, 512), "stem_width": 64}
_META = {"metadata_cols": META_COLS, "meta_fc1_neurons": 16, "meta_fc2_neurons": 16,
         "meta_dropout": 0.25}
_COMB = {"comb_fc1_neurons": 8, "comb_fc2_neurons": 8, "comb_dropout": 0.2}
MAXVIT = {"model_name": "MaxViT", "model_kind": "maxvit_tiny_rw_64.test",
          "fc1_neurons": 16, "fc2_neurons": 8, "dropout": 0.3, "metadata_cols": META_COLS}
MM_MAXVIT = {"model_name": "mm_MaxViT", "model_kind": "maxvit_tiny_rw_64.test",
             "train_data_version": "v12", **_META, **_COMB}
FUSION_MAXVIT = {"model_name": "frozen_fusion", "metadata_cols": META_COLS,
                 "image_model_config": MAXVIT, "meta_model_config": UM_NN, **_COMB}
FULL_WIDTH = {**MM_MAXVIT, "model_kind": "maxvit_tiny_rw_224.sw_in1k",
              "meta_fc1_neurons": 128, "meta_fc2_neurons": 128,
              "comb_fc1_neurons": 64, "comb_fc2_neurons": 32}
FAMILIES = {"MaxViT": MAXVIT, "mm_MaxViT": MM_MAXVIT, "fusion_MaxViT": FUSION_MAXVIT}


@pytest.fixture(autouse=True)
def tiny_maxvit(monkeypatch):
    for module in (jax_maxvit, maxvit):
        monkeypatch.setitem(module.MAXVIT_CONFIGS, "maxvit_tiny", TINY_SPEC)


def _full_width(monkeypatch):
    for module in (jax_maxvit, maxvit):
        monkeypatch.setitem(module.MAXVIT_CONFIGS, "maxvit_tiny", FULL_WIDTH_SPEC)


def _redraw_tables(tree, rng):
    return {k: (_redraw_tables(v, rng) if isinstance(v, dict)
                else (rng.normal(size=v.shape) * 0.5).astype(np.float32)
                if k == "rel_pos_table" else v)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _variables(key, spec, seed):
    del spec  # part of the cache key: the patched spec decides the tree
    config = normalize_config(json.loads(key))
    model = jax_build_model(config)
    img, meta = jax_example_inputs(config)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree_util.tree_map(
        np.asarray, init(jax.random.key(seed), image_input=img, metadata_input=meta))
    rng = np.random.default_rng(seed)
    return {"params": _redraw_tables(_perturb(variables["params"], rng), rng),
            "batch_stats": _redraw_stats(variables["batch_stats"], rng)}


def flax_variables(config, seed=0):
    """Flax variables for ``config`` under the current spec, randomised."""
    spec = json.dumps(jax_maxvit.MAXVIT_CONFIGS["maxvit_tiny"], sort_keys=True)
    return _variables(json.dumps(dict(config), sort_keys=True), spec, seed)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 63, 63, 3)).astype(np.float32),
            rng.normal(size=(n, len(META_COLS))).astype(np.float32))


def _flax_logits(config, variables, img, meta, dtype=jnp.float32):
    config = normalize_config(config)
    model = jax_build_model(config, dtype=dtype)
    apply = jax.jit(functools.partial(model.apply, train=False))
    return np.asarray(apply(
        variables, image_input=jnp.asarray(img, dtype),
        metadata_input=jnp.asarray(meta, dtype) if config.need_metadata else None,
    ), np.float32).reshape(-1)


def _port_model(config, sd, dtype=torch.float32):
    model = build_model(config, dtype=dtype, device="cpu")
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                          strict=True)
    return model


def _port_logits(model, img, meta, dtype=torch.float32):
    with torch.no_grad():
        return model(torch.from_numpy(img).to(dtype),
                     torch.from_numpy(meta).to(dtype)).float().reshape(-1).numpy()


# ------------------------- numpy-level helpers -------------------------

@pytest.mark.parametrize("win", [1, 2, 3, 5, 7])
def test_rel_position_index_equals_jax(win):
    got, want = maxvit._rel_position_index(win), jax_maxvit._rel_position_index(win)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,p", [((2, 8, 8, 3), 2), ((1, 14, 14, 5), 7),
                                     ((3, 6, 6, 4), 3)])
def test_partitions_equal_jax(shape, p):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    t = torch.from_numpy(x)
    _, h, w, _ = shape
    for part, rev, jpart, jrev in (
            (maxvit.window_partition, maxvit.window_reverse,
             jax_maxvit.window_partition, jax_maxvit.window_reverse),
            (maxvit.grid_partition, maxvit.grid_reverse,
             jax_maxvit.grid_partition, jax_maxvit.grid_reverse)):
        got = part(t, p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jpart(jnp.asarray(x), p)))
        back = rev(got, p, h, w)
        np.testing.assert_array_equal(back.numpy(), np.asarray(
            jrev(jpart(jnp.asarray(x), p), p, h, w)))
        np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("size", [224, 64, 63, 96])
def test_resize_bilinear_matches_jax(size):
    x = np.random.default_rng(size).normal(size=(2, 63, 63, 3)).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(x), size)
    assert tuple(got.shape) == (2, size, size, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_resize(jnp.asarray(x), size)),
                               rtol=0, atol=1e-6)


def test_model_kind_helpers_match_jax():
    for kind in ("maxvit_tiny_rw_256", "maxvit_tiny_rw_256.sw_in1k", "maxvit_tiny",
                 "convnext_pico.d1_in1k", "maxvit_tiny_rw_160.sw_in1k"):
        assert maxvit.get_model_image_size(kind) == jax_maxvit.get_model_image_size(kind)
    assert maxvit.maxvit_window("maxvit_tiny_rw_224.sw_in1k") == 7
    for kind, res in (("maxvit_tiny_rw_224.sw_in1k", 160), ("maxvit_tiny_rw_64.test", 96),
                      ("maxvit_tiny_rw_224", 160), ("convnext_pico.d1_in1k", 160),
                      ("maxvit_tiny", 160)):
        try:
            want = jax_convert.retarget_model_kind(kind, res)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:30]):
                maxvit_convert.retarget_model_kind(kind, res)
            continue
        assert maxvit_convert.retarget_model_kind(kind, res) == want


def test_resize_rel_pos_table():
    """Identity at the same window, constants kept, align-corners corners,
    every cell against a brute-force bilinear oracle, and the JAX function
    bit for bit."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=((2 * 7 - 1) ** 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(maxvit_convert.resize_rel_pos_table(table, 7), table)
    const = np.full((13 * 13, 3), 1.25, np.float32)
    out = maxvit_convert.resize_rel_pos_table(const, 5)
    assert out.shape == (81, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, 1.25, rtol=1e-6)
    src = table.reshape(13, 13, 4)
    for target in (5, 4, 9, 1):
        d = 2 * target - 1
        got = maxvit_convert.resize_rel_pos_table(table, target)
        np.testing.assert_array_equal(got, jax_convert.resize_rel_pos_table(table, target))
        got = got.reshape(d, d, 4)
        pos = np.linspace(0.0, 12.0, d) if d > 1 else np.zeros(1)
        i0 = np.clip(np.floor(pos).astype(int), 0, 12)
        i1 = np.clip(i0 + 1, 0, 12)
        f = pos - i0
        want = np.zeros((d, d, 4))
        for r in range(d):
            for c in range(d):
                want[r, c] = (src[i0[r], i0[c]] * (1 - f[r]) * (1 - f[c])
                              + src[i1[r], i0[c]] * f[r] * (1 - f[c])
                              + src[i0[r], i1[c]] * (1 - f[r]) * f[c]
                              + src[i1[r], i1[c]] * f[r] * f[c])
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-5, atol=1e-6)
    dst = maxvit_convert.resize_rel_pos_table(table, 5).reshape(9, 9, 4)
    for corner in ((0, 0), (-1, -1), (0, -1)):
        np.testing.assert_allclose(dst[corner], src[corner], rtol=1e-5)


def test_shortcut_alias_renames_expand_to_conv():
    sd = {"maxvit.stages.0.blocks.0.conv.shortcut.expand.weight": torch.ones(1),
          "maxvit.stem.conv1.weight": torch.zeros(1)}
    got = maxvit_convert.adapt_state_dict({"model_name": "MaxViT",
                                           "model_kind": "maxvit_tiny_rw_64"}, sd)
    assert sorted(got) == ["maxvit.stages.0.blocks.0.conv.shortcut.conv.weight",
                           "maxvit.stem.conv1.weight"]
    assert maxvit_convert.adapt_state_dict({"model_name": "um_nn"}, sd) == sd


# ------------------------------ the models ------------------------------

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
@pytest.mark.parametrize("bridge", ["state_dict_from_jax", "exporter"])
def test_f32_logits_match_flax(family, bridge):
    """On the port's bridge and on the JAX exporter's dict, loaded strict."""
    config = normalize_config(FAMILIES[family])
    variables = flax_variables(config)
    sd = (state_dict_from_jax if bridge == "state_dict_from_jax"
          else variables_to_torch_state_dict)(config, variables)
    img, meta = _inputs(3, seed=3)
    want = _flax_logits(config, variables, img, meta)
    got = _port_logits(_port_model(config, sd), img, meta)
    assert np.std(want) > 1e-3  # the check must see the inputs
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", ["MaxViT", "mm_MaxViT"])
def test_bf16_scores_close_to_jax_bf16(family):
    config = normalize_config(FAMILIES[family])
    variables = flax_variables(config)
    img, meta = _inputs(4, seed=5)
    want = _flax_logits(config, variables, img, meta, jnp.bfloat16)
    model = _port_model(config, state_dict_from_jax(config, variables), torch.bfloat16)
    got = _port_logits(model, img, meta, torch.bfloat16)
    d = np.abs(1 / (1 + np.exp(-got)) - 1 / (1 + np.exp(-want))).max()
    assert d < 0.01


def test_full_width_mm_maxvit_at_224_matches_flax(monkeypatch):
    """Widths 64/128/256/512, stem 64, window 7 over maps 56/28/14/7, the
    63 → 224 resize; depths cut to one block a stage; one alert."""
    _full_width(monkeypatch)
    config = normalize_config(FULL_WIDTH)
    variables = flax_variables(config)
    model = _port_model(config, state_dict_from_jax(config, variables))
    assert model.image_size == 224
    assert model.maxvit_backbone.stages[3].blocks[0].attn_grid.window == 7
    img, meta = _inputs(1, seed=11)
    want = _flax_logits(config, variables, img, meta)
    np.testing.assert_allclose(_port_logits(model, img, meta), want, rtol=1e-4, atol=1e-5)


def test_three_mm_maxvit_train_steps_match_the_jax_step():
    """Train-mode BatchNorm2d (flax rule), the resize and the attention
    under autograd; dropout and augmentation off.  After the first step
    (the same weights in both packages) every BatchNorm statistic is held
    to flax at 1e-6, and the metadata branch's (raw inputs) after every
    step, as tests/test_torch_train.py does.  The backbone's statistics
    after steps 2 and 3 see weights each package has updated, so they are
    held at the loss's tolerance (rtol 1e-4 / atol 1e-5); an MBConv's
    ``norm1.running_mean`` only after the first step: its batch mean is
    conv1_1x1 · pre_norm.bias, and pre_norm.bias has an analytically zero
    gradient (a train-mode BatchNorm follows it through the bias-free
    conv), so both packages' AdamW (eps 1e-8) turn rounding noise into
    updates of up to a third of the LR, of either sign."""
    config = _cfg(_no_dropout(MM_MAXVIT))
    variables = flax_variables(config)
    jax_model = jax_build_model(config)
    tx = jax_make_optimizer(config, steps_per_epoch=3)
    jstate = jax_create_train_state(config, jax.tree_util.tree_map(np.asarray, variables),
                                    tx, seed=0)
    jstep = jax_make_train_step(jax_model, tx, config)
    model = _port_model(config, state_dict_from_jax(config, variables))
    state = create_train_state(config, model, steps_per_epoch=3, seed=0)
    step = make_train_step(config)
    for i, (images, meta, labels) in enumerate(_batches(3, 8, seed=1)):
        jstate, jm = jstep(jstate, images, meta, labels, 1.5)
        m = step(state, torch.from_numpy(images), torch.from_numpy(meta),
                 torch.from_numpy(labels), 1.5)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
        want = variables_to_torch_state_dict(config, {"params": jstate.params,
                                                      "batch_stats": jstate.batch_stats})
        got = model.state_dict()
        stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 2 * 8  # stem, 2 × 3 MBConv norms, metadata branch
        for k in stats:
            if i == 0 or k.startswith("metadata_branch."):
                tol = dict(rtol=1e-6, atol=1e-6)
            elif k.endswith(".conv.norm1.running_mean"):
                continue
            else:
                tol = dict(rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **tol,
                                       err_msg=f"step {i}: {k}")
    pre_norm_bias = model.maxvit_backbone.stages[0].blocks[0].conv.pre_norm.bias
    assert pre_norm_bias.grad.abs().max().item() < 1e-7
    assert int(got["maxvit_backbone.stem.norm1.num_batches_tracked"]) == 3


def _write_run_dir(path, config, sd):
    os.makedirs(path, exist_ok=True)
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
               os.path.join(path, "best_model.pth"))
    with open(os.path.join(path, "report.json"), "w") as f:
        json.dump({"train_config": dict(config)}, f)
    return str(path)


def test_load_fusion_branches_from_a_maxvit_run_matches_jax(tmp_path):
    """Reference-layout run directories (report.json + best_model.pth): the
    MaxViT branch comes with its BatchNorm statistics, its head dropped."""
    dirs = {}
    for base in (MAXVIT, UM_NN):
        cfg = normalize_config(base)
        dirs[base["model_name"]] = _write_run_dir(
            tmp_path / base["model_name"], cfg,
            variables_to_torch_state_dict(cfg, flax_variables(cfg, seed=4)))
    config = normalize_config({"model_name": "frozen_fusion", "metadata_cols": META_COLS,
                               "image_model_dir": dirs["MaxViT"],
                               "meta_model_dir": dirs["um_nn"], **_COMB})
    fusion = normalize_config({**FUSION_MAXVIT, "image_model_dir": dirs["MaxViT"],
                               "meta_model_dir": dirs["um_nn"]})
    variables = flax_variables(fusion)
    want = variables_to_torch_state_dict(config, jax_load_fusion_branches(
        config, jax.tree_util.tree_map(np.asarray, variables)))
    model = _port_model(config, state_dict_from_jax(config, variables))
    got = load_fusion_branches(config, model.state_dict())
    assert sorted(got) == sorted(want)
    assert any(k.startswith("image_branch.maxvit.") and k.endswith("running_var") for k in got)
    for k in want:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_a_64_trained_state_dict_retargeted_to_96_matches_jax(tmp_path):
    """A window-2 checkpoint loaded into a window-3 model: the bias tables
    resampled (25 rows), as the JAX converter does on conversion; through
    ``retarget_state_dict`` and through ``load_model_checkpoint``."""
    config64 = normalize_config(MM_MAXVIT)
    sd = variables_to_torch_state_dict(config64, flax_variables(config64, seed=7))
    config96 = normalize_config({**MM_MAXVIT, "model_kind": "maxvit_tiny_rw_96.test"})
    jax_vars = torch_state_dict_to_variables(config96, sd)
    img, meta = _inputs(2, seed=9)
    want = _flax_logits(config96, jax_vars, img, meta)
    retargeted = maxvit_convert.retarget_state_dict(sd, "maxvit_tiny_rw_96.test")
    table = "maxvit_backbone.stages.0.blocks.0.attn_grid.attn.rel_pos.relative_position_bias_table"
    assert sd[table].shape == (9, 1) and retargeted[table].shape == (25, 1)
    np.testing.assert_allclose(_port_logits(_port_model(config96, retargeted), img, meta),
                               want, rtol=1e-4, atol=1e-5)
    run = _write_run_dir(tmp_path / "run64", config64, sd)
    loaded = load_model_checkpoint(config96, run)
    assert loaded[table].shape == (25, 1)
    np.testing.assert_allclose(_port_logits(_port_model(config96, loaded), img, meta),
                               want, rtol=1e-4, atol=1e-5)


def test_load_hf_model_maxvit_from_an_offline_snapshot(tmp_path, monkeypatch):
    def no_download(*args, **kwargs):
        raise AssertionError("download attempted")
    monkeypatch.setattr(hf, "download_HF_model", no_download)
    config = normalize_config(MM_MAXVIT)
    variables = flax_variables(config)
    snap = hf.get_local_model_dir("maxvit", True, "imagenet", str(tmp_path))
    assert snap.endswith("BTSbot-maxvit-tiny-in1k-metadata")
    os.makedirs(snap)
    save_torch_checkpoint(os.path.join(snap, "pytorch_model.bin"), config, variables)
    with open(os.path.join(snap, "train_config.json"), "w") as f:
        json.dump(dict(config), f)
    model, got_config = hf.load_HF_model("maxvit", True, "imagenet",
                                         models_root=str(tmp_path), device="cpu")
    assert got_config["model_name"] == "mm_MaxViT" and not model.training
    img, meta = _inputs(3, seed=13)
    np.testing.assert_allclose(_port_logits(model, img, meta),
                               _flax_logits(config, variables, img, meta),
                               rtol=1e-4, atol=1e-5)
