"""The port's backbone initialisation and manifests against the JAX
package's (CPU), after tests/test_pretrained.py.

A backbone-only timm / zoobot state dict seeds the same entries in both
packages: the JAX package's ``init_from_backbone_checkpoint`` variables,
read back through the weight bridge (``interop.weights.state_dict_from_jax``),
equal the port's seeded model state dict exactly on every backbone entry
(and the image-only ConvNeXt's head norm).  The rest of the contract:
drifted checkpoints refuse to half-load, non-backbone families reject, the
shipped manifests are the JAX package's files and the generator's output,
and ``run_training`` starts from a ``backbone_checkpoint``.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax

from btsbot_tpu.models.factory import build_model as jax_build_model
from btsbot_tpu.models.factory import example_inputs as jax_example_inputs
from btsbot_tpu.interop import manifests as jax_manifests
from btsbot_tpu.interop.pretrained import init_from_backbone_checkpoint as jax_init_backbone
from btsbot_tpu.models import maxvit as jax_maxvit
from btsbot_tpu_torch.core.config import normalize_config
from btsbot_tpu_torch.data.dataset import AlertDataset
from btsbot_tpu_torch.engine.train import run_training
from btsbot_tpu_torch.interop import manifests
from btsbot_tpu_torch.interop.pretrained import (
    UnconsumedKeysError,
    backbone_state_dict,
    init_from_backbone_checkpoint,
    maybe_init_pretrained,
)
from btsbot_tpu_torch.interop.weights import state_dict_from_jax
from btsbot_tpu_torch.models import maxvit as port_maxvit
from btsbot_tpu_torch.models.factory import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META_COLS = [f"m{i}" for i in range(25)]
ATTO = "convnext_atto.d2_in1k"
_META = {"metadata_cols": META_COLS, "meta_fc1_neurons": 16, "meta_fc2_neurons": 16,
         "meta_dropout": 0.1}
_COMB = {"comb_fc1_neurons": 8, "comb_fc2_neurons": 8, "comb_dropout": 0.1}
MM_CONVNEXT = {"model_name": "mm_ConvNeXt", "model_kind": ATTO, "train_data_version": "v12",
               **_META, **_COMB}
CONVNEXT = {"model_name": "ConvNeXt", "model_kind": ATTO, "train_data_version": "v12",
            "metadata_cols": META_COLS, "fc1_neurons": 16, "fc2_neurons": 8, "dropout": 0.1}
BODY = ("stem.", "stages.")


def _timm_checkpoint(model_kind=ATTO, num_classes=1000, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=shape).astype(np.float32) for k, shape in
            manifests.expected_checkpoint_manifest(model_kind, num_classes).items()}


def _port_seeded(config, sd):
    model = build_model(config, device="cpu", seed=1)
    return init_from_backbone_checkpoint(config, model, sd).state_dict()


@functools.lru_cache(maxsize=None)
def _jax_fresh(key):
    config = normalize_config(json.loads(key))
    model = jax_build_model(config)
    img, meta = jax_example_inputs(config)
    return jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(0), image_input=img, metadata_input=meta)


def _jax_seeded(config, sd):
    """The JAX package's fresh variables (its init, jitted) seeded from
    ``sd``, as a reference-named state dict."""
    config = normalize_config(config)
    variables = _jax_fresh(json.dumps(dict(config), sort_keys=True))
    return state_dict_from_jax(config, jax_init_backbone(config, variables, sd))


def _assert_backbone_equal(ours, theirs, prefix, extra=()):
    keys = [k for k in theirs if k.startswith(tuple(prefix + b for b in BODY))]
    keys += [k for k in extra]
    assert len(keys) > 20
    for k in keys:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]), err_msg=k)


def test_backbone_seeds_mm_convnext_as_jax():
    sd = _timm_checkpoint()
    fresh = build_model(MM_CONVNEXT, device="cpu", seed=1).state_dict()
    ours, theirs = _port_seeded(MM_CONVNEXT, sd), _jax_seeded(MM_CONVNEXT, sd)
    _assert_backbone_equal(ours, theirs, "convnext_backbone.")
    np.testing.assert_array_equal(ours["convnext_backbone.stem.0.weight"].numpy(),
                                  sd["stem.0.weight"])
    # the heads keep the fresh init; a non-LS mm_ConvNeXt has no head norm
    for k in ("combined_head.0.weight", "metadata_branch.1.weight"):
        assert torch.equal(ours[k], fresh[k])
    assert not any(k.startswith("convnext_backbone.head.") for k in ours)


def test_image_only_convnext_keeps_the_pretrained_head_norm():
    sd = _timm_checkpoint(seed=1)
    ours, theirs = _port_seeded(CONVNEXT, sd), _jax_seeded(CONVNEXT, sd)
    _assert_backbone_equal(ours, theirs, "convnext.",
                           extra=("convnext.head.1.weight", "convnext.head.1.bias"))
    np.testing.assert_array_equal(ours["convnext.head.1.weight"].numpy(),
                                  sd["head.norm.weight"])


def test_ls_mm_convnext_keeps_the_head_norm():
    config = {**MM_CONVNEXT, "train_data_version": "v10_LS"}
    sd = _timm_checkpoint(seed=8)
    ours, theirs = _port_seeded(config, sd), _jax_seeded(config, sd)
    _assert_backbone_equal(ours, theirs, "convnext_backbone.",
                           extra=("convnext_backbone.head.1.bias",))


def test_zoobot_style_backbone_only_checkpoint():
    """galaxyzoo encoders ship without a classifier and may carry wrapper
    prefixes, nested in any order."""
    sd = {k: v for k, v in _timm_checkpoint(seed=2).items() if not k.startswith("head.")}
    for wrap in ("encoder.", "model.encoder.", "module.timm_model."):
        wrapped = {wrap + k: v for k, v in sd.items()}
        fragment = backbone_state_dict(MM_CONVNEXT, wrapped)
        assert set(fragment) == {"convnext_backbone." + k for k in sd}
    ours, theirs = _port_seeded(MM_CONVNEXT, {"encoder." + k: v for k, v in sd.items()}), \
        _jax_seeded(MM_CONVNEXT, {"encoder." + k: v for k, v in sd.items()})
    _assert_backbone_equal(ours, theirs, "convnext_backbone.")


def test_npz_and_torch_files_round_trip(tmp_path):
    sd = _timm_checkpoint(seed=5)
    np.savez(tmp_path / "backbone.npz", **sd)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "backbone.pth")  # lightning-style wrapper
    theirs = _jax_seeded(MM_CONVNEXT, str(tmp_path / "backbone.npz"))
    for name in ("backbone.npz", "backbone.pth"):
        ours = _port_seeded(MM_CONVNEXT, str(tmp_path / name))
        _assert_backbone_equal(ours, theirs, "convnext_backbone.")


def test_drifted_checkpoint_refuses_to_half_load():
    sd = _timm_checkpoint(seed=3)
    sd["stages.0.blocks.0.novel_rw_extra.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="novel_rw_extra"):
        backbone_state_dict(MM_CONVNEXT, sd)
    # validate=False skips the manifest report; the accounting still refuses
    with pytest.raises(UnconsumedKeysError, match="novel_rw_extra"):
        backbone_state_dict(MM_CONVNEXT, sd, validate=False)
    sd2 = _timm_checkpoint(seed=3)
    del sd2["stem.0.weight"]
    with pytest.raises(ValueError, match="stem.0.weight"):
        backbone_state_dict(MM_CONVNEXT, sd2)
    with pytest.raises(KeyError, match="stem.0.weight"):
        backbone_state_dict(MM_CONVNEXT, sd2, validate=False)
    sd3 = _timm_checkpoint(seed=3)
    sd3["stages.1.blocks.0.mlp.fc1.weight"] = np.zeros((7, 7), np.float32)
    with pytest.raises(ValueError, match="shape mismatches"):
        backbone_state_dict(MM_CONVNEXT, sd3)
    model = build_model(MM_CONVNEXT, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="do not match|does not match"):
        init_from_backbone_checkpoint(MM_CONVNEXT, model, sd3, validate=False)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())


def test_non_backbone_families_reject_checkpoints():
    config = {"model_name": "um_nn", "train_data_version": "v12", **_META}
    with pytest.raises(ValueError, match="no pretrained-capable backbone"):
        backbone_state_dict(config, _timm_checkpoint())


def test_maxvit_backbone_seed_includes_running_statistics(monkeypatch):
    """A cut MaxViT (one block a stage, 32 / 64 wide, at 64 px: window 2)
    in both packages; the shortcut's timm name ``shortcut.expand`` too."""
    tiny = {"depths": (1, 1), "dims": (32, 64), "stem_width": 32}
    monkeypatch.setitem(jax_maxvit.MAXVIT_CONFIGS, "maxvit_tiny", tiny)
    monkeypatch.setitem(port_maxvit.MAXVIT_CONFIGS, "maxvit_tiny", tiny)
    kind = "maxvit_tiny_rw_64.test"
    config = {"model_name": "mm_MaxViT", "model_kind": kind, "train_data_version": "v12",
              **_META, **_COMB}
    man = manifests.expected_checkpoint_manifest(kind, None)
    assert man == jax_manifests.expected_checkpoint_manifest(kind, None)
    rng = np.random.default_rng(4)
    sd = {k: rng.normal(size=shape).astype(np.float32) for k, shape in man.items()}
    ours, theirs = _port_seeded(config, sd), _jax_seeded(config, sd)
    _assert_backbone_equal(ours, theirs, "maxvit_backbone.")
    np.testing.assert_array_equal(ours["maxvit_backbone.stem.norm1.running_mean"].numpy(),
                                  sd["stem.norm1.running_mean"])
    expand = {k.replace(".shortcut.conv.", ".shortcut.expand."): v for k, v in sd.items()}
    assert expand.keys() != sd.keys()
    fragment = backbone_state_dict(config, expand, validate=False)
    assert fragment.keys() == backbone_state_dict(config, sd).keys()


def test_shipped_manifests_are_the_jax_files_and_the_generator():
    for kind in ("convnext_pico.d1_in1k", "maxvit_tiny_rw_224.sw_in1k"):
        ours = os.path.join(REPO, "btsbot_tpu_torch", "interop", "manifests", f"{kind}.json")
        theirs = os.path.join(REPO, "btsbot_tpu", "interop", "manifests", f"{kind}.json")
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
        assert manifests.load_manifest(kind) == manifests.expected_checkpoint_manifest(kind)
    sd = _timm_checkpoint("convnext_pico.d1_in1k", seed=6)
    sd["extra.weight"] = np.zeros(2)
    del sd["stem.1.bias"]
    ours = manifests.validate_state_dict(sd, "convnext_pico.d1_in1k")
    assert ours == jax_manifests.validate_state_dict(sd, "convnext_pico.d1_in1k")
    assert ours["missing"] == ["stem.1.bias"] and not ours["ok"]
    with pytest.raises(ValueError, match="missing: stem.1.bias"):
        manifests.check_state_dict(sd, "convnext_pico.d1_in1k")


def test_pretrained_without_timm_or_checkpoint_keeps_the_fresh_init():
    logs = []
    model = build_model(MM_CONVNEXT, device="cpu", seed=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    maybe_init_pretrained(normalize_config({**MM_CONVNEXT, "pretrained": True}), model,
                          log=logs.append)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())
    assert "timm is unavailable" in logs[0]
    maybe_init_pretrained({**MM_CONVNEXT, "model_kind": "inceptionnext_atto"}, model,
                          log=logs.append)
    assert "inceptionnext variant" in logs[1]


def test_run_training_starts_from_a_backbone_checkpoint(tmp_path):
    """learning_rate 0: after an epoch the backbone is still the checkpoint's,
    which shows the run started from it."""
    sd = _timm_checkpoint(seed=6)
    path = tmp_path / "backbone.npz"
    np.savez(path, **sd)
    config = normalize_config({**MM_CONVNEXT, "backbone_checkpoint": str(path),
                               "learning_rate": 0.0, "beta_1": 0.9, "beta_2": 0.999,
                               "batch_size": 16, "epochs": 1, "warmup_epochs": 0,
                               "patience": 2, "random_seed": 1})
    rng = np.random.default_rng(7)
    ds = AlertDataset(labels=(rng.random(16) < 0.5).astype(np.float32),
                      images=rng.normal(0, 0.1, (16, 63, 63, 3)).astype(np.float32),
                      metadata=rng.normal(0, 1, (16, 25)).astype(np.float32))
    logs = []
    result = run_training(config, run_name="pre", out_root=str(tmp_path), train_ds=ds,
                          val_ds=ds, log=logs.append, device="cpu")
    state = result["model"].state_dict()
    for k, v in sd.items():
        if k.startswith(BODY):
            np.testing.assert_array_equal(state["convnext_backbone." + k].numpy(), v)
    assert any("backbone from" in line for line in logs)
    with open(os.path.join(result["model_dir"], "report.json")) as f:
        assert json.load(f)["train_config"]["backbone_checkpoint"] == str(path)
