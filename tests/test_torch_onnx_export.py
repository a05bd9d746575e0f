"""The port's ONNX export against the JAX exporter, and every family's
artifact verified against the port's own forward.

* On weights carried over by ``interop.weights.state_dict_from_jax``, the
  port's .onnx bytes for um_nn, mm_cnn and mm_ConvNeXt (convnext_atto) equal
  the JAX exporter's byte for byte: the graph builder is the same code, and
  the port model's ``state_dict()`` holds the reference-named weights the JAX
  exporter derives from flax.
* Every family (the CNNs, ConvNeXt, both mm_ConvNeXt heads, a cut MaxViT as
  ``tests/test_onnx_export.py`` cuts it, frozen_fusion over each image
  branch, the ``inceptionnext_*`` kinds) goes through ``verify_onnx`` on the
  CPU: the numpy evaluator against the port's float32 forward at the
  reference's rtol 1e-4 / atol 1e-5, on weights randomised from a seed
  (γ, bias tables and BatchNorm statistics too, which a fresh init leaves
  at identity-like values).
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from btsbot_tpu.core.config import normalize_config as jax_normalize_config
from btsbot_tpu.interop.onnx_export import export_onnx as jax_export_onnx
from btsbot_tpu.interop.onnx_numpy import run_model as jax_run_model
from btsbot_tpu.models import maxvit as jax_maxvit
from btsbot_tpu.models.factory import build_model as jax_build_model
from btsbot_tpu.models.factory import example_inputs as jax_example_inputs
from btsbot_tpu_torch.interop import onnx_export
from btsbot_tpu_torch.interop.onnx_numpy import run_model
from btsbot_tpu_torch.interop.onnx_proto import decode_model
from btsbot_tpu_torch.interop.weights import state_dict_from_jax
from btsbot_tpu_torch.models import maxvit
from btsbot_tpu_torch.models.factory import build_model

META_COLS = [f"m{i}" for i in range(25)]
BASE = {
    "train_data_version": "vtest", "metadata_cols": META_COLS,
    "conv1_channels": 8, "conv2_channels": 8, "conv_kernel": 5,
    "conv_dropout1": 0.1, "conv_dropout2": 0.1,
    "fc1_neurons": 16, "fc2_neurons": 8, "dropout": 0.2,
    "meta_fc1_neurons": 16, "meta_fc2_neurons": 16, "meta_dropout": 0.1,
    "comb_fc1_neurons": 8, "comb_fc2_neurons": 8, "comb_dropout": 0.1,
}
ATTO = "convnext_atto.d2_in1k"
MAXVIT_CUT = "maxvit_tiny_rw_64.test"


def _cfg(model_name, **kw):
    return {**BASE, "model_name": model_name, **kw}


def _fusion(image_cfg):
    return _cfg("frozen_fusion", image_model_config=image_cfg,
                meta_model_config=_cfg("um_nn"), skip_load_state=True)


def _data(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 63, 63, 3)).astype(np.float32),
            rng.normal(size=(n, 25)).astype(np.float32))


@pytest.fixture
def tiny_maxvit(monkeypatch):
    spec = {"depths": (1, 1), "dims": (32, 64), "stem_width": 32}
    monkeypatch.setitem(maxvit.MAXVIT_CONFIGS, "maxvit_tiny", spec)
    monkeypatch.setitem(jax_maxvit.MAXVIT_CONFIGS, "maxvit_tiny", spec)


def _randomised(config, seed=1):
    """A port model with every floating entry of its state dict redrawn."""
    model = build_model(config, device="cpu")
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            sd[k] = v
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        else:
            scale = 0.5 if k.endswith((".gamma", "bias_table", "running_mean")) else \
                float(v.std()) if v.numel() > 1 and float(v.std()) > 0 else 0.1
            sd[k] = torch.from_numpy((rng.normal(size=v.shape) * scale).astype(np.float32))
    model.load_state_dict(sd, strict=True)
    return model


def _inputs(config, n=3, seed=0):
    img, meta = _data(n, seed)
    name = config["model_name"]
    return (None if name == "um_nn" else img,
            meta if name in ("um_nn", "mm_cnn", "mm_ConvNeXt", "mm_MaxViT",
                             "frozen_fusion") else None)


@functools.lru_cache(maxsize=None)
def _jax_variables(key):
    """Flax variables from a jitted init, BatchNorm statistics redrawn."""
    config = jax_normalize_config(json.loads(key))
    model = jax_build_model(config)
    img, meta = jax_example_inputs(config)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree_util.tree_map(
        np.asarray, init(jax.random.key(0), image_input=img, metadata_input=meta))
    rng = np.random.default_rng(3)
    if "batch_stats" in variables:
        variables = dict(variables)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda v: rng.uniform(0.5, 2.0, v.shape).astype(np.float32), variables["batch_stats"])
    return variables


@pytest.mark.parametrize("config", [_cfg("um_nn"), _cfg("mm_cnn"),
                                    _cfg("mm_ConvNeXt", model_kind=ATTO)],
                         ids=["um_nn", "mm_cnn", "mm_ConvNeXt_atto"])
def test_onnx_bytes_equal_the_jax_exporters(config, tmp_path):
    variables = _jax_variables(json.dumps(config, sort_keys=True))
    jax_export_onnx(jax_normalize_config(config), variables, str(tmp_path / "jax.onnx"))
    model = build_model(config, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                           state_dict_from_jax(config, variables).items()}, strict=True)
    onnx_export.export_onnx(config, model, str(tmp_path / "torch.onnx"))
    want = (tmp_path / "jax.onnx").read_bytes()
    assert (tmp_path / "torch.onnx").read_bytes() == want
    # and the port's evaluator (a copy) runs it as the JAX package's does
    img, meta = _inputs(config)
    feeds = {"metadata": meta} if img is None else {
        "image": np.ascontiguousarray(img.transpose(0, 3, 1, 2)), "metadata": meta}
    np.testing.assert_array_equal(run_model(want, feeds)["logits"],
                                  jax_run_model(want, feeds)["logits"])
    report = onnx_export.verify_onnx(str(tmp_path / "torch.onnx"), config, model, img, meta,
                                     device="cpu")
    assert report["close"], report


FAMILIES = {
    "um_cnn": _cfg("um_cnn"),
    "ConvNeXt_atto": _cfg("ConvNeXt", model_kind=ATTO),
    "mm_ConvNeXt_atto_LS": _cfg("mm_ConvNeXt", model_kind=ATTO, train_data_version="v10LS"),
    "MaxViT_cut": _cfg("MaxViT", model_kind=MAXVIT_CUT),
    "mm_MaxViT_cut": _cfg("mm_MaxViT", model_kind=MAXVIT_CUT),
    "fusion_um_cnn": _fusion(_cfg("um_cnn")),
    "fusion_ConvNeXt_atto": _fusion(_cfg("ConvNeXt", model_kind=ATTO)),
    "fusion_MaxViT_cut": _fusion(_cfg("MaxViT", model_kind=MAXVIT_CUT)),
    "mm_ConvNeXt_inceptionnext_atto": _cfg("mm_ConvNeXt", model_kind="inceptionnext_atto"),
    "ConvNeXt_inceptionnext_atto_r2": _cfg("ConvNeXt", model_kind="inceptionnext_atto.r2"),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_every_family_verifies_against_the_ports_forward(name, tmp_path, tiny_maxvit):
    config = FAMILIES[name]
    model = _randomised(config)
    img, meta = _inputs(config)
    path = str(tmp_path / "m.onnx")
    report = onnx_export.export_and_verify_onnx(config, model, path, img, meta, device="cpu")
    assert report["close"] and report["n"] == 3, report
    assert report["reference"] == "btsbot_tpu_torch float32 forward on cpu"
    with open(tmp_path / "m.verification.json") as f:
        assert json.load(f) == report


def test_dynamic_batch_contract_and_a_failed_verification(tmp_path):
    config = _cfg("mm_ConvNeXt", model_kind=ATTO)
    model = _randomised(config)
    path = str(tmp_path / "m.onnx")
    onnx_export.export_onnx(config, model.state_dict(), path)
    with open(path, "rb") as f:
        data = f.read()
    g = decode_model(data)
    assert [i[0] for i in g.inputs] == ["image", "metadata"]
    assert g.inputs[0][1] == ["batch", 3, 63, 63] and [o[0] for o in g.outputs] == ["logits"]
    img, meta = _data(n=5, seed=2)
    got = run_model(data, {"image": np.ascontiguousarray(img.transpose(0, 3, 1, 2)),
                           "metadata": meta})["logits"]
    want = onnx_export.port_logits(config, model, img, meta, device="cpu")
    assert got.shape == want.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the artifact of other weights does not pass
    report = onnx_export.verify_onnx(path, config, _randomised(config, seed=2), img, meta,
                                     device="cpu")
    assert not report["close"] and report["max_diff"] > 1e-3


def test_verification_turns_tf32_off_and_restores_it(monkeypatch):
    seen = []
    real = onnx_export.build_model

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(*args, **kwargs)

    monkeypatch.setattr(onnx_export, "build_model", spy)
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        config = _cfg("um_nn")
        with onnx_export.float32_exact():
            inside = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        onnx_export.port_logits(config, build_model(config, device="cpu"), None,
                                _data()[1], device="cpu")
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    assert inside == seen[-1] == (False, False) and after == (True, True)
