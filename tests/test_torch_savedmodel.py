"""The port's TF SavedModel artifact (``interop.savedmodel``) against the
JAX package, through TensorFlow's loaded signature.

* Every family of ``tests/test_torch_onnx_export.py`` (MaxViT cut as that
  file cuts it): the variable tree of the JAX package's ``init_model``
  (``jax.eval_shape``), every leaf drawn from a seed with numpy (a fresh
  init's γ = 1e-6 and unit BatchNorm statistics would hide the ConvNeXt
  blocks and the folding; an eager or jitted init costs 4-26 s a family),
  carried across with ``interop.weights.state_dict_from_jax``; the port's
  artifact loaded by TF and called through ``signatures["serving_default"]``
  within rtol 1e-4 / atol 1e-5 of the flax float32 forward (jitted) at batch
  9, and the port's numpy evaluator within 1e-5 of TF on the same artifact.
* For mm_cnn and um_nn, the same against the JAX package's own SavedModel
  (jax2tf) on the same variables, and the two SignatureDefs agree in input
  and output keys, dtypes and shapes.
* Batch 3 through the artifact that served batch 9; a perturbed weight fails
  ``verify_saved_model``; ``saved_model.pb`` parses with TF's
  ``saved_model_pb2``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from btsbot_tpu import init_model  # noqa: E402
from btsbot_tpu.core.config import normalize_config as jax_normalize_config  # noqa: E402
from btsbot_tpu.interop import savedmodel as jax_savedmodel  # noqa: E402
from btsbot_tpu.models import maxvit as jax_maxvit  # noqa: E402
from btsbot_tpu_torch.interop import savedmodel  # noqa: E402
from btsbot_tpu_torch.interop.savedmodel_numpy import (decode_saved_model,  # noqa: E402
                                                       run_saved_model)
from btsbot_tpu_torch.interop.weights import state_dict_from_jax  # noqa: E402
from btsbot_tpu_torch.models import maxvit  # noqa: E402
from test_torch_onnx_export import FAMILIES, _cfg, _inputs  # noqa: E402

TOL = {"rtol": 1e-4, "atol": 1e-5}
TINY_MAXVIT = {"depths": (1, 1), "dims": (32, 64), "stem_width": 32}
ALL = {**FAMILIES, "um_nn": _cfg("um_nn"), "mm_cnn": _cfg("mm_cnn")}


@pytest.fixture(scope="module")
def cut_maxvit():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(maxvit.MAXVIT_CONFIGS, "maxvit_tiny", TINY_MAXVIT)
        mp.setitem(jax_maxvit.MAXVIT_CONFIGS, "maxvit_tiny", TINY_MAXVIT)
        yield


def _draw(path, leaf, rng):
    """A seeded value for one leaf of the variable tree, at a scale that
    keeps the activations of a deep stack in range."""
    key, shape = path[-1].key, leaf.shape
    if path[0].key == "batch_stats":
        return (rng.normal(size=shape) * 0.5 if key == "mean"
                else rng.uniform(0.5, 2.0, size=shape)).astype(np.float32)
    if key == "kernel":
        scale = 1.0 / np.sqrt(np.prod(shape[:-1]))
    elif key == "scale":
        return (1.0 + rng.normal(size=shape) * 0.1).astype(np.float32)
    else:    # biases, layer-scale γ, relative-position tables
        scale = 0.5 if key == "gamma" else 0.1
    return (rng.normal(size=shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _variables(name: str):
    config = jax_normalize_config(ALL[name])
    tree = jax.eval_shape(lambda: init_model(config, rng=0)[1])
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map_with_path(lambda p, x: _draw(p, x, rng), tree)


def _feeds(img, meta) -> dict:
    return {k: v for k, v in (("image", img), ("metadata", meta)) if v is not None}


def _signature(path):
    return tf.saved_model.load(path).signatures["serving_default"]


def _tf_logits(signature, img, meta) -> np.ndarray:
    return signature(**{k: tf.constant(v) for k, v in _feeds(img, meta).items()}
                     )["logits"].numpy()


def _flax_logits(name, variables, img, meta) -> np.ndarray:
    f, _ = jax_savedmodel.scoring_fn(jax_normalize_config(ALL[name]), variables)
    args = list(_feeds(img, meta).values())
    # XLA's backend optimisations off: half the compile time, the same
    # float32 forward up to summation order (~1e-6 here)
    compiled = jax.jit(f).lower(*args).compile({"xla_backend_optimization_level": 0})
    return np.asarray(compiled(*args))


@pytest.fixture(scope="module")
def exported(tmp_path_factory, cut_maxvit):
    """{family: (variables, state dict, artifact dir, (img, meta),
    flax logits, TF logits, numpy-evaluator logits)} at batch 9."""
    out = {}
    for name, config in ALL.items():
        variables = _variables(name)
        sd = {k: torch.from_numpy(np.asarray(v))
              for k, v in state_dict_from_jax(config, variables).items()}
        path = str(tmp_path_factory.mktemp(name))
        savedmodel.export_saved_model(config, sd, path)
        img, meta = _inputs(config, n=9, seed=5)
        out[name] = (variables, sd, path, (img, meta),
                     _flax_logits(name, variables, img, meta),
                     _tf_logits(_signature(path), img, meta),
                     run_saved_model(path, _feeds(img, meta))["logits"])
    return out


@pytest.mark.parametrize("name", list(ALL))
def test_tf_signature_matches_the_flax_forward(name, exported):
    *_, want, got_tf, got_np = exported[name]
    assert got_tf.shape == want.shape == (9,)
    assert np.ptp(want) > 1e-4     # the check must see the inputs
    np.testing.assert_allclose(got_tf, want, **TOL)
    np.testing.assert_allclose(got_np, got_tf, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["mm_cnn", "um_nn"])
def test_same_logits_and_signature_as_the_jax_saved_model(name, exported, tmp_path):
    variables, _, path, (img, meta), _, got, _ = exported[name]
    jax_path = str(tmp_path / "jax")
    jax_savedmodel.export_saved_model(jax_normalize_config(ALL[name]), variables, jax_path)
    jax_signature = _signature(jax_path)
    np.testing.assert_allclose(got, _tf_logits(jax_signature, img, meta), **TOL)
    ours = _signature(path)
    for which in ("structured_input_signature", "structured_outputs"):
        a, b = getattr(ours, which), getattr(jax_signature, which)
        assert tf.nest.map_structure(lambda s: (s.dtype, s.shape.as_list()), a) == \
            tf.nest.map_structure(lambda s: (s.dtype, s.shape.as_list()), b), which


def test_one_artifact_serves_batches_3_and_9(exported):
    _, _, path, (img, meta), want, got9, _ = exported["mm_ConvNeXt_atto_LS"]
    img, meta = img[:3], meta[:3]
    got = _tf_logits(_signature(path), img, meta)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want[:3], **TOL)
    np.testing.assert_allclose(got, got9[:3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(run_saved_model(path, _feeds(img, meta))["logits"], got,
                               rtol=0, atol=1e-5)


def test_verify_report_and_a_perturbed_weight(exported, tmp_path):
    config = ALL["mm_cnn"]
    _, sd, path, (img, meta), *_ = exported["mm_cnn"]
    report = savedmodel.verify_saved_model(path, config, sd, img, meta, device="cpu",
                                           report_path=str(tmp_path / "v.json"))
    assert report["close"] and report["tensorflow_close"] and report["n"] == 9, report
    assert report["artifact"] == "tf_saved_model"
    assert report["reference"] == "btsbot_tpu_torch float32 forward on cpu"
    shifted = {**sd, "combined_head.5.bias": sd["combined_head.5.bias"] + 0.05}
    report = savedmodel.verify_saved_model(path, config, shifted, img, meta, device="cpu")
    assert not report["close"] and not report["tensorflow_close"]
    assert report["max_diff"] == pytest.approx(0.05, rel=1e-3)


def test_saved_model_pb_parses_with_tensorflows_protos(exported):
    from tensorflow.core.protobuf import saved_model_pb2

    _, _, path, *_ = exported["mm_MaxViT_cut"]
    with open(f"{path}/saved_model.pb", "rb") as f:
        data = f.read()
    sm = saved_model_pb2.SavedModel()
    sm.ParseFromString(data)
    sm.DiscardUnknownFields()
    assert sm.ByteSize() == len(data)      # every byte is a field TF knows
    (mg,) = sm.meta_graphs
    assert list(mg.meta_info_def.tags) == ["serve"] and not mg.HasField("saver_def")
    sig = mg.signature_def["serving_default"]
    assert sig.method_name == "tensorflow/serving/predict"
    shapes = {k: [d.size for d in v.tensor_shape.dim] for k, v in sig.inputs.items()}
    assert shapes == {"image": [-1, 63, 63, 3], "metadata": [-1, 25]}
    assert [d.size for d in sig.outputs["logits"].tensor_shape.dim] == [-1]
    ours = decode_saved_model(data)
    assert [n.name for n in ours.nodes] == [n.name for n in mg.graph_def.node]
    assert [n.op for n in ours.nodes] == [n.op for n in mg.graph_def.node]
    assert not any(n.op == "VarHandleOp" or n.op.startswith("Variable")
                   for n in mg.graph_def.node)
