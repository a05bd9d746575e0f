"""The JAX package's public surface in the port.

Every name of ``btsbot_tpu.__all__`` resolves in ``btsbot_tpu_torch`` but
the two that take or return flax variables (``DELIBERATE``); the reference
facade's model class names are the classes ``build_model`` makes.  Three
public signatures the port keeps, called with the JAX package's arguments
on the CPU:

* ``ops.preprocess.l2_normalize_cutouts(triplets, eps=0.0)``: divides only
  where a cutout's norm exceeds ``eps``; equal to the JAX function's output;
* ``native.native_available()``: whether the C++ stamp decoder is loaded
  (always where ``make`` and ``g++`` are on the PATH: the port builds its
  own copy under a lock), and the same stamps decoded by both packages;
* ``utils.compile_cache.enable(cache_dir, min_compile_time_s=0.5)``: the
  argument is accepted and has no meaning for the ``nvcc`` build.
"""

import gzip
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import btsbot_tpu
import btsbot_tpu_torch
from btsbot_tpu import native as jax_native
from btsbot_tpu.ops import preprocess as jax_pre
from btsbot_tpu_torch import native
from btsbot_tpu_torch.models import maxvit
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.data.fits import write_fits_image
from btsbot_tpu_torch.ops import _build
from btsbot_tpu_torch.ops import preprocess
from btsbot_tpu_torch.utils import compile_cache
from test_torch_onnx_export import ATTO, MAXVIT_CUT, _cfg, _fusion

# flax-variable entry points with no PyTorch counterpart
DELIBERATE = {"init_model", "torch_state_dict_to_variables"}
MODEL_CONFIGS = {
    "mm_cnn": _cfg("mm_cnn"), "um_cnn": _cfg("um_cnn"), "um_nn": _cfg("um_nn"),
    "ConvNeXt": _cfg("ConvNeXt", model_kind=ATTO),
    "mm_ConvNeXt": _cfg("mm_ConvNeXt", model_kind=ATTO),
    "MaxViT": _cfg("MaxViT", model_kind=MAXVIT_CUT),
    "mm_MaxViT": _cfg("mm_MaxViT", model_kind=MAXVIT_CUT),
    "frozen_fusion": _fusion(_cfg("um_cnn")),
}


def test_every_public_name_of_the_jax_package_resolves_in_the_port():
    assert set(btsbot_tpu.__all__) - set(btsbot_tpu_torch.__all__) == DELIBERATE
    for name in btsbot_tpu.__all__:
        if name not in DELIBERATE:
            assert getattr(btsbot_tpu_torch, name) is not None, name
    from btsbot_tpu_torch import (FlexibleDataset, export_onnx, export_saved_model,
                                  load_BTSbot_model, mm_ConvNeXt)
    from btsbot_tpu_torch.data.dataset import AlertDataset
    from btsbot_tpu_torch.engine.distill import load_teacher
    from btsbot_tpu_torch.interop import onnx_export, savedmodel
    assert FlexibleDataset is AlertDataset and load_BTSbot_model is load_teacher
    assert export_onnx is onnx_export.export_onnx
    assert export_saved_model is savedmodel.export_saved_model
    assert mm_ConvNeXt.__module__ == "btsbot_tpu_torch.models.convnext"
    with pytest.raises(AttributeError):
        btsbot_tpu_torch.init_model


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_reference_model_names_are_the_classes_build_model_makes(name, monkeypatch):
    assert name in btsbot_tpu.__all__
    monkeypatch.setitem(maxvit.MAXVIT_CONFIGS, "maxvit_tiny",
                        {"depths": (1, 1), "dims": (32, 64), "stem_width": 32})
    assert type(build_model(MODEL_CONFIGS[name], device="cpu")) is getattr(btsbot_tpu_torch, name)


def _triplets():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(4, 63, 63, 3)).astype(np.float32)
    t[1, :, :, 0] *= 1e-4    # norm about 6e-3
    t[2, :, :, 2] = 0.0      # an all-zero cutout
    t[3] *= 1e-3             # norms about 6e-2
    return t


@pytest.mark.parametrize("eps", [None, 0.0, 1e-2, 0.1])
def test_l2_normalize_cutouts_eps_matches_jax(eps):
    t = _triplets()
    kw = {} if eps is None else {"eps": eps}
    got = preprocess.l2_normalize_cutouts(torch.from_numpy(t), **kw).numpy()
    want = np.asarray(jax_pre.l2_normalize_cutouts(jnp.asarray(t), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    norms = np.sqrt((t.astype(np.float64) ** 2).sum(axis=(1, 2)))
    kept = norms <= (eps or 0.0)  # left as they are
    assert np.array_equal(got.transpose(0, 3, 1, 2)[kept], t.transpose(0, 3, 1, 2)[kept])


def test_native_available():
    got = native.native_available()
    assert isinstance(got, bool)
    assert got == (native.decoder() == "native")
    if shutil.which("make") and shutil.which("g++"):
        assert got
    # whichever decoder each package loaded, both decode the same blobs alike
    rng = np.random.default_rng(3)
    blobs = [gzip.compress(write_fits_image((rng.normal(size=(n, n)) * 100).astype(dt)))
             for n, dt in ((63, np.float32), (58, np.float64), (63, np.int16))]
    blobs += [b"not gzip", gzip.compress(write_fits_image(np.ones((80, 80), np.float32)))]
    ours, ours_status = native.decode_stamps(blobs)
    theirs, their_status = jax_native.decode_stamps(blobs)
    np.testing.assert_array_equal(ours_status != 0, their_status != 0)
    assert list(ours_status != 0) == [False, False, False, True, True]
    np.testing.assert_array_equal(ours[:3], theirs[:3])


@pytest.mark.parametrize("args,kwargs", [((0.5,), {}), ((), {"min_compile_time_s": 2.0}),
                                         ((), {})])
def test_compile_cache_enable_takes_the_jax_arguments(tmp_path, monkeypatch, args, kwargs):
    def no_build():
        raise AssertionError("built")

    monkeypatch.setattr(_build, "build", no_build)
    try:
        got = compile_cache.enable(str(tmp_path / "cache"), *args, **kwargs)
        assert got == (tmp_path / "cache").resolve() == _build.BUILD_DIR
    finally:
        compile_cache.disable()
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
