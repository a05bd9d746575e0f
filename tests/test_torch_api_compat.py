"""Three public signatures of the JAX package that the port keeps, called
with the JAX package's arguments on the CPU:

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

from btsbot_tpu import native as jax_native
from btsbot_tpu.ops import preprocess as jax_pre
from btsbot_tpu_torch import native
from btsbot_tpu_torch.data.fits import write_fits_image
from btsbot_tpu_torch.ops import _build
from btsbot_tpu_torch.ops import preprocess
from btsbot_tpu_torch.utils import compile_cache


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
