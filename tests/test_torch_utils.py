"""The port's profiling helpers and its kernel cache switch on the CPU.

``utils/profiling.py``: ``trace`` writes a Chrome trace that holds an
``annotate`` region, ``time_device_fn`` times on the host clock for CPU
tensors.  ``utils/compile_cache.py``: ``enable`` points the kernel build at
a directory and ``disable`` points it back, without building anything (no
``nvcc`` here).
"""

import json
import os

import torch

from btsbot_tpu_torch.ops import _build
from btsbot_tpu_torch.utils import compile_cache, profiling


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        with profiling.annotate("btsbot-region"):
            (x @ x).sum()
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "btsbot-region" for e in events)


def test_time_device_fn_on_the_cpu():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b

    secs = profiling.time_device_fn(fn, (torch.ones(8), torch.ones(8)), iters=4, reps=2)
    assert secs > 0 and len(calls) == 1 + 4 * 2


def test_compile_cache_points_the_build_dir_without_building(tmp_path, monkeypatch):
    def no_build():
        raise AssertionError("built")

    monkeypatch.setattr(_build, "build", no_build)
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    assert _build.DEFAULT_BUILD_DIR.parts[-2:] == ("build", "kernels")
    try:
        got = compile_cache.enable(tmp_path / "cache")
        assert got == (tmp_path / "cache").resolve() == _build.BUILD_DIR
        assert not got.exists()
    finally:
        compile_cache.disable()
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
