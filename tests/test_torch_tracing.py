"""The port's spans and counters on the CPU (``utils/profiling.py``).

With no profiler recording, ``annotate`` never enters ``record_function``
and ``count`` adds nothing.  Under ``profiling.trace`` the scorer's batches,
the data feed and the train step record their spans, nested on the
profiler's clock, and ``counters.json`` holds the scorer's exact rows,
padded rows, batches and bytes copied.
"""

import json
import os

import numpy as np
import pytest
import torch

from btsbot_tpu_torch.core.config import normalize_config
from btsbot_tpu_torch.data.dataset import AlertDataset, iterate_batches
from btsbot_tpu_torch.engine import serve
from btsbot_tpu_torch.engine.state import create_train_state
from btsbot_tpu_torch.engine.steps import make_train_step, to_device
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.utils import profiling

N_META = 4
CPU = torch.device("cpu")


def _config():
    return normalize_config({
        "model_name": "mm_ConvNeXt", "model_kind": "convnext_atto.test",
        "metadata_cols": [f"m{i}" for i in range(N_META)],
        "meta_fc1_neurons": 8, "meta_fc2_neurons": 8, "meta_dropout": 0.2,
        "comb_fc1_neurons": 8, "comb_fc2_neurons": 8, "comb_dropout": 0.2,
        "batch_size": 4, "epochs": 1, "learning_rate": 1e-3, "beta_1": 0.9, "beta_2": 0.999,
    })


def _alerts(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 63, 63, 3)).astype(np.float32),
            rng.normal(size=(n, N_META)).astype(np.float32))


def _read(log_dir):
    """(spans as (name, start, end) in µs, counters) of a ``trace``."""
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation" and "dur" in e]
    with open(os.path.join(log_dir, "counters.json")) as f:
        return spans, json.load(f)


def _inside(spans, outer, name):
    """The spans called ``name`` that lie within ``outer``'s time."""
    return [s for s in spans if s[0] == name and outer[1] <= s[1] and s[2] <= outer[2]]


def test_off_path_enters_no_record_function_and_counts_nothing(monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", entered)
    profiling.reset_counters()
    assert not torch.autograd._profiler_enabled()
    with profiling.annotate("serve.batch") as a, profiling.annotate("step.run") as b:
        profiling.count("serve.rows", 5)
    assert a is None and b is None
    # one shared no-op context, not one made per span
    assert profiling.annotate("x") is profiling.annotate("y")
    assert profiling.counters() == {}


def test_counts_add_only_inside_the_traced_window(tmp_path):
    profiling.reset_counters()
    profiling.count("before")
    with profiling.trace(str(tmp_path)):
        profiling.count("inside")
        profiling.count("inside", 41)
    profiling.count("after")
    assert profiling.counters() == {"inside": 42}
    assert _read(tmp_path)[1] == {"inside": 42}
    got = profiling.counters()
    got["inside"] = 0  # a copy: the process's counters are unchanged
    assert profiling.counters() == {"inside": 42}


def test_trace_resets_the_counters_on_entry(tmp_path):
    with profiling.trace(str(tmp_path / "first")):
        profiling.count("serve.rows", 7)
        profiling.count("serve.batches")
    with profiling.trace(str(tmp_path / "second")):
        assert profiling.counters() == {}
        profiling.count("serve.rows", 3)
    assert _read(tmp_path / "first")[1] == {"serve.rows": 7, "serve.batches": 1}
    assert _read(tmp_path / "second")[1] == {"serve.rows": 3}


def test_scorer_batches_hold_their_parts_and_count_exactly(tmp_path):
    config = _config()
    weights = build_model(config, device=CPU).state_dict()
    scorer = serve.AlertScorer(config, weights, batch_size=8, bucket_sizes=[4, 8],
                               dtype=torch.float32, device=CPU)
    images, meta = _alerts(11)
    with profiling.trace(str(tmp_path)):
        got = scorer(images, meta)
    spans, counts = _read(tmp_path)
    np.testing.assert_array_equal(got, scorer(images, meta))
    # 11 alerts: a full batch of 8, then 3 padded to the bucket of 4
    assert counts == {"serve.batches": 2, "serve.rows": 11, "serve.padded_rows": 12,
                      "serve.h2d_bytes": 12 * (63 * 63 * 3 + N_META) * 4}
    batches = [s for s in spans if s[0] == "serve.batch"]
    assert len(batches) == 2
    for batch in batches:
        parts = {name: _inside(spans, batch, name) for name in
                 ("serve.pad", "serve.h2d", "serve.forward", "serve.readback")}
        # triplets and metadata are padded and copied apart
        assert [len(parts[k]) for k in parts] == [2, 2, 1, 1]
        assert max(s[2] for s in parts["serve.h2d"]) <= parts["serve.forward"][0][1]
        assert parts["serve.forward"][0][2] <= parts["serve.readback"][0][1]
    assert sum(s[0] == "serve.pad" for s in spans) == 4


@pytest.mark.parametrize("dtype,width", [(torch.float32, 4), (torch.bfloat16, 2)])
def test_padded_copy_counts_the_bytes_it_hands_over(tmp_path, dtype, width):
    images, _ = _alerts(3)
    with profiling.trace(str(tmp_path)):
        out = serve._padded_on(images, 5, CPU, dtype)
    spans, counts = _read(tmp_path)
    assert out.dtype == dtype and out.shape == (5, 63, 63, 3)
    assert not out[3:].any()
    assert counts == {"serve.h2d_bytes": 5 * 63 * 63 * 3 * width}
    assert [s[0] for s in spans] == ["serve.pad", "serve.h2d"]


def test_fed_train_step_records_the_feed_and_the_step_parts(tmp_path):
    config = _config()
    model = build_model(config, device=CPU)
    state = create_train_state(config, model, steps_per_epoch=1, seed=3)
    step = make_train_step(config)
    images, meta = _alerts(6, seed=1)
    dataset = AlertDataset(labels=np.array([0, 1, 0, 1, 0, 1], np.float32), images=images,
                           metadata=meta)
    with profiling.trace(str(tmp_path)):
        for batch in iterate_batches(dataset, 4, shuffle=True, drop_last=True, seed=0):
            m = step(state, *(to_device(x, CPU) for x in batch), 1.0)
    spans, _ = _read(tmp_path)
    assert np.isfinite(float(m["loss"])) and state.step == 1
    names = [s[0] for s in spans]
    assert names.count("feed.gather") == 1 and names.count("feed.to_device") == 3
    (run,) = [s for s in spans if s[0] == "step.run"]
    gather = next(s for s in spans if s[0] == "feed.gather")
    assert gather[2] <= run[1]  # closed before the step that consumes the batch
    parts = [_inside(spans, run, name) for name in
             ("step.augment", "step.forward", "step.backward", "step.optimizer")]
    assert [len(p) for p in parts] == [1, 1, 1, 1]
    assert all(a[0][2] <= b[0][1] for a, b in zip(parts, parts[1:]))
    assert "step.allreduce" not in names
