"""``AlertScorer``'s pinned feed ring (``engine/serve.py``).

On the CPU: the chunk plan and the tail to zero (``_feed_plan``), and the
staged path's order of events, driven in program order with stand-ins for
the CUDA streams, events and pinned memory, against the host-padded path.
On a CUDA card (marked ``cuda``; this file imports no JAX): the staged
scores bit for bit against the same scorer's host-padded path, ring reuse
across calls, and the ring's counters in a traced call.
"""

import contextlib

import numpy as np
import pytest
import torch

from btsbot_tpu_torch.core.config import normalize_config
from btsbot_tpu_torch.engine import serve
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.utils import profiling

ROW = 63 * 63 * 3 * 4  # a float32 triplet's bytes
CPU = torch.device("cpu")


def _rows(*bounds):
    return [slice(lo, hi) for lo, hi in bounds]


def _steps(real, step):
    return [slice(lo, min(lo + step, real)) for lo in range(0, real, step)]


@pytest.mark.parametrize("n,take,row_bytes,chunk_bytes,chunks,tail", [
    # one alert in the smallest bucket
    (1, slice(0, 192), ROW, 100 * ROW, _rows((0, 1)), slice(1, 192)),
    # a batch that fills its bucket: nothing to zero
    (192, slice(0, 192), ROW, 100 * ROW, _rows((0, 100), (100, 192)), slice(192, 192)),
    # one past a bucket: the next rung, mostly padding
    (193, slice(0, 768), ROW, 100 * ROW, _rows((0, 100), (100, 193)), slice(193, 768)),
    # a full batch at batch_size
    (3072, slice(0, 3072), ROW, 100 * ROW, _steps(3072, 100), slice(3072, 3072)),
    # a chunk that is not a whole number of rows
    (250, slice(0, 768), ROW, 100 * ROW + 7, _rows((0, 100), (100, 200), (200, 250)),
     slice(250, 768)),
    # a row wider than a chunk: one row a chunk
    (3, slice(0, 192), ROW, ROW // 2, _rows((0, 1), (1, 2), (2, 3)), slice(3, 192)),
    # metadata rows at the module's chunk: one chunk
    (3072, slice(0, 3072), 25 * 4, serve._STAGE_CHUNK_BYTES, _rows((0, 3072)),
     slice(3072, 3072)),
    # mesh, rank 0 of 2: its half holds every real row
    (1000, slice(0, 1536), ROW, 400 * ROW, _rows((0, 400), (400, 800), (800, 1000)),
     slice(1000, 1536)),
    # mesh, rank 1 of 2: the real rows past its half's start
    (2000, slice(1536, 3072), ROW, 100 * ROW, _steps(464, 100), slice(464, 1536)),
    # mesh, rank 1 of 2: its half is all padding
    (1000, slice(1536, 3072), ROW, 100 * ROW, [], slice(0, 1536)),
])
def test_feed_plan_chunks_the_real_rows_and_zeroes_the_rest(n, take, row_bytes, chunk_bytes,
                                                            chunks, tail):
    got_chunks, got_tail = serve._feed_plan(n, take, row_bytes, chunk_bytes)
    assert got_chunks == chunks
    assert got_tail == tail
    real = len(range(n)[take])
    # the chunks tile the rank's real rows in order; the tail runs to its share's end
    assert sum(c.stop - c.start for c in got_chunks) == real == got_tail.start
    assert got_tail.stop == take.stop - take.start


# --------------- the staged path in program order, on the CPU ---------------

N_META = 4


def _config():
    return normalize_config({
        "model_name": "mm_ConvNeXt", "model_kind": "convnext_atto.test",
        "metadata_cols": [f"m{i}" for i in range(N_META)],
        "meta_fc1_neurons": 8, "meta_fc2_neurons": 8, "meta_dropout": 0.2,
        "comb_fc1_neurons": 8, "comb_fc2_neurons": 8, "comb_dropout": 0.2,
    })


def _alerts(n, n_meta, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 63, 63, 3)).astype(np.float32),
            rng.normal(size=(n, n_meta)).astype(np.float32))


class _Stream:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def wait_event(self, event):
        self.log.append(("wait", self.name, event))


class _Event:
    """A CUDA event's stand-in: the work it marks has already run."""

    def __init__(self, log):
        self.log = log

    def record(self, stream):
        self.log.append(("record", stream.name, self))

    def query(self):
        return True

    def synchronize(self):
        self.log.append(("sync", "host", self))


@pytest.fixture
def program_order(monkeypatch):
    """The ring's CUDA calls replaced by stand-ins that log them; returns
    the log."""
    log = []
    empty = torch.empty

    def unpinned(*shape, pin_memory=False, **kw):
        return empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", unpinned)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream("copy", log))
    monkeypatch.setattr(torch.cuda, "Event", lambda: _Event(log))
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream("compute", log))
    return log


def test_staged_path_in_program_order_matches_the_padded_path(program_order, tmp_path):
    config = _config()
    weights = build_model(config, device=CPU).state_dict()
    scorer = serve.AlertScorer(config, weights, batch_size=8, bucket_sizes=[2, 4],
                               dtype=torch.float32, device=CPU)
    for n, seed in ((11, 0), (3, 1)):  # 8 + 3 (padded to 4), then 3 into a used slot
        images, meta = _alerts(n, N_META, seed)
        want = np.empty(n, np.float32)
        scorer._call_padded((images, meta), want)
        del program_order[:]
        got = np.empty(n, np.float32)
        with profiling.trace(str(tmp_path / str(n))):
            scorer._call_staged((images, meta), got)
        counts = profiling.counters()
        np.testing.assert_array_equal(got, want)
        # the slot's padding is zero on the card side
        slot = scorer._ring.slots[(n - 1) // 8 % 2]
        assert not slot.dev[0][n % 8:4].any() and not slot.dev[1][n % 8:4].any()
        batches = (n + 7) // 8
        real_bytes = n * (63 * 63 * 3 + N_META) * 4
        assert counts == {"serve.batches": batches, "serve.staged_batches": batches,
                          "serve.rows": n, "serve.padded_rows": 8 * (batches - 1) + 4,
                          "serve.h2d_bytes": real_bytes}
        # per batch on slot s: the copy stream waits for s's last forward, the
        # forward for s's copies; each batch's scores are read after the next
        # batch's forward is queued, the last batch's before the call returns
        expected = []
        slots = scorer._ring.slots
        for i in range(batches):
            s = slots[i % 2]
            expected += [("wait", "copy", s.consumed), ("record", "copy", s.copied),
                         ("wait", "compute", s.copied), ("record", "compute", s.consumed),
                         ("record", "compute", s.scored)]
            if i:
                expected.append(("sync", "host", slots[(i - 1) % 2].scored))
        expected.append(("sync", "host", slots[(batches - 1) % 2].scored))
        assert program_order == expected


# ------------------------------- on the card -------------------------------

def _pico_config():
    return normalize_config({
        "model_name": "mm_ConvNeXt", "model_kind": "convnext_pico.d1_in1k",
        "metadata_cols": [f"m{i}" for i in range(25)],
        "meta_fc1_neurons": 128, "meta_fc2_neurons": 128, "meta_dropout": 0.2,
        "comb_fc1_neurons": 256, "comb_fc2_neurons": 32, "comb_dropout": 0.2,
    })


@pytest.fixture(scope="module")
def card_scorer():
    """A bf16 flagship scorer at batch 3072 on the card, and a maker of
    fresh ones with the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config = _pico_config()
    torch.manual_seed(0)
    weights = build_model(config, device=CPU).state_dict()

    def make():
        return serve.AlertScorer(config, weights, batch_size=3072, device="cuda")
    return make(), make


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 191, 192, 3071, 3073, 7000])
def test_staged_scores_equal_the_padded_path_bit_for_bit(card_scorer, n):
    scorer, _ = card_scorer
    images, meta = _alerts(n, 25, n)
    got = scorer(images, meta)
    want = np.empty(n, np.float32)
    scorer._call_padded((images, meta), want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_ring_reuse_leaks_no_rows_between_calls(card_scorer):
    _, make = card_scorer
    scorer = make()
    first, second = _alerts(5000, 25, 1), _alerts(100, 25, 2)
    a, b = scorer(*first), scorer(*second)
    np.testing.assert_array_equal(a, make()(*first))
    np.testing.assert_array_equal(b, make()(*second))
    # the second call's batch (bucket 192) went to slot 0, which last held 3072 rows
    torch.cuda.synchronize()
    assert not scorer._ring.slots[0].dev[0][100:192].any()
    assert not scorer._ring.slots[0].dev[1][100:192].any()


@pytest.mark.cuda
def test_traced_call_feeds_every_batch_through_the_ring(card_scorer, tmp_path):
    scorer, _ = card_scorer
    images, meta = _alerts(7000, 25, 3)
    with profiling.trace(str(tmp_path)):
        scorer(images, meta)
    counts = profiling.counters()
    assert counts["serve.batches"] == 3
    assert counts["serve.staged_batches"] == counts["serve.batches"]
    assert counts["serve.h2d_bytes"] == 7000 * (63 * 63 * 3 + 25) * 4
