"""The port's broker daemon (``engine/serve.py::AlertStreamConsumer``) and
its bf16 pixel transfer against the JAX package's, on the CPU.

Both daemons run ``convnext_atto`` in float32 on the same weights (flax
variables through ``state_dict_from_jax``) over the same packets, some of
them corrupt.  Held: the same candids in each sink call, the same drop
masks, scores within 1e-5 (summation order), bf16 transfer within 0.01 of
the JAX package's bf16 transfer and of the port's float32 (bf16 rounding of
raw pixels), identical ``stats`` keys.  The daemon's own behaviour is held
too: a queue source with partial flushes and the idle drain, a source
error, ``stop()`` mid-stream.  Every join, queue wait and ``stop()`` takes
a timeout of at most 10 s, so a hang fails instead of stalling the suite.
"""

import gzip
import json
import queue
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btsbot_tpu.engine import serve as jax_serve
from btsbot_tpu_torch.data.fits import write_fits_image
from btsbot_tpu_torch.data.synthetic import synthetic_packets
from btsbot_tpu_torch.engine import serve
from btsbot_tpu_torch.interop.weights import state_dict_from_jax
from test_torch_model import META_COLS, atto_config, flax_variables

BATCH = 8
WAIT = 10.0  # seconds: the longest any wait in this file may take


def _packets(n, seed):
    """n packets, every fifth one corrupt in turn: an all-NaN science cutout,
    a missing difference cutout, an all-zero template."""
    packets = list(synthetic_packets(n, META_COLS, seed=seed, unique_stamps=True))
    for k, i in enumerate(range(2, n, 5)):
        p = packets[i]
        if k % 3 == 0:
            p["cutoutScience"] = {"stampData": gzip.compress(write_fits_image(
                np.full((63, 63), np.nan, np.float32)))}
        elif k % 3 == 1:
            p["cutoutDifference"] = None
        else:
            p["cutoutTemplate"] = {"stampData": gzip.compress(write_fits_image(
                np.zeros((63, 63), np.float32)))}
    return packets


@pytest.fixture(scope="module")
def scorers():
    """One JAX scorer and one port scorer per transfer type, shared by the
    module (the JAX one compiles once)."""
    config = atto_config()
    variables = flax_variables(config)
    weights = state_dict_from_jax(config, variables)
    out = {}
    for name, jax_wire, port_wire in (("f32", None, None),
                                      ("bf16", jnp.bfloat16, torch.bfloat16)):
        out[name] = (
            jax_serve.AlertStreamScorer(config, variables, batch_size=BATCH,
                                        dtype=jnp.float32, transfer_dtype=jax_wire),
            serve.AlertStreamScorer(config, weights, batch_size=BATCH,
                                    dtype=torch.float32, transfer_dtype=port_wire,
                                    device="cpu"))
    return out


def _run(consumer_cls, scorer, packets, **kwargs):
    """(sink calls as (candids, scores, drop), stats) of one daemon run over
    an iterable source."""
    calls = []

    def sink(pkts, scores, drop):
        calls.append(([p["candid"] for p in pkts], np.array(scores), np.array(drop)))

    consumer = consumer_cls(scorer, iter(packets), sink, max_batch=BATCH,
                            max_wait_s=1.0, **kwargs)
    return calls, consumer.run()


def test_daemon_matches_jax_per_sink_call(scorers):
    jax_scorer, port_scorer = scorers["f32"]
    packets = _packets(21, seed=1)
    got, got_stats = _run(serve.AlertStreamConsumer, port_scorer, packets)
    want, want_stats = _run(jax_serve.AlertStreamConsumer, jax_scorer, packets)
    assert [c for c, _, _ in got] == [c for c, _, _ in want]
    assert [c for c, _, _ in got] == [list(range(0, 8)), list(range(8, 16)),
                                      list(range(16, 21))]
    for (_, s, d), (_, ws, wd) in zip(got, want):
        np.testing.assert_array_equal(d, wd)
        np.testing.assert_allclose(s[~d], ws[~wd], rtol=0, atol=1e-5)
        assert np.all(np.isnan(s[d]))
    drop = np.concatenate([d for _, _, d in got])
    assert drop.sum() == 4 and np.array_equal(np.flatnonzero(drop), [2, 7, 12, 17])
    assert set(got_stats) == set(want_stats)
    for key in ("alerts_in", "alerts_scored", "dropped", "batches", "score_hist"):
        assert got_stats[key] == want_stats[key], key


def test_bf16_transfer_matches_jax_and_f32(scorers):
    packets = _packets(13, seed=2)
    jax_b, port_b = scorers["bf16"]
    _, port_f = scorers["f32"]
    got, _ = _run(serve.AlertStreamConsumer, port_b, packets)
    want, _ = _run(jax_serve.AlertStreamConsumer, jax_b, packets)
    f32, _ = _run(serve.AlertStreamConsumer, port_f, packets)
    for (c, s, d), (wc, ws, wd), (_, fs, fd) in zip(got, want, f32):
        assert c == wc
        np.testing.assert_array_equal(d, wd)
        np.testing.assert_array_equal(d, fd)
        assert np.abs(s[~d] - ws[~d]).max() <= 0.01
        assert np.abs(s[~d] - fs[~d]).max() <= 0.01


def test_bf16_transfer_halves_the_pixel_bytes(scorers):
    """The pixels reach the card stage in bfloat16; the metadata in float32."""
    _, port_b = scorers["bf16"]
    seen = {}
    fwd = port_b._fwd

    def spy(img, meta):
        seen["img"], seen["meta"] = img.dtype, meta.dtype
        return fwd(img, meta)

    port_b._fwd = spy
    try:
        port_b(_packets(3, seed=3))
    finally:
        del port_b._fwd
    assert seen == {"img": torch.bfloat16, "meta": torch.float32}


def _wait_for(pred, what):
    deadline = time.monotonic() + WAIT
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def test_queue_source_partial_flush_idle_drain_and_stop(scorers):
    """A queue source: a partial batch flushes max_wait_s after its first
    packet and its results reach the sink while the source is idle (the
    idle drain: with max_in_flight 2 nothing else would push them out); the
    None sentinel ends the run after the drain."""
    _, port_scorer = scorers["f32"]
    q = queue.Queue(maxsize=32)
    sizes = []
    consumer = serve.AlertStreamConsumer(port_scorer, q,
                                         sink=lambda p, s, d: sizes.append(len(s)),
                                         max_batch=BATCH, max_wait_s=0.05,
                                         max_in_flight=2)
    consumer.start()
    for p in _packets(3, seed=4):
        q.put(p, timeout=WAIT)
    _wait_for(lambda: sizes, "the partial batch")
    assert sizes == [3]
    for p in _packets(2, seed=5):
        q.put(p, timeout=WAIT)
    q.put(None, timeout=WAIT)
    _wait_for(lambda: consumer.stats["alerts_scored"] == 5, "the second batch")
    stats = consumer.stop(timeout=WAIT)
    assert sizes == [3, 2] and stats["alerts_scored"] == stats["alerts_in"] == 5
    assert stats["latency_p99_ms"] >= stats["latency_p50_ms"] > 0
    hist = np.asarray(stats["score_hist"])
    assert hist.shape == (20,) and hist.sum() == 5 - stats["dropped"]


def test_stop_mid_stream_scores_everything_taken_in(scorers):
    _, port_scorer = scorers["f32"]
    packets = _packets(BATCH, seed=6)
    stop_feed = threading.Event()

    def endless():
        k = 0
        while not stop_feed.is_set():
            yield dict(packets[k % len(packets)], candid=k)
            k += 1
            time.sleep(0.002)

    got = []
    consumer = serve.AlertStreamConsumer(port_scorer, endless(),
                                         sink=lambda p, s, d: got.extend(s),
                                         max_batch=BATCH, max_wait_s=0.02)
    consumer.start()
    _wait_for(lambda: consumer.stats["alerts_scored"] >= 2 * BATCH, "two batches")
    stats = consumer.stop(timeout=WAIT)
    stop_feed.set()
    assert not consumer._thread.is_alive()
    assert stats["alerts_scored"] == stats["alerts_in"] == len(got) >= 2 * BATCH


def test_source_error_is_raised_after_the_drain(scorers):
    _, port_scorer = scorers["f32"]
    packets = _packets(3, seed=7)

    def bad_source():
        yield from packets
        raise RuntimeError("broker exploded")

    got = []
    consumer = serve.AlertStreamConsumer(port_scorer, bad_source(),
                                         sink=lambda p, s, d: got.extend(s),
                                         max_batch=4, max_wait_s=0.02)
    with pytest.raises(RuntimeError, match="source failed"):
        consumer.run()
    assert len(got) == 3 and consumer.stats["alerts_scored"] == 3

    background = serve.AlertStreamConsumer(port_scorer, bad_source(),
                                           sink=lambda p, s, d: None,
                                           max_batch=4, max_wait_s=0.02)
    background.start()
    background._thread.join(WAIT)
    with pytest.raises(RuntimeError, match="background consumer failed"):
        background.stop(timeout=WAIT)


def test_failing_sink_does_not_strand_the_decode_thread(scorers):
    _, port_scorer = scorers["f32"]

    def bad_sink(p, s, d):
        raise BrokenPipeError("downstream gone")

    consumer = serve.AlertStreamConsumer(port_scorer, iter(_packets(12, seed=8)),
                                         sink=bad_sink, max_batch=4, max_wait_s=0.02)
    with pytest.raises(BrokenPipeError):
        consumer.run()
    _wait_for(lambda: not any(t.name == "alert-consumer-decode" and t.is_alive()
                              for t in threading.enumerate()), "the decode thread")


def test_stats_lines_at_the_interval(scorers):
    _, port_scorer = scorers["f32"]
    lines = []
    consumer = serve.AlertStreamConsumer(port_scorer, iter(_packets(17, seed=9)),
                                         sink=lambda *a: None, max_batch=4,
                                         max_wait_s=1.0, stats_interval_s=1e-6,
                                         stats_log=lines.append)
    stats = consumer.run()
    rows = [json.loads(line) for line in lines]
    assert len(rows) == stats["batches"] == 5
    assert rows[-1]["alerts_scored"] == 17 and "latency_p50_ms" in rows[-1]
