"""The port's Kafka source (``btsbot_tpu_torch/data/kafka.py``) against the
JAX package's, with a fake consumer as ``tests/test_kafka_source.py`` uses
(no broker, no ``confluent_kafka``): the same packets from the same feed,
the same error handling, Avro routing and tombstones, and the stub feed
through the port's serving daemon on the CPU."""

import json
import threading

import numpy as np
import pytest
import torch

from btsbot_tpu.data import kafka as jax_kafka
from btsbot_tpu_torch.data import kafka
from btsbot_tpu_torch.data.avro import write_ocf, ztf_alert_schema
from btsbot_tpu_torch.data.synthetic import synthetic_packets
from btsbot_tpu_torch.engine import serve
from btsbot_tpu_torch.interop.weights import state_dict_from_jax
from test_torch_model import META_COLS, atto_config, flax_variables


class _Msg:
    def __init__(self, value=None, error=None):
        self._value, self._error = value, error

    def error(self):
        return self._error

    def value(self):
        return self._value


class _StubConsumer:
    """poll() hands out the feed's items (a _Msg or None for an idle poll),
    then sets the stop event."""

    def __init__(self, feed, stop_event):
        self._feed = list(feed)
        self._stop = stop_event

    def poll(self, timeout):
        if not self._feed:
            self._stop.set()
            return None
        return self._feed.pop(0)


def _both(feed, **kwargs):
    """The packets of the port's source and of the JAX package's on the same
    feed."""
    out = []
    for module in (kafka, jax_kafka):
        stop = threading.Event()
        out.append(list(module.kafka_packet_source(
            _StubConsumer(list(feed), stop), stop_event=stop, poll_timeout_s=0.01,
            **kwargs)))
    return out


def _ocf(packet):
    return write_ocf(ztf_alert_schema(["magpsf"]), [packet])


def test_json_and_avro_feed_matches_jax():
    packets = [{"candid": i, "candidate": {"magpsf": float(i)}} for i in range(3)]
    avro_packet = {"objectId": "ZTF25x", "candid": 7, "candidate": {"magpsf": 18.5},
                   "cutoutScience": None, "cutoutTemplate": None,
                   "cutoutDifference": None}
    feed = [_Msg(json.dumps(p).encode()) for p in packets]
    feed.insert(1, None)                            # an idle poll mid-stream
    feed.append(_Msg(value=None))                   # a tombstone
    feed.append(_Msg(_ocf(avro_packet)))            # Avro OCF framing
    got, want = _both(feed)
    assert got == want == packets + [avro_packet]
    assert kafka.AVRO_MAGIC == jax_kafka.AVRO_MAGIC
    raw = _ocf(avro_packet)
    assert kafka.deserialize_packet(raw) == jax_kafka.deserialize_packet(raw)


def test_errors_raise_or_go_to_on_error_as_in_jax():
    feed = [_Msg(error="boom"), _Msg(json.dumps({"candid": 1}).encode())]
    for module in (kafka, jax_kafka):
        stop = threading.Event()
        with pytest.raises(RuntimeError, match="boom"):
            list(module.kafka_packet_source(_StubConsumer(list(feed), stop),
                                            stop_event=stop, poll_timeout_s=0.01))
    seen = {kafka: [], jax_kafka: []}
    for module in (kafka, jax_kafka):
        stop = threading.Event()
        got = list(module.kafka_packet_source(
            _StubConsumer(list(feed), stop), stop_event=stop, poll_timeout_s=0.01,
            on_error=seen[module].append))
        assert got == [{"candid": 1}]
    assert seen[kafka] == seen[jax_kafka] == ["boom"]
    for module in (kafka, jax_kafka):
        with pytest.raises((EOFError, ValueError)):
            module.deserialize_packet(b"Obj\x01" + b"\x00" * 16)


def test_kafka_feed_through_the_port_daemon():
    """Stub feed → kafka_packet_source → AlertStreamConsumer (CPU, f32):
    every packet scored once, in order, as the scorer scores them directly."""
    config = atto_config()
    weights = state_dict_from_jax(config, flax_variables(config))
    scorer = serve.AlertStreamScorer(config, weights, batch_size=4,
                                     dtype=torch.float32, device="cpu")
    packets = list(synthetic_packets(6, META_COLS, seed=9, unique_stamps=True))
    wire = []
    for p in packets:
        w = {"candid": p["candid"], "candidate": p["candidate"]}
        for key in ("cutoutScience", "cutoutTemplate", "cutoutDifference"):
            w[key] = {"stampData": p[key]["stampData"].hex()}
        wire.append(_Msg(json.dumps(w).encode()))

    def deser(raw):
        p = json.loads(raw)
        for key in ("cutoutScience", "cutoutTemplate", "cutoutDifference"):
            p[key]["stampData"] = bytes.fromhex(p[key]["stampData"])
        return p

    stop = threading.Event()
    source = kafka.kafka_packet_source(_StubConsumer(wire, stop), deserialize=deser,
                                       stop_event=stop, poll_timeout_s=0.01)
    got = []
    consumer = serve.AlertStreamConsumer(
        scorer, source, sink=lambda pkts, scores, drop: got.extend(
            (p["candid"], float(s)) for p, s in zip(pkts, scores)),
        max_batch=4, max_wait_s=0.02)
    stats = consumer.run()
    assert stats["alerts_scored"] == 6
    assert [c for c, _ in got] == list(range(6))
    want, _ = scorer(packets)
    np.testing.assert_allclose([s for _, s in got], want, rtol=1e-6)
