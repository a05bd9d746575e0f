"""Kafka alert source: broker topic → packet iterator for the serving daemon.

Port of ``btsbot_tpu/data/kafka.py`` (standard library only; the Avro
codec is the port's copy, ``data/avro.py``).

The reference's production story hands an ONNX file to brokers that run
their own consumers (README.md:34-43); here scoring is in-process, so this
module adapts a Kafka consumer into the iterable/queue ``source`` that
``AlertStreamConsumer`` (engine/serve.py) drains — completing the
broker→scores path end to end:

    from confluent_kafka import Consumer
    consumer = Consumer({"bootstrap.servers": ..., "group.id": "btsbot"})
    consumer.subscribe(["ztf-alerts"])
    source = kafka_packet_source(consumer)
    AlertStreamConsumer(scorer, source, sink).run()

``confluent_kafka`` is a deployment-image dependency, not required here:
the consumer object is injectable (any object with ``poll(timeout)``
returning messages with ``error()``/``value()``).  The default deserializer
handles both JSON packets and ZTF's Avro OCF framing (magic ``Obj\\x01``)
with the in-repo dependency-free codec (data/avro.py) — no fastavro needed.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Iterator

AVRO_MAGIC = b"Obj\x01"


def deserialize_packet(raw: bytes) -> dict:
    """bytes → alert packet dict.

    ZTF distributes alerts as single-record Avro OCF files (magic
    ``Obj\\x01``, schema embedded); anything else is treated as JSON (the
    cli/serve wire format uses base64 fields inside JSON — those are left
    to the caller's deserialize hook).
    """
    if raw[:4] == AVRO_MAGIC:
        from .avro import read_ocf

        _, records = read_ocf(bytes(raw))
        if len(records) != 1:
            raise ValueError(
                f"expected 1 Avro record per alert message, got "
                f"{len(records)}")
        return records[0]
    return json.loads(raw)


def kafka_packet_source(
    consumer: Any,
    deserialize: Callable[[bytes], dict] = deserialize_packet,
    poll_timeout_s: float = 1.0,
    stop_event=None,
    on_error: Callable[[Any], None] | None = None,
) -> Iterator[dict]:
    """Iterate alert packets from a Kafka consumer until ``stop_event``.

    * ``consumer``: confluent_kafka.Consumer-like — needs only
      ``poll(timeout)``; messages need ``error()`` and ``value()``.
      (Injectable: tests and other brokers can pass any stub.)
    * idle polls (None) just continue — the serving daemon's adaptive
      batching handles gaps; a set ``stop_event`` ends the iterator, which
      ends ``AlertStreamConsumer.run()`` after the drain.
    * message-level errors go to ``on_error`` (default: raise RuntimeError)
      — partition EOFs should be filtered by the consumer config
      (``enable.partition.eof: false``, the confluent default).
    """
    while stop_event is None or not stop_event.is_set():
        msg = consumer.poll(poll_timeout_s)
        if msg is None:
            continue
        err = msg.error()
        if err:
            if on_error is not None:
                on_error(err)
                continue
            raise RuntimeError(f"Kafka consumer error: {err}")
        raw = msg.value()
        if raw is None:
            continue  # tombstone / compacted-topic record: nothing to score
        yield deserialize(raw)
