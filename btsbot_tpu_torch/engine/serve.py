"""Batched alert serving on the card (port of btsbot_tpu.engine.serve).

* ``AlertScorer`` — triplet (and metadata) arrays → scores, in padded
  batches drawn from a bucket ladder, with a calibration temperature;
* ``AlertStreamScorer`` — raw alert packets → scores: the native stamp
  decode on the host, then ingest, the forward and the sigmoid on the card,
  with one packed (2, B) result per batch (scores, corrupt flag) and a
  pipelined ``score_stream``; its pixels may cross to the card in
  bfloat16 (``transfer_dtype``);
* ``AlertStreamConsumer`` — the broker daemon over it: adaptive batching,
  backpressure, a decode thread, the idle drain, latency percentiles and a
  score histogram (``cli/serve.py`` runs it as a process);
* ``verify_serving_parity`` — bf16 serving scores against the float32 ones.

Every ported family is served: an image-only model takes no metadata, a
metadata-only one no triplets (and its stream decodes no stamps).  Eager
PyTorch under ``torch.inference_mode``: the model's ConvNeXt blocks run in
the CUDA block kernel, the InceptionNeXt blocks' LN → MLP halves in
``fused_ln_mlp``.  Both scorers run on the CUDA card unless
``device="cpu"`` is passed, and raise without a card.

``AlertScorer(mesh=)`` (JAX serve.py:29-50, 89-118) serves over a
(data, model) mesh (parallel.mesh): every rank passes the same host
arrays, scores its rows of each padded batch with the big weights sharded
on the model axis, and gets all ``n`` scores back, gathered in order, as
the JAX package's single-controller call returns them.  Every bucket of
its ladder splits over the data axis: buckets that do not are dropped, and
a ``batch_size`` that does not raises.  The stream scorer and the daemon
take no mesh, as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Mapping

import numpy as np
import torch

from ..core.config import normalize_config
from ..core.device import resolve_device
from ..models.factory import build_model, example_inputs
from ..ops.preprocess import l2_normalize_cutouts, preprocess_triplets
from ..parallel.mesh import all_gather_rows, batch_sharding
from ..parallel.sharding import shard_module


def _bucket_ladder(batch_size: int, bucket_sizes=None, mesh=None) -> list[int]:
    """Sorted padded-batch ladder ending at batch_size: by default
    batch_size, /4, /16 (floor 64).  Under a mesh every bucket splits
    evenly on the "data" axis; the others are dropped (batch_size, which
    must split, is always kept)."""
    if bucket_sizes is None:
        ladder, b = [], batch_size
        while b >= 64 and len(ladder) < 3:
            ladder.append(b)
            b //= 4
    else:
        ladder = [int(b) for b in bucket_sizes]
    ladder = sorted({b for b in ladder if 0 < b <= batch_size} | {batch_size})
    if mesh is not None:
        d = int(mesh.shape.get("data", 1))
        if batch_size % d != 0:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by the mesh data axis "
                f"({d}): each rank scores an equal share of every batch")
        ladder = [b for b in ladder if b % d == 0]
    return ladder


def _pick_bucket(ladder: list[int], n: int) -> int:
    for b in ladder:
        if b >= n:
            return b
    return ladder[-1]


def _gather_metadata(packets: list[dict], cols) -> np.ndarray:
    """Per-alert metadata gather that survives malformed messages: a missing
    ``candidate`` dict, a non-numeric value or a non-finite float gives 0.0
    for that cell."""
    rows = np.zeros((len(packets), len(cols)), np.float32)
    for i, p in enumerate(packets):
        cand = p.get("candidate")
        if not isinstance(cand, dict):
            continue
        for j, c in enumerate(cols):
            try:
                v = float(cand.get(c, 0.0))
            except (TypeError, ValueError):
                continue
            if np.isfinite(v):
                rows[i, j] = v
    return rows


def load_model(config, weights: Mapping, dtype, device):
    """The config's model in eval mode on ``device`` in ``dtype``, holding
    ``weights`` (a reference-named state dict of arrays or tensors), loaded
    with ``strict=True``."""
    model = build_model(config, dtype=dtype, device=device)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()},
                          strict=True)
    return model


def _padded_on(rows: np.ndarray, bs: int, device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """rows zero-padded to bs rows, on ``device`` in ``dtype``.  A narrower
    type (bfloat16) is cast on the host, round to nearest even, so only its
    bytes cross to the card."""
    if len(rows) == bs:
        out = np.ascontiguousarray(rows, dtype=np.float32)
    else:
        out = np.zeros((bs,) + rows.shape[1:], np.float32)
        out[:len(rows)] = rows
    host = torch.from_numpy(out)
    if dtype != torch.float32:
        host = host.to(dtype)
    return host.to(device)


class AlertScorer:
    """Fixed-batch scorer: pads the tail, returns scores in input order.

    normalize=True applies the per-cutout L2 norm on the card (for raw cutout
    stacks); leave False for pre-normalised training data."""

    def __init__(self, config, weights: Mapping, batch_size: int = 3072,
                 dtype=torch.bfloat16, normalize: bool = False, bucket_sizes=None,
                 temperature: float = 1.0, device=None, mesh=None):
        """bucket_sizes: padded-batch ladder for partial batches (default
        [batch_size/16, batch_size/4, batch_size], floor 64): a partial batch
        pads to the smallest bucket that fits.  temperature: calibration
        temperature applied to the logits.  mesh: serve over a (data, model)
        mesh (see the module doc); the device defaults to this rank's card."""
        self.config = normalize_config(config)
        self.device = resolve_device(device, mesh)
        self.batch_size = batch_size
        self.bucket_sizes = _bucket_ladder(batch_size, bucket_sizes, mesh)
        self.temperature = float(temperature)
        self.dtype = dtype
        self.normalize = normalize
        self.mesh = mesh
        self.model = shard_module(load_model(self.config, weights, dtype, self.device), mesh)

    @torch.inference_mode()
    def _score(self, images: torch.Tensor | None,
               metadata: torch.Tensor | None) -> torch.Tensor:
        """(B,) float32 scores on the card for device-resident inputs (None
        for a modality the model does not take)."""
        if images is not None:
            images = images.to(self.dtype)
            if self.normalize:
                images = l2_normalize_cutouts(images)
        if metadata is not None:
            metadata = metadata.to(self.dtype)
        logits = self.model(images, metadata)
        z = logits.reshape(-1).float()
        if self.temperature != 1.0:
            z = z / self.temperature
        return torch.sigmoid(z)

    def __call__(self, triplets=None, metadata=None) -> np.ndarray:
        """Scores for ``triplets`` (N, 63, 63, 3) and ``metadata`` (N,
        n_cols); an image-only model takes ``metadata=None``, a
        metadata-only one ``triplets=None``."""
        triplets = triplets if self.config.need_triplets else None
        metadata = metadata if self.config.need_metadata else None
        n = len(triplets) if triplets is not None else len(metadata)
        out = np.empty(n, np.float32)
        share = None if self.mesh is None else batch_sharding(self.mesh)
        for start in range(0, n, self.batch_size):
            stop = min(start + self.batch_size, n)
            bs = _pick_bucket(self.bucket_sizes, stop - start)
            if share is None:
                scores = self._score(*(
                    None if rows is None else _padded_on(rows[start:stop], bs, self.device)
                    for rows in (triplets, metadata)))
            else:  # this rank's rows of the padded batch, then every rank's scores
                take = share.rows(bs)
                scores = all_gather_rows(self._score(*(
                    None if rows is None else
                    _padded_on(rows[start:stop][take], take.stop - take.start, self.device)
                    for rows in (triplets, metadata))), self.mesh.data_group,
                    self.mesh.shape["data"])
            out[start:stop] = scores[:stop - start].cpu().numpy()
        return out

    def throughput(self, iters: int = 20) -> float:
        """alerts/s of the forward on device-resident random inputs at
        batch_size (host clock around ``iters`` batches, synchronised)."""
        g = torch.Generator(device="cpu").manual_seed(0)
        s = int(self.config.get("image_size", 63))
        images = meta = None
        if self.config.need_triplets:
            images = torch.randn(self.batch_size, s, s, 3, generator=g).to(self.device)
        if self.config.need_metadata:
            meta = torch.randn(self.batch_size, len(self.config["metadata_cols"]),
                               generator=g).to(self.device)
        self._score(images, meta)
        _sync(self.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            self._score(images, meta)
        _sync(self.device)
        return self.batch_size * iters / (time.perf_counter() - t0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class AlertStreamScorer:
    """Raw-packet serving: gzip FITS cutout blobs → scores, end to end.

    The host decodes the stamps (native decoder, multithreaded) and gathers
    the metadata; the card runs the ingest (NaN clean, per-cutout L2 norm,
    corrupt mask), the forward and the sigmoid, and returns one packed (2, B)
    tensor per batch, so a batch costs one transfer each way.

    ``score_stream`` pipelines batches: while the card scores batch i, a host
    thread decodes batch i+1 (the native decoder releases the GIL).
    """

    def __init__(self, config, weights: Mapping, batch_size: int = 3072,
                 dtype=torch.bfloat16, num_threads: int = 0, transfer_dtype=None,
                 bucket_sizes=None, temperature: float = 1.0, device=None):
        """num_threads: host decode threads (0: one per core).
        transfer_dtype: a narrower type (torch.bfloat16) for the pixels'
        host → card copy, which halves its bytes at bf16's rounding of the
        raw pixels (the scores already run in bf16); the ingest still runs in
        float32 on the card, and the metadata always crosses as float32.
        None (the default) ships float32 pixels.  bucket_sizes, temperature:
        as for AlertScorer."""
        self.config = normalize_config(config)
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.bucket_sizes = _bucket_ladder(batch_size, bucket_sizes)
        self.temperature = float(temperature)
        self.dtype = dtype
        self.num_threads = num_threads
        self.transfer_dtype = transfer_dtype
        self.model = load_model(self.config, weights, dtype, self.device)

    @torch.inference_mode()
    def _fwd(self, raw_triplets: torch.Tensor | None,
             metadata: torch.Tensor | None) -> torch.Tensor:
        imgs = corrupt = None
        if raw_triplets is not None:
            imgs, corrupt = preprocess_triplets(raw_triplets.float())
            imgs = imgs.to(self.dtype)
        if metadata is not None:
            metadata = metadata.to(self.dtype)
        logits = self.model(imgs, metadata)
        z = logits.reshape(-1).float()
        if self.temperature != 1.0:
            z = z / self.temperature
        if corrupt is None:  # metadata-only model: nothing to be corrupt
            corrupt = torch.zeros_like(z)
        return torch.stack([torch.sigmoid(z), corrupt.float()])

    # ------------------------- pipeline stages -------------------------

    def _prepare(self, packets: list[dict]):
        """Host stage: decode the blobs and gather the metadata columns.
        Returns (raw_triplets (N, 63, 63, 3), metadata, decode_bad), None
        for a modality the model does not take; a metadata-only model
        decodes no stamps (its packets need no cutouts)."""
        from ..native import decode_stamps

        n = len(packets)
        metadata = None
        if self.config.need_metadata:
            metadata = _gather_metadata(packets, self.config["metadata_cols"])
        if not self.config.need_triplets:
            return None, metadata, np.zeros(n, bool)
        blobs: list[bytes] = []
        for p in packets:
            for key in ("cutoutScience", "cutoutTemplate", "cutoutDifference"):
                # a missing cutout drops that alert: an empty blob fails decode
                cutout = p.get(key) or {}
                blob = cutout.get("stampData") if isinstance(cutout, dict) else None
                blobs.append(blob if isinstance(blob, (bytes, bytearray)) else b"")
        stamps, status = decode_stamps(blobs, num_threads=self.num_threads)
        triplets = np.ascontiguousarray(
            stamps.reshape(n, 3, 63, 63).transpose(0, 2, 3, 1))
        decode_bad = status.reshape(n, 3).any(axis=1)
        return triplets, metadata, decode_bad

    def _dispatch(self, triplets, metadata, n: int) -> torch.Tensor:
        """Card stage: pad to the smallest fitting bucket and launch the
        ingest + forward.  Returns the packed (2, bucket) tensor, still being
        computed."""
        bs = _pick_bucket(self.bucket_sizes, n)
        img = meta = None
        if triplets is not None:
            img = _padded_on(triplets[:n], bs, self.device,
                             self.transfer_dtype or torch.float32)
        if metadata is not None:
            meta = _padded_on(metadata[:n], bs, self.device)
        return self._fwd(img, meta)

    @staticmethod
    def _finish(packed_dev: torch.Tensor, decode_bad, n: int):
        packed = packed_dev.cpu().numpy()  # one readback per batch
        scores = packed[0, :n]
        drop = (packed[1, :n] > 0.5) | decode_bad[:n]
        return np.where(drop, np.nan, scores), drop

    # ------------------------------ APIs ------------------------------

    def warmup(self) -> None:
        """Run every bucket once, so the first partial batch of a stream
        pays no first-call cost (kernel build, library handles)."""
        for bs in self.bucket_sizes:
            img, meta = example_inputs(self.config, bs, device=self.device)
            if img is not None and self.transfer_dtype is not None:
                img = img.to(self.transfer_dtype)
            self._fwd(img, meta)
        _sync(self.device)

    def __call__(self, packets: list[dict]) -> tuple[np.ndarray, np.ndarray]:
        """Returns (scores (N,), drop mask (N,)); scores are NaN where the
        alert was dropped as corrupt or undecodable."""
        bs = self.batch_size
        chunks = [packets[i:i + bs] for i in range(0, len(packets), bs)]
        results = list(self.score_stream(chunks))
        if not results:
            return np.empty(0, np.float32), np.empty(0, bool)
        return (np.concatenate([s for s, _ in results]),
                np.concatenate([d for _, d in results]))

    def score_stream(self, packet_batches, max_in_flight: int = 2):
        """Pipelined scoring over an iterable of packet lists (each ≤
        batch_size).  Yields (scores, drop) per input batch, in order.

        A background thread runs the host decode (``_prepare``); this thread
        pads, transfers and launches (``_dispatch``), and keeps up to
        ``max_in_flight`` batches on the card while the oldest is read back.
        The bounded queue and the in-flight window apply backpressure: the
        input iterable advances only as fast as results drain."""
        import queue as _queue
        import threading
        from collections import deque

        prepared: _queue.Queue = _queue.Queue(maxsize=max(1, max_in_flight))
        decode_error: list[BaseException] = []
        abandoned = threading.Event()

        def put_or_abandon(item) -> bool:
            # bounded waits, so an abandoned generator cannot strand the thread
            while not abandoned.is_set():
                try:
                    prepared.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    continue
            return False

        def decode_worker():
            try:
                for packets in packet_batches:
                    if len(packets) > self.batch_size:
                        raise ValueError(
                            f"stream batch of {len(packets)} exceeds "
                            f"batch_size {self.batch_size}")
                    if not put_or_abandon((packets, self._prepare(packets))):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                decode_error.append(e)
            finally:
                put_or_abandon(None)

        worker = threading.Thread(target=decode_worker, daemon=True)
        worker.start()

        inflight: deque = deque()
        try:
            while True:
                item = prepared.get()
                if item is None:
                    break
                packets, (triplets, metadata, decode_bad) = item
                packed = self._dispatch(triplets, metadata, len(packets))
                inflight.append((packed, decode_bad, len(packets)))
                if len(inflight) >= max_in_flight:
                    yield self._finish(*inflight.popleft())
            while inflight:
                yield self._finish(*inflight.popleft())
            worker.join()
            if decode_error:
                raise decode_error[0]
        finally:
            abandoned.set()


class AlertStreamConsumer:
    """Long-running broker consumer daemon over an ``AlertStreamScorer``
    (port of btsbot_tpu.engine.serve.AlertStreamConsumer).

    Pulls alert packets from a source, batches them adaptively (a batch is
    flushed at ``max_batch`` packets or ``max_wait_s`` after its first
    packet), scores them through the scorer's pipeline stages and hands the
    results to a sink.

    * source: an iterable of packets, or a ``queue.Queue`` fed by the broker
      (``None`` in the queue ends the stream after the drain).
    * sink: ``sink(packets, scores, drop)`` per scored batch.
    * backpressure: at most ``max_in_flight`` batches on the card plus one
      decoded and one collected batch are held; the bounded feeder queue (or
      a bounded queue source) blocks the broker when scoring falls behind.
    * stats: alerts in / scored / dropped, batches, wall time, alerts/s, the
      p50 / p99 of each batch's latency from its first packet's arrival to
      its results, and a 20-bin histogram of the kept scores (the cheap
      drift signal); every ``stats_interval_s`` a JSON line to
      ``stats_log``.
    """

    def __init__(self, scorer: AlertStreamScorer, source, sink,
                 max_batch: int | None = None, max_wait_s: float = 0.1,
                 max_in_flight: int = 2, stats_interval_s: float = 0.0,
                 stats_log=None):
        """stats_interval_s > 0 emits a JSON stats line to ``stats_log``
        (default: print) at most every interval while consuming."""
        import queue as _queue
        import threading
        from collections import deque

        self.scorer = scorer
        self.sink = sink
        self.max_batch = min(max_batch or scorer.batch_size, scorer.batch_size)
        self.max_wait_s = max_wait_s
        self.max_in_flight = max_in_flight
        self.stats_interval_s = stats_interval_s
        self.stats_log = stats_log or print
        self._last_stats_emit = 0.0
        self.stats = {"alerts_in": 0, "alerts_scored": 0, "dropped": 0,
                      "batches": 0, "wall_s": 0.0, "alerts_per_s": 0.0}
        # a batch is stamped when its first packet is collected, so its
        # latency is its worst alert's: the batching wait, decode, copy,
        # forward and readback
        self._latencies: deque = deque(maxlen=8192)
        # edges 0.0, 0.05, ..., 1.0
        self._score_hist = np.zeros(20, np.int64)
        self._source_error: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._done = False

        if isinstance(source, _queue.Queue):
            self._queue = source
        else:
            # an iterable goes through a bounded feeder queue (backpressure);
            # puts poll the stop flag, so stop() never strands the feeder
            self._queue = _queue.Queue(maxsize=4 * self.max_batch)

            def put_or_stop(item) -> bool:
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.2)
                        return True
                    except _queue.Full:
                        continue
                return False

            def feed(it):
                # a source that raises still delivers the sentinel, or run()
                # would poll an empty queue for ever; run() re-raises it
                try:
                    for p in it:
                        if not put_or_stop(p):
                            return
                except BaseException as e:  # noqa: BLE001 — re-raised in run()
                    self._source_error = e
                finally:
                    put_or_stop(None)

            self._feeder = threading.Thread(target=feed, args=(source,),
                                            daemon=True, name="alert-consumer-feed")
            self._feeder.start()

    def _collect_batch(self, idle_poll_s: float = 0.05):
        """One adaptive batch: (packets, first arrival on the monotonic
        clock) with up to max_batch packets (a partial batch flushes
        max_wait_s after its first packet), ``([], None)`` when the source is
        idle (so the caller drains the results in flight), None at the end."""
        import queue as _queue

        if self._done:
            return None
        batch: list = []
        first_ts = None
        deadline = None
        while len(batch) < self.max_batch:
            if self._stop.is_set():
                return (batch, first_ts) if batch else None
            timeout = idle_poll_s if deadline is None \
                else max(0.0, deadline - time.monotonic())
            try:
                item = self._queue.get(timeout=timeout)
            except _queue.Empty:
                if batch:
                    break  # max_wait_s after the first packet: flush
                return [], None  # idle: let the caller drain the pipeline
            if item is None:
                self._done = True
                break
            batch.append(item)
            if deadline is None:
                first_ts = time.monotonic()
                deadline = first_ts + self.max_wait_s
        if self._done and not batch:
            return None
        return batch, first_ts

    def _latency_stats(self) -> None:
        if self._latencies:
            p50, p99 = np.percentile(np.asarray(self._latencies), [50, 99])
            self.stats["latency_p50_ms"] = round(float(p50) * 1000, 2)
            self.stats["latency_p99_ms"] = round(float(p99) * 1000, 2)

    def run(self) -> dict:
        """Consume until the source ends (or stop()); returns the stats.

        A background thread decodes collected batches (the native decoder
        releases the GIL); this thread pads, copies and launches them and
        reads results back, with up to ``max_in_flight`` batches on the card.
        When the source goes idle, the batches in flight are finished at
        once instead of waiting for more input.

        Not built on ``score_stream``: that generator holds results until
        its in-flight window fills, which suits a fixed run, while a daemon
        must drain the moment the source goes idle, or trickle traffic pays
        max_in_flight · max_wait_s more latency.  A fix to one pipeline's
        shutdown or backpressure should be checked against the other.
        """
        import json
        import queue as _queue
        import threading
        from collections import deque

        t0 = time.perf_counter()
        self._done = False
        inflight: deque = deque()
        raw_q: _queue.Queue = _queue.Queue(maxsize=1)
        ready_q: _queue.Queue = _queue.Queue(maxsize=max(1, self.max_in_flight))
        decode_error: list[BaseException] = []

        def decode_worker():
            try:
                while True:
                    item = raw_q.get()
                    if item is None:
                        break
                    batch, ts = item
                    ready_q.put((batch, ts, self.scorer._prepare(batch)))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                decode_error.append(e)
            finally:
                ready_q.put(None)

        worker = threading.Thread(target=decode_worker, daemon=True,
                                  name="alert-consumer-decode")
        worker.start()

        def finish_oldest():
            packets, ts, packed, decode_bad = inflight.popleft()
            scores, drop = self.scorer._finish(packed, decode_bad, len(packets))
            self.stats["alerts_scored"] += len(scores)
            self.stats["dropped"] += int(drop.sum())
            self.stats["batches"] += 1
            if ts is not None:
                self._latencies.append(time.monotonic() - ts)
            kept = scores[~drop]
            if kept.size:
                self._score_hist += np.bincount(
                    np.clip((kept * 20).astype(np.int64), 0, 19), minlength=20)
                self.stats["score_hist"] = self._score_hist.tolist()
            self.sink(packets, scores, drop)
            if self.stats_interval_s > 0:
                now = time.monotonic()
                if now - self._last_stats_emit >= self.stats_interval_s:
                    self._last_stats_emit = now
                    wall = time.perf_counter() - t0
                    self._latency_stats()
                    self.stats_log(json.dumps({
                        **self.stats, "wall_s": round(wall, 3),
                        "alerts_per_s": round(
                            self.stats["alerts_scored"] / max(wall, 1e-9), 1)}))

        def drain_ready(block: bool) -> bool:
            """Launch decoded batches; False once the decoder has signalled
            the end of the stream."""
            while True:
                try:
                    item = ready_q.get(block=block, timeout=10.0 if block else None)
                except _queue.Empty:
                    return True
                if item is None:
                    return False
                batch, ts, prep = item
                packed = self.scorer._dispatch(prep[0], prep[1], len(batch))
                inflight.append((batch, ts, packed, prep[2]))
                if len(inflight) >= self.max_in_flight:
                    finish_oldest()
                block = False  # a blocking drain waits for the first item only

        decoding = True
        try:
            while True:
                collected = self._collect_batch()
                if collected is None:
                    break
                batch, ts = collected
                if batch:
                    self.stats["alerts_in"] += len(batch)
                    while decoding:
                        # never block on the decoder with results undrained:
                        # alternating put and drain avoids a deadlock of full
                        # queues
                        decoding = drain_ready(block=False)
                        try:
                            raw_q.put((batch, ts), timeout=0.05)
                            break
                        except _queue.Full:
                            continue
                else:
                    decoding = drain_ready(block=False) and decoding
                    if inflight:
                        finish_oldest()
                if not decoding:
                    break  # the decoder died mid-stream: its error below

            # the decoder's sentinel; it may still be busy with the last batch
            # (raw_q full), so keep draining results while waiting
            while decoding:
                try:
                    raw_q.put(None, timeout=0.05)
                    break
                except _queue.Full:
                    decoding = drain_ready(block=False) and decoding
            while decoding:
                decoding = drain_ready(block=True)
            while inflight:
                finish_oldest()
            worker.join()
        finally:
            # an exception above (the sink or a launch raising) must not
            # strand the decoder on raw_q.get() or ready_q.put()
            while worker.is_alive():
                try:
                    raw_q.put_nowait(None)
                except _queue.Full:
                    pass
                try:
                    ready_q.get(timeout=0.05)
                except _queue.Empty:
                    pass
            worker.join()

        self.stats["wall_s"] = time.perf_counter() - t0
        if self.stats["wall_s"] > 0:
            self.stats["alerts_per_s"] = \
                self.stats["alerts_scored"] / self.stats["wall_s"]
        self._latency_stats()
        if decode_error:
            raise decode_error[0]
        if self._source_error is not None:
            raise RuntimeError(
                "alert source failed mid-stream (scored "
                f"{self.stats['alerts_scored']} before the failure)"
            ) from self._source_error
        return self.stats

    def start(self) -> None:
        """Run the consumer loop in a background daemon thread.  An exception
        of run() (a source failing mid-stream) is re-raised by stop()."""
        import threading

        self._run_error: BaseException | None = None

        def target():
            try:
                self.run()
            except BaseException as e:  # noqa: BLE001 — re-raised in stop()
                self._run_error = e

        self._thread = threading.Thread(target=target, daemon=True,
                                        name="alert-consumer")
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> dict:
        """Signal shutdown, drain the work in flight, join, return the stats.
        Re-raises the exception the background loop died with; raises
        TimeoutError if it has not drained within ``timeout`` seconds."""
        import json

        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"consumer did not drain within {timeout}s (stats so far: "
                    f"{json.dumps(self.stats)}); call stop() again with a "
                    "longer timeout")
        err = getattr(self, "_run_error", None)
        if err is not None:
            raise RuntimeError(
                f"background consumer failed (stats: {json.dumps(self.stats)})"
            ) from err
        return self.stats


def verify_serving_parity(config, weights, triplets=None, metadata=None,
                          rtol: float = 1e-2, atol: float = 5e-3, device=None) -> dict:
    """bf16 serving scores against float32 ones on the same weights (None
    for a modality the model does not take).
    Returns {'close': bool, 'max_diff': float}."""
    bs = max(1, len(triplets if triplets is not None else metadata))
    s_bf16 = AlertScorer(config, weights, batch_size=bs, device=device)(triplets, metadata)
    s_f32 = AlertScorer(config, weights, batch_size=bs, dtype=torch.float32,
                        device=device)(triplets, metadata)
    max_diff = float(np.max(np.abs(s_bf16 - s_f32))) if len(s_f32) else 0.0
    return {"close": bool(np.allclose(s_bf16, s_f32, rtol=rtol, atol=atol)),
            "max_diff": max_diff}
