"""Batched alert serving on the card (port of btsbot_tpu.engine.serve).

* ``AlertScorer`` — triplet (and metadata) arrays → scores, in padded
  batches drawn from a bucket ladder, with a calibration temperature;
* ``AlertStreamScorer`` — raw alert packets → scores: the native stamp
  decode on the host, then ingest, the forward and the sigmoid on the card,
  with one packed (2, B) result per batch (scores, corrupt flag) and a
  pipelined ``score_stream``;
* ``verify_serving_parity`` — bf16 serving scores against the float32 ones.

Every ported family is served: an image-only model takes no metadata, a
metadata-only one no triplets (and its stream decodes no stamps).  Eager
PyTorch under ``torch.inference_mode``: the model's ConvNeXt blocks run in
the CUDA block kernel, the InceptionNeXt blocks' LN → MLP halves in
``fused_ln_mlp``.  Both scorers run on the CUDA card unless
``device="cpu"`` is passed, and raise without a card.
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


def _bucket_ladder(batch_size: int, bucket_sizes=None) -> list[int]:
    """Sorted padded-batch ladder ending at batch_size: by default
    batch_size, /4, /16 (floor 64)."""
    if bucket_sizes is None:
        ladder, b = [], batch_size
        while b >= 64 and len(ladder) < 3:
            ladder.append(b)
            b //= 4
    else:
        ladder = [int(b) for b in bucket_sizes]
    return sorted({b for b in ladder if 0 < b <= batch_size} | {batch_size})


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


def _padded_on(rows: np.ndarray, bs: int, device) -> torch.Tensor:
    """rows as float32 on ``device``, zero-padded to bs rows."""
    if len(rows) == bs:
        out = np.ascontiguousarray(rows, dtype=np.float32)
    else:
        out = np.zeros((bs,) + rows.shape[1:], np.float32)
        out[:len(rows)] = rows
    return torch.from_numpy(out).to(device)


class AlertScorer:
    """Fixed-batch scorer: pads the tail, returns scores in input order.

    normalize=True applies the per-cutout L2 norm on the card (for raw cutout
    stacks); leave False for pre-normalised training data."""

    def __init__(self, config, weights: Mapping, batch_size: int = 3072,
                 dtype=torch.bfloat16, normalize: bool = False, bucket_sizes=None,
                 temperature: float = 1.0, device=None):
        """bucket_sizes: padded-batch ladder for partial batches (default
        [batch_size/16, batch_size/4, batch_size], floor 64): a partial batch
        pads to the smallest bucket that fits.  temperature: calibration
        temperature applied to the logits."""
        self.config = normalize_config(config)
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.bucket_sizes = _bucket_ladder(batch_size, bucket_sizes)
        self.temperature = float(temperature)
        self.dtype = dtype
        self.normalize = normalize
        self.model = load_model(self.config, weights, dtype, self.device)

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
        for start in range(0, n, self.batch_size):
            stop = min(start + self.batch_size, n)
            bs = _pick_bucket(self.bucket_sizes, stop - start)
            out[start:stop] = self._score(*(
                None if rows is None else _padded_on(rows[start:stop], bs, self.device)
                for rows in (triplets, metadata)))[:stop - start].cpu().numpy()
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
                 dtype=torch.bfloat16, num_threads: int = 0, bucket_sizes=None,
                 temperature: float = 1.0, device=None):
        """num_threads: host decode threads (0: one per core).  bucket_sizes,
        temperature: as for AlertScorer."""
        self.config = normalize_config(config)
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.bucket_sizes = _bucket_ladder(batch_size, bucket_sizes)
        self.temperature = float(temperature)
        self.dtype = dtype
        self.num_threads = num_threads
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
        return self._fwd(*(None if rows is None else _padded_on(rows[:n], bs, self.device)
                           for rows in (triplets, metadata)))

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
            self._fwd(*example_inputs(self.config, bs, device=self.device))
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
