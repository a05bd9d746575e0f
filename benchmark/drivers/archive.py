"""Archive re-scoring: one caller scores host arrays through ``AlertScorer``.

A survey operator re-scores archived alerts from ``.npy`` arrays: a seeded
host pool of L2-normalised triplets and metadata, and calls of n alerts, n
log-uniform between the mix's ``call_min`` and ``call_max``, so most calls
end in a batch padded to a rung of the scorer's ladder.  Closed loop, one
caller: the next call starts when the last returns.  Every seed cycles
through the same ``call_sizes`` sizes in the same order, from a seeded
place in the cycle, each call at a seeded offset into the pool, so the work
of a window does not depend on the seed.

``score_alerts_per_s`` is the alerts scored over the whole window.  After
the window the plain float32 reference scores the pool, and every score the
window returned is compared with it as a logit (the largest and the mean
absolute gap, in units of the reference logits' spread); this covers the padding, every layer of the forward, the
sigmoid and the order of the scores.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness
from ..reference.mm_convnext import Reference


def call_sizes(traffic: dict, seed: int) -> np.ndarray:
    """The mix's cycle of call sizes: log-uniform quantiles in one fixed
    shuffled order, started at a seeded place in it."""
    k = int(traffic["call_sizes"])
    lo, hi = np.log(traffic["call_min"]), np.log(traffic["call_max"])
    sizes = np.rint(np.exp(lo + (np.arange(k) + 0.5) / k * (hi - lo))).astype(np.int64)
    sizes = sizes[np.random.default_rng(0).permutation(k)]
    return np.roll(sizes, -int(np.random.default_rng(seed).integers(k)))


class Cell:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.dtype = harness.DTYPES[ctx.cfg["serve_dtype"]]

    def setup(self) -> None:
        from btsbot_tpu_torch.engine.serve import AlertScorer

        ctx, cfg, traffic = self.ctx, self.cfg, self.ctx.traffic
        self.weights = harness.make_weights(cfg, ctx.seed, self.dtype, ctx.device)
        self.images, self.meta = harness.make_pool(
            traffic["pool_alerts"], len(cfg["model"]["metadata_cols"]), ctx.seed + 1,
            ctx.device)
        self.scorer = AlertScorer(cfg["model"], self.weights, batch_size=cfg["serve_batch"],
                                  dtype=self.dtype, normalize=False, device=ctx.device)
        for _ in range(2):
            for b in self.scorer.bucket_sizes:
                self.scorer(self.images[:b], self.meta[:b])
        self.sizes = call_sizes(traffic, ctx.seed)
        self.offsets = np.random.default_rng(ctx.seed + 2)

    def window(self, seconds: float, tw: harness.TraceWindow) -> dict:
        pool = len(self.images)
        rows = harness.RowCounter(self.scorer.model, tw)
        self.calls = []
        alerts = traced = 0
        tw.start()
        t0 = time.perf_counter()
        while True:
            n = int(self.sizes[len(self.calls) % len(self.sizes)])
            off = int(self.offsets.integers(0, pool - n + 1))
            with torch.profiler.record_function("archive.call"):
                scores = self.scorer(self.images[off:off + n], self.meta[off:off + n])
            self.calls.append((off, scores))
            alerts += n
            if tw.active:
                traced += n
            if tw.due():
                tw.stop()
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        rows.remove()
        return {"metrics": {"score_alerts_per_s": alerts / elapsed},
                "attempted": alerts, "failed": 0,
                "counters": {"forward_rows": rows.rows, "alerts_traced": traced}}

    def release(self) -> None:
        del self.scorer
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_logits(self, block: int = 2048) -> np.ndarray:
        """The float32 reference's logits for the whole pool, in blocks."""
        ref = Reference(self.cfg)
        p = {k: v.float() for k, v in self.weights.items()}
        out = []
        with torch.no_grad():
            for i in range(0, len(self.images), block):
                img = torch.from_numpy(self.images[i:i + block]).to(self.ctx.device)
                meta = torch.from_numpy(self.meta[i:i + block]).to(self.ctx.device)
                out.append(ref.logits(p, img, meta).double().cpu().numpy())
        return np.concatenate(out)

    def control_logits(self, images: np.ndarray, meta: np.ndarray) -> np.ndarray:
        """The control: the program's own int8 path (calibrated on the first
        512 alerts) in the place of its bf16 forward."""
        from btsbot_tpu_torch.ops.quantized import prepare_quantized, quantized_convnext_logits

        dev, bs = self.ctx.device, self.cfg["serve_batch"]
        state = {k: v.float() for k, v in self.weights.items()}
        q = prepare_quantized(state, self.cfg["model"], torch.from_numpy(images[:512]).to(dev),
                              device=dev)
        return np.concatenate([quantized_convnext_logits(
            q, torch.from_numpy(images[i:i + bs]).to(dev),
            torch.from_numpy(meta[i:i + bs]).to(dev)).double().cpu().numpy()
            for i in range(0, len(images), bs)])

    def control(self) -> list[harness.Check]:
        with harness.tf32_off():
            ref = self.reference_logits()
        gaps = np.abs(self.control_logits(self.images, self.meta) - ref)
        return harness.logit_gap_checks(gaps, ref.std(), self.cfg["limits"]["archive"])

    def checks(self) -> list[harness.Check]:
        with harness.tf32_off():
            ref = self.reference_logits()
        gaps = np.concatenate([np.abs(harness.logits_of(s) - ref[off:off + len(s)])
                               for off, s in self.calls])
        return harness.logit_gap_checks(gaps, ref.std(), self.cfg["limits"]["archive"])
