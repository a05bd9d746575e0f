"""Archive re-scoring with mm_MaxViT: ``archive``'s cell on another model.

The same caller, call sizes, window and comparison as ``archive.py``; what
differs is the model's weights (``make_weights`` over
``reference.mm_maxvit.param_spec``), its plain reference and its control:

* weights: the harness's recipe (``harness.make_weights``) over this
  model's entries, bias tables N(0, 1) as trained tables spread (a lost or
  misplaced bias moves the scores), and the backbone's BatchNorm
  statistics set from a seeded batch of alerts (``mm_maxvit.calibrate``):
  the recipe's N(0, 1) means would drown the L2-normalised cutouts (pixels
  ~1/63) at the stem, and no input would move a score; and the logit's
  layer shifted and scaled so that batch's logits have mean 0 and spread
  ``mm_maxvit.LOGIT_STD`` (uncentred, the logits sat near 14, where a
  float32 sigmoid and a bfloat16 logit resolve ~0.06; unscaled, some
  spread to 19, past the 16.6 above which a float32 sigmoid reads 1);
* reference: ``reference.mm_maxvit`` in float32, TF32 off, in blocks of 64
  alerts (a stage-0 MBConv map of 64 alerts at 224 is 0.8 GB);
* control: the same reference with every product's and convolution's
  operands rounded to 4 explicit mantissa bits, the nearest precision
  below the bfloat16 the configuration states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import harness
from ..reference.mm_maxvit import Reference, calibrate, param_spec
from . import archive

CALIBRATION_ALERTS = 64
REFERENCE_BLOCK = 64
CONTROL_MANTISSA = 4


def make_weights(cfg: dict, seed: int, dtype: torch.dtype, device) -> dict:
    """A program-named state dict drawn on ``device`` from ``seed`` by the
    harness's recipe (``harness.make_weights``), bias tables N(0, 1), then
    the backbone's BatchNorm statistics calibrated on a seeded batch, in the
    type it is served in."""
    spec = param_spec(cfg)
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    z = torch.randn(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for (name, shape, kind, fan), n in zip(spec, sizes):
        uu, zz = u[off:off + n].view(shape), z[off:off + n].view(shape)
        off += n
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        t = {"w": lambda: uu * math.sqrt(6 / fan), "b": lambda: uu / math.sqrt(fan),
             "w_out": lambda: uu / math.sqrt(fan),
             "ln_w": lambda: torch.exp(harness.LN_SIGMA * zz), "ln_b": lambda: 0.1 * zz,
             "bn_w": lambda: 1 + 0.1 * zz, "bn_b": lambda: 0.1 * zz, "bn_mean": lambda: zz,
             "bn_var": lambda: 1.25 + 0.75 * uu, "table": lambda: zz}[kind]()
        out[name] = t.to(dtype).contiguous()
    images, meta = harness.make_pool(CALIBRATION_ALERTS, len(cfg["model"]["metadata_cols"]),
                                     seed + 3, device)
    p = {k: v.float() for k, v in out.items()}
    with harness.tf32_off():
        stats = calibrate(cfg, p, torch.from_numpy(images).to(device),
                          torch.from_numpy(meta).to(device))
    out.update({k: v.to(dtype).contiguous() for k, v in stats.items()})
    return out


class Cell(archive.Cell):
    def setup(self) -> None:
        from btsbot_tpu_torch.engine.serve import AlertScorer

        ctx, cfg, traffic = self.ctx, self.cfg, self.ctx.traffic
        self.weights = make_weights(cfg, ctx.seed, self.dtype, ctx.device)
        self.images, self.meta = harness.make_pool(
            traffic["pool_alerts"], len(cfg["model"]["metadata_cols"]), ctx.seed + 1,
            ctx.device)
        self.scorer = AlertScorer(cfg["model"], self.weights, batch_size=cfg["serve_batch"],
                                  dtype=self.dtype, normalize=False, device=ctx.device)
        for _ in range(2):
            for b in self.scorer.bucket_sizes:
                self.scorer(self.images[:b], self.meta[:b])
        self.sizes = archive.call_sizes(traffic, ctx.seed)
        self.offsets = np.random.default_rng(ctx.seed + 2)

    def reference_logits(self, block: int = REFERENCE_BLOCK, mantissa=None) -> np.ndarray:
        """The float32 reference's logits for the whole pool, in blocks
        (``mantissa``: the control's operands); the float32 ones once a cell."""
        if mantissa is None and getattr(self, "_ref", None) is not None:
            return self._ref
        ref = Reference(self.cfg, mantissa)
        p = {k: v.float() for k, v in self.weights.items()}
        out = []
        with torch.no_grad():
            for i in range(0, len(self.images), block):
                img = torch.from_numpy(self.images[i:i + block]).to(self.ctx.device)
                meta = torch.from_numpy(self.meta[i:i + block]).to(self.ctx.device)
                out.append(ref.logits(p, img, meta).double().cpu().numpy())
        out = np.concatenate(out)
        if mantissa is None:
            self._ref = out
        return out

    def control(self) -> list[harness.Check]:
        with harness.tf32_off():
            ref = self.reference_logits()
            low = self.reference_logits(mantissa=CONTROL_MANTISSA)
        return harness.logit_gap_checks(np.abs(low - ref), ref.std(),
                                        self.cfg["limits"]["archive"])
