"""Archive re-scoring with mm_MaxViT over a MaxxViT backbone:
``archive_maxvit``'s cell on another backbone.

The same caller, call sizes, window, comparison and control as
``archive_maxvit.py``; what differs is the weights and the reference:

* weights: the harness's recipe over ``reference.mm_maxxvit.param_spec``
  (every LayerScale γ N(0, 0.5²), as the ConvNeXt cells draw γ: timm's
  1e-6 would make every branch vanish); each attention half's table MLP's
  last layer scaled so its table spreads ``mm_maxxvit.TABLE_STD`` over the
  offsets, as mm_MaxViT's N(0, 1) tables spread (``table_scales``); and the
  logit's layer shifted and scaled so a seeded batch's logits have mean 0
  and spread ``LOGIT_STD`` (``mm_maxxvit.calibrate``).  The backbone has
  no BatchNorm, so nothing else is calibrated;
* reference: ``reference.mm_maxxvit`` in float32, TF32 off, in blocks of
  64 alerts;
* control: that reference with every product's and convolution's operands
  rounded to 4 explicit mantissa bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import harness
from ..reference.mm_maxxvit import Reference, calibrate, param_spec, table_scales
from . import archive, archive_maxvit

CALIBRATION_ALERTS = 64
REFERENCE_BLOCK = 64


def make_weights(cfg: dict, seed: int, dtype: torch.dtype, device) -> dict:
    """A program-named state dict drawn on ``device`` from ``seed`` by the
    harness's recipe (``harness.make_weights``), the tables scaled and the
    logit's layer calibrated (module docstring), in the type it is served
    in."""
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
        out[name] = {"w": lambda: uu * math.sqrt(6 / fan), "b": lambda: uu / math.sqrt(fan),
                     "w_out": lambda: uu / math.sqrt(fan),
                     "ln_w": lambda: torch.exp(harness.LN_SIGMA * zz), "ln_b": lambda: 0.1 * zz,
                     "bn_w": lambda: 1 + 0.1 * zz, "bn_b": lambda: 0.1 * zz,
                     "gamma": lambda: 0.5 * zz, "bn_mean": lambda: zz,
                     "bn_var": lambda: 1.25 + 0.75 * uu}[kind]()
    # the served type's values, so program and reference start from one dict
    p = {k: v.to(dtype).float() if v.is_floating_point() else v for k, v in out.items()}
    images, meta = harness.make_pool(CALIBRATION_ALERTS, len(cfg["model"]["metadata_cols"]),
                                     seed + 3, device)
    with harness.tf32_off():
        p.update(table_scales(cfg, p))
        p.update(calibrate(cfg, p, torch.from_numpy(images).to(device),
                           torch.from_numpy(meta).to(device)))
    return {k: v.to(dtype).contiguous() if v.is_floating_point() else v for k, v in p.items()}


class Cell(archive_maxvit.Cell):
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
