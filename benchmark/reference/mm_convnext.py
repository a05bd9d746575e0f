"""Plain mm_ConvNeXt in float32: the forward, the weighted BCE and AdamW.

The yardstick that decides ``correct``.  It follows timm's ConvNeXt-v1 and
BTSbot's multimodal head as published, NHWC:

* stem: Conv 4×4 / 4 → LayerNorm (eps 1e-6);
* each stage after the first: LayerNorm → Conv 2×2 / 2;
* block: depthwise Conv 7×7 (padding 3) → LayerNorm → Linear(r·C) → GELU
  (erf) → Linear(C) → ·γ → + block input;
* image head: the final map flattened in NHWC order, or with "LS" in
  ``train_data_version`` pooled and LayerNormed;
* metadata: BatchNorm (eps 1e-5; in training the batch's statistics as
  E[x²] − E[x]² clipped at 0) → Linear → GELU → Dropout → Linear → GELU;
* fusion head: concatenation → Linear → GELU → Linear → GELU → Dropout →
  Linear(1).

Parameters are a dict keyed by the reference's state-dict names
(``param_spec``).  ``tf32=True`` rounds both operands of every convolution
and product to TF32 (10 explicit mantissa bits, to nearest even): the
control, the reference computed one precision below float32.  It imports
nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
BN_EPS = 1e-5
PARAM_KINDS = ("w", "w_out", "b", "ln_w", "ln_b", "gamma", "bn_w", "bn_b")


def param_spec(cfg: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every state-dict entry, in the
    reference's order.  Kinds: w / b (a weight / bias with its fan-in),
    w_out (the logit's weight),
    ln_w / ln_b, gamma, bn_w / bn_b / bn_mean / bn_var, count."""
    dims, depths, ratio, m = cfg["dims"], cfg["depths"], cfg["mlp_ratio"], cfg["model"]
    p = "convnext_backbone."
    spec = [(p + "stem.0.weight", (dims[0], 3, 4, 4), "w", 48),
            (p + "stem.0.bias", (dims[0],), "b", 48),
            (p + "stem.1.weight", (dims[0],), "ln_w", 0),
            (p + "stem.1.bias", (dims[0],), "ln_b", 0)]
    for s, (c, depth) in enumerate(zip(dims, depths)):
        q = f"{p}stages.{s}."
        if s:
            fan = 4 * dims[s - 1]
            spec += [(q + "downsample.0.weight", (dims[s - 1],), "ln_w", 0),
                     (q + "downsample.0.bias", (dims[s - 1],), "ln_b", 0),
                     (q + "downsample.1.weight", (c, dims[s - 1], 2, 2), "w", fan),
                     (q + "downsample.1.bias", (c,), "b", fan)]
        h = ratio * c
        for b in range(depth):
            r = f"{q}blocks.{b}."
            spec += [(r + "conv_dw.weight", (c, 1, 7, 7), "w", 49),
                     (r + "conv_dw.bias", (c,), "b", 49),
                     (r + "norm.weight", (c,), "ln_w", 0),
                     (r + "norm.bias", (c,), "ln_b", 0),
                     (r + "mlp.fc1.weight", (h, c), "w", c),
                     (r + "mlp.fc1.bias", (h,), "b", c),
                     (r + "mlp.fc2.weight", (c, h), "w", h),
                     (r + "mlp.fc2.bias", (c,), "b", h),
                     (r + "gamma", (c,), "gamma", 0)]
    if _head_norm(cfg):
        spec += [(p + "head.1.weight", (dims[-1],), "ln_w", 0),
                 (p + "head.1.bias", (dims[-1],), "ln_b", 0)]
    n_meta, f1, f2 = len(m["metadata_cols"]), m["meta_fc1_neurons"], m["meta_fc2_neurons"]
    c1, c2 = m["comb_fc1_neurons"], m["comb_fc2_neurons"]
    n_in = image_features(cfg) + f2
    spec += [("metadata_branch.0.weight", (n_meta,), "bn_w", 0),
             ("metadata_branch.0.bias", (n_meta,), "bn_b", 0),
             ("metadata_branch.0.running_mean", (n_meta,), "bn_mean", 0),
             ("metadata_branch.0.running_var", (n_meta,), "bn_var", 0),
             ("metadata_branch.0.num_batches_tracked", (), "count", 0),
             ("metadata_branch.1.weight", (f1, n_meta), "w", n_meta),
             ("metadata_branch.1.bias", (f1,), "b", n_meta),
             ("metadata_branch.4.weight", (f2, f1), "w", f1),
             ("metadata_branch.4.bias", (f2,), "b", f1),
             ("combined_head.0.weight", (c1, n_in), "w", n_in),
             ("combined_head.0.bias", (c1,), "b", n_in),
             ("combined_head.2.weight", (c2, c1), "w", c1),
             ("combined_head.2.bias", (c2,), "b", c1),
             ("combined_head.5.weight", (1, c2), "w_out", c2),
             ("combined_head.5.bias", (1,), "b", c2)]
    return spec


def _head_norm(cfg: dict) -> bool:
    return "LS" in cfg["model"].get("train_data_version", "")


def _final_side(cfg: dict) -> int:
    s = (cfg["image_size"] - 4) // 4 + 1
    for _ in range(len(cfg["dims"]) - 1):
        s = (s - 2) // 2 + 1
    return s


def image_features(cfg: dict) -> int:
    return cfg["dims"][-1] * (1 if _head_norm(cfg) else _final_side(cfg) ** 2)


def trainable(spec) -> list[str]:
    return [name for name, _, kind, _ in spec if kind in PARAM_KINDS]


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (13 low mantissa bits cleared, to nearest
    even), still stored as float32; the gradient passes straight through."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (i.view(torch.float32) - x).detach()


def _gelu(x):
    return F.gelu(x)  # the erf form


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


class Reference:
    """The forward and training arithmetic over a parameter dict."""

    def __init__(self, cfg: dict, tf32: bool = False):
        self.cfg = cfg
        self.rnd = to_tf32 if tf32 else (lambda t: t)

    def _conv(self, x_nhwc, w, b, stride=1, padding=0, groups=1):
        y = F.conv2d(self.rnd(x_nhwc.permute(0, 3, 1, 2)), self.rnd(w), b,
                     stride=stride, padding=padding, groups=groups)
        return y.permute(0, 2, 3, 1)

    def _linear(self, x, w, b):
        return F.linear(self.rnd(x), self.rnd(w), b)

    def backbone(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        q = "convnext_backbone."
        x = self._conv(x, p[q + "stem.0.weight"], p[q + "stem.0.bias"], stride=4)
        x = _ln(x, p[q + "stem.1.weight"], p[q + "stem.1.bias"])
        for s, (c, depth) in enumerate(zip(cfg["dims"], cfg["depths"])):
            st = f"{q}stages.{s}."
            if s:
                x = _ln(x, p[st + "downsample.0.weight"], p[st + "downsample.0.bias"])
                x = self._conv(x, p[st + "downsample.1.weight"], p[st + "downsample.1.bias"],
                               stride=2)
            for b in range(depth):
                r = f"{st}blocks.{b}."
                y = self._conv(x, p[r + "conv_dw.weight"], p[r + "conv_dw.bias"],
                               padding=3, groups=c)
                y = _ln(y, p[r + "norm.weight"], p[r + "norm.bias"])
                y = _gelu(self._linear(y, p[r + "mlp.fc1.weight"], p[r + "mlp.fc1.bias"]))
                y = self._linear(y, p[r + "mlp.fc2.weight"], p[r + "mlp.fc2.bias"])
                x = x + p[r + "gamma"] * y
        if _head_norm(cfg):
            x = _ln(x.mean(dim=(1, 2)), p[q + "head.1.weight"], p[q + "head.1.bias"])
        return x.reshape(x.shape[0], -1)

    def logits(self, p: dict, images: torch.Tensor, metadata: torch.Tensor,
               train: bool = False, masks=None) -> torch.Tensor:
        """(N,) logits.  ``train``: the metadata BatchNorm on the batch's
        statistics and dropout by ``masks`` = (metadata mask, head mask), each
        0/1, applied as x · mask / (1 − p)."""
        m = self.cfg["model"]
        img = self.backbone(p, images)
        x = metadata
        if train:
            mean = x.mean(dim=0)
            var = torch.clamp(x.square().mean(dim=0) - mean.square(), min=0.0)
        else:
            mean = p["metadata_branch.0.running_mean"]
            var = p["metadata_branch.0.running_var"]
        x = (x - mean) * torch.rsqrt(var + BN_EPS) * p["metadata_branch.0.weight"] \
            + p["metadata_branch.0.bias"]
        x = _gelu(self._linear(x, p["metadata_branch.1.weight"], p["metadata_branch.1.bias"]))
        if train:
            x = x * masks[0] / (1 - m["meta_dropout"])
        x = _gelu(self._linear(x, p["metadata_branch.4.weight"], p["metadata_branch.4.bias"]))
        h = torch.cat([img, x], dim=1)
        h = _gelu(self._linear(h, p["combined_head.0.weight"], p["combined_head.0.bias"]))
        h = _gelu(self._linear(h, p["combined_head.2.weight"], p["combined_head.2.bias"]))
        if train:
            h = h * masks[1] / (1 - m["comb_dropout"])
        return self._linear(h, p["combined_head.5.weight"], p["combined_head.5.bias"]).reshape(-1)


def weighted_bce(logits, labels, pos_weight: float) -> torch.Tensor:
    """Mean of −[w·y·log σ(z) + (1 − y)·log(1 − σ(z))]."""
    return -(pos_weight * labels * F.logsigmoid(logits)
             + (1 - labels) * F.logsigmoid(-logits)).mean()


def augment(images: torch.Tensor, h_flip, v_flip, rot_k) -> torch.Tensor:
    """A flip of W where ``h_flip``, of H where ``v_flip``, then a
    counter-clockwise quarter turn ``rot_k`` times, per alert."""
    out = []
    for img, h, v, k in zip(images, h_flip.tolist(), v_flip.tolist(), rot_k.tolist()):
        if h:
            img = img.flip(1)
        if v:
            img = img.flip(0)
        out.append(torch.rot90(img, int(k), dims=(0, 1)))
    return torch.stack(out)


def adamw_(p: dict, grads: dict, m1: dict, m2: dict, t: int, lr: float,
           betas: tuple[float, float], eps: float = 1e-8, wd: float = 0.01) -> None:
    """One decoupled-weight-decay Adam update of every parameter in place."""
    b1, b2 = betas
    for name, g in grads.items():
        m1[name] = b1 * m1[name] + (1 - b1) * g
        m2[name] = b2 * m2[name] + (1 - b2) * g * g
        m_hat = m1[name] / (1 - b1 ** t)
        denom = torch.sqrt(m2[name]) / math.sqrt(1 - b2 ** t) + eps
        p[name] = p[name] * (1 - lr * wd) - lr * m_hat / denom
