"""Plain mm_MaxViT in float32: the eval-mode forward.

The yardstick that decides ``correct`` in the MaxViT cell.  It follows
MaxViT (Tu et al., ECCV 2022, arXiv:2204.01697) in timm's
``maxvit_tiny_rw_224`` layout and BTSbot's multimodal head, NHWC:

* the 63×63 triplets resized to the native size (bilinear, half-pixel
  centres, no antialiasing);
* stem: Conv 3×3 / 2 (no bias) → BatchNorm → GELU → Conv 3×3;
* each block: MBConv, then window attention, then grid attention;
* MBConv: BatchNorm → 1×1 conv to 4× the input width (no bias) →
  BatchNorm → GELU → depthwise 3×3 (stride 2 in a stage's first block,
  padding 1, no bias) → BatchNorm → GELU → squeeze-excite (mean → 1×1 to
  a quarter of the input width → SiLU → 1×1 → sigmoid, times the map) →
  1×1 conv to the output width; plus the input, or where the stride is 2 or
  the width changes, a 2×2 / 2 average pool and a 1×1 conv of it;
* attention half: x + proj(attention(qkv(LN(x)))) with multi-head
  attention (head dim 32, scale 32^−½) inside each P×P window, or each P×P
  grid of tokens strided by (H/P, W/P), and a learned bias from a
  ((2P−1)², heads) table at the swin index of the two tokens' offset;
* MLP half: x + fc2(GELU(fc1(LN(x)))), hidden 4C;
* the final map pooled (mean, no norm); BatchNorms eps 1e-5 with running
  statistics, LayerNorms eps 1e-5, GELU the erf form;
* metadata and fusion head as ``mm_convnext.py``.

Departures from timm's published definition, and what this cannot confirm
without the published weights and code at hand:

* the stem is 3→64→64 (the program's ``MAXVIT_CONFIGS``, stem width 64,
  the JAX package's); timm's published cost of maxvit_tiny_rw_224 (~29.1 M
  parameters, 5.1 GMACs) fits a 3→32→64 stem, which by this count is
  ~0.48 GFLOP an alert less;
* GELU is the erf form everywhere (timm's default ``gelu`` is; its
  ``gelu_tanh`` variants are not used here);
* LayerNorm eps 1e-5 and BatchNorm eps 1e-5 (timm's maxxvit defaults to
  1e-5 for ``layernorm2d`` / ``batchnorm2d``; not confirmed for the ``rw``
  variant);
* the attention's output projection and qkv carry biases, and the MBConv's
  first 1×1 and the depthwise conv do not (the program's layout).

Parameters are a dict keyed by the program's state-dict names
(``param_spec``).  ``mantissa`` rounds both operands of every product and
convolution to that many explicit mantissa bits (to nearest even): the
control, the reference computed below bfloat16 (7 bits).  It imports
nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
BN_EPS = 1e-5
HEAD_DIM = 32
EXPAND = 4
SE_RATIO = 0.25
# the calibrated logits' spread.  The comparison reads gaps in units of the
# pool's spread, which the scale leaves as they are; at 2, a logit reaches
# the 16.6 above which a float32 sigmoid reads 1 only 8 spreads out
# (unscaled, one seed's pool spread 4.6 and reached 18.6)
LOGIT_STD = 2.0


def _bn_spec(name: str, n: int) -> list:
    return [(name + ".weight", (n,), "bn_w", 0), (name + ".bias", (n,), "bn_b", 0),
            (name + ".running_mean", (n,), "bn_mean", 0),
            (name + ".running_var", (n,), "bn_var", 0),
            (name + ".num_batches_tracked", (), "count", 0)]


def _linear_spec(name: str, n_out: int, n_in: int, bias: bool = True, conv: bool = False):
    shape = (n_out, n_in, 1, 1) if conv else (n_out, n_in)
    spec = [(name + ".weight", shape, "w", n_in)]
    return spec + ([(name + ".bias", (n_out,), "b", n_in)] if bias else [])


def stage_inputs(cfg: dict) -> list[int]:
    return [cfg["stem_width"]] + list(cfg["dims"][:-1])


def param_spec(cfg: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every state-dict entry, in the
    program's order.  Kinds as ``mm_convnext.param_spec``'s, with
    ``table`` for the relative-position bias tables."""
    dims, depths, stem, p = cfg["dims"], cfg["depths"], cfg["stem_width"], cfg["window"]
    m = cfg["model"]
    q = "maxvit_backbone."
    spec = [(q + "stem.conv1.weight", (stem, 3, 3, 3), "w", 27)]
    spec += _bn_spec(q + "stem.norm1", stem)
    spec += [(q + "stem.conv2.weight", (stem, stem, 3, 3), "w", 9 * stem),
             (q + "stem.conv2.bias", (stem,), "b", 9 * stem)]
    for s, (c_in0, c, depth) in enumerate(zip(stage_inputs(cfg), dims, depths)):
        for b in range(depth):
            r = f"{q}stages.{s}.blocks.{b}."
            c_in = c_in0 if b == 0 else c
            mid, rd = EXPAND * c_in, max(1, int(c_in * SE_RATIO))
            if b == 0 or c_in != c:
                spec += _linear_spec(r + "conv.shortcut.conv", c, c_in, conv=True)
            spec += _bn_spec(r + "conv.pre_norm", c_in)
            spec += _linear_spec(r + "conv.conv1_1x1", mid, c_in, bias=False, conv=True)
            spec += _bn_spec(r + "conv.norm1", mid)
            spec += [(r + "conv.conv2_kxk.weight", (mid, 1, 3, 3), "w", 9)]
            spec += _bn_spec(r + "conv.norm2", mid)
            spec += _linear_spec(r + "conv.se.fc1", rd, mid, conv=True)
            spec += _linear_spec(r + "conv.se.fc2", mid, rd, conv=True)
            spec += _linear_spec(r + "conv.conv3_1x1", c, mid, conv=True)
            for half in ("attn_block", "attn_grid"):
                h = r + half + "."
                spec += [(h + "norm1.weight", (c,), "ln_w", 0), (h + "norm1.bias", (c,), "ln_b", 0)]
                spec += _linear_spec(h + "attn.qkv", 3 * c, c)
                spec += _linear_spec(h + "attn.proj", c, c)
                spec += [(h + "attn.rel_pos.relative_position_bias_table",
                          ((2 * p - 1) ** 2, c // HEAD_DIM), "table", 0)]
                spec += [(h + "norm2.weight", (c,), "ln_w", 0), (h + "norm2.bias", (c,), "ln_b", 0)]
                spec += _linear_spec(h + "mlp.fc1", cfg["mlp_ratio"] * c, c)
                spec += _linear_spec(h + "mlp.fc2", c, cfg["mlp_ratio"] * c)
    n_meta, f1, f2 = len(m["metadata_cols"]), m["meta_fc1_neurons"], m["meta_fc2_neurons"]
    c1, c2 = m["comb_fc1_neurons"], m["comb_fc2_neurons"]
    n_in = dims[-1] + f2
    spec += _bn_spec("metadata_branch.0", n_meta)
    spec += _linear_spec("metadata_branch.1", f1, n_meta) + _linear_spec("metadata_branch.4", f2, f1)
    spec += _linear_spec("combined_head.0", c1, n_in) + _linear_spec("combined_head.2", c2, c1)
    spec += [("combined_head.5.weight", (1, c2), "w_out", c2),
             ("combined_head.5.bias", (1,), "b", c2)]
    return spec


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 rounded to ``bits`` explicit mantissa bits (to nearest even),
    still stored as float32."""
    drop = 23 - bits
    i = x.detach().contiguous().view(torch.int32)
    i = (i + ((1 << (drop - 1)) - 1) + ((i >> drop) & 1)) & ~((1 << drop) - 1)
    return x + (i.view(torch.float32) - x).detach()


def swin_index(p: int) -> torch.Tensor:
    """(p², p²) index into the (2p−1)² table: token i at (i // p, i % p),
    the offset (dy, dx) of i from j at row dy + p − 1, column dx + p − 1."""
    y, x = torch.arange(p * p) // p, torch.arange(p * p) % p
    dy, dx = y[:, None] - y[None, :], x[:, None] - x[None, :]
    return (dy + p - 1) * (2 * p - 1) + dx + p - 1


def _gelu(x):
    return F.gelu(x)  # the erf form


class Reference:
    """The eval-mode forward over a parameter dict.  ``stats``: where set,
    each backbone BatchNorm's running statistics are replaced by the
    mean and (biased) variance of its input over the batch, and recorded
    in ``stats`` under its prefix (how ``calibrate`` sets them)."""

    def __init__(self, cfg: dict, mantissa: int | None = None):
        self.cfg = cfg
        self.rnd = (lambda t: round_mantissa(t, mantissa)) if mantissa else (lambda t: t)
        self.stats: dict | None = None

    # ---- operations (NHWC)
    def _conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        y = F.conv2d(self.rnd(x.permute(0, 3, 1, 2)), self.rnd(w), b, stride=stride,
                     padding=padding, groups=groups)
        return y.permute(0, 2, 3, 1)

    def _linear(self, x, w, b=None):
        return F.linear(self.rnd(x), self.rnd(w.reshape(w.shape[0], -1)), b)

    def _bn(self, p, name, x):
        if self.stats is not None and name.startswith("maxvit_backbone."):
            mean, var = x.mean(dim=(0, 1, 2)), x.var(dim=(0, 1, 2), unbiased=False)
            self.stats[name] = (mean, var)
        else:
            mean, var = p[name + ".running_mean"], p[name + ".running_var"]
        return (x - mean) * torch.rsqrt(var + BN_EPS) * p[name + ".weight"] + p[name + ".bias"]

    def _ln(self, p, name, x):
        return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], LN_EPS)

    # ---- layers
    def _mbconv(self, p, r, x, c_in, c, stride):
        if stride == 2 or c_in != c:
            s = x
            if stride == 2:
                s = F.avg_pool2d(s.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            s = self._linear(s, p[r + "shortcut.conv.weight"], p[r + "shortcut.conv.bias"])
        else:
            s = x
        y = self._bn(p, r + "pre_norm", x)
        y = self._linear(y, p[r + "conv1_1x1.weight"])
        y = _gelu(self._bn(p, r + "norm1", y))
        y = self._conv(y, p[r + "conv2_kxk.weight"], stride=stride, padding=1,
                       groups=y.shape[-1])
        y = _gelu(self._bn(p, r + "norm2", y))
        g = y.mean(dim=(1, 2))
        g = F.silu(self._linear(g, p[r + "se.fc1.weight"], p[r + "se.fc1.bias"]))
        g = torch.sigmoid(self._linear(g, p[r + "se.fc2.weight"], p[r + "se.fc2.bias"]))
        y = y * g[:, None, None, :]
        return self._linear(y, p[r + "conv3_1x1.weight"], p[r + "conv3_1x1.bias"]) + s

    def _attention(self, p, h, x, grid: bool):
        n_img, hh, ww, c = x.shape
        win, heads = self.cfg["window"], c // HEAD_DIM
        a, b = hh // win, ww // win
        # tokens of each partition: (image, partition a, partition b, token y, token x)
        if grid:
            t = x.reshape(n_img, win, a, win, b, c).permute(0, 2, 4, 1, 3, 5)
        else:
            t = x.reshape(n_img, a, win, b, win, c).permute(0, 1, 3, 2, 4, 5)
        t = t.reshape(-1, win * win, c)
        t = self._ln(p, h + "norm1", t)
        qkv = self._linear(t, p[h + "attn.qkv.weight"], p[h + "attn.qkv.bias"])
        q, k, v = qkv.reshape(t.shape[0], win * win, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
        s = torch.matmul(self.rnd(q * HEAD_DIM ** -0.5), self.rnd(k).transpose(-2, -1))
        table = p[h + "attn.rel_pos.relative_position_bias_table"]
        s = s + table[swin_index(win).to(table.device)].permute(2, 0, 1)
        o = torch.matmul(self.rnd(torch.softmax(s, dim=-1)), self.rnd(v))
        o = self._linear(o.transpose(1, 2).reshape(t.shape[0], win * win, c),
                         p[h + "attn.proj.weight"], p[h + "attn.proj.bias"])
        o = o.reshape(n_img, a, b, win, win, c)
        o = o.permute(0, 3, 1, 4, 2, 5) if grid else o.permute(0, 1, 3, 2, 4, 5)
        return x + o.reshape(n_img, hh, ww, c)

    def _mlp(self, p, h, x):
        y = self._ln(p, h + "norm2", x)
        y = _gelu(self._linear(y, p[h + "mlp.fc1.weight"], p[h + "mlp.fc1.bias"]))
        return x + self._linear(y, p[h + "mlp.fc2.weight"], p[h + "mlp.fc2.bias"])

    def backbone(self, p: dict, images: torch.Tensor) -> torch.Tensor:
        cfg, q = self.cfg, "maxvit_backbone."
        size = cfg["image_size"]
        x = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                          align_corners=False, antialias=False).permute(0, 2, 3, 1)
        x = self._conv(x, p[q + "stem.conv1.weight"], stride=2, padding=1)
        x = _gelu(self._bn(p, q + "stem.norm1", x))
        x = self._conv(x, p[q + "stem.conv2.weight"], p[q + "stem.conv2.bias"], padding=1)
        for s, (c_in0, c, depth) in enumerate(zip(stage_inputs(cfg), cfg["dims"],
                                                  cfg["depths"])):
            for b in range(depth):
                r = f"{q}stages.{s}.blocks.{b}."
                x = self._mbconv(p, r + "conv.", x, c_in0 if b == 0 else c, c,
                                 2 if b == 0 else 1)
                for half, grid in (("attn_block.", False), ("attn_grid.", True)):
                    x = self._attention(p, r + half, x, grid)
                    x = self._mlp(p, r + half, x)
        return x.mean(dim=(1, 2))

    def logits(self, p: dict, images: torch.Tensor, metadata: torch.Tensor) -> torch.Tensor:
        """(N,) eval-mode logits."""
        img = self.backbone(p, images)
        x = metadata
        x = (x - p["metadata_branch.0.running_mean"]) \
            * torch.rsqrt(p["metadata_branch.0.running_var"] + BN_EPS) \
            * p["metadata_branch.0.weight"] + p["metadata_branch.0.bias"]
        x = _gelu(self._linear(x, p["metadata_branch.1.weight"], p["metadata_branch.1.bias"]))
        x = _gelu(self._linear(x, p["metadata_branch.4.weight"], p["metadata_branch.4.bias"]))
        h = torch.cat([img, x], dim=1)
        h = _gelu(self._linear(h, p["combined_head.0.weight"], p["combined_head.0.bias"]))
        h = _gelu(self._linear(h, p["combined_head.2.weight"], p["combined_head.2.bias"]))
        return self._linear(h, p["combined_head.5.weight"], p["combined_head.5.bias"]).reshape(-1)


def calibrate(cfg: dict, p: dict, images: torch.Tensor, metadata: torch.Tensor) -> dict:
    """Each backbone BatchNorm's running statistics set to the mean and
    variance of its input over a batch (float32), as a trained model's match
    its data, and the logit's layer shifted and scaled so that the batch's
    logits have mean 0 and standard deviation ``LOGIT_STD``, as a
    classifier's logits lie a few units about its decision boundary, where a
    float32 sigmoid resolves them (above ~16.6 it reads 1 exactly, and a
    score no longer tells its logit); returns the new entries."""
    ref = Reference(cfg)
    ref.stats = {}
    with torch.no_grad():
        ref.backbone(p, images)
    out = {}
    for name, (mean, var) in ref.stats.items():
        out[name + ".running_mean"], out[name + ".running_var"] = mean, var
    with torch.no_grad():
        z = Reference(cfg).logits({**p, **out}, images, metadata)
    scale = LOGIT_STD / z.std()
    out["combined_head.5.weight"] = p["combined_head.5.weight"] * scale
    out["combined_head.5.bias"] = (p["combined_head.5.bias"] - z.mean()) * scale
    return out
