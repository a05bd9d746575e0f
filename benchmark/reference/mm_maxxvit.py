"""Plain mm_MaxViT over a MaxxViT backbone in float32: the eval-mode forward.

The yardstick that decides ``correct`` in the MaxxViT cell.  It follows
timm's ``maxxvit_rmlp_small_rw_256`` (``models/maxxvit.py``: MaxViT, Tu et
al., ECCV 2022, arXiv:2204.01697, with ConvNeXt blocks, Liu et al., CVPR
2022, arXiv:2201.03545, in place of the MBConvs) and BTSbot's multimodal
head, NHWC.  With C = 96 / 192 / 384 / 768 over depths 2 / 2 / 5 / 2, head
dim 32 and P = 8:

* the 63×63 triplets resized to 256×256 (bilinear, half-pixel centres, no
  antialiasing);
* stem: conv 3×3 / 2 pad 1, 3 → 48, no bias → LayerNorm over channels (eps
  1e-6) → GELU → conv 3×3 / 1 pad 1, 48 → 96 with bias;
* each block: a ConvNeXt half, then window attention and its MLP, then grid
  attention and its MLP;
* ConvNeXt half: in a stage's first block (stride 2) shortcut = 2×2 / 2
  average pool, then a 1×1 conv C_in → C with bias where C_in ≠ C, and h =
  depthwise 7×7 / 2 pad 3 with bias, groups C_in, C_in → C (output channel
  o reads input channel o // (C / C_in)); in the other blocks shortcut = x
  and h = depthwise 7×7 / 1 pad 3 with bias.  Then x ← shortcut + γ_c ⊙
  fc2(GELU(fc1(LN(h)))), LN eps 1e-6, fc1 C → 4C and fc2 4C → C with bias;
* attention half: x ← x + γ₁ ⊙ proj(Attn(qkv(LN(x)))), LN eps 1e-5, with
  multi-head attention (head dim 32, scale 32^−½) inside each P×P window,
  or each P×P grid of tokens strided by (H/P, W/P): softmax(q·kᵀ·scale +
  B)·v.  qkv's channels are (3, heads, 32);
* bias B[h, i, j] = table[swin index of (i, j), h], table = W₂·ReLU(W₁·u
  + b₁) + b₂ over the (2P − 1)² offsets (dy, dx) ∈ [−(P−1), P−1]², u =
  sign(d)·ln(1 + |d|) (timm ``RelPosMlp``, mode "cr": no sigmoid, no
  gain), W₁ 512 × 2, W₂ heads × 512;
* MLP half: x ← x + γ₂ ⊙ fc2(GELU(fc1(LN(x)))), LN eps 1e-5, hidden 4C;
* the final map pooled (mean, no norm); GELU the erf form;
* metadata and fusion head as ``mm_maxvit.py`` (its ``logits``).

Departures from timm's published definition, and what this cannot confirm
without timm's code at hand:

* qkv's output channels are ordered (3, heads, 32), the program's layout;
  timm's ``head_first`` orders them (heads, 3, 32): a permutation of
  Wqkv's rows, the same function once weights are converted;
* the attention halves' LayerNorm eps is 1e-5 (the program's MaxViT's);
  timm's transformer default may be 1e-6, not confirmed;
* the table MLP has no dropout (timm's drops 1/8 of its hidden units in
  training; an eval forward is the same);
* timm's final norm and classifier are left out: the pooled map feeds the
  fusion head, as in the program's mm_MaxViT;
* the shortcut's 1×1 conv is named ``shortcut.conv`` (timm's
  ``shortcut.expand``, which the program's checkpoint loader renames).

Parameters are a dict keyed by the program's state-dict names
(``param_spec``).  ``mantissa`` rounds both operands of every product and
convolution (the table MLP's too) to that many explicit mantissa bits: the
control.  It imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mm_maxvit import LOGIT_STD, _bn_spec, _linear_spec, swin_index
from .mm_maxvit import Reference as MaxViTReference

CONV_LN_EPS = 1e-6
ATTN_LN_EPS = 1e-5
HEAD_DIM = 32
REL_POS_DIM = 512
TAPS = 7
# the spread of each attention half's bias table over its offsets (a head's
# mean left out), as mm_maxvit_tiny's N(0, 1) tables spread
TABLE_STD = 1.0


def stage_inputs(cfg: dict) -> list[int]:
    return [cfg["stem_width"][-1]] + list(cfg["dims"][:-1])


def _ln_spec(name: str, n: int) -> list:
    return [(name + ".weight", (n,), "ln_w", 0), (name + ".bias", (n,), "ln_b", 0)]


def param_spec(cfg: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every state-dict entry, in timm's
    module order.  Kinds as ``mm_convnext.param_spec``'s."""
    dims, depths, ratio = cfg["dims"], cfg["depths"], cfg["mlp_ratio"]
    s0, s1 = cfg["stem_width"]
    m = cfg["model"]
    q = "maxvit_backbone."
    spec = [(q + "stem.conv1.weight", (s0, 3, 3, 3), "w", 27)]
    spec += _ln_spec(q + "stem.norm1", s0)
    spec += [(q + "stem.conv2.weight", (s1, s0, 3, 3), "w", 9 * s0),
             (q + "stem.conv2.bias", (s1,), "b", 9 * s0)]
    for s, (c_in0, c, depth) in enumerate(zip(stage_inputs(cfg), dims, depths)):
        for b in range(depth):
            r = f"{q}stages.{s}.blocks.{b}."
            c_in = c_in0 if b == 0 else c
            if c_in != c:
                spec += _linear_spec(r + "conv.shortcut.conv", c, c_in, conv=True)
            spec += [(r + "conv.conv_dw.weight", (c, 1, TAPS, TAPS), "w", TAPS * TAPS),
                     (r + "conv.conv_dw.bias", (c,), "b", TAPS * TAPS)]
            spec += _ln_spec(r + "conv.norm", c)
            spec += _linear_spec(r + "conv.mlp.fc1", ratio * c, c, conv=True)
            spec += _linear_spec(r + "conv.mlp.fc2", c, ratio * c, conv=True)
            spec += [(r + "conv.ls.gamma", (c,), "gamma", 0)]
            for half in ("attn_block", "attn_grid"):
                h = r + half + "."
                spec += _ln_spec(h + "norm1", c)
                spec += _linear_spec(h + "attn.qkv", 3 * c, c)
                spec += _linear_spec(h + "attn.rel_pos.mlp.fc1", REL_POS_DIM, 2)
                spec += _linear_spec(h + "attn.rel_pos.mlp.fc2", c // HEAD_DIM, REL_POS_DIM)
                spec += _linear_spec(h + "attn.proj", c, c)
                spec += [(h + "ls1.gamma", (c,), "gamma", 0)]
                spec += _ln_spec(h + "norm2", c)
                spec += _linear_spec(h + "mlp.fc1", ratio * c, c)
                spec += _linear_spec(h + "mlp.fc2", c, ratio * c)
                spec += [(h + "ls2.gamma", (c,), "gamma", 0)]
    n_meta, f1, f2 = len(m["metadata_cols"]), m["meta_fc1_neurons"], m["meta_fc2_neurons"]
    c1, c2 = m["comb_fc1_neurons"], m["comb_fc2_neurons"]
    spec += _bn_spec("metadata_branch.0", n_meta)
    spec += _linear_spec("metadata_branch.1", f1, n_meta) + _linear_spec("metadata_branch.4", f2, f1)
    spec += _linear_spec("combined_head.0", c1, dims[-1] + f2) + _linear_spec("combined_head.2", c2, c1)
    spec += [("combined_head.5.weight", (1, c2), "w_out", c2),
             ("combined_head.5.bias", (1,), "b", c2)]
    return spec


def log_coords(p: int, device=None) -> torch.Tensor:
    """((2p − 1)², 2) float32: the offsets (dy, dx), dy major, each as
    sign(d)·ln(1 + |d|)."""
    d = torch.arange(-(p - 1), p, dtype=torch.float32, device=device)
    u = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1).reshape(-1, 2)
    return torch.sign(u) * torch.log1p(u.abs())


class Reference(MaxViTReference):
    """The eval-mode forward over a parameter dict (``logits`` is
    ``mm_maxvit.Reference``'s: this backbone, then its metadata branch and
    head)."""

    def _ln(self, p, name, x, eps=ATTN_LN_EPS):
        return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], eps)

    def table(self, p, h) -> torch.Tensor:
        """The ((2P − 1)², heads) bias table of the attention half ``h``."""
        u = log_coords(self.cfg["window"], p[h + "attn.rel_pos.mlp.fc1.weight"].device)
        t = F.relu(self._linear(u, p[h + "attn.rel_pos.mlp.fc1.weight"],
                                p[h + "attn.rel_pos.mlp.fc1.bias"]))
        return self._linear(t, p[h + "attn.rel_pos.mlp.fc2.weight"],
                            p[h + "attn.rel_pos.mlp.fc2.bias"])

    def _conv_half(self, p, r, x, c_in, c, stride):
        s = x
        if stride == 2:
            s = F.avg_pool2d(s.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        if c_in != c:
            s = self._linear(s, p[r + "shortcut.conv.weight"], p[r + "shortcut.conv.bias"])
        y = self._conv(x, p[r + "conv_dw.weight"], p[r + "conv_dw.bias"], stride=stride,
                       padding=TAPS // 2, groups=c_in)
        y = self._ln(p, r + "norm", y, CONV_LN_EPS)
        y = F.gelu(self._linear(y, p[r + "mlp.fc1.weight"], p[r + "mlp.fc1.bias"]))
        y = self._linear(y, p[r + "mlp.fc2.weight"], p[r + "mlp.fc2.bias"])
        return s + p[r + "ls.gamma"] * y

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
        table = self.table(p, h)
        s = s + table[swin_index(win).to(table.device)].permute(2, 0, 1)
        o = torch.matmul(self.rnd(torch.softmax(s, dim=-1)), self.rnd(v))
        o = self._linear(o.transpose(1, 2).reshape(t.shape[0], win * win, c),
                         p[h + "attn.proj.weight"], p[h + "attn.proj.bias"])
        o = o.reshape(n_img, a, b, win, win, c)
        o = o.permute(0, 3, 1, 4, 2, 5) if grid else o.permute(0, 1, 3, 2, 4, 5)
        return x + p[h + "ls1.gamma"] * o.reshape(n_img, hh, ww, c)

    def _mlp(self, p, h, x):
        y = self._ln(p, h + "norm2", x)
        y = F.gelu(self._linear(y, p[h + "mlp.fc1.weight"], p[h + "mlp.fc1.bias"]))
        return x + p[h + "ls2.gamma"] * self._linear(y, p[h + "mlp.fc2.weight"],
                                                     p[h + "mlp.fc2.bias"])

    def backbone(self, p: dict, images: torch.Tensor) -> torch.Tensor:
        cfg, q = self.cfg, "maxvit_backbone."
        size = cfg["image_size"]
        x = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                          align_corners=False, antialias=False).permute(0, 2, 3, 1)
        x = self._conv(x, p[q + "stem.conv1.weight"], stride=2, padding=1)
        x = F.gelu(self._ln(p, q + "stem.norm1", x, CONV_LN_EPS))
        x = self._conv(x, p[q + "stem.conv2.weight"], p[q + "stem.conv2.bias"], padding=1)
        for s, (c_in0, c, depth) in enumerate(zip(stage_inputs(cfg), cfg["dims"],
                                                  cfg["depths"])):
            for b in range(depth):
                r = f"{q}stages.{s}.blocks.{b}."
                x = self._conv_half(p, r + "conv.", x, c_in0 if b == 0 else c, c,
                                    2 if b == 0 else 1)
                for half, grid in (("attn_block.", False), ("attn_grid.", True)):
                    x = self._attention(p, r + half, x, grid)
                    x = self._mlp(p, r + half, x)
        return x.mean(dim=(1, 2))


def table_scales(cfg: dict, p: dict) -> dict:
    """Each attention half's table MLP's last layer (weight and bias) scaled
    so that its table spreads ``TABLE_STD`` over the offsets (the root mean
    square over heads of each head's standard deviation; a head's mean,
    which a softmax ignores, left out); returns the new entries."""
    ref, out = Reference(cfg), {}
    for name in [n for n, *_ in param_spec(cfg) if n.endswith("attn.rel_pos.mlp.fc2.weight")]:
        h = name[:-len("attn.rel_pos.mlp.fc2.weight")]
        with torch.no_grad():
            spread = ref.table(p, h).var(dim=0, unbiased=False).mean().sqrt()
        scale = TABLE_STD / spread
        out[name] = p[name] * scale
        out[h + "attn.rel_pos.mlp.fc2.bias"] = p[h + "attn.rel_pos.mlp.fc2.bias"] * scale
    return out


def calibrate(cfg: dict, p: dict, images: torch.Tensor, metadata: torch.Tensor) -> dict:
    """The logit's layer shifted and scaled so that a batch's logits have
    mean 0 and standard deviation ``LOGIT_STD`` (``mm_maxvit.calibrate``'s
    reason; the backbone has no BatchNorm to set); returns the new
    entries."""
    with torch.no_grad():
        z = Reference(cfg).logits(p, images, metadata)
    scale = LOGIT_STD / z.std()
    return {"combined_head.5.weight": p["combined_head.5.weight"] * scale,
            "combined_head.5.bias": (p["combined_head.5.bias"] - z.mean()) * scale}
