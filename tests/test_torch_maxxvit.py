"""The port's MaxxViT backbone (``models/maxxvit.py``, under mm_MaxViT) against
the plain reference ``benchmark/reference/mm_maxxvit.py`` (CPU).

The JAX package has no MaxxViT, so the reference is the plain float32
PyTorch forward that decides the benchmark cell's ``correct``.  The model
runs cut to stem 16 → 32, widths 32 / 64 / 128 / 256, depths 1 / 1 / 1 / 1,
64×64 input (P = 2), on seeded weights drawn as the benchmark draws them
(γ ~ N(0, 0.5²), LayerNorm gains log-normal), so every branch and the
tables count.  Tolerances, each with its reason:

* f32 logits within 1e-5, absolute and relative, of the reference's (the
  same float32 operations in another order: γ₁ folded into proj, the plain
  kernels' chains);
* every gradient within 1e-4 of the largest gradient (the same, through
  the backward; the table MLP's last bias has no gradient but rounding,
  since a softmax ignores a shift of a head's scores);
* the channel multiplier's map, the table, the index and the parameter
  counts: exact.
"""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import mm_maxxvit
from btsbot_tpu_torch.core.config import normalize_config
from btsbot_tpu_torch.models import maxvit, maxxvit
from btsbot_tpu_torch.models.convnext import conv_nhwc
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.ops.partition_attention import rel_position_index
from btsbot_tpu_torch.utils import profiling

KIND = "maxxvit_rmlp_small_rw_256.sw_in1k"
TINY = {"depths": (1, 1, 1, 1), "dims": (32, 64, 128, 256), "stem_width": (16, 32)}
META_COLS = [f"m{i}" for i in range(5)]
MODEL = {"model_name": "mm_MaxViT", "model_kind": "maxxvit_rmlp_small_rw_64.test",
         "metadata_cols": META_COLS, "meta_fc1_neurons": 32, "meta_fc2_neurons": 32,
         "meta_dropout": 0.25, "comb_fc1_neurons": 64, "comb_fc2_neurons": 32,
         "comb_dropout": 0.2}


def _cfg(spec):
    return {"model": MODEL, "dims": list(spec["dims"]), "depths": list(spec["depths"]),
            "stem_width": list(spec["stem_width"]), "window": 2, "image_size": 64,
            "mlp_ratio": 4}


def _weights(cfg, seed=0):
    """The benchmark's draw (``harness.make_weights``'s recipe) on the CPU;
    the fixture then spreads the tables and the logits as the cell does."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind, fan in mm_maxxvit.param_spec(cfg):
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64)
            continue
        u = torch.rand(shape, generator=g) * 2 - 1
        z = torch.randn(shape, generator=g)
        out[name] = {"w": lambda: u * math.sqrt(6 / fan), "b": lambda: u / math.sqrt(fan),
                     "w_out": lambda: u / math.sqrt(fan), "ln_w": lambda: torch.exp(0.75 * z),
                     "ln_b": lambda: 0.1 * z, "bn_w": lambda: 1 + 0.1 * z,
                     "bn_b": lambda: 0.1 * z, "gamma": lambda: 0.5 * z, "bn_mean": lambda: z,
                     "bn_var": lambda: 1.25 + 0.75 * u}[kind]()
    return out


@pytest.fixture
def tiny(monkeypatch):
    """``tiny(spec)`` → (cfg, model with the reference's weights, weights)."""
    def make(spec=TINY):
        monkeypatch.setitem(maxvit.MAXXVIT_CONFIGS, "maxxvit_rmlp_small", spec)
        cfg = _cfg(spec)
        weights = _weights(cfg)
        weights.update(mm_maxxvit.table_scales(cfg, weights))
        weights.update(mm_maxxvit.calibrate(cfg, weights, *_inputs(16)))
        model = build_model(MODEL, device="cpu")
        model.load_state_dict(weights, strict=True)
        return cfg, model, weights
    return make


def _inputs(n=4):
    g = torch.Generator().manual_seed(1)
    return (torch.randn((n, 63, 63, 3), generator=g) / 20,
            torch.randn((n, len(META_COLS)), generator=g))


def test_logits_and_gradients_match_the_reference(tiny):
    cfg, model, weights = tiny()
    images, meta = _inputs()
    z = model(images, meta).reshape(-1)
    z.sum().backward()
    p = {k: v.requires_grad_(v.is_floating_point()) for k, v in weights.items()}
    zr = mm_maxxvit.Reference(cfg).logits(p, images, meta)
    zr.sum().backward()
    # the images move the logits, not the metadata alone
    with torch.no_grad():
        moved = mm_maxxvit.Reference(cfg).logits(weights, images.flip(0), meta)
    assert float((moved - zr.detach()).abs().max()) > 0.1
    torch.testing.assert_close(z.detach(), zr.detach(), rtol=1e-5, atol=1e-5)
    top = max(float(v.grad.abs().max()) for v in p.values() if v.grad is not None)
    for name, param in model.named_parameters():
        assert float((param.grad - p[name].grad).abs().max()) <= 1e-4 * top, name


def test_the_stride_2_conv_reads_channel_o_by_the_multiplier():
    """Output channel o of the strided depthwise conv (C_in = 4 → C = 12,
    multiplier 3) reads input channel o // 3, in the port and the reference."""
    half = maxxvit.ConvNeXtHalf(4, 12, stride=2)
    with torch.no_grad():
        half.conv_dw.weight.zero_()
        half.conv_dw.weight[:, 0, 3, 3] = 1
        half.conv_dw.bias.zero_()
    x = torch.arange(4.0).expand(1, 8, 8, 4).contiguous()
    want = torch.arange(12) // 3
    assert torch.equal(conv_nhwc(half.conv_dw, x)[0, 0, 0], want.float())
    ref = mm_maxxvit.Reference({"window": 2})
    h = ref._conv(x, half.conv_dw.weight, half.conv_dw.bias, stride=2, padding=3, groups=4)
    assert torch.equal(h[0, 0, 0], want.float())


def test_the_table_is_the_rel_pos_mlp_by_hand():
    """timm ``RelPosMlp`` (mode "cr") offset by offset, and its rows in the
    order of the swin index the attention gathers them by."""
    torch.manual_seed(0)
    p, heads = 3, 2
    rel = maxxvit.RelPosMlp(p, heads, hidden=16)
    w1, b1 = rel.mlp.fc1.weight.double(), rel.mlp.fc1.bias.double()
    w2, b2 = rel.mlp.fc2.weight.double(), rel.mlp.fc2.bias.double()
    rows = []
    for dy in range(-(p - 1), p):
        for dx in range(-(p - 1), p):
            u = torch.tensor([math.copysign(math.log1p(abs(dy)), dy),
                              math.copysign(math.log1p(abs(dx)), dx)], dtype=torch.float64)
            rows.append(w2 @ torch.relu(w1 @ u + b1) + b2)
    torch.testing.assert_close(rel().double(), torch.stack(rows), rtol=1e-6, atol=1e-6)
    # token i at (i // p, i % p): row index[i, j] holds the offset of i from j
    u = maxxvit.log_coords(p, torch.device("cpu")).numpy()
    index = rel_position_index(p)
    for i in range(p * p):
        for j in range(p * p):
            dy, dx = i // p - j // p, i % p - j % p
            assert np.allclose(u[index[i, j]], [np.sign(dy) * np.log1p(abs(dy)),
                                                np.sign(dx) * np.log1p(abs(dx))])


def test_the_model_kind_sets_the_size_the_window_and_the_spec():
    assert maxvit.get_model_image_size(KIND) == 256
    assert maxvit.maxvit_window(KIND) == 8
    assert maxvit.is_maxxvit(KIND) and not maxvit.is_maxxvit("maxvit_tiny_rw_224.sw_in1k")
    assert maxvit.maxxvit_spec(KIND)["dims"] == (96, 192, 384, 768)
    assert maxvit.feature_size({"model_kind": KIND}) == 768
    with pytest.raises(ValueError):
        maxvit.maxvit_spec(KIND)
    with pytest.raises(ValueError):
        maxvit.maxxvit_spec("maxxvit_rmlp_huge_rw_256")
    assert maxvit.get_model_image_size("maxvit_tiny_rw_224.sw_in1k") == 224


# (kind, backbone parameters; with timm's 1000-class head and final norm, the
# totals are 66,010,612 / 29,636,592 / 16,779,692: timm's published 66.01 M,
# 29.64 M and 16.78 M)
@pytest.mark.parametrize("kind,count", [("maxxvit_rmlp_small_rw_256.sw_in1k", 65_240_076),
                                        ("maxxvit_rmlp_tiny_rw_256.sw_in1k", 29_122_568),
                                        ("maxxvit_rmlp_nano_rw_256.sw_in1k", 16_265_668)])
def test_the_published_backbones_count_their_parameters(kind, count):
    config = normalize_config(dict(MODEL, model_kind=kind))
    with torch.device("meta"):
        model = maxvit.MmMaxViT(config)
    n = sum(p.numel() for name, p in model.named_parameters()
            if name.startswith("maxvit_backbone."))
    assert n == count
    dims = maxvit.maxxvit_spec(kind)["dims"]
    assert n + dims[-1] * 1000 + 1000 + 2 * dims[-1] == pytest.approx(
        {"maxxvit_rmlp_small": 66.01e6, "maxxvit_rmlp_tiny": 29.64e6,
         "maxxvit_rmlp_nano": 16.78e6}[kind.split("_rw")[0]], abs=5e3)


def test_each_half_takes_its_kernel_and_records_its_spans(tiny, monkeypatch):
    """Stride-1 ConvNeXt halves go to ``convnext_block_fused``, stride-2 ones
    to ``fused_ln_mlp`` (eps 1e-6) after the grouped conv, each attention
    half to ``ln_qkv`` → ``partition_attention`` at P and its MLP half to
    ``fused_ln_mlp`` (eps 1e-5) with γ₂; one table a launch."""
    spec = dict(TINY, depths=(2, 1, 1, 2))
    cfg, model, weights = tiny(spec)
    calls = []

    def counting(name, fn):
        def run(*args, **kwargs):
            calls.append((name, kwargs.get("eps"), args[2] if name == "attention" else None))
            return fn(*args, **kwargs)
        return run
    monkeypatch.setattr(maxxvit, "convnext_block_fused",
                        counting("block", maxxvit.convnext_block_fused))
    monkeypatch.setattr(maxxvit, "fused_ln_mlp", counting("conv_mlp", maxxvit.fused_ln_mlp))
    monkeypatch.setattr(maxvit, "fused_ln_mlp", counting("mlp", maxvit.fused_ln_mlp))
    monkeypatch.setattr(maxvit, "ln_qkv", counting("ln_qkv", maxvit.ln_qkv))
    monkeypatch.setattr(maxvit, "partition_attention",
                        counting("attention", maxvit.partition_attention))
    images, meta = _inputs(2)
    profiling.reset_counters()
    with torch.no_grad(), torch.profiler.profile() as prof:
        model(images, meta)
    names = [c[0] for c in calls]
    assert names.count("block") == 2 and names.count("conv_mlp") == 4
    assert names.count("ln_qkv") == names.count("attention") == names.count("mlp") == 12
    assert {c[1] for c in calls if c[0] == "conv_mlp"} == {1e-6}
    assert {c[1] for c in calls if c[0] == "mlp"} == {1e-5}
    assert {c[2] for c in calls if c[0] == "attention"} == {2}
    assert profiling.counters()["maxxvit.relpos_tables"] == 12
    spans = [e.name for e in prof.events()]
    assert spans.count("maxxvit.conv") == 6 and spans.count("maxxvit.attention") == 6
    assert spans.count("maxxvit.relpos") == 12
    profiling.reset_counters()
