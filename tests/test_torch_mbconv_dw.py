"""MaxViT's MBConv middle (``ops/mbconv_dw.py``): the plain version against
the modules' chain and the model's calls on the CPU, the benchmark's
arithmetic for it, and ``csrc/mbconv_dw.cu`` on the card.

This file imports no JAX, so its ``cuda`` tests run on the card with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_mbconv_dw.py -q``.  Tolerances, each with its reason:

* the plain version against ``MBConv``'s modules, and the recompute
  backward's gradients against the chain's own: bit for bit (the same ops
  on the same views);
* on the card, bfloat16: one bfloat16 ulp at each of the five rounding
  points (BN1, GELU, the conv, BN2, GELU), carried forward through what
  follows it (GELU's slope is at most 1.13, the conv sums |tap| times its
  inputs' error, BN2 multiplies by |scale|), plus 2^-20 at each GELU: the
  float GELUs differ by that much where the tanh form's 1 + tanh(u) cancels
  (x below about -4; ``bf16_bound``);
* float32: rtol 1e-5 / atol 1e-5 against the plain version with cuDNN's
  TF32 off (BatchNorm folded into a scale and shift, the taps summed in
  another order).
"""

from __future__ import annotations

import json

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from btsbot_tpu_torch.models import maxvit
from btsbot_tpu_torch.models.common import batch_norm_nhwc
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.ops import _build
from btsbot_tpu_torch.ops import mbconv_dw as mb

SEED = 2**31 + 1213
EPS = (mb.BN_EPS, mb.BN_EPS)
TINY_AT_64 = "maxvit_tiny_rw_64.test"  # maxvit_tiny on 64×64 inputs
# (input side, mid, stride) of maxvit_tiny's 11 MBConvs at 224
TINY_SHAPES = [(112, 256, 2), (56, 256, 1), (56, 256, 2), (28, 512, 1), (28, 512, 2)] + \
    [(14, 1024, 1)] * 4 + [(14, 1024, 2), (7, 2048, 1)]
GELU_SLOPE = 1.13  # the largest slope of either GELU (1.129 at x = sqrt(2))


def _draw(b, side, c, dtype, device, seed):
    """An input map and MBConv parameters: running statistics away from the
    identity, and BN1's shift drawn so that GELU(BN1(0)) is not 0 (padding
    applied before the activation would show)."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    def norm():
        mean, var = 0.5 * rnd(c), 0.5 + torch.rand(c, generator=g)
        weight = 1 + 0.3 * rnd(c)
        scale = weight / torch.sqrt(var + mb.BN_EPS)
        bias = mean * scale + 0.5 + torch.rand(c, generator=g)  # BN(0) in [0.5, 1.5)
        return tuple(p.to(device) for p in (mean, var, weight, bias))

    h = rnd(b, side, side, c).to(device, dtype)
    return h, norm(), (rnd(c, 1, 3, 3) / 3).to(device), norm()


def _block(in_chs, out_chs, stride, seed):
    torch.manual_seed(seed)
    blk = maxvit.MBConv(in_chs, out_chs, stride).eval()
    with torch.no_grad():
        for bn in (blk.pre_norm, blk.norm1, blk.norm2):
            bn.running_mean.normal_(0, 0.5)
            bn.running_var.uniform_(0.5, 1.5)
            bn.weight.normal_(1, 0.3)
            bn.bias.normal_(0, 0.5)
    return blk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("side", [8, 7])
def test_the_plain_version_is_the_mbconvs_chain_bit_for_bit(side, stride, dtype):
    blk = _block(8, 16 if stride == 2 else 8, stride, side + stride)
    x = torch.randn(2, side, side, 8).to(dtype)
    with torch.no_grad():
        h = blk.conv1_1x1(blk.pre_norm(x))
        chain = maxvit.gelu(blk.norm2(blk.conv2_kxk(maxvit.gelu(blk.norm1(h)))))
        plain = mb.mbconv_dw_reference(h, maxvit._running(blk.norm1), blk.conv2_kxk.weight,
                                       maxvit._running(blk.norm2), stride)
        wrapped = mb.mbconv_dw(h, maxvit._running(blk.norm1), blk.conv2_kxk.weight,
                               maxvit._running(blk.norm2), stride)
    assert plain.shape == (2, (side - 1) // stride + 1, (side - 1) // stride + 1, 32)
    torch.testing.assert_close(plain, chain, rtol=0, atol=0)
    torch.testing.assert_close(wrapped, chain, rtol=0, atol=0)
    if side % stride == 0:  # the shortcut's 2×2 pool takes even sides only
        with torch.no_grad():
            whole = blk(x)
            want = blk.conv3_1x1(blk.se(chain)) + (x if blk.shortcut is None
                                                   else blk.shortcut(x))
        torch.testing.assert_close(whole, want, rtol=0, atol=0)


@pytest.mark.parametrize("eps", [(1e-3, 1e-5), (1e-5, 0.25)])
def test_each_batchnorm_keeps_its_own_eps(eps):
    """An eval-mode MBConv hands each BatchNorm's eps to the wrapper: the
    block equals its modules' chain bit for bit when the two differ."""
    blk = _block(8, 8, 1, 5)
    blk.norm1.eps, blk.norm2.eps = eps
    x = torch.randn(2, 6, 6, 8)
    with torch.no_grad():
        h = blk.conv1_1x1(blk.pre_norm(x))
        chain = maxvit.gelu(blk.norm2(blk.conv2_kxk(maxvit.gelu(blk.norm1(h)))))
        whole = blk(x)
    torch.testing.assert_close(whole, blk.conv3_1x1(blk.se(chain)) + x, rtol=0, atol=0)
    with torch.no_grad():
        one_eps = mb.mbconv_dw(h, maxvit._running(blk.norm1), blk.conv2_kxk.weight,
                               maxvit._running(blk.norm2), 1, (eps[0], eps[0]))
    assert not torch.equal(one_eps, chain)  # the eps makes a difference at this size


def test_an_eval_forward_calls_the_wrapper_once_an_mbconv_and_a_train_forward_never(
        monkeypatch):
    """maxvit_tiny's 11 MBConvs (its depths at narrow widths, 64×64: sides
    32 → 2, window 2), in the order and at the shapes
    ``benchmark/counts_mbconv.py`` reckons them."""
    from benchmark import counts_mbconv, harness

    spec = {"depths": (2, 2, 5, 2), "dims": (32, 64, 64, 96), "stem_width": 16}
    monkeypatch.setitem(maxvit.MAXVIT_CONFIGS, "maxvit_tiny", spec)
    calls = []
    real = maxvit.mbconv_dw

    def counting(h, norm1, taps, norm2, stride, eps=EPS):
        calls.append((h.shape[1], h.shape[3], stride))
        return real(h, norm1, taps, norm2, stride, eps)
    monkeypatch.setattr(maxvit, "mbconv_dw", counting)
    cfg = harness.load_json("configs", "mm_maxvit_tiny")
    model = build_model(dict(cfg["model"], model_kind=TINY_AT_64), device="cpu")
    images, meta = torch.randn(2, 63, 63, 3), torch.randn(2, 25)
    with torch.no_grad():
        model.eval()(images, meta)
    assert calls == counts_mbconv.mbconv_shapes(dict(cfg, image_size=64, dims=spec["dims"],
                                                     depths=spec["depths"], stem_width=16))
    assert len(calls) == 11
    calls.clear()
    model.train()(images, meta)
    assert calls == []


def test_the_benchmark_reckons_the_issues_eight_shapes():
    from benchmark import counts, counts_mbconv, harness

    cfg = harness.load_json("configs", "mm_maxvit_tiny")
    shapes = counts_mbconv.mbconv_shapes(cfg)
    assert shapes == TINY_SHAPES
    read = sum(s * s * m for s, m, _ in shapes)
    written = sum(((s - 1) // st + 1) ** 2 * m for s, m, st in shapes)
    assert (read, written) == (6_723_584, 3_261_440)
    # 20.0 MB an alert in bf16: 6.0 µs at 3.35 TB/s; the parameters once a launch
    params = sum(9 * m * 2 + 16 * m for _, m, _ in shapes)
    assert counts_mbconv.mbconv_bound_s(cfg, 3072, "bfloat16") == pytest.approx(
        (3072 * (read + written) * 2 + params) / counts.HBM_BYTES_PER_S)
    assert 1e6 * counts_mbconv.mbconv_bound_s(cfg, 1, "bfloat16") == pytest.approx(6.05, abs=0.01)


def test_the_roofline_reader_reads_the_kernels_and_the_rows():
    from benchmark import counts_mbconv, harness

    cfg = harness.load_json("configs", "mm_maxvit_tiny")
    read = harness.load_module("layer_metrics", "mbconv_dw_roofline.score").read
    trace = harness.Trace(window_s=2.0, kernels=[
        ("void btsbot::mbconv::mbconv_dw_kernel<__nv_bfloat16, 2>", 0.1, 0.004),
        ("void btsbot::mbconv::mbconv_dw_kernel<__nv_bfloat16, 1>", 0.2, 0.006),
        ("void cudnn::cnn::conv2d_grouped_direct_kernel", 0.3, 0.5)], memcpys=[], host=[])
    run = harness.LayerRun(trace=trace, counters={"forward_rows": [192, 3072]}, cfg=cfg)
    bound = sum(counts_mbconv.mbconv_bound_s(cfg, r, "bfloat16") for r in (192, 3072))
    assert read(run) == pytest.approx(100 * bound / 0.010)
    # the parent's program: no such kernel
    bare = harness.Trace(window_s=2.0, kernels=trace.kernels[2:], memcpys=[], host=[])
    assert read(harness.LayerRun(trace=bare, counters={"forward_rows": [192]}, cfg=cfg)) is None
    assert read(harness.LayerRun(trace=None, counters={}, cfg=cfg)) is None


@pytest.mark.parametrize("stride", [1, 2])
def test_the_recompute_backward_gives_the_chains_gradients(stride, monkeypatch):
    """The autograd Function (the card's path) with the launch replaced by
    the plain version: every gradient equals the plain chain's own."""
    monkeypatch.setattr(mb, "_launch_mbconv_dw",
                        lambda h, taps, n1, n2, s, eps: mb.mbconv_dw_reference(
                            h, n1, taps, n2, s, eps))
    h, n1, taps, n2 = _draw(2, 7, 16, torch.float32, "cpu", stride)
    leaves = [h, taps, n1[2], n1[3], n2[2], n2[3]]
    grads = []
    for run in (lambda *a: mb._MBConvDw.apply(a[0], a[1], n1[0], n1[1], a[2], a[3], n2[0],
                                               n2[1], a[4], a[5], stride, EPS),
                lambda *a: mb.mbconv_dw_reference(a[0], (n1[0], n1[1], a[2], a[3]), a[1],
                                                  (n2[0], n2[1], a[4], a[5]), stride)):
        xs = [t.detach().clone().requires_grad_() for t in leaves]
        out = run(*xs)
        out.backward(torch.linspace(-1, 1, out.numel()).reshape(out.shape))
        grads.append([x.grad for x in xs])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_the_launch_refuses_what_the_kernel_does_not_take():
    h, n1, taps, n2 = _draw(1, 4, 16, torch.float32, "cpu", 0)
    with pytest.raises(ValueError, match="multiple of 8"):
        mb._launch_mbconv_dw(h[..., :12], taps[:12], [p[:12] for p in n1],
                             [p[:12] for p in n2], 1, EPS)
    with pytest.raises(ValueError, match="stride 1 or 2"):
        mb._launch_mbconv_dw(h, taps, n1, n2, 3, EPS)
    with pytest.raises(ValueError, match="do not fit"):
        mb._launch_mbconv_dw(h, taps[:8], n1, n2, 1, EPS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mb._launch_mbconv_dw(h, taps, n1, n2, 1, EPS)


def test_the_smoke_checks_every_image_of_the_timed_launch(monkeypatch):
    """``chip_smoke._mbconv_check`` runs the plain version a chunk of images
    at a time over the whole batch: an output wrong in the last chunk only
    fails it."""
    monkeypatch.setattr(chip_smoke, "MAXVIT_MBCONV_CHUNK", 2)
    h, n1, taps, n2 = _draw(5, 6, 16, torch.bfloat16, "cpu", 3)
    got = mb.mbconv_dw(h, n1, taps, n2, 2)
    assert chip_smoke._mbconv_check(h, n1, taps, n2, 2, got, "bfloat16") == 0.0
    got[4, 1, 2, 3] += 0.5
    with pytest.raises(chip_smoke.PhaseFailed, match=r"\(5,6,6,16\) stride 2.*1 beyond"):
        chip_smoke._mbconv_check(h, n1, taps, n2, 2, got, "bfloat16")


def test_the_smoke_reports_a_maxvit_forwards_launches_of_both_kernels():
    """The kernels line's entries of ``partition_attention`` and
    ``mbconv_dw``: each shape's row times its launches a maxvit_tiny
    forward (22 and 11), and the launches phase "maxvit" counted."""
    att = [{"dtype": d, "mode": m, "side": s, "kernel_ms": 1.0, "plain_ms": 2.0,
            "bound_ms": 0.5, "max_abs_err": 0.01 * s}
           for d in ("bfloat16", "float32") for s in (56, 28, 14, 7) for m in ("window", "grid")]
    mbc = [{"side": s, "mid": m, "stride": st, "kernel_ms": float(s), "plain_ms": 3.0,
            "library_ms": 2.0, "bound_ms": 1.0, "max_abs_err": 0.0}
           for s, m, st in chip_smoke.MAXVIT_MBCONVS]
    qkv = [{"side": s, "C": c, "kernel_ms": 1.0, "plain_ms": 2.0, "library_ms": 2.0,
            "bound_ms": 0.5, "max_abs_err": 0.0} for s, c in chip_smoke.MAXVIT_STAGES]
    state = {"maxvit_attention": att, "maxvit_mbconv": mbc, "maxvit_ln_qkv": qkv,
             "maxvit_launches": {
                 "partition_attention": {"serving": 44, "total": 66},
                 "mbconv_dw": {"serving": 22, "total": 33},
                 "ln_qkv": {"serving": 44, "total": 66}}}
    entries = {e["name"]: e for e in chip_smoke._maxvit_entries(state)}
    pa, dw = entries["partition_attention"], entries["mbconv_dw"]
    assert (pa["launches_a_forward"], pa["ms"], pa["plain_ms"], pa["bound_ms"]) == (22, 22, 44, 11)
    assert pa["library_ms"] is None and pa["max_abs_err"] == 0.56
    assert dw["launches_a_forward"] == 11 and dw["library_ms"] == 22 and dw["plain_ms"] == 33
    assert dw["ms"] == sum(s for s, _, _ in TINY_SHAPES)  # the 14² stride-1 shape four times
    assert (dw["launches"], dw["launches_by_path"]) == (33, {
        "MaxViT / mm_MaxViT serving and the mm_MaxViT stream": 22})
    assert pa["source"] == "btsbot_tpu_torch/csrc/partition_attention.cu"
    assert dw["source"] == "btsbot_tpu_torch/csrc/mbconv_dw.cu"


# ------------------------------ on the card ------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def bf16_bound(h, norm1, taps, norm2, stride, eps=EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain bfloat16 output and, for each element, the most a kernel
    that rounds where it rounds may differ from it (module docstring)."""
    def bn(x, n):
        return batch_norm_nhwc(x, *n, eps[n is norm2])

    w = taps.to(torch.bfloat16).float().abs()
    c = h.shape[-1]

    def conv(x):
        return F.conv2d(x.permute(0, 3, 1, 2), w, None, stride, 1, 1, c).permute(0, 2, 3, 1)
    floor = 2.0 ** -20
    u = bn(h, norm1)                                        # rounded: BN1
    a = mb.gelu(u)                                          # rounded: GELU
    d_a = GELU_SLOPE * _bf16_ulp(u.float()) + floor
    d_a = d_a + _bf16_ulp(a.float().abs() + d_a)
    y = F.conv2d(a.permute(0, 3, 1, 2), taps.to(a.dtype), None, stride, 1, 1, c).permute(
        0, 2, 3, 1)                                         # rounded: the conv
    d_y = conv(d_a) + 2.0 ** -20 * conv(a.float().abs())
    d_y = d_y + _bf16_ulp(y.float().abs() + d_y)
    z = bn(y, norm2)                                        # rounded: BN2
    scale = (norm2[2].float() / torch.sqrt(norm2[1].float() + eps[1])).abs()
    d_z = scale * d_y
    d_z = d_z + _bf16_ulp(z.float().abs() + d_z)
    out = mb.gelu(z)                                        # rounded: GELU
    d_o = GELU_SLOPE * d_z + floor
    return out, d_o + _bf16_ulp(out.float().abs() + d_o)


# (batch, side, C, stride): the eight shapes of maxvit_tiny's MBConvs at 224,
# then ragged and odd ones.  Where an image is a step or a few, a block walks
# image after image of its slab if the batch has more images than the card
# holds blocks a slab: at 7 × 7 × 2048 (32 slabs) and at 9 × 9 × 24 (one
# slab, three of its eight channel groups live)
CARD_SHAPES = [(4, s, m, st) for s, m, st in dict.fromkeys(TINY_SHAPES)][:-1] + [
    (64, 7, 2048, 1), (3, 13, 136, 2), (3, 13, 136, 1), (600, 9, 24, 2), (5, 1, 24, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,side,c,stride", CARD_SHAPES)
def test_kernel_matches_the_plain_version(card, batch, side, c, stride, dtype, monkeypatch):
    h, n1, taps, n2 = _draw(batch, side, c, dtype, card, side * c + stride)
    lib = chip_smoke.CountingLibrary(_build.library)
    monkeypatch.setattr(_build, "library", lib)
    with torch.no_grad():
        got = mb.mbconv_dw(h, n1, taps, n2, stride)
    torch.cuda.synchronize()
    assert lib.launches == {("mbconv_dw", None, None, None): 1}
    # the padding is live: GELU(BN1(0)) is not 0 in any channel
    assert bool((mb.gelu(n1[3] - n1[0] * n1[2] / torch.sqrt(n1[1] + mb.BN_EPS)) > 0.3).all())
    if dtype == torch.float32:
        old = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            want = mb.mbconv_dw_reference(h, n1, taps, n2, stride)
        finally:
            torch.backends.cudnn.allow_tf32 = old
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        want, bound = bf16_bound(h, n1, taps, n2, stride)
        d = (got.float() - want.float()).abs()
        assert got.shape == want.shape
        assert bool((d <= bound).all()), (
            f"{int((d > bound).sum())} of {d.numel()} outputs beyond the bound; worst "
            f"{float((d / bound).max()):.3g} × it; {float((d > 0).float().mean()):.4f} differ")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_scored_batch_makes_11_launches_and_no_cudnn_depthwise_conv(card, dtype, tmp_path,
                                                                      monkeypatch):
    """mm_MaxViT at maxvit_tiny's depths through ``AlertScorer``: 11
    ``mbconv_dw`` launches a batch through the kernel library, and the traced
    batch holds 11 kernels of that name and no cuDNN grouped convolution."""
    from benchmark import harness
    from btsbot_tpu_torch.engine.serve import AlertScorer
    from btsbot_tpu_torch.utils import profiling

    cfg = harness.load_json("configs", "mm_maxvit_tiny")
    weights = build_model(cfg["model"], device="cpu").state_dict()
    scorer = AlertScorer(cfg["model"], weights, batch_size=64, dtype=dtype, device=card)
    images, meta = harness.make_pool(64, 25, SEED, card)
    scorer(images, meta)  # warm-up
    lib = chip_smoke.CountingLibrary(_build.library)
    monkeypatch.setattr(_build, "library", lib)
    with profiling.trace(str(tmp_path)):
        scores = scorer(images, meta)
    assert lib.launches[("mbconv_dw", None, None, None)] == 11
    kernels = [e["name"] for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]
               if e.get("cat") == "kernel"]
    assert sum("mbconv_dw" in k for k in kernels) == 11
    assert not [k for k in kernels if "grouped" in k or "depthwise" in k.lower()], kernels
    assert bool(torch.isfinite(torch.as_tensor(scores)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("params", ["bfloat16", "mixed"])
@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_takes_the_models_parameters_and_each_eps(card, params, stride):
    """A bf16 map with the parameters as a bf16 model holds them (read in
    place) or of mixed types (float32 copies), and two different eps: within
    the bf16 bound of the plain version."""
    h, n1, taps, n2 = _draw(6, 15, 264, torch.bfloat16, card, 7 + stride)
    n1 = tuple(p.to(torch.bfloat16) for p in n1)
    n2 = tuple(p.to(torch.bfloat16) for p in n2)
    if params == "bfloat16":
        taps = taps.to(torch.bfloat16)
    eps = (1e-3, 0.05)
    with torch.no_grad():
        got = mb.mbconv_dw(h, n1, taps, n2, stride, eps)
        want, bound = bf16_bound(h, n1, taps, n2, stride, eps)
    d = (got.float() - want.float()).abs()
    assert bool((d <= bound).all()), f"worst {float((d / bound).max()):.3g} x the bound"
    with torch.no_grad():
        other = mb.mbconv_dw(h, n1, taps, n2, stride, (eps[0], eps[0]))
    assert not torch.equal(other, got)  # BN2's eps reached the kernel
