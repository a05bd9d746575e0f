"""MaxViT's LN1 → qkv (``ops/ln_qkv.py``): the plain version against the
modules' chain and the model's calls on the CPU, the benchmark's arithmetic
and reader for it, and ``csrc/ln_qkv.cu`` on the card.

This file imports no JAX, so its ``cuda`` tests run on the card with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_ln_qkv.py -q``.  Tolerances, each with its reason:

* the plain version against the ``LayerNorm`` and ``Linear`` modules, and
  the recompute backward's gradients against the chain's own: bit for bit
  (the same ops on the same tensors);
* on the card, bfloat16: 2^-7 of |plain| (the two sides' final roundings
  one bfloat16 step apart) plus 2^-7 of Σ_k |W_nk · LN(x)_k| (one
  normalised operand a bfloat16 step apart: the kernel and ATen take the
  LayerNorm's float statistics in another order, so an operand near a
  rounding edge can round the other way; the float sums' order adds far
  less), ``bf16_bound``;
* float32: 1e-5 of the largest |plain| (TF32 off; the float sums in another
  order).
"""

from __future__ import annotations

import json

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from btsbot_tpu_torch.models import maxvit
from btsbot_tpu_torch.models.common import LayerNorm, Linear
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.ops import _build
from btsbot_tpu_torch.ops import ln_qkv as lq

SEED = 2**31 + 2207
EPS = maxvit.LN_EPS
TINY_AT_64 = "maxvit_tiny_rw_64.test"  # maxvit_tiny on 64×64 inputs
# (side, C) of maxvit_tiny's 22 launches at 224: a window and a grid half a block
TINY_SHAPES = [(56, 64)] * 4 + [(28, 128)] * 4 + [(14, 256)] * 10 + [(7, 512)] * 4


def _draw(shape, c, dtype, device, seed):
    """A map (..., C) away from mean 0, and LayerNorm gains spread as trained
    ones are, with qkv's weight and bias at nn.Linear's scale."""
    g = torch.Generator().manual_seed(seed)
    x = 2 * torch.randn(*shape, c, generator=g) + 0.5
    ln_w = torch.exp(0.75 * torch.randn(c, generator=g))
    ln_b = 0.3 * torch.randn(c, generator=g)
    w = (2 * torch.rand(3 * c, c, generator=g) - 1) * c ** -0.5
    b = (2 * torch.rand(3 * c, generator=g) - 1) * c ** -0.5
    return x.to(device, dtype), [p.to(device) for p in (ln_w, ln_b, w, b)]


def _modules(params):
    c = params[0].shape[0]
    norm, lin = LayerNorm(c, eps=EPS), Linear(c, 3 * c)
    with torch.no_grad():
        for p, v in zip((norm.weight, norm.bias, lin.weight, lin.bias), params):
            p.copy_(v)
    return norm, lin


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_the_plain_version_is_the_modules_chain_bit_for_bit(c, dtype):
    x, params = _draw((2, 5, 7), c, dtype, "cpu", c)
    norm, lin = _modules(params)
    with torch.no_grad():
        chain = lin(norm(x))
        plain = lq.ln_qkv_reference(x, *params, EPS)
        wrapped = lq.ln_qkv(x, *params, EPS)
    assert plain.shape == (2, 5, 7, 3 * c) and plain.dtype == dtype
    torch.testing.assert_close(plain, chain, rtol=0, atol=0)
    torch.testing.assert_close(wrapped, chain, rtol=0, atol=0)


@pytest.mark.parametrize("train", [False, True])
def test_a_forward_calls_the_wrapper_twice_a_block(train, monkeypatch):
    """maxvit_tiny's 22 attention halves (its depths at narrow widths, 64×64:
    sides 16 → 2, window 2), in the order and at the shapes
    ``benchmark/counts_ln_qkv.py`` reckons them, in eval and in train mode,
    each with its block's LN1 and qkv."""
    from benchmark import counts_ln_qkv, harness

    spec = {"depths": (2, 2, 5, 2), "dims": (32, 64, 64, 96), "stem_width": 16}
    monkeypatch.setitem(maxvit.MAXVIT_CONFIGS, "maxvit_tiny", spec)
    calls = []
    real = maxvit.ln_qkv

    def counting(x, ln_w, ln_b, weight, bias, eps):
        calls.append((x.shape[1], x.shape[3], ln_w, weight, eps))
        return real(x, ln_w, ln_b, weight, bias, eps)
    monkeypatch.setattr(maxvit, "ln_qkv", counting)
    cfg = harness.load_json("configs", "mm_maxvit_tiny")
    model = build_model(dict(cfg["model"], model_kind=TINY_AT_64), device="cpu")
    images, meta = torch.randn(2, 63, 63, 3), torch.randn(2, 25)
    if train:
        model.train()(images, meta).sum().backward()
    else:
        with torch.no_grad():
            model.eval()(images, meta)
    assert [(s, c) for s, c, *_ in calls] == counts_ln_qkv.ln_qkv_shapes(
        dict(cfg, image_size=64, dims=spec["dims"], depths=spec["depths"], stem_width=16))
    assert len(calls) == 22
    halves = [m for m in model.modules() if isinstance(m, maxvit.PartitionAttention)]
    assert len(halves) == 22
    for (*_, w, wq, eps), h in zip(calls, halves):
        assert w is h.norm1.weight and wq is h.attn.qkv.weight and eps == EPS


def test_the_recompute_backward_gives_the_chains_gradients(monkeypatch):
    """The autograd Function (the card's path) with the launch replaced by
    the plain version: every gradient equals the modules' chain's own."""
    monkeypatch.setattr(lq, "_launch_ln_qkv", lq.ln_qkv_reference)
    x, params = _draw((2, 6, 6), 64, torch.float32, "cpu", 11)
    leaves = [x, *params]
    grads = []
    for run in (lambda *a: lq._LnQkv.apply(*a, EPS),
                lambda *a: F.linear(F.layer_norm(a[0], (64,), a[1], a[2], EPS), a[3], a[4])):
        xs = [t.detach().clone().requires_grad_() for t in leaves]
        out = run(*xs)
        out.backward(torch.linspace(-1, 1, out.numel()).reshape(out.shape))
        grads.append([t.grad for t in xs])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_the_launch_refuses_what_the_kernel_does_not_take():
    x, params = _draw((1, 4, 4), 16, torch.float32, "cpu", 0)
    ln_w, ln_b, w, b = params
    with pytest.raises(ValueError, match="multiple of 8"):
        lq._launch_ln_qkv(x[..., :12], ln_w[:12], ln_b[:12], w[:36, :12], b[:36], EPS)
    with pytest.raises(ValueError, match="do not fit"):
        lq._launch_ln_qkv(x, ln_w, ln_b, w[:32], b[:32], EPS)
    with pytest.raises(ValueError, match="do not fit"):
        lq._launch_ln_qkv(x, ln_w, ln_b, w[:, :8].contiguous(), b, EPS)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lq._launch_ln_qkv(x.double(), ln_w, ln_b, w, b, EPS)
    with pytest.raises(ValueError, match="not contiguous"):
        lq._launch_ln_qkv(x.transpose(1, 2), ln_w, ln_b, w, b, EPS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lq._launch_ln_qkv(x, ln_w, ln_b, w, b, EPS)


def test_the_benchmark_reckons_maxvit_tinys_22_launches():
    from benchmark import counts, counts_ln_qkv, harness

    cfg = harness.load_json("configs", "mm_maxvit_tiny")
    assert counts_ln_qkv.ln_qkv_shapes(cfg) == TINY_SHAPES
    # bytes bound every launch but the last stage's, where 6 C² operations a
    # token at 989 TFLOP/s take longer than 8 C bytes at 3.35 TB/s
    want = 0.0
    for side, c in TINY_SHAPES:
        tokens = 3072 * side * side
        moved = (4 * c * tokens + 3 * c * c + 5 * c) * 2
        ops = 6.0 * c * c * tokens
        assert (moved / counts.HBM_BYTES_PER_S > ops / counts.PEAK_FLOPS["bfloat16"]) == (c < 512)
        want += max(moved / counts.HBM_BYTES_PER_S, ops / counts.PEAK_FLOPS["bfloat16"])
    assert counts_ln_qkv.ln_qkv_bound_s(cfg, 3072, "bfloat16") == pytest.approx(want)
    assert 1e3 * want == pytest.approx(13.47, abs=0.01)  # a forward at batch 3072


def test_the_roofline_reader_reads_the_kernels_and_the_rows():
    from benchmark import counts_ln_qkv, harness

    cfg = harness.load_json("configs", "mm_maxvit_tiny")
    read = harness.load_module("layer_metrics", "ln_qkv_roofline.score").read
    trace = harness.Trace(window_s=2.0, kernels=[
        ("void btsbot::qkv::ln_qkv_bf16_kernel<64>(CUtensorMap, ...)", 0.1, 0.004),
        ("void btsbot::qkv::ln_qkv_bf16_kernel<512>(CUtensorMap, ...)", 0.2, 0.006),
        ("void btsbot::hopper::ln_mlp_bf16_kernel<64, false>", 0.3, 0.5),
        ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel", 0.9, 0.7)],
        memcpys=[], host=[])
    run = harness.LayerRun(trace=trace, counters={"forward_rows": [192, 3072]}, cfg=cfg)
    bound = sum(counts_ln_qkv.ln_qkv_bound_s(cfg, r, "bfloat16") for r in (192, 3072))
    assert read(run) == pytest.approx(100 * bound / 0.010)
    # the parent's program: ATen's LayerNorm and cuBLAS, no such kernel
    bare = harness.Trace(window_s=2.0, kernels=trace.kernels[2:], memcpys=[], host=[])
    assert read(harness.LayerRun(trace=bare, counters={"forward_rows": [192]}, cfg=cfg)) is None
    assert read(harness.LayerRun(trace=None, counters={}, cfg=cfg)) is None


def test_the_smoke_checks_every_image_of_the_timed_launch(monkeypatch):
    """``chip_smoke._ln_qkv_check`` runs the plain version a chunk of images
    at a time over the whole batch: an output wrong in the last chunk only
    fails it."""
    monkeypatch.setattr(chip_smoke, "MAXVIT_LN_QKV_CHUNK", 2)
    x, params = _draw((5, 3, 3), 64, torch.bfloat16, "cpu", 3)
    params = [p.to(torch.bfloat16) for p in params]
    got = lq.ln_qkv(x, *params, EPS)
    assert chip_smoke._ln_qkv_check(x, params, got, "bfloat16") == 0.0
    got[4, 1, 2, 3] += 1.0
    with pytest.raises(chip_smoke.PhaseFailed, match=r"\(5, 3, 3, 64\).*1 beyond"):
        chip_smoke._ln_qkv_check(x, params, got, "bfloat16")


def test_the_smoke_reports_a_maxvit_forwards_ln_qkv_launches():
    """The kernels line's ``ln_qkv`` entry: each stage's row times its two
    launches a block (22 a maxvit_tiny forward), and the launches phase
    "maxvit" counted."""
    att = [{"dtype": "bfloat16", "mode": m, "side": s, "kernel_ms": 1.0, "plain_ms": 2.0,
            "bound_ms": 0.5, "max_abs_err": 0.0} for s in (56, 28, 14, 7)
           for m in ("window", "grid")]
    mbc = [{"side": s, "mid": m, "stride": st, "kernel_ms": 1.0, "plain_ms": 3.0,
            "library_ms": 2.0, "bound_ms": 1.0, "max_abs_err": 0.0}
           for s, m, st in chip_smoke.MAXVIT_MBCONVS]
    qkv = [{"side": s, "C": c, "kernel_ms": float(c), "plain_ms": 2.0 * c, "library_ms": 3.0,
            "bound_ms": 0.5, "max_abs_err": 0.001 * s} for s, c in chip_smoke.MAXVIT_STAGES]
    state = {"maxvit_attention": att, "maxvit_mbconv": mbc, "maxvit_ln_qkv": qkv,
             "maxvit_launches": {k: {"serving": 44, "total": 66}
                                 for k in ("partition_attention", "mbconv_dw", "ln_qkv")}}
    entry = {e["name"]: e for e in chip_smoke._maxvit_entries(state)}["ln_qkv"]
    assert entry["launches_a_forward"] == 22 and entry["bound_ms"] == 11
    assert entry["ms"] == sum(c for _, c in TINY_SHAPES)
    assert (entry["plain_ms"], entry["library_ms"]) == (2 * entry["ms"], 66)
    assert entry["max_abs_err"] == 0.056
    assert entry["source"] == "btsbot_tpu_torch/csrc/ln_qkv.cu"
    assert "F.layer_norm + F.linear" in entry["per"]


# ------------------------------ on the card ------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bf16_bound(x, params, eps=EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain bfloat16 output and, for each element, the most a kernel
    that rounds where it rounds may differ from it (module docstring)."""
    ln_w, ln_b, w, _ = params
    want = lq.ln_qkv_reference(x, *params, eps)
    xn = F.layer_norm(x, (x.shape[-1],), ln_w.to(x.dtype), ln_b.to(x.dtype), eps)
    spread = xn.float().abs() @ w.to(x.dtype).float().abs().t()
    return want, 2.0 ** -7 * (want.float().abs() + spread)


# (batch, side, C): maxvit_tiny's four stage shapes, then rows that end
# inside a tile (a single partial tile, one row), the other tuned widths, and
# widths the tensor-core kernel does not take (the CUDA cores in bf16 too)
CARD_SHAPES = [(6, 56, 64), (6, 28, 128), (6, 14, 256), (6, 7, 512), (3, 7, 512), (1, 1, 64),
               (2, 9, 192), (5, 5, 320), (2, 3, 384), (3, 4, 448), (2, 7, 96), (2, 3, 768),
               (2, 5, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,side,c", CARD_SHAPES)
def test_kernel_matches_the_plain_version(card, batch, side, c, dtype, monkeypatch):
    x, params = _draw((batch, side, side), c, dtype, card, side * c)
    params = [p.to(dtype) for p in params]
    lib = chip_smoke.CountingLibrary(_build.library)
    monkeypatch.setattr(_build, "library", lib)
    with torch.no_grad():
        got = lq.ln_qkv(x, *params, EPS)
    torch.cuda.synchronize()
    assert lib.launches == {("ln_qkv", None, None, None): 1}
    assert got.shape == (batch, side, side, 3 * c) and got.dtype == dtype
    with torch.no_grad():
        if dtype == torch.float32:
            want = lq.ln_qkv_reference(x, *params, EPS)
            d = (got - want).abs()
            assert float(d.max()) <= 1e-5 * float(want.abs().max()), float(d.max())
        else:
            want, bound = bf16_bound(x, params)
            d = (got.float() - want.float()).abs()
            assert bool((d <= bound).all()), (
                f"{int((d > bound).sum())} of {d.numel()} outputs beyond the bound; worst "
                f"{float((d / bound).max()):.3g} × it; {float((d > 0).float().mean()):.4f} "
                f"differ")


@pytest.mark.cuda
def test_kernel_takes_a_float32_models_parameters_and_its_eps(card):
    """A bf16 map with the parameters as a float32 model holds them (cast
    per launch), and another eps: within the bf16 bound of the plain
    version, which the eps moves."""
    x, params = _draw((4, 14, 14), 256, torch.bfloat16, card, 5)
    x = x * 0.03  # a variance near eps, so eps shows
    with torch.no_grad():
        got = lq.ln_qkv(x, *params, 1e-3)
        other = lq.ln_qkv(x, *params, EPS)
        want, bound = bf16_bound(x, params, 1e-3)
    assert not torch.equal(other, got)
    assert bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.cuda
def test_the_train_backward_matches_the_modules_chain(card):
    """float32 through the kernel's Function: the forward within 1e-5 of the
    modules' chain and every gradient equal to the chain's own (the backward
    recomputes it)."""
    x, params = _draw((2, 14, 14), 128, torch.float32, card, 9)
    norm, lin = _modules([p.cpu() for p in params])
    norm, lin = norm.to(card), lin.to(card)
    xs = [x.clone().requires_grad_(), x.clone().requires_grad_()]
    out = lq.ln_qkv(xs[0], norm.weight, norm.bias, lin.weight, lin.bias, EPS)
    g = torch.randn(out.shape, generator=torch.Generator(device=card).manual_seed(1),
                    device=card)
    out.backward(g)
    grads = [xs[0].grad] + [p.grad.clone() for p in (*norm.parameters(), *lin.parameters())]
    for p in (*norm.parameters(), *lin.parameters()):
        p.grad = None
    chain = lin(norm(xs[1]))
    chain.backward(g)
    want = [xs[1].grad] + [p.grad for p in (*norm.parameters(), *lin.parameters())]
    assert float((out - chain).abs().max()) <= 1e-5 * float(chain.abs().max())
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_scored_batch_makes_22_launches_and_no_aten_layer_norm(card, dtype, tmp_path,
                                                                 monkeypatch):
    """mm_MaxViT at maxvit_tiny's depths through ``AlertScorer``: 22 ``ln_qkv``
    launches a batch through the kernel library, and the traced batch holds
    22 kernels of that name (in bf16 the tensor-core ones) and no ATen
    LayerNorm."""
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
    assert lib.launches[("ln_qkv", None, None, None)] == 22
    kernels = [e["name"] for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]
               if e.get("cat") == "kernel"]
    named = [k for k in kernels if "ln_qkv" in k]
    assert len(named) == 22
    if dtype == torch.bfloat16:
        assert all("ln_qkv_bf16_kernel" in k for k in named), named
    assert not [k for k in kernels if "layer_norm" in k], kernels
    assert bool(torch.isfinite(torch.as_tensor(scores)).all())
