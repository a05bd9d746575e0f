"""MaxViT's attention in natural order, its MLP half on ``fused_ln_mlp``,
and the port's mm_MaxViT against the benchmark's plain reference
(``benchmark/reference/mm_maxvit.py``), on the CPU; the kernels on the card.

This file imports no JAX, so its ``cuda`` tests run on the card with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_partition_attention.py -q``.  Tolerances, each with its
reason:

* the natural-order attention half against partition → attention →
  reverse, and the plain attention core against the same core on
  partitioned tokens: bit for bit (the same arithmetic on the same rows);
* the port's float32 logits against the reference's: rtol 1e-4 / atol 1e-4
  (float32 through ~100 convolutions and products, summed in other orders;
  the LayerNorms of the MLP half normalise in another order);
* ``fused_ln_mlp``'s plain version against the reference's MLP half:
  rtol 1e-5 / atol 1e-5 (float32, LayerNorm statistics in another order);
* on the card, the bfloat16 kernel against the plain version: rtol 2^-7,
  atol 2^-7 of the largest |v| (``bf16_tolerance``: a probability or an
  output that rounds to the neighbouring bfloat16, the float sums running in
  another order); float32: rtol 1e-5 / atol 1e-5;
* the ConvNeXt block, ``fused_ln_mlp`` (eps 1e-6) and int8 block kernels:
  bit for bit with the digests of their outputs before the LN eps became an
  argument (``KERNEL_DIGESTS``, recorded on an H100 from the parent tree).
"""

from __future__ import annotations

import collections
import hashlib
import json

import numpy as np
import pytest
import torch

import chip_smoke
from btsbot_tpu_torch.models import maxvit
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.ops import _build
from btsbot_tpu_torch.ops import ln_mlp as port_mlp
from btsbot_tpu_torch.ops import partition_attention as pa

TINY_SPEC = {"depths": (1, 1), "dims": (32, 64), "stem_width": 32}
FULL_WIDTH_SPEC = {"depths": (1, 1, 1, 1), "dims": (64, 128, 256, 512), "stem_width": 64}
SEED = 2**31 + 977
# (side, C) of the four stages at 224, window 7
STAGES = [(56, 64), (28, 128), (14, 256), (7, 512)]


def _bench_config(spec: dict, kind: str, window: int, size: int) -> dict:
    from benchmark import harness

    cfg = harness.load_json("configs", "mm_maxvit_tiny")
    return dict(cfg, dims=list(spec["dims"]), depths=list(spec["depths"]),
                stem_width=spec["stem_width"], window=window, image_size=size,
                model=dict(cfg["model"], model_kind=kind))


@pytest.mark.parametrize("spec,kind,window,size,n", [
    (TINY_SPEC, "maxvit_tiny_rw_64.test", 2, 64, 4),
    (FULL_WIDTH_SPEC, "maxvit_tiny_rw_224.sw_in1k", 7, 224, 4),
])
def test_port_matches_the_benchmark_reference(spec, kind, window, size, n, monkeypatch):
    """Seeded weights as the benchmark draws them (a calibration batch of 4),
    loaded strict; float32 logits on L2-normalised alerts."""
    from benchmark import harness
    from benchmark.drivers import archive_maxvit
    from benchmark.reference.mm_maxvit import Reference, param_spec

    monkeypatch.setitem(maxvit.MAXVIT_CONFIGS, "maxvit_tiny", spec)
    monkeypatch.setattr(archive_maxvit, "CALIBRATION_ALERTS", 4)
    cfg = _bench_config(spec, kind, window, size)
    model = build_model(cfg["model"], device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {name: shape for name, shape, _, _ in param_spec(cfg)}
    weights = archive_maxvit.make_weights(cfg, SEED, torch.float32, "cpu")
    model.load_state_dict(weights, strict=True)
    images, meta = harness.make_pool(n, len(cfg["model"]["metadata_cols"]), SEED, "cpu")
    images, meta = torch.from_numpy(images), torch.from_numpy(meta)
    with torch.no_grad():
        got = model(images, meta).reshape(-1)
        want = Reference(cfg).logits(weights, images, meta)
    assert want.std() > 0.05  # the alerts' logits differ, so a wrong layer shows
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _old_attention_half(module: maxvit.PartitionAttention, x):
    """x + attention over the partitions as the port ran it before: the map
    partitioned first, LN, qkv, the core, proj on the partition's tokens,
    then reversed."""
    part, rev = ((pa.grid_partition, pa.grid_reverse) if module.attn.grid
                 else (pa.window_partition, pa.window_reverse))
    _, h, w, c = x.shape
    t = part(x, module.window)
    attn = module.attn
    bn, n, _ = t.shape
    heads = c // pa.HEAD_DIM
    qkv = attn.qkv(module.norm1(t)).reshape(bn, n, 3, heads, pa.HEAD_DIM)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    q = q * pa.HEAD_DIM ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-2, -1))
    s = s + pa.relative_bias(attn.rel_pos.relative_position_bias_table, module.window).to(
        x.dtype)
    s = torch.softmax(s, dim=-1).to(x.dtype)
    out = attn.proj(torch.matmul(s, v).transpose(1, 2).reshape(bn, n, c))
    return rev(t + out, module.window, h, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", [False, True])
def test_natural_order_attention_equals_partition_attention_reverse(grid, dtype):
    torch.manual_seed(0)
    module = maxvit.PartitionAttention(64, 7, grid=grid).to(dtype)
    with torch.no_grad():
        module.attn.rel_pos.relative_position_bias_table.normal_()
        x = torch.randn(2, 14, 21, 64).to(dtype)
        got = x + module.attn(module.norm1(x))
        want = _old_attention_half(module, x)
        qkv = torch.randn(2, 14, 21, 3 * 64).to(dtype)
        table = module.attn.rel_pos.relative_position_bias_table
        core = pa.partition_attention(qkv, table, 7, grid)
        part, rev = ((pa.grid_partition, pa.grid_reverse) if grid
                     else (pa.window_partition, pa.window_reverse))
        per_part = pa.partition_attention_reference(
            part(qkv, 7).reshape(-1, 7, 7, 3 * 64), table, 7, grid=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the core on the natural map equals the core on each partition, reversed
    torch.testing.assert_close(core, rev(per_part.reshape(-1, 49, 64), 7, 14, 21),
                               rtol=0, atol=0)


def test_grid_and_window_partitions_differ_and_invert():
    x = torch.arange(2 * 6 * 6 * 3, dtype=torch.float32).reshape(2, 6, 6, 3)
    for part, rev in ((pa.window_partition, pa.window_reverse),
                      (pa.grid_partition, pa.grid_reverse)):
        torch.testing.assert_close(rev(part(x, 3), 3, 6, 6), x, rtol=0, atol=0)
    # a window holds neighbours, a grid tokens 6 / 3 = 2 apart
    assert pa.window_partition(x, 3)[0, :3, 0].tolist() == [0.0, 3.0, 6.0]
    assert pa.grid_partition(x, 3)[0, :3, 0].tolist() == [0.0, 6.0, 12.0]


def test_fused_ln_mlp_plain_at_eps_1e5_is_the_references_mlp_half():
    from benchmark.reference.mm_maxvit import Reference

    g = torch.Generator().manual_seed(1)
    c = 64
    # rows of small spread, where eps 1e-5 and 1e-6 give different outputs
    x = 0.01 * torch.randn(300, c, generator=g)
    p = {"h.norm2.weight": 1 + 0.1 * torch.randn(c, generator=g),
         "h.norm2.bias": 0.1 * torch.randn(c, generator=g),
         "h.mlp.fc1.weight": torch.randn(4 * c, c, generator=g) / c ** 0.5,
         "h.mlp.fc1.bias": 0.1 * torch.randn(4 * c, generator=g),
         "h.mlp.fc2.weight": torch.randn(c, 4 * c, generator=g) / (2 * c ** 0.5),
         "h.mlp.fc2.bias": 0.1 * torch.randn(c, generator=g)}
    args = (x, x, p["h.norm2.weight"], p["h.norm2.bias"], p["h.mlp.fc1.weight"],
            p["h.mlp.fc1.bias"], p["h.mlp.fc2.weight"], p["h.mlp.fc2.bias"], torch.ones(c))
    want = Reference({"window": 7})._mlp(p, "h.", x)
    got = port_mlp.fused_ln_mlp(*args, eps=maxvit.LN_EPS)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (port_mlp.fused_ln_mlp(*args) - want).abs().max() > 1e-3  # eps 1e-6 differs
    # under autograd (the card's backward recomputes this plain version)
    xg = x.clone().requires_grad_()
    port_mlp.ln_mlp_reference(xg, xg, *args[2:], eps=maxvit.LN_EPS).sum().backward()
    assert torch.isfinite(xg.grad).all()


def test_a_bias_first_gathered_in_inference_mode_still_trains():
    """The cached bias index outlives the inference-mode call that made it
    and is saved for backward by a later training step."""
    pa._index.cache_clear()
    table = torch.randn(9, 2)
    with torch.inference_mode():
        pa.relative_bias(table, 2)
    table.requires_grad_()
    pa.relative_bias(table, 2).sum().backward()
    assert torch.equal(table.grad, torch.bincount(torch.from_numpy(
        pa.rel_position_index(2).reshape(-1)).long(), minlength=9).float()[:, None].expand(9, 2))


def test_the_reference_swin_index_is_the_ports():
    from benchmark.reference.mm_maxvit import swin_index

    for win in (1, 2, 5, 7, 8):
        np.testing.assert_array_equal(swin_index(win).numpy(), pa.rel_position_index(win))


def test_the_model_makes_one_attention_and_one_mlp_call_a_half(monkeypatch):
    """Two ``partition_attention`` and two ``fused_ln_mlp`` calls a block (22
    at maxvit_tiny's depths), each block's halves inside the two spans."""
    monkeypatch.setitem(maxvit.MAXVIT_CONFIGS, "maxvit_tiny", TINY_SPEC)
    calls = {"attention": [], "mlp": []}
    real_attn, real_mlp = maxvit.partition_attention, maxvit.fused_ln_mlp

    def attn(qkv, table, window, grid=False):
        calls["attention"].append((tuple(qkv.shape), window, grid))
        return real_attn(qkv, table, window, grid)

    def mlp(*args, eps=1e-6):
        calls["mlp"].append(eps)
        return real_mlp(*args, eps=eps)
    monkeypatch.setattr(maxvit, "partition_attention", attn)
    monkeypatch.setattr(maxvit, "fused_ln_mlp", mlp)
    lib = chip_smoke.CountingLibrary(_build.library)
    monkeypatch.setattr(_build, "library", lib)
    cfg = _bench_config(TINY_SPEC, "maxvit_tiny_rw_64.test", 2, 64)
    model = build_model(cfg["model"], device="cpu").eval()
    with torch.profiler.profile() as prof, torch.no_grad():
        model(torch.randn(2, 63, 63, 3), torch.randn(2, 25))
    assert calls["attention"] == [((2, 16, 16, 96), 2, False), ((2, 16, 16, 96), 2, True),
                                  ((2, 8, 8, 192), 2, False), ((2, 8, 8, 192), 2, True)]
    assert calls["mlp"] == [maxvit.LN_EPS] * 4
    names = [e.name for e in prof.events()]
    assert names.count("maxvit.mbconv") == 2 and names.count("maxvit.attention") == 2
    assert not lib.launches  # the CPU: no kernel


# ------------------------------ on the card ------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("side,c", STAGES)
def test_kernel_matches_the_plain_version(card, side, c, grid, dtype, monkeypatch):
    g = torch.Generator(device=card).manual_seed(side + c)
    batch = 64
    qkv = torch.randn(batch, side, side, 3 * c, generator=g, device=card).to(dtype)
    table = torch.randn(169, c // 32, generator=g, device=card)
    lib = chip_smoke.CountingLibrary(_build.library)
    monkeypatch.setattr(_build, "library", lib)
    got = pa.partition_attention(qkv, table, 7, grid)
    torch.cuda.synchronize()
    assert lib.launches == {("partition_attention", None, None, None): 1}
    want = pa.partition_attention_reference(qkv, table, 7, grid)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), **bf16_tolerance(qkv))


@pytest.mark.cuda
def test_a_scored_batch_makes_22_launches_of_each_kernel_and_no_eager_attention(card, tmp_path,
                                                                                monkeypatch):
    """mm_MaxViT at maxvit_tiny's depths through ``AlertScorer`` in bf16: 22
    ``partition_attention`` and 22 ``fused_ln_mlp`` launches a batch through
    the kernel library, the bytes counter read, and the traced batch holds no
    softmax, batched product or SDPA (no eager attention or f32 score
    tensor)."""
    from benchmark import harness
    from btsbot_tpu_torch.engine.serve import AlertScorer
    from btsbot_tpu_torch.utils import profiling

    cfg = harness.load_json("configs", "mm_maxvit_tiny")
    weights = build_model(cfg["model"], device="cpu").state_dict()
    scorer = AlertScorer(cfg["model"], weights, batch_size=64, dtype=torch.bfloat16,
                         device=card)
    images, meta = harness.make_pool(64, 25, SEED, card)
    scorer(images, meta)  # warm-up
    lib = chip_smoke.CountingLibrary(_build.library)
    monkeypatch.setattr(_build, "library", lib)
    with profiling.trace(str(tmp_path)):
        scores = scorer(images, meta)
    launches = collections.Counter(key[0] for key in lib.launches.elements())
    assert launches["partition_attention"] == 22 and launches["fused_ln_mlp"] == 22
    assert profiling.counters()["partition_attention.bytes"] > 0 and np.isfinite(scores).all()
    names = {e["name"] for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]}
    assert not names & {"aten::_softmax", "aten::softmax", "aten::bmm",
                        "aten::scaled_dot_product_attention"}, names


def bf16_tolerance(qkv) -> dict:
    """The bfloat16 kernel against the plain version: a probability that
    rounds to the neighbouring bfloat16 moves an output by at most 2^-8 of
    the largest |v| it weights, and the output's own rounding by 2^-8 of it
    (the float sums run in another order on either side); twice both."""
    v = qkv[..., 2 * qkv.shape[-1] // 3:]
    return {"rtol": 2 ** -7, "atol": 2 ** -7 * float(v.abs().max())}


def _seeded(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale


def kernel_digests(device="cuda") -> dict:
    """SHA-256 of the bfloat16 and float32 outputs of the ConvNeXt block and
    ``fused_ln_mlp`` kernels (eps 1e-6, the default) at pico's stage-0 and
    stage-2 widths, and of the int8 block kernel, on seeded inputs made on
    the CPU."""
    from btsbot_tpu_torch.ops import quantized as tq
    from btsbot_tpu_torch.ops.convnext_block import convnext_block_fused

    out = {}
    for side, c in ((15, 64), (3, 256)):
        x = _seeded((96, side, side, c), c)
        params = [_seeded((c, 1, 7, 7), 1, 0.1), _seeded((c,), 2, 0.1),
                  1 + _seeded((c,), 3, 0.1), _seeded((c,), 4, 0.1),
                  _seeded((4 * c, c), 5, c ** -0.5), _seeded((4 * c,), 6, 0.1),
                  _seeded((c, 4 * c), 7, (4 * c) ** -0.5), _seeded((c,), 8, 0.1),
                  _seeded((c,), 9, 0.5)]
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(device, dtype)
            pd = [p.to(device, dtype) for p in params]
            with torch.no_grad():
                blk = convnext_block_fused(xd, *pd)
                rows = xd.reshape(-1, c)
                mlp = port_mlp.fused_ln_mlp(rows, rows, *pd[2:])
            for name, t in (("convnext_block", blk), ("ln_mlp", mlp)):
                key = f"{name}/{str(dtype).split('.')[-1]}/{side}x{c}"
                out[key] = hashlib.sha256(t.cpu().contiguous().view(torch.uint8).numpy()
                                          .tobytes()).hexdigest()[:16]
        wq = [tq.quantize_weight(w, axes) for w, axes in
              ((tq._hwio(params[0]), (0, 1, 2)), (params[4].t(), (0,)), (params[6].t(), (0,)))]
        dw = (tq.forward_layout("b_dw", wq[0][0]), wq[0][1])
        fc1 = (tq.forward_layout("b_fc1", wq[1][0]), wq[1][1])
        fc2 = (tq.forward_layout("b_fc2", wq[2][0]), wq[2][1])
        on = [(a.to(device), s.to(device)) for a, s in (dw, fc1, fc2)]
        with torch.no_grad():
            q8 = tq.int8_block(x.to(device), 0.03, 0.05, 0.02, on[0], params[1].to(device),
                               params[2].to(device), params[3].to(device), on[1],
                               params[5].to(device), on[2], params[7].to(device),
                               params[8].to(device))
        out[f"int8_block/float32/{side}x{c}"] = hashlib.sha256(
            q8.cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]
    return out


# recorded on an NVIDIA H100 80GB HBM3 from the tree before the eps argument
KERNEL_DIGESTS = {
    "convnext_block/bfloat16/15x64": "2bb8ecef65c6550f",
    "ln_mlp/bfloat16/15x64": "2ff322a2d692862a",
    "convnext_block/float32/15x64": "70a4b6df242a6f54",
    "ln_mlp/float32/15x64": "57833736f9651ce1",
    "int8_block/float32/15x64": "e37ac834ce0cb0ec",
    "convnext_block/bfloat16/3x256": "2a7805e33a04ebce",
    "ln_mlp/bfloat16/3x256": "59cc89d99555dcc0",
    "convnext_block/float32/3x256": "29e66ee68c7027f0",
    "ln_mlp/float32/3x256": "49f3a1738a009477",
    "int8_block/float32/3x256": "9241f63b7908f378",
}


@pytest.mark.cuda
def test_convnext_kernels_are_bit_for_bit_as_before_the_eps_argument(card):
    got = kernel_digests()
    assert KERNEL_DIGESTS and got == KERNEL_DIGESTS, json.dumps(got, indent=1)
