"""The bfloat16 tensor-core kernels at every other width ("wgmma_any"),
their design held on the CPU.

The kernels (``btsbot_tpu_torch/csrc/hopper_mlp.cuh`` with ``Plan<CP,
true>``, ``ln_mlp.cu``, ``convnext_block.cu``) only run on the card, where
``chip_smoke.py`` holds them to their plain versions.  What can be held here
is what they rest on, as small torch emulations kept in this file (nothing
on the port's main path imports them):

* a width C padded inside the kernel to CP = 64 ceil(C / 64), the weights
  brought in as 64 x 64 boxes whose part past the real extents is zeros
  (the TMA's out-of-bounds fill), the normalised rows with zeros written in
  the padded channels, the LayerNorm over the real C, and the last hidden
  chunk partial, gives the plain version's result and the JAX kernel's in
  interpret mode (f32 rtol 1e-5: summation order; bf16 rtol = atol 3e-2:
  rounding order);
* at CP > 512 the output columns split over blocks, each recomputing the
  first product, gives each column's full sum rounded once: the same bits
  as one block taking every column;
* a pad left with NaN makes every output NaN (why the zeros are written);
* the plan's split of the output columns over blocks and warpgroups covers
  every column exactly once, and the producer's order of weight units is
  the one both warpgroups consume.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btsbot_tpu.ops.pallas_mlp import fused_ln_mlp as jax_fused_ln_mlp
from btsbot_tpu_torch.models.common import gelu
from btsbot_tpu_torch.ops import ln_mlp as port_mlp

# The padded widths the kernels are built for (hopper_mlp.cuh BTS_ANY_WIDTHS).
ANY_WIDTHS = (64, 128, 192, 256, 320, 384, 448, 512, 640, 768, 1024)


def padded_width(c):
    """The CP a real width C runs at (hopper_mlp.cuh any_width_plan)."""
    if c <= 512:
        return -(-c // 64) * 64
    return 640 if c <= 640 else 768 if c <= 768 else 1024


def plan(cp):
    """The constants of hopper_mlp.cuh Plan<CP>: K slabs, slices of the
    output columns over blocks, 64-column blocks a slice, warpgroups across
    the columns, accumulator blocks a warpgroup, rows a block, and the
    LayerNorm's lanes a row and 8-channel vectors a lane."""
    ks = cp // 64
    slices = (ks + 7) // 8
    sb = -(-ks // slices)
    cs = 2 if sb > 4 else 1
    g8 = cp // 8
    lpp = 32 if g8 >= 32 else 16 if g8 >= 16 else 8
    return dict(KS=ks, SLICES=slices, SB=sb, CS=cs, NBW=-(-sb // cs), TM=64 * (2 // cs),
                LPP=lpp, VEC=-(-g8 // lpp), G8=g8)


def slice_blocks(p, y):
    """(blk0, nb): the 64-column blocks block row y of the grid owns."""
    blk0 = y * p["SB"]
    return blk0, min(p["SB"], p["KS"] - blk0)


def owned_blocks(p, y, cs):
    """The output blocks warpgroup cs of slice y accumulates, acc[k] in k
    order (Slice::has)."""
    blk0, nb = slice_blocks(p, y)
    return [blk0 + cs * p["NBW"] + k for k in range(p["NBW"]) if cs * p["NBW"] + k < nb]


def producer_units(p, y, hidden):
    """The weight units the producer thread sends, in order
    (produce_weights): per chunk the KS slabs of fc1, then one fc2 unit per
    accumulator step, alternating between the warpgroups."""
    blk0, nb = slice_blocks(p, y)
    units = []
    for j0 in range(0, hidden, 64):
        units += [("w1", j0, u) for u in range(p["KS"])]
        units += [("w2", j0, blk0 + cs * p["NBW"] + k) for k in range(p["NBW"])
                  for cs in range(p["CS"]) if cs * p["NBW"] + k < nb]
    return units


def consumer_units(p, y, cs, hidden):
    """What warpgroup cs waits for, in order (consume_mlp), and the unit it
    multiplies into each accumulator block."""
    blk0, nb = slice_blocks(p, y)
    seen, products = [], []
    for j0 in range(0, hidden, 64):
        seen += [("w1", j0, u) for u in range(p["KS"])]
        for k in range(p["NBW"]):
            for c2 in range(p["CS"]):
                if c2 * p["NBW"] + k < nb:
                    unit = ("w2", j0, blk0 + c2 * p["NBW"] + k)
                    seen.append(unit)
                    if c2 == cs:
                        products.append((k, unit))
    return seen, products


# ------------------------- (i) the plan -------------------------

@pytest.mark.parametrize("cp", ANY_WIDTHS)
def test_column_split_covers_every_column_once(cp):
    p = plan(cp)
    assert p["TM"] % (256 // p["LPP"]) == 0  # row groups of the LayerNorm
    assert p["NBW"] <= 4  # a warpgroup's accumulator: at most (64, 256) floats
    owned = [b for y in range(p["SLICES"]) for cs in range(p["CS"])
             for b in owned_blocks(p, y, cs)]
    assert sorted(owned) == list(range(p["KS"]))  # each 64-column block once
    hidden = 3 * cp - 40  # a partial last chunk
    for y in range(p["SLICES"]):
        sent = producer_units(p, y, hidden)
        for cs in range(p["CS"]):
            seen, products = consumer_units(p, y, cs, hidden)
            assert seen == sent  # both warpgroups walk the producer's ring
            mine = owned_blocks(p, y, cs)
            assert [(k, u[2]) for k, u in products] == [
                (k, b) for _ in range(0, hidden, 64) for k, b in enumerate(mine)]
    # the real widths that run at this CP: each stored column exactly once,
    # and the LayerNorm's vectors cover the real channels once
    for c in range(max(8, cp - 64 + 8), cp + 1, 8):
        if padded_width(c) != cp:
            continue
        cols = [b * 64 + j for y in range(p["SLICES"]) for cs in range(p["CS"])
                for b in owned_blocks(p, y, cs) for j in range(64) if b * 64 + j < c]
        assert sorted(cols) == list(range(c))
        vecs = [vv * p["LPP"] + lane for vv in range(p["VEC"]) for lane in range(p["LPP"])]
        assert sorted(g for g in vecs if g * 8 < c) == list(range(c // 8))
        assert all(g < p["G8"] for g in vecs if g * 8 < cp)


def test_plan_keeps_the_tuned_widths():
    """At C = 64 / 128 / 256 / 512 the plan is the one the tuned kernels
    had: 128 rows and one warpgroup across the columns up to 256, 64 rows
    and two warpgroups of 256 columns at 512, one block across them."""
    got = {cp: tuple(plan(cp)[k] for k in ("TM", "CS", "NBW", "SLICES", "LPP", "VEC"))
           for cp in (64, 128, 256, 512)}
    assert got == {64: (128, 1, 1, 1, 8, 1), 128: (128, 1, 2, 1, 16, 1),
                   256: (128, 1, 4, 1, 32, 1), 512: (64, 2, 4, 1, 32, 2)}
    assert {cp: plan(cp)["SLICES"] for cp in (640, 768, 1024)} == {640: 2, 768: 2, 1024: 2}
    assert [padded_width(c) for c in (40, 48, 80, 96, 160, 192, 320, 384, 520, 640, 768,
                                      1024)] == [64, 64, 128, 128, 192, 192, 320, 384, 640,
                                                 640, 768, 1024]


# ------------------------- (ii) the padded products -------------------------

def box(w, r0, c0):
    """A 64 x 64 box of w at (row r0, column c0), as the TMA brings it in:
    the part past w's real extents is zeros."""
    out = torch.zeros(64, 64)
    part = w[r0:r0 + 64, c0:c0 + 64].float()
    out[:part.shape[0], :part.shape[1]] = part
    return out


def emulate_wgmma_any(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, pad=0.0):
    """The kernels' order of work at width C padded to CP: Xn with `pad` in
    the channels past C, per slice and warpgroup the hidden dimension in
    chunks of 64 (the first product over all CP/64 slabs of boxes, the
    second into the warpgroup's accumulator blocks in float32), each output
    column rounded once at the end and stored once."""
    dtype = h.dtype
    m, c = h.shape
    hidden = w1.shape[0]
    cp = padded_width(c)
    p = plan(cp)

    def r(v):  # round to the storage type, continue in float32
        return v.to(dtype).float()

    xn = torch.full((m, cp), pad)
    xn[:, :c] = r(r(r(port_mlp.layer_norm_f32(h)) * ln_w.float()) + ln_b.float())
    b1p = torch.zeros(-(-hidden // 64) * 64)
    b1p[:hidden] = b1.float()  # read with a mask
    out = torch.full((m, c), float("nan"))
    for y in range(p["SLICES"]):
        for cs in range(p["CS"]):
            blocks = owned_blocks(p, y, cs)
            acc = {b: torch.zeros(m, 64) for b in blocks}
            for j0 in range(0, hidden, 64):
                hh = torch.zeros(m, 64)
                for u in range(p["KS"]):
                    hh += xn[:, u * 64:u * 64 + 64] @ box(w1, j0, u * 64).T
                g = gelu(r(r(hh) + b1p[j0:j0 + 64]).to(dtype)).float()
                for b in blocks:
                    acc[b] += g @ box(w2, b * 64, j0).T
            for b in blocks:
                n = min(64, c - b * 64)
                if n <= 0:
                    continue
                cols = slice(b * 64, b * 64 + n)
                z = r(r(r(acc[b][:, :n]) + b2[cols].float()) * gamma[cols].float())
                out[:, cols] = (res[:, cols].float() + z).to(dtype).float()
    return out.to(dtype)


def _case(c, hidden, m, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)  # noqa: E731
    return dict(h=f(m, c), res=f(m, c), lns=1 + f(c, k=0.1), lnb=f(c, k=0.1),
                w1=f(hidden, c, k=0.1), b1=f(hidden, k=0.1), w2=f(c, hidden, k=0.1),
                b2=f(c, k=0.1), gamma=f(c, k=0.5))


KEYS = ("h", "res", "lns", "lnb", "w1", "b1", "w2", "b2", "gamma")
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


def _jax(p, dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    a = {k: jnp.asarray(p[k], dtype=jd) for k in KEYS}
    out = jax_fused_ln_mlp(a["h"], a["res"], a["lns"], a["lnb"], a["w1"].T, a["b1"],
                           a["w2"].T, a["b2"], a["gamma"], True)  # Pallas, interpret mode
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("ratio", [2, 3, 4])
@pytest.mark.parametrize("c", [40, 80, 160, 320])
def test_zero_filled_boxes_match_plain_and_jax(c, ratio, dtype):
    p = _case(c, ratio * c, 37, seed=c + ratio)
    args = [torch.tensor(p[k]).to(dtype) for k in KEYS]
    got = emulate_wgmma_any(*args)
    assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), port_mlp.ln_mlp_reference(*args).float(),
                               **TOL[dtype])
    np.testing.assert_allclose(got.float().numpy(), _jax(p, dtype), **TOL[dtype])


@pytest.mark.parametrize("c", [640, 1024])
def test_column_split_rounds_each_sum_once(c):
    """Two slices of output columns, each recomputing the first product,
    give exactly the bits of one block taking all columns (each column's
    sum over the hidden units complete in one block, rounded once), within
    one bf16 rounding of the plain version."""
    p = _case(c, 4 * c, 9, seed=c)
    args = [torch.tensor(p[k]).to(torch.bfloat16) for k in KEYS]
    assert plan(padded_width(c))["SLICES"] == 2
    got = emulate_wgmma_any(*args)
    assert torch.equal(got, _one_slice(args))
    torch.testing.assert_close(got.float(), port_mlp.ln_mlp_reference(*args).float(),
                               **TOL[torch.bfloat16])


def _one_slice(args):
    """The same products with every output block in one block (no split):
    one warpgroup's accumulator per 64 columns, summed over the same chunks
    in the same order."""
    h, res, ln_w, ln_b, w1, b1, w2, b2, gamma = args
    dtype, (m, c), hidden = h.dtype, h.shape, w1.shape[0]

    def r(v):
        return v.to(dtype).float()

    cp = padded_width(c)
    xn = torch.zeros(m, cp)
    xn[:, :c] = r(r(r(port_mlp.layer_norm_f32(h)) * ln_w.float()) + ln_b.float())
    acc = torch.zeros(m, cp)
    b1p = torch.zeros(-(-hidden // 64) * 64)
    b1p[:hidden] = b1.float()
    for j0 in range(0, hidden, 64):
        hh = torch.zeros(m, 64)
        for u in range(cp // 64):
            hh += xn[:, u * 64:u * 64 + 64] @ box(w1, j0, u * 64).T
        g = gelu(r(r(hh) + b1p[j0:j0 + 64]).to(dtype)).float()
        for b in range(cp // 64):
            acc[:, b * 64:b * 64 + 64] += g @ box(w2, b * 64, j0).T
    z = r(r(r(acc[:, :c]) + b2.float()) * gamma.float())
    return (res.float() + z).to(dtype)


@pytest.mark.parametrize("c", [40, 80])
def test_a_nan_pad_poisons_every_output(c):
    """Shared memory is not cleared between blocks: a NaN left in Xn's
    padded channels meets the zero-filled weight columns, and NaN times
    zero is NaN, in every hidden unit and so in every output."""
    p = _case(c, 4 * c, 16, seed=7)
    args = [torch.tensor(p[k]).to(torch.bfloat16) for k in KEYS]
    assert bool(torch.isfinite(emulate_wgmma_any(*args).float()).all())
    assert bool(torch.isnan(emulate_wgmma_any(*args, pad=float("nan")).float()).all())
