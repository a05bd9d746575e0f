"""The index math of the bfloat16 CUDA kernels' tiling, held on the CPU.

The kernels themselves (``btsbot_tpu_torch/csrc``) only run on the card,
where ``chip_smoke.py`` holds them to their plain versions.  What can be
held here is the design they rest on, as small torch emulations kept in
this file (nothing on the port's main path imports them):

* the depthwise taps of a tile of TM consecutive flattened pixels read only
  the contiguous run ``[row0 - halo, row0 + TM + halo)`` of that index, with
  per-tap bounds masks inside the sample, ``halo = ry * W + rx``;
* the hidden dimension walked in chunks of 64 units with float accumulation
  across chunks and one rounding at the end gives the plain version's
  result (f32 rtol 1e-5: summation order; bf16 rtol = atol 3e-2: rounding
  order), and through it the JAX kernel's in interpret mode;
* the 128-byte swizzle of the normalised-rows tile and of a weight unit is
  a bijection onto the tile's 16-byte groups;
* the wrappers raise on a weight that is misaligned or not contiguous.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btsbot_tpu.ops.pallas_mlp import fused_ln_mlp as jax_fused_ln_mlp
from btsbot_tpu_torch.models.common import gelu
from btsbot_tpu_torch.ops import _build
from btsbot_tpu_torch.ops import convnext_block as port_block
from btsbot_tpu_torch.ops import ln_mlp as port_mlp

PICO = [(15, 64), (7, 128), (3, 256), (1, 512)]  # side, C of the four stages
# Tile heights to emulate at each width: the kernels' own today (on the card
# chip_smoke.py asks the built library for them) and one that is not theirs;
# what is held here is true of any height.
TILE_ROWS = {64: (128, 40), 128: (128, 72), 256: (128, 24), 512: (64, 128)}


# ------------------------- (i) the halo range -------------------------

def reach(h, w):
    """How far a tap can reach inside an (h, w) map, and the run of
    flattened rows that covers it (csrc/convnext_block.cu reach_of)."""
    ry, rx = min(3, h - 1), min(3, w - 1)
    return ry, rx, ry * w + rx


def tile_depthwise(x, dw_w, row0, tm):
    """Depthwise 7x7 SAME conv (float32, no bias) of flattened pixels
    row0 .. row0 + tm of NHWC x, reading nothing but the clipped run
    [row0 - halo, row0 + tm + halo) of the flattened index."""
    b, h, w, c = x.shape
    m = b * h * w
    ry, rx, halo = reach(h, w)
    lo, hi = max(row0 - halo, 0), min(row0 + tm + halo, m)
    tile = torch.full((tm + 2 * halo, c), float("nan"))  # unloaded rows poison
    tile[lo - (row0 - halo):hi - (row0 - halo)] = x.reshape(m, c)[lo:hi].float()
    wt = dw_w.float().reshape(c, 7, 7)
    out = torch.zeros(min(tm, m - row0), c)
    for r in range(out.shape[0]):
        rem = (row0 + r) % (h * w)
        py, px = divmod(rem, w)
        for dy in range(-ry, ry + 1):
            for dx in range(-rx, rx + 1):
                if 0 <= py + dy < h and 0 <= px + dx < w:
                    out[r] += tile[r + halo + dy * w + dx] * wt[:, dy + 3, dx + 3]
    return out


@pytest.mark.parametrize("which", [0, 1], ids=["kernel_height", "other_height"])
@pytest.mark.parametrize("side,c", PICO)
def test_halo_range_covers_every_tap_of_a_tile(side, c, which):
    rng = np.random.default_rng(side)
    b = 3 if side > 1 else 150
    tm = TILE_ROWS[c][which]
    m = b * side * side
    assert m % tm != 0  # the last tile is ragged
    x = torch.tensor(rng.normal(size=(b, side, side, c)), dtype=torch.float32)
    dw_w = torch.tensor(rng.normal(size=(c, 1, 7, 7)) * 0.1, dtype=torch.float32)
    want = port_block.depthwise_conv7_reference(x, dw_w, torch.zeros(c)).reshape(m, c)
    spans_samples = False
    for row0 in range(0, m, tm):
        got = tile_depthwise(x, dw_w, row0, tm)
        assert torch.isfinite(got).all()  # no tap read a row outside the run
        torch.testing.assert_close(got, want[row0:row0 + tm], rtol=1e-5, atol=1e-5)
        spans_samples |= row0 // (side * side) != (row0 + got.shape[0] - 1) // (side * side)
    assert spans_samples


def test_halo_is_the_least_run_at_small_maps():
    assert reach(1, 1) == (0, 0, 0)  # only the centre tap is in bounds
    assert reach(3, 3) == (2, 2, 8)
    assert reach(15, 15) == (3, 3, 48)


# ------------------------- (ii) chunked hidden dimension -------------------------

def chunked_ln_mlp(h, shortcut, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gamma, chunk=64):
    """The kernels' order of work: the hidden dimension in chunks, the second
    product accumulated in float32 across chunks and rounded once."""
    dtype = h.dtype

    def r(v):  # round to the storage type, continue in float32
        return v.to(dtype).float()

    xn = r(r(r(port_mlp.layer_norm_f32(h)) * ln_w.float()) + ln_b.float())
    acc = torch.zeros(h.shape[0], h.shape[1])
    for j0 in range(0, fc1_w.shape[0], chunk):
        hid = r(r(xn @ fc1_w[j0:j0 + chunk].float().T) + fc1_b[j0:j0 + chunk].float())
        g = gelu(hid.to(dtype)).float()
        acc += g @ fc2_w[:, j0:j0 + chunk].float().T
    y = r(r(r(acc) + fc2_b.float()) * gamma.float())
    return (shortcut.float() + y).to(dtype)


def _mlp_case(c, m, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)  # noqa: E731
    return dict(h=f(m, c), res=f(m, c), lns=1 + f(c, k=0.1), lnb=f(c, k=0.1),
                w1=f(4 * c, c, k=0.1), b1=f(4 * c, k=0.1), w2=f(c, 4 * c, k=0.1),
                b2=f(c, k=0.1), gamma=f(c, k=0.5))


def _torch_case(p, dtype):
    return [torch.tensor(p[k]).to(dtype) for k in
            ("h", "res", "lns", "lnb", "w1", "b1", "w2", "b2", "gamma")]


@pytest.mark.parametrize("c", [32, 48])  # two and three chunks of 64 hidden units
def test_chunked_hidden_matches_plain_and_jax_f32(c):
    p = _mlp_case(c, 37, seed=c)
    args = _torch_case(p, torch.float32)
    got = chunked_ln_mlp(*args)
    torch.testing.assert_close(got, port_mlp.ln_mlp_reference(*args), rtol=1e-5, atol=1e-5)
    jargs = [jnp.asarray(p[k]) for k in ("h", "res", "lns", "lnb")] \
        + [jnp.asarray(p["w1"].T), jnp.asarray(p["b1"]), jnp.asarray(p["w2"].T),
           jnp.asarray(p["b2"]), jnp.asarray(p["gamma"])]
    want = np.asarray(jax_fused_ln_mlp(*jargs, True))  # Pallas, interpret mode
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [32, 48])
def test_chunked_hidden_matches_plain_bf16(c):
    args = _torch_case(_mlp_case(c, 37, seed=100 + c), torch.bfloat16)
    got = chunked_ln_mlp(*args)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), port_mlp.ln_mlp_reference(*args).float(),
                               rtol=3e-2, atol=3e-2)


# ------------------------- (iii) the 128-byte swizzle -------------------------

def swizzled_offset(row, group, rows):
    """Byte offset of 16-byte group `group` (8 bf16 channels) of row `row` in
    a tile of `rows` rows kept as slabs of 64 channels, [C/64][rows][64],
    with the 128-byte swizzle (csrc/hopper_mlp.cuh layer_norm_to_xn)."""
    slab, g = group >> 3, group & 7
    return slab * rows * 128 + row * 128 + ((g ^ (row & 7)) << 4)


@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_swizzle_is_a_bijection_on_the_tile(c):
    rows = TILE_ROWS[c][0]
    offsets = {swizzled_offset(r, g, rows) for r in range(rows) for g in range(c // 8)}
    assert offsets == set(range(0, rows * c * 2, 16))
    # a 16-byte group never leaves its 128-byte row: the TMA unit (64 rows of
    # one slab) and the wgmma descriptor (8-row groups 1024 bytes apart) see
    # the same rows
    for r in range(rows):
        for g in range(c // 8):
            off = swizzled_offset(r, g, rows) - (g >> 3) * rows * 128
            assert off // 128 == r


def test_swizzle_spreads_a_column_over_all_banks():
    """The eight rows of an 8-row group put one 16-byte column group into
    eight different 16-byte bank groups."""
    for g in range(8):
        assert {swizzled_offset(r, g, 64) % 128 for r in range(8)} == set(range(0, 128, 16))


# ------------------------- (iv) operands the kernels refuse -------------------------

def _block_args(c=64):
    x = torch.zeros(2, 3, 3, c)
    return [x, torch.zeros(c, 1, 7, 7), torch.zeros(c), torch.ones(c), torch.zeros(c),
            torch.zeros(4 * c, c), torch.zeros(4 * c), torch.zeros(c, 4 * c),
            torch.zeros(c), torch.zeros(c)]


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is a CUDA one: it passes the wrappers' device
    check and reaches the checks behind it."""
    is_cuda = property(lambda self: True)


def _misaligned(shape):
    n = int(np.prod(shape))
    t = torch.zeros(n + 1)[1:].reshape(shape)  # 4 bytes off a 16-byte line
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    return t


@pytest.mark.parametrize("which", ["block", "ln_mlp"])
@pytest.mark.parametrize("fault", ["not contiguous", "not 16-byte aligned"])
def test_wrappers_raise_on_a_weight_the_kernels_do_not_take(which, fault, monkeypatch):
    """Past the device check (the input here stands in for a CUDA tensor) a
    weight that is not contiguous or not on a 16-byte line raises before any
    launch: no quiet copy, no fall back to the plain version."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("reached the launch"))
    args = _block_args()
    args[0] = args[0].as_subclass(_OnCard)
    c = args[0].shape[-1]
    if fault == "not contiguous":
        args[5] = torch.zeros(c, 4 * c).T  # fc1.weight as a transposed view
    else:
        args[7] = _misaligned((c, 4 * c))  # fc2.weight
    if which == "block":
        fn = port_block._FusedBlock.apply
    else:
        fn = port_mlp._FusedLnMlp.apply
        args = [args[0].reshape(-1, c), args[0].reshape(-1, c)] + args[3:]
    with pytest.raises(ValueError, match=fault):
        fn(*args)
