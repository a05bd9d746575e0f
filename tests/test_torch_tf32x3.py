"""The arithmetic of the float32 tensor-core kernels ("tf32x3",
``btsbot_tpu_torch/csrc/tf32x3.cu``), held on the CPU.

The kernels run only on the card, where ``chip_smoke.py`` holds them to
their plain versions.  What is held here is the arithmetic they rest on,
emulated in torch (nothing on the port's path imports this file):

* every operand of both products split as a = hi + lo, hi = tf32(a),
  lo = tf32(a - hi), rounded as ``cvt.rna.tf32.f32`` rounds (to nearest,
  ties away from zero, the low 13 bits cleared);
* the K axis walked in 32-wide slabs in order, three products a slab
  (lo.hi, hi.lo, hi.hi), summed in a float32 accumulator;
* the permutation of K inside a slab that lets a lane's two 16-byte loads
  be its m64k8 A fragments (``slab_source``), and the workspace's size.

The emulation agrees with the JAX kernels in interpret mode and with the
port's plain versions within rtol / atol 1e-5 at C = 64, 80 and 512, hidden
4C and 2C, and is no further from float64 than exact float32 is; one TF32
product is 100 times further and misses 1e-5, which is why the kernels
take three.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btsbot_tpu.ops.pallas_convnext import convnext_block_fused as jax_block
from btsbot_tpu.ops.pallas_mlp import fused_ln_mlp as jax_ln_mlp
from btsbot_tpu_torch.models.common import gelu
from btsbot_tpu_torch.ops import _build
from btsbot_tpu_torch.ops import convnext_block as port_block
from btsbot_tpu_torch.ops import ln_mlp as port_mlp

TOL = dict(rtol=1e-5, atol=1e-5)
KEYS = ("h", "res", "lns", "lnb", "w1", "b1", "w2", "b2", "gamma")


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: half a TF32 ulp
    added to the magnitude, the low 13 bits cleared."""
    u = x.contiguous().view(torch.int32)
    return torch.bitwise_and(u + 0x1000, -0x2000).view(torch.float32)


def tf32_matmul(a: torch.Tensor, w: torch.Tensor, products: int = 3) -> torch.Tensor:
    """a (M, K) . w (N, K)^T as the kernels compute it: 32-wide K slabs in
    order, each the sum of lo.hi, hi.lo and hi.hi (``products`` = 1: hi.hi
    alone, one TF32 product), into a float32 accumulator."""
    a_hi, w_hi = rna_tf32(a), rna_tf32(w)
    a_lo, w_lo = rna_tf32(a - a_hi), rna_tf32(w - w_hi)
    acc = torch.zeros(a.shape[0], w.shape[0], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 32):
        s = slice(k0, k0 + 32)
        if products == 3:
            acc = acc + a_lo[:, s] @ w_hi[:, s].T
            acc = acc + a_hi[:, s] @ w_lo[:, s].T
        acc = acc + a_hi[:, s] @ w_hi[:, s].T
    return acc


def emulate_ln_mlp(h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, products=3):
    """The float32 chain of the kernels: LN in float32, both products as
    ``tf32_matmul``, GELU (erf), bias, γ and shortcut in float32."""
    xn = port_mlp.layer_norm_f32(h) * ln_w + ln_b
    g = gelu(tf32_matmul(xn, w1, products) + b1)
    return res + (tf32_matmul(g, w2, products) + b2) * gamma


def emulate_block(x, dw_w, dw_b, *rest):
    c = x.shape[-1]
    h = port_block.depthwise_conv7_reference(x, dw_w, dw_b).reshape(-1, c)
    return emulate_ln_mlp(h, x.reshape(-1, c), *rest).reshape(x.shape)


def _case(c, hidden, m, seed, wide=False):
    """Rows and parameters from numpy: the weights at the scale of the port's
    own init (uniform within ±fan_in^-1/2, as ``chip_smoke.py`` draws them on
    the card), γ ~ N(0, 0.5); ``wide``: weights ~ N(0, 0.1), which at C = 512
    puts the pre-activations near 2.3 and the outputs near 28."""
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)  # noqa: E731
    u = lambda *s: ((rng.random(size=s) * 2 - 1) * s[-1] ** -0.5).astype(np.float32)  # noqa: E731
    w = (lambda *s: f(*s, k=0.1)) if wide else u
    return dict(h=f(m, c), res=f(m, c), lns=1 + f(c, k=0.1), lnb=f(c, k=0.1),
                w1=w(hidden, c), b1=w(hidden, c)[:, 0].copy(), w2=w(c, hidden),
                b2=w(c, hidden)[:, 0].copy(), gamma=f(c, k=0.5))


def _jax_ln_mlp(p):
    a = {k: jnp.asarray(p[k]) for k in KEYS}
    return np.array(jax_ln_mlp(a["h"], a["res"], a["lns"], a["lnb"], a["w1"].T, a["b1"],
                                 a["w2"].T, a["b2"], a["gamma"], True))  # interpret mode


@pytest.mark.parametrize("ratio", [4, 2])
@pytest.mark.parametrize("c", [64, 80, 512])
def test_three_tf32_products_match_plain_and_jax(c, ratio):
    p = _case(c, ratio * c, 37, seed=c + ratio)
    args = [torch.from_numpy(p[k]) for k in KEYS]
    got = emulate_ln_mlp(*args)
    torch.testing.assert_close(got, port_mlp.ln_mlp_reference(*args), **TOL)
    np.testing.assert_allclose(got.numpy(), _jax_ln_mlp(p), **TOL)


@pytest.mark.parametrize("c", [64, 80, 512])
def test_block_on_a_7x7_map_matches_plain_and_jax(c):
    rng = np.random.default_rng(c)
    p = _case(c, 4 * c, 1, seed=c + 7)
    x = rng.normal(size=(1, 7, 7, c)).astype(np.float32)
    dw = (rng.normal(size=(c, 1, 7, 7)) * 0.1).astype(np.float32)
    dwb = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    rest = [torch.from_numpy(p[k]) for k in KEYS[2:]]
    args = [torch.from_numpy(x), torch.from_numpy(dw), torch.from_numpy(dwb), *rest]
    got = emulate_block(*args)
    torch.testing.assert_close(got, port_block.convnext_block_reference(*args), **TOL)
    want = jax_block(jnp.asarray(x), jnp.asarray(dw.transpose(2, 3, 1, 0)), jnp.asarray(dwb),
                     jnp.asarray(p["lns"]), jnp.asarray(p["lnb"]), jnp.asarray(p["w1"].T),
                     jnp.asarray(p["b1"]), jnp.asarray(p["w2"].T), jnp.asarray(p["b2"]),
                     jnp.asarray(p["gamma"]), True)  # interpret mode
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("c", [64, 512])
def test_three_products_are_as_exact_as_float32_one_is_not(c):
    """At the wide law (outputs up to ~28 at C = 512, hidden 4C) even exact
    float32 is ~1e-5 from the float64 value: the plain version and the JAX
    kernel differ by up to 1e-5 there in their order of summation alone.
    Three TF32 products come no further from float64 than exact float32
    does; one TF32 product comes 100 times further and misses 1e-5."""
    p = _case(c, 4 * c, 37, seed=c + 4, wide=True)
    args = [torch.from_numpy(p[k]) for k in KEYS]
    exact = port_mlp.ln_mlp_reference(*[a.double() for a in args])
    err = lambda got: (torch.as_tensor(got).double() - exact).abs().max().item()  # noqa: E731
    f32 = max(err(port_mlp.ln_mlp_reference(*args)), err(_jax_ln_mlp(p)))
    err3, err1 = err(emulate_ln_mlp(*args)), err(emulate_ln_mlp(*args, products=1))
    assert err3 <= f32 and err1 > 1e-4 and err1 > 100 * err3
    assert not torch.allclose(emulate_ln_mlp(*args, products=1).double(), exact, **TOL)


def test_rna_rounds_to_nearest_ties_away_and_splits_exactly():
    ulp = 2.0 ** -10  # a TF32 ulp at 1.0
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23, 1 + 0.7 * ulp,
                      3.0, 0.0], dtype=torch.float32)
    assert rna_tf32(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0, 0.0]
    v = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi = rna_tf32(v)
    lo = rna_tf32(v - hi)
    assert bool((hi.view(torch.int32) & 0x1FFF == 0).all())
    # hi + lo keeps 22 of float32's 24 bits: |v - hi - lo| <= 2^-22 |v|
    assert bool(((v - hi - lo).abs() <= v.abs() * 2.0 ** -22).all())


def slab_source(p: int) -> int:
    """csrc/tf32x3.cu slab_source: position 8 kk + j of a 32-wide K slab
    reads source column 8 (j % 4) + 2 kk + j // 4."""
    q, kk, j = p % 32, (p % 32) // 8, p % 8
    return p - q + 8 * (j % 4) + 2 * kk + j // 4


def test_k_permutation_is_the_lanes_fragment_layout():
    """Lane t of a quad loads channels 8t .. 8t + 7 of a slab; k-step kk of
    the m64k8 A fragment wants fragment columns t (value 2 kk) and t + 4
    (value 2 kk + 1).  The weights' permutation puts the same source
    columns at those positions, and is a bijection on every slab."""
    assert sorted(slab_source(p) for p in range(96)) == list(range(96))
    for kk in range(4):
        for t in range(4):
            assert slab_source(8 * kk + t) == 8 * t + 2 * kk
            assert slab_source(8 * kk + t + 4) == 8 * t + 2 * kk + 1
    # a product over the permuted K equals the plain one
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float64))
    w = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float64))
    perm = torch.tensor([slab_source(p) for p in range(64)])
    torch.testing.assert_close(a[:, perm] @ w[:, perm].T, a @ w.T, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("c, hidden, taps", [(40, 120, True), (64, 256, False),
                                              (80, 160, True), (1024, 4096, False)])
def test_workspace_is_the_size_the_plan_asks_for(c, hidden, taps, monkeypatch):
    """A float32 launch gets a fresh float32 workspace of the size the
    library's plan asks for at its rows and widths; bfloat16 gets none, and
    a width the plan refuses raises."""
    asked = []

    class Lib:
        def btsbot_tf32x3_workspace_floats(self, m, c_, hidden_, taps_):
            asked.append((m, c_, hidden_, taps_))
            return 0 if c_ > 1024 else 7 * c_ + hidden_

    monkeypatch.setattr(_build, "library", lambda: Lib())
    x = torch.zeros(3, c)
    ws = _build.kernel_workspace("tf32x3", x, 37, c, hidden, taps)
    assert ws.dtype == torch.float32 and ws.numel() == 7 * c + hidden
    assert asked == [(37, c, hidden, int(taps))]
    assert _build.workspace_args(ws) == [ws.data_ptr(), 4 * ws.numel()]
    assert _build.kernel_workspace("tuned", x, 37, c, hidden, taps) is None
    assert _build.workspace_args(None) == []
    with pytest.raises(ValueError, match="do not take"):
        _build.kernel_workspace("tf32x3", x, 37, 1032, hidden, taps)
