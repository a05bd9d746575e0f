"""The port's kernel modules against the JAX kernels they replace (CPU).

The plain PyTorch versions (``ln_mlp_reference``, ``convnext_block_reference``)
are held to the JAX plain versions and to the Pallas kernels in interpret
mode, on the same numpy inputs.  Tolerances: f32 rtol = atol = 1e-5
(summation order); bf16 3e-2 (bf16 rounding at different points).  On CPU
tensors the wrappers take the plain version and launch no kernel (a
``chip_smoke.CountingLibrary`` in the kernel library's place counts none);
the CUDA kernels themselves are held to these plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from btsbot_tpu.ops.pallas_convnext import _block_reference
from btsbot_tpu.ops.pallas_convnext import convnext_block_fused as jax_block_fused
from btsbot_tpu.ops.pallas_mlp import _mlp_reference
from btsbot_tpu.ops.pallas_mlp import fused_ln_mlp as jax_fused_ln_mlp
from btsbot_tpu_torch.ops import _build
from btsbot_tpu_torch.ops import convnext_block as port_block
from btsbot_tpu_torch.ops import ln_mlp as port_mlp


def _mlp_params(c, rng):
    """JAX layout: w1 (C, 4C), w2 (4C, C)."""
    return dict(
        lns=1 + rng.normal(size=(c,)) * 0.1, lnb=rng.normal(size=(c,)) * 0.1,
        w1=rng.normal(size=(c, 4 * c)) * 0.1, b1=rng.normal(size=(4 * c,)) * 0.1,
        w2=rng.normal(size=(4 * c, c)) * 0.1, b2=rng.normal(size=(c,)) * 0.1,
        gamma=rng.normal(size=(c,)) * 0.5)


def _jax_args(p, dtype):
    return [jnp.asarray(np.asarray(p[k], np.float32), dtype)
            for k in ("lns", "lnb", "w1", "b1", "w2", "b2", "gamma")]


def _torch_args(p, dtype):
    """Port layout: fc1.weight (4C, C), fc2.weight (C, 4C)."""
    t = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in p.items()}
    return [x.to(dtype) for x in (t["lns"], t["lnb"], t["w1"].T.contiguous(), t["b1"],
                                  t["w2"].T.contiguous(), t["b2"], t["gamma"])]


def _block_params(c, rng):
    return dict(dw=rng.normal(size=(7, 7, 1, c)) * 0.1, dwb=rng.normal(size=(c,)) * 0.1,
                **_mlp_params(c, rng))


def _dw_torch(p, dtype):
    dw = torch.tensor(np.transpose(p["dw"], (3, 2, 0, 1)).astype(np.float32))
    return [dw.to(dtype), torch.tensor(p["dwb"].astype(np.float32)).to(dtype)]


def _dw_jax(p, dtype):
    return [jnp.asarray(p["dw"].astype(np.float32), dtype),
            jnp.asarray(p["dwb"].astype(np.float32), dtype)]


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def test_ln_mlp_reference_matches_jax_f32():
    rng = np.random.default_rng(3)
    m, c = 50, 8  # not a multiple of any row tile
    h, res = rng.normal(size=(m, c)), rng.normal(size=(m, c))
    p = _mlp_params(c, rng)
    jargs = [jnp.asarray(h, jnp.float32), jnp.asarray(res, jnp.float32)] \
        + _jax_args(p, jnp.float32)
    want_ref = _mlp_reference(*jargs)
    want_kernel = jax_fused_ln_mlp(*jargs, True)  # Pallas, interpret mode
    got = port_mlp.ln_mlp_reference(torch.tensor(h, dtype=torch.float32),
                                    torch.tensor(res, dtype=torch.float32),
                                    *_torch_args(p, torch.float32))
    np.testing.assert_allclose(_f32(got), _f32(want_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), rtol=1e-5, atol=1e-5)


def test_ln_mlp_reference_matches_jax_bf16():
    rng = np.random.default_rng(4)
    m, c = 50, 16
    h, res = rng.normal(size=(m, c)), rng.normal(size=(m, c))
    p = _mlp_params(c, rng)
    jargs = [jnp.asarray(h, jnp.bfloat16), jnp.asarray(res, jnp.bfloat16)] \
        + _jax_args(p, jnp.bfloat16)
    want = _mlp_reference(*jargs)
    got = port_mlp.ln_mlp_reference(torch.tensor(h, dtype=torch.float32).bfloat16(),
                                    torch.tensor(res, dtype=torch.float32).bfloat16(),
                                    *_torch_args(p, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("shape", [(4, 15, 15, 8), (2, 7, 7, 16), (2, 3, 3, 16),
                                   (2, 1, 1, 16)])
def test_block_reference_matches_jax_f32(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape)
    p = _block_params(shape[-1], rng)
    jargs = [jnp.asarray(x, jnp.float32)] + _dw_jax(p, jnp.float32) \
        + _jax_args(p, jnp.float32)
    want_ref = _block_reference(*jargs)
    want_kernel = jax_block_fused(*jargs, True)  # Pallas, interpret mode
    got = port_block.convnext_block_reference(
        torch.tensor(x, dtype=torch.float32), *_dw_torch(p, torch.float32),
        *_torch_args(p, torch.float32))
    assert got.shape == shape
    np.testing.assert_allclose(_f32(got), _f32(want_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 7, 7, 16), (2, 1, 1, 16)])
def test_block_reference_matches_jax_bf16(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape)
    p = _block_params(shape[-1], rng)
    jargs = [jnp.asarray(x, jnp.bfloat16)] + _dw_jax(p, jnp.bfloat16) \
        + _jax_args(p, jnp.bfloat16)
    want = _block_reference(*jargs)
    got = port_block.convnext_block_reference(
        torch.tensor(x, dtype=torch.float32).bfloat16(), *_dw_torch(p, torch.bfloat16),
        *_torch_args(p, torch.bfloat16))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-2, atol=3e-2)


def test_wrappers_on_cpu_take_the_plain_path(monkeypatch):
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(2, 7, 7, 16)), dtype=torch.float32)
    p = _block_params(16, rng)
    dw, mlp = _dw_torch(p, torch.float32), _torch_args(p, torch.float32)
    lib = chip_smoke.CountingLibrary(_build.library)
    monkeypatch.setattr(_build, "library", lib)
    got = port_block.convnext_block_fused(x, *dw, *mlp)
    assert torch.equal(got, port_block.convnext_block_reference(x, *dw, *mlp))
    h, res = x.reshape(-1, 16), x.reshape(-1, 16) * 0.5
    got = port_mlp.fused_ln_mlp(h, res, *mlp)
    assert torch.equal(got, port_mlp.ln_mlp_reference(h, res, *mlp))
    names = port_block.BLOCK_PARAM_NAMES
    got = port_block.block_params_apply(dict(zip(names, dw + mlp)), x)
    assert torch.equal(got, port_block.convnext_block_reference(x, *dw, *mlp))
    assert not lib.launches


def test_wrappers_raise_off_the_cpu_instead_of_falling_back():
    """A tensor that is not on the CPU goes to the kernel or raises; here a
    'meta' tensor stands in for a device the kernel does not take."""
    x = torch.empty(2, 7, 7, 16, device="meta")
    dw = [torch.empty(16, 1, 7, 7, device="meta"), torch.empty(16, device="meta")]
    mlp = [torch.empty(s, device="meta") for s in
           [(16,), (16,), (64, 16), (64,), (16, 64), (16,), (16,)]]
    with pytest.raises(ValueError, match="CUDA"):
        port_block.convnext_block_fused(x, *dw, *mlp)
    with pytest.raises(ValueError, match="CUDA"):
        port_mlp.fused_ln_mlp(x.reshape(-1, 16), x.reshape(-1, 16), *mlp)


def test_kernel_operands_reject_what_the_kernels_do_not_take():
    from btsbot_tpu_torch.ops import _build

    with pytest.raises(ValueError, match="CUDA"):
        _build.kernel_operands(torch.zeros(4, 64), [], "k")


@pytest.mark.parametrize("which", ["block", "ln_mlp"])
def test_autograd_backward_recomputes_the_plain_version(which, monkeypatch):
    """The autograd.Function's backward (run on the card after the kernel's
    forward) gives the JAX custom-VJP gradients.  The launch is replaced by
    the plain version so the wiring runs on the CPU."""
    rng = np.random.default_rng(5)
    c = 8
    p = _block_params(c, rng)
    if which == "block":
        x = rng.normal(size=(2, 7, 7, c))
        monkeypatch.setattr(port_block, "_launch_block", port_block.convnext_block_reference)
        fn = port_block._FusedBlock.apply
        targs = [torch.tensor(x, dtype=torch.float32)] + _dw_torch(p, torch.float32) \
            + _torch_args(p, torch.float32)
        jargs = [jnp.asarray(x, jnp.float32)] + _dw_jax(p, jnp.float32) \
            + _jax_args(p, jnp.float32)

        def jax_loss(*a):
            return jnp.sum(jnp.square(jax_block_fused(*a, True)))
    else:
        h, res = rng.normal(size=(30, c)), rng.normal(size=(30, c))
        monkeypatch.setattr(port_mlp, "_launch_ln_mlp", port_mlp.ln_mlp_reference)
        fn = port_mlp._FusedLnMlp.apply
        targs = [torch.tensor(h, dtype=torch.float32), torch.tensor(res, dtype=torch.float32)] \
            + _torch_args(p, torch.float32)
        jargs = [jnp.asarray(h, jnp.float32), jnp.asarray(res, jnp.float32)] \
            + _jax_args(p, jnp.float32)

        def jax_loss(*a):
            return jnp.sum(jnp.square(jax_fused_ln_mlp(*a, True)))
    targs = [t.requires_grad_(True) for t in targs]
    fn(*targs).square().sum().backward()
    want = jax.grad(jax_loss, argnums=tuple(range(len(jargs))))(*jargs)
    for t, g in zip(targs, want):
        got = t.grad.numpy()
        g = np.asarray(g)
        if got.shape != g.shape:  # torch layouts of the conv and linear weights
            g = np.transpose(g, (3, 2, 0, 1)) if g.ndim == 4 else g.T
        np.testing.assert_allclose(got, g, rtol=1e-4, atol=1e-5)
