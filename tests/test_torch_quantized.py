"""The port's int8 quantized ConvNeXt path (btsbot_tpu_torch/ops/quantized.py)
against the JAX package's (btsbot_tpu/ops/quantized.py), on the CPU.

The same seeded numpy inputs and the same weights (a port model's, made by
torch's init from a seed and carried to the JAX package with its
``torch_state_dict_to_variables``; the JAX qparams carried back with
``qparams_from_jax``) go through both packages, at ``convnext_atto.test``
widths as in tests/test_quantized.py:

* the quantizers bit for bit (int8 values and float32 scales, .5 ties
  included), the depthwise, patchify (stem / downsample) and fc int32
  accumulators exactly, and the whole depthwise step (the plain version of
  ``csrc/int8_dwconv.cu``) bit for bit against the JAX expression;
* calibration (against ``prepare_quantized``) and the f32 forward, twice.
  Free-running, each package quantizes its own float activations, and one
  float32 ulp of difference in a LayerNorm (XLA's CPU rsqrt is not
  correctly rounded, its sums run in another order) flips an int8 value now
  and then: scales within rtol 1e-5 (measured 2.1e-7, 23 flips in the
  calibration) and f32 logits within atol 1e-4 (measured 3.0e-8, 8 flips).
  Teacher-forced, the port takes the JAX package's int8 activations in place
  of its own (every ``quantize_act`` call, recorded in order), which leaves
  only float rounding, under the same limits.  A flip can travel on: with
  the JAX test's flax-initialised weights the free-running figures were
  1.4e-3 and 1.8e-4, the teacher-forced ones within these limits;
* the plain version of the fused block kernel (``int8_block_reference``,
  the plain side of ``csrc/int8_block.cu``) bit for bit against the
  composition the forward ran before it, in both types, on the carried
  qparams' blocks at C = 40 and 80 and 7×7, 3×3 and 1×1 maps; its debug
  outputs, its tails from a given q_h or q_g, the CUDA wrapper's refusal of
  a CPU tensor and the admission of widths;
* bf16 scores within 0.01 (measured 4.7e-4), the same
  ``verify_quantized_parity`` verdict as the JAX function's at its test's
  tol 0.05 (mm_ConvNeXt and image-only ConvNeXt), and a batch of one alert
  (the padded int8 GEMM).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from btsbot_tpu import normalize_config as jax_normalize_config
from btsbot_tpu.interop.convert import torch_state_dict_to_variables
from btsbot_tpu.ops import quantized as jq
import torch.nn.functional as F

from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.ops import _build
from btsbot_tpu_torch.ops import quantized as tq
from btsbot_tpu_torch.ops.ln_mlp import _layernorm

CFG = {
    "model_name": "mm_ConvNeXt",
    "model_kind": "convnext_atto.test",
    "train_data_version": "v12",
    "metadata_cols": [f"m{i}" for i in range(25)],
    "meta_fc1_neurons": 16, "meta_fc2_neurons": 16, "meta_dropout": 0.2,
    "comb_fc1_neurons": 8, "comb_fc2_neurons": 8, "comb_dropout": 0.2,
}
IMAGE_ONLY = {**CFG, "model_name": "ConvNeXt", "fc1_neurons": 16, "fc2_neurons": 8,
              "dropout": 0.2}


def _unit_triplets(rng, n):
    img = rng.normal(size=(n, 63, 63, 3)).astype(np.float32)
    return img / np.linalg.norm(img, axis=(1, 2), keepdims=True)


class _Recording:
    """Patches ``module.quantize_act`` to keep every int8 output (the JAX
    package's: by call order at trace time, so it works under ``jit``
    through ``jax.debug.callback``), or to return such a recording in place
    of its own (the port's; sizes checked, since the port quantizes a
    block's MLP input as (M, C) rows and the JAX package as (B, H, W, C)),
    counting the values that differ from its own quantization."""

    def __init__(self, module, replay=None):
        self.module, self.orig = module, module.quantize_act
        self.out, self.replay, self.flips = [], replay and iter(replay), 0

    def __call__(self, x, scale):
        q = self.orig(x, scale)
        if self.replay is None:
            i = len(self.out)
            self.out.append(None)
            jax.debug.callback(lambda v: self.out.__setitem__(i, np.asarray(v)), q)
            return q
        want = next(self.replay)
        assert q.numel() == want.size
        want = want.reshape(tuple(q.shape))
        self.flips += int((q.numpy() != want).sum())
        return torch.from_numpy(want.copy())

    def __enter__(self):
        self.module.quantize_act = self
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        self.module.quantize_act = self.orig


def _jax_variables(config: dict, seed: int) -> tuple:
    """A port model's weights (torch's init from ``seed``) as a
    reference-named numpy state dict and as the JAX package's variables."""
    sd = {k: v.numpy() for k, v in build_model(config, device="cpu", seed=seed)
          .state_dict().items()}
    return sd, torch_state_dict_to_variables(jax_normalize_config(config), sd)


@pytest.fixture(scope="module")
def mm():
    """One model, its calibration by the JAX package (``prepare_quantized``)
    and its f32 forward there, both with their int8 activations recorded;
    the port's calibration free-running and teacher-forced, and the JAX
    qparams carried across."""
    sd, variables = _jax_variables(CFG, seed=0)
    config = jax_normalize_config(CFG)
    rng = np.random.default_rng(1)
    cal = _unit_triplets(rng, 64)
    test = _unit_triplets(rng, 16)
    meta = rng.normal(size=(16, 25)).astype(np.float32)
    with _Recording(jq) as cal_rec:
        q = jq.prepare_quantized(variables, config, jnp.asarray(cal))
    with _Recording(jq) as fwd_rec:
        f32 = jax.jit(lambda i, m: jq.quantized_convnext_logits(q, i, m, dtype=jnp.float32))(
            jnp.asarray(test), jnp.asarray(meta))
    port = tq.prepare_quantized(sd, CFG, torch.from_numpy(cal), device="cpu")
    with _Recording(tq, replay=cal_rec.out) as forced:
        port_forced = tq.prepare_quantized(sd, CFG, torch.from_numpy(cal), device="cpu")
    return {"test": test, "meta": meta, "q": q, "sd": sd, "jax_f32": np.asarray(f32),
            "fwd_rec": fwd_rec.out, "port": port, "port_forced": port_forced,
            "cal_flips": forced.flips, "carried": tq.qparams_from_jax(q, sd, device="cpu")}


# ------------------------------- quantizers -------------------------------

@pytest.mark.parametrize("shape,axes", [((7, 7, 1, 40), (0, 1, 2)), ((4, 4, 3, 40), (0, 1, 2)),
                                        ((40, 160), (0,)), ((160, 40), (0,))])
def test_quantize_weight_bit_for_bit(shape, axes):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    w = (rng.normal(size=shape) * 0.1).astype(np.float32)
    jw, js = jq.quantize_weight(jnp.asarray(w), axes)
    tw, ts = tq.quantize_weight(torch.from_numpy(w), axes)
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_weight_ties_round_half_to_even():
    # absmax 127 in each column makes the scale exactly 1: the .5 values tie
    w = np.array([[127.0, -127.0], [2.5, -2.5], [3.5, 0.5], [-0.5, 1.5]], np.float32)
    jw, js = jq.quantize_weight(jnp.asarray(w), (0,))
    tw, ts = tq.quantize_weight(torch.from_numpy(w), (0,))
    np.testing.assert_array_equal(ts.numpy(), [1.0, 1.0])
    np.testing.assert_array_equal(tw.numpy(), [[127, -127], [2, -2], [4, 0], [0, 2]])
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale_kind", ["float", "0-d"])
def test_quantize_act_bit_for_bit(dtype, scale_kind):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(4096,)) * 3).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    s = np.float32(np.abs(x).max() / np.float32(127))
    js = float(s) if scale_kind == "float" else jnp.asarray(s)
    ts = float(s) if scale_kind == "float" else torch.tensor(s)
    got = tq.quantize_act(tx, ts)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.quantize_act(jx, js)))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_quantize_act_ties_and_clip(scale):
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 200.0, -300.0], np.float32) * scale
    got = tq.quantize_act(torch.from_numpy(x), scale).numpy()
    np.testing.assert_array_equal(got, [0, 2, 2, 0, -2, -2, 126, 127, -127])
    np.testing.assert_array_equal(got, np.asarray(jq.quantize_act(jnp.asarray(x), scale)))


# ---------------------------- int32 accumulators ----------------------------

def _int8(rng, shape):
    a = rng.integers(-127, 128, size=shape).astype(np.int8)
    a.flat[::97] = 127  # the extremes too
    a.flat[1::89] = -127
    return a


def test_dwconv_accumulator_exact():
    rng = np.random.default_rng(11)
    xq, wq = _int8(rng, (2, 15, 15, 40)), _int8(rng, (7, 7, 40))
    want = jq._conv_i8(jnp.asarray(xq), jnp.asarray(wq[:, :, None, :]), (1, 1), "SAME",
                       groups=40)
    got = tq.int8_dwconv_accumulate(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,xshape,wshape,k", [
    ("stem", (2, 63, 63, 3), (4, 4, 3, 40), 4),
    ("s1_down", (2, 15, 15, 40), (2, 2, 40, 80), 2),
    ("s3_down", (3, 3, 3, 160), (2, 2, 160, 320), 2)])
def test_patchify_accumulators_exact(name, xshape, wshape, k):
    rng = np.random.default_rng(k * 1000 + wshape[-1])
    xq, w = _int8(rng, xshape), _int8(rng, wshape)
    want = jq._conv_i8(jnp.asarray(xq), jnp.asarray(w), (k, k), "VALID")
    got = tq._patch_conv(torch.from_numpy(xq), tq.forward_layout(name, torch.from_numpy(w)), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m", [1, 16, 17, 200])
def test_fc_accumulators_exact(m):
    rng = np.random.default_rng(m)
    h, w = _int8(rng, (m, 160)), _int8(rng, (160, 640))
    want = jnp.dot(jnp.asarray(h), jnp.asarray(w), preferred_element_type=jnp.int32)
    got = tq.int8_matmul(torch.from_numpy(h), tq.forward_layout("s0b0_fc1", torch.from_numpy(w)))
    assert got.shape == (m, 640) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dwconv_step_bit_for_bit(dtype):
    """The plain version of csrc/int8_dwconv.cu against JAX quantized.py:199-203."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 7, 80)).astype(np.float32)
    w = (rng.normal(size=(7, 7, 1, 80)) * 0.1).astype(np.float32)
    bias = rng.normal(size=80).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    s_x = float(jnp.max(jnp.abs(jx.astype(jnp.float32))) / 127.0)
    dwq, dws = jq.quantize_weight(jnp.asarray(w), (0, 1, 2))
    acc = jq._conv_i8(jq.quantize_act(jx, s_x), dwq, (1, 1), "SAME", groups=80)
    want = (acc.astype(jnp.float32) * (s_x * dws)).astype(jdt) + jnp.asarray(bias).astype(jdt)
    got = tq.int8_dwconv(torch.from_numpy(x).to(tdt), s_x,
                         tq.forward_layout("s0b0_dw", torch.from_numpy(np.array(dwq))),
                         torch.from_numpy(np.array(dws)), torch.from_numpy(bias))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ------------------------- calibration and forward -------------------------

def _scale_rel(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(abs(a[k] - b[k]) / abs(b[k]) for k in a)


def test_calibration_keys_and_free_running_scales(mm):
    port, q = mm["port"], mm["q"]
    assert port["scales"].keys() == q["scales"].keys()
    assert port["weights"].keys() == q["weights"].keys()
    assert port["weights"]["s0b0_fc1"][0].dtype == torch.int8
    assert all(isinstance(v, float) for v in port["scales"].values())
    assert _scale_rel(port["scales"], q["scales"]) < 1e-5
    # the input scale sees no LayerNorm: equal
    assert port["scales"]["stem_in"] == q["scales"]["stem_in"]


def test_calibration_teacher_forced_scales(mm):
    assert _scale_rel(mm["port_forced"]["scales"], mm["q"]["scales"]) < 1e-5
    assert mm["cal_flips"] > 0  # free-running, some int8 values differ


@pytest.mark.parametrize("forced", [False, True], ids=["free", "teacher-forced"])
def test_f32_logits_match_jax(mm, forced):
    args = (mm["carried"], torch.from_numpy(mm["test"]), torch.from_numpy(mm["meta"]))
    if forced:
        with _Recording(tq, replay=mm["fwd_rec"]):
            got = tq.quantized_convnext_logits(*args, dtype=torch.float32)
    else:
        got = tq.quantized_convnext_logits(*args, dtype=torch.float32)
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), mm["jax_f32"], rtol=0, atol=1e-4)


def test_bf16_scores_and_verify_verdict_mm(mm, monkeypatch):
    """bf16 scores within 0.01 of the JAX package's (its int8 logits taken
    from inside its ``verify_quantized_parity``), and the same verdict."""
    seen, orig = [], jq.quantized_convnext_logits

    def keep(*a, **k):
        seen.append(orig(*a, **k))
        return seen[-1]

    monkeypatch.setattr(jq, "quantized_convnext_logits", keep)
    want = jq.verify_quantized_parity(mm["q"], jnp.asarray(mm["test"]), jnp.asarray(mm["meta"]),
                                      tol=0.05)
    got = tq.quantized_convnext_logits(mm["carried"], torch.from_numpy(mm["test"]),
                                       torch.from_numpy(mm["meta"]))
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    d = np.abs(torch.sigmoid(got.float()).numpy()
               - np.asarray(jax.nn.sigmoid(seen[0].astype(jnp.float32))))
    assert d.max() <= 0.01
    verdict = tq.verify_quantized_parity(mm["port"], torch.from_numpy(mm["test"]),
                                         torch.from_numpy(mm["meta"]), tol=0.05)
    assert verdict["close"] == want["close"] is True
    assert abs(verdict["max_score_diff"] - want["max_score_diff"]) < 0.01


def _to_jax_qparams(port, variables, config):
    """The port's qparams in the JAX package's layouts (HWIO, (in, out))."""
    weights = {}
    for name, (wq, ws) in port["weights"].items():
        w = wq.numpy()
        if name.endswith("_dw"):
            w = w[:, :, None, :]
        elif name.endswith(("_fc1", "_fc2")):
            w = w.T
        else:
            k = 4 if name == "stem" else 2
            w = w.T.reshape(k, k, -1, w.shape[0])
        weights[name] = (jnp.asarray(w), jnp.asarray(ws.numpy()))
    return {"depths": port["depths"], "scales": port["scales"], "weights": weights,
            "variables": variables, "config": config}


def test_verify_parity_verdict_image_only():
    sd, variables = _jax_variables(IMAGE_ONLY, seed=3)
    rng = np.random.default_rng(2)
    cal, test = _unit_triplets(rng, 32), _unit_triplets(rng, 8)
    port = tq.prepare_quantized(sd, IMAGE_ONLY, torch.from_numpy(cal), device="cpu")
    got = tq.verify_quantized_parity(port, torch.from_numpy(test), None, tol=0.05)
    want = jq.verify_quantized_parity(
        _to_jax_qparams(port, variables, jax_normalize_config(IMAGE_ONLY)),
        jnp.asarray(test), None, tol=0.05)
    assert got["close"] == want["close"] is True
    logits = tq.quantized_convnext_logits(port, torch.from_numpy(test), dtype=torch.float32)
    assert logits.shape == (8,) and bool(torch.isfinite(logits).all())


def test_batch_of_one(mm):
    """One alert: every int8 GEMM has M ≤ 16 rows at the 1×1 stage and
    runs padded; its logit is the one it gets inside a batch."""
    test, meta = mm["test"], mm["meta"]
    one = tq.quantized_convnext_logits(mm["carried"], torch.from_numpy(test[:1]),
                                       torch.from_numpy(meta[:1]), dtype=torch.float32)
    many = tq.quantized_convnext_logits(mm["carried"], torch.from_numpy(test),
                                        torch.from_numpy(meta), dtype=torch.float32)
    assert one.shape == (1,)
    np.testing.assert_allclose(one.numpy(), many.numpy()[:1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(one.numpy(), mm["jax_f32"][:1], rtol=0, atol=1e-4)


def test_the_cuda_wrapper_refuses_a_cpu_tensor():
    x = torch.zeros(1, 1, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tq._launch_int8_dwconv(x, 1.0, torch.zeros(7, 7, 8, dtype=torch.int8),
                               torch.ones(8), torch.zeros(8))


def test_the_port_module_imports_no_jax():
    code = ("import sys, btsbot_tpu_torch.ops.quantized; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'btsbot_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


# ------------------------- the fused block, plain -------------------------

def _block_args(mm, pre: str, side: int, dtype):
    """Block ``pre`` of the carried qparams (its scales, int8 weights and
    float parameters) on a seeded input of 3 × side × side pixels, with γ
    drawn at std 0.5 in place of its 1e-6 init, under which the block's
    branch would vanish from a bfloat16 output."""
    qp, p = mm["carried"], mm["carried"]["state_dict"]
    s_, b_ = int(pre[1]), int(pre[3])
    bp = f"convnext_backbone.stages.{s_}.blocks.{b_}"
    c = qp["weights"][pre + "_dw"][0].shape[-1]
    rng = np.random.default_rng(side * 100 + c)
    x = rng.normal(size=(3, side, side, c)) * 2
    gamma = torch.from_numpy((rng.normal(size=c) * 0.5).astype(np.float32))
    sc = qp["scales"]
    return (torch.from_numpy(x.astype(np.float32)).to(dtype), sc[pre + "_x"], sc[pre + "_h"],
            sc[pre + "_g"], qp["weights"][pre + "_dw"], p[f"{bp}.conv_dw.bias"],
            p[f"{bp}.norm.weight"], p[f"{bp}.norm.bias"], qp["weights"][pre + "_fc1"],
            p[f"{bp}.mlp.fc1.bias"], qp["weights"][pre + "_fc2"], p[f"{bp}.mlp.fc2.bias"],
            gamma)


def _composition(x, s_x, s_h, s_g, dw, dw_b, ln_w, ln_b, fc1, b1, fc2, b2, gamma):
    """The block as the int8 forward computed it before the fused kernel
    (0-d tensor scales for the dense layers, as it held them), with its
    float intermediates' quantizations."""
    dtype, c = x.dtype, x.shape[-1]
    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in (("h", s_h), ("g", s_g))}
    h = tq.int8_dwconv(x, s_x, *dw, dw_b)
    h = _layernorm(h, ln_w, ln_b).reshape(-1, c)
    g = F.gelu(tq._int8_dense(h, t["h"], fc1, b1, dtype), approximate="tanh")
    y = tq._int8_dense(g, t["g"], fc2, b2, dtype)
    out = x + y.reshape(x.shape) * gamma.to(dtype)
    return out, tq.quantize_act(h, s_h), tq.quantize_act(g, s_g)


BLOCK_CASES = [("s0b0", 3), ("s1b0", 1), ("s1b1", 7)]  # C = 40 at 3x3, C = 80 at 1x1 and 7x7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pre,side", BLOCK_CASES)
def test_int8_block_reference_is_the_composition(mm, pre, side, dtype):
    args = _block_args(mm, pre, side, dtype)
    want = _composition(*args)[0]
    got = tq.int8_block(*args)  # a CPU tensor: the plain version
    assert got.dtype == dtype and got.shape == args[0].shape
    assert torch.equal(got, want)
    assert not torch.equal(got, args[0])  # the block's branch reaches the output


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_block_debug_outputs_and_forced_tails(mm, dtype):
    args = _block_args(mm, "s1b0", 3, dtype)
    out, q_h, q_g = tq.int8_block(*args, debug=True)
    want, want_h, want_g = _composition(*args)
    assert q_h.dtype == q_g.dtype == torch.int8
    assert q_h.shape == (9 * 3, 80) and q_g.shape == (9 * 3, 320)
    assert torch.equal(q_h, want_h) and torch.equal(q_g, want_g) and torch.equal(out, want)
    # fed its own values, each tail is the free run
    assert torch.equal(tq.int8_block_reference(*args, q_h=q_h), out)
    tail, h2, g2 = tq.int8_block_reference(*args, debug=True, q_g=q_g)
    assert torch.equal(tail, out) and h2 is None and torch.equal(g2, q_g)
    # and a changed q_g changes the tail
    assert not torch.equal(tq.int8_block_reference(*args, q_g=-q_g), out)


def test_int8_block_wrapper_refuses_a_cpu_tensor(mm):
    args = _block_args(mm, "s0b0", 1, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tq._launch_int8_block(*args)


@pytest.mark.parametrize("c,ok", [(12, False), (1032, False), (0, False), (40, True),
                                  (80, True), (1024, True)])
def test_int8_block_admits_widths(c, ok):
    if ok:
        _build.int8_block_admit(c, 4 * c)
    else:
        with pytest.raises(ValueError, match="multiple of 8"):
            _build.int8_block_admit(c, 4 * c)
    with pytest.raises(ValueError, match="multiple of 16"):
        _build.int8_block_admit(40, 168)
