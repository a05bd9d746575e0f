"""The parts of the port's trainer against the JAX package's (CPU).

Each part gets the same numpy inputs in both packages.  Tolerances, each
with its reason:

* losses 1e-6 relative (float32, the same log-sigmoid form);
* learning rates 1e-7 relative (float32 in the same order; the cosine is
  rounded once from float64 in the port);
* augmentation given the JAX masks: exact (flips and rotations move
  values without arithmetic);
* AdamW against ``optax.adamw``: 1e-6 (float32, another operation order);
* train-mode BatchNorm against flax: outputs 1e-5, running statistics 1e-6
  relative (float32 reductions in another order);
* the block and LN→MLP ``autograd.Function``s against autograd of their
  plain versions: exact (the backward is that recompute).
"""

import json

import flax.linen as fnn
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from btsbot_tpu import normalize_config
from btsbot_tpu.data.dataset import AlertDataset as JaxAlertDataset
from btsbot_tpu.data.dataset import iterate_batches as jax_iterate_batches
from btsbot_tpu.engine import loss as jax_loss
from btsbot_tpu.engine.schedule import lr_at_epoch as jax_lr_at_epoch
from btsbot_tpu.engine.schedule import make_lr_schedule as jax_make_lr_schedule
from btsbot_tpu.metrics.diagnostics import diagnostic_summary as jax_diagnostic_summary
from btsbot_tpu.ops.augment import augment_triplets as jax_augment
from btsbot_tpu_torch.data.dataset import AlertDataset, iterate_batches, num_batches
from btsbot_tpu_torch.engine import loss
from btsbot_tpu_torch.engine.schedule import lr_at_epoch, make_lr_schedule
from btsbot_tpu_torch.engine.state import create_train_state, make_optimizer
from btsbot_tpu_torch.engine.steps import make_train_step
from btsbot_tpu_torch.metrics.diagnostics import diagnostic_summary
from btsbot_tpu_torch.models.common import BatchNorm1d, Dropout, set_dropout_generator
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.ops import convnext_block as port_block
from btsbot_tpu_torch.ops import ln_mlp as port_mlp
from btsbot_tpu_torch.ops.augment import (
    apply_augmentation,
    augment_triplets,
    draw_augmentation,
)
from test_torch_model import atto_config


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# ------------------------------ losses ------------------------------

@pytest.mark.parametrize("pos_weight", [1.0, 3.7])
def test_weighted_bce_matches_jax(pos_weight):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 1)) * 4
    labels = (rng.random(64) < 0.3).astype(np.float32)
    want = jax_loss.weighted_bce_with_logits(jnp.asarray(logits, jnp.float32),
                                             jnp.asarray(labels), pos_weight)
    got = loss.weighted_bce_with_logits(_t(logits), _t(labels), pos_weight)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("temperature", [1.0, 2.0, 4.0])
def test_kd_loss_and_its_gradient_match_jax(temperature):
    rng = np.random.default_rng(1)
    s, t = rng.normal(size=64) * 3, rng.normal(size=64) * 3
    want, want_grad = jax.value_and_grad(jax_loss.binary_kd_loss)(
        jnp.asarray(s, jnp.float32), jnp.asarray(t, jnp.float32), temperature)
    st = _t(s).requires_grad_(True)
    tt = _t(t).requires_grad_(True)
    got = loss.binary_kd_loss(st, tt, temperature)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_grad), rtol=1e-6,
                               atol=1e-9)
    assert tt.grad is None  # the teacher gets no gradient


def test_binary_accuracy_matches_jax():
    rng = np.random.default_rng(2)
    scores, labels = rng.random(101), (rng.random(101) < 0.4).astype(np.float32)
    want = jax_loss.binary_accuracy(jnp.asarray(scores), jnp.asarray(labels))
    assert loss.binary_accuracy(_t(scores), _t(labels)).item() == pytest.approx(
        float(want), abs=1e-7)


# ------------------------------ schedule ------------------------------

@pytest.mark.parametrize("base_lr,total,warmup", [
    (1e-4, 500, 5), (1e-3, 50, 0), (2e-3, 7, 2), (3e-4, 3, 1)])
def test_lr_at_epoch_matches_jax(base_lr, total, warmup):
    for epoch in range(min(total, 60)):
        want = float(jax_lr_at_epoch(epoch, base_lr, total, warmup))
        assert lr_at_epoch(epoch, base_lr, total, warmup) == pytest.approx(want, rel=1e-7)


@pytest.mark.parametrize("warmup", [0, 1])
def test_lr_of_every_update_over_three_epochs_matches_jax(warmup):
    """The LR the port's train step sets for update k is JAX's schedule at
    count k (optax evaluates it before the update)."""
    config = normalize_config({**atto_config(), "learning_rate": 1e-3, "beta_1": 0.9,
                               "beta_2": 0.999, "epochs": 3, "warmup_epochs": warmup,
                               "batch_size": 2, "meta_dropout": 0.0, "comb_dropout": 0.0})
    spe = 2
    model = build_model(config, device="cpu", seed=0)
    state = create_train_state(config, model, spe, seed=0)
    step = make_train_step(config)
    rng = np.random.default_rng(3)
    jax_sched = jax_make_lr_schedule(config, spe)
    for k in range(3 * spe):
        step(state, _t(rng.normal(size=(2, 63, 63, 3))), _t(rng.normal(size=(2, 25))),
             _t([0.0, 1.0]), 1.0)
        used = state.optimizer.param_groups[0]["lr"]
        assert used == pytest.approx(float(jax_sched(k)), rel=1e-7)
        assert used == make_lr_schedule(config, spe)(k)
    assert state.step == 3 * spe


# ------------------------------ augmentation ------------------------------

@pytest.mark.parametrize("flags", [(True, True, True), (True, False, False),
                                   (False, True, False), (False, False, True)])
def test_augmentation_given_jax_masks_is_exact(flags):
    h, v, r = flags
    rng = np.random.default_rng(4)
    images = rng.normal(size=(16, 9, 9, 3)).astype(np.float32)
    key = jax.random.key(7)
    want = jax_augment(key, jnp.asarray(images), h_flip=h, v_flip=v, rot=r)
    # the draws inside augment_triplets (ops/augment.py:56-65 of the JAX package)
    k_h, k_v, k_r = jax.random.split(key, 3)
    masks = (np.array(jax.random.bernoulli(k_h, 0.5, (16,))) if h else None,
             np.array(jax.random.bernoulli(k_v, 0.5, (16,))) if v else None,
             np.array(jax.random.randint(k_r, (16,), 0, 4)) if r else None)
    got = apply_augmentation(torch.from_numpy(images),
                             *[None if m is None else torch.from_numpy(m) for m in masks])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_augmentation_draws_follow_the_generator():
    images = torch.arange(2 * 4 * 4 * 3, dtype=torch.float32).reshape(2, 4, 4, 3)
    g = torch.Generator().manual_seed(5)
    a = augment_triplets(g, images)
    g.manual_seed(5)
    np.testing.assert_array_equal(augment_triplets(g, images).numpy(), a.numpy())
    h, v, k = draw_augmentation(g, 1000, "cpu", h_flip=True, v_flip=False, rot=True)
    assert v is None and h.dtype == torch.bool
    assert 0.4 < h.float().mean().item() < 0.6
    assert set(k.tolist()) == {0, 1, 2, 3}


# ------------------------------ optimizer ------------------------------

def test_adamw_updates_match_optax():
    rng = np.random.default_rng(6)
    shapes = {"w": (8, 5), "b": (5,), "gamma": (3,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    config = normalize_config({"model_name": "mm_ConvNeXt", "learning_rate": 3e-3,
                               "beta_1": 0.99, "beta_2": 0.99})
    tx = optax.adamw(3e-3, b1=0.99, b2=0.99, eps=1e-8, weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(config, list(tp.values()))
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        upd, opt_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


# ------------------------------ train-mode layers ------------------------------

def test_batchnorm_train_mode_follows_flax():
    """Outputs and running statistics over three train-mode batches: the
    running variance takes the biased batch variance (torch's own takes the
    unbiased one, n/(n-1) larger)."""
    rng = np.random.default_rng(8)
    batches = [(rng.normal(size=(16, 25)) * 3 + 5).astype(np.float32) for _ in range(3)]
    scale = (1 + rng.normal(size=25) * 0.1).astype(np.float32)
    bias = (rng.normal(size=25) * 0.1).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.key(0), jnp.zeros((1, 25)))
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = variables["batch_stats"]
    port = BatchNorm1d(25).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    for x in batches:
        want, upd = bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    for ours, theirs in ((port.running_mean, stats["mean"]), (port.running_var, stats["var"])):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6)
    torch_var = torch.nn.BatchNorm1d(25, momentum=0.1).train()
    for x in batches:
        torch_var(torch.from_numpy(x))
    assert not np.allclose(torch_var.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-3)
    assert int(port.num_batches_tracked) == 3
    port.eval()  # eval mode reads the running statistics
    x = torch.from_numpy(batches[0])
    want = (x - port.running_mean) / torch.sqrt(port.running_var + 1e-5) * port.weight + port.bias
    np.testing.assert_allclose(port(x).detach().numpy(), want.detach().numpy(), rtol=1e-5,
                               atol=1e-5)


def test_dropout_is_inverted_dropout_from_its_generator():
    drop = Dropout(0.25).train()
    set_dropout_generator(drop, torch.Generator().manual_seed(3))
    x = torch.rand(4000) + 1
    y = drop(x)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert 0.72 < kept.float().mean().item() < 0.78
    drop.generator.manual_seed(3)
    torch.testing.assert_close(drop(x), y, rtol=0, atol=0)
    assert torch.equal(drop.eval()(x), x)


# ------------------------------ the kernels' autograd Functions ------------------------------

def _block_args(c, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 5, 5, c, generator=g).to(dtype)
    params = [torch.randn(s, generator=g) * 0.2 for s in
              [(c, 1, 7, 7), (c,), (c,), (c,), (4 * c, c), (4 * c,), (c, 4 * c), (c,), (c,)]]
    return x, params


def _grads(fn, x, params, seed):
    x = x.detach().clone().requires_grad_(True)
    params = [p.detach().clone().requires_grad_(True) for p in params]
    out = fn(x, *params)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)).to(out.dtype)
    out.backward(g)
    return out, [x.grad] + [p.grad for p in params]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["convnext_block", "ln_mlp"])
def test_fused_function_backward_is_the_plain_versions_gradient(monkeypatch, which, dtype):
    """The ``autograd.Function`` path (taken on the card) with the launch
    replaced by the plain version: its gradients are autograd's through the
    plain version, float32 for float32 parameters whatever x's type."""
    c = 8
    x, params = _block_args(c, dtype, seed=9)
    if which == "convnext_block":
        mod, fn, ref = port_block, port_block._FusedBlock, port_block.convnext_block_reference
        launch = "_launch_block"
    else:
        mod, fn, ref = port_mlp, port_mlp._FusedLnMlp, port_mlp.ln_mlp_reference
        launch = "_launch_ln_mlp"
        x = x.reshape(-1, c)
        params = [x * 0.5 + 0.1] + params[2:]  # shortcut, then the LN / MLP / γ weights

    def plain_launch(*args):
        return ref(*args)
    monkeypatch.setattr(mod, launch, plain_launch)
    out_f, grads_f = _grads(fn.apply, x, params, seed=10)
    out_r, grads_r = _grads(ref, x, params, seed=10)
    torch.testing.assert_close(out_f, out_r, rtol=0, atol=0)
    for gf, gr, p in zip(grads_f, grads_r, [x] + params):
        assert gf.dtype == p.dtype
        torch.testing.assert_close(gf, gr, rtol=0, atol=0)


# ------------------------------ data and metrics ------------------------------

def test_iterate_batches_yields_jax_order():
    rng = np.random.default_rng(11)
    labels = (rng.random(37) < 0.5).astype(np.float32)
    meta = rng.normal(size=(37, 4)).astype(np.float32)
    images = rng.normal(size=(37, 3, 3, 3)).astype(np.float32)
    for kw in (dict(shuffle=True, drop_last=True, seed=5),
               dict(shuffle=True, drop_last=False, seed=6), {}):
        ours = list(iterate_batches(AlertDataset(labels, images, meta), 8, **kw))
        theirs = list(jax_iterate_batches(JaxAlertDataset(labels, images, meta), 8, **kw))
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    assert num_batches(AlertDataset(labels), 8) == 5
    assert num_batches(AlertDataset(labels), 8, drop_last=True) == 4


def test_diagnostic_summary_matches_jax():
    import pandas as pd
    rng = np.random.default_rng(12)
    n = 120
    cand = {"objectId": np.asarray([f"ZTF{i // 4:03d}" for i in range(n)]),
            "jd": 2459300.5 + rng.random(n) * 30, "magpsf": 17 + rng.random(n) * 2.5,
            "peakmag": 17 + rng.random(n) * 2}
    labels = (np.repeat(rng.random(n // 4), 4) < 0.4).astype(int)
    preds = np.clip(labels * 0.6 + rng.random(n) * 0.5, 0, 1)
    got = diagnostic_summary(cand, preds, labels)
    want = jax_diagnostic_summary(pd.DataFrame(cand), preds, labels)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)  # NaN too
    # with the figure (ported): the same summary beside a 4 x 3 grid of panels
    drawn = diagnostic_summary(cand, preds, labels, make_figure=True)
    fig = drawn.pop("fig")
    assert len([a for a in fig.axes if a.get_label() != "<colorbar>"]) == 12
    assert json.dumps(drawn, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_val_cuts_filter_and_nan_metadata_follow_jax(tmp_path):
    import pandas as pd
    from btsbot_tpu.data.dataset import apply_val_cuts as jax_apply_val_cuts
    from btsbot_tpu.data.dataset import load_split as jax_load_split
    from btsbot_tpu_torch.data.dataset import apply_val_cuts, load_split, read_candidates
    rng = np.random.default_rng(13)
    n = 30
    cand = pd.DataFrame({"objectId": [f"ZTF{i}" for i in range(n)],
                         "label": (rng.random(n) < 0.5).astype(int),
                         "is_SN": rng.random(n) < 0.7, "near_threshold": rng.random(n) < 0.2,
                         "is_rise": rng.random(n) < 0.6, "m0": rng.normal(size=n)})
    path = tmp_path / "val_cand_vt_N100.csv"
    cand.to_csv(path, index=False)
    ours = read_candidates(str(path))
    assert ours["is_SN"].dtype == bool and ours["label"].dtype == np.int64
    config = normalize_config({"model_name": "um_nn", "train_data_version": "vt",
                               "metadata_cols": ["m0"], "val_sne_only": True,
                               "val_keep_near_threshold": False, "val_rise_only": True})
    got = apply_val_cuts(load_split(config, "val", str(tmp_path)), config)
    want = jax_apply_val_cuts(jax_load_split(config, "val", str(tmp_path)), config)
    assert 0 < len(got) < n
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.metadata, want.metadata)
    np.testing.assert_array_equal(got.candidates["objectId"], want.candidates["objectId"])
    cand.loc[3, "m0"] = np.nan
    cand.to_csv(path, index=False)
    for loader in (load_split, jax_load_split):
        with pytest.raises(ValueError, match="NaNs found in metadata columns"):
            loader(config, "val", str(tmp_path))
