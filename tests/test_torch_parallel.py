"""The port's mesh in one process (CPU): meshes built on torch's ``fake``
backend (no peers, no data moved) against the JAX package's meshes on the
virtual devices, the model axis's sharding rule against
``variables_shardings`` under the weight bridge, the serving ladder
against JAX's, the global-batch draws of augmentation and dropout, and a
world-size-1 gloo group, where a mesh run must equal the run without one.
"""

import contextlib
import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import jax
from jax.sharding import PartitionSpec as P

from btsbot_tpu.engine.serve import _bucket_ladder as jax_bucket_ladder
from btsbot_tpu.models.factory import build_model as jax_build_model
from btsbot_tpu.models.factory import example_inputs as jax_example_inputs
from btsbot_tpu.parallel.mesh import make_mesh as jax_make_mesh
from btsbot_tpu.parallel.sharding import variables_shardings
from btsbot_tpu_torch.engine.serve import _bucket_ladder
from btsbot_tpu_torch.engine.train import run_training
from btsbot_tpu_torch.interop.weights import state_dict_from_jax
from btsbot_tpu_torch.models.common import BatchNorm1d, Dropout, Dropout2d
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.ops.augment import augment_triplets
from btsbot_tpu_torch.parallel.mesh import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    replicated,
)
from btsbot_tpu_torch.parallel.sharding import module_shardings, param_spec
from test_torch_model import pico_config
from test_torch_train import _datasets, train_config


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A process group of ``n`` ranks in which this process is ``rank``
    and no collective moves data."""
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def gloo_world_of_one():
    initialize_distributed(backend="gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


MESH_COUNTS = [(1, None, 1), (2, None, 1), (2, 1, 2), (4, None, 2), (4, 2, 2), (4, 1, 4),
               (8, None, 1), (8, 4, 2), (8, 2, 4), (8, 3, 2), (4, 3, 1), (2, 2, 2)]


@pytest.mark.parametrize("n,data,model", MESH_COUNTS)
def test_make_mesh_shapes_match_jax(n, data, model):
    devices = jax.devices()[:n]
    try:
        want = dict(jax_make_mesh(data=data, model=model, devices=devices).shape)
    except ValueError:
        want = ValueError
    with fake_world(n, rank=n - 1):
        if want is ValueError:
            with pytest.raises(ValueError, match=f"!= {n} devices"):
                make_mesh(data=data, model=model)
            return
        mesh = make_mesh(data=data, model=model)
    assert mesh.shape == want
    assert (mesh.data_index, mesh.model_index) == divmod(n - 1, want["model"])


def test_make_mesh_without_a_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh()


def test_batch_sharding_takes_this_ranks_rows_and_refuses_a_ragged_batch():
    x = np.arange(24).reshape(12, 2)
    with fake_world(4, rank=2):
        rows = batch_sharding(make_mesh(data=2, model=2))
        np.testing.assert_array_equal(rows(x), x[6:12])
        with pytest.raises(ValueError, match="does not split"):
            rows(x[:7])


def test_replicated_is_the_inverse_of_batch_sharding(gloo_world_of_one):
    mesh = make_mesh()
    x = torch.arange(10.0).reshape(5, 2)
    torch.testing.assert_close(replicated(mesh)(batch_sharding(mesh)(x)), x)


def _flax_param_shapes(config):
    """The flax params' shapes (traced, not computed)."""
    model = jax_build_model(config)
    image, metadata = jax_example_inputs(config)
    return jax.eval_shape(functools.partial(model.init, train=False), jax.random.key(0),
                          image_input=image, metadata_input=metadata)


@pytest.mark.parametrize("kind", ["convnext_pico.d1_in1k", "inceptionnext_pico.r2"])
def test_sharded_parameters_are_the_jax_model_axis_leaves(kind):
    """mm_ConvNeXt at pico width, model axis 2: the port shards exactly the
    tensors the weight bridge fills from the leaves JAX's rule gives
    P(..., "model"), on the dimension the bridge fills from their last axis
    (tests/test_parallel.py:30-42)."""
    config = pico_config() if kind.startswith("convnext") else \
        type(pico_config())({**pico_config(), "model_kind": kind})
    shapes = _flax_param_shapes(config)
    jax_mesh = jax_make_mesh(data=4, model=2)
    specs = variables_shardings(shapes["params"], jax_mesh)
    # each leaf as the index along its last axis where the rule shards it, -1 elsewhere
    markers = {"params": jax.tree_util.tree_map(
        lambda leaf, s: (np.broadcast_to(np.arange(leaf.shape[-1], dtype=np.float32),
                                         leaf.shape) if s.spec == P(*[None] * (leaf.ndim - 1),
                                                                    "model")
                         else np.full(leaf.shape, -1.0, np.float32)),
        shapes["params"], specs),
        "batch_stats": jax.tree_util.tree_map(lambda leaf: np.full(leaf.shape, -1.0),
                                              shapes["batch_stats"])}
    bridged = state_dict_from_jax(config, markers)
    want = {}
    for name, arr in bridged.items():
        if arr.ndim and arr.min() >= 0:
            # the dim along which the marker counts up
            want[name] = next(d for d in range(arr.ndim)
                              if arr.shape[d] > 1 and np.all(np.diff(arr, axis=d) == 1))
    assert want
    with fake_world(2):
        got = module_shardings(build_model(config, device="cpu"), make_mesh(data=1, model=2))
    assert got == want


@pytest.mark.parametrize("shape,model_size,name,want", [
    ((256, 256), 2, "a.weight", 0),
    ((255, 512), 2, "a.weight", None),           # output features not divisible
    ((128, 256), 2, "a.weight", None),           # 2^15 elements: replicated
    ((65536,), 2, "a.bias", None),               # ndim 1
    ((256, 256), 1, "a.weight", None),           # no model axis
    ((512, 128, 1, 1), 4, "a.weight", 0),        # a 1x1 conv
    ((16, 13, 13), 2, "attn.rel_pos.relative_position_bias_table", None),
    ((64, 64, 32), 2, "attn.rel_pos.relative_position_bias_table", 2),
])
def test_param_spec_follows_the_jax_rule_through_the_bridge(shape, model_size, name, want):
    assert param_spec(name, torch.empty(shape), model_size) == want


LADDER_GRID = [(b, buckets, d) for b in (64, 100, 256, 3072)
               for buckets in (None, [8, 32, 100], [3, 6, 64])
               for d in (1, 2, 3, 4, 8)]


@pytest.mark.parametrize("batch,buckets,data", LADDER_GRID)
def test_bucket_ladder_under_a_mesh_matches_jax(batch, buckets, data):
    try:
        want = jax_bucket_ladder(batch, buckets,
                                 jax_make_mesh(data=data, model=1, devices=jax.devices()[:data]))
    except ValueError:
        want = ValueError
    with fake_world(data):
        mesh = make_mesh()
        if want is ValueError:
            with pytest.raises(ValueError, match="divisible"):
                _bucket_ladder(batch, buckets, mesh)
        else:
            assert _bucket_ladder(batch, buckets, mesh) == want
    assert _bucket_ladder(batch, buckets) == jax_bucket_ladder(batch, buckets, None)


@pytest.mark.parametrize("count", [2, 4])
def test_augmentation_under_a_mesh_is_the_global_batchs(count):
    images = torch.randn(8, 63, 63, 3, generator=torch.Generator().manual_seed(0))
    whole = augment_triplets(torch.Generator().manual_seed(7), images)
    k = 8 // count
    parts = [augment_triplets(torch.Generator().manual_seed(7), images[i * k:(i + 1) * k],
                              rows=(i, count)) for i in range(count)]
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)


@pytest.mark.parametrize("layer,shape", [(Dropout, (8, 16)), (Dropout2d, (8, 5, 5, 6))])
def test_dropout_under_a_mesh_keeps_this_ranks_rows_of_the_global_mask(layer, shape):
    x = torch.ones(shape)
    drop = layer(0.4).train()
    drop.generator = torch.Generator().manual_seed(3)
    whole = drop(x)
    parts = []
    for i in range(2):
        drop.generator = torch.Generator().manual_seed(3)
        drop.rows = (i, 2)
        parts.append(drop(x[i * 4:(i + 1) * 4]))
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)


def test_batchnorm_over_a_data_group_takes_the_flax_statistics(gloo_world_of_one):
    """The summed statistics (one rank here) against the plain ones:
    output, gradient and running statistics."""
    x = torch.randn(12, 5, generator=torch.Generator().manual_seed(1)) * 2 + 1
    results = []
    for group in (None, (dist.group.WORLD, 1)):
        bn = BatchNorm1d(5).train()
        bn.data_group = group
        xi = x.clone().requires_grad_(True)
        y = bn(xi)
        (y * torch.arange(5.0)).square().sum().backward()
        results.append((y.detach(), xi.grad, bn.running_mean.clone(), bn.running_var.clone()))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_run_training_on_a_mesh_of_one_equals_the_run_without(gloo_world_of_one, tmp_path):
    """A world-size-1 mesh (the collectives over one rank) changes nothing:
    the same history, bit for bit, and the same best model."""
    config = train_config(meta_dropout=0.25, comb_dropout=0.2, data_aug_h_flip=1,
                          data_aug_v_flip=1, data_aug_rot=1)
    train_ds, val_ds = _datasets(n_train=16, n_val=16, seed=8)
    kw = dict(train_ds=train_ds, val_ds=val_ds, log=lambda _m: None, device="cpu")
    plain = run_training(config, out_root=str(tmp_path / "plain"), **kw)
    mesh = run_training(config, out_root=str(tmp_path / "mesh"), mesh=make_mesh(), **kw)
    for key, value in plain["history"].items():
        if key != "run_name":
            np.testing.assert_array_equal(mesh["history"][key], value)
    np.testing.assert_array_equal(mesh["best_val_scores"], plain["best_val_scores"])
    for name in ("best_model.pth", "latest.pt", "report.json"):
        assert os.path.isfile(os.path.join(mesh["model_dir"], name))
