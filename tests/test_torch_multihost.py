"""The port's mesh across processes on the CPU: spawned gloo ranks
(``device="cpu"``) against the one-process run and the JAX package's
mesh step.

One 2-rank job (``torch_mesh_jobs.run``) runs every case under the
meshes 2×1 (data) and 1×2 (model) of one process group; the test process
runs the same functions without a mesh.  Tolerances:

* a step with dropout and augmentation on (the small ConvNeXt, γ = 0.5):
  loss rtol 1e-5; the combined head's output weight after the step rtol
  1e-5 / atol 1e-7 (the JAX test's, tests/test_parallel.py:79-82);
  BatchNorm running statistics rtol 1e-6 / atol 1e-7 (sums over two
  ranks, float32);
* the 2×1 step with dropout 0 and no augmentation against JAX's step on
  ``make_mesh(data=2, model=1)``: loss rtol 1e-4, BatchNorm statistics
  rtol 1e-6 / atol 1e-7 (tests/test_torch_train.py's);
* ``run_training``: per-epoch losses rtol 1e-5 of the one-process run;
  ``AlertScorer``: rtol 1e-5 / atol 1e-6 of the unsharded scorer.

The 4-process hybrid mesh and ``dryrun_multichip(4)`` are ``slow``, as
the JAX package's multi-process tests and dry run are.
"""

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from btsbot_tpu.engine.state import create_train_state as jax_create_train_state
from btsbot_tpu.engine.state import make_optimizer
from btsbot_tpu.engine.steps import make_train_step as jax_make_train_step
from btsbot_tpu.interop.convert import torch_state_dict_to_variables
from btsbot_tpu.models.factory import build_model as jax_build_model
from btsbot_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from btsbot_tpu.parallel.mesh import make_mesh as jax_make_mesh
from btsbot_tpu.parallel.sharding import shard_variables
from btsbot_tpu_torch.core.config import normalize_config
from btsbot_tpu_torch.engine.checkpoint import load_model_checkpoint, load_torch_checkpoint
from btsbot_tpu_torch.engine.eval import predict_dataset
from btsbot_tpu_torch.data.dataset import load_split
from btsbot_tpu_torch.models.factory import build_model
from btsbot_tpu_torch.parallel.dryrun import dryrun_multichip, free_port, spawn
from test_torch_train import train_config, write_split
import torch_mesh_jobs as jobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
MESHES = ((2, 1), (1, 2))
BN = ("metadata_branch.0.running_mean", "metadata_branch.0.running_var")
OUT_W = "combined_head.5.weight"


def _batch(n, seed, n_meta=25):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 63, 63, 3)).astype(np.float32),
            rng.normal(size=(n, n_meta)).astype(np.float32),
            (rng.random(n) < 0.4).astype(np.float32), 1.3)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("mesh"))
    data = os.path.join(work, "data")
    os.makedirs(data)
    write_split(data, "train", 32, seed=1)
    write_split(data, "val", 16, seed=2)
    config = train_config(meta_dropout=0.25, comb_dropout=0.2, data_aug_h_flip=1,
                          data_aug_v_flip=1, data_aug_rot=1, random_seed=4)
    model = build_model(config, device="cpu", seed=0)
    with torch.no_grad():  # γ = 0.5: every block counts in the step
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.fill_(0.5)
    # the JAX step's weights: the port's flax-scheme init, carried across by
    # the JAX package's converter (its eager init costs more than the test)
    jax_config = train_config()
    jax_weights = build_model(jax_config, device="cpu", seed=1).state_dict()
    jax_model = jax_build_model(jax_config)
    variables = torch_state_dict_to_variables(
        jax_config, {k: v.numpy() for k, v in jax_weights.items()})
    rng = np.random.default_rng(9)
    inp = {  # configs as plain dicts: the ranks import no JAX
        "config": dict(config), "weights": model.state_dict(), "batch": _batch(16, 5),
        "jax_config": dict(jax_config), "jax_batch": _batch(16, 6),
        "jax_weights": jax_weights,
        "train_config": dict(train_config(meta_dropout=0.25, comb_dropout=0.2,
                                          data_aug_h_flip=1, data_aug_v_flip=1,
                                          data_aug_rot=1)),
        "data_dir": data, "out_root": os.path.join(work, "mesh_runs"),
        "serve": (rng.normal(size=(40, 63, 63, 3)).astype(np.float32),
                  rng.normal(size=(40, 25)).astype(np.float32)),
    }
    torch.save(inp, os.path.join(work, "inputs.pt"))
    # the ranks run while this process computes its own side
    pool = concurrent.futures.ThreadPoolExecutor(1)
    job = pool.submit(spawn, 2, "torch_mesh_jobs:run", [work], timeout=300, path=[TESTS])
    yield dict(inp, work=work, jax_model=jax_model, jax_variables=variables,
               jax_config_obj=jax_config, job=job)
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(inputs, cli_run, single, jax_step):
    """Both ranks' results of the 2-rank job (waited for after this
    process's own side)."""
    inputs["job"].result()
    return [torch.load(os.path.join(inputs["work"], f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def single(inputs, tmp_path_factory):
    """The same cases in this process, without a mesh."""
    root = str(tmp_path_factory.mktemp("single"))
    return {
        "step": jobs.one_step(inputs["config"], inputs["weights"], inputs["batch"]),
        "train": jobs.train(inputs["train_config"], inputs["data_dir"], root),
        "resumed": jobs.train(dict(inputs["train_config"], epochs=3), inputs["data_dir"],
                              root, resume=True),
        "serve": {name: jobs.score(inputs["config"], inputs["weights"], **kw)
                  for name, kw in jobs.serving_cases(inputs)},
    }


def _assert_step_matches(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["correct"] == want["correct"]
    np.testing.assert_allclose(got["state"][OUT_W].numpy(), want["state"][OUT_W].numpy(),
                               rtol=1e-5, atol=1e-7)
    for name in BN:
        np.testing.assert_allclose(got["state"][name].numpy(), want["state"][name].numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_step_under_a_mesh_equals_the_one_process_step(ranks, single, shape):
    """Dropout and augmentation on: each rank draws the global batch's
    masks and flips, BatchNorm takes the global batch's statistics."""
    for r in ranks:
        _assert_step_matches(r["steps"][shape], single["step"])
    np.testing.assert_allclose(ranks[0]["steps"][shape]["scores"].numpy(),
                               single["step"]["scores"].numpy(), rtol=1e-5, atol=1e-6)


def test_model_axis_keeps_one_shard_of_each_big_weight(ranks, single):
    got = ranks[0]["steps"][1, 2]
    assert got["sharded"] and set(got["sharded"].values()) == {0}
    whole = single["step"]["state"]
    for name, dim in got["sharded"].items():
        assert whole[name].shape[dim] % 2 == 0 and whole[name].numel() >= 1 << 16
        assert got["state"][name].shape == whole[name].shape   # gathered for the checkpoint
    local = {n.replace("parametrizations.", "").replace(".original", ""): s
             for n, s in got["shapes"].items()}
    for name, dim in got["sharded"].items():
        want = list(whole[name].shape)
        want[dim] //= 2
        assert list(local[name]) == want
    assert ranks[0]["steps"][2, 1]["sharded"] == {}


def test_every_rank_returns_the_same_results(ranks):
    a, b = ranks
    for shape in MESHES:
        assert a["steps"][shape]["loss"] == b["steps"][shape]["loss"]
    for key in a["serve"]:
        np.testing.assert_array_equal(a["serve"][key], b["serve"][key])
    for run in ("train", "resumed"):
        for k, v in a[run]["history"].items():
            np.testing.assert_array_equal(b[run]["history"][k], v)


@pytest.fixture(scope="module")
def jax_step(inputs):
    """The JAX package's step on make_mesh(data=2, model=1): (loss, the
    metadata BatchNorm's mean and var after it)."""
    config = inputs["jax_config_obj"]
    images, metadata, labels, pw = inputs["jax_batch"]
    tx = make_optimizer(config, steps_per_epoch=4)
    mesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    state = jax_create_train_state(config, inputs["jax_variables"], tx, seed=3)
    state = state.replace(params=shard_variables(state.params, mesh),
                          batch_stats=shard_variables(state.batch_stats, mesh),
                          opt_state=shard_variables(state.opt_state, mesh))
    shard = jax_batch_sharding(mesh)
    with mesh:
        state, m = jax_make_train_step(inputs["jax_model"], tx, config)(
            state, *(jax.device_put(jnp.asarray(x), shard) for x in (images, metadata, labels)),
            jnp.float32(pw))
    bn = state.batch_stats["metadata_branch"]["bn"]
    return float(m["loss"]), np.asarray(bn["mean"]), np.asarray(bn["var"])


def test_data_parallel_step_matches_the_jax_mesh_step(ranks, jax_step):
    """2×1 in the port against the JAX step on make_mesh(data=2, model=1):
    dropout 0, no augmentation, flax-scheme weights."""
    got = ranks[0]["jax_step"]
    np.testing.assert_allclose(got["loss"], jax_step[0], rtol=1e-4)
    for ours, theirs in zip(BN, jax_step[1:]):
        np.testing.assert_allclose(got["state"][ours].numpy(), theirs, rtol=1e-6, atol=1e-7)


def test_run_training_under_a_mesh_equals_one_process(inputs, ranks, single):
    got, want = ranks[0]["train"], single["train"]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got["history"][key], want["history"][key], rtol=1e-5)
    for key in ("train_accuracy", "val_accuracy"):
        np.testing.assert_array_equal(got["history"][key], want["history"][key])
    # rank 0's best_model.pth: whole tensors, loaded without a mesh
    config = normalize_config(inputs["train_config"])
    model = build_model(config, device="cpu")
    model.load_state_dict(load_torch_checkpoint(os.path.join(inputs["work"], "best_2x1.pth")),
                          strict=True)
    _, scores = predict_dataset(model, config, load_split(config, "val", inputs["data_dir"]))
    np.testing.assert_allclose(scores, got["best_val_scores"], rtol=0, atol=1e-6)
    assert sorted(os.listdir(got["model_dir"])) == ["best_model.pth", "latest.pt",
                                                    "report.json"]


def test_resume_under_the_model_axis_reshards(ranks, single):
    """latest.pt written by the 2×1 run, resumed under 1×2: the third
    epoch equals the one-process resumed run's, on sharded weights."""
    got, want = ranks[0]["resumed"], single["resumed"]
    assert got["step"] == want["step"] == 6
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got["history"][key], want["history"][key], rtol=1e-5)
    assert got["sharded"]
    for name, dim in got["sharded"].items():
        key = name.rpartition(".")[0] + ".parametrizations." + name.rpartition(".")[2] \
            + ".original"
        assert got["shapes"][key][dim] * 2 == want["shapes"][name][dim]


@pytest.mark.parametrize("case", ["batch16", "tail", "trickle"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_alert_scorer_under_a_mesh_matches_the_unsharded_scorer(ranks, single, shape, case):
    got = ranks[0]["serve"][shape, case]
    want = single["serve"][case]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_alert_scorer_refuses_a_batch_the_data_axis_does_not_split(ranks):
    assert "divisible" in ranks[0]["indivisible"]


@pytest.fixture(scope="module")
def cli_run(inputs):
    """``cli.train --mesh 2x1`` under torchrun (2 ranks, gloo, the host),
    started beside the rest: (process, out root)."""
    cfg = os.path.join(inputs["work"], "cli_config.json")
    with open(cfg, "w") as f:
        json.dump(dict(inputs["train_config"], epochs=1), f)
    out = os.path.join(inputs["work"], "cli_models")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "btsbot_tpu_torch.cli.train", cfg, "--mesh", "2x1", "--device",
         "cpu", "--no-figure", "--data-dir", inputs["data_dir"], "--out-root", out],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_cli_train_under_torchrun_trains_on_gloo(inputs, cli_run, single):
    proc, out = cli_run
    try:
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stdout[-2000:] + stderr[-3000:]
    assert stdout.count("epoch 1/1") == 1   # rank 0 alone logs
    run_dir = os.path.join(out, "mm_ConvNeXt_v12_N100_torch", "run")
    with open(os.path.join(run_dir, "report.json")) as f:
        report = json.load(f)
    # the one-process run's first epoch: the same batches, draws and (warmup) LR
    np.testing.assert_allclose(report["Training history"]["train_loss"],
                               single["train"]["history"]["train_loss"][:1], rtol=1e-5)
    config = normalize_config(dict(inputs["train_config"], epochs=1))
    model = build_model(config, device="cpu")
    model.load_state_dict(load_model_checkpoint(config, run_dir), strict=True)


def _workers(n, extra=(), model_axis=1):
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "btsbot_tpu_torch.parallel.multihost_check", str(i), str(n),
         str(port), str(model_axis), "--device", "cpu", *extra],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(n)]


def _communicate_all(procs, timeout):
    """Every worker's output; on a timeout every worker is killed."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _losses(procs, outs, n):
    losses = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        m = re.search(r"MULTIHOST_OK process=\d+ devices=(\d+) processes=(\d+) "
                      r"loss=([\d.eE+-]+)", out)
        assert m, out[-2000:]
        assert m.group(1) == m.group(2) == str(n)
        losses.append(float(m.group(3)))
    return losses


def test_two_multihost_check_workers_report_the_same_loss():
    procs = _workers(2)
    losses = _losses(procs, _communicate_all(procs, 120), 2)
    assert losses[0] == losses[1] and 0.0 < losses[0] < 10.0


def test_worker_death_fails_fast_not_hang():
    """One of four workers os._exit()s after step 1 without a handshake
    (tests/test_multihost.py's case): the others must exit non-zero (gloo
    sees the closed connection) instead of hanging, never finishing their
    50 steps."""
    extra = ["--steps", "50", "--heartbeat-timeout", "10"]
    port = free_port()
    procs = []
    for i in range(4):
        cmd = [sys.executable, "-m", "btsbot_tpu_torch.parallel.multihost_check", str(i), "4",
               str(port), "1", "--device", "cpu", *extra] + (["--die-after", "1"] if i == 2
                                                             else [])
        procs.append(subprocess.Popen(cmd, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO,
                                                          "OMP_NUM_THREADS": "2"},
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    t0 = time.monotonic()
    outs = _communicate_all(procs, 60)
    assert procs[2].returncode == 17 and "MULTIHOST_DYING process=2" in outs[2]
    for i in (0, 1, 3):
        assert procs[i].returncode != 0, f"worker {i} exited 0 despite a dead peer"
        assert "MULTIHOST_OK" not in outs[i]
    assert time.monotonic() - t0 < 60


@pytest.mark.slow
def test_four_process_hybrid_mesh_train_step():
    procs = _workers(4, model_axis=2)
    losses = _losses(procs, _communicate_all(procs, 300), 4)
    assert len(set(losses)) == 1 and 0.0 < losses[0] < 10.0


@pytest.mark.slow
def test_dryrun_multichip_four_ranks():
    report = dryrun_multichip(4)
    assert "dryrun_multichip OK" in report and "resume=ok trickle=ok" in report
