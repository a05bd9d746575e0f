"""The multi-process dry runs (port of ``dryrun_multichip`` /
``dryrun_multihost`` in the repository's ``__graft_entry__.py``).

The JAX dry run sweeps (data, model) meshes over virtual devices of one
process; here each device is a process.  ``dryrun_multichip(n)`` spawns
``n`` ranks on a gloo group, each on the host (``device="cpu"``), and
every rank runs the sweep:

* each mesh shape of ``_mesh_shapes(n)``: one flagship (mm_ConvNeXt-pico)
  train step and an eval step at batch 2n, finite loss and scores;
* ``AlertScorer`` over the hybrid mesh with the bucket ladder engaged (a
  full batch and a partial tail);
* mm_MaxViT (``maxvit_tiny`` at 96 px), frozen_fusion (um_cnn + um_nn
  branches, the head trained) and mm_InceptionNeXt-pico.r2: a train and
  an eval step each on the hybrid mesh;
* a resume under the hybrid mesh: step, save, restore into a fresh state,
  step again: the loss equals the uninterrupted run's;
* a serving trickle under the most model-heavy mesh: a flush whose count
  the data axis does not divide is padded to the smallest conforming
  bucket and returns exactly that many finite scores.

``dryrun_multihost(n)`` spawns ``n`` ``multihost_check`` workers and
holds their losses equal.  ``spawn`` is the launcher both use: ``n``
fresh processes, rank i of n, each calling a ``module:function`` target
on a started process group; a rank that fails (or the timeout) kills the
others.

    python -c "from btsbot_tpu_torch.parallel.dryrun import dryrun_multichip; \\
               dryrun_multichip(4)"
"""

from __future__ import annotations

import importlib
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

META_COLS = [
    "sgscore1", "distpsnr1", "sgscore2", "distpsnr2", "fwhm", "magpsf",
    "sigmapsf", "chipsf", "ra", "dec", "diffmaglim", "ndethist", "nmtchps",
    "age", "days_since_peak", "days_to_peak", "peakmag_so_far", "new_drb",
    "ncovhist", "nnotdet", "chinr", "sharpnr", "scorr", "sky", "maxmag_so_far",
]

FLAGSHIP_CONFIG = {
    "model_name": "mm_ConvNeXt", "model_kind": "convnext_pico.d1_in1k",
    "train_data_version": "v12", "metadata_cols": META_COLS,
    "meta_fc1_neurons": 128, "meta_fc2_neurons": 128, "meta_dropout": 0.25,
    "comb_fc1_neurons": 256, "comb_fc2_neurons": 32, "comb_dropout": 0.2,
    "learning_rate": 1e-4, "beta_1": 0.99, "beta_2": 0.99, "batch_size": 64,
    "epochs": 10, "warmup_epochs": 1, "patience": 5, "random_seed": 2,
}

# maxvit_tiny's depths and widths at 96 px native resolution, which bounds
# the host's cost (the JAX dry run's cut)
MAXVIT_DRYRUN_CONFIG = {
    "model_name": "mm_MaxViT", "model_kind": "maxvit_tiny_rw_96.dryrun",
    "train_data_version": "v12", "metadata_cols": META_COLS, "pretrained": False,
    "fc1_neurons": 32, "fc2_neurons": 16, "dropout": 0.3,
    "meta_fc1_neurons": 64, "meta_fc2_neurons": 64, "meta_dropout": 0.25,
    "comb_fc1_neurons": 64, "comb_fc2_neurons": 32, "comb_dropout": 0.2,
    "learning_rate": 1e-4, "beta_1": 0.9, "beta_2": 0.999, "batch_size": 16,
    "epochs": 2, "warmup_epochs": 1, "patience": 2, "random_seed": 0,
}


def _fusion_dryrun_config() -> dict:
    """frozen_fusion over inline um_cnn and um_nn branch configs."""
    base = {"train_data_version": "v12", "metadata_cols": META_COLS,
            "learning_rate": 1e-4, "beta_1": 0.9, "beta_2": 0.999,
            "batch_size": 16, "epochs": 2, "warmup_epochs": 1,
            "patience": 2, "random_seed": 0}
    image = {**base, "model_name": "um_cnn", "conv1_channels": 16, "conv2_channels": 16,
             "conv_kernel": 5, "conv_dropout1": 0.3, "conv_dropout2": 0.3,
             "fc1_neurons": 32, "fc2_neurons": 16, "dropout": 0.3}
    meta = {**base, "model_name": "um_nn", "meta_fc1_neurons": 32,
            "meta_fc2_neurons": 16, "meta_dropout": 0.25}
    return {**base, "model_name": "frozen_fusion", "image_model_config": image,
            "meta_model_config": meta, "image_model_dir": "", "meta_model_dir": "",
            "comb_fc1_neurons": 32, "comb_fc2_neurons": 16, "comb_dropout": 0.2}


def _mesh_shapes(n: int) -> list[tuple[int, int]]:
    """(data, model) shapes to sweep: all data, the default hybrid, and a
    model-heavier split where the count allows."""
    shapes = [(n, 1)]
    if n % 2 == 0 and n >= 2:
        shapes.append((n // 2, 2))
    if n % 4 == 0 and n >= 8:
        shapes.append((n // 4, 4))
    return shapes


# ----------------------------------------------------------------- launcher

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(n: int, target: str, args=(), backend: str = "gloo", timeout: float = 600.0,
          path=()) -> list[str]:
    """Run ``target`` (``"module:function"``, called with ``*args``, which
    must be JSON) as rank i of ``n`` in ``n`` fresh processes on one
    process group, and return each rank's output.  ``path``: directories
    to import the target from, beside the repository.  Raises when a rank
    fails or ``timeout`` seconds pass; the other ranks are killed first."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [_ROOT, *path] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))}
    with tempfile.TemporaryDirectory(prefix="btsbot_spawn_") as tmp:
        logs = [open(os.path.join(tmp, f"rank{i}.log"), "w+") for i in range(n)]
        try:
            procs = [subprocess.Popen(
                [sys.executable, "-m", __name__, target, str(i), str(n), str(port), backend,
                 json.dumps(list(args))],
                cwd=_ROOT, env=env, stdout=logs[i], stderr=subprocess.STDOUT)
                for i in range(n)]
            deadline = time.monotonic() + timeout
            failed = []
            try:
                while any(p.poll() is None for p in procs):
                    failed = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
                    if failed:
                        break  # the others would wait on the failed rank
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{target}: {n} ranks ran past {timeout} s")
                    time.sleep(0.05)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                    p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
        finally:
            for f in logs:
                f.close()
    failed = failed or [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed:
        i = failed[0]
        raise RuntimeError(f"{target}: rank {i} of {n} exited {procs[i].returncode}:\n"
                           f"{outs[i][-4000:]}")
    return outs


def _worker(argv: list[str]) -> None:
    target, rank, n, port, backend, args = argv
    import torch
    import torch.distributed as dist

    from .mesh import initialize_distributed

    if backend == "gloo":  # n ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(n)))
    initialize_distributed(f"localhost:{port}", int(n), int(rank), backend=backend)
    module, _, fn = target.partition(":")
    try:
        getattr(importlib.import_module(module), fn)(*json.loads(args))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ the sweep

def _batch(n: int, seed: int, image_size: int = 63):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, image_size, image_size, 3)).astype(np.float32),
            r.normal(size=(n, len(META_COLS))).astype(np.float32),
            r.integers(0, 2, size=(n,)).astype(np.float32))


def _fresh_state(config, mesh, device):
    from ..engine.state import create_train_state
    from ..models.factory import build_model

    model = build_model(config, device=device, seed=0)
    return create_train_state(config, model, steps_per_epoch=1, seed=0, mesh=mesh)


def _local(mesh, batch, device):
    import torch

    from .mesh import batch_sharding

    rows = batch_sharding(mesh)
    return [torch.from_numpy(rows(x)).to(device) for x in batch]


def _train_eval(config, mesh, batch: int, device) -> float:
    """One train step and one eval step under ``mesh`` at global ``batch``."""
    from ..engine.steps import make_eval_step, make_train_step

    state = _fresh_state(config, mesh, device)
    images, metadata, labels = _local(mesh, _batch(batch, 0), device)
    loss = float(make_train_step(config, mesh=mesh)(state, images, metadata, labels,
                                                    1.5)["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss in the dry run: {loss}")
    _, scores = make_eval_step(config, mesh)(state.model, images, metadata)
    scores = scores.cpu().numpy()
    if scores.shape != (batch,) or not np.all(np.isfinite(scores)):
        raise AssertionError(f"eval scores {scores.shape}, finite {np.isfinite(scores).all()}")
    return loss


def _resume(config, mesh, batch: int, device) -> None:
    """Step → save → restore into a fresh state → step: the same loss as
    the uninterrupted second step."""
    import torch.distributed as dist

    from ..engine.checkpoint import restore_train_state, save_train_state
    from ..engine.steps import make_train_step

    step = make_train_step(config, mesh=mesh)
    b1, b2 = (_local(mesh, _batch(batch, s), device) for s in (11, 12))
    state = _fresh_state(config, mesh, device)
    step(state, *b1, 1.5)
    path = [tempfile.mkdtemp(prefix="dryrun_resume_") if mesh.rank == 0 else None]
    dist.broadcast_object_list(path, src=0)
    ckpt = os.path.join(path[0], "latest.pt")
    try:
        save_train_state(ckpt, state, {"epoch": 0})
        loss_cont = float(step(state, *b2, 1.5)["loss"])
        restored, extra = restore_train_state(ckpt, _fresh_state(config, mesh, device))
        if extra["epoch"] != 0:
            raise AssertionError(f"restored extra {extra}")
        loss_res = float(step(restored, *b2, 1.5)["loss"])
    finally:
        mesh.barrier()
        if mesh.rank == 0:
            import shutil
            shutil.rmtree(path[0], ignore_errors=True)
    if not (np.isfinite(loss_cont)
            and abs(loss_res - loss_cont) <= 1e-5 * max(1.0, abs(loss_cont))):
        raise AssertionError(f"resume under the mesh diverged: {loss_res} vs {loss_cont}")


def _weights(config):
    from ..models.factory import build_model

    return build_model(config, device="cpu", seed=0).state_dict()


def _serving(config, mesh, n_ranks: int, device, trickle: bool) -> None:
    """AlertScorer over ``mesh`` with the ladder [n, 2n]: 3n − 1 alerts (a
    full batch and a tail) or a trickle of data − 1 alerts."""
    from ..engine.serve import AlertScorer

    scorer = AlertScorer(config, _weights(config), batch_size=2 * n_ranks, mesh=mesh,
                         bucket_sizes=[n_ranks, 2 * n_ranks], device=device)
    d = mesh.shape["data"]
    if any(b % d for b in scorer.bucket_sizes):
        raise AssertionError(f"ladder {scorer.bucket_sizes} under data axis {d}")
    n = max(1, d - 1) if trickle else 3 * n_ranks - 1
    trips, meta, _ = _batch(n, 7 if trickle else 1)
    scores = scorer(trips, meta)
    if scores.shape != (n,) or not np.all(np.isfinite(scores)):
        raise AssertionError(f"{n} alerts gave scores {scores.shape}")


def multichip_rank(n: int, device: str = "cpu") -> None:
    """One rank's sweep (the target ``dryrun_multichip`` spawns)."""
    from ..core.config import normalize_config
    from .mesh import make_mesh

    import torch.distributed as dist
    rank = dist.get_rank()

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    config = normalize_config(FLAGSHIP_CONFIG)
    results = []
    for data, model in _mesh_shapes(n):
        mesh = make_mesh(data=data, model=model)
        loss = _train_eval(config, mesh, 2 * n, device)
        results.append((dict(mesh.shape), loss))
        say(f"dryrun mesh {mesh.shape}: train+eval OK loss={loss:.4f}")

    shapes = _mesh_shapes(n)
    serve_shape = shapes[1] if n >= 8 and len(shapes) > 1 else shapes[-1]
    hybrid = make_mesh(data=serve_shape[0], model=serve_shape[1])
    _serving(config, hybrid, n, device, trickle=False)
    say(f"dryrun serving mesh {hybrid.shape}: bucketed AlertScorer OK")

    families = [("mm_MaxViT", normalize_config(MAXVIT_DRYRUN_CONFIG)),
                ("frozen_fusion", normalize_config(_fusion_dryrun_config()))]
    for name, cfg in families:
        loss = _train_eval(cfg, hybrid, 2 * n, device)
        say(f"dryrun {name} mesh {hybrid.shape}: train+eval OK loss={loss:.4f}")

    _resume(config, hybrid, 2 * n, device)
    say(f"dryrun resume-under-mesh {hybrid.shape}: restored step matches continuation OK")

    ix_cfg = normalize_config({**FLAGSHIP_CONFIG, "model_kind": "inceptionnext_pico.r2"})
    loss = _train_eval(ix_cfg, hybrid, 2 * n, device)
    say(f"dryrun mm_InceptionNeXt.r2 mesh {hybrid.shape}: train+eval OK loss={loss:.4f}")

    tp_shape = shapes[-1]
    tp_mesh = make_mesh(data=tp_shape[0], model=tp_shape[1])
    _serving(config, tp_mesh, n, device, trickle=True)
    say(f"dryrun serving trickle mesh {tp_mesh.shape}: non-divisible flush padded+scored OK")
    say(f"dryrun_multichip OK: meshes={[s for s, _ in results]} loss={results[0][1]:.4f} "
        "families=[mm_ConvNeXt, mm_MaxViT, frozen_fusion, mm_InceptionNeXt.r2] "
        "resume=ok trickle=ok")


def dryrun_multichip(n_processes: int, timeout: float = 1800.0) -> str:
    """Sweep the mesh shapes of ``n_processes`` gloo ranks on the host over
    training, evaluation and serving; returns (and prints) rank 0's report."""
    out = spawn(n_processes, f"{__name__}:multichip_rank", [n_processes],
                timeout=timeout)[0]
    report = "\n".join(line for line in out.splitlines() if line.startswith("dryrun"))
    print(report, flush=True)
    return report


def dryrun_multihost(n_processes: int = 2, model_axis: int = 1,
                     timeout: float = 300.0) -> float:
    """``n_processes`` ``multihost_check`` workers on gloo and the host:
    every one must report the same finite loss, which is returned."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": _ROOT}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "btsbot_tpu_torch.parallel.multihost_check", str(i),
         str(n_processes), str(port), str(model_axis), "--device", "cpu"],
        cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n_processes)]
    losses = []
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"process {i} failed:\n{out[-2000:]}")
            m = re.search(r"MULTIHOST_OK .* loss=([\d.eE+-]+)", out)
            if not m:
                raise RuntimeError(out[-2000:])
            losses.append(float(m.group(1)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if len(set(losses)) != 1 or not np.isfinite(losses[0]):
        raise AssertionError(f"losses differ: {losses}")
    print(f"dryrun_multihost OK: {n_processes} processes, loss={losses[0]:.4f}", flush=True)
    return losses[0]


if __name__ == "__main__":
    _worker(sys.argv[1:])
