"""Multi-process training-path check (port of
btsbot_tpu.parallel.multihost_check).

One process per rank: ``initialize_distributed`` → a (data, model) mesh
over the processes → each rank's rows of one global batch → train steps
whose gradients are averaged over the data axis (and whose wide weights
are sharded on the model axis) → the same finite loss on every rank.  It
runs the JAX check's small mm_cnn config.  Run one process per rank:

    python -m btsbot_tpu_torch.parallel.multihost_check <process_id> \\
        <num_processes> <coordinator_port> [model_axis] [--steps N] \\
        [--die-after K] [--heartbeat-timeout S] [--device cpu|cuda] \\
        [--backend gloo|nccl]

Process 0 listens on the port.  Each rank prints ``MULTIHOST_OK
process=… devices=… processes=… loss=…``.  ``--die-after K`` makes the
process exit with 17 after step K without any shutdown handshake (a dead
host): the others must then fail, bounded by ``--heartbeat-timeout`` (the
process group's timeout), not hang.  The device is the rank's card
(``cuda:{LOCAL_RANK}``, else ``cuda:{process_id}``) unless ``--device``
names one; the backend is ``nccl`` on the card and ``gloo`` on the host
unless ``--backend`` names one.
"""

from __future__ import annotations

import os
import sys

import numpy as np

SMALL_MM_CNN = {
    "model_name": "mm_cnn", "train_data_version": "vmh",
    "metadata_cols": [f"m{i}" for i in range(25)],
    "conv1_channels": 4, "conv2_channels": 4, "conv_kernel": 3,
    "conv_dropout1": 0.1, "conv_dropout2": 0.1,
    "meta_fc1_neurons": 8, "meta_fc2_neurons": 8, "meta_dropout": 0.1,
    "comb_fc1_neurons": 8, "comb_fc2_neurons": 8, "comb_dropout": 0.1,
    "learning_rate": 1e-3, "beta_1": 0.9, "beta_2": 0.999,
    "batch_size": 8, "epochs": 1, "patience": 1, "random_seed": 0,
}
GLOBAL_BATCH = 16


def run_worker(process_id: int, num_processes: int, port: int, model_axis: int = 1,
               steps: int = 2, die_after_step: int | None = None,
               heartbeat_timeout: int | None = None, device: str | None = None,
               backend: str | None = None) -> dict:
    """Run the check in THIS process (one rank); returns {'loss',
    'global_devices', 'process_count'}."""
    import torch
    import torch.distributed as dist

    from ..core.config import normalize_config
    from ..core.device import resolve_device
    from ..engine.state import create_train_state
    from ..engine.steps import make_train_step
    from ..models.factory import build_model
    from .mesh import batch_sharding, initialize_distributed, make_mesh

    if backend is None:
        backend = "gloo" if device is not None and device.startswith("cpu") else "nccl"
    initialize_distributed(coordinator_address=f"localhost:{port}",
                           num_processes=num_processes, process_id=process_id,
                           heartbeat_timeout_seconds=heartbeat_timeout, backend=backend)
    try:
        mesh = make_mesh(model=model_axis)
        dev = resolve_device(device, mesh)
        config = normalize_config(SMALL_MM_CNN)
        # every rank builds the same weights from the seed
        model = build_model(config, device=dev, seed=0)
        state = create_train_state(config, model, steps_per_epoch=2, seed=0, mesh=mesh)
        train_step = make_train_step(config, mesh=mesh)

        # one global batch; each rank feeds its rows (a multi-host input
        # pipeline's local shards)
        rng = np.random.default_rng(100)
        batch = (rng.normal(size=(GLOBAL_BATCH, 63, 63, 3)).astype(np.float32),
                 rng.normal(size=(GLOBAL_BATCH, 25)).astype(np.float32),
                 (rng.random(GLOBAL_BATCH) < 0.5).astype(np.float32))
        rows = batch_sharding(mesh)
        local = [torch.from_numpy(rows(x)).to(dev) for x in batch]
        loss = None
        for step_i in range(steps):
            loss = float(train_step(state, *local, 1.0)["loss"])
            if die_after_step is not None and step_i == die_after_step:
                print(f"MULTIHOST_DYING process={process_id} step={step_i}", flush=True)
                os._exit(17)  # abrupt: no shutdown handshake, like a dead host
        return {"loss": loss, "global_devices": dist.get_world_size(),
                "process_count": dist.get_world_size()}
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    kwargs = {}
    pos = []
    it = iter(argv)
    for a in it:
        if a == "--steps":
            kwargs["steps"] = int(next(it))
        elif a == "--die-after":
            kwargs["die_after_step"] = int(next(it))
        elif a == "--heartbeat-timeout":
            kwargs["heartbeat_timeout"] = int(next(it))
        elif a == "--device":
            kwargs["device"] = next(it)
        elif a == "--backend":
            kwargs["backend"] = next(it)
        else:
            pos.append(a)
    process_id, num_processes, port = (int(a) for a in pos[:3])
    model_axis = int(pos[3]) if len(pos) > 3 else 1
    result = run_worker(process_id, num_processes, port, model_axis, **kwargs)
    print(f"MULTIHOST_OK process={process_id} devices={result['global_devices']} "
          f"processes={result['process_count']} loss={result['loss']:.6f}", flush=True)


if __name__ == "__main__":
    main()
