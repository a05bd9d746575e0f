"""What the mesh tests run in spawned gloo ranks
(``btsbot_tpu_torch.parallel.dryrun.spawn``), and the one-process
reference they hold it to: the same functions with ``mesh=None``.

``run(workdir)`` is one rank's job.  It reads ``inputs.pt`` (configs,
weights, a global batch, split files) from ``workdir``, runs every case
under the meshes 2×1 and 1×2 of a 2-rank group, and writes
``rank{r}.pt``.  Imports torch and the port only.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch


def one_step(config, weights, batch, mesh=None, device="cpu") -> dict:
    """One train step from ``weights`` on the global ``batch`` (images,
    metadata, labels, pos_weight); under ``mesh`` this rank feeds its
    rows.  Returns the loss, the global ``correct`` and the whole
    parameters and BatchNorm statistics after the step."""
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.engine.state import create_train_state
    from btsbot_tpu_torch.engine.steps import make_train_step
    from btsbot_tpu_torch.models.factory import build_model
    from btsbot_tpu_torch.parallel.mesh import batch_sharding
    from btsbot_tpu_torch.parallel.sharding import full_state_dict, module_shardings

    config = normalize_config(config)
    model = build_model(config, device=device)
    model.load_state_dict(weights, strict=True)
    state = create_train_state(config, model, steps_per_epoch=4, seed=3, mesh=mesh)
    *arrays, pos_weight = batch
    if mesh is not None:
        arrays = [batch_sharding(mesh)(x) for x in arrays]
    m = make_train_step(config, mesh=mesh)(
        state, *(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in arrays),
        pos_weight)
    return {"loss": float(m["loss"]), "correct": int(m["correct"]),
            "scores": m["scores"].cpu(),
            "state": {k: v.detach().cpu() for k, v in full_state_dict(state.model).items()},
            "sharded": module_shardings(state.model, mesh) if mesh is not None else {},
            "shapes": {n: tuple(p.shape) for n, p in state.model.named_parameters()}}


def train(config, data_dir, out_root, mesh=None, resume=False, device="cpu") -> dict:
    """``run_training`` on the split files of ``data_dir``."""
    from btsbot_tpu_torch.engine.train import run_training
    from btsbot_tpu_torch.parallel.sharding import module_shardings

    r = run_training(config, data_dir=data_dir, out_root=out_root, run_name="run",
                     resume=resume, log=lambda _m: None, device=device, mesh=mesh)
    return {"history": {k: np.asarray(v) for k, v in r["history"].items()
                        if k != "run_name"},
            "model_dir": r["model_dir"], "best_val_scores": r["best_val_scores"],
            "sharded": module_shardings(r["model"], mesh) if mesh is not None else {},
            "shapes": {n: tuple(p.shape) for n, p in r["model"].named_parameters()},
            "step": r["state"].step}


def score(config, weights, trips, meta, batch_size, bucket_sizes=None, mesh=None,
          device="cpu") -> np.ndarray:
    from btsbot_tpu_torch.engine.serve import AlertScorer

    scorer = AlertScorer(config, weights, batch_size=batch_size, dtype=torch.float32,
                         bucket_sizes=bucket_sizes, mesh=mesh, device=device)
    return scorer(trips, meta)


def serving_cases(inputs) -> list:
    """(name, kwargs of ``score``): 40 alerts at batch 16, and the dry
    run's tail (3·2 − 1 alerts) and trickle (data − 1, at least 1) at
    batch 4 with the ladder [2, 4]."""
    trips, meta = inputs["serve"]
    return [("batch16", dict(trips=trips, meta=meta, batch_size=16)),
            ("tail", dict(trips=trips[:5], meta=meta[:5], batch_size=4, bucket_sizes=[2, 4])),
            ("trickle", dict(trips=trips[:1], meta=meta[:1], batch_size=4,
                             bucket_sizes=[2, 4]))]


def run(workdir: str) -> None:
    import torch.distributed as dist

    from btsbot_tpu_torch.parallel.mesh import make_mesh

    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    meshes = {shape: make_mesh(data=shape[0], model=shape[1]) for shape in ((2, 1), (1, 2))}
    out = {"steps": {}, "serve": {}}
    for shape, mesh in meshes.items():
        out["steps"][shape] = one_step(inputs["config"], inputs["weights"], inputs["batch"],
                                       mesh)
        for name, kw in serving_cases(inputs):
            out["serve"][shape, name] = score(inputs["config"], inputs["weights"], mesh=mesh,
                                              **kw)
    out["jax_step"] = one_step(inputs["jax_config"], inputs["jax_weights"],
                               inputs["jax_batch"], meshes[2, 1])
    try:
        score(inputs["config"], inputs["weights"], *inputs["serve"], batch_size=15,
              mesh=meshes[2, 1])
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    # two epochs data parallel, then a third resumed on the model axis
    out["train"] = train(inputs["train_config"], inputs["data_dir"], inputs["out_root"],
                         meshes[2, 1])
    if dist.get_rank() == 0:  # the resume below may write a later best model
        shutil.copy(os.path.join(out["train"]["model_dir"], "best_model.pth"),
                    os.path.join(workdir, "best_2x1.pth"))
    out["resumed"] = train(dict(inputs["train_config"], epochs=3), inputs["data_dir"],
                           inputs["out_root"], meshes[1, 2], resume=True)
    torch.save(out, os.path.join(workdir, f"rank{dist.get_rank()}.pt"))
