"""Training CLI: ``python -m btsbot_tpu_torch.cli.train <config.json> [options]``.

The port of ``python -m btsbot_tpu.cli.train``.  It trains on the CUDA
card; ``--device cpu`` asks for the host.  As in the JAX CLI the
diagnostic figure is drawn unless ``--no-figure``; it needs matplotlib,
and without it the run raises before its first step.

``--mesh DATAxMODEL`` trains over a (data, model) mesh of ranks, one
process each, started by ``torchrun`` (which sets RANK, WORLD_SIZE,
LOCAL_RANK and the rendezvous address): each rank takes its card,
``cuda:{LOCAL_RANK}``, or the one ``--device`` names.  Under torchrun
with more than one process and no ``--mesh`` every rank is on the data
axis, as the JAX CLI puts every device there.  ``--backend`` is ``nccl``
on the card and ``gloo`` with ``--device cpu`` by default; ranks that
share one card pass ``--device cuda:0 --backend gloo`` (NCCL takes one
rank per card):

    torchrun --standalone --nproc_per_node 2 -m btsbot_tpu_torch.cli.train \\
        cfg.json --mesh 2x1 --data-dir D --out-root M
"""

from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from ..core.config import load_config
from ..engine.train import run_training


def _mesh(spec: str | None, device: str | None, backend: str | None):
    """The mesh the flags ask for (None: no mesh); starts the process group
    unless one is running."""
    if spec is None and int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return None
    from ..parallel.mesh import initialize_distributed, make_mesh

    if backend is None:
        backend = "gloo" if device is not None and device.startswith("cpu") else "nccl"
    if not dist.is_initialized():
        initialize_distributed(backend=backend)
    if spec is None:
        return make_mesh()
    data, model = (int(x) for x in spec.lower().split("x"))
    return make_mesh(data=data, model=model)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Train a btsbot model with the "
                                            "PyTorch / CUDA port")
    p.add_argument("config", help="Path to flat-JSON train config")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--out-root", default="models")
    p.add_argument("--run-name", default="run")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in the model dir")
    p.add_argument("--no-figure", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; under a mesh "
                        "cuda:LOCAL_RANK)")
    p.add_argument("--mesh", default=None,
                   help="Mesh spec 'DATAxMODEL' (e.g. 4x2) over torchrun's ranks; "
                        "default under torchrun: every rank on the data axis")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="process-group backend under a mesh (default: nccl, "
                        "gloo with --device cpu)")
    args = p.parse_args(argv)

    started = not dist.is_initialized()
    mesh = _mesh(args.mesh, args.device, args.backend)
    try:
        return run_training(
            load_config(args.config),
            data_dir=args.data_dir,
            out_root=args.out_root,
            run_name=args.run_name,
            resume=args.resume,
            make_figure=not args.no_figure,
            device=args.device,
            mesh=mesh,
        )
    finally:
        if mesh is not None and started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
