"""Training CLI: ``python -m btsbot_tpu_torch.cli.train <config.json> [options]``.

The port of ``python -m btsbot_tpu.cli.train`` without ``--mesh`` (ROADMAP
Queue A item 9) and without the diagnostic figure.  It trains on the CUDA
card; ``--device cpu`` asks for the host.
"""

from __future__ import annotations

import argparse

from ..core.config import load_config
from ..engine.train import run_training


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Train a btsbot model with the "
                                            "PyTorch / CUDA port")
    p.add_argument("config", help="Path to flat-JSON train config")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--out-root", default="models")
    p.add_argument("--run-name", default="run")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in the model dir")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    return run_training(
        load_config(args.config),
        data_dir=args.data_dir,
        out_root=args.out_root,
        run_name=args.run_name,
        resume=args.resume,
        device=args.device,
    )


if __name__ == "__main__":
    main()
