"""Data-acquisition CLI (port of ``python -m btsbot_tpu.cli.download``):

    python -m btsbot_tpu_torch.cli.download compile-ztfids [--base-dir D]
    python -m btsbot_tpu_torch.cli.download alerts <query_name> [--base-dir D]
        [--raw-cache DIR] [--no-cutouts] [--device cpu]
    python -m btsbot_tpu_torch.cli.download cutouts --survey PS|LS ...

Label policy per source list as in the reference (trues → 1;
dims/vars/rejects/junk/extra_* → 0; extIas → "compute").  The alerts'
ingest (NaN-clean, L2 norm, corrupt drop, crop) runs on the card unless
``--device cpu``.  Needs network and credentials (KOWALSKI_USER/PASS,
FRITZ_API_KEY, BTSSE_USER/PASS) and, for the queries, penquins / requests /
PIL, imported when used.
"""

from __future__ import annotations

import argparse
import os

LABEL_BY_QUERY = {
    "trues": 1,
    "dims": 0, "vars": 0, "rejects": 0, "junk": 0,
    "extra_agn": 0, "extra_cvs": 0,
    "extIas": "compute",
}


def main(argv=None):
    p = argparse.ArgumentParser(description="Acquire BTSbot training data")
    sub = p.add_subparsers(dest="cmd", required=True)

    pz = sub.add_parser("compile-ztfids", help="Build source lists (BTSSE/Fritz queries)")
    pz.add_argument("--base-dir", default="data/base_data")
    pz.add_argument("--overwrite", action="store_true")

    pa = sub.add_parser("alerts", help="Download alerts for a source list")
    pa.add_argument("query_name", choices=sorted(LABEL_BY_QUERY))
    pa.add_argument("--base-dir", default="data/base_data")
    pa.add_argument("--raw-cache", default=None,
                    help="Dir for per-object raw query caching")
    pa.add_argument("--no-cutouts", action="store_true")
    pa.add_argument("--cutout-size", type=int, default=63)
    pa.add_argument("--device", default=None,
                    help="torch device of the ingest (default: the CUDA card)")

    pc = sub.add_parser("cutouts", help="Archival color images (PanSTARRS/LegacySurvey)")
    pc.add_argument("--survey", required=True, choices=["PS", "LS"])
    pc.add_argument("--split", default="train", choices=["train", "val", "test", "all"])
    pc.add_argument("--version", default="v11")
    pc.add_argument("--workers", type=int, default=8)
    pc.add_argument("--data-dir", default="data")

    args = p.parse_args(argv)

    if args.cmd == "compile-ztfids":
        from ..data.query.ztfid import compile_ztfids
        compile_ztfids(args.base_dir, overwrite=args.overwrite)
    elif args.cmd == "alerts":
        from ..data.dataset import read_candidates
        from ..data.query.kowalski import download_training_data

        list_path = os.path.join(args.base_dir, f"{args.query_name}.csv")
        if not os.path.exists(list_path):
            from ..data.query.ztfid import compile_ztfids
            compile_ztfids(args.base_dir)
        download_training_data(
            read_candidates(list_path), args.query_name,
            label=LABEL_BY_QUERY[args.query_name], out_dir=args.base_dir,
            include_cutouts=not args.no_cutouts, cutout_size=args.cutout_size,
            save_raw=args.raw_cache, load_raw=args.raw_cache, verbose=True,
            device=args.device)
    elif args.cmd == "cutouts":
        from ..data.query.cutouts import process_dataset
        process_dataset(args.survey, args.split, args.version, args.workers,
                        data_dir=args.data_dir)


if __name__ == "__main__":
    main()
