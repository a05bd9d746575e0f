"""Dataset-construction CLI (port of ``python -m btsbot_tpu.cli.dataset``):

    python -m btsbot_tpu_torch.cli.dataset build --version v12 \
        --sets trues dims vars rejects [--base-dir D] [--out-dir D]
    python -m btsbot_tpu_torch.cli.dataset subset --version v12 --split train \
        --n-max-p 100 [--sne-only] [--no-near-threshold] [--rise-only]
    python -m btsbot_tpu_torch.cli.dataset subsample --version v12 --split train \
        --percent 10
    python -m btsbot_tpu_torch.cli.dataset to-hf --version v12 --split train

The JAX CLI's subcommands and flags; the files are the same (numpy and the
candidate CSVs, written by ``data.dataset.write_candidates``).  Host only:
no step runs on the card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="Build training datasets")
    sub = p.add_subparsers(dest="cmd", required=True)

    pb = sub.add_parser("build", help="splits + merge + N-capped subsets")
    pb.add_argument("--version", required=True)
    pb.add_argument("--sets", nargs="+", default=["trues", "dims", "vars", "rejects"])
    pb.add_argument("--base-dir", default="data/base_data")
    pb.add_argument("--out-dir", default="data")
    pb.add_argument("--seed", type=int, default=2)
    pb.add_argument("--n-max-p", type=int, default=100)
    pb.add_argument("--n-max-n", type=int, default=100)

    ps = sub.add_parser("subset", help="extra N-capped/flag-cut subsets")
    ps.add_argument("--version", required=True)
    ps.add_argument("--split", required=True)
    ps.add_argument("--data-dir", default="data")
    ps.add_argument("--n-max-p", type=int, required=True)
    ps.add_argument("--n-max-n", type=int, default=0)
    ps.add_argument("--sne-only", action="store_true")
    ps.add_argument("--no-near-threshold", action="store_true")
    ps.add_argument("--rise-only", action="store_true")

    pp = sub.add_parser("subsample", help="object-level percentage subsets")
    pp.add_argument("--version", required=True)
    pp.add_argument("--split", required=True)
    pp.add_argument("--percent", type=float, required=True)
    pp.add_argument("--data-dir", default="data")
    pp.add_argument("--seed", type=int, default=2)

    ph = sub.add_parser("to-hf", help="export split as datasets.Dataset")
    ph.add_argument("--version", required=True)
    ph.add_argument("--split", required=True)
    ph.add_argument("--data-dir", default="data")
    ph.add_argument("--n-max", type=int, default=100)

    args = p.parse_args(argv)

    from ..data.dataset import read_candidates, write_candidates

    if args.cmd == "build":
        from ..data.splits import build_dataset_files
        build_dataset_files(args.base_dir, args.out_dir, args.sets, args.version,
                            seed=args.seed, N_max_p=args.n_max_p, N_max_n=args.n_max_n)
    elif args.cmd == "subset":
        from ..data.splits import create_subset
        trips = np.load(os.path.join(args.data_dir,
                                     f"{args.split}_triplets_{args.version}.npy"))
        cand = read_candidates(os.path.join(args.data_dir,
                                            f"{args.split}_cand_{args.version}.csv"))
        trips, cand, cuts = create_subset(
            trips, cand, args.split, N_max_p=args.n_max_p, N_max_n=args.n_max_n,
            sne_only=args.sne_only, keep_near_threshold=not args.no_near_threshold,
            rise_only=args.rise_only)
        np.save(os.path.join(args.data_dir,
                             f"{args.split}_triplets_{args.version}{cuts}.npy"), trips)
        write_candidates(cand, os.path.join(args.data_dir,
                                            f"{args.split}_cand_{args.version}{cuts}.csv"))
        print(f"Wrote {cuts} subset of {args.split}")
    elif args.cmd == "subsample":
        from ..data.splits import subsample_objects
        trips = np.load(os.path.join(args.data_dir,
                                     f"{args.split}_triplets_{args.version}_N100.npy"))
        cand = read_candidates(os.path.join(args.data_dir,
                                            f"{args.split}_cand_{args.version}_N100.csv"))
        trips, cand = subsample_objects(trips, cand, args.percent, seed=args.seed)
        tag = f"{args.version}s{int(args.percent)}"
        np.save(os.path.join(args.data_dir, f"{args.split}_triplets_{tag}_N100.npy"), trips)
        write_candidates(cand, os.path.join(args.data_dir,
                                            f"{args.split}_cand_{tag}_N100.csv"))
    elif args.cmd == "to-hf":
        from ..data.hf_dataset import convert_to_hf
        convert_to_hf(args.split, args.version, data_dir=args.data_dir, n_max=args.n_max)


if __name__ == "__main__":
    main()
