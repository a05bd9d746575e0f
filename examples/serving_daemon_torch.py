#!/usr/bin/env python3
"""Broker-consumer serving daemon with the PyTorch / CUDA port (counterpart
of examples/serving_daemon.py).

A long-running loop that consumes ZTF alert packets from a broker feed,
scores them in adaptively sized batches on the CUDA card (host decode
pipelined with the card's work) and emits (candid, score) results, with
backpressure when the feed outruns the card:

    python examples/serving_daemon_torch.py --model-dir models/..../run \\
        [--batch 3072] [--max-wait-ms 100] [--device cpu]

``--synthetic N`` streams N synthetic gzip+FITS packets through the real
decode path instead of connecting to a broker.  To consume a real feed,
replace the source with a Kafka iterator (``btsbot_tpu_torch.data.kafka``) or
any iterable of alert dicts (or a bounded ``queue.Queue``).  Without
``--model-dir`` it serves the port's shipped example model.  The same loop
as a process with more sources: ``python -m btsbot_tpu_torch.cli.serve``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--model-dir", default=None,
                   help="Trained model dir (a run of the port or of the reference "
                        "trainer, or an HF snapshot); omit for the shipped example "
                        "model")
    p.add_argument("--batch", type=int, default=3072)
    p.add_argument("--max-wait-ms", type=float, default=100.0)
    p.add_argument("--synthetic", type=int, default=10_000,
                   help="Stream N synthetic packets instead of a broker")
    p.add_argument("--out", default=None,
                   help="JSONL results file (default: the summary line only)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="Build and load the CUDA kernel library in DIR: a restart "
                        "loads it instead of compiling (utils/compile_cache.py)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    if args.compile_cache:
        from btsbot_tpu_torch.utils.compile_cache import enable
        enable(args.compile_cache)

    from btsbot_tpu_torch import AlertStreamConsumer, AlertStreamScorer
    from btsbot_tpu_torch.data.synthetic import synthetic_packets
    from btsbot_tpu_torch.engine.checkpoint import load_run_dir

    model_dir = args.model_dir or os.path.join(ROOT, "btsbot_tpu_torch", "example_data")
    config, weights = load_run_dir(model_dir)
    scorer = AlertStreamScorer(config, weights, batch_size=args.batch, device=args.device)

    out_fh = open(args.out, "w") if args.out else None  # noqa: SIM115 — closed below

    def sink(packets, scores, drop):
        if out_fh is not None:
            for pkt, s, d in zip(packets, scores, drop):
                out_fh.write(json.dumps({"candid": pkt.get("candid"),
                                         "score": None if d else float(s)}) + "\n")

    source = synthetic_packets(args.synthetic, config["metadata_cols"])
    consumer = AlertStreamConsumer(scorer, source, sink, max_batch=args.batch,
                                   max_wait_s=args.max_wait_ms / 1e3)
    t0 = time.time()
    try:
        stats = consumer.run()
    finally:
        if out_fh is not None:
            out_fh.close()
    stats = {**stats, "total_wall_s": round(time.time() - t0, 2)}
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
