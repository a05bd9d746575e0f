"""Serving CLI: ``python -m btsbot_tpu_torch.cli.serve <model_dir> [opts]``.

The port of ``python -m btsbot_tpu.cli.serve``: the broker-consumer daemon
(``engine/serve.py::AlertStreamConsumer``) as a process, on the CUDA card
unless ``--device cpu`` is given.

Wire format (``--jsonl``): one alert packet per line as JSON with the
Kafka / Avro field layout the scorer consumes:
``{"candid": ..., "candidate": {<metadata cols>},
"cutoutScience|Template|Difference": {"stampData": "<base64 gzip FITS>"}}``.
Results stream to ``--out`` (or stdout) as
``{"candid": ..., "score": float|null, "dropped": bool}`` per alert;
``score`` is null where the alert was dropped as corrupt or undecodable.

``--synthetic N`` serves generated packets instead (smoke and throughput
runs); ``--avro FILE`` replays a ZTF Avro OCF archive, streamed block by
block with the dependency-free codec (``data/avro.py``).

The model directory is an HF-style snapshot (train_config.json +
pytorch_model.bin) or a training run of the port or of the reference
trainer (report.json or train_config.json + best_model.pth); see
``engine/checkpoint.py::load_run_dir``.  SIGTERM and SIGINT stop the
consumer after the work in flight is scored.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys


def _iter_jsonl_packets(path: str):
    """Yield packets from a JSONL file, decoding base64 stampData blobs."""
    stream = sys.stdin if path == "-" else open(path)  # noqa: SIM115
    with stream:
        for line in stream:
            line = line.strip()
            if not line:
                continue
            p = json.loads(line)
            for key in ("cutoutScience", "cutoutTemplate", "cutoutDifference"):
                cutout = p.get(key)
                blob = cutout.get("stampData") if isinstance(cutout, dict) else None
                if isinstance(blob, str):
                    p[key]["stampData"] = base64.b64decode(blob)
            yield p


def _temperature(arg: str, model_dir: str) -> float:
    """The calibration temperature: a number, or with 'auto' the one
    ``cli.val --calibrate`` wrote to the model dir's perf.json (1.0 with a
    notice when there is none)."""
    if arg != "auto":
        return float(arg)
    import os
    perf_path = os.path.join(model_dir, "perf.json")
    try:
        with open(perf_path) as f:
            temperature = float(json.load(f)["calibration"]["temperature"])
    except (OSError, KeyError, ValueError, TypeError):
        print(f"no calibration in {perf_path}; serving uncalibrated "
              "(run cli.val --calibrate first)", file=sys.stderr)
        return 1.0
    print(f"calibration temperature {temperature} from {perf_path}",
          file=sys.stderr)
    return temperature


def main(argv=None) -> dict:
    """Runs the daemon to the end of its source; returns its stats (also
    printed to stderr as one JSON line)."""
    p = argparse.ArgumentParser(
        description="Serve alert packets through the PyTorch / CUDA scoring daemon")
    p.add_argument("model_dir",
                   help="Model dir (report.json/train_config.json + "
                        "best_model.pth or pytorch_model.bin)")
    p.add_argument("--jsonl", default=None, metavar="FILE",
                   help="JSONL packet source ('-' for stdin); see module "
                        "docstring for the wire format")
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="Serve N synthetic packets instead of --jsonl")
    p.add_argument("--avro", default=None, metavar="FILE",
                   help="Serve alerts from a ZTF Avro OCF file (archival "
                        "replay; streamed block-by-block with the in-repo "
                        "codec — data/avro.py)")
    p.add_argument("--out", default=None,
                   help="JSONL results file (default stdout)")
    p.add_argument("--batch", type=int, default=3072)
    p.add_argument("--max-wait-ms", type=float, default=100.0)
    p.add_argument("--bf16-transfer", action="store_true",
                   help="Ship pixels host->device as bfloat16 (halves "
                        "ingest bytes)")
    p.add_argument("--temperature", default="1.0",
                   help="Calibration temperature fitted via "
                        "cli.val --calibrate; served scores become "
                        "calibrated probabilities. 'auto' reads "
                        "calibration.temperature from the model dir's "
                        "perf.json (falls back to 1.0 with a notice)")
    p.add_argument("--retarget-resolution", type=int, default=None,
                   metavar="RES",
                   help="MaxViT only: serve the trained model at this "
                        "native resolution instead of the one it was "
                        "trained at (rel-pos bias tables resampled)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="Build and load the CUDA kernel library in DIR, so a "
                        "restarted daemon loads it instead of compiling")
    p.add_argument("--stats-interval", type=float, default=0.0,
                   metavar="SECONDS",
                   help="Emit a JSON stats line to stderr at this interval")
    p.add_argument("--no-warmup", action="store_true",
                   help="Skip the first call at each bucket size before "
                        "consuming (the kernel build then lands on the first "
                        "batch)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    n_sources = sum(x is not None for x in (args.jsonl, args.synthetic, args.avro))
    if n_sources != 1:
        p.error("exactly one of --jsonl / --synthetic / --avro is required")

    if args.compile_cache:
        from ..utils.compile_cache import enable
        enable(args.compile_cache)

    import signal

    import torch

    from ..core.config import normalize_config
    from ..engine.checkpoint import load_run_dir
    from ..engine.serve import AlertStreamConsumer, AlertStreamScorer

    config, weights = load_run_dir(args.model_dir)
    if args.retarget_resolution is not None:
        from ..interop.maxvit_convert import retarget_model_kind, retarget_state_dict
        kind = retarget_model_kind(config.get("model_kind", ""),
                                   args.retarget_resolution)
        config = normalize_config({**config, "model_kind": kind})
        weights = retarget_state_dict(weights, kind)
        print(f"retargeted to {kind}", file=sys.stderr)
    temperature = _temperature(args.temperature, args.model_dir)
    scorer = AlertStreamScorer(
        config, weights, batch_size=args.batch,
        transfer_dtype=torch.bfloat16 if args.bf16_transfer else None,
        temperature=temperature, device=args.device)
    if not args.no_warmup:
        print(f"warming {len(scorer.bucket_sizes)} bucket sizes "
              f"{scorer.bucket_sizes}...", file=sys.stderr)
        scorer.warmup()

    avro_fh = None
    if args.synthetic is not None:
        from ..data.synthetic import synthetic_packets
        source = synthetic_packets(args.synthetic, config["metadata_cols"])
    elif args.avro is not None:
        from ..data.avro import iter_ocf_stream
        avro_fh = open(args.avro, "rb")  # noqa: SIM115 — closed in finally
        source = iter_ocf_stream(avro_fh)
    else:
        source = _iter_jsonl_packets(args.jsonl)

    out = sys.stdout if args.out is None else open(args.out, "w")  # noqa: SIM115

    def sink(packets, scores, drop):
        for pkt, s, d in zip(packets, scores, drop):
            out.write(json.dumps({
                "candid": pkt.get("candid"),
                "score": None if d else round(float(s), 6),
                "dropped": bool(d)}) + "\n")
        out.flush()

    consumer = AlertStreamConsumer(
        scorer, source, sink, max_wait_s=args.max_wait_ms / 1e3,
        stats_interval_s=args.stats_interval,
        stats_log=lambda line: print(line, file=sys.stderr))

    # daemon lifecycle: SIGTERM / SIGINT score the work in flight and stop
    def _shutdown(signum, frame):
        del frame
        print(json.dumps({"signal": signum, "action": "stopping"}), file=sys.stderr)
        consumer._stop.set()

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, _shutdown)
        except ValueError:  # not the main thread (e.g. under a test harness)
            pass

    try:
        stats = consumer.run()
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        if avro_fh is not None:
            avro_fh.close()
        if out is not sys.stdout:
            out.close()
    print(json.dumps(stats), file=sys.stderr)
    return stats


if __name__ == "__main__":
    main()
