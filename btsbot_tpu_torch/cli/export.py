"""Deployment-export CLI: ``python -m btsbot_tpu_torch.cli.export <model_dir>``
(port of ``python -m btsbot_tpu.cli.export``).

``<model_dir>`` is a run directory of the port or of the reference trainer
(``report.json`` + ``best_model.pth``) or an HF-style snapshot
(``train_config.json`` + ``pytorch_model.bin``).  Formats:

* ``onnx`` (default) — a .onnx file emitted from the run's reference-named
  state dict (``interop.onnx_export``), dynamic batch axis, inputs
  ``image`` / ``metadata``, output ``logits``: the reference's broker
  contract; verified by the numpy evaluator against the port's float32
  forward on ``--device`` (default the card, TF32 off) at rtol 1e-4 / atol
  1e-5 on the JAX CLI's synthetic inputs (16 alerts, seed 0), the report
  printed and written next to the artifact as ``<name>.verification.json``;
  a failed verification exits non-zero;
* ``saved_model`` — a TF SavedModel directory (``interop.savedmodel``:
  ``saved_model.pb`` + an empty ``variables/``, tag ``serve``, signature
  ``serving_default`` with inputs ``image`` (NHWC) / ``metadata`` and output
  ``logits``, dynamic batch axis), written with no TensorFlow; verified like
  the ONNX file (the numpy evaluator, and TensorFlow's loaded signature where
  installed), the report in ``<dir>/verification.json``;
* ``torch`` — the reference-named ``pytorch_model.bin``, loadable by the
  original btsbot package and by ``interop.hf.load_model_dir``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _verification_inputs(config, n: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    triplets = metadata = None
    if config.need_triplets:
        s = int(config.get("image_size", 63))
        triplets = rng.normal(size=(n, s, s, 3)).astype(np.float32)
    if config.need_metadata:
        metadata = rng.normal(size=(n, len(config["metadata_cols"]))).astype(np.float32)
    return triplets, metadata


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export a trained model dir as a deployment artifact")
    p.add_argument("model_dir", help="Run dir (report.json + best_model.pth) or snapshot")
    p.add_argument("--output", default=None,
                   help="Artifact path (default <model_dir>/model.onnx, "
                        "<model_dir>/saved_model or <model_dir>/pytorch_model.bin)")
    p.add_argument("--format", default="onnx", choices=["onnx", "saved_model", "torch"])
    p.add_argument("--no-verify", action="store_true",
                   help="Skip the cross-runtime verification pass")
    p.add_argument("--retarget-resolution", type=int, default=None, metavar="RES",
                   help="MaxViT only: export the artifact at this native resolution "
                        "instead of the trained one (rel-pos bias tables resampled)")
    p.add_argument("--device", default=None,
                   help="torch device of the verification forward (default: the CUDA card)")
    args = p.parse_args(argv)

    import torch

    from ..core.config import normalize_config
    from ..engine.checkpoint import load_run_dir

    config, sd = load_run_dir(args.model_dir)
    if args.retarget_resolution is not None:
        from ..interop.maxvit_convert import retarget_model_kind, retarget_state_dict
        kind = retarget_model_kind(config.get("model_kind", ""), args.retarget_resolution)
        sd = retarget_state_dict(sd, kind)
        config = normalize_config({**config, "model_kind": kind})
        print(f"retargeted to {kind}")

    report = None
    if args.format == "onnx":
        from ..interop.onnx_export import export_onnx, verify_onnx
        out = args.output or os.path.join(args.model_dir, "model.onnx")
        export_onnx(config, sd, out)
        if not args.no_verify:
            triplets, metadata = _verification_inputs(config)
            report = verify_onnx(out, config, sd, triplets, metadata, device=args.device,
                                 report_path=f"{os.path.splitext(out)[0]}.verification.json")
    elif args.format == "saved_model":
        from ..interop.savedmodel import export_saved_model, verify_saved_model
        out = args.output or os.path.join(args.model_dir, "saved_model")
        export_saved_model(config, sd, out)
        if not args.no_verify:
            triplets, metadata = _verification_inputs(config)
            report = verify_saved_model(out, config, sd, triplets, metadata, device=args.device,
                                        report_path=os.path.join(out, "verification.json"))
    else:
        out = args.output or os.path.join(args.model_dir, "pytorch_model.bin")
        torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()}, out)

    print(f"Exported {args.format} artifact: {out}")
    if report is not None:
        print(json.dumps(report))
        # the in-repo evaluator, and TensorFlow where it ran
        failed = [k for k in ("close", "tensorflow_close") if report.get(k) is False]
        if failed:
            raise SystemExit(f"Verification FAILED ({', '.join(failed)}): max_diff "
                             f"{report['max_diff']:.3e}, rtol {report['rtol']} / atol "
                             f"{report['atol']}")
        print(f"Verified vs the port's f32 forward ({report['reference']}): max|diff| = "
              f"{report['max_diff']:.3e} (rtol {report['rtol']}, atol {report['atol']})")
    return out


if __name__ == "__main__":
    main()
