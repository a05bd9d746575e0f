"""Publishing CLI: ``python -m btsbot_tpu_torch.cli.publish <model_dir>`` (port
of ``python -m btsbot_tpu.cli.publish``).

Prepares train_config.json + pytorch_model.bin from a run directory, writes
the model card, and uploads to the HuggingFace Hub.  ``--no-upload`` stops
after preparing the local artifacts, which ``interop.hf.load_model_dir``
then loads.  Host only: no step runs on the card.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Export a trained model dir for publishing")
    p.add_argument("model_dir", help="Run dir (report.json + best_model.pth)")
    p.add_argument("--no-upload", action="store_true",
                   help="Prepare pytorch_model.bin/train_config.json/README.md but skip "
                        "the Hub upload")
    args = p.parse_args(argv)

    from ..interop.publish import (
        config_to_params,
        create_model_card,
        prep_config,
        prep_model,
        upload_model_to_hf,
    )

    config = prep_config(args.model_dir)
    prep_model(args.model_dir, config)
    print(f"Exported pytorch_model.bin + train_config.json in {args.model_dir}")

    try:
        arch, multi_modal, pretrain = config_to_params(config)
    except (KeyError, ValueError):
        # the Hub naming scheme covers the convnext / maxvit / inceptionnext
        # families only; other models stop at the local export
        print("Model family has no HF repo naming; skipping model card and upload "
              "(local artifacts are ready for torch/ONNX use).")
        return
    create_model_card(args.model_dir, arch, multi_modal, pretrain)
    print(f"Wrote model card ({arch}, multi_modal={multi_modal}, pretrain={pretrain})")
    if not args.no_upload:
        link = upload_model_to_hf(args.model_dir)
        print(f"Uploaded to {link}")


if __name__ == "__main__":
    main()
