"""Distillation CLI: ``python -m btsbot_tpu_torch.cli.distill <teacher_dir> [opts]``.

The port of ``python -m btsbot_tpu.cli.distill``: from a trained or
converted model directory (an HF snapshot with pytorch_model.bin, or a run
directory of the port or of the reference trainer) to a student of another
``model_kind``, trained on the data directory's splits with the teacher's
scores in its loss (``engine.distill``).  It runs on the CUDA card unless
``--device cpu``; the figure needs matplotlib (``--no-figure`` without it).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="Distill a trained model into a student of another kind")
    p.add_argument("teacher_dir", help="Teacher model dir (HF snapshot or training run)")
    p.add_argument("--student-kind", default="inceptionnext_pico.r2",
                   help="Student model_kind (default: inceptionnext_pico.r2; on an "
                        "NVIDIA H100 80GB HBM3 at 700 W it serves 415k alerts/s against "
                        "the convnext_pico teacher's 505k, bf16 at batch 3072)")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--out-root", default="models")
    p.add_argument("--run-name", default="distill")
    p.add_argument("--epochs", type=int, default=None,
                   help="Override the teacher config's epoch count")
    p.add_argument("--alpha", type=float, default=0.5,
                   help="Weight on the hard-label BCE term (rest goes to KD)")
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--no-figure", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from ..engine.distill import distill_to_student, load_teacher, student_config_from_teacher

    teacher, t_cfg = load_teacher(args.teacher_dir, device=args.device)
    overrides = {"distill_alpha": args.alpha, "distill_temperature": args.temperature}
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    student_config = student_config_from_teacher(t_cfg, args.student_kind, **overrides)

    result = distill_to_student(
        teacher=teacher,
        student_config=student_config,
        data_dir=args.data_dir,
        out_root=args.out_root,
        run_name=args.run_name,
        make_figure=not args.no_figure,
        device=args.device,
    )
    print(f"student model dir: {result['model_dir']}")
    return result


if __name__ == "__main__":
    main()
