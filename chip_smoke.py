#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``btsbot_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``btsbot_tpu_torch/csrc`` into
``build/kernels/`` and drives the flagship serving path (mm_ConvNeXt,
convnext_pico, 63×63×3 triplets + 25 metadata features) on the card:

1. setup: the card's name and power limit, the kernel build (ptxas'
   registers and spills), a ``cuobjdump -sass`` check that every bfloat16
   kernel and every float32 kernel (``csrc/tf32x3.cu``, three TF32 products
   on the tensor cores) holds ``HGMMA`` (tensor-core) instructions, ptxas'
   warnings, TF32 off for the plain versions;
2. each kernel against its plain PyTorch version at the four pico stage
   shapes at batch 3072, in float32 (rtol 1e-4 / atol 1e-5: summation order)
   and bfloat16 (rtol = atol = 3e-2: two bf16 roundings), with CUDA-event
   times of both and the bound of the work on an H100 (float32: both
   bounds, exact float32 at 67 TFLOP/s and three TF32 products at 495 / 3,
   and in the printed line the first version's recorded time),
   ``fused_ln_mlp``
   also at hidden 2C (the ``inceptionnext_*.r2`` blocks); then ragged sizes
   (batch 7, batch 1, and sizes one row short of and one row past a tile
   edge, the tile's height asked of the built library), and maps too wide
   for the block kernel to keep its input tile in shared memory;
3. the main path: ``AlertScorer`` (bf16 and f32, batch 3072) on 2×3072+500
   alerts and on the port's example alerts (``btsbot_tpu_torch/example_data``),
   and ``AlertStreamScorer`` on 2×3072 synthetic packets; 12 block-kernel
   launches per batch, every float32 one
   on the "tf32x3" kernels; f32 scores within
   1e-5 of the plain model on the card, bf16 within 0.01 of f32, stream
   drop masks identical to the array path's;
4. ``fast_mm_convnext_logits``: 12 ``fused_ln_mlp`` launches, logits within
   rtol 1e-4 of the module's f32 logits;
5. the bf16 forward at batch 3072 split with CUDA events into its 12
   block-kernel launches and everything else (information only);
6. training: a synthetic split in the reference's file layout (4,096 train
   and 1,024 val alerts); one float32 train step through the kernel against
   one through the plain blocks (loss rtol 1e-6, every gradient within
   1e-4 of its largest entry, 12 launches); ``cli.train`` for 2 epochs at
   batch 64, then resumed for a third, with 12 block-kernel launches per
   train step and per eval batch, finite losses, the JAX package's
   ``report.json`` keys, and ``best_model.pth`` scoring the val split
   within 1e-6 of the trainer's best epoch; one bfloat16 step's loss within
   1e-2 of float32's; steps/s at batch 64 and 1,024 in both types, one
   step split into its 12 block launches, the recompute backward and the
   optimizer, and a ``torch.profiler`` table of kernel time by name with the
   device's busy share (information only);
7. the other families at full width: the production ``mm_cnn`` (its
   configuration read from ``btsbot_tpu_torch/train_configs/prod_config.json``),
   ``um_cnn`` and ``um_nn`` at its widths, the image-only ``ConvNeXt``-pico
   and ``frozen_fusion`` over a ConvNeXt-pico and a um_nn branch:
   ``AlertScorer`` in bf16 and f32 at batch 3072 on 3,572 alerts (12
   block-kernel launches a batch for ConvNeXt and the fusion, 0 for the
   rest; f32 within 1e-5 of the plain model for those two, within rtol 1e-4
   / atol 1e-5 of the host's f32 scores on 256 alerts for the conv and MLP
   families; bf16 within 0.01 of f32), ``AlertStreamScorer`` for mm_cnn and
   um_nn (drop masks identical to the array path's), the reference trainer's
   mm_cnn checkpoint (``tests/fixtures/ref_trained_mm_cnn``) against its
   recorded scores in f32, mm_cnn's forward split into its four convs and
   the rest beside their FLOP bound, ``cli.train`` for mm_cnn (2 epochs at
   batch 64) and its run exported with ``cli.export --format saved_model``
   (the TF SavedModel verified against the card's f32 forward on 16
   alerts), ConvNeXt-pico and um_nn (1 epoch each), then ``frozen_fusion``
   for 1 epoch from those two run directories with its branch parameters
   bit-identical afterwards; alerts/s and mm_cnn's train steps/s
   (information only);
8. MaxViT at ``maxvit_tiny_rw_224.sw_in1k`` full depth (the attention core
   in ``csrc/partition_attention.cu`` and the MLP halves in ``fused_ln_mlp``,
   22 launches of each a forward, the MBConvs' middles in
   ``csrc/mbconv_dw.cu``, 11; the rest cuBLAS / cuDNN; bias tables drawn
   at std 0.5): the attention kernel against its plain version at the four
   stage shapes at batch 3072 in both modes (bf16, and f32 at batch 256)
   with its time, the plain version's and the bound; the MBConv kernel
   against its plain version at the eight MBConv shapes (both types at the
   scorer's batches 768 and 192, bf16 at 3072) with its time at 3072 beside
   the plain version's, cuDNN's depthwise conv's and the bound; ``mm_MaxViT``
   (metadata 128/128, combined 64/32) and the image-only ``MaxViT`` (256/32
   head): f32 logits and pooled features on the card within rtol 1e-4 /
   atol 1e-5 of the host's on 16 alerts; ``AlertScorer`` in bf16 at batch
   1,024 and f32 at 512 on 2,148 alerts (bf16 within 0.01 of f32) with
   alerts/s and peak memory; ``AlertStreamScorer`` on 1,024 packets (drop
   masks identical to the array path's); the bf16 forward split with CUDA
   events into stem, MBConvs, attention (qkv, the kernel, proj), MLP halves
   (LN1, the residual, ``fused_ln_mlp``) and the rest beside each part's
   FLOP bound (counted on a host copy: the kernels are no PyTorch
   operators); one f32 train step on the card against the host on 8
   alerts (loss rtol 1e-4, running statistics 1e-5); ``cli.train`` for
   mm_MaxViT, MaxViT and um_nn (1 epoch at batch 32 on 512 + 256 alerts),
   train steps/s, then ``frozen_fusion`` over the MaxViT and um_nn runs with
   its branch parameters bit-identical afterwards; the 224 ``best_model.pth``
   loaded into ``maxvit_tiny_rw_160`` (bias tables resampled) scoring finite;
9. InceptionNeXt: mm_ConvNeXt with ``inceptionnext_pico`` and
   ``inceptionnext_pico.r2`` under both scorers at batch 3072 (12
   ``fused_ln_mlp`` launches a batch, f32 within 1e-5 of the plain model,
   bf16 within 0.01 of f32), the kernel's share of the bf16 forward, and
   ``cli.train`` for ``.r2`` (1 epoch at batch 64, 12 launches a train step
   and an eval batch);
10. widths: both kernels against their plain versions at the four stage
    shapes of convnext atto, femto, nano, tiny, small and base at batch 256
    (f32 rtol 1e-4 / atol 1e-5, bf16 3e-2; ``fused_ln_mlp`` at hidden 4C,
    2C and 3C; a ragged batch and row count), and at nano's at batch 3072
    (hidden 4C) with times, the plain version's and the bound: C = 64 /
    128 / 256 / 512 in the tuned kernels and every other width in the padded
    tensor-core kernels ("wgmma_any") in bf16, every width in f32 in
    ``csrc/tf32x3.cu`` ("tf32x3"); both types at ``ODD_SHAPES``
    (C = 640 at 7x7, 520, 1000, maps too wide for the input tile, 64 rows
    at C = 768 and one at 1024); one f32
    forward of mm_ConvNeXt at each size at batch 64 against the plain
    model (scores 1e-5, logits rtol 1e-4 / atol 1e-5; launches = the sum of
    the depths), a train step kernel vs plain at atto and base (loss rtol
    1e-6, gradients 1e-4 of their largest entry), and
    ``inceptionnext_atto`` / ``inceptionnext_base`` forwards;
11. nano: mm_ConvNeXt from a config without ``model_kind`` (the JAX
    package's default ``convnext_nano.d1h_in1k``, 80 / 160 / 320 / 640)
    under both scorers at batch 3072 on 3,572 alerts: 14 block launches a
    batch, f32 within 1e-5 of the plain model, bf16 within 0.01 of f32,
    alerts/s on device-resident inputs, and the bf16 forward split into its
    14 block launches and everything else;
12. daemon: ``cli.serve`` in-process on phase 6's flagship run at batch
    3072: ``--synthetic 20000`` (every candid once, 12 block launches a
    batch, alerts/s and latency p50 / p99), ``--avro`` over an 8,192-packet
    ``synthetic_avro_ocf`` archive with 9 corrupt stamps with and without
    ``--bf16-transfer`` (drop flags equal ``AlertStreamScorer``'s own mask,
    bf16 transfer within 0.01 of f32), a bursty trickle (2,000 alerts
    every second for 5 s, max wait 100 ms) whose p99 latency stays under
    the gap between bursts (the idle drain), ``stop()`` mid-stream;
13. val: ``cli.val --calibrate`` on that run's val split writes
    ``perf.json`` with the JAX CLI's keys; ``cli.serve --temperature auto``
    reports its temperature and serves ``calibrate_scores`` of the T = 1
    scores within 1e-3;
14. distill: ``cli.distill --student-kind inceptionnext_pico.r2 --epochs 1
    --no-figure`` on phase 6's flagship run at batch 64 (12 block launches,
    the teacher's forward only, and 12 ``fused_ln_mlp`` launches a distill
    step; 0 and 12 an eval batch; finite losses, the JAX package's
    ``report.json`` keys, the student's ``best_model.pth`` scoring the val
    split within 1e-6 of the trainer's best epoch, the teacher's tensors
    bit-identical afterwards); one f32 distill step through both kernels
    against both models plain (loss rtol 1e-6, gradients 1e-4 of their
    largest entry); the teacher's in-step logits on an unaugmented batch
    within 1e-5 of ``AlertScorer``'s f32 model (eval mode); ``cli.train``
    for 1 epoch from a ``backbone_checkpoint`` written from the flagship's
    backbone (equal before the first step) with ``generate_embeddings``
    (``embeddings.csv``, 1,024 rows); ``run_training`` with a JSONL logger
    (a line an epoch); ``extract_features`` on the card within 1e-5 of the
    plain model (f32); distill steps/s at batch 64 f32 and at 1,024 with the
    student in bf16 (teacher f32, then bf16), one step split into the
    teacher's forward, AdamW and the rest (information only);
15. lifecycle, the dataset-to-deployment path at the flagship's full
    width: four source sets (trues, dims, vars, rejects; 400 objects, about
    3,200 alerts, every 150th with an all-NaN science stamp) through
    ``download_training_data`` with a client that replays the packets (the
    ingest on the card: corrupt alerts dropped, unit-norm float64
    triplets), ``cli.dataset build``, ``cli.train --epochs 1 --no-figure``
    at batch 64 on the built split (12 block launches a step and an eval
    batch), ``cli.export`` (ONNX verified on the card's f32 forward with
    TF32 off, ``close: true``, 12 block launches; then the same artifact at
    256 alerts; then ``--format saved_model``, the TF SavedModel verified
    the same way at 16 alerts by its numpy evaluator (12 block launches),
    and the unchanged artifact refused against the weights with
    ``combined_head.5.bias`` + 0.05; then ``--format torch``, whose
    ``pytorch_model.bin`` loads
    ``strict=True`` and scores the val split within 1e-6 of the run's best
    epoch), ``cli.publish --no-upload`` and ``load_model_dir`` (the same
    scores), an ``inceptionnext_pico`` mm_ConvNeXt exported and verified
    through 12 ``fused_ln_mlp`` launches, and ``center_crop`` /
    ``crop_triplets`` / ``nan_row_mask`` on the card against numpy; each
    CLI's seconds, the ONNX file's and the SavedModel's sizes, the ONNX
    numpy evaluator's alerts/s against the card's f32 forward on the same
    256 alerts and the SavedModel evaluator's seconds for 16 (information
    only);
16. int8, the quantized path (``ops/quantized.py``): the int8 block kernel
    (``csrc/int8_block.cu``, one launch a block) with its ptxas lines and
    ``IGMMA`` (int8 tensor-core) instructions in each of its 22 kernels, at
    pico's and nano's stage shapes at batch 3072 and at atto's C = 40 and
    base's C = 1024 at batch 256 in bf16 and f32: its q_h within one int8
    step of the plain version's from the same x, its q_g within one step of
    the plain version's fed the kernel's q_h, its output bit for bit equal
    to the plain tail fed the kernel's q_g, with its time, PR 11's eager
    block's, the plain version's and the bound (bytes at 3.35 TB/s against
    int8 operations at 1,979 TOP/s); the depthwise kernel
    (``csrc/int8_dwconv.cu``, the calibration's) against its plain version
    at every stage shape of pico and nano at batch 3072 in bf16 and f32,
    bit for bit (max|d| = 0), with its time, the plain version's, cuDNN's
    float32 depthwise conv over the integer-valued quantized tensor (the
    same accumulators) and the bound (bytes at 3.35 TB/s, or 49
    multiply-adds an output at the FP32 pipe's rate from the card's SM
    count and top clock); then the flagship and mm_ConvNeXt-nano on the
    main path's weights, calibrated on 512 unit-norm triplets (12 / 14
    depthwise launches) and scored on 3072 others: 12 / 14 counted block
    launches a forward and no depthwise launch, finite logits, every score
    within 0.015 of the port's bf16 model (``verify_quantized_parity``), the
    card's float32 forward replayed on the host teacher-forced (each
    block's input, q_h, q_g and output traced; the doubled-scale mutant
    refused), int8 alerts/s and the forward split into the block launches,
    the stem's and downsamples' int8 GEMMs, quantize and dequantize passes,
    and the rest;
17. examples: ``examples/inference_example_torch.py --local`` (the shipped
    example model's f32 scores, TF32 off, within 1e-5 of its golden scores
    in ``btsbot_tpu_torch/example_data``), ``serving_daemon_torch.py
    --synthetic 2000`` (every packet scored) and ``train_quickstart_torch.py
    --epochs 1 --n 512`` (a ``best_model.pth``, finite val scores), each in
    this process;
18. mesh (``btsbot_tpu_torch.parallel``): ``run_training(mesh=make_mesh())``
    at world size 1 under NCCL, 1 epoch at batch 64 on phase 6's split
    (cuDNN deterministic): 12 block launches a train step and an eval batch,
    its ``best_model.pth`` scoring the val split within 1e-6 of the same run
    without a mesh; then two ranks sharing the card over gloo (CUDA tensors,
    ``parallel.dryrun.spawn`` running ``mesh_rank``) at meshes 2x1 and 1x2:
    one f32 step (TF32 off) of the flagship and of
    mm_InceptionNeXt-pico.r2 at global batch 64 against the one-process
    step on the card (loss rtol 1e-5, the all-reduced gradients within 1e-4
    of their largest entry, the head's output weight rtol 1e-5 / atol 1e-7,
    12 block or ``fused_ln_mlp`` launches on each rank), and the flagship's
    ``AlertScorer(mesh=)`` on 1,100 alerts at batch 512 (f32 within 1e-5 of
    the unsharded scorer, bf16 within 0.01 of f32, 12 launches a batch on
    each rank); the f32 step's time at 1x1 (NCCL and one process), 2x1 and
    1x2 with the gradient all-reduce's share (information only);
19. a ``{"kernels": [...]}`` line (launches by path and by variant and
    width, the source of each variant, a pico and a nano forward's
    launches against their bound; the float32 kernels of ``csrc/tf32x3.cu``
    as entries of their own: a pico f32 forward's 12 launches against both
    bounds; ``int8_block``: a pico int8 forward's 12 launches against their
    bound, PR 11's eager block and the plain version; ``int8_dwconv``: the
    same 12 shapes against their bound and cuDNN's, launched by the
    calibration; ``partition_attention`` and ``mbconv_dw``: a maxvit_tiny
    forward's 22 and 11 launches against their bound and the plain
    version, with the launches phase 8 counted), alerts/s for each scorer
    and the daemon, int8
    beside bf16 and f32 (information only), the per-width times in a table
    and in ``build/smoke_widths.json``;
20. the card's name and power limit, then as the last line
    ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero and prints no result.  So does a host
without CUDA, and a directory without the port beside this script.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH = 3072
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,  # dense bf16 tensor cores
            "float32": 67e12,    # float32 outside the tensor cores (no TF32)
            # the float32 kernels' products: three dense TF32 tensor-core
            # products for each (csrc/tf32x3.cu)
            "tf32x3": 495e12 / 3,
            "int8": 1979e12}     # dense int8 tensor cores (a multiply-add is 2 ops)
# The first version's float32 kernels (float FMAs on the CUDA cores) at the
# four pico stage shapes at batch 3072, ms a launch: recorded on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md, the kernel table's brackets), not
# measured here, so printed beside this run's times with that label and
# never put in the kernels line
FIRST_F32_MS = {"convnext_block_fused": (3.20, 2.28, 2.25, 1.39),
              "fused_ln_mlp": (1.76, 2.11, 2.09, 1.48),
              "fused_ln_mlp_r2": (1.01, 1.16, 1.07, 0.74)}
PICO_STAGES = [(15, 64, 2), (7, 128, 2), (3, 256, 6), (1, 512, 2)]  # side, C, depth
# maps whose input tile with its halo does not fit a block's shared memory:
# the bf16 block kernel reads x from device memory there (batch, side, C)
WIDE_MAPS = [(2, 56, 64), (1, 112, 128), (3, 14, 256), (5, 7, 512)]
TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# the padded widths the bf16 "wgmma_any" kernels are built for
# (csrc/hopper_mlp.cuh BTS_ANY_WIDTHS), and the bf16 kernels in the library:
# fused_ln_mlp and the block kernel with and without its input tile, at the
# 4 tuned widths and at these
WGMMA_WIDTHS = (64, 128, 192, 256, 320, 384, 448, 512, 640, 768, 1024)
BF16_KERNELS = 3 * (4 + len(WGMMA_WIDTHS))
# the float32 kernels (csrc/tf32x3.cu): both functions at 1-4 blocks of 32
# output columns a warpgroup, and with 128-row tiles (C <= 64)
F32_KERNELS = 2 * (4 + 1)
# MaxViT's kernels, which use no tensor-core instruction of wgmma's:
# csrc/partition_attention.cu at P = 1..8 (bf16 one or two heads a block,
# f32) and csrc/mbconv_dw.cu (bf16 and f32, stride 1 and 2)
MAXVIT_KERNELS = 3 * 8 + 2 * 2

META_COLS = [
    "sgscore1", "distpsnr1", "sgscore2", "distpsnr2", "fwhm", "magpsf",
    "sigmapsf", "chipsf", "ra", "dec", "diffmaglim", "ndethist", "nmtchps",
    "age", "days_since_peak", "days_to_peak", "peakmag_so_far", "new_drb",
    "ncovhist", "nnotdet", "chinr", "sharpnr", "scorr", "sky", "maxmag_so_far",
]
# the flagship configuration (the JAX package's FLAGSHIP_CONFIG)
FLAGSHIP_CONFIG = {
    "model_name": "mm_ConvNeXt",
    "model_kind": "convnext_pico.d1_in1k",
    "train_data_version": "v12",
    "metadata_cols": META_COLS,
    "meta_fc1_neurons": 128, "meta_fc2_neurons": 128, "meta_dropout": 0.25,
    "comb_fc1_neurons": 256, "comb_fc2_neurons": 32, "comb_dropout": 0.2,
    "learning_rate": 1e-4, "beta_1": 0.99, "beta_2": 0.99, "batch_size": 64,
    "epochs": 10, "warmup_epochs": 1, "patience": 5, "random_seed": 2,
}
EXAMPLE_DIR = os.path.join(ROOT, "btsbot_tpu_torch", "example_data")


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)
    print(f"  ok: {what}", flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------ phase 1 ------------------------------

def _short_kernel(mangled: str) -> str:
    """``ln_mlp_bf16_kernel<256>`` from the mangled name of an instantiation
    (``_ZN`` + length-prefixed names + ``I`` + integer template arguments)."""
    rest, name = mangled[3:], ""
    while (m := re.match(r"(\d+)", rest)):
        n = int(m.group(1))
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if not mangled.startswith("_ZN") or not args:
        return mangled
    return f"{name}<{','.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>"


def phase_setup(state: dict) -> None:
    import torch
    from btsbot_tpu_torch.ops import _build

    state["gpu"] = gpu_line()
    print(f"card: {state['gpu']}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    _launches()  # from here on every launch is counted (the kernels line's widths: the run's)
    info = _build.build_info
    state["ptxas"] = info.get("ptxas", "")  # a later build() call finds the library and clears it
    print(f"kernels built in {secs:.1f} s (compiled={info.get('compiled')}) "
          f"into {_build.BUILD_DIR}", flush=True)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", info.get("ptxas", ""))]
    if regs:
        print(f"  ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers",
              flush=True)
    # spills and ptxas' notes on lost performance (C7512: wgmma serialised for
    # want of registers), each with the kernels it names
    kernel, notes = "", {}
    for line in info.get("ptxas", "").splitlines():
        if "Compiling entry function" in line:
            kernel = _short_kernel(line.split("'")[1])
        elif "Performance Loss" in line:
            text, _, rest = line.split(": ", 1)[1].partition(" for the function ")
            notes.setdefault(text, []).append(_short_kernel(rest.strip(" '")))
        elif ("spill" in line and " 0 bytes spill stores" not in line) or "warning" in line:
            notes.setdefault(line.split(": ", 1)[-1].strip(), []).append(kernel)
    for text, kernels in notes.items():
        print(f"  ptxas: {text} [{', '.join(sorted(set(kernels)))}]", flush=True)
    # a build that lost the tensor-core path must not pass
    counts = _build.sass_opcode_counts("HGMMA")
    hgmma = {k: n for k, n in counts.items() if "bf16" in k and "partition_attention" not in k}
    print(f"  HGMMA instructions in the bf16 kernels: {sorted(hgmma.values())}", flush=True)
    check(len(hgmma) == BF16_KERNELS and min(hgmma.values()) > 0,
          f"all {BF16_KERNELS} bf16 kernels (fused_ln_mlp, the block kernel with and "
          f"without its input tile in shared memory, x 4 tuned + {len(WGMMA_WIDTHS)} padded "
          f"widths) hold HGMMA instructions")
    f32 = {k: n for k, n in counts.items() if "tf32x3_kernel" in k}
    print(f"  HGMMA instructions in the float32 kernels: {sorted(f32.values())}", flush=True)
    int8 = [k for k in counts if "int8_dwconv_kernel" in k]
    int8_block = [k for k in counts if "int8_block_kernel" in k]
    check(len(f32) == F32_KERNELS and min(f32.values()) > 0 and len(int8) == INT8_KERNELS
          and len(int8_block) == INT8_BLOCK_KERNELS
          and len(counts) == BF16_KERNELS + F32_KERNELS + INT8_KERNELS + INT8_BLOCK_KERNELS
          + MAXVIT_KERNELS + 2,
          f"all {F32_KERNELS} float32 kernels (fused_ln_mlp and the block kernel, x 1-4 "
          f"blocks of 32 output columns a warpgroup and the 128-row tile) hold HGMMA "
          f"instructions, and the library holds no other kernel but the weight split, "
          f"the split-sum pass, the int8 depthwise kernel in both types, the "
          f"{INT8_BLOCK_KERNELS} int8 block kernels and MaxViT's {MAXVIT_KERNELS}")


# ------------------------------ phase 2 ------------------------------

def _block_inputs(side: int, c: int, dtype, seed: int, batch: int = BATCH,
                  ratio: int = 4):
    """Block input and parameters (MLP hidden width ratio·C) at the scale of
    torch's default init, with γ and the LN affine randomised."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def u(shape, bound):
        return (torch.rand(shape, generator=g, device=DEVICE) * 2 - 1) * bound

    def n(shape, std):
        return torch.randn(shape, generator=g, device=DEVICE) * std

    hid = ratio * c
    x = n((batch, side, side, c), 1.0)
    params = [u((c, 1, 7, 7), 1 / 7), u((c,), 1 / 7), 1 + n((c,), 0.1), n((c,), 0.1),
              u((hid, c), c ** -0.5), u((hid,), c ** -0.5),
              u((c, hid), hid ** -0.5), u((c,), hid ** -0.5), n((c,), 0.5)]
    return x.to(dtype), [p.to(dtype) for p in params]


def _bound(bytes_moved: float, ops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bound3(bytes_moved: float, mlp_ops: float, tap_ops: float) -> tuple[float, str]:
    """The bound of a float32 launch as the "tf32x3" kernels do the work:
    the products at three TF32 tensor-core products each (495 / 3 TFLOP/s),
    the taps at 67 TFLOP/s, against the bytes at 3.35 TB/s."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (mlp_ops / PEAK_OPS["tf32x3"] + tap_ops / PEAK_OPS["float32"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed_row(dname: str, work: tuple, **fields) -> dict:
    """A timed launch's record: ``fields`` with the bound of ``work`` (bytes,
    the products' operations, the taps') at the type's rate, and for
    float32 the three-TF32-product bound beside it (``bound3_ms``); the
    first version's recorded time (``first_ms``, not measured in this run)
    is kept for float32 only, for the printed line."""
    bytes_moved, mlp_ops, tap_ops = work
    row = dict(fields, dtype=dname)
    row["bound_ms"], row["bound_by"] = _bound(bytes_moved, mlp_ops + tap_ops, dname)
    if dname == "float32":
        row["bound3_ms"], row["bound3_by"] = _bound3(bytes_moved, mlp_ops, tap_ops)
    else:
        row.pop("first_ms", None)
    return row


def _f32_note(r: dict) -> str:
    """A float32 row's second bound and the first version's recorded time."""
    if r["dtype"] != "float32":
        return ""
    ms = r.get("first_ms")
    first = (f", first version {ms:.2f} ms (recorded, PR 1; not measured here)"
             if ms is not None else ", first version: none recorded at this shape")
    return f", bound 3xTF32 {r['bound3_ms']:.4f} ms ({r['bound3_by']}){first}"


def _ragged_batches(side: int, tm: int) -> list[int]:
    """Batch 1, and the smallest batches whose B * side^2 rows end one row
    short of and one row past an edge of a tile of tm rows."""
    hw = side * side
    return [1] + [next(b for b in range(2, 4 * tm) if (b * hw) % tm == want)
                  for want in (tm - 1, 1)]


def phase_kernels(state: dict) -> None:
    import torch
    from btsbot_tpu_torch.ops import _build
    from btsbot_tpu_torch.ops.convnext_block import (
        convnext_block_fused, convnext_block_reference, depthwise_conv7_reference)
    from btsbot_tpu_torch.ops.ln_mlp import fused_ln_mlp, ln_mlp_reference

    lib = _build.library()
    results = {"convnext_block_fused": [], "fused_ln_mlp": [], "fused_ln_mlp_r2": []}
    # the stage shapes keep their input tile in shared memory; wider maps
    # do not, and the block kernel reads x from device memory
    check(all(lib.btsbot_block_tiles_input(c, side, side) == 1
              for side, c, _ in PICO_STAGES)
          and all(lib.btsbot_block_tiles_input(c, side, side) == 0
                  for _, side, c in WIDE_MAPS),
          f"input tile in shared memory at the stage shapes, not at {WIDE_MAPS}")
    f32_tiles = {(side, c): lib.btsbot_tf32x3_tiles_input(c, side, side)
                 for side, c in [(s_, c_) for s_, c_, _ in PICO_STAGES]
                 + [(s_, c_) for _, s_, c_ in WIDE_MAPS]}
    print(f"  float32 block kernel keeps its input tile in shared memory at (side, C): "
          f"{[k for k, v in f32_tiles.items() if v == 1]}, reads x through L2 at "
          f"{[k for k, v in f32_tiles.items() if v == 0]}", flush=True)
    check(all(v in (0, 1) for v in f32_tiles.values())
          and all(f32_tiles[(side, c)] == 1 for side, c, _ in PICO_STAGES[:2]),
          "the float32 block kernel takes every map, its input tile in shared memory at "
          "the first two stage shapes")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for stage, (side, c, depth) in enumerate(PICO_STAGES):
            x, p = _block_inputs(side, c, dtype, seed=c)
            m = BATCH * side * side
            item = x.element_size()
            w_bytes = sum(t.numel() for t in p) * item
            mlp_ops = 2 * 2 * m * c * 4 * c            # two products
            with torch.inference_mode():
                # the whole block
                got = convnext_block_fused(x, *p)
                want = convnext_block_reference(x, *p)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = torch.allclose(got.float(), want.float(), **TOL[dname])
                ms = time_ms(lambda: convnext_block_fused(x, *p))
                plain_ms = time_ms(lambda: convnext_block_reference(x, *p))
                work = (2 * m * c * item + w_bytes, mlp_ops, 2 * 49 * m * c)
                row = _timed_row(dname, work, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 shape=[BATCH, side, side, c], depth=depth,
                                 first_ms=FIRST_F32_MS["convnext_block_fused"][stage])
                results["convnext_block_fused"].append(row)
                print(f"  convnext_block_fused {dname} ({BATCH},{side},{side},{c}): "
                      f"max|d|={err:.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
                      f"{_f32_note(row)}", flush=True)
                check(ok, f"convnext_block_fused matches its plain version "
                          f"({dname}, C={c})")

                # the LN -> MLP half on the same block's conv output
                h = depthwise_conv7_reference(x, p[0], p[1]).reshape(-1, c)
                res = x.reshape(-1, c)
                q = p[2:]
                got = fused_ln_mlp(h, res, *q)
                want = ln_mlp_reference(h, res, *q)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = torch.allclose(got.float(), want.float(), **TOL[dname])
                ms = time_ms(lambda: fused_ln_mlp(h, res, *q))
                plain_ms = time_ms(lambda: ln_mlp_reference(h, res, *q))
                row = _timed_row(dname, (3 * m * c * item + sum(t.numel() for t in q) * item,
                                         mlp_ops, 0), max_abs_err=err, ms=ms,
                                 plain_ms=plain_ms, shape=[m, c], depth=depth,
                                 first_ms=FIRST_F32_MS["fused_ln_mlp"][stage])
                results["fused_ln_mlp"].append(row)
                print(f"  fused_ln_mlp {dname} ({m},{c}): max|d|={err:.3g} "
                      f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
                      f"{_f32_note(row)}", flush=True)
                check(ok, f"fused_ln_mlp matches its plain version ({dname}, C={c})")

                # hidden 2C: the LN -> MLP half of an inceptionnext_*.r2 block
                q2 = _block_inputs(side, c, dtype, seed=c + 1, batch=1, ratio=2)[1][2:]
                got = fused_ln_mlp(h, res, *q2)
                want = ln_mlp_reference(h, res, *q2)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = torch.allclose(got.float(), want.float(), **TOL[dname])
                ms = time_ms(lambda: fused_ln_mlp(h, res, *q2))
                plain_ms = time_ms(lambda: ln_mlp_reference(h, res, *q2))
                row = _timed_row(dname, (3 * m * c * item + sum(t.numel() for t in q2) * item,
                                         mlp_ops / 2, 0), max_abs_err=err, ms=ms,
                                 plain_ms=plain_ms, shape=[m, c], depth=depth,
                                 first_ms=FIRST_F32_MS["fused_ln_mlp_r2"][stage])
                results["fused_ln_mlp_r2"].append(row)
                print(f"  fused_ln_mlp hidden 2C {dname} ({m},{c}): max|d|={err:.3g} "
                      f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
                      f"{_f32_note(row)}", flush=True)
                check(ok, f"fused_ln_mlp at hidden 2C matches its plain version "
                          f"({dname}, C={c})")

                # a partial batch: rows past the last full tile are masked
                xr, mr = x[:7].contiguous(), 7 * side * side + 5
                ok = torch.allclose(convnext_block_fused(xr, *p).float(),
                                    convnext_block_reference(xr, *p).float(), **TOL[dname])
                ok &= torch.allclose(fused_ln_mlp(h[:mr], res[:mr], *q).float(),
                                     ln_mlp_reference(h[:mr], res[:mr], *q).float(),
                                     **TOL[dname])
                check(ok, f"both kernels match at a ragged size ({dname}, C={c}, "
                          f"B=7, M={mr})")
                tm = (lib.btsbot_tf32x3_rows(c) if dtype == torch.float32
                      else lib.btsbot_tile_rows(c))
                batches = _ragged_batches(side, tm)
                rows = [1, 3 * tm - 1, 3 * tm + 1]
                ok = True
                for b in batches:
                    xr = x[:b].contiguous()
                    ok &= torch.allclose(convnext_block_fused(xr, *p).float(),
                                         convnext_block_reference(xr, *p).float(),
                                         **TOL[dname])
                for mr in rows:
                    ok &= torch.allclose(fused_ln_mlp(h[:mr], res[:mr], *q).float(),
                                         ln_mlp_reference(h[:mr], res[:mr], *q).float(),
                                         **TOL[dname])
                torch.cuda.synchronize()
                check(tm > 0 and ok,
                      f"both kernels match at the edges of a tile of {tm} rows ({dname}, "
                      f"C={c}, block B={batches}, M={[b * side * side for b in batches]}; "
                      f"ln_mlp M={rows})")
            del x, p, h, res, got, want
            torch.cuda.empty_cache()
        for b, side, c in WIDE_MAPS:
            x, p = _block_inputs(side, c, dtype, seed=side + c, batch=b)
            with torch.inference_mode():
                got = convnext_block_fused(x, *p)
                want = convnext_block_reference(x, *p)
                ms = time_ms(lambda: convnext_block_fused(x, *p))
                plain_ms = time_ms(lambda: convnext_block_reference(x, *p))
            err = (got.float() - want.float()).abs().max().item()
            check(torch.allclose(got.float(), want.float(), **TOL[dname]),
                  f"convnext_block_fused matches its plain version at a wide map "
                  f"({dname}, ({b},{side},{side},{c}), max|d|={err:.3g}, kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms)")
    print("  library_ms: none (no single PyTorch call computes either fused block)",
          flush=True)
    state["kernel_results"] = results


# ------------------------------ phase 3 ------------------------------

def _randomise(model, seed: int) -> None:
    """γ (init 1e-6 makes every block an identity), MaxViT's bias tables
    (std 0.5, as tests/test_maxvit_fullspec.py draws them) and the BN
    statistics to seeded random values."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith((".gamma", ".relative_position_bias_table")):
                prm.copy_(torch.randn(prm.shape, generator=g) * 0.5)
        for bn in model.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                bn.running_mean.copy_(torch.randn(bn.running_mean.shape, generator=g))
                bn.running_var.copy_(torch.rand(bn.running_var.shape, generator=g) * 1.5
                                     + 0.5)


def _normalised_triplets(n: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, 63, 63, 3)).astype(np.float32)
    return t / np.sqrt((t ** 2).sum(axis=(1, 2), keepdims=True))


def _example_data():
    import numpy as np
    trips = np.load(os.path.join(EXAMPLE_DIR, "usage_triplets.npy")).astype(np.float32)
    with open(os.path.join(EXAMPLE_DIR, "usage_candidates.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    meta = np.asarray([[float(r[c]) for c in META_COLS] for r in rows], np.float32)
    return trips, meta


def _plain_scores(model, triplets, metadata, batch: int):
    """Scores of the plain model (every block in its plain version) on the
    card, batch by batch with the scorer's padding."""
    import numpy as np
    import torch
    from btsbot_tpu_torch.engine.serve import _bucket_ladder, _padded_on, _pick_bucket

    ladder = _bucket_ladder(batch)
    out = []
    n = len(triplets if triplets is not None else metadata)
    with torch.inference_mode(), _plain_ops():
        for s in range(0, n, batch):
            e = min(s + batch, n)
            bs = _pick_bucket(ladder, e - s)
            img, meta = (None if x is None else _padded_on(x[s:e], bs, DEVICE)
                         for x in (triplets, metadata))
            z = model(img, meta).reshape(-1).float()
            out.append(torch.sigmoid(z)[:e - s].cpu().numpy())
    return np.concatenate(out)


def _numpy_corrupt_mask(raw):
    """Independent numpy statement of the drop rule (non-finite median,
    all-zero after cleaning, float32 sum-of-squares overflow)."""
    import numpy as np
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN cutouts
        med = np.nanmedian(raw, axis=(1, 2))
    cleaned = np.nan_to_num(raw)
    with np.errstate(over="ignore"):
        sq = np.square(cleaned).sum(axis=(1, 2), dtype=np.float32)
    bad = ~np.isfinite(med) | np.all(cleaned == 0, axis=(1, 2)) | ~np.isfinite(sq)
    return bad.any(axis=-1)


def _packets(n: int, seed: int) -> list:
    """n synthetic packets, three of which must be dropped: an all-NaN
    science cutout, an all-zero template, a missing difference cutout."""
    import numpy as np
    from btsbot_tpu_torch.data.fits import write_fits_image
    from btsbot_tpu_torch.data.synthetic import synthetic_packets

    packets = list(synthetic_packets(n - 3, META_COLS, seed=seed, unique_stamps=True))
    bad = list(synthetic_packets(3, META_COLS, seed=seed + 1, unique_stamps=True))
    bad[0]["cutoutScience"] = {"stampData": gzip.compress(write_fits_image(
        np.full((63, 63), np.nan, np.float32)))}
    bad[1]["cutoutTemplate"] = {"stampData": gzip.compress(write_fits_image(
        np.zeros((63, 63), np.float32)))}
    bad[2]["cutoutDifference"] = None
    for at, packet in zip((10, n // 2, n - 100), bad):
        packets[at:at] = [packet]
    return packets


def _n_batches(n: int) -> int:
    return -(-n // BATCH)


def phase_main_path(state: dict) -> None:
    import numpy as np
    import torch
    from btsbot_tpu_torch import AlertScorer, AlertStreamScorer, native
    from btsbot_tpu_torch.engine.serve import _gather_metadata
    from btsbot_tpu_torch.models.factory import build_model
    from btsbot_tpu_torch.ops.preprocess import preprocess_triplets

    model = build_model(FLAGSHIP_CONFIG, dtype=torch.float32, device=DEVICE, seed=0)
    _randomise(model, seed=1)
    weights = model.state_dict()
    state["model"], state["weights"] = model, weights

    n_big = 2 * BATCH + 500
    trips = _normalised_triplets(n_big, seed=2)
    meta = np.random.default_rng(3).normal(size=(n_big, len(META_COLS))).astype(np.float32)
    ex_trips, ex_meta = _example_data()
    print(f"  {len(ex_trips)} example alerts, {n_big} synthetic alerts", flush=True)

    scorers = {
        "bf16": AlertScorer(FLAGSHIP_CONFIG, weights, batch_size=BATCH, device=DEVICE),
        "f32": AlertScorer(FLAGSHIP_CONFIG, weights, batch_size=BATCH,
                           dtype=torch.float32, device=DEVICE),
    }
    ladder = [b for b in (BATCH // 16, BATCH // 4, BATCH) if b >= 64]
    check(scorers["bf16"].bucket_sizes == ladder, f"bucket ladder {ladder}")
    stream = AlertStreamScorer(FLAGSHIP_CONFIG, weights, batch_size=BATCH,
                               device=DEVICE)
    print(f"  stamp decoder: {native.decoder()}", flush=True)

    packets = _packets(2 * BATCH, seed=4)

    # warm every bucket outside the counted run
    for sc in scorers.values():
        sc(trips[:1], meta[:1]), sc(trips[:500], meta[:500]), sc(trips[:BATCH], meta[:BATCH])
    stream.warmup()
    torch.cuda.synchronize()

    # ---- the counted run of the main path
    mark = _launches(by=4)
    timings, scores = {}, {}
    for name, sc in scorers.items():
        t0 = time.perf_counter()
        scores[name] = sc(trips, meta)
        timings[f"AlertScorer {name}"] = (n_big, time.perf_counter() - t0)
        scores[name + "_ex"] = sc(ex_trips, ex_meta)
    t0 = time.perf_counter()
    s_stream, d_stream = stream(packets)
    timings["AlertStreamScorer bf16"] = (len(packets), time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = _launches(mark)
    state["launches_main"] = launches
    batches = 2 * (_n_batches(n_big) + _n_batches(len(ex_trips))) + _n_batches(len(packets))
    print(f"  launches: {launches} over {batches} batches", flush=True)
    check(launches["convnext_block_fused"] == 12 * batches,
          f"12 block-kernel launches per batch ({12 * batches})")
    by_variant = _launches(mark, by=2)
    f32_batches = _n_batches(n_big) + _n_batches(len(ex_trips))
    print(f"  launches by kernel and variant: {by_variant}", flush=True)
    check(by_variant == {("convnext_block_fused", "tf32x3"): 12 * f32_batches,
                         ("convnext_block_fused", "tuned"): 12 * (batches - f32_batches)},
          f"every float32 launch ({12 * f32_batches}) on the tf32x3 kernels, every "
          f"bfloat16 one on the tuned kernels")
    state["launches_main_f32"] = by_variant[("convnext_block_fused", "tf32x3")]

    # ---- scores
    for name in ("f32", "bf16", "f32_ex", "bf16_ex"):
        check(bool(np.all(np.isfinite(scores[name]))), f"{name} scores finite")
    plain = _plain_scores(model, trips, meta, BATCH)
    plain_ex = _plain_scores(model, ex_trips, ex_meta, BATCH)
    d32 = max(np.abs(scores["f32"] - plain).max(), np.abs(scores["f32_ex"] - plain_ex).max())
    print(f"  f32 kernel path vs plain model: max|d|={d32:.3g}", flush=True)
    check(d32 <= 1e-5, "f32 scores within 1e-5 of the plain model on the card")
    d16 = max(np.abs(scores["bf16"] - scores["f32"]).max(),
              np.abs(scores["bf16_ex"] - scores["f32_ex"]).max())
    print(f"  bf16 vs f32 scores: max|d|={d16:.3g}", flush=True)
    check(d16 <= 0.01, "bf16 scores within 0.01 of f32")

    # ---- stream against the array path on the same decoded triplets
    t0 = time.perf_counter()
    raw, _, decode_bad = stream._prepare(packets)
    secs = time.perf_counter() - t0
    print(f"  host stage alone (decode + metadata gather, {native.decoder()}): "
          f"{len(packets) / secs:.1f} packets/s ({secs:.3f} s)", flush=True)
    want_drop = _numpy_corrupt_mask(raw) | decode_bad
    check(int(want_drop.sum()) == 3 and bool(np.array_equal(d_stream, want_drop)),
          "stream drop mask identical to the array path's (3 dropped)")
    with torch.inference_mode():
        proc, drop_dev = preprocess_triplets(torch.from_numpy(raw).to(DEVICE))
    check(bool(np.array_equal(drop_dev.cpu().numpy() | decode_bad, want_drop)),
          "device corrupt mask identical to the numpy one")
    arr = scorers["bf16"](proc.cpu().numpy(), _gather_metadata(packets, META_COLS))
    keep = ~want_drop
    ds = np.abs(s_stream[keep] - arr[keep]).max()
    print(f"  stream vs array scores (bf16): max|d|={ds:.3g}", flush=True)
    check(ds <= 0.01 and bool(np.all(np.isnan(s_stream[want_drop]))),
          "stream scores match the array path; dropped alerts are NaN")

    state["timings"] = timings
    state["scorer_bf16"] = scorers["bf16"]
    state["throughput"] = {name: sc.throughput() for name, sc in scorers.items()}


# ------------------------------ phase 4 ------------------------------

def phase_fast_path(state: dict) -> None:
    import numpy as np
    import torch
    from btsbot_tpu_torch.ops.ln_mlp import fast_mm_convnext_logits

    model, weights = state["model"], state["weights"]
    trips = torch.from_numpy(_normalised_triplets(BATCH, seed=6)).to(DEVICE)
    meta = torch.from_numpy(np.random.default_rng(7).normal(
        size=(BATCH, len(META_COLS))).astype(np.float32)).to(DEVICE)
    with torch.inference_mode():
        want = model(trips, meta).reshape(-1)
        torch.cuda.synchronize()
        mark = _launches(by=4)
        got = fast_mm_convnext_logits(weights, trips, meta, FLAGSHIP_CONFIG)
        torch.cuda.synchronize()
        launches = _launches(mark)
        by_variant = _launches(mark, by=2)
    state["launches_fast"] = launches
    print(f"  launches: {launches}", flush=True)
    check(launches["fused_ln_mlp"] == 12
          and by_variant == {("fused_ln_mlp", "tf32x3"): 12},
          "12 fused_ln_mlp launches, all float32 on the tf32x3 kernel")
    err = (got - want).abs().max().item()
    print(f"  fast path vs module logits (f32): max|d|={err:.3g}", flush=True)
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-5),
          "fast_mm_convnext_logits within rtol 1e-4 of the module")


# ------------------------------ phase 5 ------------------------------

def _block_split(sc, per_forward: int, iters: int = 10) -> tuple:
    """(forward ms, ms in its block-kernel launches) of the scorer's bf16
    forward at batch BATCH on device-resident inputs, with CUDA events around
    each launch; ``per_forward`` launches a forward."""
    import torch
    from btsbot_tpu_torch.ops import convnext_block as port_block

    g = torch.Generator(device="cpu").manual_seed(0)
    images = torch.randn(BATCH, 63, 63, 3, generator=g).to(DEVICE)
    meta = torch.randn(BATCH, len(META_COLS), generator=g).to(DEVICE)
    launch, spans = port_block._launch_block, []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args)
        end.record()
        spans.append((start, end))
        return out

    for _ in range(3):
        sc._score(images, meta)
    whole = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    port_block._launch_block = timed
    try:
        torch.cuda.synchronize()
        whole[0].record()
        for _ in range(iters):
            sc._score(images, meta)
        whole[1].record()
        torch.cuda.synchronize()
    finally:
        port_block._launch_block = launch
    check(len(spans) == per_forward * iters, f"{per_forward} block launches per timed forward")
    return (whole[0].elapsed_time(whole[1]) / iters,
            sum(a.elapsed_time(b) for a, b in spans) / iters)


def phase_forward_split(state: dict) -> None:
    """The bf16 forward on device-resident inputs, split with CUDA events into
    the 12 block-kernel launches and everything else (stem, downsample,
    heads, sigmoid, the gaps between launches)."""
    total, blocks = _block_split(state["scorer_bf16"], 12)
    state["forward_split"] = (total, blocks)
    print(f"  bf16 forward at batch {BATCH}: {total:.3f} ms = 12 block launches "
          f"{blocks:.3f} ms + everything else {total - blocks:.3f} ms "
          f"({BATCH / total * 1e3:.0f} alerts/s) on {state['gpu']}", flush=True)


# ------------------------------ phase 6 ------------------------------

TRAIN_ALERTS, VAL_ALERTS, TRAIN_BATCH = 4096, 1024, 64
# report.json as the JAX package writes it (metrics/report.py), val summary
# with candidates (metrics/diagnostics.py)
REPORT_KEYS = {"Run time stamp", "Run name", "Training history", "train_config",
               "val_summary"}
HISTORY_KEYS = {"train_loss", "train_accuracy", "val_loss", "val_accuracy"}
SUMMARY_KEYS = {"roc_auc", "bts_acc", "notbts_acc", "bal_acc", "alert_precision",
                "alert_recall", "accuracy", "confusion", "policy_performance"}


def _write_split(data_dir: str, split: str, n: int, seed: int) -> None:
    """``{split}_cand_v12_N100.csv`` + ``{split}_triplets_v12_N100.npy``: about
    30 % positives, each with a blob in all three cutouts; L2-normalised
    cutouts; the 25 flagship metadata columns (magpsf 17-19.5); three alerts
    an object."""
    import numpy as np
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.3).astype(np.int64)
    trips = rng.normal(size=(n, 63, 63, 3)).astype(np.float32)
    trips[labels == 1, 28:35, 28:35, :] += 2.0
    trips /= np.sqrt((trips ** 2).sum(axis=(1, 2), keepdims=True))
    np.save(os.path.join(data_dir, f"{split}_triplets_v12_N100.npy"), trips)
    meta = rng.normal(size=(n, len(META_COLS))) + 0.5 * labels[:, None]
    meta[:, META_COLS.index("magpsf")] = 17 + 2.5 * rng.random(n)
    with open(os.path.join(data_dir, f"{split}_cand_v12_N100.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["objectId", "candid", "jd", "label"] + META_COLS)
        for i in range(n):
            w.writerow([f"ZTF{seed}{i // 3:07d}", 10 ** 12 + i, 2459300.5 + i / 7,
                        labels[i]] + [f"{v:.7g}" for v in meta[i]])


def _smoke_split(state: dict) -> tuple[str, str]:
    """(scratch directory, data directory): the training split, written on
    first use under ``build/``; ``main`` removes the directory at exit."""
    if "scratch" not in state:
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        state["scratch"] = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        data_dir = os.path.join(state["scratch"], "data")
        os.makedirs(data_dir)
        t0 = time.perf_counter()
        _write_split(data_dir, "train", TRAIN_ALERTS, seed=11)
        _write_split(data_dir, "val", VAL_ALERTS, seed=12)
        print(f"  wrote {TRAIN_ALERTS} + {VAL_ALERTS} alerts in the reference's layout "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return state["scratch"], os.path.join(state["scratch"], "data")


def _train_config(**over) -> dict:
    return {**FLAGSHIP_CONFIG, "pretrained": False, "batch_size": TRAIN_BATCH, **over}


def _fresh_state(config, weights):
    """(normalised config, train state) of a fresh flagship holding ``weights``."""
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.engine.state import create_train_state
    from btsbot_tpu_torch.models.factory import build_model

    config = normalize_config(config)
    model = build_model(config, device=DEVICE)
    model.load_state_dict(weights)
    return config, create_train_state(config, model,
                                      steps_per_epoch=TRAIN_ALERTS // TRAIN_BATCH)


def _one_step(config, weights, batch):
    """One train step of a fresh model holding ``weights`` on ``batch``;
    (loss, {name: grad}, block-kernel launches)."""
    import torch
    from btsbot_tpu_torch.engine.steps import make_train_step

    config, st = _fresh_state(config, weights)
    torch.cuda.synchronize()
    mark = _launches(by=4)
    m = make_train_step(config)(st, *batch)
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in st.model.named_parameters()}
    return m["loss"].item(), grads, _launches(mark)["convnext_block_fused"]


def _step_split(config, weights, batch, iters: int = 10):
    """ms of one train step = 12 block launches + the recompute backward of
    the 12 blocks + the optimizer + everything else, with CUDA events."""
    import torch
    from btsbot_tpu_torch.engine.steps import make_train_step
    from btsbot_tpu_torch.ops import convnext_block as port_block

    config, st = _fresh_state(config, weights)
    step = make_train_step(config)
    spans = {"launch": [], "backward": [], "optimizer": []}

    def timed(kind, fn):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[kind].append((start, end))
            return out
        return wrapper

    for _ in range(3):
        step(st, *batch)
    launch, backward, opt_step = (port_block._launch_block, port_block.recompute_backward,
                                  st.optimizer.step)
    port_block._launch_block = timed("launch", launch)
    port_block.recompute_backward = timed("backward", backward)
    st.optimizer.step = timed("optimizer", opt_step)
    whole = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    try:
        torch.cuda.synchronize()
        whole[0].record()
        for _ in range(iters):
            step(st, *batch)
        whole[1].record()
        torch.cuda.synchronize()
    finally:
        port_block._launch_block, port_block.recompute_backward = launch, backward
        del st.optimizer.step
    check(len(spans["launch"]) == len(spans["backward"]) == 12 * iters,
          "12 block launches and 12 recompute backwards per timed step")
    out = {k: sum(a.elapsed_time(b) for a, b in v) / iters for k, v in spans.items()}
    out["step"] = whole[0].elapsed_time(whole[1]) / iters
    out["rest"] = out["step"] - out["launch"] - out["backward"] - out["optimizer"]
    return out


def _profile(fn, label: str, iters: int = 5, top: int = 10) -> None:
    """Kernel time by name over ``iters`` calls of ``fn`` with
    ``torch.profiler``, and the device's busy share of the wall time
    (information only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    # kernels only: a user annotation (``Optimizer.step#AdamW.step``) also
    # shows on the device timeline, spanning kernels counted on their own
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / iters
    if not kernels:
        print("  profiler: no device time recorded; busy share not measured", flush=True)
        return
    print(f"  profile, {label}: {wall_ms:.3f} ms a call (host clock, profiler on), device "
          f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{sum(e.count for e in kernels) / iters:.0f} kernels a call", flush=True)
    for e in sorted(kernels, key=lambda e: e.device_time_total, reverse=True)[:top]:
        print(f"    {e.device_time_total / 1e3 / iters:8.3f} ms  x{e.count / iters:4.0f}  "
              f"{e.key[:110]}", flush=True)


def _profile_steps(config, weights, batch) -> None:
    """``_profile`` over flagship train steps."""
    from btsbot_tpu_torch.engine.steps import make_train_step

    config, st = _fresh_state(config, weights)
    step = make_train_step(config)
    _profile(lambda: step(st, *batch), f"train step batch {batch[0].shape[0]} "
                                       f"{config.get('compute_dtype', 'float32')}")


def phase_train(state: dict) -> None:
    import numpy as np
    import torch
    from btsbot_tpu_torch.cli.train import main as train_cli
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.data.dataset import load_split
    from btsbot_tpu_torch.engine.checkpoint import load_model_checkpoint
    from btsbot_tpu_torch.engine.eval import predict_dataset
    from btsbot_tpu_torch.engine.steps import make_train_step
    from btsbot_tpu_torch.models.factory import build_model

    weights = state["weights"]
    tmp, data_dir = _smoke_split(state)
    out_root = os.path.join(tmp, "models")
    config = normalize_config(_train_config(epochs=2))
    train = load_split(config, "train", data_dir)
    val = load_split(config, "val", data_dir)

    def batch_of(n):
        return (torch.from_numpy(train.images[:n]).to(DEVICE),
                torch.from_numpy(train.metadata[:n]).to(DEVICE),
                torch.from_numpy(train.labels[:n]).to(DEVICE), train.pos_weight)

    # ---- one float32 step through the kernel and through the plain blocks
    batch = batch_of(TRAIN_BATCH)
    loss_k, grads_k, n_k = _one_step(config, weights, batch)
    with _plain_ops():
        loss_p, grads_p, n_p = _one_step(config, weights, batch)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    worst, worst_name = max(
        ((grads_k[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), n)
        for n, g in grads_p.items())
    print(f"  one f32 step: loss {loss_k:.8f} kernel / {loss_p:.8f} plain "
          f"(rel {rel:.3g}); worst gradient max|d|/max|g| = {worst:.3g} ({worst_name})",
          flush=True)
    check(n_k == 12 and n_p == 0, "12 block-kernel launches in a train step (0 plain)")
    check(rel <= 1e-6, "train-step loss through the kernel within rtol 1e-6 of plain")
    check(worst <= 1e-4, "every gradient within 1e-4 x its largest entry of plain")

    # ---- bfloat16 compute, same weights and batch
    loss_b, grads_b, _ = _one_step({**config, "compute_dtype": "bfloat16"}, weights,
                                   batch)
    print(f"  one bf16 step: loss {loss_b:.6f} (f32 {loss_k:.6f})", flush=True)
    check(abs(loss_b - loss_k) <= 1e-2 and all(
        g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        for g in grads_b.values()),
        "bf16 first-step loss within 1e-2 of f32; finite float32 gradients")

    # ---- the entry point: 2 epochs, then resumed for a third
    steps = TRAIN_ALERTS // TRAIN_BATCH
    evals = -(-VAL_ALERTS // TRAIN_BATCH)
    cli_args = ["--data-dir", data_dir, "--out-root", out_root, "--run-name", "smoke",
                "--no-figure", "--device", DEVICE]
    runs = []
    for epochs, extra in ((2, []), (3, ["--resume"])):
        path = os.path.join(tmp, f"config_{epochs}.json")
        with open(path, "w") as f:
            json.dump(_train_config(epochs=epochs), f)
        torch.cuda.synchronize()
        mark = _launches(by=4)
        t0 = time.perf_counter()
        result = train_cli([path] + cli_args + extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _launches(mark)["convnext_block_fused"]
        ran = epochs - (2 if extra else 0)
        want = 12 * ran * (steps + evals)
        print(f"  cli.train {' '.join(extra) or '(fresh)'}: {ran} epoch(s), "
              f"{launches} block launches, {secs:.1f} s", flush=True)
        check(launches == want, f"12 block launches per train step and eval batch "
                                f"({ran} x ({steps} + {evals}) x 12 = {want})")
        hist = result["history"]
        check(len(hist["train_loss"]) == epochs and all(
            np.all(np.isfinite(hist[k])) for k in ("train_loss", "val_loss")),
            f"{epochs} epochs of finite train and val losses")
        runs.append((result, secs, launches))
        if not extra:
            # best_model.pth as a user loads it, scored on the val split
            model = build_model(config, device=DEVICE)
            model.load_state_dict(load_model_checkpoint(config, result["model_dir"]),
                                  strict=True)
            _, scores = predict_dataset(model, config, val)
            d = float(np.abs(scores - result["best_val_scores"]).max())
            print(f"  best_model.pth vs the trainer's best epoch: max|d|={d:.3g}",
                  flush=True)
            check(d <= 1e-6, "best_model.pth loads strict and scores the val split "
                             "within 1e-6 of the trainer's best-epoch predictions")
    result = runs[-1][0]
    state["flagship_run"] = result["model_dir"]  # served in "daemon", validated in "val"
    with open(os.path.join(result["model_dir"], "report.json")) as f:
        report = json.load(f)
    check(set(report) == REPORT_KEYS and set(report["Training history"]) == HISTORY_KEYS
          and set(report["val_summary"]) == SUMMARY_KEYS,
          "report.json has the JAX package's keys")
    for name in ("train_loss", "val_loss"):
        print(f"  {name}: {[round(float(x), 5) for x in result['history'][name]]}", flush=True)
    print(f"  val ROC-AUC {report['val_summary']['roc_auc']:.4f}", flush=True)
    state["launches_train"] = sum(r[2] for r in runs)

    # ---- speed (information only)
    rates = {}
    for n in (TRAIN_BATCH, 1024):
        batch = batch_of(n)
        for dname in ("float32", "bfloat16"):
            cfg, st = _fresh_state({**config, "compute_dtype": dname}, weights)
            step = make_train_step(cfg)
            ms = time_ms(lambda: step(st, *batch))
            rates[(n, dname)] = ms
            print(f"  train step batch {n} {dname}: {ms:.3f} ms = {1e3 / ms:.1f} "
                  f"steps/s, {n * 1e3 / ms:.1f} alerts/s on {state['gpu']}", flush=True)
            del st
    splits = {}
    for n, dname in ((TRAIN_BATCH, "float32"), (1024, "float32"), (1024, "bfloat16")):
        sp = _step_split({**config, "compute_dtype": dname}, weights, batch_of(n))
        splits[(n, dname)] = sp
        print(f"  step split batch {n} {dname}: {sp['step']:.3f} ms = 12 block "
              f"launches {sp['launch']:.3f} + recompute backward {sp['backward']:.3f} "
              f"+ optimizer {sp['optimizer']:.3f} + everything else {sp['rest']:.3f} "
              f"on {state['gpu']}", flush=True)
    for n, dname in ((TRAIN_BATCH, "float32"), (1024, "bfloat16")):
        try:
            _profile_steps({**config, "compute_dtype": dname}, weights, batch_of(n))
        except Exception as e:  # noqa: BLE001 — information only
            print(f"  profiler failed ({e!r}); not measured", flush=True)
    state["train"] = {"epoch_secs": [r[1] for r in runs], "step_ms": rates,
                      "splits": splits}


# ------------------------------ phase 7 ------------------------------

FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures", "ref_trained_mm_cnn")
FAMILY_ALERTS = BATCH + 500          # a full batch and a partial one
CPU_ALERTS = 256                     # the conv families' f32 check on the host
# the kernel each family's forward launches (12 times, nano 14; the others
# launch none)
KERNEL_OF = {"ConvNeXt": "convnext_block_fused", "frozen_fusion": "convnext_block_fused",
             "inceptionnext_pico": "fused_ln_mlp", "inceptionnext_pico.r2": "fused_ln_mlp",
             "mm_ConvNeXt-nano": "convnext_block_fused", "mm_MaxViT": "fused_ln_mlp",
             "MaxViT": "fused_ln_mlp", "frozen_fusion over MaxViT": "fused_ln_mlp"}
# launches of that kernel a forward where they are not 12: maxvit_tiny's 22 MLP halves
LAUNCHES_OF = {"mm_MaxViT": 22, "MaxViT": 22, "frozen_fusion over MaxViT": 22}


def _family_configs() -> dict:
    """The production mm_cnn (``btsbot_tpu_torch/train_configs/prod_config.json``,
    read as data), um_cnn and um_nn at its widths, the image-only
    ConvNeXt-pico, and frozen_fusion over a ConvNeXt-pico and a um_nn
    branch; each trains on the smoke split (``train_data_version`` v12)."""
    with open(os.path.join(ROOT, "btsbot_tpu_torch", "train_configs", "prod_config.json")) as f:
        prod = json.load(f)
    train = {k: prod[k] for k in ("learning_rate", "beta_1", "beta_2", "batch_size",
                                  "warmup_epochs", "random_seed", "metadata_cols")}
    train.update(train_data_version="v12", pretrained=False, epochs=1, patience=5)
    conv = {k: prod[k] for k in ("conv1_channels", "conv2_channels", "conv_kernel",
                                 "conv_dropout1", "conv_dropout2")}
    meta = {k: prod[k] for k in ("meta_fc1_neurons", "meta_fc2_neurons", "meta_dropout")}
    um_nn = {"model_name": "um_nn", **meta, **train}
    convnext = {"model_name": "ConvNeXt", "model_kind": "convnext_pico.d1_in1k",
                "fc1_neurons": FLAGSHIP_CONFIG["comb_fc1_neurons"],
                "fc2_neurons": FLAGSHIP_CONFIG["comb_fc2_neurons"],
                "dropout": FLAGSHIP_CONFIG["comb_dropout"], **train}
    return {
        "mm_cnn": {**prod, **train},
        "um_cnn": {"model_name": "um_cnn", **conv, "fc1_neurons": prod["comb_fc1_neurons"],
                   "fc2_neurons": prod["comb_fc2_neurons"], "dropout": prod["comb_dropout"],
                   **train},
        "um_nn": um_nn,
        "ConvNeXt": convnext,
        "frozen_fusion": {"model_name": "frozen_fusion", "image_model_config": convnext,
                          "meta_model_config": um_nn,
                          **{k: FLAGSHIP_CONFIG[k] for k in ("comb_fc1_neurons",
                                                            "comb_fc2_neurons",
                                                            "comb_dropout")}, **train},
    }


def _conv_split(model, images, iters: int = 10) -> dict:
    """ms of mm_cnn's forward at this batch and type, split with CUDA events
    into its four convs and everything else; and each conv alone on its
    channels_last view (as the model calls it) and after a copy of its input
    to NCHW-contiguous memory (the copy's cost included)."""
    import torch
    convs = [model.conv_layers[i] for i in (0, 2, 6, 8)]
    spans = {i: [] for i in range(4)}
    inputs = {}

    def timed(i, conv):
        fwd = conv.forward

        def wrapper(x):
            inputs[i] = x
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fwd(x)
            end.record()
            spans[i].append((start, end))
            return out
        return wrapper

    meta = torch.zeros(images.shape[0], len(META_COLS), device=DEVICE, dtype=images.dtype)
    with torch.inference_mode():
        for _ in range(3):
            model(images, meta)
        for i, conv in enumerate(convs):
            conv.forward = timed(i, conv)
        try:
            whole = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            whole[0].record()
            for _ in range(iters):
                model(images, meta)
            whole[1].record()
            torch.cuda.synchronize()
        finally:
            for conv in convs:
                del conv.forward
        out = {"forward": whole[0].elapsed_time(whole[1]) / iters}
        for i, conv in enumerate(convs):
            out[f"conv{i}"] = sum(a.elapsed_time(b) for a, b in spans[i]) / iters
            nchw = inputs[i].permute(0, 3, 1, 2)
            w, b = conv.weight.to(nchw.dtype), conv.bias.to(nchw.dtype)
            out[f"conv{i}_view"] = time_ms(lambda: conv._conv_forward(nchw, w, b))
            out[f"conv{i}_copy"] = time_ms(lambda: conv._conv_forward(nchw.contiguous(), w, b))
            # cuDNN's autotuner instead of its heuristics (information only)
            torch.backends.cudnn.benchmark = True
            try:
                out[f"conv{i}_tuned"] = time_ms(lambda: conv._conv_forward(nchw, w, b))
            finally:
                torch.backends.cudnn.benchmark = False
        out["rest"] = out["forward"] - sum(out[f"conv{i}"] for i in range(4))
        try:
            _profile(lambda: model(images, meta), f"mm_cnn forward batch {images.shape[0]} "
                                                  f"{str(images.dtype).split('.')[-1]}")
        except Exception as e:  # noqa: BLE001 — information only
            print(f"  profiler failed ({e!r}); not measured", flush=True)
    return out


def _conv_work(config) -> list:
    """(FLOPs, bytes at one byte an element) an alert of each of mm_cnn's
    four convs: its input read once, its output and weights written and read
    once."""
    c1, c2, k = config["conv1_channels"], config["conv2_channels"], config["conv_kernel"]
    s1, s2 = 63 * 63, 31 * 31
    shapes = [(s1, 3, c1), (s1, c1, c1), (s2, c1, c2), (s2, c2, c2)]  # pixels, in, out
    return [(2 * px * cin * cout * k * k, px * (cin + cout) + cout * (cin * k * k + 1))
            for px, cin, cout in shapes]


# the wrappers of the kernels without variants, by their C entry points
KERNEL_ENTRIES = {"btsbot_partition_attention": "partition_attention",
                  "btsbot_mbconv_dw": "mbconv_dw", "btsbot_int8_block": "int8_block",
                  "btsbot_int8_dwconv": "int8_dwconv"}


class CountingLibrary:
    """Stands in for ``ops._build.library`` and counts the kernels'
    launches: called, it returns itself; an entry point looked up on it is
    the loaded library's, and each launch of a kernel that returns success
    adds one to ``launches`` under (wrapper, variant, C, hidden) (variant, C
    and hidden for the two ConvNeXt kernels, else None).  ``load``, the
    loader it stands in for, runs at the first lookup, so where the wrappers
    take their plain versions nothing is built or counted."""

    def __init__(self, load):
        self.load = load
        self.launches = collections.Counter()

    def __call__(self):
        return self

    def __getattr__(self, name):
        from btsbot_tpu_torch.ops import _build

        fn = getattr(self.load(), name)
        widths = {entry: (wrapper, variant)
                  for op, wrapper in (("convnext_block", "convnext_block_fused"),
                                      ("ln_mlp", "fused_ln_mlp"))
                  for variant, entry in _build.ENTRY_POINTS[op].items()}
        if name not in widths and name not in KERNEL_ENTRIES:
            return fn  # a size query, not a launch

        def launch(*args):
            err = fn(*args)
            if err == 0:
                if name in KERNEL_ENTRIES:
                    key = (KERNEL_ENTRIES[name], None, None, None)
                else:
                    wrapper, variant = widths[name]
                    # ..., C, hidden, [LN eps,] [is_bf16: not tf32x3's,] stream
                    end = -1 - (wrapper == "fused_ln_mlp") - (variant != "tf32x3")
                    key = (wrapper, variant, *args[end - 2:end])
                self.launches[key] += 1
            return err
        return launch


def _launches(since: dict | None = None, by: int = 1,
              kernels=("convnext_block_fused", "fused_ln_mlp")) -> dict:
    """The kernel launches of this run (the first call puts a
    ``CountingLibrary`` in ``ops._build.library``'s place; ``phase_setup``
    makes that call), summed by the first ``by`` of their (wrapper, variant,
    C, hidden); with ``since``, an earlier return at ``by`` = 4, only those
    after it.  At ``by`` = 1 the keys are ``kernels``, 0 where one did not
    launch."""
    from btsbot_tpu_torch.ops import _build

    if not isinstance(_build.library, CountingLibrary):
        _build.library = CountingLibrary(_build.library)
    counts = _build.library.launches - collections.Counter(since or {})
    out = dict.fromkeys(kernels, 0) if by == 1 else {}
    for key, n in counts.items():
        k = key[0] if by == 1 else key[:by]
        if by > 1 or k in out:
            out[k] = out.get(k, 0) + n
    return out


@contextlib.contextmanager
def _plain_ops():
    """The models' kernel wrappers replaced by their plain versions for the
    block's length (a distilled teacher's and a fusion's branch too): the
    reference the kernel path is held to on the same device."""
    from btsbot_tpu_torch.models import convnext, maxvit
    from btsbot_tpu_torch.ops.convnext_block import convnext_block_reference
    from btsbot_tpu_torch.ops.ln_mlp import ln_mlp_reference
    from btsbot_tpu_torch.ops.mbconv_dw import mbconv_dw_reference
    from btsbot_tpu_torch.ops.partition_attention import partition_attention_reference

    with _patched(convnext, convnext_block_fused=convnext_block_reference,
                  fused_ln_mlp=ln_mlp_reference), \
            _patched(maxvit, fused_ln_mlp=ln_mlp_reference, mbconv_dw=mbconv_dw_reference,
                     partition_attention=partition_attention_reference):
        yield


def _serve_family(name, config, trips, meta, per_batch: int = 12) -> dict:
    """Both scorers at batch 3072 on the card (counted), their checks, and
    the throughputs; ``per_batch``: launches of the family's kernel a batch."""
    import numpy as np
    import torch
    from btsbot_tpu_torch import AlertScorer
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.models.factory import build_model

    cfg = normalize_config(config)
    trips = trips if cfg.need_triplets else None
    meta = meta if cfg.need_metadata else None
    model = build_model(cfg, dtype=torch.float32, device=DEVICE, seed=0)
    _randomise(model, seed=1)
    weights = model.state_dict()
    scorers = {"bf16": AlertScorer(cfg, weights, batch_size=BATCH, device=DEVICE),
               "f32": AlertScorer(cfg, weights, batch_size=BATCH, dtype=torch.float32,
                                  device=DEVICE)}
    for sc in scorers.values():  # warm both buckets of the counted run
        sc(*(None if x is None else x[:BATCH] for x in (trips, meta)))
        sc(*(None if x is None else x[BATCH:] for x in (trips, meta)))
    torch.cuda.synchronize()
    mark = _launches(by=4)
    scores = {k: sc(trips, meta) for k, sc in scorers.items()}
    torch.cuda.synchronize()
    counts = _launches(mark)
    batches = 2 * _n_batches(FAMILY_ALERTS)
    want = {k: per_batch * batches if KERNEL_OF.get(name) == k else 0 for k in counts}
    print(f"  {name}: launches {counts} over {batches} batches", flush=True)
    check(counts == want, f"{name}: " + ", ".join(
        f"{n // batches} {k} launches a batch" for k, n in want.items()))
    check(all(bool(np.all(np.isfinite(v))) for v in scores.values())
          and scores["f32"].shape == (FAMILY_ALERTS,), f"{name}: finite scores")
    if name in KERNEL_OF:
        ref = _plain_scores(model, trips, meta, BATCH)
        d = float(np.abs(scores["f32"] - ref).max())
        print(f"  {name}: f32 kernel path vs plain model: max|d|={d:.3g}", flush=True)
        check(d <= 1e-5, f"{name}: f32 scores within 1e-5 of the plain model on the card")
    else:
        cpu = AlertScorer(cfg, {k: v.cpu() for k, v in weights.items()}, batch_size=CPU_ALERTS,
                          dtype=torch.float32, device="cpu")
        ref = cpu(*(None if x is None else x[:CPU_ALERTS] for x in (trips, meta)))
        got = scores["f32"][:CPU_ALERTS]
        d = float(np.abs(got - ref).max())
        print(f"  {name}: f32 card vs f32 host on {CPU_ALERTS} alerts: max|d|={d:.3g}",
              flush=True)
        check(bool(np.allclose(got, ref, rtol=1e-4, atol=1e-5)),
              f"{name}: f32 scores within rtol 1e-4 / atol 1e-5 of the host's")
    d16 = float(np.abs(scores["bf16"] - scores["f32"]).max())
    print(f"  {name}: bf16 vs f32 scores: max|d|={d16:.3g}", flush=True)
    check(d16 <= 0.01, f"{name}: bf16 scores within 0.01 of f32")
    rates = {k: sc.throughput(iters=10) for k, sc in scorers.items()}
    print(f"  {name}: forward on device-resident inputs, batch {BATCH}: bf16 "
          f"{rates['bf16']:.1f} alerts/s, f32 {rates['f32']:.1f} alerts/s on "
          f"{gpu_line()}", flush=True)
    return {"model": model, "weights": weights, "launches": counts, "rates": rates,
            "scorer_bf16": scorers["bf16"]}


def _stream_family(name, config, weights, scorer_bf16, batch: int = BATCH) -> None:
    """AlertStreamScorer at ``batch`` on ``batch`` packets (three of them
    bad) against the array path on the same decoded alerts."""
    import numpy as np
    import torch
    from btsbot_tpu_torch import AlertStreamScorer
    from btsbot_tpu_torch.engine.serve import _gather_metadata
    from btsbot_tpu_torch.ops.preprocess import preprocess_triplets

    stream = AlertStreamScorer(config, weights, batch_size=batch, device=DEVICE)
    packets = _packets(batch, seed=21)
    s_stream, d_stream = stream(packets)
    raw, meta, decode_bad = stream._prepare(packets)
    if raw is None:  # metadata only: no stamp decoded, nothing dropped
        want_drop = np.zeros(len(packets), bool)
        arr = scorer_bf16(metadata=_gather_metadata(packets, META_COLS))
    else:
        with torch.inference_mode():
            proc, drop_dev = preprocess_triplets(torch.from_numpy(raw).to(DEVICE))
        want_drop = drop_dev.cpu().numpy() | decode_bad
        check(bool(np.array_equal(_numpy_corrupt_mask(raw) | decode_bad, want_drop))
              and int(want_drop.sum()) == 3, f"{name}: device corrupt mask identical to "
                                             f"the numpy one (3 dropped)")
        arr = scorer_bf16(proc.cpu().numpy(), meta)
    keep = ~want_drop
    ds = float(np.abs(s_stream[keep] - arr[keep]).max())
    print(f"  {name}: stream vs array scores (bf16): max|d|={ds:.3g}, "
          f"{int(d_stream.sum())} dropped", flush=True)
    check(bool(np.array_equal(d_stream, want_drop)) and ds <= 0.01
          and bool(np.all(np.isnan(s_stream[want_drop]))),
          f"{name}: stream drop mask identical to the array path's, scores match it")


def _fixture_on_card() -> None:
    """The reference trainer's mm_cnn checkpoint, loaded strict, scored in
    f32 on the card against the scores the reference itself produced."""
    import numpy as np
    import torch
    from btsbot_tpu_torch import AlertScorer
    from btsbot_tpu_torch.engine.checkpoint import load_model_checkpoint

    with open(os.path.join(FIXTURE_DIR, "report.json")) as f:
        config = json.load(f)["train_config"]
    bundle = np.load(os.path.join(FIXTURE_DIR, "in_distribution.npz"))
    sc = AlertScorer(config, load_model_checkpoint(config, FIXTURE_DIR), batch_size=BATCH,
                     dtype=torch.float32, device=DEVICE)
    got = sc(bundle["images"], bundle["metadata"])
    want = bundle["expected_scores"]
    d = float(np.abs(got - want).max())
    print(f"  reference-trained mm_cnn on the card: {len(want)} alerts, max|d|={d:.3g} "
          f"against the reference's scores", flush=True)
    check(bool(np.allclose(got, want, rtol=1e-4, atol=1e-5)),
          "reference best_model.pth reproduces in_distribution.npz in f32 (rtol 1e-4 / "
          "atol 1e-5)")


def _train_family(config, name, data_dir, out_root, run_name,
                  alerts: tuple | None = None) -> tuple:
    """cli.train on a split of ``alerts`` (train, val; default the smoke
    split's); (result, seconds, {kernel: launches}), with 12 launches of the
    family's kernel (KERNEL_OF; LAUNCHES_OF where not 12) per train step and
    eval batch checked."""
    import numpy as np
    import torch
    from btsbot_tpu_torch.cli.train import main as train_cli

    path = os.path.join(out_root, f"{run_name}.json")
    os.makedirs(out_root, exist_ok=True)
    with open(path, "w") as f:
        json.dump(config, f)
    torch.cuda.synchronize()
    mark = _launches(by=4)
    t0 = time.perf_counter()
    result = train_cli([path, "--data-dir", data_dir, "--out-root", out_root,
                        "--run-name", run_name, "--no-figure", "--device", DEVICE])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _launches(mark)
    hist = result["history"]
    check(len(hist["train_loss"]) == config["epochs"] and all(
        np.all(np.isfinite(hist[k])) for k in ("train_loss", "val_loss")),
        f"{name}: cli.train ran {config['epochs']} epoch(s) with finite train and val "
        f"losses ({secs:.1f} s, launches {counts})")
    alerts = alerts or (TRAIN_ALERTS, VAL_ALERTS)
    steps = alerts[0] // config["batch_size"] * config["epochs"]
    evals = -(-alerts[1] // config["batch_size"]) * config["epochs"]
    per_forward = LAUNCHES_OF.get(name, 12)
    want = {k: per_forward * (steps + evals) if KERNEL_OF.get(name) == k else 0 for k in counts}
    check(counts == want, f"{name}: launches {want} in training ({steps} steps + "
                          f"{evals} eval batches)")
    return result, secs, counts


def _branches_kept(result, dirs: dict) -> bool:
    """Every branch parameter of a trained fusion run equal, bit for bit, to
    its branch run's (``dirs``: prefix → run directory)."""
    import torch
    from btsbot_tpu_torch.engine.checkpoint import load_model_checkpoint

    trained = load_model_checkpoint(None, result["model_dir"])
    same = True
    for prefix, model_dir in dirs.items():
        branch = load_model_checkpoint(None, model_dir)
        for key, _ in result["model"].named_parameters():
            if key.startswith(prefix):
                same &= torch.equal(trained[key], branch[key[len(prefix):]])
    return same


def phase_families(state: dict) -> None:
    import numpy as np
    import torch
    from btsbot_tpu_torch.cli.export import main as export_cli
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.data.dataset import load_split
    from btsbot_tpu_torch.engine.checkpoint import load_model_checkpoint
    from btsbot_tpu_torch.engine.eval import predict_dataset
    from btsbot_tpu_torch.engine.state import create_train_state
    from btsbot_tpu_torch.engine.steps import make_train_step
    from btsbot_tpu_torch.models.factory import build_model

    configs = _family_configs()
    trips = _normalised_triplets(FAMILY_ALERTS, seed=22)
    meta = np.random.default_rng(23).normal(size=(FAMILY_ALERTS, len(META_COLS))).astype(
        np.float32)
    served, launches, rates = {}, {}, {}
    for name, config in configs.items():
        served[name] = _serve_family(name, config, trips, meta)
        launches[f"{name} serving"] = served[name]["launches"]["convnext_block_fused"]
        rates[name] = served[name]["rates"]
    for name in ("mm_cnn", "um_nn"):
        _stream_family(name, configs[name], served[name]["weights"],
                       served[name]["scorer_bf16"])
    _fixture_on_card()

    # ---- mm_cnn's forward split and its FLOP bounds
    split = {}
    work = _conv_work(configs["mm_cnn"])
    flops = sum(f for f, _ in work) * BATCH
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model = build_model(configs["mm_cnn"], dtype=dtype, device=DEVICE, seed=0)
        images = torch.from_numpy(trips[:BATCH]).to(DEVICE, dtype)
        sp = _conv_split(model, images)
        split[dname] = sp
        item = images.element_size()
        bounds = [_bound(b * item * BATCH, f * BATCH, dname) for f, b in work]
        print(f"  mm_cnn forward {dname} batch {BATCH}: {sp['forward']:.3f} ms = convs "
              + " + ".join(f"{sp[f'conv{i}']:.3f}" for i in range(4))
              + f" + everything else {sp['rest']:.3f}; the convs' FLOP bound "
              f"{flops / PEAK_OPS[dname] * 1e3:.3f} ms ({flops / 1e12:.3f} TFLOP), each "
              f"conv's bound " + " + ".join(f"{ms:.3f} ({by})" for ms, by in bounds)
              + f" = {sum(ms for ms, _ in bounds):.3f} ms, on {state['gpu']}", flush=True)
        print("    each conv on its channels_last view / after a copy to NCHW-contiguous / "
              "on the view with cudnn.benchmark: "
              + ", ".join(f"{sp[f'conv{i}_view']:.3f} / {sp[f'conv{i}_copy']:.3f} / "
                          f"{sp[f'conv{i}_tuned']:.3f}" for i in range(4)) + " ms", flush=True)
        del model, images
    torch.cuda.empty_cache()

    # ---- training: mm_cnn for 2 epochs; the two branches and frozen_fusion for 1
    tmp, data_dir = _smoke_split(state)
    out_root = os.path.join(tmp, "families")
    train_launches = 0
    mm = {**configs["mm_cnn"], "epochs": 2}
    result, secs, n = _train_family(mm, "mm_cnn", data_dir, out_root, "mm_cnn")
    train_launches += n["convnext_block_fused"]
    cfg = normalize_config(mm)
    model = build_model(cfg, device=DEVICE)
    model.load_state_dict(load_model_checkpoint(cfg, result["model_dir"]), strict=True)
    _, scores = predict_dataset(model, cfg, load_split(cfg, "val", data_dir))
    d = float(np.abs(scores - result["best_val_scores"]).max())
    check(d <= 1e-6, f"mm_cnn best_model.pth loads strict and scores the val split within "
                     f"1e-6 of the trainer's best epoch (max|d|={d:.3g})")
    export_cli([result["model_dir"], "--format", "saved_model", "--device", DEVICE])
    with open(os.path.join(result["model_dir"], "saved_model", "verification.json")) as f:
        sm = json.load(f)
    check(sm["close"] and sm["n"] == 16,
          f"mm_cnn cli.export --format saved_model: the TF SavedModel (convs, pools, folded "
          f"BatchNorm) verified against the card's f32 forward, close: true, max|d| = "
          f"{sm['max_diff']:.3g}")
    branch_dirs = {}
    for name in ("ConvNeXt", "um_nn"):
        r, _, n = _train_family(configs[name], name, data_dir, out_root, name)
        branch_dirs[name] = r["model_dir"]
        train_launches += n["convnext_block_fused"]
    fusion = {k: v for k, v in configs["frozen_fusion"].items()
              if k not in ("image_model_config", "meta_model_config")}
    fusion.update(image_model_dir=branch_dirs["ConvNeXt"], meta_model_dir=branch_dirs["um_nn"])
    r, fusion_secs, n = _train_family(fusion, "frozen_fusion", data_dir, out_root, "fusion")
    train_launches += n["convnext_block_fused"]
    check(_branches_kept(r, {"image_branch.": branch_dirs["ConvNeXt"],
                             "meta_branch.": branch_dirs["um_nn"]}),
          "frozen_fusion: every branch parameter bit-identical to its branch run's "
          "best_model.pth after training")

    # ---- mm_cnn train steps/s at batch 64 (information only)
    train = load_split(cfg, "train", data_dir)
    batch = (torch.from_numpy(train.images[:TRAIN_BATCH]).to(DEVICE),
             torch.from_numpy(train.metadata[:TRAIN_BATCH]).to(DEVICE),
             torch.from_numpy(train.labels[:TRAIN_BATCH]).to(DEVICE), train.pos_weight)
    step_ms = {}
    for dname in ("float32", "bfloat16"):
        c = normalize_config({**mm, "compute_dtype": dname})
        st = create_train_state(c, build_model(c, device=DEVICE), steps_per_epoch=64)
        step = make_train_step(c)
        step_ms[dname] = time_ms(lambda: step(st, *batch))
        print(f"  mm_cnn train step batch {TRAIN_BATCH} {dname}: {step_ms[dname]:.3f} ms = "
              f"{1e3 / step_ms[dname]:.1f} steps/s on {state['gpu']}", flush=True)
    state["families"] = {"launches": launches, "train_launches": train_launches,
                         "rates": rates, "split": split, "step_ms": step_ms,
                         "mm_cnn_cli_s": secs, "fusion_cli_s": fusion_secs}


# ------------------------------ phase 8 ------------------------------

MAXVIT_KIND = "maxvit_tiny_rw_224.sw_in1k"
MAXVIT_BATCH = {"bf16": 1024, "f32": 512}    # the 6.6 GB first MBConv map caps it
MAXVIT_ALERTS = 2 * MAXVIT_BATCH["bf16"] + 100
MAXVIT_HOST_ALERTS = 16                       # f32 on the card against the host
MAXVIT_SPLIT = (512, 256)                     # cli.train's train and val alerts
MAXVIT_TRAIN_BATCH = 32


def _maxvit_configs() -> dict:
    """mm_MaxViT as tests/test_maxvit_fullspec.py:24-35 builds it (metadata
    128/128, combined 64/32) and the image-only MaxViT with a 256/32 head,
    both maxvit_tiny_rw_224.sw_in1k at full depth, with the flagship's
    training settings at batch 32; um_nn (production widths) for the fusion."""
    train = {k: FLAGSHIP_CONFIG[k] for k in ("learning_rate", "beta_1", "beta_2",
                                             "warmup_epochs", "random_seed",
                                             "metadata_cols", "train_data_version")}
    train.update(batch_size=MAXVIT_TRAIN_BATCH, epochs=1, patience=5, pretrained=False)
    return {
        "mm_MaxViT": {"model_name": "mm_MaxViT", "model_kind": MAXVIT_KIND,
                      "meta_fc1_neurons": 128, "meta_fc2_neurons": 128,
                      "meta_dropout": 0.25, "comb_fc1_neurons": 64,
                      "comb_fc2_neurons": 32, "comb_dropout": 0.2, **train},
        "MaxViT": {"model_name": "MaxViT", "model_kind": MAXVIT_KIND, "fc1_neurons": 256,
                   "fc2_neurons": 32, "dropout": 0.2, **train},
        "um_nn": {**_family_configs()["um_nn"], "batch_size": MAXVIT_TRAIN_BATCH},
    }


def _maxvit_flops(model, images, meta) -> dict:
    """FLOPs of one forward by part (torch.utils.flop_counter, products and
    convs only): stem, MBConvs, attention (window + grid), MLPs, total."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    parts = {"stem": re.compile(r"\.stem$"), "MBConv": re.compile(r"blocks\.\d+\.conv$"),
             "attention": re.compile(r"attn_(block|grid)\.attn$"),
             "MLP": re.compile(r"attn_(block|grid)$")}
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model(images, meta)
    out = {k: 0 for k in parts}
    for name, ops in counter.get_flop_counts().items():
        for part, pattern in parts.items():
            if pattern.search(name):
                out[part] += sum(ops.values())
    out["MLP"] -= out["attention"]  # the halves less their attention: the MLPs
    out["total"] = counter.get_total_flops()
    return out


def _maxvit_split(sc, images, meta, iters: int = 5) -> dict:
    """ms of the scorer's forward split with CUDA events into the stem, the
    MBConvs, the attention (window + grid: qkv, the kernel, proj), the MLP
    halves (the attention halves less their attention: LN1, the residual,
    ``fused_ln_mlp``) and everything else (resize, pool, heads, sigmoid)."""
    import torch
    from btsbot_tpu_torch.models import maxvit as mx

    kinds = {mx.Stem: "stem", mx.MBConv: "MBConv", mx.RelPosAttention: "attention",
             mx.PartitionAttention: "MLP"}
    spans = {k: [] for k in kinds.values()}
    handles = []

    def pre(module, args):
        module._t0 = torch.cuda.Event(enable_timing=True)
        module._t0.record()

    def post(module, args, out):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        spans[kinds[type(module)]].append((module._t0, end))

    for _ in range(2):
        sc._score(images, meta)
    for module in sc.model.modules():
        if type(module) in kinds:
            handles += [module.register_forward_pre_hook(pre),
                        module.register_forward_hook(post)]
    whole = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    try:
        torch.cuda.synchronize()
        whole[0].record()
        for _ in range(iters):
            sc._score(images, meta)
        whole[1].record()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    out = {k: sum(a.elapsed_time(b) for a, b in v) / iters for k, v in spans.items()}
    out["forward"] = whole[0].elapsed_time(whole[1]) / iters
    out["rest"] = out["forward"] - sum(out[k] for k in kinds.values())
    out["MLP"] -= out["attention"]
    return out


def _maxvit_features(model, images):
    """The pooled final map of a MaxViT / mm_MaxViT (the head's input)."""
    from btsbot_tpu_torch.ops.resize import resize_bilinear

    backbone = model.maxvit_backbone if hasattr(model, "maxvit_backbone") else model.maxvit
    x = backbone.stem(resize_bilinear(images, model.image_size))
    for stage in backbone.stages:
        x = stage(x)
    return x.mean(dim=(1, 2))


def _serve_maxvit(name, config, trips, meta, state) -> dict:
    """f32 card against host on 16 alerts; both scorers (bf16 at batch 1,024,
    f32 at 512) on 2 × 1,024 + 100 alerts, their checks, rates and peak
    memory; the bf16 forward's split against each part's FLOP bound."""
    import numpy as np
    import torch
    from btsbot_tpu_torch import AlertScorer
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.models.factory import build_model

    cfg = normalize_config(config)
    meta = meta if cfg.need_metadata else None
    model = build_model(cfg, dtype=torch.float32, device=DEVICE, seed=0)
    _randomise(model, seed=1)
    weights = model.state_dict()

    # ---- f32 on the card against f32 on the host
    host = build_model(cfg, dtype=torch.float32, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in weights.items()}, strict=True)
    n = MAXVIT_HOST_ALERTS
    img = torch.from_numpy(trips[:n])
    m = None if meta is None else torch.from_numpy(meta[:n])
    with torch.inference_mode():
        got = [model(img.to(DEVICE), None if m is None else m.to(DEVICE)).cpu(),
               _maxvit_features(model, img.to(DEVICE)).cpu()]
        want = [host(img, m), _maxvit_features(host, img)]
    # a random MaxViT's logits move little from alert to alert, so the
    # pooled features (which do) are held too
    spread = float(want[1].std(dim=0).mean())
    print(f"  {name}: f32 card vs host on {n} alerts: logits max|d|="
          f"{float((got[0] - want[0]).abs().max()):.3g}, pooled features max|d|="
          f"{float((got[1] - want[1]).abs().max()):.3g} (their spread over alerts "
          f"{spread:.3g})", flush=True)
    check(all(bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5)) for a, b in zip(got, want))
          and spread > 1e-3,
          f"{name}: f32 logits and pooled features on the card within rtol 1e-4 / atol "
          f"1e-5 of the host's")
    del host

    # ---- both scorers
    scorers = {k: AlertScorer(cfg, weights, batch_size=b, device=DEVICE,
                              dtype=torch.bfloat16 if k == "bf16" else torch.float32)
               for k, b in MAXVIT_BATCH.items()}
    scores, memory, e2e = {}, {}, {}
    for k, sc in scorers.items():
        b = MAXVIT_BATCH[k]
        sc(trips[:b], None if meta is None else meta[:b])          # warm both buckets
        sc(trips[:100], None if meta is None else meta[:100])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scores[k] = sc(trips, meta)
        torch.cuda.synchronize()
        e2e[k] = len(trips) / (time.perf_counter() - t0)
        memory[k] = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(bool(np.all(np.isfinite(v))) and v.shape == (len(trips),)
              for v in scores.values()), f"{name}: finite scores from both scorers")
    d16 = float(np.abs(scores["bf16"] - scores["f32"]).max())
    print(f"  {name}: bf16 vs f32 scores on {len(trips)} alerts: max|d|={d16:.3g}",
          flush=True)
    check(d16 <= 0.01, f"{name}: bf16 scores within 0.01 of f32")
    rates = {k: sc.throughput(iters=5) for k, sc in scorers.items()}
    for k in scorers:
        print(f"  {name} AlertScorer {k} batch {MAXVIT_BATCH[k]}: {rates[k]:.1f} alerts/s on "
              f"device-resident inputs, {e2e[k]:.1f} alerts/s end to end, peak memory "
              f"{memory[k]:.2f} GiB (max_memory_allocated) on {state['gpu']}", flush=True)

    # ---- the bf16 forward by part, beside each part's FLOP bound
    b = MAXVIT_BATCH["bf16"]
    g = torch.Generator(device="cpu").manual_seed(0)
    images = torch.randn(b, 63, 63, 3, generator=g).to(DEVICE)
    meta_t = (None if meta is None
              else torch.randn(b, len(META_COLS), generator=g).to(DEVICE))
    split = _maxvit_split(scorers["bf16"], images, meta_t)
    try:
        host = build_model(cfg, dtype=torch.float32, device="cpu").eval()
        host.load_state_dict({k: v.cpu() for k, v in weights.items()}, strict=True)
        flops = _maxvit_flops(host, images[:1].cpu(),
                              None if meta_t is None else meta_t[:1].cpu())
    except Exception as e:  # noqa: BLE001 — information only
        print(f"  flop counter failed ({e!r}); bounds not measured", flush=True)
        flops = None
    parts = ("stem", "MBConv", "attention", "MLP")
    line = f"  {name} bf16 forward batch {b}: {split['forward']:.3f} ms = " + " + ".join(
        f"{p} {split[p]:.3f}" for p in parts) + f" + everything else {split['rest']:.3f}"
    if flops:
        line += ("; FLOP bound at 989 TFLOP/s " + ", ".join(
            f"{p} {flops[p] * b / PEAK_OPS['bfloat16'] * 1e3:.3f}" for p in parts)
            + f", whole {flops['total'] * b / PEAK_OPS['bfloat16'] * 1e3:.3f} ms "
            f"({flops['total'] / 1e9:.2f} GFLOP an alert)")
    print(line + f" on {state['gpu']}", flush=True)
    if name == "mm_MaxViT":
        try:
            _profile(lambda: scorers["bf16"]._score(images, meta_t),
                     f"{name} bf16 forward batch {b}", iters=3, top=16)
        except Exception as e:  # noqa: BLE001 — information only
            print(f"  profiler failed ({e!r}); not measured", flush=True)
    return {"model": model, "weights": weights, "rates": rates, "e2e": e2e,
            "memory": memory, "split": split, "flops": flops,
            "scorer_bf16": scorers["bf16"]}


def _host_vs_card_step(config, weights, batch) -> None:
    """One f32 train step of the same weights on the card and on the host,
    dropout and augmentation off: loss rtol 1e-4, running statistics 1e-5."""
    import torch
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.engine.state import create_train_state
    from btsbot_tpu_torch.engine.steps import make_train_step
    from btsbot_tpu_torch.models.factory import build_model

    cfg = normalize_config({**config, "meta_dropout": 0.0, "comb_dropout": 0.0,
                            "data_aug_h_flip": 0, "data_aug_v_flip": 0, "data_aug_rot": 0})
    out = {}
    for dev in (DEVICE, "cpu"):
        model = build_model(cfg, device=dev)
        model.load_state_dict({k: v.to(dev) for k, v in weights.items()}, strict=True)
        st = create_train_state(cfg, model, steps_per_epoch=1)
        m = make_train_step(cfg)(st, *(t.to(dev) for t in batch[:3]), batch[3])
        out[dev] = (m["loss"].item(), {k: v.detach().cpu() for k, v in
                                       model.state_dict().items() if "running_" in k})
    (loss_c, stats_c), (loss_h, stats_h) = out[DEVICE], out["cpu"]
    d = max(float((stats_c[k] - stats_h[k]).abs().max()) for k in stats_h)
    ok = all(torch.allclose(stats_c[k], stats_h[k], rtol=1e-5, atol=1e-5) for k in stats_h)
    print(f"  mm_MaxViT one f32 step on {len(batch[0])} alerts: loss {loss_c:.8f} card / "
          f"{loss_h:.8f} host; {len(stats_h)} running statistics, max|d|={d:.3g}",
          flush=True)
    check(abs(loss_c - loss_h) <= 1e-4 * abs(loss_h) and ok,
          "mm_MaxViT train step: card loss within rtol 1e-4 of the host's, running "
          "statistics within 1e-5")


MAXVIT_STAGES = [(56, 64), (28, 128), (14, 256), (7, 512)]  # side, C at 224
MAXVIT_ATTENTION_F32_BATCH = 256


def _attention_kernel_rows(state: dict) -> list:
    """The partition-attention kernel against its plain version at the four
    stage shapes, window and grid: bf16 at batch 3072 (rtol 2^-7, atol 2^-7
    of the largest |v|, as tests/test_torch_partition_attention.py holds it),
    f32 at batch 256 (rtol 1e-5 / atol 1e-5); ms of
    both beside the bound (qkv read and the output written once at 3.35 TB/s,
    or 4 · 49 · C operations a token at the type's peak)."""
    import torch
    from btsbot_tpu_torch.ops import partition_attention as pa

    rows = []
    for dname, batch in (("bfloat16", BATCH), ("float32", MAXVIT_ATTENTION_F32_BATCH)):
        dtype = getattr(torch, dname)
        for side, c in MAXVIT_STAGES:
            g = torch.Generator(device=DEVICE).manual_seed(side)
            qkv = torch.randn(batch, side, side, 3 * c, generator=g, device=DEVICE).to(dtype)
            table = torch.randn(169, c // 32, generator=g, device=DEVICE)
            item = qkv.element_size()
            tokens = batch * side * side
            work = ((4 * c * tokens + 169 * c // 32) * item, 4.0 * 49 * c * tokens)
            bound_ms, by = _bound(*work, "bfloat16" if dname == "bfloat16" else "float32")
            for grid in (False, True):
                with torch.inference_mode():
                    got = pa.partition_attention(qkv, table, 7, grid)
                    want = pa.partition_attention_reference(qkv, table, 7, grid)
                    torch.cuda.synchronize()
                    d = (got.float() - want.float()).abs()
                    # bf16: a probability or an output one bf16 step off moves an
                    # output by 2^-8 of the largest |v| or of itself; twice both
                    tol = ((2 ** -7, 2 ** -7 * float(qkv[..., 2 * c:].abs().max()))
                           if dname == "bfloat16" else (1e-5, 1e-5))
                    excess = d - tol[0] * want.float().abs()
                    ok, worst = bool((excess <= tol[1]).all()), float(d.max())
                    differ = float((d > 0).float().mean())
                    del got, want, d, excess
                    kernel = time_ms(lambda: pa.partition_attention(qkv, table, 7, grid))
                    plain = time_ms(lambda: pa.partition_attention_reference(qkv, table, 7,
                                                                             grid), iters=3)
                mode = "grid" if grid else "window"
                check(ok, f"partition_attention {dname} {mode} ({batch},{side},{side},{3 * c}) "
                          f"within rtol {tol[0]:.3g} / atol {tol[1]:.3g} of its plain version "
                          f"(max|d| {worst:.3g}, {100 * differ:.3f} % of outputs differ)")
                print(f"  partition_attention {dname} {mode} ({batch},{side},{side},{3 * c}): "
                      f"kernel {kernel:.4f} ms, plain {plain:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({by}; {100 * bound_ms / kernel:.1f} %), worst {worst:.3g} on "
                      f"{state['gpu']}", flush=True)
                rows.append({"dtype": dname, "mode": mode, "batch": batch, "side": side, "C": c,
                             "kernel_ms": kernel, "plain_ms": plain, "bound_ms": bound_ms,
                             "max_abs_err": worst})
            del qkv
            torch.cuda.empty_cache()
    return rows


# (input side, mid channels, stride) of maxvit_tiny's MBConvs at 224, one of each
MAXVIT_MBCONVS = [(112, 256, 2), (56, 256, 1), (56, 256, 2), (28, 512, 1), (28, 512, 2),
                  (14, 1024, 1), (14, 1024, 2), (7, 2048, 1)]
# the scorer's padded batches below 3072 (its ladder 3072 / 768 / 192), where
# the kernel is checked in both types; at 3072 it is checked in bf16, the
# serving type
MAXVIT_MBCONV_CHECK_BATCHES = (768, 192)
MAXVIT_MBCONV_CHUNK = 192  # images a call of the plain version: its copies of the map fit


def _mbconv_check(h, n1, taps, n2, stride, got, dname) -> float:
    """Checks the kernel's output ``got`` of the map h against the plain
    version, run MAXVIT_MBCONV_CHUNK images at a time (every image is its
    own: BatchNorm takes the running statistics); bf16 within 2^-6 relative
    / 2^-5 absolute (a few bf16 ulps of five rounding points, as
    tests/test_torch_mbconv_dw.py bounds them one by one), f32 rtol 1e-5 /
    atol 1e-5.  Returns the largest |difference|."""
    import torch
    from btsbot_tpu_torch.ops import mbconv_dw as mb

    tol = (2 ** -6, 2 ** -5) if dname == "bfloat16" else (1e-5, 1e-5)
    worst, beyond, differ = 0.0, 0, 0
    with torch.inference_mode():
        for i in range(0, h.shape[0], MAXVIT_MBCONV_CHUNK):
            want = mb.mbconv_dw_reference(h[i:i + MAXVIT_MBCONV_CHUNK], n1, taps, n2,
                                          stride).float()
            d = (got[i:i + MAXVIT_MBCONV_CHUNK].float() - want).abs()
            beyond += int((d > tol[1] + tol[0] * want.abs()).sum())
            differ += int((d > 0).sum())
            worst = max(worst, float(d.max()))
            del want, d
    b, side, _, mid = h.shape
    check(beyond == 0, f"mbconv_dw {dname} ({b},{side},{side},{mid}) stride {stride} within "
                       f"rtol {tol[0]:.3g} / atol {tol[1]:.3g} of its plain version (max|d| "
                       f"{worst:.3g}, {beyond} beyond, {100 * differ / got.numel():.3f} % "
                       f"differ)")
    return worst


def _mbconv_kernel_rows(state: dict) -> list:
    """The MBConv kernel against its plain version (``_mbconv_check``) at
    maxvit_tiny's eight MBConv shapes: both types at the scorer's batches 768
    and 192, bf16 at 3072 (the launch that is timed); ms at batch 3072 in
    bf16 of the kernel, the plain version (cuDNN's grouped conv and four
    eager passes), cuDNN's depthwise conv alone (the yardstick,
    ``library_ms``) and the bound (the input map read once, the output
    written once, the taps and the BN vectors, at 3.35 TB/s)."""
    import torch
    import torch.nn.functional as F
    from btsbot_tpu_torch.ops import mbconv_dw as mb

    def draw(batch, side, mid, dtype):
        g = torch.Generator(device=DEVICE).manual_seed(side * mid + batch)
        h = torch.randn(batch, side, side, mid, generator=g, device=DEVICE).to(dtype)
        norms = []
        for _ in range(2):
            mean = 0.5 * torch.randn(mid, generator=g, device=DEVICE)
            var = 0.5 + torch.rand(mid, generator=g, device=DEVICE)
            weight = 1 + 0.3 * torch.randn(mid, generator=g, device=DEVICE)
            bias = mean * weight / torch.sqrt(var + mb.BN_EPS) + 0.5  # GELU(BN(0)) != 0
            norms.append((mean, var, weight, bias))
        taps = torch.randn(mid, 1, 3, 3, generator=g, device=DEVICE) / 3
        return h, norms[0], taps, norms[1]

    rows = []
    for side, mid, stride in MAXVIT_MBCONVS:
        out_side = (side - 1) // stride + 1
        worst = 0.0
        for batch in MAXVIT_MBCONV_CHECK_BATCHES:
            for dname in ("bfloat16", "float32"):
                h, n1, taps, n2 = draw(batch, side, mid, getattr(torch, dname))
                with torch.inference_mode():
                    got = mb.mbconv_dw(h, n1, taps, n2, stride)
                worst = max(worst, _mbconv_check(h, n1, taps, n2, stride, got, dname))
                del h, got
        h, n1, taps, n2 = draw(BATCH, side, mid, torch.bfloat16)
        bytes_moved = (BATCH * (side * side + out_side * out_side) * mid * 2 + 9 * mid * 2
                       + 4 * mid * 4)
        bound_ms, _ = _bound(bytes_moved, 18.0 * BATCH * out_side * out_side * mid, "bfloat16")
        with torch.inference_mode():
            kernel = time_ms(lambda: mb.mbconv_dw(h, n1, taps, n2, stride))
            got = mb.mbconv_dw(h, n1, taps, n2, stride)  # the timed launch, once more
        worst = max(worst, _mbconv_check(h, n1, taps, n2, stride, got, "bfloat16"))
        del got
        nchw = h.permute(0, 3, 1, 2)
        w16 = taps.to(torch.bfloat16)
        with torch.inference_mode():
            plain = time_ms(lambda: mb.mbconv_dw_reference(h, n1, taps, n2, stride), iters=3)
            library = time_ms(lambda: F.conv2d(nchw, w16, None, stride, 1, 1, mid), iters=3)
        print(f"  mbconv_dw bf16 ({BATCH},{side},{side},{mid}) stride {stride}: kernel "
              f"{kernel:.4f} ms, plain {plain:.4f} ms, library (cuDNN depthwise alone) "
              f"{library:.4f} ms, bound {bound_ms:.4f} ms ({100 * bound_ms / kernel:.1f} %) "
              f"on {state['gpu']}", flush=True)
        rows.append({"side": side, "mid": mid, "stride": stride, "batch": BATCH,
                     "kernel_ms": kernel, "plain_ms": plain, "library_ms": library,
                     "bound_ms": bound_ms, "max_abs_err": worst})
        del h, nchw
        torch.cuda.empty_cache()
    return rows


def _maxvit_entries(state: dict) -> list:
    """The kernels line's entries of MaxViT's two kernels, which replace no
    Pallas kernel: one maxvit_tiny forward's launches at batch 3072 in bf16
    (the serving type), each shape's time × the launches of it a forward,
    and the launches phase "maxvit" counted."""
    from btsbot_tpu_torch.models.maxvit import maxvit_spec

    # a stage's blocks by its side: two attention launches each, and an
    # MBConv each, the first at stride 2 from the side before
    depths = dict(zip((56, 28, 14, 7), maxvit_spec(MAXVIT_KIND)["depths"]))
    att = [(r, depths[r["side"]]) for r in state["maxvit_attention"] if r["dtype"] == "bfloat16"]
    mb = [(r, 1 if r["stride"] == 2 else depths[r["side"]] - 1) for r in state["maxvit_mbconv"]]
    launches = state["maxvit_launches"]
    entries = []
    for name, source, rows, per_forward, library in (
            ("partition_attention", "partition_attention.cu", att, 22, False),
            ("mbconv_dw", "mbconv_dw.cu", mb, 11, True)):
        def total(key):
            return sum(r[key] * n for r, n in rows)
        check(sum(n for _, n in rows) == per_forward,
              f"{name}: the rows cover a forward's {per_forward} launches")
        entries.append({
            "name": name, "route": "cuda", "source": f"btsbot_tpu_torch/csrc/{source}",
            "replaces": "no Pallas counterpart (btsbot_tpu/models/maxvit.py leaves it to XLA)",
            "launches": launches[name]["total"],
            "launches_by_path": {"MaxViT / mm_MaxViT serving and the mm_MaxViT stream":
                                 launches[name]["serving"]},
            "launches_a_forward": per_forward,
            "max_abs_err": max(r["max_abs_err"] for r, _ in rows),
            "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
            "library_ms": total("library_ms") if library else None,
            "bound_ms": total("bound_ms"), "bound_by": "bytes",
            "per": f"one maxvit_tiny forward at batch {BATCH}, bfloat16 ({per_forward} "
                   f"launches)" + ("; library_ms: cuDNN's depthwise conv alone" if library
                                   else "")})
    return entries


def phase_maxvit(state: dict) -> None:
    """MaxViT / mm_MaxViT at maxvit_tiny_rw_224 (the attention core on
    ``csrc/partition_attention.cu``, the MLP halves on ``fused_ln_mlp``):
    the attention kernel alone, serving, training, a fusion over a MaxViT run
    and the 224 → 160 retarget."""
    import numpy as np
    import torch
    from btsbot_tpu_torch import AlertScorer
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.data.dataset import load_split
    from btsbot_tpu_torch.engine.checkpoint import load_model_checkpoint
    from btsbot_tpu_torch.engine.eval import predict_dataset
    from btsbot_tpu_torch.engine.state import create_train_state
    from btsbot_tpu_torch.engine.steps import make_train_step
    from btsbot_tpu_torch.models.factory import build_model
    from btsbot_tpu_torch.models.maxvit import maxvit_spec

    configs = _maxvit_configs()
    # unit-normal pixels, as tests/test_maxvit_fullspec.py draws them: at the
    # L2-normalised scale (~1/63) a random-weight MaxViT's logits barely move
    trips = np.random.default_rng(31).normal(size=(MAXVIT_ALERTS, 63, 63, 3)).astype(
        np.float32)
    meta = np.random.default_rng(32).normal(size=(MAXVIT_ALERTS, len(META_COLS))).astype(
        np.float32)
    maxvit_kernels = ("convnext_block_fused", "fused_ln_mlp", "partition_attention",
                      "mbconv_dw")

    state["maxvit_attention"] = _attention_kernel_rows(state)
    state["maxvit_mbconv"] = _mbconv_kernel_rows(state)
    mark = _launches(by=4)
    served = {name: _serve_maxvit(name, configs[name], trips, meta, state)
              for name in ("mm_MaxViT", "MaxViT")}
    _stream_family("mm_MaxViT", configs["mm_MaxViT"], served["mm_MaxViT"]["weights"],
                   served["mm_MaxViT"]["scorer_bf16"], batch=MAXVIT_BATCH["bf16"])
    serving = _launches(mark, kernels=maxvit_kernels)
    check(serving["convnext_block_fused"] == 0 and serving["fused_ln_mlp"] > 0
          and serving["fused_ln_mlp"] == serving["partition_attention"]
          and serving["fused_ln_mlp"] % 22 == 0
          and 2 * serving["mbconv_dw"] == serving["fused_ln_mlp"],
          f"MaxViT serving launches no block kernel and 22 partition_attention, 22 "
          f"fused_ln_mlp and 11 mbconv_dw launches a forward ({serving})")

    # ---- training
    tmp, _ = _smoke_split(state)
    data_dir = os.path.join(tmp, "maxvit_data")
    os.makedirs(data_dir, exist_ok=True)
    _write_split(data_dir, "train", MAXVIT_SPLIT[0], seed=33)
    _write_split(data_dir, "val", MAXVIT_SPLIT[1], seed=34)
    cfg = normalize_config(configs["mm_MaxViT"])
    train = load_split(cfg, "train", data_dir)
    n = 8
    batch = (torch.from_numpy(train.images[:n]), torch.from_numpy(train.metadata[:n]),
             torch.from_numpy(train.labels[:n]), train.pos_weight)
    _host_vs_card_step(configs["mm_MaxViT"], served["mm_MaxViT"]["weights"], batch)

    out_root = os.path.join(tmp, "maxvit_runs")
    runs = {}
    for name in ("mm_MaxViT", "MaxViT", "um_nn"):
        runs[name] = _train_family(configs[name], name, data_dir, out_root, name,
                                   alerts=MAXVIT_SPLIT)
    mm_result, mm_secs, _ = runs["mm_MaxViT"]
    model = build_model(cfg, device=DEVICE)
    model.load_state_dict(load_model_checkpoint(cfg, mm_result["model_dir"]), strict=True)
    _, scores = predict_dataset(model, cfg, load_split(cfg, "val", data_dir))
    d = float(np.abs(scores - mm_result["best_val_scores"]).max())
    check(d <= 1e-6, f"mm_MaxViT best_model.pth loads strict and scores the val split "
                     f"within 1e-6 of the trainer's best epoch (max|d|={d:.3g})")
    b = MAXVIT_TRAIN_BATCH
    step_batch = tuple(torch.from_numpy(x[:b]).to(DEVICE) for x in
                       (train.images, train.metadata, train.labels)) + (train.pos_weight,)
    step_ms = {}
    for dname in ("float32", "bfloat16"):
        c = normalize_config({**configs["mm_MaxViT"], "compute_dtype": dname})
        m = build_model(c, device=DEVICE)
        m.load_state_dict(served["mm_MaxViT"]["weights"])
        st = create_train_state(c, m, steps_per_epoch=16)
        step = make_train_step(c)
        step_ms[dname] = time_ms(lambda: step(st, *step_batch), iters=5, warmup=2)
        print(f"  mm_MaxViT train step batch {b} {dname}: {step_ms[dname]:.3f} ms = "
              f"{1e3 / step_ms[dname]:.2f} steps/s, {b * 1e3 / step_ms[dname]:.1f} "
              f"alerts/s on {state['gpu']}", flush=True)
        del st, m
    print(f"  mm_MaxViT cli.train 1 epoch ({MAXVIT_SPLIT[0] // b} steps + "
          f"{-(-MAXVIT_SPLIT[1] // b)} eval batches): {mm_secs:.1f} s", flush=True)

    # ---- frozen_fusion over the MaxViT and um_nn runs
    fusion = {k: v for k, v in _family_configs()["frozen_fusion"].items()
              if k not in ("image_model_config", "meta_model_config")}
    fusion.update(image_model_dir=runs["MaxViT"][0]["model_dir"],
                  meta_model_dir=runs["um_nn"][0]["model_dir"],
                  batch_size=MAXVIT_TRAIN_BATCH)
    r, fusion_secs, _ = _train_family(fusion, "frozen_fusion over MaxViT", data_dir,
                                      out_root, "fusion_maxvit", alerts=MAXVIT_SPLIT)
    check(_branches_kept(r, {"image_branch.": runs["MaxViT"][0]["model_dir"],
                             "meta_branch.": runs["um_nn"][0]["model_dir"]}),
          "frozen_fusion over MaxViT: every branch parameter bit-identical to its branch "
          "run's best_model.pth after training")

    # ---- the 224 checkpoint retargeted to 160
    cfg160 = normalize_config({**configs["mm_MaxViT"],
                               "model_kind": "maxvit_tiny_rw_160.sw_in1k"})
    sd160 = load_model_checkpoint(cfg160, mm_result["model_dir"])
    key = "maxvit_backbone.stages.0.blocks.0.attn_block.attn.rel_pos.relative_position_bias_table"
    sc160 = AlertScorer(cfg160, sd160, batch_size=MAXVIT_BATCH["bf16"], device=DEVICE)
    s160 = sc160(trips[:500], meta[:500])  # a full batch bucket and a partial one
    rate160 = sc160.throughput(iters=5)
    print(f"  retarget 224 -> 160: bias table {tuple(sd160[key].shape)}; bf16 "
          f"{rate160:.1f} alerts/s at batch {MAXVIT_BATCH['bf16']} (224: "
          f"{served['mm_MaxViT']['rates']['bf16']:.1f}) on {state['gpu']}", flush=True)
    heads = maxvit_spec(MAXVIT_KIND)["dims"][0] // 32
    check(tuple(sd160[key].shape) == (81, heads) and s160.shape == (len(trips[:500]),)
          and bool(np.all(np.isfinite(s160))),
          "the 224 best_model.pth loads into maxvit_tiny_rw_160 (tables resampled to "
          "window 5) and gives finite scores")
    state["maxvit"] = {name: {k: v for k, v in sv.items()
                              if k in ("rates", "e2e", "memory", "split", "flops")}
                       for name, sv in served.items()}
    state["maxvit"]["train"] = {"step_ms": step_ms, "cli_s": mm_secs,
                                "fusion_cli_s": fusion_secs, "rate160": rate160}
    total = _launches(mark, kernels=maxvit_kernels)
    state["maxvit_launches"] = {k: {"serving": serving[k], "total": total[k]}
                                for k in ("partition_attention", "mbconv_dw")}


# ------------------------------ phase 9 ------------------------------

INCEPTION_KINDS = ("inceptionnext_pico", "inceptionnext_pico.r2")


def _ln_mlp_share(sc, iters: int = 10) -> tuple:
    """(forward ms, ms in the 12 fused_ln_mlp launches) of the scorer's bf16
    forward on device-resident inputs, with CUDA events."""
    import torch
    from btsbot_tpu_torch.ops import ln_mlp as port_ln_mlp

    g = torch.Generator(device="cpu").manual_seed(0)
    images = torch.randn(BATCH, 63, 63, 3, generator=g).to(DEVICE)
    meta = torch.randn(BATCH, len(META_COLS), generator=g).to(DEVICE)
    launch, spans = port_ln_mlp._launch_ln_mlp, []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args)
        end.record()
        spans.append((start, end))
        return out

    for _ in range(3):
        sc._score(images, meta)
    whole = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    port_ln_mlp._launch_ln_mlp = timed
    try:
        torch.cuda.synchronize()
        whole[0].record()
        for _ in range(iters):
            sc._score(images, meta)
        whole[1].record()
        torch.cuda.synchronize()
    finally:
        port_ln_mlp._launch_ln_mlp = launch
    check(len(spans) == 12 * iters, "12 fused_ln_mlp launches per timed forward")
    return (whole[0].elapsed_time(whole[1]) / iters,
            sum(a.elapsed_time(b) for a, b in spans) / iters)


def phase_inceptionnext(state: dict) -> None:
    """mm_ConvNeXt with the InceptionNeXt mixer (pico, and the .r2 student),
    every block's LN → MLP half in the fused_ln_mlp kernel: both scorers,
    the kernel's share of the bf16 forward, and cli.train for .r2."""
    import numpy as np

    configs = {kind: _train_config(model_kind=kind, epochs=1) for kind in INCEPTION_KINDS}
    trips = _normalised_triplets(FAMILY_ALERTS, seed=41)
    meta = np.random.default_rng(42).normal(size=(FAMILY_ALERTS, len(META_COLS))).astype(
        np.float32)
    launches, rates, shares = {}, {}, {}
    for kind, config in configs.items():
        served = _serve_family(kind, config, trips, meta)
        launches[f"mm_ConvNeXt {kind} serving"] = served["launches"]["fused_ln_mlp"]
        rates[kind] = served["rates"]
        total, ln_mlp = _ln_mlp_share(served["scorer_bf16"])
        shares[kind] = (total, ln_mlp)
        print(f"  mm_ConvNeXt {kind} bf16 forward at batch {BATCH}: {total:.3f} ms = 12 "
              f"fused_ln_mlp launches {ln_mlp:.3f} ms ({100 * ln_mlp / total:.1f} %) + "
              f"everything else {total - ln_mlp:.3f} ms ({BATCH / total * 1e3:.0f} alerts/s) "
              f"on {state['gpu']}", flush=True)
    tmp, data_dir = _smoke_split(state)
    r2 = INCEPTION_KINDS[1]
    _, secs, counts = _train_family(configs[r2], r2, data_dir, os.path.join(tmp, "inception"),
                                    "inceptionnext_r2")
    state["inceptionnext"] = {"launches": launches, "train_launches": counts["fused_ln_mlp"],
                              "rates": rates, "shares": shares, "cli_s": secs}


# ------------------------------ widths ------------------------------

WIDTH_SIZES = ("atto", "femto", "nano", "tiny", "small", "base")
WIDTHS_BATCH = 256           # the kernels against their plain versions
WIDTHS_MODEL_BATCH = 64      # a forward and a train step of each size
WIDTHS_INCEPTION = ("inceptionnext_atto", "inceptionnext_base")
WIDTH_FORWARD_LAUNCHES: dict = {}  # kind -> (kernel, launches in its forward)


def _stage_shapes(kind: str) -> list:
    """(side, C, depth) of each stage of a ConvNeXt kind at 63×63 input."""
    from btsbot_tpu_torch.models.convnext import convnext_spec
    spec = convnext_spec(kind)
    return list(zip((15, 7, 3, 1), spec["dims"], spec["depths"]))


def _check_kernel(name, fn, ref, args, dname, work, results, key, where) -> None:
    """One kernel call against its plain version on the same inputs; its
    time, the plain version's and the bound of ``work`` (bytes, the
    products' operations, the taps') go to ``results[key]`` with ``where``
    (size and shape)."""
    import torch
    with torch.inference_mode():
        got = fn(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **TOL[dname])
        ms = time_ms(lambda: fn(*args), iters=5, warmup=1)
        plain_ms = time_ms(lambda: ref(*args), iters=5, warmup=1)
    row = _timed_row(dname, work, **where, max_abs_err=err, ms=ms, plain_ms=plain_ms)
    results.setdefault(key, []).append(row)
    check(ok, f"{name}: max|d|={err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}){_f32_note(row)}")


def _width_kernels(size: str, results: dict, batch: int = WIDTHS_BATCH,
                   ratios: tuple = (4, 2, 3)) -> None:
    """Both kernels against their plain versions at one ConvNeXt size's four
    stage shapes at ``batch``, f32 and bf16; fused_ln_mlp at hidden ``ratios``
    times C; a ragged batch and a ragged row count."""
    import torch
    from btsbot_tpu_torch.ops import _build
    from btsbot_tpu_torch.ops.convnext_block import (
        convnext_block_fused, convnext_block_reference, depthwise_conv7_reference)
    from btsbot_tpu_torch.ops.ln_mlp import fused_ln_mlp, ln_mlp_reference

    lib = _build.library()
    for side, c, depth in _stage_shapes(f"convnext_{size}"):
        m = batch * side * side
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            item = dtype.itemsize
            x, p = _block_inputs(side, c, dtype, seed=c, batch=batch)
            variant = _build.kernel_variant(c, 4 * c, dtype)
            w_bytes = sum(t.numel() for t in p) * item
            tag = f"{size} C={c} ({batch},{side},{side}) {dname} {variant}"
            where = {"size": size, "shape": [batch, side, side, c], "depth": depth}
            _check_kernel(f"convnext_block_fused {tag}", convnext_block_fused,
                          convnext_block_reference, (x, *p), dname,
                          (2 * m * c * item + w_bytes, 16 * m * c * c, 2 * 49 * m * c),
                          results, ("convnext_block_fused", c, 4 * c), dict(where, variant=variant))
            h = depthwise_conv7_reference(x, p[0], p[1]).reshape(-1, c)
            res = x.reshape(-1, c)
            for ratio in ratios:
                q = p[2:] if ratio == 4 else _block_inputs(
                    side, c, dtype, seed=c + ratio, batch=1, ratio=ratio)[1][2:]
                hid = ratio * c
                v_hid = _build.kernel_variant(c, hid, dtype)
                _check_kernel(
                    f"fused_ln_mlp {tag} hidden {ratio}C ({v_hid})",
                    fused_ln_mlp, ln_mlp_reference, (h, res, *q), dname,
                    (3 * m * c * item + sum(t.numel() for t in q) * item, 4 * m * c * hid, 0),
                    results, ("fused_ln_mlp", c, hid), dict(where, variant=v_hid))
            # ragged: a partial batch, and rows one past a tile edge
            tm = (lib.btsbot_tf32x3_rows(c) if variant == "tf32x3"
                  else lib.btsbot_tile_rows(c))
            mr = min(3 * tm + 1, m)
            with torch.inference_mode():
                xr = x[:7].contiguous()
                ok = torch.allclose(convnext_block_fused(xr, *p).float(),
                                    convnext_block_reference(xr, *p).float(), **TOL[dname])
                ok &= torch.allclose(fused_ln_mlp(h[:mr], res[:mr], *p[2:]).float(),
                                     ln_mlp_reference(h[:mr], res[:mr], *p[2:]).float(),
                                     **TOL[dname])
                torch.cuda.synchronize()
            check(tm > 0 and ok, f"both kernels at a ragged size ({tag}, block B=7, "
                                 f"ln_mlp M={mr}, tile {tm} rows)")
            del x, p, h, res
        torch.cuda.empty_cache()


# shapes off the model kinds' paths (batch, side, C, hidden / C): a C = 640
# map wider than 1x1 (the taps' weights read from device memory), C = 520 (a
# 64-channel slab wholly past C, a partial hidden chunk), C = 1000 at 3x3,
# maps too wide for the input tile at small C, and few rows at C > 512 (64
# and 1: the float32 kernels split the hidden chunks over blocks there)
ODD_SHAPES = [(5, 7, 640, 4), (4, 5, 520, 3), (3, 3, 1000, 4), (2, 56, 40, 4), (1, 112, 96, 4),
              (64, 1, 768, 4), (1, 1, 1024, 4)]


def _odd_shapes() -> None:
    """Both kernels against their plain versions at ODD_SHAPES: bf16 on the
    wgmma_any kernels, f32 on the tf32x3 kernels."""
    import torch
    from btsbot_tpu_torch.ops import _build
    from btsbot_tpu_torch.ops.convnext_block import (
        convnext_block_fused, convnext_block_reference, depthwise_conv7_reference)
    from btsbot_tpu_torch.ops.ln_mlp import fused_ln_mlp, ln_mlp_reference

    lib = _build.library()
    for (b, side, c, ratio), dtype in [(shape, dt) for shape in ODD_SHAPES
                                       for dt in (torch.bfloat16, torch.float32)]:
        dname = str(dtype).split(".")[-1]
        variant = "wgmma_any" if dtype == torch.bfloat16 else "tf32x3"
        tiled = (lib.btsbot_block_tiles_input if variant == "wgmma_any"
                 else lib.btsbot_tf32x3_tiles_input)(c, side, side)
        x, p = _block_inputs(side, c, dtype, seed=c + side, batch=b, ratio=ratio)
        hid = ratio * c
        h = depthwise_conv7_reference(x, p[0], p[1]).reshape(-1, c)
        res = x.reshape(-1, c)
        with torch.inference_mode():
            got, want = convnext_block_fused(x, *p).float(), convnext_block_reference(x, *p).float()
            d_block = (got - want).abs().max().item()
            ok = torch.allclose(got, want, **TOL[dname])
            got, want = (fused_ln_mlp(h, res, *p[2:]).float(),
                         ln_mlp_reference(h, res, *p[2:]).float())
            d_mlp = (got - want).abs().max().item()
            ok &= torch.allclose(got, want, **TOL[dname])
            torch.cuda.synchronize()
        check(_build.kernel_variant(c, hid, dtype) == variant and ok,
              f"both {variant} kernels match at ({b},{side},{side},{c}) hidden {hid} "
              f"(input tile {'kept' if tiled else 'not kept'}, max|d| block "
              f"{d_block:.3g}, fused_ln_mlp {d_mlp:.3g})")


def _width_model(kind: str, train: bool) -> None:
    """One f32 forward of mm_ConvNeXt with ``kind`` at batch 64 against the
    plain model (every block launched once), and with ``train`` one f32
    train step through the kernels against one through the plain blocks."""
    import numpy as np
    import torch
    from btsbot_tpu_torch.models.factory import build_model

    config = _train_config(model_kind=kind)
    n = WIDTHS_MODEL_BATCH
    depth = sum(d for _, _, d in _stage_shapes(kind))
    kernel = "fused_ln_mlp" if "inception" in kind else "convnext_block_fused"
    model = build_model(config, dtype=torch.float32, device=DEVICE, seed=0)
    _randomise(model, seed=1)
    model.eval()
    images = torch.from_numpy(_normalised_triplets(n, seed=51)).to(DEVICE)
    meta = torch.from_numpy(np.random.default_rng(52).normal(
        size=(n, len(META_COLS))).astype(np.float32)).to(DEVICE)
    with torch.inference_mode():
        torch.cuda.synchronize()
        mark = _launches(by=4)
        got = model(images, meta).reshape(-1)
        torch.cuda.synchronize()
        counts = _launches(mark)
        with _plain_ops():
            want = model(images, meta).reshape(-1)
    dl = (got - want).abs().max().item()
    ds = (torch.sigmoid(got) - torch.sigmoid(want)).abs().max().item()
    print(f"  {kind} f32 forward, batch {n}: launches {counts}; logits in "
          f"[{want.min().item():.3g}, {want.max().item():.3g}], max|d| logits {dl:.3g}, "
          f"scores {ds:.3g}", flush=True)
    check(counts[kernel] == depth and sum(counts.values()) == depth,
          f"{kind}: {depth} {kernel} launches a forward (sum of depths)")
    WIDTH_FORWARD_LAUNCHES[kind] = (kernel, depth)
    check(ds <= 1e-5 and torch.allclose(got, want, rtol=1e-4, atol=1e-5),
          f"{kind}: f32 scores within 1e-5 (logits rtol 1e-4 / atol 1e-5) of the plain "
          f"model")
    if not train:
        return
    labels = torch.from_numpy((np.arange(n) % 3 == 0).astype(np.float32)).to(DEVICE)
    batch = (images, meta, labels, 2.0)
    weights = model.state_dict()
    loss_k, grads_k, n_k = _one_step(config, weights, batch)
    with _plain_ops():
        loss_p, grads_p, n_p = _one_step(config, weights, batch)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    worst, worst_name = max(
        ((grads_k[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), k)
        for k, g in grads_p.items())
    print(f"  {kind} f32 train step: loss {loss_k:.8f} kernel / {loss_p:.8f} plain "
          f"(rel {rel:.3g}); worst gradient max|d|/max|g| = {worst:.3g} ({worst_name})",
          flush=True)
    check(n_k == depth and n_p == 0, f"{kind}: {depth} block launches a train step")
    check(rel <= 1e-6 and worst <= 1e-4, f"{kind}: train-step loss within rtol 1e-6 and "
                                         f"every gradient within 1e-4 of its largest entry")


def phase_widths(state: dict) -> None:
    """Both kernels at every ConvNeXt width (Queue C1): the stage shapes of
    atto, femto, nano, tiny, small and base against the plain versions (and
    nano's at the serving batch), one f32 forward of each size against the
    plain model, a train step at atto and base, and InceptionNeXt atto and
    base."""
    results: dict = {}
    for size in WIDTH_SIZES:
        _width_kernels(size, results)
    state["nano_results"] = {}
    _width_kernels("nano", state["nano_results"], batch=BATCH, ratios=(4,))
    _odd_shapes()
    for size in WIDTH_SIZES:
        _width_model(f"convnext_{size}", train=size in ("atto", "base"))
    for kind in WIDTHS_INCEPTION:
        _width_model(kind, train=False)
    state["width_results"] = results


# ------------------------------ nano ------------------------------

# mm_ConvNeXt with the JAX package's default backbone: a config without
# model_kind gets convnext_nano.d1h_in1k (dims 80 / 160 / 320 / 640, depths
# 2 / 2 / 8 / 2: 14 block launches a batch, none at a tuned width)
NANO_CONFIG = {k: v for k, v in FLAGSHIP_CONFIG.items() if k != "model_kind"}
NANO_LAUNCHES = 14


def phase_nano(state: dict) -> None:
    """mm_ConvNeXt-nano served in bf16 and f32 through AlertScorer at batch
    3072 (14 block launches a batch, f32 within 1e-5 of the plain model,
    bf16 within 0.01 of f32), and the bf16 forward split into its 14 block
    launches and everything else."""
    import numpy as np
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.models.convnext import convnext_spec

    kind = normalize_config(NANO_CONFIG).model_kind
    spec = convnext_spec(kind)
    check(kind == "convnext_nano.d1h_in1k" and list(spec["dims"]) == [80, 160, 320, 640]
          and sum(spec["depths"]) == NANO_LAUNCHES,
          f"a config without model_kind builds {kind} (80 / 160 / 320 / 640, 14 blocks)")
    trips = _normalised_triplets(FAMILY_ALERTS, seed=61)
    meta = np.random.default_rng(62).normal(size=(FAMILY_ALERTS, len(META_COLS))).astype(
        np.float32)
    served = _serve_family("mm_ConvNeXt-nano", NANO_CONFIG, trips, meta,
                           per_batch=NANO_LAUNCHES)
    total, blocks = _block_split(served["scorer_bf16"], NANO_LAUNCHES)
    state["nano"] = {"launches": served["launches"]["convnext_block_fused"],
                     "rates": served["rates"], "split": (total, blocks)}
    print(f"  mm_ConvNeXt-nano bf16 forward at batch {BATCH}: {total:.3f} ms = "
          f"{NANO_LAUNCHES} block launches {blocks:.3f} ms + everything else "
          f"{total - blocks:.3f} ms ({BATCH / total * 1e3:.0f} alerts/s) on {state['gpu']}",
          flush=True)


# ------------------------------ daemon ------------------------------

DAEMON_SYNTHETIC = 20000     # the saturated source
DAEMON_AVRO = 8192           # packets in the Avro OCF archive
# the trickle: bursts of TRICKLE_BURST alerts every TRICKLE_PERIOD_S seconds
# (2,000 alerts/s for 5 s).  A steady 2,000 alerts/s never leaves the queue
# empty for the daemon's 50 ms idle poll, so its idle drain shows between
# bursts: each batch is finished while the source is idle, before the next
# burst, instead of when the next batch is launched.
TRICKLE_BURST, TRICKLE_PERIOD_S, TRICKLE_BURSTS = 2000, 1.0, 5
TRICKLE_WAIT_MS = 100.0


def _serve_cli(args: list, out: str) -> tuple:
    """``cli.serve.main`` in-process, results to ``out``: (stats, result
    rows, its stderr, block-kernel launches)."""
    import contextlib
    import io
    import torch
    from btsbot_tpu_torch.cli.serve import main as serve_main

    err = io.StringIO()
    torch.cuda.synchronize()
    mark = _launches(by=4)
    with contextlib.redirect_stderr(err):
        stats = serve_main(args + ["--out", out, "--device", DEVICE])
    torch.cuda.synchronize()
    launches = _launches(mark)["convnext_block_fused"]
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    return stats, rows, err.getvalue(), launches


def _corrupt_avro(path: str, seed: int) -> list:
    """A ``synthetic_avro_ocf`` archive of DAEMON_AVRO packets written to
    ``path`` with some stamps corrupt (not gzip, an all-NaN science
    cutout, an all-zero template, a missing difference); returns its
    records as the daemon reads them."""
    import numpy as np
    from btsbot_tpu_torch.data.avro import read_ocf, write_ocf
    from btsbot_tpu_torch.data.fits import write_fits_image
    from btsbot_tpu_torch.data.synthetic import synthetic_avro_ocf

    schema, records = read_ocf(synthetic_avro_ocf(DAEMON_AVRO, META_COLS, seed=seed))
    nan = gzip.compress(write_fits_image(np.full((63, 63), np.nan, np.float32)))
    zero = gzip.compress(write_fits_image(np.zeros((63, 63), np.float32)))
    for k, i in enumerate(range(5, DAEMON_AVRO, 997)):
        rec = records[i]
        if k % 4 == 0:
            rec["cutoutScience"]["stampData"] = b"not a gzip stream"
        elif k % 4 == 1:
            rec["cutoutScience"]["stampData"] = nan
        elif k % 4 == 2:
            rec["cutoutTemplate"]["stampData"] = zero
        else:
            rec["cutoutDifference"] = None
    with open(path, "wb") as f:
        f.write(write_ocf(schema, records, codec="deflate", block_records=64))
    return records


def phase_daemon(state: dict) -> None:
    """The broker daemon (``cli.serve``) on the flagship run of phase 6 at
    batch 3072: a saturated synthetic source, an Avro OCF archive with
    corrupt stamps (f32 and bf16 pixel transfer), a trickle source for the
    idle drain, and ``stop()`` mid-stream."""
    import numpy as np
    import threading
    import torch
    from btsbot_tpu_torch.engine.checkpoint import load_run_dir
    from btsbot_tpu_torch.engine.serve import AlertStreamConsumer, AlertStreamScorer
    from btsbot_tpu_torch.data.synthetic import synthetic_packets

    run_dir = state["flagship_run"]
    tmp, _ = _smoke_split(state)
    out = os.path.join(tmp, "daemon.jsonl")
    config, weights = load_run_dir(run_dir)
    check(config["model_kind"] == FLAGSHIP_CONFIG["model_kind"],
          f"the daemon serves the flagship run {run_dir}")
    base = [run_dir, "--batch", str(BATCH)]
    results = {}

    # ---- saturated: N synthetic packets
    stats, rows, err, launches = _serve_cli(base + ["--synthetic", str(DAEMON_SYNTHETIC)],
                                            out)
    from btsbot_tpu_torch.engine.serve import _bucket_ladder
    buckets = len(_bucket_ladder(BATCH))  # the warm-up runs each bucket once
    print(f"  --synthetic {DAEMON_SYNTHETIC}: {stats['alerts_per_s']:.1f} alerts/s, "
          f"latency p50 {stats['latency_p50_ms']} ms p99 {stats['latency_p99_ms']} ms, "
          f"{stats['batches']} batches, {launches} block launches on {state['gpu']}",
          flush=True)
    check([r["candid"] for r in rows] == list(range(DAEMON_SYNTHETIC))
          and not any(r["dropped"] for r in rows)
          and all(0.0 <= r["score"] <= 1.0 for r in rows),
          f"every candid of {DAEMON_SYNTHETIC} once, in order, scored")
    check(launches == 12 * (stats["batches"] + buckets),
          f"12 block-kernel launches per daemon batch ({stats['batches']} batches + "
          f"{buckets} warm-up)")
    results["synthetic"] = stats
    daemon_launches = launches

    # ---- an Avro OCF archive with corrupt stamps, f32 and bf16 transfer; full
    # batches only (a long max wait), so the daemon's batches are the direct
    # scorer's
    path = os.path.join(tmp, "night.avro")
    records = _corrupt_avro(path, seed=61)
    direct = AlertStreamScorer(config, weights, batch_size=BATCH, device=DEVICE)
    want_scores, want_drop = direct(records)
    served = {}
    for name, extra in (("f32", []), ("bf16", ["--bf16-transfer"])):
        stats, rows, err, launches = _serve_cli(
            base + ["--avro", path, "--max-wait-ms", "60000"] + extra, out)
        served[name] = rows
        drop = np.array([r["dropped"] for r in rows])
        print(f"  --avro {DAEMON_AVRO} ({name} transfer): {stats['alerts_per_s']:.1f} "
              f"alerts/s, p50 {stats['latency_p50_ms']} ms, p99 "
              f"{stats['latency_p99_ms']} ms, {int(drop.sum())} dropped on {state['gpu']}",
              flush=True)
        n_bad = len(range(5, DAEMON_AVRO, 997))
        check([r["candid"] for r in rows] == [r["candid"] for r in records]
              and np.array_equal(drop, want_drop) and int(drop.sum()) == n_bad,
              f"avro {name}: every candid once; the drop flags are AlertStreamScorer's "
              f"own mask on the same packets ({n_bad} dropped)")
        daemon_launches += launches
        results[f"avro_{name}"] = stats
    keep = ~want_drop
    s32 = np.array([r["score"] for r, k in zip(served["f32"], keep) if k])
    s16 = np.array([r["score"] for r, k in zip(served["bf16"], keep) if k])
    d = float(np.abs(s16 - s32).max())
    d_direct = float(np.abs(s32 - want_scores[keep]).max())
    print(f"  avro scores: bf16 vs f32 transfer max|d|={d:.3g}; f32 transfer vs the "
          f"scorer called directly max|d|={d_direct:.3g}", flush=True)
    check(d <= 0.01 and d_direct <= 1e-5,
          "bf16-transfer scores within 0.01 of f32-transfer; f32 within 1e-5 of the "
          "scorer called directly on the same batches (6-decimal wire format)")

    # ---- a trickle: bursts with idle gaps, partial batches (max wait 100 ms)
    n = TRICKLE_BURST * TRICKLE_BURSTS
    packets = list(synthetic_packets(n, META_COLS, seed=62))
    scorer = AlertStreamScorer(config, weights, batch_size=BATCH, device=DEVICE)
    scorer.warmup()

    def trickle():
        t0 = time.monotonic()
        for b in range(TRICKLE_BURSTS):
            ahead = b * TRICKLE_PERIOD_S - (time.monotonic() - t0)
            if ahead > 0:
                time.sleep(ahead)
            yield from packets[b * TRICKLE_BURST:(b + 1) * TRICKLE_BURST]

    got = []
    torch.cuda.synchronize()
    mark = _launches(by=4)
    consumer = AlertStreamConsumer(scorer, trickle(), sink=lambda p, s, d: got.extend(s),
                                   max_wait_s=TRICKLE_WAIT_MS / 1e3)
    stats = consumer.run()
    launches = _launches(mark)["convnext_block_fused"]
    daemon_launches += launches
    print(f"  trickle, {TRICKLE_BURST} alerts every {TRICKLE_PERIOD_S} s x {TRICKLE_BURSTS}, "
          f"max_wait {TRICKLE_WAIT_MS} ms: {stats['batches']} batches, latency p50 "
          f"{stats['latency_p50_ms']} ms p99 {stats['latency_p99_ms']} ms on {state['gpu']}",
          flush=True)
    check(len(got) == n == stats["alerts_scored"] and launches == 12 * stats["batches"],
          f"trickle: all {n} scored, 12 block launches a batch")
    check(stats["latency_p99_ms"] < 1e3 * TRICKLE_PERIOD_S,
          f"trickle: p99 latency under the {TRICKLE_PERIOD_S} s between bursts: every "
          f"batch is finished while the source is idle (the idle drain), not when the "
          f"next burst's batch is launched")
    results["trickle"] = stats

    # ---- stop() mid-stream
    halt = threading.Event()

    def endless():
        k = 0
        while not halt.is_set():
            yield dict(packets[k % len(packets)], candid=k)
            k += 1

    consumer = AlertStreamConsumer(scorer, endless(), sink=lambda *a: None)
    consumer.start()
    deadline = time.monotonic() + 60
    while consumer.stats["alerts_scored"] < 2 * BATCH and time.monotonic() < deadline:
        time.sleep(0.05)
    stats = consumer.stop(timeout=60)
    halt.set()
    print(f"  stop() mid-stream: {stats['alerts_in']} in, {stats['alerts_scored']} "
          f"scored", flush=True)
    check(stats["alerts_scored"] == stats["alerts_in"] >= 2 * BATCH,
          "stop() mid-stream leaves alerts_scored == alerts_in")
    state["daemon"] = {"stats": results, "launches": daemon_launches}


# ------------------------------ val ------------------------------

def phase_val(state: dict) -> None:
    """``cli.val --calibrate`` on the flagship run's val split, then
    ``cli.serve --temperature auto`` on that run against ``calibrate_scores``
    of its uncalibrated scores."""
    import contextlib
    import io
    import numpy as np
    from btsbot_tpu_torch.cli.val import main as val_main
    from btsbot_tpu_torch.metrics.calibration import calibrate_scores

    run_dir = state["flagship_run"]
    tmp, data_dir = _smoke_split(state)
    perf_path = os.path.join(run_dir, "perf.json")
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = val_main([run_dir, "--data-dir", data_dir, "--calibrate",
                            "--device", DEVICE])
    secs = time.perf_counter() - t0
    print("  " + out.getvalue().strip().replace("\n", "\n  "), flush=True)
    with open(perf_path) as f:
        perf = json.load(f)
    cal = perf.get("calibration", {})
    check(set(cal) == {"temperature", "nll_before", "nll_after", "ece_before",
                       "ece_after"} and cal["nll_after"] <= cal["nll_before"] + 1e-9
          and set(perf) == SUMMARY_KEYS | {"calibration"}
          and perf["calibration"] == json.loads(json.dumps(summary["calibration"])),
          f"cli.val --calibrate wrote perf.json with the JAX CLI's keys and "
          f"calibration.temperature {cal.get('temperature')} ({secs:.1f} s)")
    # full batches only (a long max wait): both runs score the same batches
    args = [run_dir, "--batch", str(BATCH), "--synthetic", "4096", "--max-wait-ms", "60000"]
    out = os.path.join(tmp, "val_serve.jsonl")
    _, plain_rows, _, _ = _serve_cli(args, out)
    _, rows, err, _ = _serve_cli(args + ["--temperature", "auto"], out)
    t = cal["temperature"]
    check(f"calibration temperature {t}" in err,
          f"cli.serve --temperature auto reports the temperature {t}")
    s1 = np.array([r["score"] for r in plain_rows])
    st = np.array([r["score"] for r in rows])
    d = float(np.abs(st - calibrate_scores(s1, t)).max())
    print(f"  served at T={t} vs calibrate_scores of the T=1 scores: max|d|={d:.3g}",
          flush=True)
    check(d <= 1e-3, "calibrated serving within 1e-3 of calibrate_scores(T=1 scores)")
    state["val"] = {"temperature": t, "secs": secs}


# ------------------------------ distill ------------------------------

DISTILL_STUDENT = "inceptionnext_pico.r2"
DISTILL_BIG_BATCH = 1024
DISTILL_FEATURE_ALERTS = 200     # extract_features on the card: 3 full batches + a ragged one


def _backbone_equal(model, sd: dict, prefix: str) -> bool:
    import torch
    state = model.state_dict()
    return all(torch.equal(state[prefix + k].cpu(), torch.as_tensor(v)) for k, v in sd.items())


def _distill_step(config, teacher, batch):
    """One distill step of a fresh student (seed 0, γ and statistics
    randomised); (loss, {name: grad}, {kernel: launches})."""
    import torch
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.engine.state import create_train_state
    from btsbot_tpu_torch.engine.steps import make_train_step
    from btsbot_tpu_torch.models.factory import build_model

    config = normalize_config(config)
    model = build_model(config, device=DEVICE, seed=0)
    _randomise(model, seed=81)
    st = create_train_state(config, model, steps_per_epoch=TRAIN_ALERTS // TRAIN_BATCH)
    step = make_train_step(config, teacher=teacher)
    torch.cuda.synchronize()
    mark = _launches(by=4)
    m = step(st, *batch)
    torch.cuda.synchronize()
    counts = _launches(mark)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return m["loss"].item(), grads, counts


def _distill_split(config, teacher, batch, iters: int = 10) -> dict:
    """ms of one distill step = the teacher's forward + AdamW + the student's
    forward and backward with everything else, with CUDA events."""
    import torch
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.engine.state import create_train_state
    from btsbot_tpu_torch.engine.steps import make_train_step
    from btsbot_tpu_torch.models.factory import build_model

    config = normalize_config(config)
    model = build_model(config, device=DEVICE, seed=0)
    st = create_train_state(config, model, steps_per_epoch=TRAIN_ALERTS // TRAIN_BATCH)
    step = make_train_step(config, teacher=teacher)
    for _ in range(3):
        step(st, *batch)
    spans = {"teacher": [], "optimizer": []}
    open_span = {}

    def start(kind):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        open_span[kind] = ev

    def stop(kind):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        spans[kind].append((open_span.pop(kind), ev))

    hooks = [teacher.register_forward_pre_hook(lambda *_: start("teacher")),
             teacher.register_forward_hook(lambda *_: stop("teacher"))]
    opt_step = st.optimizer.step

    def timed_step(*args, **kwargs):
        start("optimizer")
        out = opt_step(*args, **kwargs)
        stop("optimizer")
        return out

    st.optimizer.step = timed_step
    whole = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    try:
        torch.cuda.synchronize()
        whole[0].record()
        for _ in range(iters):
            step(st, *batch)
        whole[1].record()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
        del st.optimizer.step
    check(len(spans["teacher"]) == len(spans["optimizer"]) == iters,
          "one teacher forward and one AdamW step per timed distill step")
    out = {k: sum(a.elapsed_time(b) for a, b in v) / iters for k, v in spans.items()}
    out["step"] = whole[0].elapsed_time(whole[1]) / iters
    out["student"] = out["step"] - out["teacher"] - out["optimizer"]
    return out


def _distill_kernels() -> dict:
    """Both kernels against their plain versions at the shapes the distill
    path gives them: the teacher's blocks (hidden 4C) in f32 at batch 64 and
    at 1,024 in f32 and bf16, the student's ``fused_ln_mlp`` (hidden 2C) in
    f32 at 64 and bf16 at 1,024, at the four pico stage shapes; {(kernel,
    batch, dtype): a forward's 12 launches summed (ms, plain, bound)}."""
    import torch
    from btsbot_tpu_torch.ops.convnext_block import (
        convnext_block_fused, convnext_block_reference, depthwise_conv7_reference)
    from btsbot_tpu_torch.ops.ln_mlp import fused_ln_mlp, ln_mlp_reference

    results = {}
    for batch, dtype, kernels in ((TRAIN_BATCH, torch.float32, ("block", "ln_mlp")),
                                  (DISTILL_BIG_BATCH, torch.float32, ("block",)),
                                  (DISTILL_BIG_BATCH, torch.bfloat16, ("block", "ln_mlp"))):
        dname, item = str(dtype).split(".")[-1], dtype.itemsize
        for side, c, depth in PICO_STAGES:
            m = batch * side * side
            x, p = _block_inputs(side, c, dtype, seed=c, batch=batch)
            where = {"shape": [batch, side, side, c], "depth": depth}
            if "block" in kernels:
                _check_kernel(f"distill teacher block C={c} batch {batch} {dname}",
                              convnext_block_fused, convnext_block_reference, (x, *p), dname,
                              (2 * m * c * item + sum(t.numel() for t in p) * item,
                               16 * m * c * c, 2 * 49 * m * c),
                              results, ("convnext_block_fused", batch, dname), where)
            if "ln_mlp" in kernels:
                q = _block_inputs(side, c, dtype, seed=c + 2, batch=1, ratio=2)[1][2:]
                h = depthwise_conv7_reference(x, p[0], p[1]).reshape(-1, c)
                _check_kernel(f"distill student fused_ln_mlp C={c} hidden 2C batch {batch} "
                              f"{dname}", fused_ln_mlp, ln_mlp_reference,
                              (h, x.reshape(-1, c), *q), dname,
                              (3 * m * c * item + sum(t.numel() for t in q) * item,
                               8 * m * c * c, 0), results, ("fused_ln_mlp", batch, dname), where)
            del x, p
        torch.cuda.empty_cache()
    totals = {}
    for key, rows in results.items():
        t_ops = sum(r["bound_ms"] * r["depth"] for r in rows if r["bound_by"] == "operations")
        t_bytes = sum(r["bound_ms"] * r["depth"] for r in rows if r["bound_by"] == "bytes")
        totals[key] = {k: sum(r[k] * r["depth"] for r in rows)
                       for k in ("ms", "plain_ms", "bound_ms", "bound3_ms") if k in rows[0]}
        totals[key].update(bound_by="operations" if t_ops > t_bytes else "bytes",
                           max_abs_err=max(r["max_abs_err"] for r in rows))
    return totals


def phase_distill(state: dict) -> None:
    """Distillation on the card: ``cli.distill`` from phase 6's flagship run
    into ``inceptionnext_pico.r2`` (the teacher's 12 blocks in the block
    kernel forward only, the student's 12 in ``fused_ln_mlp`` under
    autograd), a kernel step against a plain one, the teacher's in-step
    logits against ``AlertScorer``'s, ``cli.train`` from a backbone
    checkpoint with embeddings, a JSONL logger, ``extract_features``, and
    distill steps/s split by CUDA events."""
    import numpy as np
    import torch
    from btsbot_tpu_torch.cli.distill import main as distill_main
    from btsbot_tpu_torch.cli.train import main as train_cli
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.data.dataset import AlertDataset, load_split
    from btsbot_tpu_torch.engine import distill as distill_mod
    from btsbot_tpu_torch.engine import train as train_mod
    from btsbot_tpu_torch.engine.checkpoint import load_model_checkpoint, load_run_dir
    from btsbot_tpu_torch.engine.eval import predict_dataset
    from btsbot_tpu_torch.engine.serve import AlertScorer
    from btsbot_tpu_torch.engine.state import create_train_state
    from btsbot_tpu_torch.engine.steps import make_train_step
    from btsbot_tpu_torch.metrics.embeddings import extract_features, final_linear
    from btsbot_tpu_torch.models.factory import build_model
    from btsbot_tpu_torch.utils.logging import JsonlLogger

    # ---- both kernels at the distill path's shapes against their plain versions
    state["distill_kernels"] = _distill_kernels()
    for (name, n_b, dname), t in state["distill_kernels"].items():
        three = f", bound 3xTF32 {t['bound3_ms']:.4f}" if "bound3_ms" in t else ""
        print(f"  distill path, {name} batch {n_b} {dname}: a forward's 12 launches "
              f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f}, bound {t['bound_ms']:.4f} "
              f"({t['bound_by']}){three}, first version: none recorded at batch {n_b}, "
              f"max|d|={t['max_abs_err']:.3g} on {state['gpu']}", flush=True)

    run_dir = state["flagship_run"]
    tmp, data_dir = _smoke_split(state)
    t_cfg, t_weights = load_run_dir(run_dir)
    s_cfg = distill_mod.student_config_from_teacher(t_cfg, DISTILL_STUDENT, epochs=1)
    train = load_split(s_cfg, "train", data_dir)
    val = load_split(s_cfg, "val", data_dir)

    def batch_of(n):
        return (torch.from_numpy(train.images[:n]).to(DEVICE),
                torch.from_numpy(train.metadata[:n]).to(DEVICE),
                torch.from_numpy(train.labels[:n]).to(DEVICE), train.pos_weight)

    # ---- the entry point: cli.distill, the teacher captured as it is loaded
    loaded = {}
    load_teacher = distill_mod.load_teacher

    def capture(*args, **kwargs):
        model, config = load_teacher(*args, **kwargs)
        loaded["model"] = model
        loaded["before"] = {k: v.clone() for k, v in model.state_dict().items()}
        return model, config

    steps = TRAIN_ALERTS // TRAIN_BATCH
    evals = -(-VAL_ALERTS // TRAIN_BATCH)
    distill_mod.load_teacher = capture
    try:
        torch.cuda.synchronize()
        mark = _launches(by=4)
        t0 = time.perf_counter()
        result = distill_main([run_dir, "--student-kind", DISTILL_STUDENT, "--data-dir",
                               data_dir, "--out-root", os.path.join(tmp, "distill"),
                               "--epochs", "1", "--no-figure", "--device", DEVICE])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _launches(mark)
    finally:
        distill_mod.load_teacher = load_teacher
    print(f"  cli.distill {DISTILL_STUDENT}: 1 epoch at batch {TRAIN_BATCH}, launches "
          f"{counts}, {secs:.1f} s on {state['gpu']}", flush=True)
    want = {"convnext_block_fused": 12 * steps, "fused_ln_mlp": 12 * (steps + evals)}
    check(counts == want, f"12 block launches (teacher, forward only) a distill step and 0 "
                          f"an eval batch; 12 fused_ln_mlp launches a distill step and an "
                          f"eval batch ({steps} steps, {evals} eval batches: {want})")
    hist = result["history"]
    check(len(hist["train_loss"]) == 1 and all(
        np.all(np.isfinite(hist[k])) for k in ("train_loss", "val_loss")),
        f"finite distill losses: train {hist['train_loss']}, val {hist['val_loss']}")
    with open(os.path.join(result["model_dir"], "report.json")) as f:
        report = json.load(f)
    check(set(report) == REPORT_KEYS and set(report["Training history"]) == HISTORY_KEYS
          and set(report["val_summary"]) == SUMMARY_KEYS
          and report["train_config"]["model_kind"] == DISTILL_STUDENT,
          "the student's report.json has the JAX package's keys and the student's kind")
    student = build_model(s_cfg, device=DEVICE)
    student.load_state_dict(load_model_checkpoint(s_cfg, result["model_dir"]), strict=True)
    _, scores = predict_dataset(student, s_cfg, val)
    d = float(np.abs(scores - result["best_val_scores"]).max())
    check(d <= 1e-6, f"the student's best_model.pth scores the val split within 1e-6 of the "
                     f"trainer's best epoch (max|d|={d:.3g})")
    teacher = loaded["model"]
    check(not teacher.training and all(torch.equal(v, loaded["before"][k])
                                       for k, v in teacher.state_dict().items()),
          "the teacher's tensors (parameters and BatchNorm statistics) bit-identical after "
          "the run, still in eval mode")
    state["distill_launches"] = counts

    # ---- one f32 distill step through both kernels and through both plain models
    batch = batch_of(TRAIN_BATCH)
    loss_k, grads_k, n_k = _distill_step(s_cfg, teacher, batch)
    with _plain_ops():
        loss_p, grads_p, n_p = _distill_step(s_cfg, teacher, batch)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    worst, worst_name = max(
        ((grads_k[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), n)
        for n, g in grads_p.items())
    print(f"  one f32 distill step: loss {loss_k:.8f} kernels / {loss_p:.8f} plain (rel "
          f"{rel:.3g}); worst gradient max|d|/max|g| = {worst:.3g} ({worst_name})", flush=True)
    check(n_k == {"convnext_block_fused": 12, "fused_ln_mlp": 12}
          and n_p == {"convnext_block_fused": 0, "fused_ln_mlp": 0},
          "12 block + 12 fused_ln_mlp launches in a distill step (0 in the plain step)")
    check(rel <= 1e-6, "distill-step loss through the kernels within rtol 1e-6 of plain")
    check(worst <= 1e-4, "every student gradient within 1e-4 x its largest entry of plain")

    # ---- the teacher's in-step logits (no augmentation) against AlertScorer's f32 model
    seen = []
    hook = teacher.register_forward_hook(lambda _m, _a, out: seen.append(out.detach()))
    try:
        _distill_step({**s_cfg, "data_aug_h_flip": 0, "data_aug_v_flip": 0, "data_aug_rot": 0},
                      teacher, batch)
    finally:
        hook.remove()
    scorer = AlertScorer(t_cfg, t_weights, batch_size=TRAIN_BATCH, dtype=torch.float32,
                         device=DEVICE)
    with torch.inference_mode():
        want_logits = scorer.model(batch[0], batch[1]).reshape(-1)
    d = (seen[0].reshape(-1) - want_logits).abs().max().item()
    check(len(seen) == 1 and d <= 1e-5,
          f"the teacher's in-step logits within 1e-5 of AlertScorer's f32 logits on an "
          f"unaugmented batch (max|d|={d:.3g}): eval mode")

    # ---- cli.train from a backbone checkpoint written from a port model, with embeddings
    prefix = "convnext_backbone."
    backbone = {k[len(prefix):]: v for k, v in t_weights.items()
                if k.startswith((prefix + "stem.", prefix + "stages."))}
    ckpt = os.path.join(tmp, "backbone.pth")
    torch.save(backbone, ckpt)
    b_cfg = _train_config(epochs=1, backbone_checkpoint=ckpt, generate_embeddings=True)
    path = os.path.join(tmp, "backbone_config.json")
    with open(path, "w") as f:
        json.dump(b_cfg, f)
    seeded = []
    create_train_state = train_mod.create_train_state

    def capture_state(config, model, *args, **kwargs):
        seeded.append(_backbone_equal(model, backbone, prefix))
        return create_train_state(config, model, *args, **kwargs)

    train_mod.create_train_state = capture_state
    try:
        torch.cuda.synchronize()
        mark = _launches(by=4)
        t0 = time.perf_counter()
        b_result = train_cli([path, "--data-dir", data_dir, "--out-root",
                              os.path.join(tmp, "backbone"), "--run-name", "backbone",
                              "--no-figure", "--device", DEVICE])
        torch.cuda.synchronize()
        b_secs = time.perf_counter() - t0
        b_counts = _launches(mark)
    finally:
        train_mod.create_train_state = create_train_state
    check(seeded == [True], "cli.train's model holds the checkpoint's backbone before its "
                            "first step")
    with open(os.path.join(b_result["model_dir"], "embeddings.csv"), newline="") as f:
        rows = list(csv.reader(f))
    emb = np.asarray(rows[1:], dtype=np.float64)
    check(rows[0] == ["umap_emb_1", "umap_emb_2", "candid"] and emb.shape == (VAL_ALERTS, 3)
          and np.isfinite(emb).all(),
          f"embeddings.csv holds the JAX columns and {VAL_ALERTS} finite rows "
          f"(cli.train {b_secs:.1f} s, launches {b_counts})")
    check(b_counts["convnext_block_fused"] == 12 * (steps + 2 * evals),
          "12 block launches a train step, an eval batch and an embeddings batch")

    # ---- the experiment logger: one JSONL line an epoch, then the summary
    log_path = os.path.join(tmp, "log.jsonl")
    train_mod.run_training(normalize_config(_train_config(epochs=2)), data_dir=data_dir,
                           out_root=os.path.join(tmp, "logged"), run_name="logged",
                           logger=JsonlLogger(log_path), device=DEVICE, log=lambda _m: None)
    with open(log_path) as f:
        lines = [json.loads(line) for line in f]
    check([x["step"] for x in lines[:-1]] == [0, 1] and "ROC_AUC" in lines[-1]["summary"],
          "the JSONL logger wrote one line an epoch (2) and the summary's ROC_AUC")

    # ---- extract_features on the card against the plain model (f32)
    n = DISTILL_FEATURE_ALERTS
    sub = AlertDataset(val.labels[:n], val.images[:n], val.metadata[:n])
    model = build_model(t_cfg, device=DEVICE)
    model.load_state_dict(t_weights)
    mark = _launches(by=4)
    feats = extract_features(model, t_cfg, sub)
    f_counts = _launches(mark)
    plain = []
    hook = final_linear(model).register_forward_pre_hook(lambda _m, a: plain.append(a[0]))
    try:
        with torch.no_grad(), _plain_ops():
            for s in range(0, n, TRAIN_BATCH):
                model(torch.from_numpy(sub.images[s:s + TRAIN_BATCH]).to(DEVICE),
                      torch.from_numpy(sub.metadata[s:s + TRAIN_BATCH]).to(DEVICE))
    finally:
        hook.remove()
    plain = torch.cat(plain).float().cpu().numpy()
    d = float(np.abs(feats - plain).max())
    scale = max(1.0, float(np.abs(plain).max()))
    check(feats.shape == plain.shape == (n, final_linear(model).in_features)
          and d <= 1e-5 * scale and f_counts["convnext_block_fused"] == 12 * -(-n // TRAIN_BATCH),
          f"extract_features on the card within 1e-5 x max(1, max|f|) of the plain model "
          f"(max|d|={d:.3g}, max|f|={scale:.3g}), 12 block launches a batch")

    # ---- speed (information only): the student's own step before and after
    # the distill steps, which run the two teacher types in turns at batch
    # 1,024 (f32, bf16, bf16, f32)
    alone = {}

    def time_alone():
        for n_b, s_dtype in ((TRAIN_BATCH, "float32"), (DISTILL_BIG_BATCH, "bfloat16")):
            cfg = normalize_config({**s_cfg, "compute_dtype": s_dtype})
            st = create_train_state(cfg, build_model(cfg, device=DEVICE, seed=0),
                                    steps_per_epoch=steps)
            step, b = make_train_step(cfg), batch_of(n_b)
            ms = time_ms(lambda: step(st, *b))
            alone.setdefault((n_b, s_dtype), []).append(ms)
            print(f"  {DISTILL_STUDENT} train step alone, batch {n_b} {s_dtype}: "
                  f"{ms:.3f} ms on {state['gpu']}", flush=True)
            if n_b == DISTILL_BIG_BATCH and len(alone[(n_b, s_dtype)]) == 2:
                _profile(lambda: step(st, *b), f"{DISTILL_STUDENT} step alone, batch "
                                               f"{n_b} {s_dtype}")

    time_alone()
    splits = []
    teachers = {"float32": teacher, "bfloat16": distill_mod.load_teacher(
        run_dir, dtype=torch.bfloat16, device=DEVICE)[0]}
    for n_b, s_dtype, t_name in ((TRAIN_BATCH, "float32", "float32"),
                                 (DISTILL_BIG_BATCH, "bfloat16", "float32"),
                                 (DISTILL_BIG_BATCH, "bfloat16", "bfloat16"),
                                 (DISTILL_BIG_BATCH, "bfloat16", "bfloat16"),
                                 (DISTILL_BIG_BATCH, "bfloat16", "float32")):
        sp = _distill_split({**s_cfg, "compute_dtype": s_dtype}, teachers[t_name],
                            batch_of(n_b))
        splits.append(((n_b, s_dtype, t_name), sp))
        print(f"  distill step batch {n_b}, student {s_dtype}, teacher {t_name}: "
              f"{sp['step']:.3f} ms = {1e3 / sp['step']:.1f} steps/s "
              f"({n_b * 1e3 / sp['step']:.0f} alerts/s) = teacher forward {sp['teacher']:.3f} "
              f"+ student forward, backward and the rest {sp['student']:.3f} + AdamW "
              f"{sp['optimizer']:.3f} on {state['gpu']}", flush=True)
    time_alone()
    for n_b, s_dtype, t_name in ((TRAIN_BATCH, "float32", "float32"),
                                 (DISTILL_BIG_BATCH, "bfloat16", "float32"),
                                 (DISTILL_BIG_BATCH, "bfloat16", "bfloat16")):
        cfg = normalize_config({**s_cfg, "compute_dtype": s_dtype})
        st = create_train_state(cfg, build_model(cfg, device=DEVICE, seed=0),
                                steps_per_epoch=steps)
        step, b = make_train_step(cfg, teacher=teachers[t_name]), batch_of(n_b)
        try:
            _profile(lambda: step(st, *b), f"distill step batch {n_b}, student {s_dtype}, "
                                           f"teacher {t_name}")
        except Exception as e:  # noqa: BLE001 — information only
            print(f"  profiler failed ({e!r}); not measured", flush=True)
        del st
    state["distill"] = {"cli_s": secs, "splits": splits, "backbone_cli_s": b_secs,
                        "alone": alone}


# ------------------------------ phase 15 ------------------------------

# the dataset-to-deployment path: four source sets of the reference's
# training set, each LIFECYCLE_OBJECTS objects with 3-13 alerts (about 3,200
# alerts in all), through the port's acquisition, split, train, export and
# publish entry points
LIFECYCLE_SETS = {"trues": (16.5, 18.4), "dims": (18.6, 19.8), "vars": (15.5, 18.5),
                  "rejects": (17.0, 19.5)}                 # peak magnitude range
LIFECYCLE_OBJECTS = 100
LIFECYCLE_CORRUPT_EVERY = 150     # every 150th packet's science stamp is all NaN
LIFECYCLE_VERIFY = 256            # the second ONNX verification's batch
LIFECYCLE_CROP = 47
LIFECYCLE_INCEPTION = "inceptionnext_pico"


class _ReplayKowalski:
    """Kowalski stand-in: replays packets by object and programid (a copy of
    each, as a query returns new dicts) and previous candidates of the aux
    catalog."""

    def __init__(self, packets: dict, prv: dict):
        self.packets, self.prv = packets, prv

    def query(self, q):
        flt = q["query"]["filter"]
        if q["query"]["catalog"] == "ZTF_alerts":
            data = [dict(p) for p in self.packets.get(flt["objectId"], [])
                    if p["candidate"]["programid"] == flt["candidate.programid"]]
        else:
            data = [{"prv_candidates": self.prv[flt["_id"]]}] if flt["_id"] in self.prv else []
        return {"kowalski": {"data": data}}


def _lifecycle_set(set_name: str, seed: int):
    """({objectId: packets}, {objectId: previous candidates}, corrupt count)
    of one source set: the cutouts of an object (a source in the science and
    difference stamps of trues, noise elsewhere) shared by its alerts, a
    light curve around a peak in the set's magnitude range, and the flagship's
    metadata fields."""
    import numpy as np
    from btsbot_tpu_torch.data.fits import write_fits_image

    rng = np.random.default_rng(seed)
    lo, hi = LIFECYCLE_SETS[set_name]
    yy, xx = np.mgrid[:63, :63]
    bump = np.exp(-((yy - 31) ** 2 + (xx - 31) ** 2) / 8.0)
    nan_blob = gzip.compress(write_fits_image(np.full((63, 63), np.nan, np.float32)), 1)
    packets, prv, corrupt, count = {}, {}, 0, 0
    for o in range(LIFECYCLE_OBJECTS):
        oid = f"ZTF24{set_name[:3]}{o:05d}"
        src = 6.0 * bump * (set_name == "trues")
        stamps = [gzip.compress(write_fits_image(
            (rng.normal(size=(63, 63)) + s).astype(np.float32)), 1)
            for s in (src, 0.0, src)]
        n, peak = int(rng.integers(3, 14)), rng.uniform(lo, hi)
        at_peak, jd0 = int(rng.integers(0, n)), 2459500.5 + 0.37 * o
        ra, dec = rng.uniform(0, 360), rng.uniform(-30, 80)
        alerts_ = []
        for i in range(n):
            sci = stamps[0]
            if count % LIFECYCLE_CORRUPT_EVERY == LIFECYCLE_CORRUPT_EVERY - 1:
                sci, corrupt = nan_blob, corrupt + 1
            count += 1
            cand = {
                "candid": int(seed * 10 ** 7 + o * 100 + i), "programid": 1 + i % 2,
                "fid": 1 + i % 2, "isdiffpos": "t" if rng.random() < 0.95 else "f",
                "jd": jd0 + 1.5 * i, "jdstarthist": jd0 - float(rng.uniform(0, 5)),
                "magpsf": float(peak + 0.08 * abs(i - at_peak) + rng.normal(0, 0.02)),
                "sigmapsf": float(rng.uniform(0.05, 0.2)),
                "diffmaglim": float(rng.uniform(20, 21)), "ra": ra, "dec": dec,
                "ndethist": i + 1, "ncovhist": i + 1 + int(rng.integers(0, 9)),
                "nmtchps": int(rng.integers(0, 20)), "drb": float(rng.uniform(0.5, 1)),
                **{k: float(rng.normal()) for k in ("fwhm", "chipsf", "sky", "scorr",
                                                    "chinr", "sharpnr")},
                "sgscore1": float(rng.uniform(-0.05, 1)), "distpsnr1": float(rng.uniform(0, 20)),
                "sgscore2": float(rng.uniform(-1, 1)), "distpsnr2": float(rng.uniform(0, 30)),
            }
            alerts_.append({"objectId": oid, "candidate": cand,
                            "classifications": {"acai_h": float(rng.uniform())},
                            "cutoutScience": {"stampData": sci},
                            "cutoutTemplate": {"stampData": stamps[1]},
                            "cutoutDifference": {"stampData": stamps[2]}})
        packets[oid] = alerts_
        if o % 3 == 0:
            prv[oid] = [{"jd": jd0 - 3.0, "diffmaglim": 20.2},
                        {"jd": jd0 - 1.0, "diffmaglim": 20.6, "magpsf": None},
                        {"jd": jd0 - 0.5, "diffmaglim": 19.9, "magpsf": 19.5}]
    return packets, prv, corrupt


def _new_drb(triplets):
    """The ``drb_fn`` hook (the reference re-scores with braai): a squashed
    central flux of the difference stamp."""
    import numpy as np
    return 1.0 / (1.0 + np.exp(-100.0 * triplets[:, 28:35, 28:35, 2].mean(axis=(1, 2))))


def _timed_cli(name: str, fn, argv: list, secs: dict):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(argv)
    torch.cuda.synchronize()
    secs[name] = time.perf_counter() - t0
    return out


def phase_lifecycle(state: dict) -> None:
    """The dataset-to-deployment path on the card: acquisition through a
    replaying Kowalski client (ingest on the card), ``cli.dataset build``,
    ``cli.train``, ``cli.export`` (ONNX verified on the card at 16 and 256
    alerts, the TF SavedModel at 16 and a mutant refused, and the torch
    checkpoint), ``cli.publish --no-upload`` and
    ``load_model_dir``; an ``inceptionnext_pico`` export verified through
    ``fused_ln_mlp``; the crop ops against numpy."""
    import numpy as np
    import torch
    from btsbot_tpu_torch.cli.dataset import main as dataset_cli
    from btsbot_tpu_torch.cli.export import _verification_inputs
    from btsbot_tpu_torch.cli.export import main as export_cli
    from btsbot_tpu_torch.cli.publish import main as publish_cli
    from btsbot_tpu_torch.cli.train import main as train_cli
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.data.dataset import load_split, read_candidates
    from btsbot_tpu_torch.data.query.kowalski import download_training_data
    from btsbot_tpu_torch.engine.checkpoint import load_torch_checkpoint
    from btsbot_tpu_torch.engine.eval import predict_dataset
    from btsbot_tpu_torch.interop.hf import load_model_dir
    from btsbot_tpu_torch.interop.onnx_export import (export_onnx, float32_exact,
                                                      verify_onnx)
    from btsbot_tpu_torch.interop.onnx_numpy import run_model
    from btsbot_tpu_torch.interop.savedmodel import verify_saved_model
    from btsbot_tpu_torch.interop.savedmodel_numpy import run_saved_model
    from btsbot_tpu_torch.models.factory import build_model
    from btsbot_tpu_torch.ops.preprocess import center_crop, crop_triplets, nan_row_mask

    tmp, _ = _smoke_split(state)
    root = os.path.join(tmp, "lifecycle")
    base, data, models = (os.path.join(root, d) for d in ("base_data", "data", "models"))
    secs, launches = {}, {}

    def counted(name, fn):
        mark = _launches(by=4)
        out = fn()
        launches[name] = _launches(mark)
        return out

    # ---- acquisition: four source sets through download_training_data
    t0 = time.perf_counter()
    sets = {name: _lifecycle_set(name, seed=20 + i) for i, name in enumerate(LIFECYCLE_SETS)}
    n_alerts = sum(len(p) for ps, _, _ in sets.values() for p in ps.values())
    n_corrupt = sum(c for _, _, c in sets.values())
    print(f"  {len(sets) * LIFECYCLE_OBJECTS} objects, {n_alerts} alert packets "
          f"({n_corrupt} with an all-NaN science stamp) made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    path_t0 = time.perf_counter()
    for name, (packets, prv, corrupt) in sets.items():
        t0 = time.perf_counter()
        counted(f"download {name}", lambda: download_training_data(
            {"ZTFID": np.asarray(list(packets))}, name, 1 if name == "trues" else 0,
            client=_ReplayKowalski(packets, prv), out_dir=base, drb_fn=_new_drb,
            device=DEVICE))
        secs[f"download {name}"] = time.perf_counter() - t0
        trips = np.load(os.path.join(base, f"{name}_triplets.npy"))
        cand = read_candidates(os.path.join(base, f"{name}_candidates.csv"))
        n = sum(len(p) for p in packets.values())
        check(trips.shape == (n - corrupt, 63, 63, 3) and trips.dtype == np.float64
              and np.isfinite(trips).all() and len(cand["objectId"]) == n - corrupt
              and np.allclose(np.linalg.norm(trips, axis=(1, 2)), 1.0, atol=1e-5),
              f"{name}: {n} packets ingested on the card, {corrupt} corrupt dropped, "
              f"unit-norm float64 triplets ({secs[f'download {name}']:.1f} s)")
    check(all(v == {"convnext_block_fused": 0, "fused_ln_mlp": 0}
              for k, v in launches.items() if k.startswith("download")),
          "the ingest runs no block kernel")

    # ---- cli.dataset build
    counted("cli.dataset", lambda: _timed_cli(
        "cli.dataset build", dataset_cli,
        ["build", "--version", "vlc", "--base-dir", base, "--out-dir", data], secs))
    config = normalize_config(_train_config(train_data_version="vlc", epochs=1))
    train, val = load_split(config, "train", data), load_split(config, "val", data)
    check(len(train) > 20 * TRAIN_BATCH and len(val) > TRAIN_BATCH and 0 < train.num_pos
          < len(train) and np.isfinite(train.metadata).all(),
          f"cli.dataset build: {len(train)} train / {len(val)} val alerts (N100), both "
          f"labels, finite metadata ({secs['cli.dataset build']:.1f} s)")

    # ---- cli.train, 1 epoch at batch 64
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(config), f)
    result = counted("cli.train", lambda: _timed_cli(
        "cli.train", train_cli, [cfg_path, "--data-dir", data, "--out-root", models,
                                 "--run-name", "lifecycle", "--no-figure", "--device",
                                 DEVICE], secs))
    run = result["model_dir"]
    steps, evals = len(train) // TRAIN_BATCH, -(-len(val) // TRAIN_BATCH)
    want = 12 * (steps + evals)
    check(launches["cli.train"]["convnext_block_fused"] == want
          and np.all(np.isfinite(result["history"]["train_loss"])),
          f"cli.train 1 epoch: {want} block launches (12 x ({steps} steps + {evals} eval "
          f"batches)), finite losses ({secs['cli.train']:.1f} s)")

    # ---- cli.export: ONNX verified on the card, then the torch checkpoint
    counted("cli.export onnx", lambda: _timed_cli("cli.export onnx", export_cli,
                                                  [run, "--device", DEVICE], secs))
    onnx_path = os.path.join(run, "model.onnx")
    with open(os.path.join(run, "model.verification.json")) as f:
        report = json.load(f)
    onnx_mb = os.path.getsize(onnx_path) / 2 ** 20
    check(report["close"] and report["n"] == 16
          and launches["cli.export onnx"]["convnext_block_fused"] == 12,
          f"cli.export: ONNX ({onnx_mb:.2f} MiB) verified against the card's f32 forward "
          f"(12 block launches), close: true, max|d| = {report['max_diff']:.3g} "
          f"({secs['cli.export onnx']:.1f} s)")
    sd = load_torch_checkpoint(os.path.join(run, "best_model.pth"))
    trips, meta = _verification_inputs(config, n=LIFECYCLE_VERIFY, seed=1)
    big = counted(f"verify {LIFECYCLE_VERIFY}", lambda: verify_onnx(
        onnx_path, config, sd, trips, meta, device=DEVICE))
    check(big["close"] and big["n"] == LIFECYCLE_VERIFY
          and launches[f"verify {LIFECYCLE_VERIFY}"]["convnext_block_fused"] == 12,
          f"the same artifact at batch {LIFECYCLE_VERIFY}: close: true, max|d| = "
          f"{big['max_diff']:.3g} (12 block launches)")

    # ---- cli.export --format saved_model: the TF SavedModel verified on the card
    counted("cli.export saved_model", lambda: _timed_cli(
        "cli.export saved_model", export_cli,
        [run, "--format", "saved_model", "--device", DEVICE], secs))
    sm_dir = os.path.join(run, "saved_model")
    with open(os.path.join(sm_dir, "verification.json")) as f:
        sm_report = json.load(f)
    sm_mb = os.path.getsize(os.path.join(sm_dir, "saved_model.pb")) / 2 ** 20
    t16, m16 = _verification_inputs(config)
    t0 = time.perf_counter()
    run_saved_model(sm_dir, {"image": t16, "metadata": m16})
    sm_eval_s = time.perf_counter() - t0
    check(sm_report["close"] and sm_report["n"] == 16
          and launches["cli.export saved_model"]["convnext_block_fused"] == 12,
          f"cli.export --format saved_model: TF SavedModel ({sm_mb:.2f} MiB) verified against "
          f"the card's f32 forward (12 block launches), close: true, max|d| = "
          f"{sm_report['max_diff']:.3g} ({secs['cli.export saved_model']:.1f} s; its numpy "
          f"evaluator {sm_eval_s:.2f} s for 16 alerts on the host)")
    # a check that cannot fail proves nothing: the same artifact against
    # weights with the last bias shifted
    shifted = {**sd, "combined_head.5.bias": sd["combined_head.5.bias"] + 0.05}
    mutant = counted("verify saved_model mutant", lambda: verify_saved_model(
        sm_dir, config, shifted, t16, m16, device=DEVICE))
    check(not mutant["close"],
          f"the unchanged SavedModel against combined_head.5.bias + 0.05: close: false, "
          f"max|d| = {mutant['max_diff']:.3g}")

    # the numpy evaluator against the card's f32 forward on the same alerts
    with open(onnx_path, "rb") as f:
        model_bytes = f.read()
    feeds = {"image": np.ascontiguousarray(trips.transpose(0, 3, 1, 2)), "metadata": meta}
    t0 = time.perf_counter()
    run_model(model_bytes, feeds)
    host_s = time.perf_counter() - t0
    model = build_model(config, device=DEVICE)
    model.load_state_dict(sd, strict=True)
    x, m = torch.from_numpy(trips).to(DEVICE), torch.from_numpy(meta).to(DEVICE)
    with float32_exact(), torch.inference_mode():
        card_ms = time_ms(lambda: model(x, m))
    state["lifecycle_rates"] = (LIFECYCLE_VERIFY / host_s, LIFECYCLE_VERIFY * 1e3 / card_ms)
    print(f"  {LIFECYCLE_VERIFY} alerts: numpy evaluator {host_s:.2f} s = "
          f"{state['lifecycle_rates'][0]:.1f} alerts/s (host), the card's f32 forward "
          f"{card_ms:.3f} ms = {state['lifecycle_rates'][1]:.1f} alerts/s on {state['gpu']}",
          flush=True)

    counted("cli.export torch", lambda: _timed_cli(
        "cli.export torch", export_cli, [run, "--format", "torch"], secs))
    fresh = build_model(config, device=DEVICE)
    fresh.load_state_dict(load_torch_checkpoint(os.path.join(run, "pytorch_model.bin")),
                          strict=True)
    _, scores = predict_dataset(fresh, config, val)
    d = float(np.abs(scores - result["best_val_scores"]).max())
    check(d <= 1e-6, f"pytorch_model.bin loads strict into a fresh model and scores the val "
                     f"split within 1e-6 of the run's best epoch (max|d|={d:.3g})")

    # ---- cli.publish --no-upload, then the published directory as users load it
    counted("cli.publish", lambda: _timed_cli("cli.publish", publish_cli,
                                              [run, "--no-upload"], secs))
    published, pub_config = load_model_dir(run, device=DEVICE)
    _, scores = predict_dataset(published, pub_config, val)
    d = float(np.abs(scores - result["best_val_scores"]).max())
    check(os.path.isfile(os.path.join(run, "README.md")) and d <= 1e-6,
          f"cli.publish --no-upload: model card written; load_model_dir scores the val "
          f"split within 1e-6 of the run's best epoch (max|d|={d:.3g})")

    # ---- an inceptionnext_pico export through fused_ln_mlp's f32 path
    inc_cfg = normalize_config({**FLAGSHIP_CONFIG, "model_kind": LIFECYCLE_INCEPTION})
    inc = build_model(inc_cfg, device=DEVICE, seed=3)
    _randomise(inc, seed=4)
    inc_path = os.path.join(root, "inceptionnext.onnx")
    export_onnx(inc_cfg, inc, inc_path)
    t_in, m_in = _verification_inputs(inc_cfg)
    inc_report = counted("verify inceptionnext", lambda: verify_onnx(
        inc_path, inc_cfg, inc, t_in, m_in, device=DEVICE))
    check(inc_report["close"]
          and launches["verify inceptionnext"] == {"convnext_block_fused": 0,
                                                   "fused_ln_mlp": 12},
          f"{LIFECYCLE_INCEPTION} (random weights): ONNX verified on the card, close: "
          f"true, max|d| = {inc_report['max_diff']:.3g} (12 fused_ln_mlp launches)")
    torch.cuda.synchronize()
    secs["whole path"] = time.perf_counter() - path_t0
    total = {k: sum(v[k] for v in launches.values())
             for k in ("convnext_block_fused", "fused_ln_mlp")}
    state["lifecycle"] = {"secs": secs, "launches": launches, "total": total,
                          "onnx_mb": onnx_mb, "saved_model_mb": sm_mb,
                          "saved_model_eval_s": sm_eval_s,
                          "saved_model_max_diff": (sm_report["max_diff"],
                                                   mutant["max_diff"]),
                          "max_diff": (report["max_diff"],
                                                           big["max_diff"],
                                                           inc_report["max_diff"])}

    # ---- the crop ops and the NaN-row mask on the card against numpy
    raw = np.load(os.path.join(base, "trues_triplets.npy"))[:LIFECYCLE_VERIFY]
    raw32 = raw.astype(np.float32)
    m0 = (63 - LIFECYCLE_CROP) // 2
    want_c = raw32[:, m0:m0 + LIFECYCLE_CROP, m0:m0 + LIFECYCLE_CROP, :]
    want_n = want_c / np.linalg.norm(want_c.astype(np.float64), axis=(1, 2), keepdims=True)
    t = torch.from_numpy(raw32).to(DEVICE)
    got_c = center_crop(t, LIFECYCLE_CROP).cpu().numpy()
    got_n = crop_triplets(t, LIFECYCLE_CROP).cpu().numpy()
    raw32[3, 5, 7, 1] = np.nan
    got_mask = nan_row_mask(torch.from_numpy(raw32).to(DEVICE)).cpu().numpy()
    err = float(np.abs(got_n - want_n).max())
    check(np.array_equal(got_c, want_c) and err <= 1e-6
          and np.array_equal(got_mask, np.isnan(raw32).any(axis=(1, 2, 3))),
          f"center_crop (exact), crop_triplets (max|d| = {err:.3g} against float64 numpy) "
          f"and nan_row_mask on the card at {LIFECYCLE_VERIFY} x 63 x 63 x 3 -> "
          f"{LIFECYCLE_CROP}")


# ------------------------------ int8 ------------------------------

INT8_CAL = 512        # calibration triplets
INT8_TOL = 0.015      # |Δscore| against the bf16 model (verify_quantized_parity's default)
INT8_HOST = 256       # alerts of the float32 replay of the card's forward on the host
INT8_X_ATOL = 1e-5    # |Δ| of a depthwise input there (stage 0's stem LN ulps, x up to ~10)
INT8_F32_ATOL = 1e-5  # |Δlogit| there (the same backbone features; the heads' ulps)
INT8_MUTANT = "s0b0_fc2"  # the weight scale doubled to show that the replay can fail
INT8_KERNELS = 2      # csrc/int8_dwconv.cu: float32 and bfloat16 inputs
# csrc/int8_block.cu: each padded width of WGMMA_WIDTHS in both types
INT8_BLOCK_KERNELS = 2 * len(WGMMA_WIDTHS)
# the int8 block kernel's shapes besides pico's and nano's stages at BATCH:
# atto's C = 40 (15x15) and base's C = 1024 (1x1) at batch 256 (kind, stage)
INT8_BLOCK_EXTRA = (("convnext_atto", 0), ("convnext_base", 3))
INT8_BLOCK_EXTRA_BATCH = 256
INT8_BLOCK_BOUND = ("bytes (x read once, out written once, the int8 weights and the float "
                    "parameters) at 3.35 TB/s, or the two products' 4 C hidden and the 49 C "
                    "taps' int8 operations a pixel at the dense int8 tensor-core peak, "
                    "1,979 TOP/s")
INT8_FORWARDS = {"mm_ConvNeXt-pico (flagship)": (FLAGSHIP_CONFIG, "convnext_pico", 12),
                 "mm_ConvNeXt-nano": (NANO_CONFIG, "convnext_nano", NANO_LAUNCHES)}
INT8_BOUND = ("bytes (x read once, out written once) at 3.35 TB/s, or 49 int8 multiply-adds "
              "(98 ops) an output at the dense int8 tensor-core peak, 1,979 TOP/s")


def _fma_rate() -> tuple[float, str]:
    """The FP32 pipe's multiply-adds a second (the unit the int8 depthwise
    kernel sums its taps on): SMs x 128 lanes x the card's top SM clock.
    Printed as the kernel's own arithmetic floor, not as its bound."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    rate = sms * 128 * mhz * 1e6
    return rate, f"{sms} SMs x 128 FP32 lanes x {mhz:.0f} MHz = {rate / 1e12:.2f} T FMA/s"


def _int8_dw_inputs(side: int, c: int, dtype, seed: int):
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(BATCH, side, side, c, device=DEVICE, generator=g).to(dtype)
    wq = torch.randint(-127, 128, (7, 7, c), device=DEVICE, dtype=torch.int8, generator=g)
    ws = torch.rand(c, device=DEVICE, generator=g) * 0.01 + 1e-4
    bias = torch.randn(c, device=DEVICE, generator=g)
    return x, float(x.float().abs().amax() / torch.tensor(127.0, device=DEVICE)), wq, ws, bias


def _int8_dw_rows(kind: str, fma_rate: float) -> list:
    """The kernel against its plain version at each stage shape of ``kind``
    at batch BATCH in both types (bit for bit), with its time, the plain
    version's, cuDNN's float32 depthwise conv over the integer-valued
    quantized tensor (the same accumulators), the bound and the taps' time
    on the FP32 pipe alone (the unit the kernel sums them on)."""
    import torch
    import torch.nn.functional as F
    from btsbot_tpu_torch.ops import quantized as tq

    rows = []
    for side, c, depth in _stage_shapes(kind):
        for dtype in (torch.bfloat16, torch.float32):
            x, s_x, wq, ws, bias = _int8_dw_inputs(side, c, dtype, seed=side * 1000 + c)
            got = tq._launch_int8_dwconv(x, s_x, wq, ws, bias)
            want = tq.int8_dwconv_reference(x, s_x, wq, ws, bias)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            dname = str(dtype).split(".")[1]
            check(err == 0.0, f"int8_dwconv {kind} ({BATCH},{side},{side},{c}) {dname}: "
                              f"bit for bit with its plain version")
            xq = tq.quantize_act(x, s_x).float().permute(0, 3, 1, 2)  # channels_last view
            wf = wq.permute(2, 0, 1).unsqueeze(1).float()
            n = x.numel()
            t_bytes = 2 * n * x.element_size() / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * 49 * n / PEAK_OPS["int8"] * 1e3
            rows.append(dict(
                kind=kind, shape=(BATCH, side, side, c), depth=depth, dtype=dname,
                max_abs_err=err,
                ms=time_ms(lambda: tq._launch_int8_dwconv(x, s_x, wq, ws, bias)),
                plain_ms=time_ms(lambda: tq.int8_dwconv_reference(x, s_x, wq, ws, bias)),
                library_ms=time_ms(lambda: F.conv2d(xq, wf, None, 1, 3, groups=c)),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                fp32_pipe_ms=49 * n / fma_rate * 1e3))
            r = rows[-1]
            print(f"  int8_dwconv {kind} {r['shape']} {dname}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, cuDNN f32 accumulators {r['library_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f} by {r['bound_by']}, {r['bound_ms'] / r['ms']:.0%}; "
                  f"the taps on the FP32 pipe alone {r['fp32_pipe_ms']:.4f})", flush=True)
    return rows


def _int8_block_inputs(side: int, c: int, batch: int, seed: int):
    """A block's float32 input and parameters (``_block_inputs``), its
    weights quantized as ``prepare_quantized`` quantizes them, and its three
    activation scales (Python floats) from the plain float32 path on that
    input, as calibration records them.  Returns (x, the arguments after x
    of ``ops.quantized.int8_block``)."""
    import torch
    import torch.nn.functional as F
    from btsbot_tpu_torch.ops import quantized as tq
    from btsbot_tpu_torch.ops.ln_mlp import _layernorm

    x, (dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma) = _block_inputs(
        side, c, torch.float32, seed, batch=batch)

    def qw(name, w, axes):
        wq, ws = tq.quantize_weight(w, axes)
        return tq.forward_layout(name, wq), ws

    dw = qw("b_dw", tq._hwio(dw_w), (0, 1, 2))
    fc1, fc2 = qw("b_fc1", w1.t(), (0,)), qw("b_fc2", w2.t(), (0,))
    with torch.inference_mode():
        s_x = float(tq._act_scale(x))
        h = _layernorm(tq.int8_dwconv_reference(x, s_x, *dw, dw_b), ln_w, ln_b).reshape(-1, c)
        s_h = float(tq._act_scale(h))
        g = F.gelu(tq._int8_dense(h, s_h, fc1, b1, torch.float32), approximate="tanh")
        s_g = float(tq._act_scale(g))
    return x, [s_x, s_h, s_g, dw, dw_b, ln_w, ln_b, fc1, b1, fc2, b2, gamma]


def _int8_eager_block(x, s_x, s_h, s_g, dw, dw_b, ln_w, ln_b, fc1, b1, fc2, b2, gamma):
    """The block as PR 11's int8 forward ran it on the card: the depthwise
    kernel (``int8_dwconv``), then eager passes around ``torch._int_mm``,
    the dense layers' scales as 0-d tensors on the card."""
    import torch
    import torch.nn.functional as F
    from btsbot_tpu_torch.ops import quantized as tq
    from btsbot_tpu_torch.ops.ln_mlp import _layernorm

    dtype, c = x.dtype, x.shape[-1]
    h = tq.int8_dwconv(x, s_x, *dw, dw_b)
    h = _layernorm(h, ln_w, ln_b).reshape(-1, c)
    h = F.gelu(tq._int8_dense(h, s_h, fc1, b1, dtype), approximate="tanh")
    h = tq._int8_dense(h, s_g, fc2, b2, dtype)
    return x + h.reshape(x.shape) * gamma.to(dtype)


def _int8_block_work(m: int, c: int, item: int) -> tuple[float, float]:
    """(bytes, int8 operations) of one block launch over m pixels of width c
    at hidden 4c in a type of ``item`` bytes: x read once, out written once,
    the int8 weights with their float32 scales, the float parameters; both
    products (2 ops a multiply-add) and the 49 taps."""
    hid = 4 * c
    w_bytes = 49 * c + 2 * c * hid + 4 * (c + hid + c) + item * (5 * c + hid)
    return 2 * m * c * item + w_bytes, 2 * (2 * m * c * hid) + 2 * 49 * m * c


def _int8_block_rows() -> list:
    """The int8 block kernel (csrc/int8_block.cu) against its plain version
    at pico's and nano's stage shapes at batch BATCH and at
    INT8_BLOCK_EXTRA at batch INT8_BLOCK_EXTRA_BATCH, in both types: its
    q_h within one int8 step of the plain version's from the same x, its q_g
    within one step of the plain version's fed the kernel's q_h, its output
    bit for bit equal to the plain tail fed the kernel's q_g; with its time,
    the eager block's of PR 11 (``_int8_eager_block``), the plain version's
    and the bound."""
    import torch
    from btsbot_tpu_torch.ops import quantized as tq

    shapes = [(kind, st, BATCH) for kind in ("convnext_pico", "convnext_nano")
              for st in _stage_shapes(kind)]
    shapes += [(kind, _stage_shapes(kind)[stage], INT8_BLOCK_EXTRA_BATCH)
               for kind, stage in INT8_BLOCK_EXTRA]
    rows = []
    for kind, (side, c, depth), batch in shapes:
        x32, args = _int8_block_inputs(side, c, batch, seed=side * 1000 + c + 7)
        scales = [torch.tensor(v, dtype=torch.float32, device=DEVICE) for v in args[1:3]]
        eager_args = [args[0], *scales, *args[3:]]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            x = x32.to(dtype)
            tag = f"{kind} ({batch},{side},{side},{c}) {dname}"
            with torch.inference_mode():
                out, q_h, q_g = tq._launch_int8_block(x, *args, debug=True)
                _, plain_h, _ = tq.int8_block_reference(x, *args, debug=True)
                _, _, plain_g = tq.int8_block_reference(x, *args, debug=True, q_h=q_h)
                tail = tq.int8_block_reference(x, *args, q_g=q_g)
                free = tq.int8_block_reference(x, *args)
                torch.cuda.synchronize()
                dh = (q_h.int() - plain_h.int()).abs()
                dg = (q_g.int() - plain_g.int()).abs()
                err = float((out.float() - tail.float()).abs().max())
                free_err = float((out.float() - free.float()).abs().max())
                flips_h, flips_g = int((dh > 0).sum()), int((dg > 0).sum())
                check(int(dh.max()) <= 1, f"int8_block {tag}: q_h within one int8 step of the "
                      f"plain version's from the same x ({flips_h} of {dh.numel()} differ)")
                check(int(dg.max()) <= 1, f"int8_block {tag}: q_g within one step of the plain "
                      f"version's fed the kernel's q_h ({flips_g} of {dg.numel()} differ)")
                check(torch.equal(out, tail), f"int8_block {tag}: the output bit for bit equal "
                      f"to the plain tail fed the kernel's q_g (max|d| = {err:.3g}; against "
                      f"the free-running plain version {free_err:.3g})")
                del q_h, q_g, plain_h, plain_g, tail, free, dh, dg
                ms = time_ms(lambda: tq._launch_int8_block(x, *args))
                eager_ms = time_ms(lambda: _int8_eager_block(x, *eager_args), iters=5, warmup=1)
                plain_ms = time_ms(lambda: tq.int8_block_reference(x, *args), iters=5, warmup=1)
            n_bytes, ops = _int8_block_work(batch * side * side, c, x.element_size())
            t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["int8"] * 1e3
            rows.append(dict(
                kind=kind, shape=(batch, side, side, c), depth=depth, dtype=dname,
                max_abs_err=err, free_max_abs_err=free_err, q_h_flips=flips_h,
                q_g_flips=flips_g, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops
                else "operations"))
            r = rows[-1]
            print(f"  int8_block {tag}: {ms:.4f} ms (PR 11's eager block {eager_ms:.4f}, plain "
                  f"{plain_ms:.4f}, bound {r['bound_ms']:.4f} by {r['bound_by']}, "
                  f"{r['bound_ms'] / ms:.0%})", flush=True)
            del x, out
        del x32, args, eager_args
        torch.cuda.empty_cache()
    return rows


def _int8_block_build(state: dict) -> None:
    """int8_block.cu's ptxas lines (each kernel's registers and spills) and
    IGMMA (int8 tensor-core) instructions in every one of its kernels."""
    from btsbot_tpu_torch.ops import _build

    report = state.get("ptxas", "")
    kernel = ""
    for line in report[report.find("== int8_block.cu"):].splitlines()[1:]:
        if line.startswith("=="):
            break
        if "Compiling entry function" in line:
            m = re.search(r"ILi(\d+)E(f|13__nv_bfloat16)E", line)
            kernel = (f"int8_block_kernel<{m.group(1)}, "
                      f"{'float' if m.group(2) == 'f' else 'bf16'}>" if m else line)
        elif "Used" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"  ptxas {kernel}: {line.split(': ', 1)[-1].strip()}", flush=True)
    igmma = {k: n for k, n in _build.sass_opcode_counts("IGMMA").items()
             if "int8_block_kernel" in k}
    print(f"  IGMMA instructions in the int8 block kernels: {sorted(igmma.values())}", flush=True)
    check(len(igmma) == INT8_BLOCK_KERNELS and min(igmma.values()) > 0,
          f"all {INT8_BLOCK_KERNELS} int8 block kernels ({len(WGMMA_WIDTHS)} padded widths x "
          f"float32 / bfloat16) hold IGMMA instructions")


@contextlib.contextmanager
def _patched(module, **fns):
    """``module``'s functions replaced by ``fns`` for the block's length."""
    saved = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _int8_split(qp, images, meta, iters: int = 5) -> dict:
    """The int8 forward at batch BATCH split with CUDA events into its block
    launches (csrc/int8_block.cu), the int8 GEMMs (``torch._int_mm``: the
    stem and the downsamples), their quantize and dequantize passes, and the
    rest (the stem's and downsamples' LNs and patchify copies, the heads).
    The spans wrap four functions of ``ops.quantized``; each span's calls a
    forward are checked against the forward's structure, so a renamed or
    inlined function fails here instead of moving its time into the rest."""
    import torch
    from btsbot_tpu_torch.ops import quantized as tq

    spans = {"block launches": [], "int8 GEMMs": [], "quantize passes": [],
             "dequantize passes": []}
    wrapped = {"_launch_int8_block": "block launches", "int8_matmul": "int8 GEMMs",
               "quantize_act": "quantize passes", "_dequant": "dequantize passes"}

    def timed(fn, key):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[key].append((start, end))
            return out
        return run

    tq.quantized_convnext_logits(qp, images, meta)
    whole = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    with _patched(tq, **{name: timed(getattr(tq, name), key) for name, key in wrapped.items()}):
        torch.cuda.synchronize()
        whole[0].record()
        for _ in range(iters):
            tq.quantized_convnext_logits(qp, images, meta)
        whole[1].record()
        torch.cuda.synchronize()
    out = {k: sum(a.elapsed_time(b) for a, b in v) / iters for k, v in spans.items()}
    out["calls"] = {k: len(v) / iters for k, v in spans.items()}
    blocks, stages = sum(qp["depths"]), len(qp["depths"])
    # one launch a block; a GEMM with its passes for the stem and each downsample
    want = {"block launches": blocks, "int8 GEMMs": stages, "quantize passes": stages,
            "dequantize passes": stages}
    check(out["calls"] == want, f"the int8 forward's split wraps {want} calls a forward "
                                f"({out['calls']})")
    out["forward"] = whole[0].elapsed_time(whole[1]) / iters
    out["rest"] = out["forward"] - sum(out[k] for k in spans)
    return out


def _qparams_on(qp: dict, device: str) -> dict:
    import torch
    return {**qp, "device": torch.device(device),
            "weights": {k: (wq.to(device), ws.to(device)) for k, (wq, ws) in qp["weights"].items()},
            "state_dict": {k: v.to(device) for k, v in qp["state_dict"].items()}}


def _int8_card_trace(qp, images, meta) -> tuple:
    """The card's float32 int8 forward, with each block launch's input, q_h,
    q_g and output (the kernel's debug outputs) and each int8 GEMM's input
    and output copied to the host in call order, and its logits."""
    import torch
    from btsbot_tpu_torch.ops import quantized as tq

    trace = {"blk": [], "mm": []}
    launch, matmul = tq._launch_int8_block, tq.int8_matmul

    def blk(x, *args, debug=False):
        out, q_h, q_g = launch(x, *args, debug=True)
        trace["blk"].append((x.cpu(), q_h.cpu(), q_g.cpu(), out.cpu()))
        return out

    def mm(a, w):
        out = matmul(a, w)
        trace["mm"].append((a.cpu(), out.cpu()))
        return out

    with _patched(tq, _launch_int8_block=blk, int8_matmul=mm):
        logits = tq.quantized_convnext_logits(qp, images, meta, dtype=torch.float32)
    return trace, logits.cpu()


def _int8_replay(host_qp, images, meta, trace, logits) -> dict:
    """The host's float32 int8 forward (the plain block, the host's
    ``_int_mm``) teacher-forced with the card's trace.  Each block compares
    the host's input with the card's, then from the card's input its q_h
    with the card's q_h, from the card's q_h its q_g with the card's q_g,
    and from the card's q_g its output, which must equal the card's bit for
    bit; each int8 GEMM (stem, downsamples) compares its int8 input with the
    card's and takes the card's, its result bit for bit.  An ulp of a
    LayerNorm or a GELU between the two devices flips an int8 value by one
    step at most and leaves the forced forward's features equal; a wrong
    scale or operand on the card moves a block input, an int8 value or a
    block output further."""
    import torch
    from btsbot_tpu_torch.ops import quantized as tq

    blks, mms = list(trace["blk"]), list(trace["mm"])
    st = {"x": 0.0, "step": 0, "flips": 0, "values": 0, "exact": True}
    reference, matmul = tq.int8_block_reference, tq.int8_matmul

    def steps(a, b):
        d = (a.int() - b.int()).abs()
        st["step"] = max(st["step"], int(d.max()))
        st["flips"] += int((d > 0).sum())
        st["values"] += d.numel()

    def blk(x, *args, debug=False):
        card_x, card_h, card_g, card_out = blks.pop(0)
        st["x"] = max(st["x"], float((x - card_x).abs().max()))
        with _patched(tq, int8_matmul=matmul):  # the block's own products are not traced
            steps(reference(card_x, *args, debug=True)[1], card_h)
            steps(reference(card_x, *args, debug=True, q_h=card_h)[2], card_g)
            out = reference(card_x, *args, q_g=card_g)
        st["exact"] &= torch.equal(out, card_out)
        return out

    def mm(a, w):
        card_a, card_out = mms.pop(0)
        steps(a, card_a)
        out = matmul(card_a, w)
        st["exact"] &= torch.equal(out, card_out)
        return out

    with _patched(tq, int8_block_reference=blk, int8_matmul=mm):
        host = tq.quantized_convnext_logits(host_qp, images, meta, dtype=torch.float32)
    st["exact"] &= not blks and not mms
    st["logits"] = float((host - logits).abs().max())
    st["holds"] = (st["exact"] and st["x"] <= INT8_X_ATOL and st["step"] <= 1
                   and st["logits"] <= INT8_F32_ATOL)
    return st


def _int8_host_check(name, qp, images, meta, all_images, all_meta) -> dict:
    """The card's int8 forward (the block kernel, cuBLASLt's int8 GEMMs) at
    dtype=float32 replayed on the host on the same qparams and INT8_HOST
    alerts (``_int8_replay``); then once with INT8_MUTANT's weight scale
    doubled on the card (a wrong dequantize scale in one block), which the
    replay must find, beside the 0.015 check against the bf16 model on it."""
    from btsbot_tpu_torch.ops import quantized as tq

    host_qp = _qparams_on(qp, "cpu")
    images_h, meta_h = images.cpu(), meta.cpu()
    good = _int8_replay(host_qp, images_h, meta_h, *_int8_card_trace(qp, images, meta))
    wq, ws = qp["weights"][INT8_MUTANT]
    bad_qp = {**qp, "weights": {**qp["weights"], INT8_MUTANT: (wq, ws * 2)}}
    bad = _int8_replay(host_qp, images_h, meta_h, *_int8_card_trace(bad_qp, images, meta))
    bad_parity = tq.verify_quantized_parity(bad_qp, all_images, all_meta, tol=INT8_TOL)

    def show(st):
        return (f"GEMMs and block outputs bit for bit: {st['exact']}, block inputs max|d| "
                f"{st['x']:.4g}, int8 values {st['flips']} of {st['values']} differ (by at most "
                f"{st['step']} steps), logits max|d| {st['logits']:.4g}")
    print(f"  {name}: float32 int8 forward on the card replayed on the host ({len(images)} "
          f"alerts): {show(good)}; limits: exact, {INT8_X_ATOL}, one step, {INT8_F32_ATOL}",
          flush=True)
    print(f"  {name}: with {INT8_MUTANT}'s weight scale doubled on the card: {show(bad)}; vs "
          f"the bf16 model max|Δscore| {bad_parity['max_score_diff']:.4g} (the {INT8_TOL} "
          f"check: {'close' if bad_parity['close'] else 'not close'})", flush=True)
    check(good["holds"], f"{name}: the card's float32 int8 forward replays on the host")
    check(not bad["holds"], f"{name}: the replay finds {INT8_MUTANT}'s weight scale doubled")
    return {"replay": good, "mutant_replay": bad,
            "mutant_max_score_diff": bad_parity["max_score_diff"]}


def phase_int8(state: dict) -> None:
    """The int8 quantized path (ops/quantized.py): the block kernel's build
    (ptxas, IGMMA) and its three checks at every stage shape of pico and
    nano and at atto's C = 40 and base's C = 1024 (``_int8_block_rows``),
    the depthwise kernel (calibration's) against its plain version at every
    stage shape of pico and nano, then the flagship and nano calibrated on
    512 triplets (the depthwise kernel once a block) and scored on 3072
    others (the block kernel once a block, the depthwise kernel never),
    within 0.015 of the port's bf16 model on the same weights, the float32
    forward on the card against the host's (``_int8_host_check``), with the
    counted launches, alerts/s and the forward split."""
    import numpy as np
    import torch
    from btsbot_tpu_torch.models.factory import build_model
    from btsbot_tpu_torch.ops import quantized as tq

    _int8_block_build(state)
    print(f"  the block kernel's bound: {INT8_BLOCK_BOUND}", flush=True)
    block_rows = _int8_block_rows()
    report = state.get("ptxas", "")
    for line in report[report.find("== int8_dwconv.cu"):].splitlines()[1:]:
        if line.startswith("=="):
            break
        if "Used" in line or "spill" in line:
            print(f"  ptxas int8_dwconv: {line.split(': ', 1)[-1].strip()}", flush=True)
    rate, how = _fma_rate()
    print(f"  the depthwise kernel's bound: {INT8_BOUND}; the taps on the FP32 pipe alone "
          f"(the kernel's own floor, not its bound): 49 multiply-adds an output at {how}",
          flush=True)
    rows = _int8_dw_rows("convnext_pico", rate) + _int8_dw_rows("convnext_nano", rate)
    res = {"rows": rows, "block_rows": block_rows, "fma_rate": how, "paths": {}}
    meta_all = np.random.default_rng(83).normal(size=(BATCH, len(META_COLS))).astype(np.float32)
    for name, (config, kind, per_forward) in INT8_FORWARDS.items():
        model = build_model(config, dtype=torch.float32, device=DEVICE, seed=0)
        _randomise(model, seed=1)
        weights = model.state_dict()
        cal = torch.from_numpy(_normalised_triplets(INT8_CAL, seed=81)).to(DEVICE)
        images = torch.from_numpy(_normalised_triplets(BATCH, seed=82)).to(DEVICE)
        meta = torch.from_numpy(meta_all).to(DEVICE)
        mark = _launches(by=4)
        qp = tq.prepare_quantized(weights, config, cal)
        torch.cuda.synchronize()
        cal_launches = _launches(mark, kernels=("int8_dwconv",))["int8_dwconv"]
        check(cal_launches == per_forward, f"{name}: {per_forward} int8_dwconv launches in "
                                           f"the calibration ({cal_launches})")
        tq.quantized_convnext_logits(qp, images, meta)  # warm
        torch.cuda.synchronize()
        mark = _launches(by=4)
        logits = tq.quantized_convnext_logits(qp, images, meta)
        torch.cuda.synchronize()
        launches, dw_launches = _launches(mark, kernels=("int8_block", "int8_dwconv")).values()
        check(launches == per_forward and dw_launches == 0,
              f"{name}: {per_forward} int8_block launches in the int8 forward ({launches}), "
              f"no int8_dwconv launch ({dw_launches})")
        check(logits.shape == (BATCH,) and bool(torch.isfinite(logits.float()).all()),
              f"{name}: finite int8 logits of shape ({BATCH},)")
        parity = tq.verify_quantized_parity(qp, images, meta, tol=INT8_TOL)
        scores = torch.sigmoid(logits.float())
        print(f"  {name}: int8 vs the bf16 model, max|Δscore| = "
              f"{parity['max_score_diff']:.4g}; the int8 scores span {float(scores.min()):.4f} "
              f"to {float(scores.max()):.4f}", flush=True)
        check(parity["close"], f"{name}: int8 scores within {INT8_TOL} of the port's bf16 "
                               f"model on the same weights")
        host = _int8_host_check(name, qp, images[:INT8_HOST], meta[:INT8_HOST],
                                images, meta)
        ms = time_ms(lambda: torch.sigmoid(
            tq.quantized_convnext_logits(qp, images, meta).float()), iters=5, warmup=1)
        split = _int8_split(qp, images, meta)
        res["paths"][name] = {"launches": launches, "cal_launches": cal_launches,
                              "max_score_diff": parity["max_score_diff"],
                              "alerts_per_s": BATCH / ms * 1e3, "split": split, **host}
        print(f"  {name} int8 forward at batch {BATCH}: {BATCH / ms * 1e3:.1f} alerts/s; "
              f"split {split['forward']:.3f} ms = " + ", ".join(
                  f"{k} {split[k]:.3f} ({split['calls'][k]} calls)" for k in split["calls"])
              + f", rest {split['rest']:.3f} on {state['gpu']}", flush=True)
    state["int8"] = res


# ------------------------------ examples ------------------------------

EXAMPLE_SCRIPTS = {name: os.path.join(ROOT, "examples", f"{name}_torch.py")
                   for name in ("inference_example", "serving_daemon", "train_quickstart")}


def _example_main(name: str, argv: list):
    """An example script's ``main(argv)``, run in this process."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"{name}_torch", EXAMPLE_SCRIPTS[name])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main(argv)


def phase_examples(state: dict) -> None:
    """The port's examples on the card: the shipped example model's f32
    scores (TF32 off since phase 1) within 1e-5 of its golden scores, the
    serving daemon over 2,000 synthetic packets, the training quickstart for
    one epoch on 512 alerts."""
    import numpy as np
    from btsbot_tpu_torch.ops import _build

    secs = {}
    t0 = time.perf_counter()
    out = _example_main("inference_example", ["--local", "--device", DEVICE])
    secs["inference_example --local"] = time.perf_counter() - t0
    d = float(np.abs(out["scores"] - out["expected_scores"]).max())
    print(f"  inference_example_torch --local: max|score - golden| = {d:.3g}", flush=True)
    check(out["scores"].shape == (16,) and d <= 1e-5,
          "the example model's f32 scores on the card within 1e-5 of the golden scores")
    t0 = time.perf_counter()
    stats = _example_main("serving_daemon", ["--synthetic", "2000", "--device", DEVICE])
    secs["serving_daemon --synthetic 2000"] = time.perf_counter() - t0
    check(stats["alerts_in"] == stats["alerts_scored"] == 2000 and stats["dropped"] == 0
          and _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR,
          "serving_daemon_torch scored all 2,000 synthetic packets")
    scratch, _ = _smoke_split(state)
    t0 = time.perf_counter()
    out = _example_main("train_quickstart", ["--epochs", "1", "--n", "512", "--device", DEVICE,
                                             "--out", os.path.join(scratch, "quickstart")])
    secs["train_quickstart --epochs 1 --n 512"] = time.perf_counter() - t0
    check(bool(np.all(np.isfinite(out["scores"])))
          and os.path.isfile(os.path.join(out["result"]["model_dir"], "best_model.pth")),
          "train_quickstart_torch trained an epoch, wrote best_model.pth and served the val "
          "split")
    state["examples"] = secs
    print("  examples: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f" on {state['gpu']}", flush=True)


# ------------------------------ phase "mesh" ------------------------------

MESH_SHAPES = ((2, 1), (1, 2))       # two ranks sharing the one card over gloo
MESH_KINDS = {"convnext_pico.d1_in1k": "convnext_block_fused",
              "inceptionnext_pico.r2": "fused_ln_mlp"}
MESH_SCORE_BATCH = 512
MESH_SCORE_ALERTS = 2 * MESH_SCORE_BATCH + 76   # two full batches and a tail
MESH_STEP_ITERS = 10


def _whole_grads(model, mesh) -> dict:
    """Every parameter's gradient as a whole tensor (a sharded weight's
    shards gathered over the model group)."""
    from btsbot_tpu_torch.parallel.mesh import all_gather_rows
    from btsbot_tpu_torch.parallel.sharding import full_named_parameters, module_shardings

    dims = module_shardings(model, mesh) if mesh is not None else {}
    out = {}
    for name, p in full_named_parameters(model):
        g = p.grad
        if name in dims:
            d, m = dims[name], mesh.shape["model"]
            g = all_gather_rows(g.movedim(d, 0), mesh.model_group, m).movedim(0, d)
        out[name] = g.detach().cpu().clone()
    return out


def _mesh_step(config, weights, batch, mesh, device, timed: bool = True,
               profile: str | None = None) -> dict:
    """One f32 train step of a fresh model holding ``weights`` on the global
    ``batch`` (this rank's rows under ``mesh``): loss, whole gradients, the
    head's output weight after the step, kernel launches; then (``timed``)
    the step's time over ``MESH_STEP_ITERS`` more steps and the gradient
    all-reduce's (host clock, synchronised), and (``profile``, a label) a
    ``torch.profiler`` table of the step (information only)."""
    import torch
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.engine.state import create_train_state
    from btsbot_tpu_torch.engine.steps import average_gradients, make_train_step
    from btsbot_tpu_torch.models.factory import build_model
    from btsbot_tpu_torch.parallel.mesh import batch_sharding
    from btsbot_tpu_torch.parallel.sharding import full_state_dict

    config = normalize_config(config)
    model = build_model(config, device=device)
    model.load_state_dict(weights)
    st = create_train_state(config, model, steps_per_epoch=TRAIN_ALERTS // TRAIN_BATCH,
                            mesh=mesh)
    *arrays, pos_weight = batch
    if mesh is not None:
        arrays = [batch_sharding(mesh)(x) for x in arrays]
    inputs = [torch.from_numpy(x).to(device) for x in arrays]
    step = make_train_step(config, mesh=mesh)
    torch.cuda.synchronize()
    mark = _launches(by=4)
    m = step(st, *inputs, pos_weight)
    torch.cuda.synchronize()
    out = {"loss": m["loss"].item(), "launches": _launches(mark),
           "grads": _whole_grads(model, mesh),
           "out_w": full_state_dict(model)["combined_head.5.weight"].cpu().clone()}
    ms = {}
    for name, fn in (() if not timed else
                     (("step", lambda: step(st, *inputs, pos_weight)),
                      ("all_reduce", lambda: average_gradients(
                          [p for p in model.parameters() if p.grad is not None], mesh)))):
        if name == "all_reduce" and mesh is None:
            continue
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_STEP_ITERS):
            fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / MESH_STEP_ITERS
    out["ms"] = ms
    if profile is not None:
        _profile(lambda: step(st, *inputs, pos_weight), profile)
    return out


def _mesh_scores(config, weights, trips, meta, dtype, mesh, device):
    """``AlertScorer`` scores at batch 512 and the launches it made."""
    import torch
    from btsbot_tpu_torch.engine.serve import AlertScorer

    sc = AlertScorer(config, weights, batch_size=MESH_SCORE_BATCH, dtype=dtype, mesh=mesh,
                     device=device)
    torch.cuda.synchronize()
    mark = _launches(by=4)
    scores = sc(trips, meta)
    torch.cuda.synchronize()
    return scores, _launches(mark)


def mesh_rank(workdir: str) -> None:
    """One of two ranks sharing the card over gloo (``phase_mesh`` spawns
    them): under each mesh of ``MESH_SHAPES``, one f32 step of each kind
    and the flagship's scorers; rank ``r`` writes ``rank{r}.pt``."""
    import torch
    import torch.distributed as dist
    from btsbot_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    meshes = {s: make_mesh(data=s[0], model=s[1]) for s in MESH_SHAPES}
    out = {"steps": {}, "scores": {}}
    for shape, mesh in meshes.items():
        for kind in MESH_KINDS:
            out["steps"][shape, kind] = _mesh_step(
                inp["configs"][kind], inp["weights"][kind], inp["batch"], mesh, DEVICE,
                timed=kind == "convnext_pico.d1_in1k")
        for dname in ("float32", "bfloat16"):
            out["scores"][shape, dname] = _mesh_scores(
                inp["configs"]["convnext_pico.d1_in1k"], inp["weights"]["convnext_pico.d1_in1k"],
                *inp["serve"], getattr(torch, dname), mesh, DEVICE)
    torch.save(out, os.path.join(workdir, f"rank{dist.get_rank()}.pt"))


def phase_mesh(state: dict) -> None:
    """(a) ``run_training(mesh=make_mesh())`` at world size 1 under NCCL
    against the same run without a mesh; (b) two ranks on the card over
    gloo at 2x1 and 1x2: one f32 step of the flagship and of
    mm_InceptionNeXt-pico.r2 against the one-process step; (c)
    ``AlertScorer(mesh=)`` on those ranks against the unsharded scorer."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from btsbot_tpu_torch.core.config import normalize_config
    from btsbot_tpu_torch.data.dataset import load_split
    from btsbot_tpu_torch.engine.checkpoint import load_model_checkpoint
    from btsbot_tpu_torch.engine.eval import predict_dataset
    from btsbot_tpu_torch.engine.serve import AlertScorer
    from btsbot_tpu_torch.engine.train import run_training
    from btsbot_tpu_torch.models.factory import build_model
    from btsbot_tpu_torch.parallel.dryrun import spawn
    from btsbot_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    tmp, data_dir = _smoke_split(state)
    config = normalize_config(_train_config(epochs=1))
    val = load_split(config, "val", data_dir)
    steps = TRAIN_ALERTS // TRAIN_BATCH
    evals = -(-VAL_ALERTS // TRAIN_BATCH)
    launches = {"convnext_block_fused": 0, "fused_ln_mlp": 0}
    timing = {}

    # ---- (a) world size 1 under NCCL against no mesh, deterministic cuDNN
    initialize_distributed(backend="nccl")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = make_mesh()
        scores = {}
        for name, m in (("no mesh", None), ("mesh 1x1", mesh)):
            torch.cuda.synchronize()
            mark = _launches(by=4)
            t0 = time.perf_counter()
            r = run_training(config, data_dir=data_dir, out_root=os.path.join(tmp, "mesh_a"),
                             run_name=name.replace(" ", "_"), log=lambda _m: None,
                             device=DEVICE, mesh=m)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n = _launches(mark)["convnext_block_fused"]
            model = build_model(config, device=DEVICE)
            model.load_state_dict(load_model_checkpoint(config, r["model_dir"]), strict=True)
            scores[name] = predict_dataset(model, config, val)[1]
            print(f"  run_training {name}: 1 epoch {secs:.1f} s, {n} block launches, "
                  f"train loss {r['history']['train_loss'][0]:.6f}", flush=True)
            check(n == 12 * (steps + evals), f"{name}: 12 block launches a train step and an "
                                             f"eval batch ({12 * (steps + evals)})")
            if m is not None:
                launches["convnext_block_fused"] += n
        d = float(np.abs(scores["mesh 1x1"] - scores["no mesh"]).max())
        print(f"  best_model.pth of the 1x1 NCCL run vs the run without a mesh: val scores "
              f"max|d| = {d:.3g}", flush=True)
        check(d <= 1e-6, "run_training(mesh=make_mesh()) at world size 1 under NCCL: its "
                         "best_model.pth scores within 1e-6 of the run without a mesh")
        train = load_split(config, "train", data_dir)
        batch = (train.images[:TRAIN_BATCH], train.metadata[:TRAIN_BATCH],
                 train.labels[:TRAIN_BATCH], train.pos_weight)
        one = _mesh_step(config, state["weights"], batch, mesh, DEVICE,
                         profile="flagship f32 step at batch 64, 1x1 mesh under NCCL")
        timing["1x1 nccl"] = one["ms"]
    finally:
        torch.backends.cudnn.deterministic = det
        dist.destroy_process_group()

    # ---- (b), (c): two ranks on the card over gloo (CUDA tensors)
    configs = {kind: _train_config(model_kind=kind, epochs=1) for kind in MESH_KINDS}
    r2 = build_model(configs["inceptionnext_pico.r2"], device="cpu", seed=0)
    _randomise(r2, seed=5)
    weights = {"convnext_pico.d1_in1k": {k: v.cpu() for k, v in state["weights"].items()},
               "inceptionnext_pico.r2": r2.state_dict()}
    trips = _normalised_triplets(MESH_SCORE_ALERTS, seed=21)
    meta = np.random.default_rng(22).normal(
        size=(MESH_SCORE_ALERTS, len(META_COLS))).astype(np.float32)
    work = os.path.join(tmp, "mesh_ranks")
    os.makedirs(work)
    torch.save({"configs": configs, "weights": weights, "batch": batch,
                "serve": (trips, meta)}, os.path.join(work, "inputs.pt"))
    t0 = time.perf_counter()
    spawn(2, "chip_smoke:mesh_rank", [work], backend="gloo", timeout=300)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    print(f"  2 ranks on the card over gloo: {time.perf_counter() - t0:.1f} s with their "
          f"start", flush=True)
    for kind, kernel in MESH_KINDS.items():
        flagship = kind == "convnext_pico.d1_in1k"
        want = _mesh_step(configs[kind], weights[kind], batch, None, DEVICE, timed=flagship,
                          profile="the same step in one process, no mesh" if flagship
                          else None)
        if flagship:
            timing["1x1 one process"] = want["ms"]
        for shape in MESH_SHAPES:
            for r, res in enumerate(ranks):
                got = res["steps"][shape, kind]
                rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
                worst, worst_name = max(
                    ((got["grads"][n] - g).abs().max().item()
                     / max(g.abs().max().item(), 1e-30), n) for n, g in want["grads"].items())
                w_ok = torch.allclose(got["out_w"], want["out_w"], rtol=1e-5, atol=1e-7)
                n = got["launches"][kernel]
                print(f"  {kind} {shape[0]}x{shape[1]} rank {r}: loss {got['loss']:.8f} vs "
                      f"{want['loss']:.8f} (rel {rel:.3g}); worst gradient max|d|/max|g| "
                      f"{worst:.3g} ({worst_name}); {n} {kernel} launches", flush=True)
                check(rel <= 1e-5 and worst <= 1e-4 and w_ok and n == 12,
                      f"{kind} step on the {shape[0]}x{shape[1]} mesh, rank {r}: loss rtol "
                      f"1e-5, all-reduced gradients within 1e-4 of their largest entry, the "
                      f"head's output weight rtol 1e-5 / atol 1e-7, 12 {kernel} launches")
                launches[kernel] += n
                if flagship:
                    timing[f"{shape[0]}x{shape[1]} gloo rank {r}"] = got["ms"]
    sc = {}
    for dname in ("float32", "bfloat16"):
        sc[dname], _ = _mesh_scores(configs["convnext_pico.d1_in1k"],
                                    weights["convnext_pico.d1_in1k"], trips, meta,
                                    getattr(torch, dname), None, DEVICE)
    per_rank = 12 * -(-MESH_SCORE_ALERTS // MESH_SCORE_BATCH)
    for shape in MESH_SHAPES:
        for r, res in enumerate(ranks):
            f32, n32 = res["scores"][shape, "float32"]
            bf16, n16 = res["scores"][shape, "bfloat16"]
            d32 = float(np.abs(f32 - sc["float32"]).max())
            d16 = float(np.abs(bf16 - f32).max())
            print(f"  AlertScorer {shape[0]}x{shape[1]} rank {r}: f32 max|d| vs unsharded "
                  f"{d32:.3g}, bf16 vs f32 {d16:.3g}; {n32['convnext_block_fused']} + "
                  f"{n16['convnext_block_fused']} block launches", flush=True)
            check(f32.shape == (MESH_SCORE_ALERTS,) and d32 <= 1e-5 and d16 <= 0.01
                  and n32["convnext_block_fused"] == n16["convnext_block_fused"] == per_rank,
                  f"AlertScorer on the {shape[0]}x{shape[1]} mesh, rank {r}: all "
                  f"{MESH_SCORE_ALERTS} scores, f32 within 1e-5 of the unsharded scorer, "
                  f"bf16 within 0.01 of f32, {per_rank} block launches a type")
            launches["convnext_block_fused"] += n32["convnext_block_fused"] + \
                n16["convnext_block_fused"]
    for name, ms in timing.items():
        share = (f", gradient all-reduce {ms['all_reduce']:.3f} ms "
                 f"({100 * ms['all_reduce'] / ms['step']:.1f} %)" if "all_reduce" in ms else "")
        print(f"  flagship f32 step at global batch {TRAIN_BATCH}, {name}: {ms['step']:.3f} ms"
              f"{share} on {state['gpu']}", flush=True)
    state["mesh"] = {"launches": launches, "timing": timing}


# ------------------------------ phase 16 ------------------------------

def _kernel_entry(name, source, replaces, launches, rows):
    """One forward's worth of launches at batch 3072 in bf16 (the serving
    type): each stage's time × its depth, summed over the four stages."""
    bf = [r for r in rows if r["dtype"] == "bfloat16"]

    def total(key):
        return sum(r[key] * r["depth"] for r in bf)

    t_ops = sum(r["bound_ms"] * r["depth"] for r in bf if r["bound_by"] == "operations")
    t_bytes = sum(r["bound_ms"] * r["depth"] for r in bf if r["bound_by"] == "bytes")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": None,
            "per": "one pico forward at batch 3072, bfloat16 (12 launches)"}


def _f32_entry(name, replaces, launches, rows):
    """The float32 kernel of one function (csrc/tf32x3.cu): a pico forward's
    12 launches at batch 3072 against the bound of three TF32 products
    (``bound_ms``) and the bound of exact float32 (``bound_f32_ms``)."""
    f = [r for r in rows if r["dtype"] == "float32"]

    def total(key):
        return sum(r[key] * r["depth"] for r in f)

    t_ops = sum(r["bound3_ms"] * r["depth"] for r in f if r["bound3_by"] == "operations")
    t_bytes = sum(r["bound3_ms"] * r["depth"] for r in f if r["bound3_by"] == "bytes")
    return {"name": f"{name} (float32)", "route": "cuda",
            "source": "btsbot_tpu_torch/csrc/tf32x3.cu", "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in f),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound3_ms"),
            "bound_by": "operations" if t_ops > t_bytes else "bytes", "library_ms": None,
            "bound_f32_ms": total("bound_ms"),
            "per": "one pico forward at batch 3072, float32 (12 launches); bound_ms: the "
                   "products as three TF32 products (495 / 3 TFLOP/s), the taps at 67 "
                   "TFLOP/s; bound_f32_ms: every operation at 67 TFLOP/s"}


def phase_report(state: dict) -> None:
    res = state["kernel_results"]
    fam = state["families"]
    paths = {"mm_ConvNeXt serving": state["launches_main"]["convnext_block_fused"],
             **fam["launches"], "mm_ConvNeXt-nano serving": state["nano"]["launches"]}
    inc = state["inceptionnext"]
    ln_mlp_paths = {"fast_mm_convnext_logits": state["launches_fast"]["fused_ln_mlp"],
                    **inc["launches"]}
    # this slice's path: cli.distill, the teacher's blocks forward only
    paths["cli.distill teacher (mm_ConvNeXt-pico, forward only)"] = \
        state["distill_launches"]["convnext_block_fused"]
    ln_mlp_paths[f"cli.distill student ({DISTILL_STUDENT}, train + eval)"] = \
        state["distill_launches"]["fused_ln_mlp"]
    # this slice's path: acquisition → cli.dataset → cli.train → cli.export
    # (ONNX verified on the card) → cli.publish, and an InceptionNeXt export
    lc = state["lifecycle"]["total"]
    paths["lifecycle (cli.train 1 epoch + ONNX verifications at 16 and 256 alerts + "
          "SavedModel verifications at 16, the mutant's too)"] = \
        lc["convnext_block_fused"]
    ln_mlp_paths[f"lifecycle ({LIFECYCLE_INCEPTION} ONNX verification)"] = lc["fused_ln_mlp"]
    # this slice's path: the mesh (run_training at world size 1 under NCCL;
    # two ranks sharing the card over gloo: steps at 2x1 and 1x2 and the
    # flagship's AlertScorer, the ranks' counts summed)
    mesh = state["mesh"]["launches"]
    paths["mesh (run_training 1x1 NCCL; 2 gloo ranks on the card: 2x1 / 1x2 flagship steps "
          "and AlertScorer f32 + bf16)"] = mesh["convnext_block_fused"]
    ln_mlp_paths["mesh (2 gloo ranks on the card: 2x1 / 1x2 mm_InceptionNeXt-pico.r2 "
                 "steps)"] = mesh["fused_ln_mlp"]
    distill_shapes = {}
    for (name, n_b, dname), t in state["distill_kernels"].items():
        distill_shapes.setdefault(name, {})[f"batch {n_b} {dname}"] = dict(
            t, per=f"a forward's 12 launches at the pico stage shapes, batch {n_b}, {dname}"
                    + (", hidden 2C" if name == "fused_ln_mlp" else ""))
    kernels = [
        _kernel_entry("convnext_block_fused", "btsbot_tpu_torch/csrc/convnext_block.cu",
                      "btsbot_tpu/ops/pallas_convnext.py:147", sum(paths.values()),
                      res["convnext_block_fused"]),
        _kernel_entry("fused_ln_mlp", "btsbot_tpu_torch/csrc/ln_mlp.cu",
                      "btsbot_tpu/ops/pallas_mlp.py:99", sum(ln_mlp_paths.values()),
                      res["fused_ln_mlp"]),
    ]
    # each serving path's count, and the training paths' (the cli.train runs
    # of phases 6, 7 and 9)
    kernels[0]["launches_by_path"] = paths
    kernels[0]["launches_train"] = state["launches_train"] + fam["train_launches"]
    kernels[1]["launches_by_path"] = ln_mlp_paths
    kernels[1]["launches_train"] = inc["train_launches"]
    for entry in kernels:
        entry["distill_shapes"] = distill_shapes[entry["name"]]
    r2 = _kernel_entry("fused_ln_mlp", "", "", 0, res["fused_ln_mlp_r2"])
    kernels[1]["hidden_2c"] = {k: r2[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "max_abs_err")}
    kernels[1]["hidden_2c"]["per"] = ("one inceptionnext_pico.r2 forward at batch 3072, "
                                      "bfloat16 (12 launches)")
    # the float32 kernels: launches of the main path's f32 scorer (the block)
    # and of the f32 fast path (fused_ln_mlp)
    f32_entries = [
        _f32_entry("convnext_block_fused", "btsbot_tpu/ops/pallas_convnext.py:147",
                   state["launches_main_f32"], res["convnext_block_fused"]),
        _f32_entry("fused_ln_mlp", "btsbot_tpu/ops/pallas_mlp.py:99",
                   state["launches_fast"]["fused_ln_mlp"], res["fused_ln_mlp"]),
    ]
    r2 = _f32_entry("fused_ln_mlp", "", 0, res["fused_ln_mlp_r2"])
    f32_entries[1]["hidden_2c"] = {k: r2[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                      "bound_f32_ms", "max_abs_err")}
    # nano's stage shapes at the serving batch (phase "widths"), a forward's
    # 14 launches in bf16 on the wgmma_any kernels
    for entry, name in zip(kernels, ("convnext_block_fused", "fused_ln_mlp")):
        rows = [r for (n, _, _), rs in state["nano_results"].items() if n == name for r in rs]
        nano = _kernel_entry(name, "", "", 0, rows)
        entry["nano_forward"] = {k: nano[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                      "max_abs_err")}
        entry["nano_forward"]["per"] = (f"one convnext_nano forward at batch {BATCH}, "
                                        f"bfloat16 ({NANO_LAUNCHES} launches, wgmma_any)")
    print("  the first version of both kernels (float FMAs on the CUDA cores), recorded "
          "on an NVIDIA H100 80GB HBM3 at 700 W and not measured here: "
          "convnext_block_fused 27.6 ms, fused_ln_mlp 24.4 ms for the same 12 launches",
          flush=True)
    for name, (n, secs) in state["timings"].items():
        print(f"  {name}: {n / secs:.1f} alerts/s end to end ({n} alerts, "
              f"{secs:.3f} s) on {state['gpu']}", flush=True)
    for name, rate in state["throughput"].items():
        print(f"  AlertScorer {name} forward on device-resident inputs: "
              f"{rate:.1f} alerts/s on {state['gpu']}", flush=True)
    tr = state["train"]
    print(f"  training, flagship f32 at batch {TRAIN_BATCH}: cli.train "
          f"{tr['epoch_secs'][0]:.1f} s for 2 epochs, {tr['epoch_secs'][1]:.1f} s resumed "
          f"for a third, on {state['gpu']}", flush=True)
    for (n, dname), ms in tr["step_ms"].items():
        print(f"  train step batch {n} {dname}: {n * 1e3 / ms:.1f} alerts/s "
              f"({1e3 / ms:.1f} steps/s)", flush=True)
    for name, r in fam["rates"].items():
        print(f"  {name} forward at batch {BATCH}: bf16 {r['bf16']:.1f}, f32 {r['f32']:.1f} "
              f"alerts/s on {state['gpu']}", flush=True)
    print(f"  mm_cnn train step batch {TRAIN_BATCH}: "
          + ", ".join(f"{d} {1e3 / ms:.1f} steps/s" for d, ms in fam["step_ms"].items())
          + f"; cli.train 2 epochs {fam['mm_cnn_cli_s']:.1f} s; frozen_fusion 1 epoch "
          f"{fam['fusion_cli_s']:.1f} s, on {state['gpu']}", flush=True)
    for kind, (total, ln_mlp) in inc["shares"].items():
        r = inc["rates"][kind]
        print(f"  mm_ConvNeXt {kind} at batch {BATCH}: bf16 {r['bf16']:.1f}, f32 "
              f"{r['f32']:.1f} alerts/s; fused_ln_mlp {100 * ln_mlp / total:.1f} % of the "
              f"bf16 forward; cli.train (.r2) 1 epoch {inc['cli_s']:.1f} s on {state['gpu']}",
              flush=True)
    nano = state["nano"]
    total, blocks = nano["split"]
    print(f"  mm_ConvNeXt-nano at batch {BATCH}: bf16 {nano['rates']['bf16']:.1f}, f32 "
          f"{nano['rates']['f32']:.1f} alerts/s; bf16 forward {total:.3f} ms, its "
          f"{NANO_LAUNCHES} block launches {blocks:.3f} ms ({100 * blocks / total:.1f} %) "
          f"on {state['gpu']}", flush=True)
    mx = state["maxvit"]
    for name in ("mm_MaxViT", "MaxViT"):
        print(f"  {name}: " + ", ".join(
            f"{k} batch {MAXVIT_BATCH[k]} {mx[name]['rates'][k]:.1f} alerts/s "
            f"({mx[name]['memory'][k]:.2f} GiB peak)" for k in MAXVIT_BATCH)
            + f" on {state['gpu']}", flush=True)
    t = mx["train"]
    print(f"  mm_MaxViT train step batch {MAXVIT_TRAIN_BATCH}: " + ", ".join(
        f"{d} {1e3 / ms:.2f} steps/s" for d, ms in t["step_ms"].items())
        + f"; cli.train 1 epoch {t['cli_s']:.1f} s, frozen_fusion over MaxViT "
        f"{t['fusion_cli_s']:.1f} s; maxvit_tiny_rw_160 bf16 {t['rate160']:.1f} alerts/s "
        f"on {state['gpu']}", flush=True)
    # the widths phase: each size's forward, and every width each kernel was
    # launched at in this run (by variant: tuned, wgmma_any or tf32x3)
    from btsbot_tpu_torch.ops import _build
    for kind, (name, n) in WIDTH_FORWARD_LAUNCHES.items():
        entry = kernels[0] if name == "convnext_block_fused" else kernels[1]
        entry["launches_by_path"][f"mm_ConvNeXt {kind} forward (widths)"] = n
    kernels[0]["launches_by_path"]["mm_ConvNeXt cli.serve daemon"] = state["daemon"]["launches"]
    run = _launches(by=4)
    for entry, key in zip(kernels, ("convnext_block", "ln_mlp")):
        entry["max_abs_err"] = max([entry["max_abs_err"]] + [
            r["max_abs_err"] for res_ in (state["width_results"], state["nano_results"])
            for (name, _, _), rows in res_.items() if name == entry["name"] for r in rows])
        by = {}
        for (_, variant, c, hidden), n in sorted(
                (k, n) for k, n in run.items() if k[0] == entry["name"]):
            by.setdefault(variant, {})[f"{c}x{hidden}"] = n
        entry["launches_by_width"] = by
        entry["widths"] = {v: sorted({int(k.split("x")[0]) for k in d}) for v, d in by.items()}
        entry["sources_by_variant"] = {
            "tuned": f"btsbot_tpu_torch/csrc/{key}.cu",
            "wgmma_any": f"btsbot_tpu_torch/csrc/{key}.cu",
            "tf32x3": "btsbot_tpu_torch/csrc/tf32x3.cu"}
        check(set(by) <= set(entry["sources_by_variant"]) and "tf32x3" in by,
              f"{entry['name']}: launched only by its kernels ({sorted(by)}), float32 on "
              f"tf32x3 at widths {entry['widths'].get('tf32x3')}")
    for entry, base in zip(f32_entries, kernels):
        entry["max_abs_err"] = max([entry["max_abs_err"]] + [
            r["max_abs_err"] for res_ in (state["width_results"], state["nano_results"])
            for (name, _, _), rows in res_.items() if name == base["name"] for r in rows
            if r["dtype"] == "float32"])
        entry["launches_by_width"] = base["launches_by_width"]["tf32x3"]
    kernels += f32_entries
    kernels += _int8_entries(state["int8"])
    kernels += _maxvit_entries(state)
    _report_widths(state)
    _report_int8(state)
    _report_daemon(state)
    _report_lifecycle(state)
    state["kernels_line"] = json.dumps({"kernels": kernels})


def _int8_forward(rows: list, kind: str, keys: tuple) -> dict:
    """A ``kind`` int8 forward's launches of one kernel at batch BATCH in
    bf16: each stage's row times its depth, summed, with the bound's side."""
    rows = [r for r in rows if r["kind"] == kind and r["dtype"] == "bfloat16"]
    out = {k: sum(r[k] * r["depth"] for r in rows) for k in keys}
    t = {by: sum(r["bound_ms"] * r["depth"] for r in rows if r["bound_by"] == by)
         for by in ("bytes", "operations")}
    out["bound_by"] = "operations" if t["operations"] > t["bytes"] else "bytes"
    return out


def _int8_entries(res: dict) -> list:
    """The int8 block kernel (csrc/int8_block.cu), launched once a block by
    the int8 forward, and the int8 depthwise kernel (csrc/int8_dwconv.cu),
    launched once a block by the calibration: a pico forward's 12 launches
    at batch 3072 in bf16 (each stage's time x its depth), nano's 14 beside
    them."""
    per = f"one pico int8 forward at batch {BATCH}, bfloat16 (12 launches)"
    nano_per = (f"one convnext_nano int8 forward at batch {BATCH}, bfloat16 ({NANO_LAUNCHES} "
                f"launches)")
    keys = ("ms", "eager_ms", "plain_ms", "bound_ms")
    brows = res["block_rows"]
    block = {"name": "int8_block", "route": "cuda",
             "source": "btsbot_tpu_torch/csrc/int8_block.cu",
             "replaces": "btsbot_tpu/ops/quantized.py:194 (no Pallas kernel: the JAX "
                         "package's int8 block is XLA's)",
             "launches": sum(p["launches"] for p in res["paths"].values()),
             "launches_by_path": {f"{k} int8 forward": p["launches"]
                                  for k, p in res["paths"].items()},
             "max_abs_err": max(r["max_abs_err"] for r in brows),
             **_int8_forward(brows, "convnext_pico", keys), "library_ms": None,
             "nano_forward": dict(_int8_forward(brows, "convnext_nano", keys), per=nano_per),
             "free_max_abs_err": max(r["free_max_abs_err"] for r in brows),
             "q_h_flips": sum(r["q_h_flips"] for r in brows),
             "q_g_flips": sum(r["q_g_flips"] for r in brows),
             "bound_rate": INT8_BLOCK_BOUND,
             "per": per + "; max_abs_err: against the plain tail fed the kernel's q_g (q_h "
                    "and q_g within one int8 step of the plain version's); eager_ms: PR 11's "
                    "block (the depthwise kernel, eager passes, torch._int_mm)"}
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    dw = {"name": "int8_dwconv", "route": "cuda",
          "source": "btsbot_tpu_torch/csrc/int8_dwconv.cu",
          "replaces": "btsbot_tpu/ops/quantized.py:199 (no Pallas kernel: the JAX "
                      "package's int8 depthwise conv is XLA's)",
          "launches": sum(p["cal_launches"] for p in res["paths"].values()),
          "launches_by_path": {f"{k} calibration (prepare_quantized)": p["cal_launches"]
                               for k, p in res["paths"].items()},
          "max_abs_err": max(r["max_abs_err"] for r in res["rows"]),
          **_int8_forward(res["rows"], "convnext_pico", keys),
          "nano_forward": dict(_int8_forward(res["rows"], "convnext_nano", keys), per=nano_per),
          "bound_rate": INT8_BOUND,
          "per": f"the launches of a pico forward at batch {BATCH}, bfloat16 (12; the "
                 "calibration runs them once a block, in float32); library_ms: cuDNN's "
                 "float32 depthwise conv over the integer-valued quantized tensor (the same "
                 "accumulators)"}
    return [block, dw]


def _report_int8(state: dict) -> None:
    res = state["int8"]
    print(f"  int8_block (ms: kernel / PR 11's eager block / plain / bound; bound: "
          f"{INT8_BLOCK_BOUND}; q_h and q_g: values a step from the plain version's) on "
          f"{state['gpu']}:", flush=True)
    for r in res["block_rows"]:
        print(f"    {r['kind']:13s} {str(r['shape']):19s} {r['dtype']:8s} {r['ms']:.4f} / "
              f"{r['eager_ms']:.4f} / {r['plain_ms']:.4f} / {r['bound_ms']:.4f} "
              f"({r['bound_by']}) q_h {r['q_h_flips']} q_g {r['q_g_flips']} "
              f"max|d| given q_g {r['max_abs_err']:.3g}, free {r['free_max_abs_err']:.3g}",
              flush=True)
    print(f"  int8_dwconv at batch {BATCH} (ms: kernel / plain / cuDNN f32 accumulators / "
          f"bound / the taps on the FP32 pipe; bound: {INT8_BOUND}; FP32 pipe: "
          f"{res['fma_rate']}) on {state['gpu']}:", flush=True)
    for r in res["rows"]:
        print(f"    {r['kind']:13s} {str(r['shape']):19s} {r['dtype']:8s} {r['ms']:.4f} / "
              f"{r['plain_ms']:.4f} / {r['library_ms']:.4f} / {r['bound_ms']:.4f} "
              f"({r['bound_by']}) / {r['fp32_pipe_ms']:.4f} max|d|={r['max_abs_err']:.3g}",
              flush=True)
    for name, p in res["paths"].items():
        rate = {"mm_ConvNeXt-pico (flagship)": state["throughput"],
                "mm_ConvNeXt-nano": state["nano"]["rates"]}[name]
        sp = p["split"]
        print(f"  {name} at batch {BATCH}: int8 {p['alerts_per_s']:.1f}, bf16 "
              f"{rate['bf16']:.1f}, f32 {rate['f32']:.1f} alerts/s; int8 forward "
              f"{sp['forward']:.3f} ms = blocks {sp['block launches']:.3f} + int8 GEMMs "
              f"{sp['int8 GEMMs']:.3f} + quantize {sp['quantize passes']:.3f} + dequantize "
              f"{sp['dequantize passes']:.3f} + rest {sp['rest']:.3f}; max|Δscore| vs bf16 "
              f"{p['max_score_diff']:.4g}; float32 replay on the host: logits max|d| "
              f"{p['replay']['logits']:.4g}, {p['replay']['flips']} int8 values a step apart; "
              f"{INT8_MUTANT} doubled: block inputs max|d| {p['mutant_replay']['x']:.4g}, "
              f"max|Δscore| vs bf16 {p['mutant_max_score_diff']:.4g} on {state['gpu']}",
              flush=True)
    print("  examples: " + ", ".join(f"{k} {v:.1f} s" for k, v in state["examples"].items())
          + f" on {state['gpu']}", flush=True)


def _report_widths(state: dict) -> None:
    """Each size's stage shapes at batch 256 (phase "widths"): the block and
    fused_ln_mlp at hidden 4C as a table, every launch (2C and 3C too) in
    ``build/smoke_widths.json`` beside the card's name."""
    rows = [{"kernel": name, "C": c, "hidden": hidden, **r}
            for (name, c, hidden), results in state["width_results"].items()
            for r in results]
    from btsbot_tpu_torch.ops import _build
    order = {s: i for i, s in enumerate(WIDTH_SIZES)}
    rows.sort(key=lambda r: (order[r["size"]], r["C"], r["kernel"], r["hidden"], r["dtype"]))
    print(f"  per-width launches at batch {WIDTHS_BATCH} (ms: kernel / plain / bound) on "
          f"{state['gpu']}:", flush=True)
    for r in rows:
        if r["hidden"] == 4 * r["C"]:
            print(f"    {r['size']:5s} {r['kernel']:20s} {str(tuple(r['shape'])):19s} "
                  f"{r['dtype']:8s} {r['variant']:9s} "
                  f"{r['ms']:.4f} / {r['plain_ms']:.4f} / {r['bound_ms']:.4f} "
                  f"({r['bound_by']}) max|d|={r['max_abs_err']:.3g}"
                  + (f" bound 3xTF32 {r['bound3_ms']:.4f}" if "bound3_ms" in r else ""),
                  flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "smoke_widths.json"), "w") as f:
        json.dump({"card": state["gpu"], "batch": WIDTHS_BATCH, "rows": rows}, f, indent=1)


def _report_daemon(state: dict) -> None:
    for name, st in state["daemon"]["stats"].items():
        print(f"  daemon {name}: {st['alerts_per_s']:.1f} alerts/s, latency p50 "
              f"{st['latency_p50_ms']} ms, p99 {st['latency_p99_ms']} ms, "
              f"{st['batches']} batches on {state['gpu']}", flush=True)
    print(f"  cli.val --calibrate: temperature {state['val']['temperature']}, "
          f"{state['val']['secs']:.1f} s on {state['gpu']}", flush=True)
    dist = state["distill"]
    print(f"  cli.distill ({DISTILL_STUDENT}, 1 epoch at batch {TRAIN_BATCH}) "
          f"{dist['cli_s']:.1f} s; cli.train from a backbone checkpoint with embeddings "
          f"{dist['backbone_cli_s']:.1f} s on {state['gpu']}", flush=True)
    for (n, s_dtype, t_dtype), sp in dist["splits"]:
        print(f"  distill step batch {n} student {s_dtype} teacher {t_dtype}: "
              f"{1e3 / sp['step']:.1f} steps/s ({sp['step']:.3f} ms: teacher "
              f"{sp['teacher']:.3f}, student + rest {sp['student']:.3f}, AdamW "
              f"{sp['optimizer']:.3f}; the student's step alone "
              f"{' / '.join(f'{ms:.3f}' for ms in dist['alone'][(n, s_dtype)])})", flush=True)


def _report_lifecycle(state: dict) -> None:
    lc = state["lifecycle"]
    print(f"  lifecycle seconds on {state['gpu']}: " + ", ".join(
        f"{k} {v:.1f}" for k, v in lc["secs"].items()), flush=True)
    host, card = state["lifecycle_rates"]
    print(f"  lifecycle: model.onnx {lc['onnx_mb']:.2f} MiB; ONNX max|d| "
          f"{' / '.join(f'{d:.3g}' for d in lc['max_diff'])} (16 / {LIFECYCLE_VERIFY} alerts "
          f"/ {LIFECYCLE_INCEPTION}); numpy evaluator {host:.1f} alerts/s against the card's "
          f"f32 forward {card:.1f} alerts/s on {LIFECYCLE_VERIFY} alerts", flush=True)
    print(f"  lifecycle: saved_model.pb {lc['saved_model_mb']:.2f} MiB; max|d| "
          f"{lc['saved_model_max_diff'][0]:.3g} (the mutant's "
          f"{lc['saved_model_max_diff'][1]:.3g}); its numpy evaluator "
          f"{lc['saved_model_eval_s']:.2f} s for 16 alerts (host)", flush=True)
    print(f"  lifecycle launches: {lc['total']} = " + "; ".join(
        f"{k} {v['convnext_block_fused']} / {v['fused_ln_mlp']}"
        for k, v in lc["launches"].items() if any(v.values())), flush=True)


PHASES = [("setup", phase_setup), ("kernels", phase_kernels),
          ("main path", phase_main_path), ("fast path", phase_fast_path),
          ("forward split", phase_forward_split), ("train", phase_train),
          ("families", phase_families), ("maxvit", phase_maxvit),
          ("inceptionnext", phase_inceptionnext), ("widths", phase_widths),
          ("nano", phase_nano),
          ("daemon", phase_daemon), ("val", phase_val), ("distill", phase_distill),
          ("lifecycle", phase_lifecycle), ("int8", phase_int8), ("examples", phase_examples),
          ("mesh", phase_mesh), ("report", phase_report)]


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "btsbot_tpu_torch", "csrc")):
        print("FAIL: btsbot_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 3
    state: dict = {}
    try:
        for name, fn in PHASES:
            print(f"== phase: {name}", flush=True)
            t0 = time.perf_counter()
            try:
                fn(state)
            except Exception:  # noqa: BLE001 — reported, then the run fails
                traceback.print_exc()
                print(f"FAIL: phase {name}", flush=True)
                return 1
            print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        if "scratch" in state:
            shutil.rmtree(state["scratch"], ignore_errors=True)
    print(state["kernels_line"], flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
