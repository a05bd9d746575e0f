#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``btsbot_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``btsbot_tpu_torch/csrc`` into
``build/kernels/`` and drives the flagship serving path (mm_ConvNeXt,
convnext_pico, 63×63×3 triplets + 25 metadata features) on the card:

1. setup: the card's name and power limit, the kernel build (ptxas'
   registers and spills), a ``cuobjdump -sass`` check that every bfloat16
   kernel holds ``HGMMA`` (tensor-core) instructions, ptxas' warnings, TF32
   off;
2. each kernel against its plain PyTorch version at the four pico stage
   shapes at batch 3072, in float32 (rtol 1e-4 / atol 1e-5: summation order)
   and bfloat16 (rtol = atol = 3e-2: two bf16 roundings), with CUDA-event
   times of both and the bound of the work on an H100; then ragged sizes
   (batch 7, batch 1, and sizes one row short of and one row past a tile
   edge, the tile's height asked of the built library), and maps too wide
   for the block kernel to keep its input tile in shared memory;
3. the main path: ``AlertScorer`` (bf16 and f32, batch 3072) on 2×3072+500
   alerts and on the example alerts, and ``AlertStreamScorer`` on 2×3072
   synthetic packets; 12 block-kernel launches per batch; f32 scores within
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
7. a ``{"kernels": [...]}`` line, alerts/s for each scorer (information only);
8. the card's name and power limit, then as the last line
   ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero and prints no result.  So does a host
without CUDA, and a directory without the port beside this script.
"""

from __future__ import annotations

import csv
import gzip
import json
import os
import re
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
            "float32": 67e12}    # float32 outside the tensor cores (no TF32)
PICO_STAGES = [(15, 64, 2), (7, 128, 2), (3, 256, 6), (1, 512, 2)]  # side, C, depth
# maps whose input tile with its halo does not fit a block's shared memory:
# the bf16 block kernel reads x from device memory there (batch, side, C)
WIDE_MAPS = [(2, 56, 64), (1, 112, 128), (3, 14, 256), (5, 7, 512)]
TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}

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
EXAMPLE_DIR = os.path.join(ROOT, "btsbot_tpu", "example_data")


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
    info = _build.build_info
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
    hgmma = {k: n for k, n in _build.sass_opcode_counts("HGMMA").items() if "bf16" in k}
    print(f"  HGMMA instructions in the bf16 kernels: {sorted(hgmma.values())}", flush=True)
    check(len(hgmma) == 12 and min(hgmma.values()) > 0,
          "all 12 bf16 kernels (fused_ln_mlp, the block kernel with and without "
          "its input tile in shared memory, x 4 widths) hold HGMMA instructions")


# ------------------------------ phase 2 ------------------------------

def _block_inputs(side: int, c: int, dtype, seed: int, batch: int = BATCH):
    """Block input and parameters at the scale of torch's default init,
    with γ and the LN affine randomised."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def u(shape, bound):
        return (torch.rand(shape, generator=g, device=DEVICE) * 2 - 1) * bound

    def n(shape, std):
        return torch.randn(shape, generator=g, device=DEVICE) * std

    hid = 4 * c
    x = n((batch, side, side, c), 1.0)
    params = [u((c, 1, 7, 7), 1 / 7), u((c,), 1 / 7), 1 + n((c,), 0.1), n((c,), 0.1),
              u((hid, c), c ** -0.5), u((hid,), c ** -0.5),
              u((c, hid), hid ** -0.5), u((c,), hid ** -0.5), n((c,), 0.5)]
    return x.to(dtype), [p.to(dtype) for p in params]


def _bound(bytes_moved: float, ops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    results = {"convnext_block_fused": [], "fused_ln_mlp": []}
    # the stage shapes keep their input tile in shared memory; wider maps
    # do not, and the block kernel reads x from device memory
    check(all(lib.btsbot_block_tiles_input(c, side, side) == 1
              for side, c, _ in PICO_STAGES)
          and all(lib.btsbot_block_tiles_input(c, side, side) == 0
                  for _, side, c in WIDE_MAPS),
          f"input tile in shared memory at the stage shapes, not at {WIDE_MAPS}")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for side, c, depth in PICO_STAGES:
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
                bound_ms, bound_by = _bound(2 * m * c * item + w_bytes,
                                            mlp_ops + 2 * 49 * m * c, dname)
                results["convnext_block_fused"].append(dict(
                    dtype=dname, shape=[BATCH, side, side, c], depth=depth,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by))
                print(f"  convnext_block_fused {dname} ({BATCH},{side},{side},{c}): "
                      f"max|d|={err:.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                      f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
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
                bound_ms, bound_by = _bound(
                    3 * m * c * item + sum(t.numel() for t in q) * item, mlp_ops, dname)
                results["fused_ln_mlp"].append(dict(
                    dtype=dname, shape=[m, c], depth=depth, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
                print(f"  fused_ln_mlp {dname} ({m},{c}): max|d|={err:.3g} "
                      f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                      f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
                check(ok, f"fused_ln_mlp matches its plain version ({dname}, C={c})")

                # a partial batch: rows past the last full tile are masked
                xr, mr = x[:7].contiguous(), 7 * side * side + 5
                ok = torch.allclose(convnext_block_fused(xr, *p).float(),
                                    convnext_block_reference(xr, *p).float(), **TOL[dname])
                ok &= torch.allclose(fused_ln_mlp(h[:mr], res[:mr], *q).float(),
                                     ln_mlp_reference(h[:mr], res[:mr], *q).float(),
                                     **TOL[dname])
                check(ok, f"both kernels match at a ragged size ({dname}, C={c}, "
                          f"B=7, M={mr})")
                tm = lib.btsbot_tile_rows(c)
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
    """γ (init 1e-6 makes every block an identity) and the BN statistics
    to seeded random values."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith(".gamma"):
                prm.copy_(torch.randn(prm.shape, generator=g) * 0.5)
        bn = model.metadata_branch[0]
        bn.running_mean.copy_(torch.randn(bn.running_mean.shape, generator=g))
        bn.running_var.copy_(torch.rand(bn.running_var.shape, generator=g) * 1.5 + 0.5)


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
    from btsbot_tpu_torch.engine.serve import _bucket_ladder, _padded, _pick_bucket

    ladder = _bucket_ladder(batch)
    out = []
    with torch.inference_mode():
        for s in range(0, len(triplets), batch):
            e = min(s + batch, len(triplets))
            bs = _pick_bucket(ladder, e - s)
            img = torch.from_numpy(_padded(triplets[s:e], bs)).to(DEVICE)
            meta = torch.from_numpy(_padded(metadata[s:e], bs)).to(DEVICE)
            z = model(img, meta, plain=True).reshape(-1).float()
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


def _n_batches(n: int) -> int:
    return -(-n // BATCH)


def phase_main_path(state: dict) -> None:
    import numpy as np
    import torch
    from btsbot_tpu_torch import AlertScorer, AlertStreamScorer, native
    from btsbot_tpu_torch.data.fits import write_fits_image
    from btsbot_tpu_torch.data.synthetic import synthetic_packets
    from btsbot_tpu_torch.engine.serve import _gather_metadata
    from btsbot_tpu_torch.models.factory import build_model
    from btsbot_tpu_torch.ops.convnext_block import convnext_block_fused
    from btsbot_tpu_torch.ops.ln_mlp import fused_ln_mlp
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

    # packets: synthetic, plus three that must be dropped
    packets = list(synthetic_packets(2 * BATCH - 3, META_COLS, seed=4, unique_stamps=True))
    bad = list(synthetic_packets(3, META_COLS, seed=5, unique_stamps=True))
    bad[0]["cutoutScience"] = {"stampData": gzip.compress(write_fits_image(
        np.full((63, 63), np.nan, np.float32)))}
    bad[1]["cutoutTemplate"] = {"stampData": gzip.compress(write_fits_image(
        np.zeros((63, 63), np.float32)))}
    bad[2]["cutoutDifference"] = None
    packets[10:10] = bad[:1]
    packets[3000:3000] = bad[1:2]
    packets[5000:5000] = bad[2:]

    # warm every bucket outside the counted run
    for sc in scorers.values():
        sc(trips[:1], meta[:1]), sc(trips[:500], meta[:500]), sc(trips[:BATCH], meta[:BATCH])
    stream.warmup()
    torch.cuda.synchronize()

    # ---- the counted run of the main path
    convnext_block_fused.launches = 0
    fused_ln_mlp.launches = 0
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
    launches = {"convnext_block_fused": convnext_block_fused.launches,
                "fused_ln_mlp": fused_ln_mlp.launches}
    state["launches_main"] = launches
    batches = 2 * (_n_batches(n_big) + _n_batches(len(ex_trips))) + _n_batches(len(packets))
    print(f"  launches: {launches} over {batches} batches", flush=True)
    check(launches["convnext_block_fused"] == 12 * batches,
          f"12 block-kernel launches per batch ({12 * batches})")

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
    from btsbot_tpu_torch.ops.convnext_block import convnext_block_fused
    from btsbot_tpu_torch.ops.ln_mlp import fast_mm_convnext_logits, fused_ln_mlp

    model, weights = state["model"], state["weights"]
    trips = torch.from_numpy(_normalised_triplets(BATCH, seed=6)).to(DEVICE)
    meta = torch.from_numpy(np.random.default_rng(7).normal(
        size=(BATCH, len(META_COLS))).astype(np.float32)).to(DEVICE)
    with torch.inference_mode():
        want = model(trips, meta).reshape(-1)
        torch.cuda.synchronize()
        convnext_block_fused.launches = 0
        fused_ln_mlp.launches = 0
        got = fast_mm_convnext_logits(weights, trips, meta, FLAGSHIP_CONFIG)
        torch.cuda.synchronize()
        launches = {"convnext_block_fused": convnext_block_fused.launches,
                    "fused_ln_mlp": fused_ln_mlp.launches}
    state["launches_fast"] = launches
    print(f"  launches: {launches}", flush=True)
    check(launches["fused_ln_mlp"] == 12, "12 fused_ln_mlp launches")
    err = (got - want).abs().max().item()
    print(f"  fast path vs module logits (f32): max|d|={err:.3g}", flush=True)
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-5),
          "fast_mm_convnext_logits within rtol 1e-4 of the module")


# ------------------------------ phase 5 ------------------------------

def phase_forward_split(state: dict) -> None:
    """The bf16 forward on device-resident inputs, split with CUDA events into
    the 12 block-kernel launches and everything else (stem, downsample,
    heads, sigmoid, the gaps between launches)."""
    import torch
    from btsbot_tpu_torch.ops import convnext_block as port_block

    sc = state["scorer_bf16"]
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

    iters = 10
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
    total = whole[0].elapsed_time(whole[1]) / iters
    blocks = sum(a.elapsed_time(b) for a, b in spans) / iters
    check(len(spans) == 12 * iters, "12 block launches per timed forward")
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


def _one_step(config, weights, batch, plain: bool = False):
    """One train step of a fresh model holding ``weights`` on ``batch``;
    (loss, {name: grad}, block-kernel launches)."""
    import torch
    from btsbot_tpu_torch.engine.steps import make_train_step
    from btsbot_tpu_torch.ops.convnext_block import convnext_block_fused

    config, st = _fresh_state(config, weights)
    torch.cuda.synchronize()
    convnext_block_fused.launches = 0
    m = make_train_step(config, plain=plain)(st, *batch)
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in st.model.named_parameters()}
    return m["loss"].item(), grads, convnext_block_fused.launches


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


def _profile_steps(config, weights, batch, iters: int = 5) -> None:
    """Kernel time by name over ``iters`` train steps with ``torch.profiler``,
    and the device's busy share of the wall time (information only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from btsbot_tpu_torch.engine.steps import make_train_step

    config, st = _fresh_state(config, weights)
    step = make_train_step(config)
    for _ in range(3):
        step(st, *batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step(st, *batch)
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
    print(f"  profile, batch {batch[0].shape[0]} {config.get('compute_dtype', 'float32')}: "
          f"{wall_ms:.3f} ms a step (host clock, profiler on), device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{sum(e.count for e in kernels) / iters:.0f} kernels a step", flush=True)
    for e in sorted(kernels, key=lambda e: e.device_time_total, reverse=True)[:10]:
        print(f"    {e.device_time_total / 1e3 / iters:8.3f} ms  x{e.count / iters:4.0f}  "
              f"{e.key[:110]}", flush=True)


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
    from btsbot_tpu_torch.ops.convnext_block import convnext_block_fused

    weights = state["weights"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        data_dir, out_root = os.path.join(tmp, "data"), os.path.join(tmp, "models")
        os.makedirs(data_dir)
        t0 = time.perf_counter()
        _write_split(data_dir, "train", TRAIN_ALERTS, seed=11)
        _write_split(data_dir, "val", VAL_ALERTS, seed=12)
        print(f"  wrote {TRAIN_ALERTS} + {VAL_ALERTS} alerts in the reference's layout "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
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
        loss_p, grads_p, n_p = _one_step(config, weights, batch, plain=True)
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
                    "--device", DEVICE]
        runs = []
        for epochs, extra in ((2, []), (3, ["--resume"])):
            path = os.path.join(tmp, f"config_{epochs}.json")
            with open(path, "w") as f:
                json.dump(_train_config(epochs=epochs), f)
            torch.cuda.synchronize()
            convnext_block_fused.launches = 0
            t0 = time.perf_counter()
            result = train_cli([path] + cli_args + extra)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = convnext_block_fused.launches
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
        for n, dname in ((TRAIN_BATCH, "float32"), (1024, "bfloat16")):
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


def phase_report(state: dict) -> None:
    res = state["kernel_results"]
    kernels = [
        _kernel_entry("convnext_block_fused", "btsbot_tpu_torch/csrc/convnext_block.cu",
                      "btsbot_tpu/ops/pallas_convnext.py:147",
                      state["launches_main"]["convnext_block_fused"],
                      res["convnext_block_fused"]),
        _kernel_entry("fused_ln_mlp", "btsbot_tpu_torch/csrc/ln_mlp.cu",
                      "btsbot_tpu/ops/pallas_mlp.py:99",
                      state["launches_fast"]["fused_ln_mlp"], res["fused_ln_mlp"]),
    ]
    # the training path's count: both cli.train runs of phase 6
    kernels[0]["launches_train"] = state["launches_train"]
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
    state["kernels_line"] = json.dumps({"kernels": kernels})


PHASES = [("setup", phase_setup), ("kernels", phase_kernels),
          ("main path", phase_main_path), ("fast path", phase_fast_path),
          ("forward split", phase_forward_split), ("train", phase_train),
          ("report", phase_report)]


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
    print(state["kernels_line"], flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
