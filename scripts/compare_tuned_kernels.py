#!/usr/bin/env python3
"""Time the bfloat16 block kernels of this checkout against another
checkout's, on one card, in one process.

    python3 scripts/compare_tuned_kernels.py --baseline DIR

DIR is the root of another checkout of the repository (for example the
parent commit unpacked with ``git archive``).  Each checkout's
``btsbot_tpu_torch/csrc`` is built into its own ``build/kernels`` with
``ops/_build.py``, both libraries are loaded, and the tuned entry points
(``btsbot_convnext_block`` and ``btsbot_ln_mlp``, C = 64 / 128 / 256 / 512)
are launched on the same inputs at the four pico stage shapes at batch 3072
in bfloat16 (hidden 4C), and the padded ones (``btsbot_convnext_block_wgmma``,
``btsbot_ln_mlp_wgmma``) at nano's four (C = 80 / 160 / 320 / 640), in
turns: baseline, this, this, baseline, three times.  Each turn is the mean
of 20 launches between CUDA events after 3 warm-up launches.  Prints each
stage's mean time for both, a forward's launches (pico's depths 2 / 2 / 6 /
2, nano's 2 / 2 / 8 / 2) for both and their ratio, the largest difference
between the two libraries' outputs, the card's name and power limit, and a
JSON line with all of it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PICO_STAGES = [(15, 64, 2), (7, 128, 2), (3, 256, 6), (1, 512, 2)]  # side, C, depth
NANO_STAGES = [(15, 80, 2), (7, 160, 2), (3, 320, 8), (1, 640, 2)]
BATCH = 3072
# entry point -> the stages it is compared at
ENTRIES = {"btsbot_convnext_block": PICO_STAGES, "btsbot_ln_mlp": PICO_STAGES,
           "btsbot_convnext_block_wgmma": NANO_STAGES, "btsbot_ln_mlp_wgmma": NANO_STAGES}


def load(root: Path):
    """Build ``root``'s kernels into ``root/build/kernels`` and load them,
    each entry point with the signature of ``root``'s own ``_build.py`` (a
    checkout from before the LN -> MLP kernels took the LN eps has none)."""
    import importlib.util

    from btsbot_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location(
        f"_build_{abs(hash(str(root)))}", root / "btsbot_tpu_torch" / "ops" / "_build.py")
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    _build.CSRC_DIR = root / "btsbot_tpu_torch" / "csrc"
    _build.BUILD_DIR = root / "build" / "kernels"
    lib = ctypes.CDLL(str(_build.build()))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = theirs._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def inputs(side: int, c: int, seed: int):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(torch.bfloat16)

    hid = 4 * c
    x = n(BATCH, side, side, c)
    params = [n(c, 1, 7, 7, std=0.1), n(c, std=0.1), 1 + n(c, std=0.1), n(c, std=0.1),
              n(hid, c, std=c ** -0.5), n(hid, std=0.1), n(c, hid, std=hid ** -0.5),
              n(c, std=0.1), n(c, std=0.5)]
    return x, params


def launcher(lib, name: str, x, params, out):
    """A call of entry point ``name`` on these tensors (the wrappers' own
    argument order) on the current stream."""
    import torch
    b, h, w, c = x.shape
    hidden = params[4].shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, name)
    if name.startswith("btsbot_convnext_block"):
        ptrs = [x.data_ptr()] + [p.data_ptr() for p in params]
        args = ptrs + [out.data_ptr(), b, h, w, c, hidden, 1, stream]
    else:  # h = x's rows, shortcut = x's rows, then the block's params from ln_w on
        rows = x.data_ptr()
        ptrs = [rows, rows] + [p.data_ptr() for p in params[2:]]
        eps = [1e-6] if ctypes.c_float in fn.argtypes else []  # the LN eps, where taken
        args = ptrs + [out.data_ptr(), b * h * w, c, hidden, *eps, 1, stream]

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name} failed to launch: CUDA error {err}")
    return call


def time_ms(call, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="root of the checkout to compare with")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    libs = {"baseline": load(args.baseline.resolve()), "this": load(ROOT)}
    result = {"card": card, "batch": BATCH, "dtype": "bfloat16"}
    with torch.inference_mode():
        for name, shapes in ENTRIES.items():
            stages = []
            for side, c, depth in shapes:
                x, params = inputs(side, c, seed=c)
                outs = {k: torch.empty_like(x) for k in libs}
                calls = {k: launcher(lib, name, x, params, outs[k]) for k, lib in libs.items()}
                for call in calls.values():
                    call()
                torch.cuda.synchronize()
                diff = (outs["this"].float() - outs["baseline"].float()).abs().max().item()
                times = {k: [] for k in libs}
                for _ in range(args.rounds):
                    for k in ("baseline", "this", "this", "baseline"):
                        times[k].append(time_ms(calls[k]))
                ms = {k: sum(v) / len(v) for k, v in times.items()}
                stages.append({"C": c, "side": side, "depth": depth, "max_abs_diff": diff,
                               "ms": ms, "turns": times})
                print(f"{name} ({BATCH},{side},{side},{c}): baseline {ms['baseline']:.4f} ms, "
                      f"this {ms['this']:.4f} ms, max|d| {diff:.3g}", flush=True)
            fwd = {k: sum(s["ms"][k] * s["depth"] for s in stages) for k in libs}
            result[name] = {"stages": stages, "forward_ms": fwd,
                            "ratio": fwd["this"] / fwd["baseline"],
                            "max_abs_diff": max(s["max_abs_diff"] for s in stages)}
            print(f"{name}: a forward's {sum(d for _, _, d in shapes)} launches: baseline "
                  f"{fwd['baseline']:.4f} ms, "
                  f"this {fwd['this']:.4f} ms (ratio {fwd['this'] / fwd['baseline']:.4f}) "
                  f"on {card}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
