"""The benchmark's machinery, shared by every cell.

``BENCHMARK.json`` names each cell's configuration and traffic mix; this
module finds their files by those names (``configs/<config>.json``,
``traffic/<traffic>.json``), the traffic's driver by the ``driver`` key of
its file (``drivers/<driver>.py``), and each per-layer metric's reader by
the metric's name (``layer_metrics/<name>.py``, or the name before its
first dot).  A later cell, mix or metric is new files plus new entries, with
no file here edited.

It also makes the weights and the alert pools from the seed on the card,
profiles the traced window, and judges the comparisons that decide
``correct``.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .reference.mm_convnext import param_spec

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# LayerNorm gains are log-normal across channels, as a trained ConvNeXt's
# are: a few channels carry large activations, which per-tensor int8 scales
# (the control of the bfloat16 cells) pay for and bfloat16 does not
LN_SIGMA = 0.75
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# top-level module names a run must not hold: the JAX package and JAX
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "btsbot_tpu")


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(BENCH_DIR / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots); where
    no such file is, the one named by the part before the first dot, so one
    reader serves every ``<metric>.<cells>`` that reads alike."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        path = BENCH_DIR / kind / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Modules in ``sys.modules`` whose top-level name is a forbidden one,
    compared whole (``btsbot_tpu_torch`` is not ``btsbot_tpu``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


@dataclasses.dataclass
class Check:
    """One compared number and its limit: the run is correct only where
    ``value <= limit`` for every check."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclasses.dataclass
class Context:
    workload: str
    seed: int
    device: torch.device
    cfg: dict            # the configuration's file
    traffic: dict        # the traffic mix's file


@dataclasses.dataclass
class LayerRun:
    """What a per-layer reader reads: the traced window (None when nothing
    was traced), the harness's counters, the configuration."""
    trace: "Trace | None"
    counters: dict
    cfg: dict


# ------------------------------ inputs ------------------------------

def make_weights(cfg: dict, seed: int, dtype: torch.dtype, device) -> dict:
    """A reference-named state dict drawn on the card from ``seed`` in two
    calls (one uniform, one normal), in the type it is served in: weights
    U(±√(6/fan_in)), which keeps each layer's output as wide as its input
    under GELU, so the logits spread as a trained model's do and a fault in
    any layer shows in the scores; the logit's weight and the biases
    U(±1/√fan_in) as torch's defaults, which keeps the logits well inside
    the range a float32 sigmoid resolves; LayerNorm gains exp(N(0, 0.75²))
    (``LN_SIGMA``) and biases N(0, 0.1²); BatchNorm affines near (1, 0);
    γ ~ N(0, 0.5²) so every block contributes; the BatchNorm statistics
    N(0, 1) and U(0.5, 2)."""
    spec = param_spec(cfg)
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    z = torch.randn(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for (name, shape, kind, fan), n in zip(spec, sizes):
        uu, zz = u[off:off + n].view(shape), z[off:off + n].view(shape)
        off += n
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        t = {"w": lambda: uu * math.sqrt(6 / fan), "b": lambda: uu / math.sqrt(fan),
             "w_out": lambda: uu / math.sqrt(fan),
             "ln_w": lambda: torch.exp(LN_SIGMA * zz), "ln_b": lambda: 0.1 * zz,
             "bn_w": lambda: 1 + 0.1 * zz, "bn_b": lambda: 0.1 * zz,
             "gamma": lambda: 0.5 * zz, "bn_mean": lambda: zz,
             "bn_var": lambda: 1.25 + 0.75 * uu}[kind]()
        out[name] = t.to(dtype).contiguous()
    return out


def make_pool(n: int, n_meta: int, seed: int, device, chunk: int = 4096):
    """Host arrays of ``n`` alerts made on the card from ``seed``: triplets
    (n, 63, 63, 3) float32 with each cutout L2-normalised, as training
    splits store them, and metadata (n, n_meta) float32."""
    g = torch.Generator(device=device).manual_seed(seed)
    images = np.empty((n, 63, 63, 3), np.float32)
    for i in range(0, n, chunk):
        t = torch.randn((min(chunk, n - i), 63, 63, 3), generator=g, device=device)
        t = t / t.square().sum(dim=(1, 2), keepdim=True).sqrt()
        torch.from_numpy(images[i:i + len(t)]).copy_(t)
    meta = torch.randn((n, n_meta), generator=g, device=device).cpu().numpy()
    return images, meta


def logit_gap_checks(gaps: np.ndarray, scale: float, limits: dict) -> list[Check]:
    """The absolute logit gaps of the compared answers in units of
    ``scale``, the standard deviation of the reference's logits over the
    pool (which the seed's weights set): their largest (``logit_gap_max``,
    which one wrong answer moves) and their mean (``logit_gap_mean``)."""
    gaps = np.asarray(gaps, np.float64) / scale
    worst = float(gaps.max()) if gaps.size else float("inf")
    mean = float(gaps.mean()) if gaps.size else float("inf")
    return [Check("logit_gap_max", worst, limits["logit_gap_max"]),
            Check("logit_gap_mean", mean, limits["logit_gap_mean"])]


def logits_of(scores: np.ndarray) -> np.ndarray:
    """The logits a float32 sigmoid came from, in float64."""
    s = np.clip(scores.astype(np.float64), 1e-12, 1 - 1e-12)
    return np.log(s) - np.log1p(-s)


@contextlib.contextmanager
def tf32_off():
    """float32 products and convolutions in float32 on the card (PyTorch lets
    cuDNN take TF32 by default)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------ tracing ------------------------------

@dataclasses.dataclass
class Trace:
    """Device and host events of the traced window, seconds from its start."""
    window_s: float
    kernels: list        # (name, start, duration)
    memcpys: list        # (name, start, duration)
    host: list           # (name, start, duration) of host operators and spans

    def kernel_time(self, *patterns: str) -> tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds a pattern."""
        hits = [d for n, _, d in self.kernels if any(p in n for p in patterns)]
        return sum(hits), len(hits)

    def busy_intervals(self) -> list[tuple[float, float]]:
        """Merged intervals in which a kernel ran (copies are not busy)."""
        merged: list[list[float]] = []
        for _, s, d in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, 0.0), min(s + d, self.window_s)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def breakdown(self, top: int = 10, labelled: int = 500) -> dict:
        """The device operations that took most time, and the idle gaps by
        the innermost host event running at each gap's middle (the
        ``labelled`` longest gaps; the rest summed as shorter gaps)."""
        ops: dict[str, float] = {}
        for name, _, d in self.kernels + self.memcpys:
            ops[name[:160]] = ops.get(name[:160], 0.0) + d
        gaps, last = [], 0.0
        for s, e in self.busy_intervals() + [(self.window_s, self.window_s)]:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        labels: dict[str, float] = {}
        for s, e in gaps[:labelled]:
            mid = 0.5 * (s + e)
            hi = bisect.bisect_right(starts, mid)
            inner = [h for h in host[max(0, hi - 2000):hi] if h[1] + h[2] >= mid]
            label = min(inner, key=lambda h: h[2])[0][:160] if inner else "no host event"
            labels[label] = labels.get(label, 0.0) + (e - s)
        if len(gaps) > labelled:
            labels["shorter gaps"] = sum(e - s for s, e in gaps[labelled:])

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(ops), "idle_gaps": ranked(labels)}


class TraceWindow:
    """The profiler over the first ``seconds`` of the measured window (None:
    the whole window); does nothing when tracing is off."""
    SPAN = "bench.window"

    def __init__(self, enabled: bool, seconds: float | None, device):
        self.enabled = enabled
        self.seconds = seconds
        self.device = device
        self.active = False
        self._prof = None
        self._span = None
        self._t0 = 0.0

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(self.SPAN)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        self.active = True

    def due(self) -> bool:
        """True once the traced part of the window has run its length."""
        return (self.active and self.seconds is not None
                and time.perf_counter() - self._t0 >= self.seconds)

    def stop(self) -> None:
        if not self.active:
            return
        sync(self.device)
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False

    def read(self) -> Trace | None:
        """The traced window's events (after ``stop``)."""
        if self._prof is None:
            return None
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._prof = None
        spans = [e for e in events if e.get("name") == self.SPAN
                 and e.get("cat") == "user_annotation"]
        if not spans:
            return None
        t0, dur = float(spans[0]["ts"]), float(spans[0]["dur"])
        kernels, memcpys, host = [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            rec = (e["name"], (float(e["ts"]) - t0) / 1e6, float(e["dur"]) / 1e6)
            if not 0 <= rec[1] <= dur / 1e6:
                continue
            cat = e.get("cat")
            if cat == "kernel":
                kernels.append(rec)
            elif cat == "gpu_memcpy":
                memcpys.append(rec)
            elif cat in ("cpu_op", "user_annotation", "cuda_runtime") and e["name"] != self.SPAN:
                host.append(rec)
        return Trace(window_s=dur / 1e6, kernels=kernels, memcpys=memcpys, host=host)


class RowCounter:
    """Counts the rows of every forward of ``model`` while ``window`` is
    tracing (a forward pre-hook: the program is not changed)."""

    def __init__(self, model, window: TraceWindow):
        self.rows: list[int] = []
        self.window = window
        self._handle = model.register_forward_pre_hook(self._hook, with_kwargs=True)

    def _hook(self, module, args, kwargs):
        if self.window.active:
            x = args[0] if args else kwargs.get("image_input")
            self.rows.append(int(x.shape[0]))

    def remove(self) -> None:
        self._handle.remove()

