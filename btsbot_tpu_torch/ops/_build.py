"""Build and load the port's CUDA kernels.

Every ``btsbot_tpu_torch/csrc/*.cu`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface,
``build/kernels/libbtsbot_kernels.so`` at the repository root, which is
loaded with ``ctypes``.  The sources are compiled in parallel, one ``nvcc``
each, then linked; the build runs at first use and again only when a
source or a flag changes (a digest of both sits beside the library).

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on anything but 0.  A failed build raises: there is no
fallback to the plain PyTorch versions on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
DEFAULT_BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
# where build() compiles to and loads from; utils/compile_cache.py moves it
BUILD_DIR = DEFAULT_BUILD_DIR
LIB_NAME = "libbtsbot_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_SIGNATURES = {
    # h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out, M, C, hidden, is_bf16,
    # stream
    "btsbot_ln_mlp": [_P] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, _P],
    # x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, out, B, H, W, C,
    # hidden, is_bf16, stream
    "btsbot_convnext_block": [_P] * 11 + [ctypes.c_int] * 6 + [_P],
    # the same two functions at any width (csrc/any_width.cu)
    "btsbot_ln_mlp_any": [_P] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, _P],
    "btsbot_convnext_block_any": [_P] * 11 + [ctypes.c_int] * 6 + [_P],
    # M, C, hidden -> rows of the flattened index a block of the any-width
    # kernels takes (0: widths they do not take)
    "btsbot_any_width_rows": [ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
    # C -> rows of the flattened index a block of the bf16 kernels takes
    "btsbot_tile_rows": [ctypes.c_int],
    # C, H, W -> 1 if the bf16 block kernel keeps the input tile of such a
    # map in shared memory, 0 if it reads x from device memory
    "btsbot_block_tiles_input": [ctypes.c_int] * 3,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def find_cuda_tool(tool: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``):
    $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", tool))
    found = shutil.which(tool)
    if found:
        candidates.append(found)
    candidates.append(f"/usr/local/cuda/bin/{tool}")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(f"{tool} not found (set CUDA_HOME or put {tool} on PATH); "
                       "the CUDA kernels cannot be built or inspected")


def sass_opcode_counts(opcode: str) -> dict[str, int]:
    """How often ``opcode`` occurs in each kernel of the built library
    (``cuobjdump -sass``), keyed by the kernel's mangled name."""
    out = subprocess.run([find_cuda_tool("cuobjdump"), "-sass", str(build())],
                         capture_output=True, text=True, check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            counts[name] = 0
        elif name is not None and opcode in line:
            counts[name] += 1
    return counts


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels if the library is missing or stale; returns its
    path.  Sets ``build_info`` (seconds, whether it compiled, ptxas
    report)."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        build_info.update(seconds=0.0, compiled=False, ptxas="")
        return lib_path
    nvcc = find_cuda_tool("nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{digest[:12]}.{os.getpid()}"
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
               "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports, failures = [], []
    for src, _, proc in jobs:
        out, err = proc.communicate()
        reports.append(f"== {src.name}\n{out}{err}")
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src.name}:\n{out}{err}")
    if failures:
        raise RuntimeError("\n".join(failures))
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in jobs]],
        capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stderr}")
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    build_info.update(seconds=time.perf_counter() - t0, compiled=True,
                      ptxas="\n".join(reports))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Widths the tuned kernels take (csrc/convnext_block.cu, csrc/ln_mlp.cu: bf16
# in units of 64 channels and 64 hidden units, float32 in tiles specialised
# per C); every other width runs csrc/any_width.cu.
TUNED_WIDTHS = (64, 128, 256, 512)
# C entry point of each function and kernel variant
ENTRY_POINTS = {
    "convnext_block": {"tuned": "btsbot_convnext_block",
                       "any_width": "btsbot_convnext_block_any"},
    "ln_mlp": {"tuned": "btsbot_ln_mlp", "any_width": "btsbot_ln_mlp_any"},
}


def kernel_variant(c: int, hidden: int) -> str:
    """The kernel that takes a block of width ``c`` with ``hidden`` MLP units,
    chosen by width: "tuned" for C in TUNED_WIDTHS at a hidden width that is a
    multiple of 64 (every ``k * C`` there), "any_width" for every other C and
    hidden that are multiples of 8 (every ConvNeXt size's widths and their
    ``.r<k>`` hidden widths).  Raises on widths neither takes."""
    if c <= 0 or hidden <= 0 or c % 8 or hidden % 8:
        raise ValueError(f"the kernels take C and hidden widths that are positive "
                         f"multiples of 8, got C={c}, hidden={hidden}")
    return "tuned" if c in TUNED_WIDTHS and hidden % 64 == 0 else "any_width"


def count_launch(wrapper, c: int, hidden: int) -> None:
    """One launch of ``wrapper``'s kernel at widths (c, hidden): its total
    ``launches`` and its ``launches_by_width[(c, hidden)]``."""
    wrapper.launches += 1
    key = (c, hidden)
    wrapper.launches_by_width[key] = wrapper.launches_by_width.get(key, 0) + 1


def kernel_operands(x, params, name: str) -> list:
    """Validate a kernel's input tensor and bring its parameters to its type;
    returns the operands, x first.  Raises on what the kernels do not take:
    the TMA descriptors and the 16-byte loads want every operand contiguous
    and on a 16-byte line, and a quiet copy per launch would hide the cost."""
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    ops = [x.contiguous()]
    for i, p in enumerate(params):
        if p.device != x.device:
            raise ValueError(f"{name}: operands on {p.device} and {x.device}")
        if not p.is_contiguous():
            raise ValueError(f"{name}: operand {i + 1} of shape {tuple(p.shape)} "
                             f"is not contiguous")
        ops.append(p.to(x.dtype))
    for i, t in enumerate(ops):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand {i} of shape {tuple(t.shape)} is "
                             f"not 16-byte aligned")
    return ops


def current_stream(x) -> int:
    """The raw handle of PyTorch's current stream on x's card."""
    return torch.cuda.current_stream(x.device).cuda_stream
