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
    # h, res, ln_w, ln_b, w1, b1, w2, b2, gamma, out, M, C, hidden, LN eps,
    # is_bf16, stream
    "btsbot_ln_mlp": [_P] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_float, ctypes.c_int, _P],
    # x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, out, B, H, W, C,
    # hidden, is_bf16, stream
    "btsbot_convnext_block": [_P] * 11 + [ctypes.c_int] * 6 + [_P],
    # the same two functions in bfloat16 on the tensor cores at any width
    # (convnext_block.cu, ln_mlp.cu)
    "btsbot_ln_mlp_wgmma": [_P] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_float, ctypes.c_int, _P],
    "btsbot_convnext_block_wgmma": [_P] * 11 + [ctypes.c_int] * 6 + [_P],
    # float32 at every width, three TF32 products (csrc/tf32x3.cu): the same
    # arguments with a workspace (pointer, bytes) after out, and no is_bf16
    "btsbot_ln_mlp_tf32x3": [_P] * 11 + [ctypes.c_longlong, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
    "btsbot_convnext_block_tf32x3": [_P] * 12 + [ctypes.c_longlong]
    + [ctypes.c_int] * 5 + [_P],
    # M, C, hidden, taps -> floats of the workspace a float32 launch needs
    # (the weights' split halves, and partial sums where the hidden chunks are
    # split over blocks; 0: widths the kernels do not take)
    "btsbot_tf32x3_workspace_floats": [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int],
    # C -> rows of the flattened index a block of the float32 kernels takes,
    # and C, H, W -> 1 if the float32 block kernel keeps the input tile of
    # such a map in shared memory (0: x through L2; both 0 / -1 for a width
    # they do not take)
    "btsbot_tf32x3_rows": [ctypes.c_int],
    "btsbot_tf32x3_tiles_input": [ctypes.c_int] * 3,
    # C -> rows of the flattened index a block of the bf16 kernels takes
    # (tuned or wgmma_any; 0: a width they do not take)
    "btsbot_tile_rows": [ctypes.c_int],
    # C, H, W -> 1 if the bf16 block kernel keeps the input tile of such a
    # map in shared memory, 0 if it reads x from device memory
    "btsbot_block_tiles_input": [ctypes.c_int] * 3,
    # the int8 path's depthwise step (csrc/int8_dwconv.cu): x, taps, tap
    # scales, bias, out, s_x, B, H, W, C, is_bf16, stream
    "btsbot_int8_dwconv": [_P] * 5 + [ctypes.c_float] + [ctypes.c_int] * 5 + [_P],
    # one quantized block in one launch (csrc/int8_block.cu): x, dw_q, dw_s,
    # dw_b, ln_w, ln_b, w1, w1_s, b1, w2, w2_s, b2, gamma, out, debug q_h,
    # debug q_g, s_x, s_h, s_g, B, H, W, C, hidden, w1's row bytes, is_bf16,
    # stream
    "btsbot_int8_block": [_P] * 16 + [ctypes.c_float] * 3 + [ctypes.c_int] * 7 + [_P],
    # C, H, W -> shared memory of one block of it (0: it does not take them)
    "btsbot_int8_block_smem": [ctypes.c_int] * 3,
    # MaxViT's window / grid attention (csrc/partition_attention.cu): qkv,
    # table, out, B, H, W, C, P, grid, scale, is_bf16, stream
    "btsbot_partition_attention": [_P] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                    ctypes.c_int, _P],
    # MaxViT's MBConv middle (csrc/mbconv_dw.cu): x, taps, BN1's mean, var,
    # weight, bias, BN2's, out, B, H, W, C, stride, BN1's eps, BN2's, is_bf16,
    # params_bf16, stream
    "btsbot_mbconv_dw": [_P] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
    + [ctypes.c_int] * 2 + [_P],
    # MaxViT's LN1 -> qkv (csrc/ln_qkv.cu): x, ln_w, ln_b, w, b, out, M, C,
    # LN eps, is_bf16, stream
    "btsbot_ln_qkv": [_P] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_int, _P],
}

# entry points that return something other than a CUDA error code
_RESTYPES = {"btsbot_tf32x3_workspace_floats": ctypes.c_longlong}

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
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# Widths the tuned bfloat16 kernels take (csrc/convnext_block.cu,
# csrc/ln_mlp.cu: in units of 64 channels and 64 hidden units).  Every other
# width runs, in bfloat16, the same tensor-core design padded inside the
# kernel to a multiple of 64 channels.  float32 runs csrc/tf32x3.cu at every
# width: both products as three TF32 tensor-core products each.
TUNED_WIDTHS = (64, 128, 256, 512)
MAX_WIDTH = 1024  # the widest C the kernels of either type take
# C entry point of each function and kernel variant
ENTRY_POINTS = {
    "convnext_block": {"tuned": "btsbot_convnext_block",
                       "tf32x3": "btsbot_convnext_block_tf32x3",
                       "wgmma_any": "btsbot_convnext_block_wgmma"},
    "ln_mlp": {"tuned": "btsbot_ln_mlp", "tf32x3": "btsbot_ln_mlp_tf32x3",
               "wgmma_any": "btsbot_ln_mlp_wgmma"},
}
def kernel_variant(c: int, hidden: int, dtype: torch.dtype) -> str:
    """The kernel that takes a block of width ``c`` with ``hidden`` MLP units
    in ``dtype``: in float32 "tf32x3"; in bfloat16 "tuned" for C in
    TUNED_WIDTHS at a hidden width that is a multiple of 64 (every ``k * C``
    there) and "wgmma_any" at every other C.  C and hidden are multiples of
    8 (every ConvNeXt size's widths and their ``.r<k>`` hidden widths), C up
    to MAX_WIDTH.  Raises on what none takes."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the kernels take float32 or bfloat16, got {dtype}")
    if c <= 0 or hidden <= 0 or c % 8 or hidden % 8:
        raise ValueError(f"the kernels take C and hidden widths that are positive "
                         f"multiples of 8, got C={c}, hidden={hidden}")
    if c > MAX_WIDTH:
        raise ValueError(f"the kernels take C up to {MAX_WIDTH}, got C={c}")
    if dtype == torch.float32:
        return "tf32x3"
    return "tuned" if c in TUNED_WIDTHS and hidden % 64 == 0 else "wgmma_any"


def int8_block_admit(c: int, hidden: int) -> None:
    """Raise unless the int8 block kernel (csrc/int8_block.cu) takes a block
    of width ``c`` with ``hidden`` MLP units: C a multiple of 8 up to
    MAX_WIDTH (padded to 64 ceil(C / 64) inside the kernel), hidden a
    multiple of 16 (fc2's rows are hidden bytes apart, and TMA wants 16-byte
    row strides).  Every ConvNeXt width at hidden 4C is taken."""
    if c <= 0 or c % 8 or c > MAX_WIDTH:
        raise ValueError(f"the int8 block kernel takes C a multiple of 8 up to {MAX_WIDTH}, "
                         f"got C={c}")
    if hidden <= 0 or hidden % 16:
        raise ValueError(f"the int8 block kernel takes a hidden width that is a positive "
                         f"multiple of 16, got {hidden}")


def kernel_workspace(variant: str, x, m: int, c: int, hidden: int, taps: bool):
    """A fresh float32 workspace for a "tf32x3" launch over ``m`` rows, of
    the size the library's plan asks for (None for the bfloat16 kernels).
    The caller holds it until the launch is enqueued; after that PyTorch's
    caching allocator reuses it only for work that the stream orders after
    the launch."""
    if variant != "tf32x3":
        return None
    floats = library().btsbot_tf32x3_workspace_floats(m, c, hidden, int(taps))
    if floats <= 0:
        raise ValueError(f"the float32 kernels do not take C={c}, hidden={hidden}")
    return torch.empty(floats, dtype=torch.float32, device=x.device)


def type_args(variant: str) -> list:
    """The bfloat16 entry points' is_bf16 (always 1: it keeps the earlier
    signature, in which it chose the type, as a guard against a float32
    caller of it); none for the float32 ones, whose type is their own."""
    return [] if variant == "tf32x3" else [1]


def workspace_args(ws) -> list:
    """The (pointer, bytes) arguments of a workspace after ``out``; none
    without one."""
    return [] if ws is None else [ws.data_ptr(), ws.numel() * ws.element_size()]


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
