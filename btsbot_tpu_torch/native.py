"""ctypes binding for the repository's native (C++) batched stamp decoder.

Loads ``build/native/libbtsbot_native.so`` at the repository root, the
port's own build of ``cpp/stamp_decoder.cc`` (made on first use when a
toolchain is present, by ``make -C cpp`` with ``TARGET`` pointed at a
temporary name there), and exposes ``decode_stamps(blobs) -> (stamps,
status)``.  The build holds an exclusive lock on a file beside the library
and moves the finished file into place with one rename, so processes that
start together (test workers) build it once and never load a half-written
one; ``cpp/`` itself is not written.  When the library
cannot be built or loaded, the host falls back to the port's own Python
decoder (``data.alerts``); ``native_available()`` and ``decoder()`` say
which one runs.  Either way this is host work: the decoded stamps go to the
card afterwards.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CPP_DIR = os.path.join(_REPO_ROOT, "cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libbtsbot_native.so")

STAMP_SIZE = 63
PAD_VALUE = 1e-9

_lib = None
_load_attempted = False


def _try_build() -> bool:
    """Build the library unless another process has: under the lock,
    compile to a temporary name in the build directory, then rename it into
    place.  True when the finished library is there."""
    tmp = os.path.join(_BUILD_DIR, f".libbtsbot_native.{os.getpid()}.so")
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(os.path.join(_BUILD_DIR, "build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(_LIB_PATH):
                return True
            try:
                subprocess.run(["make", "-C", _CPP_DIR, f"TARGET={tmp}"], check=True,
                               capture_output=True, timeout=120)
                os.replace(tmp, _LIB_PATH)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(_LIB_PATH)


def load_library():
    """The loaded CDLL, or None when it cannot be built or loaded."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not os.path.exists(_LIB_PATH) and not _try_build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.btsbot_decode_stamps.restype = ctypes.c_int
    lib.btsbot_decode_stamps.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    """True when the C++ decoder is loaded."""
    return load_library() is not None


def decoder() -> str:
    """'native' when the C++ decoder is loaded, else 'python'."""
    return "native" if native_available() else "python"


def decode_stamps(blobs: list[bytes], out_size: int = STAMP_SIZE,
                  pad_value: float = PAD_VALUE, num_threads: int = 0):
    """Decode a batch of gzip+FITS stamp blobs.

    Returns (stamps (N, out_size, out_size) float32, undersized stamps padded
    bottom/right with pad_value; status (N,) int32, 0 = ok)."""
    n = len(blobs)
    # zeros: a failed decode leaves its plane untouched, so it must start
    # deterministic
    out = np.zeros((n, out_size, out_size), dtype=np.float32)
    status = np.zeros(n, dtype=np.int32)

    lib = load_library()
    if lib is not None:
        blob_array = (ctypes.c_char_p * n)(*blobs)
        sizes = np.asarray([len(b) for b in blobs], dtype=np.int64)
        lib.btsbot_decode_stamps(
            blob_array, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, out_size, pad_value,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_threads)
        return out, status

    from .data.alerts import decode_stamp

    for i, blob in enumerate(blobs):
        try:
            stamp = decode_stamp(blob)
            h, w = stamp.shape
        except Exception:  # noqa: BLE001 — any malformed blob drops its alert
            status[i] = 2
            continue
        if h > out_size or w > out_size:
            status[i] = 3
            continue
        out[i] = pad_value
        out[i, :h, :w] = stamp
    return out, status
