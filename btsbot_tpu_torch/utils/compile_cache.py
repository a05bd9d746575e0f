"""A persistent kernel cache for serving cold-start (port of
btsbot_tpu/utils/compile_cache.py).

A broker restarts its scorer processes.  The JAX package keeps XLA's
compiled executables in a persistent cache; the port's counterpart is the
kernel library: ``ops/_build.py`` compiles ``csrc/*.cu`` with ``nvcc`` into
``build/kernels/libbtsbot_kernels.so`` and a digest of the sources and
flags beside it, and loads that library instead of compiling again while
the digest matches.  ``enable(cache_dir)`` moves that directory, so a
daemon restarted in a fresh checkout or container (``cli.serve
--compile-cache DIR``) loads the library it built before.  PyTorch's own
operators need no cache: they run eagerly.

Call it before the first kernel launch: a library already loaded stays
loaded for the life of the process.
"""

from __future__ import annotations

from pathlib import Path

from ..ops import _build


def enable(cache_dir) -> Path:
    """Build and load the kernel library in ``cache_dir`` from now on;
    returns the directory."""
    path = Path(cache_dir).expanduser().resolve()
    _build.BUILD_DIR = path
    return path


def disable() -> None:
    """Back to the default build directory, ``build/kernels/``."""
    _build.BUILD_DIR = _build.DEFAULT_BUILD_DIR
