"""Where the port keeps its compiled kernels: the counterpart of the JAX
package's `utils/compile_cache.py`.

The JAX package points XLA's persistent compilation cache at a directory,
so that every process after the first loads its compiled programs instead
of compiling them again. The port compiles one thing, the CUDA kernel
library (`ops/kernels.py`: one nvcc process a source, then a link, at the
first kernel call), under a name keyed by a hash of the sources and flags,
so a directory of such libraries is the same kind of cache: a process that
finds its library there loads it instead of building it again. This
module points that directory.

Opt out with OWC_NO_COMPILE_CACHE=1 (each process then builds into a
temporary directory of its own, removed when it exits: for measuring the
build itself); relocate with OWC_KERNEL_CACHE_DIR, which plays the part of
JAX's JAX_COMPILATION_CACHE_DIR. By default the library lives in the
package's git-ignored `_build/`.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path

from ..ops import kernels

ENV_DIR = "OWC_KERNEL_CACHE_DIR"
DEFAULT_DIR = kernels.BUILD_DIR

_configured: str | None = None   # the directory the first configurer chose


def enable_persistent_compilation_cache(cache_dir: str | None = None,
                                        min_secs: float = 1.0) -> str | None:
    """Point the kernel library's directory (`ops.kernels.BUILD_DIR`) at an
    on-disk cache and return it; idempotent, and safe to call before or
    after the first kernel call (the library is located when it is first
    built or loaded). As in the JAX package: the first caller to configure
    a directory wins, so a bare call (`import ...cli`) does not re-point one
    a user chose; an explicit `cache_dir` always overrides; with
    OWC_NO_COMPILE_CACHE set it returns None and the library is built into
    a per-process temporary directory. `min_secs` is accepted for the JAX
    signature and unused: XLA caches only programs that took that long to
    compile, while the port's one build is all or nothing."""
    global _configured
    del min_secs
    if os.environ.get("OWC_NO_COMPILE_CACHE"):
        tmp = tempfile.mkdtemp(prefix="owc-kernels-")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        kernels.BUILD_DIR = Path(tmp)
        return None
    if cache_dir is None and _configured:
        return _configured
    cache_dir = str(cache_dir or os.environ.get(ENV_DIR) or DEFAULT_DIR)
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return None                     # unwritable: the package's own _build/ stays
    kernels.BUILD_DIR = Path(cache_dir)
    _configured = cache_dir
    return cache_dir
