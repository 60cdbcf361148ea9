"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

All kernels compile, at first use, into one shared library with a plain C
interface, which is loaded with ctypes: one `nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -c` per source, all started together,
then one `nvcc -shared` link. The library lives in `_build/` inside the package,
under a name keyed by a hash of the sources and flags, so a fresh checkout
builds exactly what it holds and a changed source never loads a stale
binary. Nothing here runs at import time: the CPU tests import every module
of the port without a CUDA toolkit.

Each launcher takes raw device pointers (`tensor.data_ptr()`), sizes, a
dtype code where the kernel takes more than one element type, and the current
CUDA stream, and returns `cudaGetLastError()`; `check()` turns a nonzero
code into an exception.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# no fast-math flags: the quantizing kernels need IEEE division to round
# as the plain versions do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C launcher name -> argtypes (pointers and the stream as c_void_p, sizes as
# c_int); every launcher returns a cudaError_t as int
_SIGNATURES = {
    "owc_int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "owc_int4_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "owc_nf4_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "owc_group_asym_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _P],
    "owc_w8a8_matmul": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "owc_mel_log10": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "owc_cross_attention_grouped": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _P],
    "owc_cross_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P],
    "owc_transpose_quant_kv": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "owc_self_attention_update": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _P],
    "owc_self_attention_update_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _P],
    "owc_self_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "owc_self_attention_int8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the 12 strides are a host array of long long
    "owc_encoder_attention": [_P, _P, _P, _P, _I, _I, _I, _F,
                              ctypes.POINTER(ctypes.c_longlong), _P],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin directory on PATH)")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libowc_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hashed shared library unless it exists:
    one nvcc process per source, all at once, then a link. A file lock
    serialises concurrent builds; the library is written to a temporary
    name and renamed into place, so a reader never sees half a file."""
    global build_seconds
    so = library_path()
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        nvcc = _nvcc()
        t0 = time.perf_counter()
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
            objs = [str(Path(objdir) / (p.stem + ".o"))
                    for p in _sources() if p.suffix == ".cu"]
            jobs = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / (Path(o).stem + ".cu")),
                     "-o", o] for o in objs]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for cmd in jobs]
            outputs = [proc.communicate()[0] for proc in procs]
            for cmd, proc, out in zip(jobs, procs, outputs):
                _check_build(cmd, out, proc.returncode)
            link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]
            res = subprocess.run(link, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            _check_build(link, res.stdout, res.returncode)
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    return so


def _check_build(cmd: list[str], output: str, returncode: int) -> None:
    if returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed ({' '.join(cmd)}):\n"
                           f"{output}")


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor, name: str, *same: torch.Tensor) -> int:
    """The code of t's element type, one of `DTYPE_CODES`; raises TypeError
    on any other type, and where a tensor of `same` has another type than
    t."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes float32, bfloat16 or "
                        f"float16, got {t.dtype}")
    require_dtype(name, t.dtype, *same)
    return DTYPE_CODES[t.dtype]


def require_bf16(name: str, *tensors: torch.Tensor) -> None:
    """Raise TypeError unless every tensor is bfloat16 (bf16-only kernels)."""
    require_dtype(name, torch.bfloat16, *tensors)


def require_dtype(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Raise TypeError unless every tensor has `dtype`."""
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")


def require(cond: bool, name: str, what: str) -> None:
    """Raise ValueError unless `cond` (input checks before a launch)."""
    if not cond:
        raise ValueError(f"{name}: {what}")
