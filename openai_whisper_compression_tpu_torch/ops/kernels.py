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
    # the attention launchers take the head dim, then the capacity of the
    # body it runs (`head_dim_capacity`), last before the stream
    "owc_cross_attention_grouped": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _P],
    "owc_cross_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    "owc_transpose_quant_kv": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "owc_self_attention_update": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _P],
    "owc_self_attention_update_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _I, _P],
    "owc_self_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "owc_self_attention_int8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _P],
    # B, H, T, the head dim and capacity, the scale; the 12 strides are a
    # host array of long long; then the dtype code
    "owc_encoder_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                              ctypes.POINTER(ctypes.c_longlong), _I, _P],
}

# head dims the attention kernels have whole bodies for (each body a
# template on it): every Whisper size has 64, the test models 16. Any other
# head dim up to 256 runs the RAGGED body of its capacity
# (`head_dim_capacity`), which takes the head dim at run time, and any head
# dim past 256 the WIDE body of each kernel, which walks the head dim in
# chunks (capacity code `WIDE`, csrc/common.cuh's OWC_WIDE).
HEAD_DIMS = (16, 32, 64, 128)
CAPACITIES = HEAD_DIMS + (256,)
WIDE = 0

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


def require_dtype(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Raise TypeError unless every tensor has `dtype`."""
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")


def require(cond: bool, name: str, what: str) -> None:
    """Raise ValueError unless `cond` (input checks before a launch)."""
    if not cond:
        raise ValueError(f"{name}: {what}")


def require_head_dim(name: str, dh: int, int4: bool = False) -> None:
    """Raise ValueError unless the attention kernels take head dim `dh`:
    any width of at least 1, even where `int4` (split-half packed int4 K/V
    hold Dh / 2 byte rows)."""
    if dh < 1:
        raise ValueError(f"{name}: head dim must be at least 1, got {dh}")
    if int4 and dh % 2:
        raise ValueError(f"{name}: packed int4 K/V need an even head dim "
                         f"(Dh / 2 byte rows), got {dh}")


def head_dim_capacity(dh: int) -> int:
    """The width of the body that serves head dim `dh`: the smallest of
    `CAPACITIES` (16, 32, 64, 128, 256) that is >= dh, or `WIDE` past 256. A
    dh equal to its capacity among `HEAD_DIMS` runs that width's whole body;
    any other up to 256 runs the capacity's RAGGED body, which pads the head
    dim with zeros in registers and shared memory, never in device memory;
    a WIDE body takes the head dim at run time and walks it in chunks."""
    return next((c for c in CAPACITIES if c >= dh), WIDE)


# What the kernels launched so far declare they did, under XLA's key names:
# each wrapper adds, at every launch, the cost the JAX package's
# `pl.CostEstimate` declares for the same call (`record_cost`), so that
# `utils.profiling.cost_analysis` can count work it cannot see as aten ops.
COSTS = {"flops": 0.0, "bytes accessed": 0.0, "transcendentals": 0.0}


def record_cost(launch_cost: dict) -> None:
    """Add one launch's cost (flops, bytes accessed, transcendentals) to
    `COSTS`."""
    for key, v in launch_cost.items():
        COSTS[key] += float(v)


def cost(flops: int, bytes_accessed: int, transcendentals: int) -> dict:
    """A cost under XLA's key names, from a `pl.CostEstimate`'s fields."""
    return {"flops": flops, "bytes accessed": bytes_accessed,
            "transcendentals": transcendentals}


def aligned(t: torch.Tensor | None) -> torch.Tensor | None:
    """t itself where it is contiguous and starts on a 16-byte boundary (the
    kernels read 16-byte pieces of their rows), else a contiguous copy in a
    fresh, aligned buffer: the wrappers take any strided or offset view of a
    tensor they only read. None passes."""
    if t is None or (t.is_contiguous() and t.data_ptr() % 16 == 0):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on these inputs: grad mode is on
    and a tensor among them requires grad (None and non-tensors pass)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a launch would cut the autograd graph. A kernel writes its
    output through ctypes into a fresh tensor that has no `grad_fn`, and no
    kernel has a backward (nor has any Pallas kernel of the JAX package a
    VJP), so a gradient through it would be silently zero. Every wrapper
    calls this before it launches; calls under `torch.no_grad()` or
    `torch.inference_mode()`, and on tensors that do not require grad, pass."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel's output has no "
            "autograd history (the kernel has no backward); call it under "
            "torch.no_grad(), or take the plain path (the wrapper's `_ref` "
            "version, or the CPU) where a gradient is needed")
