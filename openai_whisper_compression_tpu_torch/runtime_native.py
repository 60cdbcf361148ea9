"""ctypes bindings for the native C++ runtime (runtime/src/owc_runtime.cpp).

A framework-free copy of the JAX package's `runtime_native.py`: host-side
batch assembly (with FLAC requests decoded in the loader's worker pool and
per-slot decode-failure flags, the serving wire), FLAC decoding and the
sparse codec of the sparse-zip storage format. Builds the shared library
with g++ into the git-ignored `runtime/build/` on first use, under a file
lock and by an atomic rename (`build`; a C ABI and ctypes, no pybind11).
Every entry point has a numpy fallback so the package works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIB_PATH = os.path.join(_REPO_ROOT, "runtime", "build", "libowcruntime.so")
_SRCS = ("src/owc_runtime.cpp", "src/owc_flac.cpp")
_loaded: ctypes.CDLL | None = None
_build_failed = False


def _open(path: str) -> ctypes.CDLL | None:
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def build() -> bool:
    """Build `runtime/build/libowcruntime.so` unless a loadable one is in
    place; True when one is. Processes that start at once (pytest workers,
    spawned ranks) serialise on an exclusive lock in `runtime/build/`;
    g++ writes a private file (the Makefile's flags) that `os.replace`
    moves into place, so no loader ever opens a half-written library, and
    a partial file another builder left behind is replaced."""
    import fcntl
    import tempfile

    root = os.path.join(_REPO_ROOT, "runtime")
    if not all(os.path.exists(os.path.join(root, s)) for s in _SRCS):
        return False
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    with open(os.path.join(os.path.dirname(_LIB_PATH), ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_LIB_PATH) and _open(_LIB_PATH) is not None:
            return True
        fd, tmp = tempfile.mkstemp(suffix=".so",
                                   dir=os.path.dirname(_LIB_PATH))
        os.close(fd)
        flags = os.environ.get("CXXFLAGS",
                               "-O3 -march=native -fPIC -std=c++17 -Wall")
        cmd = ([os.environ.get("CXX", "g++")] + flags.split()
               + ["-shared", "-pthread", "-o", tmp]
               + [os.path.join(root, s) for s in _SRCS])
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            os.chmod(tmp, 0o755)
            os.replace(tmp, _LIB_PATH)
        except Exception:
            return False
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return True


def _lib() -> ctypes.CDLL | None:
    """The library, loaded once. A library that is missing or does not
    load is (re)built under `build`'s lock; only a failed build is
    remembered, never a load that raced another process's build."""
    global _loaded, _build_failed
    if _loaded is not None:
        return _loaded
    lib = _open(_LIB_PATH) if os.path.exists(_LIB_PATH) else None
    if lib is None:
        if _build_failed:
            return None
        if not build():
            _build_failed = True
            return None
        lib = _open(_LIB_PATH)
        if lib is None:
            return None

    lib.owc_loader_create.restype = ctypes.c_void_p
    lib.owc_loader_create.argtypes = [ctypes.c_int, ctypes.c_int64,
                                      ctypes.c_int]
    lib.owc_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.owc_loader_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int]
    lib.owc_loader_clear.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.owc_loader_flush.restype = ctypes.POINTER(ctypes.c_float)
    lib.owc_loader_flush.argtypes = [ctypes.c_void_p]
    lib.owc_nnz.restype = ctypes.c_int64
    lib.owc_nnz.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                            ctypes.c_int]
    lib.owc_sparse_encode.restype = ctypes.c_int64
    lib.owc_sparse_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int]
    lib.owc_sparse_decode.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int]
    if hasattr(lib, "owc_flac_open"):  # .so may predate the FLAC decoder
        lib.owc_loader_submit_flac.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.owc_loader_take_errors.restype = ctypes.c_int
        lib.owc_loader_take_errors.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "owc_loader_error_slots"):
            lib.owc_loader_error_slots.restype = ctypes.c_int
            lib.owc_loader_error_slots.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.owc_flac_open.restype = ctypes.c_void_p
        lib.owc_flac_open.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.c_int64]
        lib.owc_flac_info.restype = ctypes.c_int
        lib.owc_flac_info.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_int32)] * 3
        lib.owc_flac_samples.restype = ctypes.c_int64
        lib.owc_flac_samples.argtypes = [ctypes.c_void_p]
        lib.owc_flac_data.restype = ctypes.POINTER(ctypes.c_int32)
        lib.owc_flac_data.argtypes = [ctypes.c_void_p]
        lib.owc_flac_close.argtypes = [ctypes.c_void_p]
    _loaded = lib
    return lib


def available() -> bool:
    return _lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


# ---------------------------------------------------------------------------
# BatchLoader
# ---------------------------------------------------------------------------

class BatchLoader:
    """Threaded audio batch assembler (native when available).

    submit() utterances into slots, flush() waits for all jobs, swaps the
    double buffer, and returns the assembled (batch, n_samples) float32
    array — feature prep for batch N+1 can overlap the device on batch N.
    """

    def __init__(self, batch: int, n_samples: int, n_threads: int = 4):
        self.batch = batch
        self.n_samples = n_samples
        self._lib = _lib()
        self._keepalive: list[np.ndarray] = []
        if self._lib is not None:
            self._h = self._lib.owc_loader_create(batch, n_samples, n_threads)
        else:
            self._h = None
            self._buf = np.zeros((batch, n_samples), np.float32)

    def submit(self, slot: int, wav: np.ndarray, sample_rate: int = 16000):
        wav = np.ascontiguousarray(wav, np.float32)
        if self._h is not None:
            self._keepalive.append(wav)  # alive until flush
            self._lib.owc_loader_submit(self._h, slot, _fptr(wav), wav.size,
                                        sample_rate)
        else:
            if sample_rate != 16000:
                n_out = int(len(wav) * 16000 / sample_rate)
                x = np.interp(np.arange(n_out) * sample_rate / 16000.0,
                              np.arange(len(wav)), wav).astype(np.float32)
            else:
                x = wav
            n = min(len(x), self.n_samples)
            self._buf[slot, :n] = x[:n]
            self._buf[slot, n:] = 0

    def submit_flac(self, slot: int, data: bytes):
        """Submit a FLAC-encoded utterance: decode + downmix + resample run
        inside the worker pool (a batch of files decodes in parallel).
        Decode failures surface at flush(); without the native decoder the
        pure-Python one raises here."""
        if self._h is not None and hasattr(self._lib, "owc_flac_open"):
            buf = np.frombuffer(data, np.uint8)
            self._keepalive.append(buf)  # alive until flush
            self._lib.owc_loader_submit_flac(
                self._h, slot,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size)
        else:
            samples, sr, bits = flac_decode(data)
            wav = samples.astype(np.float32) / float(1 << (bits - 1))
            wav = wav.mean(axis=1) if wav.shape[1] > 1 else wav[:, 0]
            self.submit(slot, wav, sample_rate=sr)

    def clear(self, slot: int):
        if self._h is not None:
            self._lib.owc_loader_clear(self._h, slot)
        else:
            self._buf[slot] = 0

    def flush(self, raise_on_error: bool = True) -> np.ndarray:
        """Wait for all jobs; return the assembled batch (copied out).

        raise_on_error=True: RuntimeError if any submit_flac decode failed.
        raise_on_error=False: failed slots come back zeroed and their
        indices from `take_error_slots()`, so one corrupt stream fails only
        its own request, not its co-riding batch."""
        if self._h is not None:
            ptr = self._lib.owc_loader_flush(self._h)
            self._keepalive.clear()
            self._error_slots: list[int] = []
            if hasattr(self._lib, "owc_loader_error_slots"):
                flags = np.zeros(self.batch, np.int32)
                n_err = self._lib.owc_loader_error_slots(
                    self._h, flags.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int32)))
                self._error_slots = np.flatnonzero(flags).tolist()
            elif hasattr(self._lib, "owc_loader_take_errors"):
                n_err = self._lib.owc_loader_take_errors(self._h)
            else:
                n_err = 0
            if n_err and raise_on_error:
                raise RuntimeError(
                    f"BatchLoader: {n_err} FLAC decode failure(s) in "
                    f"this batch (slots zeroed)")
            arr = np.ctypeslib.as_array(
                ptr, shape=(self.batch, self.n_samples))
            return np.array(arr)  # copy: front buffer is reused next flush
        self._error_slots = []
        return self._buf.copy()

    def take_error_slots(self) -> list[int]:
        """Slot indices whose FLAC decode failed in the batch returned by
        the last flush() (empty when the library predates per-slot flags)."""
        out = getattr(self, "_error_slots", [])
        self._error_slots = []
        return out

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.owc_loader_destroy(self._h)


# ---------------------------------------------------------------------------
# FLAC decode
# ---------------------------------------------------------------------------

def flac_native_available() -> bool:
    lib = _lib()
    return lib is not None and hasattr(lib, "owc_flac_open")


def flac_decode(data: bytes) -> tuple[np.ndarray, int, int]:
    """Decode a FLAC stream → (int32 samples shaped (n, channels),
    sample_rate, bits_per_sample). Native C++ decoder when built
    (runtime/src/owc_flac.cpp), pure-Python `audio.flac` otherwise —
    bit-identical outputs (pinned by tests/test_flac.py)."""
    if flac_native_available():
        lib = _lib()
        buf = np.frombuffer(data, np.uint8)
        h = lib.owc_flac_open(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size)
        if h:
            try:
                sr = ctypes.c_int32()
                ch = ctypes.c_int32()
                bits = ctypes.c_int32()
                lib.owc_flac_info(h, ctypes.byref(sr), ctypes.byref(ch),
                                  ctypes.byref(bits))
                n = lib.owc_flac_samples(h)
                arr = np.ctypeslib.as_array(lib.owc_flac_data(h),
                                            shape=(n, ch.value))
                return np.array(arr), sr.value, bits.value  # copy before close
            finally:
                lib.owc_flac_close(h)
        # fall through to Python on native parse failure (loud is wrong
        # here: the Python decoder raises the informative error instead)
    from .audio.flac import decode_flac

    samples, info = decode_flac(data)
    return samples, info.sample_rate, info.bits_per_sample


# ---------------------------------------------------------------------------
# Sparse codec
# ---------------------------------------------------------------------------

def sparse_encode(data: np.ndarray,
                  n_threads: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """-> (flat int64 indices, float32 values) of the nonzeros, in index
    order (threaded native extraction when the library is built)."""
    flat = np.ascontiguousarray(data.reshape(-1), np.float32)
    lib = _lib()
    if lib is None:
        nz = np.nonzero(flat)[0].astype(np.int64)
        return nz, flat[nz]
    nnz = lib.owc_nnz(_fptr(flat), flat.size, n_threads)
    idx = np.empty(nnz, np.int64)
    val = np.empty(nnz, np.float32)
    written = lib.owc_sparse_encode(_fptr(flat), flat.size, _iptr(idx),
                                    _fptr(val), n_threads)
    if written != nnz:
        raise RuntimeError(f"owc_sparse_encode wrote {written} of {nnz} nonzeros")
    return idx, val


def sparse_decode(idx: np.ndarray, val: np.ndarray, shape: tuple,
                  n_threads: int = 4) -> np.ndarray:
    """Dense float32 array of `shape` with `val` at the flat `idx`, zeros
    elsewhere (the inverse of `sparse_encode`)."""
    n = int(np.prod(shape))
    lib = _lib()
    if lib is None:
        out = np.zeros(n, np.float32)
        out[idx] = val
        return out.reshape(shape)
    out = np.empty(n, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    val = np.ascontiguousarray(val, np.float32)
    lib.owc_sparse_decode(_iptr(idx), _fptr(val), idx.size, _fptr(out), n,
                          n_threads)
    return out.reshape(shape)
