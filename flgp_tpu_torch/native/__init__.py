"""Native (C++) host runtime of the PyTorch port.

The out-of-core fits read X from disk through this module; the compute path
stays PyTorch and CUDA.  It is a copy of ``flgp_tpu.native`` with the same
public names and the same on-disk format, so a file written by either
package opens in the other, and it imports nothing of the JAX package:

* ``MatrixFile`` / ``write_matrix``: memory-mapped binary matrices in the
  FLGP0001 format (a 32-byte header holding magic, dtype code, rows and
  cols, then the rows), the on-disk format for data larger than host RAM;
  ``MatrixFile.read_into`` reads rows straight into a caller's buffer (a
  pinned host tensor on the streamed path).
* ``StreamLoader``: a chunked row reader with a prefetch thread.
* ``knn`` / ``lae_weights``: threaded host-side brute-force kNN and LAE
  (std::thread pool), independent oracles for the kernels.
* ``polya_gamma``: the Devroye PG(b, c) sampler, a statistical oracle for
  ``ops.polya_gamma``.

The library is built at first use with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` from ``csrc/host/flgp_host.cpp`` into ``build/flgp_tpu_torch/``,
keyed by a hash of the source and the flags as ``ops/_build.py`` keys the
kernels.  A missing ``g++``, a failed build or a failed load raises
``NativeUnavailable``; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from ..ops._build import BUILD_ROOT

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host" / "flgp_host.cpp"
_LIB_NAME = "libflgp_host.so"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-DNDEBUG")

_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1, np.dtype(np.int32): 2}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


class NativeUnavailable(RuntimeError):
    """Raised when the native library cannot be built or loaded."""


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_ROOT / f"host-{h.hexdigest()[:16]}" / _LIB_NAME


def build(force: bool = False) -> str:
    """Compile the shared library unless this exact build exists; return
    its path.  Raises ``NativeUnavailable`` without ``g++`` or when the
    compiler fails."""
    out = _library_path(_SRC)
    if out.is_file() and not force:
        return str(out)
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeUnavailable("g++ not found on PATH: the host library cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"g++ failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)
    return str(out)


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise NativeUnavailable(f"cannot load {path}: {e}") from e

        i64, i32, u64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64
        p = ctypes.c_void_p
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)

        lib.flgp_knn.argtypes = [f32p, i64, i64, f32p, i64, i64, i32p, f32p, i32]
        lib.flgp_knn.restype = None
        lib.flgp_lae.argtypes = [f32p, i64, i64, f32p, i32p, i64, i32, f32p, i32]
        lib.flgp_lae.restype = None
        lib.flgp_pg_draw.argtypes = [u64, i32p, f64p, i64, f64p, i32]
        lib.flgp_pg_draw.restype = None
        lib.flgp_matrix_write.argtypes = [ctypes.c_char_p, p, i64, i64, i32]
        lib.flgp_matrix_write.restype = i64
        lib.flgp_matrix_open.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i32)
        ]
        lib.flgp_matrix_open.restype = p
        lib.flgp_matrix_read.argtypes = [p, i64, i64, p]
        lib.flgp_matrix_read.restype = i64
        lib.flgp_matrix_prefetch.argtypes = [p, i64, i64]
        lib.flgp_matrix_prefetch.restype = None
        lib.flgp_matrix_close.argtypes = [p]
        lib.flgp_matrix_close.restype = None
        lib.flgp_knn_stream.argtypes = [p, f32p, i64, i64, i64, i32p, f32p, i32]
        lib.flgp_knn_stream.restype = i64
        lib.flgp_hardware_threads.argtypes = []
        lib.flgp_hardware_threads.restype = ctypes.c_int

        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


# ---------------------------------------------------------------------------
# Threaded host kernels
# ---------------------------------------------------------------------------


def knn(X: np.ndarray, U: np.ndarray, r: int, n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Host brute-force kNN: (indices (n, r) int32, sqdists (n, r) float32)."""
    lib = _load()
    X = np.ascontiguousarray(X, np.float32)
    U = np.ascontiguousarray(U, np.float32)
    n, d = X.shape
    s = U.shape[0]
    idx = np.empty((n, r), np.int32)
    dist = np.empty((n, r), np.float32)
    lib.flgp_knn(_f32p(X), n, d, _f32p(U), s, r, _i32p(idx), _f32p(dist), n_threads)
    return idx, dist


def lae_weights(
    X: np.ndarray, U: np.ndarray, knn_idx: np.ndarray, iters: int = 150, n_threads: int = 0
) -> np.ndarray:
    """Host LAE weights (n, r), the simplex least squares of ``ops.lae``."""
    lib = _load()
    X = np.ascontiguousarray(X, np.float32)
    U = np.ascontiguousarray(U, np.float32)
    knn_idx = np.ascontiguousarray(knn_idx, np.int32)
    n, d = X.shape
    r = knn_idx.shape[1]
    w = np.empty((n, r), np.float32)
    lib.flgp_lae(_f32p(X), n, d, _f32p(U), _i32p(knn_idx), r, iters, _f32p(w), n_threads)
    return w


def polya_gamma(seed: int, b: np.ndarray, c: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """PG(b_i, c_i) draws (integer counts), Devroye sampler."""
    lib = _load()
    b = np.ascontiguousarray(b, np.int32)
    c = np.ascontiguousarray(c, np.float64)
    out = np.empty(c.shape, np.float64)
    lib.flgp_pg_draw(np.uint64(seed), _i32p(b), _f64p(c), c.size, _f64p(out), n_threads)
    return out


def hardware_threads() -> int:
    return int(_load().flgp_hardware_threads())


# ---------------------------------------------------------------------------
# Memory-mapped matrix files + streaming loader
# ---------------------------------------------------------------------------


def write_matrix(path: str, data: np.ndarray) -> None:
    """Write a 2-D array in the FLGP0001 format."""
    lib = _load()
    data = np.ascontiguousarray(data)
    code = _DTYPE_CODES.get(data.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {data.dtype}")
    rc = lib.flgp_matrix_write(
        str(path).encode(), data.ctypes.data_as(ctypes.c_void_p), data.shape[0], data.shape[1],
        code
    )
    if rc != 0:
        raise OSError(f"flgp_matrix_write({path}) failed with code {rc}")


class MatrixFile:
    """Memory-mapped read-only matrix (rows served by the native loader)."""

    def __init__(self, path: str):
        lib = _load()
        rows = ctypes.c_int64()
        cols = ctypes.c_int64()
        code = ctypes.c_int32()
        handle = lib.flgp_matrix_open(
            str(path).encode(), ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(code)
        )
        if not handle:
            raise OSError(f"cannot open {path} as an FLGP matrix")
        self._lib = lib
        self._handle = handle
        self.shape = (rows.value, cols.value)
        self.dtype = _CODE_DTYPES[code.value]

    def read(self, start: int, count: int) -> np.ndarray:
        count = min(count, self.shape[0] - start)
        out = np.empty((max(count, 0), self.shape[1]), self.dtype)
        got = self._lib.flgp_matrix_read(
            self._handle, start, count, out.ctypes.data_as(ctypes.c_void_p)
        )
        return out[:got]

    def read_into(self, start: int, count: int, data_ptr: int) -> int:
        """Copy rows [start, start + count) (clamped to the file) to the
        C-contiguous buffer at address ``data_ptr``, which must hold them in
        the file's dtype (a tensor's ``data_ptr()``, a pinned host buffer on
        the streamed path); returns the rows copied."""
        return int(self._lib.flgp_matrix_read(self._handle, start, count, data_ptr))

    def prefetch(self, start: int, count: int) -> None:
        self._lib.flgp_matrix_prefetch(self._handle, start, count)

    def knn_stream(
        self, U: np.ndarray, r: int, chunk_rows: int = 1 << 16, n_threads: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Out-of-core kNN over the whole file without materializing X."""
        if self.dtype != np.float32:
            raise ValueError("knn_stream requires a float32 matrix")
        U = np.ascontiguousarray(U, np.float32)
        n = self.shape[0]
        idx = np.empty((n, r), np.int32)
        dist = np.empty((n, r), np.float32)
        got = self._lib.flgp_knn_stream(
            self._handle, _f32p(U), U.shape[0], r, chunk_rows, _i32p(idx), _f32p(dist), n_threads
        )
        if got != n:
            raise OSError("knn_stream failed")
        return idx, dist

    def close(self) -> None:
        if self._handle:
            self._lib.flgp_matrix_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class StreamLoader:
    """Chunk iterator over a MatrixFile with a prefetch thread: a background
    thread reads (and madvise-prefetches) the next chunks while the caller
    consumes the current one, at most ``depth`` chunks ahead."""

    def __init__(self, mat: MatrixFile, chunk_rows: int, depth: int = 2):
        self.mat = mat
        self.chunk_rows = chunk_rows
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread: Optional[threading.Thread] = None

    def _producer(self):
        n = self.mat.shape[0]
        for lo in range(0, n, self.chunk_rows):
            self.mat.prefetch(lo + self.chunk_rows, self.chunk_rows)
            self._q.put((lo, self.mat.read(lo, self.chunk_rows)))
        self._q.put(None)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item
