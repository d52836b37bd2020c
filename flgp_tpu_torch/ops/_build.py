"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every source under ``flgp_tpu_torch/csrc/`` for Hopper
(``sm_90a``), one process per source and all at once, and links the objects
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use into ``build/flgp_tpu_torch/<hash>/`` beside the
package, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the library already there.  A missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "flgp_tpu_torch"
LIB_NAME = "libflgp_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills per kernel, kept in ptxas.log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points and their argument types (pointers and the stream as void*)
_SIGNATURES = {
    "flgp_knn": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "flgp_knn_wide_lists": [_I, _I, _I],
    "flgp_lae": [_P, _L, _L, _P, _P, _L, _L, _I, _I, _I, _I, _I, _P, _P, _P],
    "flgp_lae_wide": [_P, _L, _L, _P, _P, _L, _L, _I, _I, _I, _I, _I, _P, _P, _P],
    "flgp_lae_div_check": [_I, _P, _P],
    "flgp_ell_norm_matmat": [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P, _P],
    "flgp_ell_colsum_t": [_P, _P, _L, _I, _P, _P],
    "flgp_ell_norm_gram_t": [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P, _P, _P, _P],
    "flgp_ell_norm_gram_t_wide": [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P, _P,
                                  _P],
    "flgp_ell_norm_matmat_t": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P, _P],
    "flgp_ell_norm_matmat_wide": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P, _P],
    "flgp_ell_matmat": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "flgp_ell_sym_matmat": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "flgp_polya_gamma": [_P, _P, _L, _I, _P, _P],
    "flgp_weighted_kmeanspp": [_P, _P, _P, _I, _I, _P, _P],
}

# entry points that return a count, not a cudaError
_RESTYPES = {"flgp_knn_wide_lists": ctypes.c_longlong}

_lib = None


def sources() -> list:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels "
        "of flgp_tpu_torch cannot be built"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels unless this exact build exists; return the .so."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    units = [(src, out.with_name(f"{src.stem}.{pid}.o"))
             for src in sources() if src.suffix == ".cu"]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)] for src, obj in units]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=SRC_DIR) for cmd in cmds]
    log = []
    try:
        for cmd, proc in zip(cmds, procs):
            _finish(cmd, proc, log)
        tmp = out.with_name(f"{LIB_NAME}.{pid}.tmp")
        link = [nvcc, "-shared", "-o", str(tmp), *[str(obj) for _, obj in units]]
        _finish(link, subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True, cwd=SRC_DIR), log)
        os.replace(tmp, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        (out.parent / "ptxas.log").write_text("".join(log))
        for _, obj in units:
            obj.unlink(missing_ok=True)
    return out


def _finish(cmd: list, proc: subprocess.Popen, log: list) -> None:
    """Wait for one nvcc process, keep its output, raise if it failed."""
    stdout, stderr = proc.communicate()
    log.append(stdout + stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{stderr[-4000:]}"
        )


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _lib = lib
    return _lib
