"""Build and load the port's CUDA kernels.

The kernels under ``csrc/`` have a plain C interface.  ``nvcc`` compiles all
of them into one shared library for Hopper (``sm_90a``), which is loaded
with ``ctypes``; no PyTorch header is compiled, so a build takes seconds.
The library lands in ``multimodal_concept_learning_tpu_torch/_build/``,
named by a hash of the sources and flags: the first call in a checkout
builds, later calls (and later processes) reuse the file.

Every entry point returns the ``cudaError_t`` of its launch; ``check``
turns a non-zero code into an exception.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_attention_fwd.cu", "paged_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes per entry point: every pointer and the stream are c_void_p, or
# ctypes would pass them as 32-bit ints and cut them
_SIGNATURES = {
    "mcl_flash_attention_fwd": (
        _P, _P, _P, _P, _P, _L, _L, _L, _L, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    "mcl_paged_decode_attention": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                           "the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmcl_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels if this checkout has no library for the current
    sources.  Returns {"path", "seconds", "log"} (seconds 0.0 when reused;
    log holds nvcc's ``-Xptxas -v`` register/smem report of a fresh build)."""
    lib = library_path()
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent builder never loads a partial file
    lib.with_suffix(".log").write_text(log)
    return {"path": str(lib), "seconds": seconds, "log": log}


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.mcl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = kernels().mcl_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
