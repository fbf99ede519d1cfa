"""Build and load the port's CUDA kernels.

The kernels under ``csrc/`` have a plain C interface.  ``nvcc`` compiles
each source in parallel for Hopper (``sm_90a``) and links them into one
shared library, which is loaded with ``ctypes``; no PyTorch header is
compiled, so a build takes seconds.
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
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "flash_attention_bwd_tc.cu",
           "paged_attention.cu", "attention_core.cu", "paged_attention_mp.cu", "int4_matmul.cu",
           "attention_core_bd.cu", "fused_attention_block.cu", "int4_matmul_v3.cu",
           "merged_bwd_tc.cu", "multi_tensor_adamw.cu")
HEADERS = ("flash_attention_common.cuh", "merged_attention.cuh", "mma_tiles.cuh",
           "merged_tiles.cuh", "merged_bwd_tc.cuh", "paged_split.cuh", "int4_split.cuh")
SMEM_PER_BLOCK = 232448  # bytes of shared memory one block may use on sm_90 (227 KB)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes per entry point: every pointer and the stream are c_void_p, or
# ctypes would pass them as 32-bit ints and cut them
_SIGNATURES = {
    "mcl_flash_attention_fwd": (
        _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    "mcl_flash_attention_bwd_dq": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    "mcl_flash_attention_bwd_dkv": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    "mcl_paged_decode_attention": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "mcl_attention_core_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "mcl_attention_core_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "mcl_paged_decode_attention_mp": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "mcl_int4_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "mcl_attention_core_bd_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "mcl_attention_core_bd_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    "mcl_fused_attention_fwd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P),
    "mcl_fused_attention_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    "mcl_int4_matmul_v3a": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "mcl_int4_matmul_v3b": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "mcl_multi_tensor_accumulate": (_P, _I, _I, _P),
    "mcl_multi_tensor_sq_norm": (_P, _I, _I, _P, _I, _P),
    "mcl_multi_tensor_sum": (_P, _I, _P, _P),
    "mcl_multi_tensor_adamw": (_P, _I, _I, _P, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P),
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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmcl_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels if this checkout has no library for the current
    sources: one ``nvcc -c`` per source, all started together, then one
    link.  Returns {"path", "seconds", "log"} (seconds 0.0 when reused; log
    holds nvcc's ``-Xptxas -v`` register/smem report of a fresh build)."""
    lib = library_path()
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    objs = [BUILD_DIR / f"{Path(s).stem}.{os.getpid()}.o" for s in SOURCES]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj), str(CSRC / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    rc = max(p.returncode for p in procs)
    if rc == 0:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        rc = link.returncode
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rc {rc}):\n{log}")
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


def cuda_operand(t):
    """Tensor ``t`` contiguous and 16-byte aligned, copied only if it is
    not: the kernels read their operands 16 bytes at a time, and a strided
    view or one at an odd offset (which the JAX functions take) is copied,
    not refused."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = kernels().mcl_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
