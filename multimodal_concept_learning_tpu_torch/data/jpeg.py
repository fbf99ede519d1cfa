"""JPEG reading without Pillow: ``read_image`` returns the [H, W, 3] uint8
pixels that Pillow's ``Image.open(path).convert("RGB")`` gives over
libjpeg-turbo, bit for bit.

The decoder is host C++ (``csrc/jpeg_decode.cpp``: baseline and
progressive Huffman JPEGs, 8-bit samples, 1/3/4 components, sampling
factors 1 or 2, libjpeg's accurate integer IDCT, fancy upsampling, fixed
point colour conversion, Pillow's Adobe CMYK -> RGB).  It is compiled at
first use by the host C++ compiler (``$CXX``, else ``c++`` / ``g++``) into
the gitignored ``_build/`` directory, named by a hash of the source and
flags, written under a temporary name and renamed into place, so concurrent
first users never load a partial file.  It is loaded with ``ctypes``, which
releases the GIL during a decode, so the threaded loader decodes in
parallel.  A build failure raises: there is no other decoder.

A file that starts with the PNG signature goes to ``data/png.py`` (some
ImageNet training files named ``.JPEG`` are PNGs).  Arithmetic-coded,
lossless, hierarchical and 12-bit JPEGs, h1v2 (4:4:0) subsampling and
truncated files raise ``ValueError`` naming the file and the reason.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from multimodal_concept_learning_tpu_torch.data.png import read_png

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "jpeg_decode.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_ERR_LEN = 512


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no host C++ compiler ($CXX, c++, g++) to build the JPEG decoder")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmcl_jpeg_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoder unless this checkout already has it; the path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{os.urandom(4).hex()}.tmp")
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the JPEG decoder failed (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent builder never loads a partial file
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.mcl_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                  ctypes.c_char_p, ctypes.c_int]
    lib.mcl_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p,
                                    ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int]
    lib.mcl_jpeg_info.restype = lib.mcl_jpeg_decode.restype = ctypes.c_int
    return lib


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """[H, W, 3] uint8 RGB pixels of the JPEG in ``data``."""
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    width, height = ctypes.c_int(0), ctypes.c_int(0)
    if lib.mcl_jpeg_info(data, len(data), ctypes.byref(width), ctypes.byref(height), err,
                         _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    out = np.empty((height.value, width.value, 3), np.uint8)
    if lib.mcl_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    return out


def read_image(path: str) -> np.ndarray:
    """[H, W, 3] uint8 pixels of a JPEG (or of a PNG, whatever its name)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIGNATURE):
        return read_png(path)
    return decode_jpeg(data, path)


__all__ = ["build", "decode_jpeg", "library_path", "read_image"]
