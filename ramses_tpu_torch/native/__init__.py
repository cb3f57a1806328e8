"""Native host kernels of the tree passes: C++ built with g++ on first use,
bound through ctypes.

The port's own copy of the JAX package's ``native`` module, with the two
entries the port calls: :func:`morton_encode` (``amr/keys.encode``) and
:func:`lookup_sorted` (``amr/tree.Octree.lookup_keys``).  Each is bitwise
equal to its numpy path.  The callers choose numpy or this library by the
batch's size alone (4,096 keys and more go here, as in the JAX package);
there is no switch to turn the library off and no fallback: a build that
fails raises with the compiler's output.

``src/ramses_native.cpp`` is compiled with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``ramses_tpu_torch/_build/`` (beside the CUDA kernels'
builds, keyed on a hash of the source and the flags), written to a
temporary file and renamed into place, so that a failed or concurrent build
leaves nothing that looks built.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "ramses_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """Where the build lives: the name carries a hash of the source and
    the flags, so an edit to either forces a rebuild."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libramses_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    ``RuntimeError`` naming the compiler's output when g++ fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SRC)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build {SRC.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)        # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(str(build()))
            L.morton_encode.argtypes = [_i64p, ctypes.c_int64, ctypes.c_int,
                                        _i64p]
            L.morton_encode.restype = None
            L.lookup_i64.argtypes = [_i64p, ctypes.c_int64, _i64p,
                                     ctypes.c_int64, _i64p]
            L.lookup_i64.restype = None
            _lib = L
        return _lib


def morton_encode(og: np.ndarray, ndim: int) -> np.ndarray:
    """Morton keys (int64) of integer coords ``og [n, ndim]``."""
    og = np.ascontiguousarray(og, dtype=np.int64).reshape(-1, ndim)
    out = np.empty(len(og), dtype=np.int64)
    lib().morton_encode(og, len(og), ndim, out)
    return out


def lookup_sorted(sorted_keys: np.ndarray,
                  queries: np.ndarray) -> np.ndarray:
    """Position of each query in the ascending ``sorted_keys``; -1 where
    absent."""
    s = np.ascontiguousarray(sorted_keys, dtype=np.int64)
    q = np.ascontiguousarray(queries, dtype=np.int64)
    out = np.empty(len(q), dtype=np.int64)
    lib().lookup_i64(s, len(s), q, len(q), out)
    return out
