"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` launchers; shared
device code sits in ``csrc/*.cuh`` headers.  A source is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``ramses_tpu_torch/_build/`` at first use, keyed on a hash of its source,
the headers and the flags, and loaded with ``ctypes``.  Nothing is built
at import time: the CPU tests import every module and never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# --split-compile=0: nvcc runs its optimisation passes on every core of the
# machine (mhd_ct.cu's 75 kernels build in ~40 s instead of ~110 s)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

# flags of one source beside NVCC_FLAGS: the cooling solve (K6), the RT
# transport (K8) and the RT chemistry (K9) are built without FMA
# contraction, so that their arithmetic rounds where their plain versions'
# does
EXTRA_FLAGS: Dict[str, tuple] = {name: ("-fmad=false",)
                                 for name in ("cooling", "rt_m1", "rt_chem")}

_loaded: Dict[str, ctypes.CDLL] = {}


def flags(name: str) -> tuple:
    """The ``nvcc`` flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives: the file name carries
    a hash of the source, every shared header under ``csrc/`` and the
    flags, so an edit to any of them forces a rebuild."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Build every named source that is not built yet, one ``nvcc`` per
    source, all started together; returns the compiler's report (ptxas
    registers and spills) of each one built now.

    ``nvcc`` writes into a temporary file that is renamed into place, so a
    failed or interrupted build leaves nothing that looks built.
    """
    jobs = {}
    try:
        for name in names:
            target = library_path(name)
            if target.exists() or name in jobs:
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *flags(name), "-o", tmp,
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, target)
        logs, failed = {}, []
        for name, (proc, tmp, target) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build csrc/{name}.cu "
                              f"(exit {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, target)    # atomic: concurrent builds agree
            logs[name] = out
        if failed:
            raise RuntimeError("\n".join(failed))
        return logs
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def sources() -> list:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
