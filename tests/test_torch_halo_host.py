"""K5's CUDA source built for the host CPU, against its plain version.

``ramses_tpu_torch/csrc/halo_exchange.cu`` is compiled with ``g++`` into a
shared library: a small header stands in for the CUDA runtime (the
qualifiers are empty, the vector types are aligned structs) and the
``<<<grid, block>>>`` launch becomes loops over blocks and threads, in
order.  Each launch then copies exactly what the card's would, so the
copy table (:func:`ramses_tpu_torch.parallel.dma_halo.call`), the unit
choice by alignment and the grid-stride walk are held bitwise to
:func:`ramses_tpu_torch.parallel.dma_halo.halo_exchange_ref` here on the
CPU, before any chip run.  Skips without ``g++``.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu_torch import kernels  # noqa: E402
from ramses_tpu_torch.parallel import dma_halo  # noqa: E402

RUNTIME = """
#pragma once
#include <stdint.h>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx, threadIdx, blockDim, gridDim;
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
typedef void* cudaStream_t;
"""

LAUNCH = re.compile(r"(\w+)<<<grid, block, 0, s>>>\(([^;]*)\);")


def _as_loop(m):
    return ("for (unsigned bx_ = 0; bx_ < grid.x; ++bx_) "
            "for (unsigned tx_ = 0; tx_ < block.x; ++tx_) "
            "{ blockIdx = dim3(bx_); threadIdx = dim3(tx_); "
            "blockDim = block; gridDim = grid; "
            f"{m.group(1)}({m.group(2)}); }}")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("halo_host")
    (out / "cuda_runtime.h").write_text(RUNTIME)
    src, n = LAUNCH.subn(_as_loop,
                         (kernels.CSRC / "halo_exchange.cu").read_text())
    assert n == 1 and "<<<" not in src
    (out / "halo_exchange.cpp").write_text(src)
    lib_path = out / "libhalo_exchange_host.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O1", "-shared",
                    "-fPIC", "-w", "-I", str(out), "-o", str(lib_path),
                    str(out / "halo_exchange.cpp")], check=True,
                   capture_output=True)
    return dma_halo.bind(ctypes.CDLL(str(lib_path)))


def _pairs(rng, dtype, axis, nshard, ng=2, ext=False):
    """Each shard's high slab of a random ``[5, X, Y, Z]`` block along
    ``axis`` into its +1 neighbour: into a fresh ghost tensor, or (``ext``)
    into the low ghost region of the neighbour's block extended along
    that axis."""
    shape = (5, 6, 7, 9)
    blocks = [torch.from_numpy(rng.standard_normal(shape)).to(dtype)
              for _ in range(nshard)]
    dsts = []
    for s, b in enumerate(blocks):
        if ext:
            eshape = list(shape)
            eshape[axis] += 2 * ng
            dsts.append(torch.zeros(eshape, dtype=dtype).narrow(axis, 0, ng))
        else:
            dsts.append(torch.zeros_like(
                b.narrow(axis, 0, ng), memory_format=torch.contiguous_format))
    return [(blocks[s].narrow(axis, shape[axis] - ng, ng),
             dsts[(s + 1) % nshard]) for s in range(nshard)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int16, torch.uint8])
@pytest.mark.parametrize("axis", [1, 2, 3])
@pytest.mark.parametrize("ext,ng", [(False, 2), (True, 2), (True, 1)])
def test_k5_host_build_matches_plain_version(host_lib, dtype, axis, ext,
                                             ng):
    """Every unit width: 16-byte rows (f64 along x), 8-byte rows (f32 along
    z), down to the 1-byte rows of a 1-deep uint8 slab along z."""
    rng = np.random.default_rng(axis * 10 + ext)
    got = _pairs(rng, dtype, axis, 4, ng=ng, ext=ext)
    rng = np.random.default_rng(axis * 10 + ext)
    want = _pairs(rng, dtype, axis, 4, ng=ng, ext=ext)
    assert dma_halo.call(host_lib, got) == 1
    dma_halo.halo_exchange_ref(want)
    for (gs, gd), (ws, wd) in zip(got, want):
        assert torch.equal(gs, ws) and torch.equal(gd, wd)
        assert torch.equal(gd, gs)                 # every byte moved
        # nothing outside the destination view was written
        assert torch.equal(gd._base if gd._base is not None else gd,
                           wd._base if wd._base is not None else wd)


def test_k5_host_build_splits_a_long_table(host_lib):
    """More pairs than one launch's table takes go out in several
    launches, each entry once."""
    rng = np.random.default_rng(3)
    pairs = [(torch.from_numpy(rng.standard_normal((3, 2, 5))).float()[:, 1],
              torch.zeros(3, 5)) for _ in range(dma_halo.MAX_ENTRIES + 7)]
    assert dma_halo.call(host_lib, pairs) == 2
    for src, dst in pairs:
        assert torch.equal(src, dst)
