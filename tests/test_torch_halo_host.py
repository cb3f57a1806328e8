"""K5's CUDA source built for the host CPU, against its plain version.

``ramses_tpu_torch/csrc/halo_exchange.cu`` is compiled with ``g++`` into a
shared library: a small header stands in for the CUDA runtime (the
qualifiers are empty, the vector types are aligned structs) and the
``<<<grid, block>>>`` launch becomes loops over blocks and threads, in
order.  Each launch then copies exactly what the card's would, so the
copy table and its launch plan (:func:`ramses_tpu_torch.parallel.
dma_halo.call`, :func:`~ramses_tpu_torch.parallel.dma_halo.plan`: a range
of blocks an entry, the unit chosen by alignment), the block's search for
its entry and each thread's loads in flight are held bitwise to
:func:`ramses_tpu_torch.parallel.dma_halo.halo_exchange_ref` here on the
CPU, before any chip run.  Skips without ``g++``; the plan's coverage test
needs no compiler.
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


def _held(host_lib, pairs, launches=1):
    """K5's host build over ``pairs`` (destinations filled with 77 first)
    against the plain version into copies filled the same way: bitwise,
    nothing written outside the destinations."""
    def base(t):
        return t._base if t._base is not None else t
    ref = []
    for s, d in pairs:
        base(d).fill_(77)
        rb = torch.full_like(base(d), 77)
        ref.append((s, rb.as_strided(d.shape, d.stride(),
                                     d.storage_offset())))
    assert dma_halo.call(host_lib, pairs) == launches
    dma_halo.halo_exchange_ref(ref)
    for (s, d), (_, r) in zip(pairs, ref):
        assert torch.equal(base(d), base(r)) and torch.equal(d, s)


def _ring(blocks, ax, ng):
    """Every shard's high slab along ``ax`` to shard +1, its low slab to
    shard -1, into fresh tensors: one direction after the other, as
    ``exchange_slabs`` orders a field's sends."""
    n = len(blocks)
    hi = [(b.narrow(ax, b.shape[ax] - ng, ng), (s + 1) % n)
          for s, b in enumerate(blocks)]
    lo = [(b.narrow(ax, 0, ng), (s - 1) % n) for s, b in enumerate(blocks)]
    return [(src, torch.empty_like(src, memory_format=torch.contiguous_format))
            for src, _ in hi + lo]


@pytest.mark.parametrize("ng,masked", [(2, True), (1, False)])
def test_k5_host_build_at_the_amr_exchanges(host_lib, ng, masked):
    """The sharded AMR level's exchanges at a small size: 8 shards of a
    6^3 box, the state ``[5, ...]`` and (the sweep, ng 2) its mask, the x
    exchange on the box, y on the box extended along x, z on the box
    extended along x and y (rows of 2 and 1 f32, 8 and 4 bytes), one launch
    an exchange as ``halo_extend`` makes them."""
    rng = np.random.default_rng(ng)
    loc = 6
    for axis in range(3):
        shape = [loc + 2 * ng if a < axis else loc for a in range(3)]
        state = [torch.from_numpy(rng.standard_normal([5] + shape)).float()
                 for _ in range(8)]
        pairs = _ring(state, 1 + axis, ng)
        if masked:
            mask = [torch.from_numpy(rng.random(shape) < 0.3).float()
                    for _ in range(8)]
            pairs += _ring(mask, axis, ng)
        _held(host_lib, pairs)


def test_k5_host_build_small_entries_beside_large_ones(host_lib):
    """Entries of 1 unit up to several blocks' worth in one launch, in an
    order that puts small ones between large ones, with every unit width
    among them: each entry's block range is its own."""
    rng = np.random.default_rng(11)
    pairs = []
    for k, (shape, dtype, ax, ng) in enumerate([
            ((5, 40, 30, 9), torch.float32, 1, 2),     # 16-byte units, wide
            ((3, 4, 5), torch.float32, 2, 1),          # one 4-byte unit a row
            ((2, 3), torch.uint8, 1, 1),               # 1-byte units
            ((5, 30, 41, 20), torch.float32, 3, 2),    # 8-byte rows
            ((4, 2, 6), torch.int16, 2, 1),            # 2-byte units
            ((1, 1, 4), torch.float64, 2, 2),          # one 16-byte row
            ((7, 33, 65), torch.float64, 1, 2),        # 16-byte units
            ((9,), torch.float32, 0, 3),               # a 12-byte row
    ]):
        b = torch.from_numpy(rng.standard_normal(shape) * 50).to(dtype)
        for src in (b.narrow(ax, b.shape[ax] - ng, ng), b.narrow(ax, 0, ng)):
            pairs.append((src, torch.empty_like(
                src, memory_format=torch.contiguous_format)))
    _held(host_lib, pairs)


def _covered(entries, nblocks):
    """How many times each unit of each entry is copied by a launch of
    ``nblocks`` blocks of K5's plan: the kernel's block -> entry search and
    each thread's units, over every block and thread."""
    firsts = np.array([e[6] for e in entries])
    hits = [np.zeros(e[4], dtype=np.int64) for e in entries]
    t = np.arange(256)
    for b in range(nblocks):
        k = int(np.searchsorted(firsts, b, side="right")) - 1
        units = entries[k][4]
        first = (b - firsts[k]) * dma_halo.BLOCK_UNITS + t
        for j in range(4):
            i = first + j * 256
            np.add.at(hits[k], i[i < units], 1)
    return hits


@pytest.mark.parametrize("sizes", [
    [(1, 8)], [(3000, 8), (1, 4), (5, 16), (2049, 4)],
    [(1024, 16), (1023, 16), (1025, 16)],
    [(7, 1)] * 5 + [(100, 12)] + [(1, 2)] * 3])
def test_k5_plan_covers_every_unit_once(sizes):
    """The plan's block ranges cover each unit of every entry exactly once
    (rows, row bytes; addresses 16-aligned)."""
    rows = [(1 << 20, 1 << 24, n, rb, rb, rb) for n, rb in sizes]
    entries, nblocks = dma_halo.plan(rows)
    assert [e[6] for e in entries] == sorted(e[6] for e in entries)
    for e, (n, rb) in zip(entries, sizes):
        assert e[4] == n * rb >> e[7] and rb % (1 << e[7]) == 0
    for h in _covered(entries, nblocks):
        assert h.size and bool((h == 1).all())


def test_k5_plan_unit_width_follows_alignment():
    """16-byte units only where both addresses, the row and both strides
    are multiples of 16; an odd address falls to single bytes."""
    def lg(src, dst, rb, ss, ds):
        return dma_halo.plan([(src, dst, 3, rb, ss, ds)])[0][0][7]
    assert lg(0, 0, 32, 64, 32) == 4
    assert lg(8, 0, 32, 64, 32) == 3
    assert lg(0, 0, 8, 256, 8) == 3
    assert lg(0, 4, 8, 256, 8) == 2
    assert lg(0, 0, 6, 12, 6) == 1
    assert lg(1, 0, 32, 64, 32) == 0
