"""The hydro kernels' CUDA sources built for the host CPU, against their
plain versions.

``ramses_tpu_torch/csrc/fused_muscl.cu`` (K1) and ``csrc/oct_muscl.cu``
(K3 and K2) are compiled with ``g++`` into shared libraries: a small
header stands in for the CUDA runtime.  Each ``<<<grid, block, smem>>>``
launch runs every thread of a block as a real thread (``std::thread``);
the blocks run one after another, and the threads meet at a per-block
``std::barrier`` for ``__syncthreads()`` and at a per-warp one for
``__reduce_min_sync``.  ``__shared__`` arrays are static, so one buffer
serves the running block, and ``extern __shared__`` is a buffer of the
launch's dynamic size.  ``cp.async``'s copy, commit and wait are plain
copies (the header defines ``RAMSES_HOST_STUBS`` and the helpers), and
``cudaFuncSetAttribute`` and the occupancy queries are stubs.  So K1's
staged march (several barriers a plane), K2's per-oct sums through shared
memory and K1's Courant min (warp and block reductions, one atomic a
block) run as written.  Built with ``-ffp-contract=off``, the device
functions round as the plain versions do, so the step, the Courant dt, the
coarse corrections and the MC-tracer face mass fluxes (``want_flux``) are
held against ``fused_step_ref``, ``tile_sweep_ref`` and ``oct_sweep_ref``
here on the CPU (within the table of ``tests/test_pallas_kernel.py``:
rtol 2e-5 / atol 2e-6, rel 3e-3 for the dt), through the wrappers' own
``call``; K1's ghost-padded entry is held bitwise to its unpadded entry on
a periodic box padded by the plain ``pad``, whole and cut into x slabs.
Skips without ``g++``.
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
from ramses_tpu_torch.grid import boundary as bmod  # noqa: E402
from ramses_tpu_torch.hydro import fused_muscl as fm  # noqa: E402
from ramses_tpu_torch.hydro import oct_muscl as om  # noqa: E402
from ramses_tpu_torch.hydro.core import HydroStatic  # noqa: E402

RUNTIME = """
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>
#define RAMSES_HOST_STUBS 1
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local dim3 blockIdx, threadIdx, blockDim, gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#define __align__(n)
struct alignas(16) float4 { float x, y, z, w; };
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
// the running launch: its block barrier, warp barriers and dynamic buffer
struct HostLaunch {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<int> slot;
  std::vector<float> dyn;
  int nthread;
};
static HostLaunch* host_launch_;
inline int host_tid() {
  return (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
}
inline void __syncthreads() { host_launch_->block->arrive_and_wait(); }
inline int __reduce_min_sync(unsigned, int v) {
  HostLaunch& h = *host_launch_;
  const int t = host_tid(), w = t / 32;
  const int nw = min(32, h.nthread - 32 * w);
  h.slot[t] = v;
  h.warp[w]->arrive_and_wait();
  int m = v;
  for (int i = 0; i < nw; ++i) m = min(m, h.slot[32 * w + i]);
  h.warp[w]->arrive_and_wait();
  return m;
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline int atomicMin(int* p, int v) { int o = *p; if (v < o) *p = v; return o; }
inline void cp_async_f32(float* s, const float* g) { *s = *g; }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class F>
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 0; a->localSizeBytes = 0; return 0;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int, size_t) { *n = 1; return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// one SM: the emulation runs one block at a time
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1; return 0;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
typedef void* cudaStream_t;
// one launch: every thread of a block is a thread; blocks in order, each
// closed by the block barrier before the next one starts
template <class F>
inline void host_launch(dim3 grid, dim3 block, size_t smem, F body) {
  HostLaunch h;
  h.nthread = block.x * block.y * block.z;
  h.block.reset(new std::barrier<>(h.nthread));
  for (int w = 0; 32 * w < h.nthread; ++w)
    h.warp.emplace_back(new std::barrier<>(min(32, h.nthread - 32 * w)));
  h.slot.resize(h.nthread);
  h.dyn.resize(smem / sizeof(float) + 1);
  host_launch_ = &h;
  std::vector<std::thread> ts;
  for (int t = 0; t < h.nthread; ++t)
    ts.emplace_back([&, t] {
      blockDim = block;
      gridDim = grid;
      threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                       t / (block.x * block.y));
      for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
          for (unsigned bx = 0; bx < grid.x; ++bx) {
            blockIdx = dim3(bx, by, bz);
            body();
            h.block->arrive_and_wait();
          }
    });
  for (auto& th : ts) th.join();
  host_launch_ = nullptr;
}
"""

LAUNCH = re.compile(
    r"(\w+<[^;<>]*>)<<<grid, block, (\w+), s>>>\(([^;]*)\);")
DYN_SMEM = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];")


def _as_launch(m):
    return (f"host_launch(grid, block, {m.group(2)}, [&] "
            f"{{ {m.group(1)}({m.group(3)}); }});")


def _host_build(out, name):
    (out / "cuda_host.h").write_text(RUNTIME)
    common = (kernels.CSRC / "muscl_common.cuh").read_text()
    (out / "muscl_common.cuh").write_text(
        common.replace("#include <cuda_runtime.h>", '#include "cuda_host.h"'))
    src, n = LAUNCH.subn(_as_launch, (kernels.CSRC / f"{name}.cu").read_text())
    assert n > 0 and "<<<" not in src
    src = DYN_SMEM.sub(r"float* \1 = host_launch_->dyn.data();", src)
    assert "extern __shared__" not in src
    (out / f"{name}.cpp").write_text('#include "cuda_host.h"\n' + src)
    lib_path = out / f"lib{name}_host.so"
    subprocess.run([shutil.which("g++"), "-std=c++20", "-O1", "-pthread",
                    "-ffp-contract=off", "-shared", "-fPIC", "-w", "-o",
                    str(lib_path), str(out / f"{name}.cpp")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib_path))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("muscl_host")
    return (fm.bind(_host_build(out, "fused_muscl")),
            om.bind(_host_build(out, "oct_muscl")))


def _state(shape, gamma, seed):
    rng = np.random.default_rng(seed)
    r = 1.0 + 0.3 * rng.random(shape)
    v = 0.2 * rng.standard_normal((3,) + shape)
    p = 0.5 + 0.2 * rng.random(shape)
    e = p / (gamma - 1.0) + 0.5 * r * (v ** 2).sum(axis=0)
    return torch.tensor(np.stack([r, r * v[0], r * v[1], r * v[2], e]),
                        dtype=torch.float32)


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("riemann,slope,kinds,masked,want_flux", [
    ("llf", 1, ((0, 0), (0, 0), (0, 0)), False, False),
    ("hllc", 2, ((0, 0), (0, 0), (0, 0)), True, True),
    ("llf", 8, ((1, 1), (2, 1), (1, 2)), True, True),
    ("hllc", 1, ((2, 2), (0, 0), (1, 1)), False, True),
])
def test_k1_host_build_matches_plain_version(host_libs, riemann, slope,
                                             kinds, masked, want_flux):
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=slope)
    shape = (6, 7, 40)
    u = _state(shape, cfg.gamma, 3 + slope)
    ok = (torch.from_numpy(np.random.default_rng(9).random(shape) < 0.15)
          if masked else None)
    bc = bmod.BoundarySpec(faces=tuple(
        (bmod.FaceBC(kind=lo), bmod.FaceBC(kind=hi)) for lo, hi in kinds))
    dt = torch.tensor(2e-3, dtype=torch.float32)
    dx = 1.0 / 40
    un, crt, phi = fm.call(host_libs[0], u, None if ok is None
                           else ok.to(torch.float32), dt, cfg, dx, bc,
                           False, want_flux)
    assert crt is None and (phi is not None) == want_flux
    want = fm.fused_step_ref(u, dt, cfg, dx, bc, ok=ok, want_flux=want_flux)
    _close((un, phi) if want_flux else (un,),
           want if want_flux else (want,))


def _tiles(shift, n, gamma, seed, masked):
    """A random tile batch ``[5, n, td, td, td]`` and its mask ``[n, td,
    td, td]`` (15 % refined, or none)."""
    td = (1 << (shift + 1)) + 4
    u = _state((td,) * 3 + (n,), gamma, seed).movedim(-1, 1).contiguous()
    ok = torch.from_numpy(np.random.default_rng(seed).random((n,) + (td,) * 3)
                          < (0.15 if masked else 0.0)).to(torch.float32)
    return u, ok


@pytest.mark.parametrize("shift,riemann,slope,want_flux", [
    (0, "llf", 1, True),
    (1, "hllc", 2, False),
    (1, "llf", 8, True),
    (2, "hllc", 1, True),
    (3, "llf", 2, True),
])
def test_k3_host_build_matches_plain_version(host_libs, shift, riemann,
                                             slope, want_flux):
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=slope)
    u, ok = _tiles(shift, 40 if shift < 3 else 3, cfg.gamma, 20 + shift,
                   True)
    dt = torch.tensor(2e-3, dtype=torch.float32)
    got = om.call(host_libs[1], u, ok, dt, cfg, 1.0 / 32, shift, want_flux)
    want = om.tile_sweep_ref(u, ok, dt, cfg, 1.0 / 32, shift, want_flux)
    assert len(got) == len(want) == 2 + want_flux
    _close(got, want)


@pytest.mark.parametrize("shift,n,riemann,slope,masked,want_flux", [
    (0, 1, "llf", 1, True, True),
    (0, 33, "hllc", 2, False, False),
    (1, 3, "llf", 8, True, True),
    (1, 64, "hllc", 1, False, True),
    (2, 1, "hllc", 2, True, False),
    (2, 33, "llf", 1, True, True),
    (2, 64, "hllc", 8, True, True),
    (3, 1, "hllc", 8, True, False),
    (3, 3, "llf", 1, False, True),
])
def test_k3_host_build_on_ragged_batches(host_libs, shift, n, riemann, slope,
                                         masked, want_flux):
    """Batches of 1, 3, 33 and 64 tiles at every shift, masked and not,
    each solver and slope: the staged block (one tile's x chunk a block,
    the chunk chosen by the launch) within the table of the plain
    version."""
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=slope)
    u, ok = _tiles(shift, n, cfg.gamma, 50 + n + shift, masked)
    dt = torch.tensor(2e-3, dtype=torch.float32)
    got = om.call(host_libs[1], u, ok, dt, cfg, 1.0 / 32, shift, want_flux)
    want = om.tile_sweep_ref(u, ok, dt, cfg, 1.0 / 32, shift, want_flux)
    _close(got, want)


@pytest.mark.parametrize("shift,riemann,want_flux", [
    (0, "hllc", True), (1, "llf", True), (2, "hllc", True),
    (3, "llf", False)])
def test_k3_host_build_chunk_cuts_are_bitwise(host_libs, shift, riemann,
                                              want_flux):
    """Every x chunk that fits the shared memory (1 plane a block up to the
    whole tile) gives the same bits: halo planes and the x faces between
    chunks are recomputed by the same instructions."""
    c = 1 << (shift + 1)
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=2)
    u, ok = _tiles(shift, 5 if shift < 3 else 2, cfg.gamma, 70 + shift, True)
    dt = torch.tensor(2e-3, dtype=torch.float32)
    chunks = om.launch_info(shift, 1, riemann, lib=host_libs[1])["chunks"]
    assert chunks[:2] == [1, 2] and chunks[-1] <= c
    for cx in (1, 2, 4, 8, 16)[:shift + 2]:
        if cx not in chunks:         # past an H100 block's shared memory
            with pytest.raises(RuntimeError):
                om.launch_info(shift, 1, riemann, cx, host_libs[1])
    outs = [om.call(host_libs[1], u, ok, dt, cfg, 1.0 / 32, shift,
                    want_flux, chunk=cx) for cx in chunks]
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


def test_k3_host_build_reports_its_launch(host_libs):
    """The info entry answers through the wrapper's binding: the chunk the
    launch takes (on the host's one SM, the whole tile where it fits) and
    its shared memory (primitives and mask of the staged planes, 20
    floats of slopes and sources a box cell, the parked fluxes)."""
    info = om.launch_info(2, 64, "hllc", lib=host_libs[1])
    assert info["chunk"] == 8 and info["threads"] == 256
    assert info["smem_bytes"] == 4 * (6 * 12 * 144 + 20 * 10 * 100
                                      + 5 * (9 * 64 + 2 * 8 * 9 * 8))
    assert info["chunks"] == [1, 2, 4, 8]
    info3 = om.launch_info(3, 64, "llf", lib=host_libs[1])
    assert info3["chunk"] == 2 and info3["chunks"] == [1, 2]
    with pytest.raises(RuntimeError):
        om.launch_info(2, 64, "llf", chunk=3, lib=host_libs[1])


@pytest.mark.parametrize("riemann,slope,want_flux", [
    ("llf", 1, False), ("hllc", 2, True), ("llf", 8, True)])
def test_k2_host_build_matches_plain_version(host_libs, riemann, slope,
                                             want_flux):
    """K2's per-oct sums go through shared memory and a barrier: the
    emulation's two rounds per block exercise the same layout."""
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=slope)
    shape = (6, 6, 6, 45)              # one and a half blocks of 32 octs
    u = _state(shape, cfg.gamma, 30 + slope)
    ok = (torch.from_numpy(np.random.default_rng(slope).random(shape) < 0.15)
          .to(torch.float32))
    dt = torch.tensor(2e-3, dtype=torch.float32)
    got = om.call(host_libs[1], u, ok, dt, cfg, 1.0 / 32, None, want_flux)
    want = om.oct_sweep_ref(u, ok, dt, cfg, 1.0 / 32, want_flux)
    assert len(got) == len(want) == 2 + want_flux
    _close(got, want)


@pytest.mark.parametrize("riemann,slope,masked,want_flux,shape", [
    ("llf", 1, False, False, (6, 7, 40)),
    ("hllc", 2, True, True, (2, 9, 33)),
    ("llf", 8, True, True, (5, 2, 3)),
])
def test_k1_padded_entry_is_the_unpadded_one(host_libs, riemann, slope,
                                             masked, want_flux, shape):
    """The padded entry (a shard's contract: ghosts read as given) on a
    periodic box padded by the plain ``pad`` is bitwise the unpadded entry
    on the box, mask and face fluxes included, and within the table of its
    own plain version."""
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=slope)
    u = _state(shape, cfg.gamma, 40 + slope)
    bc = bmod.BoundarySpec.periodic(3)
    ok = (torch.from_numpy(np.random.default_rng(slope).random(shape)
                           < 0.2).to(torch.float32) if masked else None)
    dt = torch.tensor(2e-3, dtype=torch.float32)
    dx = 1.0 / 40
    un, _, phi = fm.call(host_libs[0], u, ok, dt, cfg, dx, bc, False,
                         want_flux)
    u_pad = bmod.pad(u, bc, cfg, fm.NG).contiguous()
    ok_pad = fm._pad_mask(ok, bc).contiguous() if masked else None
    unp, _, phip = fm.call(host_libs[0], u_pad, ok_pad, dt, cfg, dx, None,
                           False, want_flux)
    assert torch.equal(unp, un)
    assert (phip is None) == (not want_flux)
    if want_flux:
        assert torch.equal(phip, phi)
    want = fm.fused_step_padded_ref(u_pad, dt, cfg, dx, ok_pad=ok_pad,
                                    want_flux=want_flux)
    _close((unp, phip) if want_flux else (unp,),
           want if want_flux else (want,))


def _kinds_bc(kinds):
    return bmod.BoundarySpec(faces=tuple(
        (bmod.FaceBC(kind=lo), bmod.FaceBC(kind=hi)) for lo, hi in kinds))


@pytest.mark.parametrize("shape,kinds,riemann,slope,masked,want_flux", [
    ((19, 13, 37), ((0, 0), (0, 0), (0, 0)), "hllc", 2, True, True),
    ((19, 13, 37), ((1, 2), (2, 1), (1, 0)), "llf", 8, False, True),
    ((2, 16, 16), ((0, 0), (1, 1), (2, 2)), "llf", 1, True, False),
    ((2, 16, 16), ((1, 1), (0, 0), (0, 0)), "hllc", 8, False, True),
    ((16, 3, 33), ((2, 2), (0, 0), (1, 1)), "hllc", 1, True, True),
    ((16, 3, 33), ((0, 1), (1, 2), (2, 0)), "llf", 2, False, False),
    ((3, 2, 2), ((0, 0), (0, 0), (0, 0)), "llf", 2, True, True),
    ((33, 9, 3), ((1, 1), (2, 2), (0, 0)), "hllc", 2, True, False),
])
def test_k1_host_build_on_ragged_and_thin_boxes(host_libs, shape, kinds,
                                                riemann, slope, masked,
                                                want_flux):
    """Tiles (32 x 8) and x chunks (16 planes) that do not divide the box,
    axes of 2-3 cells whose periodic ring wraps onto the tile itself, every
    boundary kind; the Courant dt of the same launch within rel 3e-3."""
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=slope)
    u = _state(shape, cfg.gamma, sum(shape) + slope)
    ok = (torch.from_numpy(np.random.default_rng(sum(shape)).random(shape)
                           < 0.15) if masked else None)
    bc = _kinds_bc(kinds)
    dt = torch.tensor(2e-3, dtype=torch.float32)
    dx = 1.0 / 40
    un, crt, phi = fm.call(host_libs[0], u, None if ok is None
                           else ok.to(torch.float32), dt, cfg, dx, bc,
                           True, want_flux)
    want = fm.fused_step_ref(u, dt, cfg, dx, bc, ok=ok, courant=True,
                             want_flux=want_flux)
    _close((un, phi) if want_flux else (un,),
           (want[0], want[2]) if want_flux else (want[0],))
    dt_next = torch.clamp(crt, max=fm.dtmax(cfg, dx))
    assert float(dt_next) == pytest.approx(float(want[1]), rel=3e-3)


@pytest.mark.parametrize("shape,cuts,riemann,masked,want_flux", [
    ((20, 9, 35), ((0, 1, 3, 4, 20), (0, 2, 18, 19, 20)), "hllc", True,
     True),
    ((7, 10, 6), ((0, 2, 3, 7), (0, 1, 5, 7)), "llf", False, True),
    ((17, 5, 33), ((0, 16, 17), (0, 1, 17)), "llf", True, False),
])
def test_k1_padded_slabs_are_the_whole_box(host_libs, shape, cuts, riemann,
                                           masked, want_flux):
    """A periodic box cut into x slabs, each slab's ghosts taken from the
    box padded by the plain ``pad`` and swept by the padded entry: the
    slabs' updates, face fluxes and Courant min are bitwise the unpadded
    entry's on the whole box, at two cuts with slabs of 1 and 2 planes
    (a cell is a chunk's warm-up plane in one cut, a steady one in the
    other)."""
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=2)
    u = _state(shape, cfg.gamma, 60 + len(cuts[0]))
    bc = bmod.BoundarySpec.periodic(3)
    ok = (torch.from_numpy(np.random.default_rng(7).random(shape)
                           < 0.2).to(torch.float32) if masked else None)
    dt = torch.tensor(2e-3, dtype=torch.float32)
    dx = 1.0 / 40
    un, crt, phi = fm.call(host_libs[0], u, ok, dt, cfg, dx, bc, True,
                           want_flux)
    u_pad = bmod.pad(u, bc, cfg, fm.NG)
    ok_pad = fm._pad_mask(ok, bc) if masked else None
    for cut in cuts:
        parts, crts, phis = [], [], []
        for a, b in zip(cut[:-1], cut[1:]):
            okp = ok_pad[a:b + 4].contiguous() if masked else None
            us, cs, ps = fm.call(host_libs[0],
                                 u_pad[:, a:b + 4].contiguous(), okp, dt,
                                 cfg, dx, None, True, want_flux)
            parts.append(us)
            crts.append(cs)
            phis.append(ps)
        assert torch.equal(torch.cat(parts, 1), un)
        assert torch.equal(torch.stack(crts).min(), crt)
        if want_flux:
            assert torch.equal(torch.cat(phis, 2), phi)


def test_k1_host_build_reports_its_shared_memory(host_libs):
    """The info entry answers through the wrapper's binding: the staged
    tiles' dynamic shared memory (2 raw and 4 primitive planes of 36 x 12
    cells x 6 floats, and the y and z face states)."""
    info = fm.launch_info("hllc", host_libs[0])
    assert info["smem_bytes"] == 4 * (6 * 6 * 36 * 12 + 10 * 9 * 32
                                      + 10 * 8 * 33)
    assert info["blocks_per_sm"] >= 1
