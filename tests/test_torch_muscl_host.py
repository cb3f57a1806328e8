"""The hydro kernels' CUDA sources built for the host CPU, against their
plain versions.

``ramses_tpu_torch/csrc/fused_muscl.cu`` (K1) and ``csrc/oct_muscl.cu``
(K3 and K2) are compiled with ``g++`` into shared libraries: a small
header stands in for the CUDA runtime (the qualifiers are empty,
``__ldg`` is a load, ``__shared__`` arrays are static) and each
``<<<grid, block>>>`` launch becomes loops over blocks and threads, in
order.  Each block's threads run twice, so that what a thread reads after
``__syncthreads()`` (K2's per-oct sums) was written by every thread of its
block in the first round; the second round writes the same values again.
Built with ``-ffp-contract=off``, the device functions round as the plain
versions do, so the step, the coarse corrections and the MC-tracer face
mass fluxes (``want_flux``) are held against ``fused_step_ref``,
``tile_sweep_ref`` and ``oct_sweep_ref`` here on the CPU (within the table
of ``tests/test_pallas_kernel.py``: rtol 2e-5 / atol 2e-6), through the
wrappers' own ``call``; K1's ghost-padded entry is held bitwise to its
unpadded entry on a periodic box padded by the plain ``pad``.  K1's Courant min (warp reductions and an atomic)
is not emulated: the card's build is held against the plain versions,
that min included, by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
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
#include <stdint.h>
#include <string.h>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx, threadIdx, blockDim;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
#define __syncthreads()
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline int __reduce_min_sync(unsigned, int v) { return v; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int atomicMin(int* p, int v) { int o = *p; if (v < o) *p = v; return o; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
typedef void* cudaStream_t;
"""

LAUNCH = re.compile(r"(\w+<[^;<>]*>)<<<grid, block, 0, s>>>\(([^;]*)\);")


def _as_loop(m):
    return ("for (unsigned bz_ = 0; bz_ < grid.z; ++bz_) "
            "for (unsigned by_ = 0; by_ < grid.y; ++by_) "
            "for (unsigned bx_ = 0; bx_ < grid.x; ++bx_) "
            "for (int round_ = 0; round_ < 2; ++round_) "
            "for (unsigned ty_ = 0; ty_ < block.y; ++ty_) "
            "for (unsigned tx_ = 0; tx_ < block.x; ++tx_) "
            "{ blockIdx = dim3(bx_, by_, bz_); threadIdx = dim3(tx_, ty_, 0); "
            f"blockDim = block; {m.group(1)}({m.group(2)}); }}")


def _host_build(out, name):
    (out / "cuda_host.h").write_text(RUNTIME)
    common = (kernels.CSRC / "muscl_common.cuh").read_text()
    (out / "muscl_common.cuh").write_text(
        common.replace("#include <cuda_runtime.h>", '#include "cuda_host.h"'))
    src, n = LAUNCH.subn(_as_loop, (kernels.CSRC / f"{name}.cu").read_text())
    assert n > 0 and "<<<" not in src
    (out / f"{name}.cpp").write_text('#include "cuda_host.h"\n' + src)
    lib_path = out / f"lib{name}_host.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O1",
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
    td = (1 << (shift + 1)) + 4
    n = 40 if shift < 3 else 3
    shape = (td,) * 3 + (n,)
    u = _state(shape, cfg.gamma, 20 + shift)
    ok = (torch.from_numpy(np.random.default_rng(shift).random(shape) < 0.15)
          .to(torch.float32))
    dt = torch.tensor(2e-3, dtype=torch.float32)
    got = om.call(host_libs[1], u, ok, dt, cfg, 1.0 / 32, shift, want_flux)
    want = om.tile_sweep_ref(u, ok, dt, cfg, 1.0 / 32, shift, want_flux)
    assert len(got) == len(want) == 2 + want_flux
    _close(got, want)


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
