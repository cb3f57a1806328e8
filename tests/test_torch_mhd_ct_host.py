"""The CT kernel's CUDA source built for the host CPU, against its plain
version.

``ramses_tpu_torch/csrc/mhd_ct.cu`` (K4) is compiled with ``g++`` into a
shared library: a small header stands in for the CUDA runtime (the
qualifiers are empty, ``__ldg`` is a load) and each ``<<<grid, BLOCK>>>``
launch becomes a loop over blocks and threads, in order.  Built with
``-ffp-contract=off``, the device functions round as the plain version
does, so every stage, solver, corner solver, passive and slope type of
the kernel is held against ``ct_slab.ct_step_slab_ref`` here on the CPU
(within the table of ``tests/test_pallas_kernel.py``: rtol 2e-5 / atol
2e-6), through the wrapper's own ``ct_slab.call``.  The card's build is
held against the same plain version by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``.  Skips without ``g++``.
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
from ramses_tpu_torch.mhd import ct_slab  # noqa: E402
from ramses_tpu_torch.mhd.core import MhdStatic  # noqa: E402

RUNTIME = """
#pragma once
#include <math.h>
#include <stdint.h>
struct HostIdx { unsigned x, y, z; };
static HostIdx blockIdx, threadIdx;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
template <class T> inline T __ldg(const T* p) { return *p; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
typedef void* cudaStream_t;
struct dim3 { unsigned x; dim3(unsigned a) : x(a) {} };
"""

LAUNCH = re.compile(r"(\w+<[^;<>]*>)<<<grid, BLOCK, 0, s>>>\(([^;]*)\);")


def _as_loop(m):
    return ("for (unsigned b_ = 0; b_ < grid.x; ++b_) "
            "for (unsigned t_ = 0; t_ < BLOCK; ++t_) "
            f"{{ blockIdx.x = b_; threadIdx.x = t_; {m.group(1)}"
            f"({m.group(2)}); }}")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("mhd_ct_host")
    (out / "cuda_host.h").write_text(RUNTIME)
    common = (kernels.CSRC / "muscl_common.cuh").read_text()
    (out / "muscl_common.cuh").write_text(
        common.replace("#include <cuda_runtime.h>", '#include "cuda_host.h"'))
    src, n = LAUNCH.subn(_as_loop, (kernels.CSRC / "mhd_ct.cu").read_text())
    assert n > 0 and "<<<" not in src
    (out / "mhd_ct.cpp").write_text('#include "cuda_host.h"\n' + src)
    lib_path = out / "libmhd_ct_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-w", "-o", str(lib_path),
                    str(out / "mhd_ct.cpp")], check=True, capture_output=True)
    return ct_slab.bind(ctypes.CDLL(str(lib_path)))


def _box(sp, seed, masked, npassive, bulk=(0.0, 0.0, 0.0)):
    """A random padded f32 box: (up, bfp_ext, okf, ovm, ovv, okp, ovr) with
    the mask and override both as the wrapper hands them to the C entry
    and as the plain version takes them; ``bulk`` is added to the
    velocity (3 is past the fast speed, ~1.1: the solvers' supersonic
    branches)."""
    rng = np.random.default_rng(seed)
    nd = len(sp)
    spp = tuple(n + 4 for n in sp)
    spe = tuple(n + 6 for n in sp)
    r = 1.0 + 0.3 * rng.random(spp)
    v = 0.2 * rng.standard_normal((3,) + spp)
    v += np.asarray(bulk).reshape((3,) + (1,) * nd)
    p = 0.5 + 0.2 * rng.random(spp)
    e = p / (2.0 / 3.0) + 0.5 * r * (v ** 2).sum(axis=0) + 0.2
    rows = [r, r * v[0], r * v[1], r * v[2], e, *np.zeros((3,) + spp)]
    rows += [r * rng.random(spp) for _ in range(npassive)]
    up = torch.tensor(np.stack(rows), dtype=torch.float32)
    bfp = torch.tensor(0.3 + 0.2 * rng.standard_normal((3,) + spe),
                       dtype=torch.float32)
    pairs = [(a, b) for a in range(nd) for b in range(a + 1, nd)]
    okf = ovm = ovv = okp = ovr = None
    if masked:
        okp = torch.from_numpy(rng.random(spp) < 0.15)
        okf = okp.to(torch.float32)
        if pairs:
            ovr = {q: (torch.from_numpy(rng.random(spp) < 0.2),
                       torch.tensor(0.05 * rng.standard_normal(spp),
                                    dtype=torch.float32)) for q in pairs}
            ovm = torch.stack([ovr[q][0].to(torch.float32) for q in pairs])
            ovv = torch.stack([ovr[q][1] for q in pairs])
    return up, bfp, okf, ovm, ovv, okp, ovr


SUPERSONIC = [(3.0, 0.0, 0.0), (-3.0, 0.0, 0.0), (0.0, 3.0, 0.0),
              (0.0, -3.0, 0.0)]


@pytest.mark.parametrize("sp,riemann,corner,slope,masked,npassive", [
    ((32,), "llf", "average", 1, False, 0),
    ((32,), "hll", "average", 8, True, 0),
    ((32,), "hlld", "average", 2, False, 1),
    ((32,), "roe", "average", 7, True, 0),
    ((32,), "upwind", "average", 0, False, 0),
    ((12, 10), "hlld", "average", 1, True, 0),
    ((12, 10), "hlld", "llf", 2, False, 0),
    ((12, 10), "roe", "roe", 1, True, 0),
    ((12, 10), "llf", "upwind", 8, False, 0),
    ((12, 10), "hll", "hll", 0, True, 0),
    ((12, 10), "upwind", "hlla", 7, False, 0),
    ((12, 10), "hlld", "hlld", 1, True, 2),
    ((6, 5, 4), "roe", "roe", 2, True, 0),
    ((6, 5, 4), "hlld", "hlld", 8, False, 1),
    ((6, 5, 4), "hll", "average", 1, True, 0),
])
def test_host_build_matches_plain_version(host_lib, sp, riemann, corner,
                                          slope, masked, npassive):
    nd = len(sp)
    cfg = MhdStatic(ndim=nd, riemann=riemann, riemann2d=corner,
                    slope_type=slope, npassive=npassive)
    assert ct_slab.supports(cfg, sp, torch.float32)
    up, bfp, okf, ovm, ovv, okp, ovr = _box(sp, sum(sp) + slope, masked,
                                            npassive)
    dt = torch.tensor(2e-3, dtype=torch.float32)
    dx = (1.0 / sp[0],) * nd
    got = ct_slab.call(host_lib, up, bfp, dt, dx, cfg, okf, ovm, ovv)
    want = ct_slab.ct_step_slab_ref(up, bfp, dt, dx, cfg, okp=okp, ovr=ovr)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("riemann,corner", [("hlld", "hlld"),
                                            ("roe", "hll"),
                                            ("hll", "hlla")])
@pytest.mark.parametrize("bulk", SUPERSONIC)
def test_host_build_matches_plain_version_supersonic(host_lib, riemann,
                                                     corner, bulk):
    """A bulk flow past the fast speed along x or y, either sign: the 1D
    solvers' and the corner solvers' supersonic regions."""
    cfg = MhdStatic(ndim=2, riemann=riemann, riemann2d=corner)
    sp = (12, 10)
    up, bfp, okf, ovm, ovv, okp, ovr = _box(sp, 7, False, 0, bulk)
    dt = torch.tensor(5e-4, dtype=torch.float32)
    dx = (1.0 / sp[0],) * 2
    got = ct_slab.call(host_lib, up, bfp, dt, dx, cfg)
    want = ct_slab.ct_step_slab_ref(up, bfp, dt, dx, cfg)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)
