"""The RT kernels' CUDA sources built for the host CPU, against their plain
versions.

``ramses_tpu_torch/csrc/rt_m1.cu`` (K8: the dense entry on 1D/2D/3D boxes,
periodic and outflow, with sources and beams, on boxes ragged against its
staged tiles and with fewer than three x planes, its chunks of x planes
bitwise alike; the block entry on gathered oct stencils, the last block's
octs ragged) and ``csrc/rt_chem.cu`` (K9: gray and 3-ion, with
and without the UV background, heating on and off) are compiled with
``g++`` through the threaded stand-in of the CUDA runtime of
``test_torch_muscl_host.py`` (each block's threads are ``std::thread``s,
blocks in order) and called through the wrappers' own ``call_*``.  Built
with ``-ffp-contract=off`` (the card's build has ``-fmad=false``).

Tolerances: K8 uses +, -, *, / and sqrt only, all correctly rounded, so it
is held to 1e-13 × M, M the field's max over the cell's 3^d stencil (it
agrees bit for bit here); K9 calls the host libm's pow and exp where torch
calls its own vectorised ones, which differ in the last bit, and 5
fixed-point iterations that have not converged amplify such a bit (up to
~2e-11 relative in the He fractions of ~5e5 K cells), so it is held to
1e-12 × (|value| + the field's max).  On the card both call the same
libdevice functions and ``tests/test_torch_gpu.py`` holds K9 to rel
1e-12.  Skips without ``g++``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu_torch import kernels  # noqa: E402
from ramses_tpu_torch.rt import chem, m1, spectra  # noqa: E402

K8_REL = 1e-13
K9_REL = 1e-12


def _build(out, name):
    from tests.test_torch_muscl_host import (DYN_SMEM, DYN_SMEM_HOST, LAUNCH,
                                             RUNTIME, _as_launch)
    (out / "cuda_host.h").write_text(RUNTIME)
    src = (kernels.CSRC / f"{name}.cu").read_text().replace(
        "#include <cuda_runtime.h>", '#include "cuda_host.h"')
    src, n = LAUNCH.subn(_as_launch, src)
    assert n > 0 and "<<<" not in src
    src = DYN_SMEM.sub(DYN_SMEM_HOST, src)
    assert "extern __shared__" not in src
    (out / f"{name}.cpp").write_text(src)
    lib = out / f"lib{name}_host.so"
    subprocess.run([shutil.which("g++"), "-std=c++20", "-O1", "-pthread",
                    "-ffp-contract=off", "-shared", "-fPIC", "-w", "-o",
                    str(lib), str(out / f"{name}.cpp")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("rt_host")
    return m1.bind(_build(out, "rt_m1")), chem.bind(_build(out, "rt_chem"))


def stencil_scale(x, nd, periodic=True):
    """|x| maxed over each cell's 3^nd neighbourhood along the last nd
    axes (wrapping, or replicating the edge)."""
    a = x.abs()
    for ax in range(a.dim() - nd, a.dim()):
        n = a.shape[ax]
        lo = a.roll(1, ax) if periodic else torch.cat(
            [a.narrow(ax, 0, 1), a.narrow(ax, 0, n - 1)], ax)
        hi = a.roll(-1, ax) if periodic else torch.cat(
            [a.narrow(ax, 1, n - 1), a.narrow(ax, n - 1, 1)], ax)
        a = torch.maximum(a, torch.maximum(lo, hi))
    return a


def rt_state(shape, ng, c_red, seed, beams=False, nd=None):
    """Random (U [ng, 1+nd, *sp], src, src_F) in f64: N over 25 decades
    (vacuum to dense), |F| up to 1.2 c N (so the limiter acts), sources
    on a few cells; ``nd`` flux components (default: one a dim)."""
    rng = np.random.default_rng(seed)
    nd = len(shape) if nd is None else nd
    N = 10.0 ** rng.uniform(-30, -5, (ng,) + shape)
    F = rng.standard_normal((ng, nd) + shape)
    F *= 1.2 * c_red * N[:, None] * rng.random((ng, 1) + shape) / \
        np.sqrt((F ** 2).sum(axis=1, keepdims=True))
    F[:, :, rng.random(shape) < 0.2] = 0.0
    src = np.where(rng.random((ng,) + shape) < 0.1,
                   10.0 ** rng.uniform(-20, -15, (ng,) + shape), 0.0)
    srcF = (c_red * src[:, None] * rng.standard_normal((ng, nd) + shape)
            if beams else None)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return (torch.from_numpy(np.concatenate([N[:, None], F], axis=1)),
            t(src), t(srcF))


def dense_close(got, want, nd, periodic):
    scale = stencil_scale(want, nd, periodic)
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= K8_REL * scale).all()), \
        float(((got - want).abs() / scale).nan_to_num(0.0).max())


# the last ten are ragged against K8's staged tiles (32 along the fastest
# axis x 8 rows with a one-cell ring in 3D and 2D, segments of 256 in 1D)
# or have fewer than three x planes (3D blocks march chunks of x planes)
DENSE = [((33,), 1, True, False), ((33,), 3, False, True),
         ((9, 14), 1, False, False), ((9, 14), 3, True, True),
         ((5, 7, 6), 1, True, True), ((6, 5, 9), 3, False, False),
         ((1, 4, 3), 2, True, False),
         ((300,), 1, True, True), ((513,), 3, False, False),
         ((19, 45), 3, True, False), ((33, 8), 1, False, True),
         ((1, 9, 33), 1, True, True), ((2, 9, 33), 3, False, False),
         ((2, 17, 65), 1, True, False), ((7, 37, 41), 3, True, True),
         ((7, 37, 41), 1, False, True), ((4, 2, 3), 2, True, False)]


@pytest.mark.parametrize("shape,ng,periodic,beams", DENSE)
def test_k8_dense_host_build_matches_plain_version(host, shape, ng,
                                                   periodic, beams):
    lib = host[0]
    nd, c_red = len(shape), 3e7
    U, src, srcF = rt_state(shape, ng, c_red, 7 * ng + nd, beams)
    dt, dx = 0.8 * 3e19 / 3.0 / c_red, 3e19
    want = m1.transport_ref(U, dt, dx, c_red, nd, periodic, src, srcF)
    got = torch.empty_like(U)
    m1.call_dense(lib, U, got, dt, dx, c_red, nd, periodic, src, srcF)
    dense_close(got, want, nd, periodic)


# each box's 4 tiles × 2 groups, and the SMs of the device the host build
# stands for (one block resident an SM): the launch cuts the x planes into
# SMs / 8 chunks, 1 to all of them (x chunks of 7, 4, 3, 2, 1 planes and
# 5, 3, 2, 2, 1)
@pytest.mark.parametrize("shape,periodic,sms", [
    ((7, 9, 33), True, (1, 16, 24, 32, 56)),
    ((5, 10, 40), False, (8, 16, 24, 32, 40))])
def test_k8_dense_host_build_chunk_cuts_are_bitwise(host, shape, periodic,
                                                    sms):
    """Every chunk of x planes a 3D block marches, as the card's SM count
    sets it (1 plane up to the whole box), gives the same bits: the planes
    at a chunk's ends are staged from the neighbouring chunks' cells and
    their records recomputed by the same instructions."""
    lib = host[0]
    lib.host_device.argtypes = [ctypes.c_int, ctypes.c_int]
    c_red = 3e7
    U, src, srcF = rt_state(shape, 2, c_red, 5, True)
    dt, dx = 0.8 * 3e19 / 3.0 / c_red, 3e19
    outs = []
    try:
        for n in sms:
            # a device a count: the launch asks a device's SMs once
            lib.host_device(n, n)
            got = torch.empty_like(U)
            m1.call_dense(lib, U, got, dt, dx, c_red, 3, periodic, src,
                          srcF)
            outs.append(got)
    finally:
        lib.host_device(0, 1)
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    want = m1.transport_ref(U, dt, dx, c_red, 3, periodic, src, srcF)
    dense_close(outs[0], want, 3, periodic)


def _blocks(nd, ng, noct, seed, c_red):
    U, _, _ = rt_state((6,) * nd + (noct,), ng, c_red, seed, nd=nd)
    # [ng, 1+nd, 6.., noct]: the gathered layout [ng*(1+nd), 6^nd, noct]
    return U.reshape((ng * (1 + nd),) + U.shape[2:]).contiguous()


# a block takes 256/2^nd octs (32 in 3D, 64 in 2D, 128 in 1D): fewer, and
# counts that leave the last block ragged
BLOCKS = [(1, 1, 7), (2, 3, 5), (3, 1, 11), (3, 2, 3), (3, 1, 45),
          (3, 3, 33), (2, 2, 130), (1, 3, 300)]


@pytest.mark.parametrize("nd,ng,noct", BLOCKS)
def test_k8_block_host_build_matches_plain_version(host, nd, ng, noct):
    lib = host[0]
    c_red = 3e7
    blk = _blocks(nd, ng, noct, 5 * nd + ng, c_red)
    ncp = noct * 2 ** nd + 5
    rad = torch.from_numpy(np.random.default_rng(1).random(
        (ncp, ng * (1 + nd))))
    dt, dx = 0.8 * 3e19 / 3.0 / c_red, 3e19
    want = m1.block_update_ref(rad, blk, dt, dx, c_red, nd, ng)
    got = rad.clone()
    m1.call_block(lib, blk, got, dt, dx, c_red, nd, ng)
    # only the leading noct*2^nd rows are written
    assert torch.equal(got[noct * 2 ** nd:], rad[noct * 2 ** nd:])
    scale = want.abs().amax(dim=0, keepdim=True)
    assert bool(((got - want).abs() <= K8_REL * scale).all())


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_k8_block_keeps_no_wrapped_value(host, nd):
    # the plain version rolls inside the 6-wide block: the kept interior
    # cells [2:4]^d must not depend on the outer ring (indices 0 and 5),
    # which only a wrapped roll could bring in
    lib = host[0]
    c_red, ng, noct = 3e7, 2, 4
    blk = _blocks(nd, ng, noct, 40 + nd, c_red)
    ring = torch.zeros((6,) * nd, dtype=torch.bool)
    for ax in range(nd):
        idx = [slice(None)] * nd
        for edge in (0, 5):
            idx[ax] = edge
            ring[tuple(idx)] = True
    noisy = blk.clone()
    noisy[:, ring] = noisy[:, ring] * 7.0 + 1e-12
    rad = torch.zeros((noct * 2 ** nd, ng * (1 + nd)), dtype=torch.float64)
    dt, dx = 1e11, 3e19
    a = m1.block_update_ref(rad, blk, dt, dx, c_red, nd, ng)
    b = m1.block_update_ref(rad, noisy, dt, dx, c_red, nd, ng)
    assert torch.equal(a, b)
    got = rad.clone()
    m1.call_block(lib, noisy, got, dt, dx, c_red, nd, ng)
    assert torch.equal(got, b)


def chem_cells(n, seed, ng=1):
    """Random cells: N from 1e-30 to 1e-5, T from 10 to 1e6 K, nH from
    1e-4 to 1e2, every ionized fraction from 1e-12 to 1."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    N = t(10.0 ** rng.uniform(-30, -5, (ng, n)))
    x = t(10.0 ** rng.uniform(-12, 0, n))
    xhe2 = t(10.0 ** rng.uniform(-12, -0.31, n))
    xhe3 = t(10.0 ** rng.uniform(-12, -0.31, n))
    T = t(10.0 ** rng.uniform(1, 6, n))
    nH = t(10.0 ** rng.uniform(-4, 2, n))
    return N, x, xhe2, xhe3, T, nH


def _uv():
    from ramses_tpu_torch.hydro.cooling import uv_rates
    g, h = uv_rates(1.0, 1.0)
    return ((g["HI"], g["HeI"], g["HeII"]), (h["HI"], h["HeI"], h["HeII"]))


def rel_close(got, want):
    tol = K9_REL * (want.abs() + want.abs().max())
    assert bool(((got - want).abs() <= tol).all()), \
        float(((got - want).abs() / want.abs()).max())


@pytest.mark.parametrize("uv,heating,otsa", [(False, True, True),
                                             (True, True, True),
                                             (True, False, False)])
def test_k9_gray_host_build_matches_plain_version(host, uv, heating, otsa):
    lib = host[1]
    n = 3000
    N, x, _, _, T, nH = chem_cells(n, 11)
    # the photon densities as a strided column of AMR-like rows
    rows = torch.zeros((n, 4), dtype=torch.float64)
    rows[:, 0] = N[0]
    uvv = _uv() if uv else None
    dt, c_red = 3e10, 3e7
    want = chem.chem_step_ref(N[0], x, T, nH, dt, c_red, chem.GroupSpec(),
                              otsa, heating=heating, uv=uvv)
    x_out, T_out = torch.empty_like(x), torch.empty_like(T)
    chem.call_gray(lib, rows[:, 0], x, T, nH, x_out, T_out, dt, c_red,
                   chem.GroupSpec(), otsa, heating, uvv)
    for g, w in zip((rows[:, 0], x_out, T_out), want):
        rel_close(g, w)
    assert torch.equal(rows[:, 1:], torch.zeros((n, 3), dtype=torch.float64))


@pytest.mark.parametrize("ng,uv,heating", [(1, False, True), (3, True, True),
                                           (2, False, False),
                                           (8, True, True)])
def test_k9_3ion_host_build_matches_plain_version(host, ng, uv, heating):
    lib = host[1]
    n = 2000
    N, x, xhe2, xhe3, T, nH = chem_cells(n, 13 + ng, ng)
    nHe = nH * 0.08
    bounds = list(np.geomspace(13.6, 1e3, ng + 1))
    groups = spectra.blackbody_groups(1e5, bounds)
    uvv = _uv() if uv else None
    dt, c_red = 1e11, 3e7
    # AMR-like strides: N rows of ng*(1+3) columns, He in [n, 2] rows
    rows = torch.zeros((n, ng * 4), dtype=torch.float64)
    rows[:, ::4] = N.t()
    he = torch.stack([xhe2, xhe3], dim=1)
    want = chem.chem_step_3ion_ref(list(N), (x, xhe2, xhe3), T, nH, nHe, dt,
                                   c_red, groups, True, heating=heating,
                                   uv=uvv)
    outs = [torch.empty_like(T) for _ in range(4)]
    view = rows.as_strided((ng, n), (4, ng * 4))
    chem.call_3ion(lib, view, x, he[:, 0], he[:, 1], T, nH, nHe, *outs, dt,
                   c_red, groups, True, heating, uvv)
    for g in range(ng):
        rel_close(rows[:, 4 * g], want[0][g])
    for g, w in zip(outs, list(want[1]) + [want[2]]):
        rel_close(g, w)
