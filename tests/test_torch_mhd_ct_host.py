"""The CT kernel's CUDA source built for the host CPU, against its plain
version.

``ramses_tpu_torch/csrc/mhd_ct.cu`` (K4, one fused launch a step: each
block marches a tile of columns through shared-memory rings, three
barriers a row) is compiled with ``g++`` into a shared library by the
threaded harness of ``tests/test_torch_muscl_host.py`` (``_host_build``):
each block's threads run as ``std::thread``s meeting at a
``std::barrier`` for ``__syncthreads()``, blocks in order, and ``extern
__shared__`` is a buffer of the launch's dynamic size.  Built with
``-ffp-contract=off``, the device functions round as the plain version
does, so every stage, solver, corner solver, passive and slope type of the
kernel is held against ``ct_slab.ct_step_slab_ref`` here on the CPU
(within the table of ``tests/test_pallas_kernel.py``: rtol 2e-5 / atol
2e-6), through the wrapper's own ``ct_slab.call``: on small boxes, on
boxes ragged against the tiles and the row chunks on every axis and
crossing at least two of them, and on supersonic flows.  Two bitwise
properties of the tiling: the step commutes with a periodic roll by a
shift that is no multiple of a tile, and every cell's centred B is the
mean of its two new faces, across tile edges.  The card's build is held
against the same plain version by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``.  Skips without ``g++``.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu_torch.grid import boundary as bmod  # noqa: E402
from ramses_tpu_torch.mhd import ct_slab  # noqa: E402
from ramses_tpu_torch.mhd import uniform as mu  # noqa: E402
from ramses_tpu_torch.mhd.core import MhdStatic  # noqa: E402
from tests.test_torch_muscl_host import _host_build  # noqa: E402


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return ct_slab.bind(_host_build(tmp_path_factory.mktemp("mhd_ct_host"),
                                    "mhd_ct"))


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


# Ragged against the tiles (2D: 126 columns of axis 1; 3D: 12 x 16
# columns of axes 1 x 2; 1D: 126 cells) and the row chunks of axis 0 on
# every axis, and crossing at least two of them.
RAGGED = [((300,), "hlld", "average", 1, True, 2),
          ((70, 131), "hlld", "llf", 1, True, 0),
          ((70, 131), "roe", "hlld", 2, True, 2),
          ((34, 13, 20), "hlld", "hlld", 8, True, 0),
          ((34, 13, 20), "roe", "roe", 2, True, 1)]


@pytest.mark.parametrize("sp,riemann,corner,slope,masked,npassive", RAGGED)
def test_host_build_on_ragged_multi_tile_boxes(host_lib, sp, riemann,
                                               corner, slope, masked,
                                               npassive):
    """Halo items computed by two blocks, warm-up rows of one chunk that
    are steady rows of the one before, tiles cut short by the box; with
    the refined mask, the EMF override and passives."""
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


@pytest.mark.parametrize("sp,riemann,corner,chunks", [
    ((20, 131), "hlld", "llf", (1, 3, 32)),
    ((20, 13, 20), "roe", "hlld", (2, 7)),
])
def test_host_build_row_chunks_are_bitwise(host_lib, sp, riemann, corner,
                                           chunks):
    """The rows a block marches (``chunk``) cut axis 0 elsewhere, so a row
    is a warm-up row in one cut and a steady row in another: the step is
    bitwise the same for every cut, mask, override and passives included."""
    nd = len(sp)
    cfg = MhdStatic(ndim=nd, riemann=riemann, riemann2d=corner, npassive=1)
    up, bfp, okf, ovm, ovv, _, _ = _box(sp, 23, True, 1)
    dt = torch.tensor(2e-3, dtype=torch.float32)
    dx = (1.0 / sp[0],) * nd
    ref = ct_slab.call(host_lib, up, bfp, dt, dx, cfg, okf, ovm, ovv)
    for chunk in chunks:
        got = ct_slab.call(host_lib, up, bfp, dt, dx, cfg, okf, ovm, ovv,
                           chunk=chunk)
        for g, w in zip(got, ref):
            assert torch.equal(g, w)


def _periodic(sp, seed, npassive, masked):
    """A random interior state of a periodic box: (u [8 + npassive, *sp],
    bf [3, *sp], ok, {pair: (mask, values)} or None, None)."""
    rng = np.random.default_rng(seed)
    nd = len(sp)
    r = 1.0 + 0.3 * rng.random(sp)
    v = 0.2 * rng.standard_normal((3,) + sp)
    p = 0.5 + 0.2 * rng.random(sp)
    e = p / (2.0 / 3.0) + 0.5 * r * (v ** 2).sum(axis=0) + 0.2
    rows = [r, r * v[0], r * v[1], r * v[2], e, *np.zeros((3,) + sp)]
    rows += [r * rng.random(sp) for _ in range(npassive)]
    u = torch.tensor(np.stack(rows), dtype=torch.float32)
    bf = torch.tensor(0.3 + 0.2 * rng.standard_normal((3,) + sp),
                      dtype=torch.float32)
    ok = ovr = None
    if masked:
        ok = torch.from_numpy(rng.random(sp) < 0.15)
        ovr = {(a, b): (torch.from_numpy(rng.random(sp) < 0.2),
                        torch.tensor(0.05 * rng.standard_normal(sp),
                                     dtype=torch.float32))
               for a in range(nd) for b in range(a + 1, nd)} or None
    return u, bf, ok, ovr


def _step_periodic(lib, cfg, u, bf, ok, ovr, dt, dx):
    """K4's host build on the periodic box padded by the plain ``_pad``."""
    nd = cfg.ndim
    kinds = ((bmod.PERIODIC, bmod.PERIODIC),) * nd

    def pad1(x):
        return mu._pad(x[None].to(torch.float32), nd, kinds)[0].contiguous()
    up = mu._pad(u, nd, kinds).contiguous()
    bfp = mu._pad(bf, nd, kinds, mu.NGHOST + 1).contiguous()
    okf = pad1(ok) if ok is not None else None
    ovm = ovv = None
    if ovr is not None:
        pairs = sorted(ovr)
        ovm = torch.stack([pad1(ovr[q][0]) for q in pairs])
        ovv = torch.stack([pad1(ovr[q][1]) for q in pairs])
    return ct_slab.call(lib, up, bfp, dt, dx, cfg, okf, ovm, ovv)


@pytest.mark.parametrize("sp,shift,riemann,corner,masked,npassive", [
    ((300,), (77,), "roe", "average", True, 1),
    ((70, 131), (13, 57), "hlld", "llf", False, 0),
    ((40, 130), (21, 101), "hll", "hlld", True, 2),
    ((34, 13, 20), (5, 3, 7), "hlld", "hlld", True, 0),
    ((20, 14, 18), (11, 5, 9), "llf", "average", False, 1),
])
def test_host_build_is_roll_invariant(host_lib, sp, shift, riemann, corner,
                                      masked, npassive):
    """On a periodic box, the step of the state rolled by a shift that is
    no multiple of a tile (nor of a row chunk) is the rolled step of the
    state, bitwise: no value depends on where the tiles cut the box."""
    nd = len(sp)
    cfg = MhdStatic(ndim=nd, riemann=riemann, riemann2d=corner,
                    npassive=npassive)
    u, bf, ok, ovr = _periodic(sp, 50 + sum(sp), npassive, masked)
    dt = torch.tensor(2e-3, dtype=torch.float32)
    dx = (1.0 / sp[0],) * nd
    dims = tuple(range(1, nd + 1))
    ref = _step_periodic(host_lib, cfg, u, bf, ok, ovr, dt, dx)

    def roll(x, lead=1):
        return torch.roll(x, shift, dims=tuple(d - 1 + lead for d in dims))
    ovr_r = (None if ovr is None else
             {q: (roll(m, 0), roll(v, 0)) for q, (m, v) in ovr.items()})
    got = _step_periodic(host_lib, cfg, roll(u), roll(bf),
                         None if ok is None else roll(ok, 0), ovr_r, dt, dx)
    for g, w in zip(got, ref):
        assert torch.equal(g, roll(w))


@pytest.mark.parametrize("sp,riemann,corner,masked", [
    ((70, 131), "hlld", "hlld", True),
    ((40, 130), "roe", "roe", False),
    ((34, 13, 20), "hlld", "llf", True),
    ((34, 13, 20), "upwind", "hlla", False),
])
def test_host_build_centred_b_is_its_faces_mean(host_lib, sp, riemann,
                                                corner, masked):
    """Every interior cell's centred B is 0.5 (low face + high face) of
    the new faces in ``bfn``, bitwise, where the high face is its upper
    neighbour's low face: the two cells may sit in different tiles or
    chunks, so the face's EMFs must have the same bits in both blocks."""
    nd = len(sp)
    cfg = MhdStatic(ndim=nd, riemann=riemann, riemann2d=corner)
    up, bfp, okf, ovm, ovv, _, _ = _box(sp, 7 + sum(sp), masked, 0)
    dt = torch.tensor(2e-3, dtype=torch.float32)
    un, bfn = ct_slab.call(host_lib, up, bfp, dt, (1.0 / sp[0],) * nd, cfg,
                           okf, ovm, ovv)
    for c in range(nd):
        n = sp[c] - 1
        mean = 0.5 * (bfn[c].narrow(c, 0, n) + bfn[c].narrow(c, 1, n))
        assert torch.equal(un[5 + c].narrow(c, 0, n), mean)


def test_host_build_reports_its_launch(host_lib):
    """The info entry answers through the wrapper's binding: one block of
    128 (1D, 2D) or 384 (3D) threads and the rings' dynamic shared memory
    (3 primitive rows, 2 of predicted cells, the marching flux components
    the EMFs read, a row of column fluxes and 2 of their component 5, 2
    rows of passive fluxes a direction, 2 of EMFs a pair), sized from the
    passive count."""
    def smem(nd, nv, pg, qg):
        npair = 3 if nd == 3 else nd - 1
        nca = 2 if nd == 3 else 1
        pf = (nd + 1) * nv + 8 + nd
        return 4 * (3 * nv * pg + qg * (2 * pf + (nca if nd > 1 else 0)
                                        + nca * 10 + 2 * nd * (nv - 8)
                                        + 2 * npair))
    for nd, rs, r2, npas, nt, pg, qg in ((1, "roe", "average", 0, 128, 130,
                                          128),
                                         (2, "hlld", "llf", 0, 128, 130, 128),
                                         (2, "hlld", "hlld", 4, 128, 130, 128),
                                         (3, "hlld", "llf", 1, 384, 320,
                                          252)):
        cfg = MhdStatic(ndim=nd, riemann=rs, riemann2d=r2, npassive=npas)
        info = ct_slab.launch_info(cfg, host_lib)
        assert info["threads"] == nt
        assert info["smem_bytes"] == smem(nd, 8 + npas, pg, qg)
        assert info["blocks_per_sm"] >= 1
