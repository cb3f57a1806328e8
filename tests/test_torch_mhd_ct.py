"""The CT kernel's plain version against the JAX package's Pallas CT kernel.

``ramses_tpu_torch.mhd.ct_slab.ct_step_slab_ref`` (the plain PyTorch
version of the hand-written kernel ``csrc/mhd_ct.cu``) against
``ramses_tpu.mhd.pallas_ct.ct_step_slab`` run in the Pallas interpreter
on the CPU, called directly as ``tests/test_dma_halo.py`` runs it, on
seeded random padded boxes: 1D with each solver, 2D with each corner
solver, 3D, slope types 0/1/2/7/8 and a passive scalar, plain and with a
refined mask and an EMF override, in f32 (the table of
``tests/test_pallas_kernel.py``: rtol 2e-5 / atol 2e-6) and in f64
(1e-12).  Also the kernel's gate and the dispatch around it on the CPU,
where the wrapper runs the plain version and never launches.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ramses_tpu.mhd import pallas_ct  # noqa: E402
from ramses_tpu.mhd import uniform as jmu  # noqa: E402
from ramses_tpu.mhd.core import MhdStatic as JMhdStatic  # noqa: E402

from ramses_tpu_torch.convert import mhd_static_from  # noqa: E402
from ramses_tpu_torch.mhd import ct_slab, uniform as mu  # noqa: E402
from ramses_tpu_torch.mhd.core import MhdStatic  # noqa: E402

F32_RTOL, F32_ATOL = 2e-5, 2e-6
F64_RTOL = 1e-12


def _box(nd, n, seed, masked, dtype, npassive=0):
    """A random padded box: (up [8 + npassive, n+4...], bfp_ext [3,
    n+6...], okp, ovr) as numpy of ``dtype``; 1D has no edge to
    override."""
    rng = np.random.default_rng(seed)
    sp = (n + 4,) * nd
    spe = (n + 6,) * nd
    r = 1.0 + 0.3 * rng.random(sp)
    v = 0.3 * rng.standard_normal((3,) + sp)
    p = 0.5 + 0.3 * rng.random(sp)
    bf = 0.3 + 0.3 * rng.standard_normal((3,) + spe)
    e = p / (2.0 / 3.0) + 0.5 * r * (v ** 2).sum(axis=0) + 0.3
    up = np.stack([r, r * v[0], r * v[1], r * v[2], e,
                   *rng.standard_normal((3,) + sp)]).astype(dtype)
    okp = ovr = None
    if masked:
        okp = rng.random(sp) < 0.2
        ovr = {(a, b): (rng.random(sp) < 0.3,
                        (0.05 * rng.standard_normal(sp)).astype(dtype))
               for a in range(nd) for b in range(a + 1, nd)} or None
    if npassive:
        up = np.concatenate([up, (r * rng.random((npassive,) + sp))
                             .astype(dtype)])
    return up, bf.astype(dtype), okp, ovr


def _case(nd, n, solver, corner, slope, npassive=0):
    name = f"{nd}-{n}-{solver}-{corner}-{slope}"
    return pytest.param(nd, n, solver, corner, slope, npassive,
                        id=name + (f"-p{npassive}" if npassive else ""))


@pytest.mark.parametrize("nd,n,solver,corner,slope,npassive", [
    _case(2, 16, "hlld", "llf", 1),
    _case(3, 8, "hll", "average", 8),
    # 1D: each solver (no edges: the corner kind is not read)
    _case(1, 16, "llf", "average", 2),
    _case(1, 16, "hll", "average", 8),
    _case(1, 16, "hlld", "average", 1),
    _case(1, 16, "roe", "average", 1),
    _case(1, 16, "upwind", "average", 0),
    # 2D: each corner kind, slope types 0 and 7
    _case(2, 8, "llf", "average", 7),
    _case(2, 8, "roe", "roe", 1),
    _case(2, 8, "llf", "upwind", 2),
    _case(2, 8, "hll", "hll", 0),
    _case(2, 8, "hll", "hlla", 7),
    _case(2, 8, "hlld", "hlld", 1),
    # 3D and a passive scalar
    _case(3, 6, "roe", "roe", 1),
    _case(3, 6, "hlld", "hlla", 8),
    _case(2, 8, "upwind", "hlld", 1, npassive=1),
])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_version_matches_pallas_kernel(nd, n, solver, corner, slope,
                                             npassive, masked, dtype):
    jc = JMhdStatic(ndim=nd, riemann=solver, riemann2d=corner,
                    slope_type=slope, npassive=npassive)
    cfg = mhd_static_from(jc)
    assert ct_slab.supports(cfg, (n,) * nd, torch.float32)
    up, bfp, okp, ovr = _box(nd, n, 3 + nd + 10 * masked, masked, dtype,
                             npassive)
    dx = (1.0 / n,) * nd
    dt = dtype(2e-3)
    jun, jbfn = pallas_ct.ct_step_slab(
        jnp.asarray(up), jnp.asarray(bfp), dt, dx, jc,
        okp=None if okp is None else jnp.asarray(okp),
        ovr=None if ovr is None else {
            k: (jnp.asarray(m), jnp.asarray(v)) for k, (m, v) in ovr.items()},
        interpret=True)
    inner = tuple([slice(None)] + [slice(2, -2)] * nd)
    want_u, want_b = np.asarray(jun)[inner], np.asarray(jbfn)[inner]
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    un, bfn = ct_slab.ct_step_slab_ref(
        torch.tensor(up), torch.tensor(bfp), torch.tensor(dt, dtype=tdt),
        dx, cfg,
        okp=None if okp is None else torch.tensor(okp),
        ovr=None if ovr is None else {
            k: (torch.tensor(m), torch.tensor(v)) for k, (m, v) in ovr.items()})
    assert un.dtype == tdt
    assert tuple(un.shape) == (8 + npassive,) + (n,) * nd
    assert tuple(bfn.shape) == (3,) + (n,) * nd
    if dtype == np.float32:
        np.testing.assert_allclose(un.numpy(), want_u, rtol=F32_RTOL,
                                   atol=F32_ATOL)
        np.testing.assert_allclose(bfn.numpy(), want_b, rtol=F32_RTOL,
                                   atol=F32_ATOL)
    else:
        for got, want in ((un, want_u), (bfn, want_b)):
            for g, w in zip(got.numpy(), want):
                assert np.abs(g - w).max() <= F64_RTOL * np.abs(w).max()


def test_supports_is_the_kernel_scope():
    f32 = torch.float32
    accepted = [
        (MhdStatic(ndim=2, riemann="hlld", riemann2d="llf"), (2048, 2048)),
        (MhdStatic(ndim=3, riemann="llf", riemann2d="average",
                   slope_type=8), (64, 64, 64)),
        (MhdStatic(ndim=1, riemann="roe"), (256,)),             # the tube
        (MhdStatic(ndim=1, riemann="upwind", slope_type=0), (16,)),
        (MhdStatic(ndim=2, riemann="roe", riemann2d="roe"), (16, 16)),
        (MhdStatic(ndim=2, riemann="upwind", slope_type=7), (16, 16)),
        (MhdStatic(ndim=2, npassive=1), (16, 16)),
        (MhdStatic(ndim=3, npassive=ct_slab.MAX_PASSIVE), (8, 8, 8)),
    ]
    accepted += [(MhdStatic(ndim=2, riemann2d=kind), (16, 16))
                 for kind in ("average", "llf", "roe", "upwind", "hll",
                              "hlla", "hlld")]
    for cfg, shape in accepted:
        assert ct_slab.supports(cfg, shape, f32), cfg
    refused = [
        (MhdStatic(ndim=2), (16, 16), torch.float64),             # f64
        (MhdStatic(ndim=3), (16, 16), f32),                       # shape
        (MhdStatic(ndim=1), (16, 16), f32),
        (MhdStatic(ndim=2, trailing_batch=True), (16, 16), f32),
        (MhdStatic(ndim=2, slope_type=3), (16, 16), f32),
        (MhdStatic(ndim=2, npassive=ct_slab.MAX_PASSIVE + 1), (16, 16), f32),
    ]
    for cfg, shape, dtype in refused:
        assert not ct_slab.supports(cfg, shape, dtype), cfg


def test_wrapper_runs_the_plain_version_on_cpu():
    cfg = MhdStatic(ndim=2, riemann="hll", riemann2d="average")
    up, bfp, okp, ovr = _box(2, 6, 1, True, np.float32)
    args = (torch.tensor(up), torch.tensor(bfp),
            torch.tensor(1e-3, dtype=torch.float32), (1 / 6, 1 / 6), cfg)
    ov = {k: (torch.tensor(m), torch.tensor(v)) for k, (m, v) in ovr.items()}
    before = ct_slab.launches
    got = ct_slab.ct_step_slab(*args, okp=torch.tensor(okp), ovr=ov)
    want = ct_slab.ct_step_slab_ref(*args, okp=torch.tensor(okp), ovr=ov)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ct_slab.launches == before


@pytest.mark.parametrize("solver", ["hlld", "roe"])
def test_step_takes_the_kernel_path_by_configuration(solver):
    """``uniform.step`` pads and hands the box to ``ct_step_slab`` inside
    the gate (on the CPU its plain version; f32, both solvers) and runs
    ``step_padded`` outside it (f64); both give the same step."""
    cfg = MhdStatic(ndim=2, riemann=solver, riemann2d="llf")
    shape = (6, 5)
    grid = mu.MhdGrid(cfg=cfg, shape=shape, dx=0.2,
                      bc_kinds=((0, 0), (2, 2)))
    rng = np.random.default_rng(2)
    r = 1.0 + 0.2 * rng.random(shape)
    u = np.stack([r, 0.1 * r, -0.2 * r, 0.05 * r,
                  2.0 + rng.random(shape), *np.zeros((3,) + shape)])
    bf = 0.3 * rng.standard_normal((3,) + shape)
    for dtype in (torch.float32, torch.float64):
        ut = torch.tensor(u, dtype=dtype)
        bft = torch.tensor(bf, dtype=dtype)
        dt = torch.tensor(1e-3, dtype=dtype)
        un, bfn = mu.step(grid, ut, bft, dt)
        up = mu._pad(ut, 2, grid.bc_kinds)
        bfp = mu._pad(bft, 2, grid.bc_kinds, 3)
        wu, wb = mu.step_padded(cfg, (0.2, 0.2), up, bfp, dt)
        assert torch.equal(un, mu._unpad(wu, 2))
        assert torch.equal(bfn, torch.stack([mu._unpad(b, 2) for b in wb]))
        assert ct_slab.supports(cfg, shape, dtype) == (dtype == torch.float32)


def test_bx_alone_roe_is_the_reference_sensitivity():
    """ROADMAP §C4: at the Roe mean's degenerate field (a uniform Bx
    alone, ``chip_smoke.py`` phase 12b's 1D box), the JAX package's own
    Pallas kernel in f32 misses the f32 table against its f64
    formulation (``step_padded``), as K4 and the port's plain f32 version
    do: the reading (max abs err 7.856e-6 of u, table excess 3.6e-6 on
    the CPU) is the formulation's sensitivity there, not a fault of the
    port.  The port's plain f32 version reads the same error within a
    factor 1.5, and agrees with the f64 formulation to 1e-12 in f64."""
    rng = np.random.default_rng(1101)
    n = 256
    spp, spe = (n + 4,), (n + 6,)
    r = 1.0 + 0.3 * rng.random(spp)
    v = 0.2 * rng.standard_normal((3,) + spp)
    p = 0.5 + 0.2 * rng.random(spp)
    e = p / (2.0 / 3.0) + 0.5 * r * (v ** 2).sum(axis=0) + 0.2
    up = np.stack([r, r * v[0], r * v[1], r * v[2], e,
                   *np.zeros((3,) + spp)]).astype(np.float32)
    bfp = np.zeros((3,) + spe, dtype=np.float32)
    bfp[0] = 0.5
    jc = JMhdStatic(ndim=1, riemann="roe", riemann2d="average")
    cfg = mhd_static_from(jc)
    dx, dt = (1.0 / n,), np.float32(2e-3)
    inner = (slice(None), slice(2, -2))
    ju, _ = pallas_ct.ct_step_slab(jnp.asarray(up), jnp.asarray(bfp), dt, dx,
                                   jc, interpret=True)
    ju = np.asarray(ju)[inner].astype(np.float64)
    eu, _ = jmu.step_padded(jc, dx, jnp.asarray(up, jnp.float64),
                            jnp.asarray(bfp, jnp.float64), np.float64(dt))
    eu = np.asarray(eu)[inner]
    jerr = np.abs(ju - eu)
    assert (jerr - (F32_ATOL + F32_RTOL * np.abs(eu))).max() > 0
    pu, _ = ct_slab.ct_step_slab_ref(torch.tensor(up), torch.tensor(bfp),
                                     torch.tensor(dt), dx, cfg)
    perr = np.abs(pu.double().numpy() - eu).max()
    assert jerr.max() / 1.5 <= perr <= 1.5 * jerr.max()
    pu64, _ = ct_slab.ct_step_slab_ref(torch.tensor(up, dtype=torch.float64),
                                       torch.tensor(bfp, dtype=torch.float64),
                                       torch.tensor(float(dt),
                                                    dtype=torch.float64),
                                       dx, cfg)
    for g, w in zip(pu64.numpy(), eu):
        assert np.abs(g - w).max() <= F64_RTOL * np.abs(w).max()
