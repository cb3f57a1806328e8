"""The port's CUDA kernels on the card: each kernel against its plain version.

Every test here needs a CUDA device and skips without one (marker ``gpu``).
On a machine with a card, run them without the JAX package's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Shapes are ragged against the kernel's 32 x 4 thread blocks and the
boundaries mix every kind the kernel maps itself, which ``chip_smoke.py``
(64³ and 256³, mostly periodic) does not reach.  Tolerances are the table
of ``tests/test_pallas_kernel.py``: rtol 2e-5 / atol 2e-6 for the state,
rel 3e-3 for the Courant dt.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu_torch.driver import Simulation  # noqa: E402
from ramses_tpu_torch.config import load_params  # noqa: E402
from ramses_tpu_torch.grid import boundary as bmod  # noqa: E402
from ramses_tpu_torch.grid import uniform  # noqa: E402
from ramses_tpu_torch.hydro import fused_muscl as fm  # noqa: E402
from ramses_tpu_torch.hydro.core import HydroStatic  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(shape, gamma, seed):
    rng = np.random.default_rng(seed)
    r = 1.0 + 0.3 * rng.random(shape)
    v = 0.2 * rng.standard_normal((3,) + shape)
    p = 0.5 + 0.2 * rng.random(shape)
    e = p / (gamma - 1.0) + 0.5 * r * (v ** 2).sum(axis=0)
    return np.stack([r, r * v[0], r * v[1], r * v[2], e]).astype(np.float32)


def _bc(kinds):
    return bmod.BoundarySpec(faces=tuple(
        (bmod.FaceBC(kind=lo), bmod.FaceBC(kind=hi)) for lo, hi in kinds))


@pytest.mark.parametrize("shape,kinds,riemann,slope_type,masked", [
    ((12, 10, 40), ((0, 0), (0, 0), (0, 0)), "llf", 1, False),
    ((5, 7, 33), ((1, 2), (2, 1), (1, 1)), "hllc", 2, False),
    ((9, 6, 35), ((2, 2), (1, 0), (0, 2)), "hllc", 8, True),
    ((2, 3, 2), ((1, 1), (0, 0), (2, 2)), "llf", 2, True),
])
def test_fused_kernel_matches_plain(cuda, shape, kinds, riemann, slope_type,
                                    masked):
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=slope_type)
    u = torch.from_numpy(_state(shape, cfg.gamma, sum(shape))).to(cuda)
    ok = None
    if masked:
        rng = np.random.default_rng(1)
        ok = torch.from_numpy(rng.random(shape) < 0.2).to(cuda)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    bc = _bc(kinds)
    un, dtn = fm.fused_step(u, dt, cfg, 0.05, bc, ok=ok, courant=True)
    ref, dtr = fm.fused_step_ref(u, dt, cfg, 0.05, bc, ok=ok, courant=True)
    torch.testing.assert_close(un, ref, rtol=2e-5, atol=2e-6)
    assert float(dtn) == pytest.approx(float(dtr), rel=3e-3)
    assert fm.fused_step(u, dt, cfg, 0.05, bc, ok=ok).shape == u.shape


def test_fused_kernel_counts_launches_and_refuses_outside_scope(cuda):
    cfg = HydroStatic(ndim=3)
    u = torch.from_numpy(_state((8, 8, 8), cfg.gamma, 0)).to(cuda)
    dt = torch.tensor(1e-3, dtype=torch.float32, device=cuda)
    bc = bmod.BoundarySpec.periodic(3)
    before = fm.launches
    fm.fused_step(u, dt, cfg, 0.1, bc)
    fm.fused_step_ref(u, dt, cfg, 0.1, bc)
    assert fm.launches == before + 1
    with pytest.raises(ValueError):
        fm.fused_step(u.double(), dt.double(), cfg, 0.1, bc)
    with pytest.raises(ValueError):
        fm.fused_step(u.transpose(1, 3), dt, cfg, 0.1, bc)
    with pytest.raises(ValueError):
        fm.fused_step(u, 1e-3, cfg, 0.1, bc)
    with pytest.raises(ValueError):
        fm.fused_step(u, dt, cfg, 0.1, _bc(((3, 3), (0, 0), (0, 0))))


def test_driver_on_cuda_matches_cpu(cuda):
    """The slice end to end at 16³: the kernel path on the card against
    the plain path on the CPU, one launch per step."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = load_params(os.path.join(root, "namelists", "sedov3d.nml"), ndim=3)
    p.amr.levelmin = p.amr.levelmax = 4
    gpu = Simulation(p)
    cpu = Simulation(p, device="cpu")
    assert gpu.device.type == "cuda"
    assert uniform.fused_ok(gpu.grid, torch.float32)
    before = fm.launches
    gpu.evolve(chunk=4)
    cpu.evolve(chunk=4)
    assert fm.launches - before == gpu.nstep == cpu.nstep == 10
    assert gpu.t == pytest.approx(cpu.t, rel=1e-5)
    got, want = gpu.state.u.cpu().numpy(), cpu.state.u.numpy()
    for c in range(5):
        assert np.abs(got[c] - want[c]).max() <= 1e-4 * np.abs(want[c]).max()


# ---------------------------------------------------------------------------
# K3 (tile_sweep) and K2 (oct_sweep)
# ---------------------------------------------------------------------------

def _batch(block, n, gamma, seed):
    rng = np.random.default_rng(seed)
    u = _state((block,) * 3 + (n,), gamma, seed)
    ok = (rng.random((block,) * 3 + (n,)) < 0.15).astype(np.float32)
    return u, ok


@pytest.mark.parametrize("shift,n,riemann,slope_type", [
    (0, 5, "llf", 1), (1, 33, "hllc", 2), (2, 70, "hllc", 8),
    (2, 8, "llf", 2), (3, 9, "hllc", 1),
])
def test_tile_sweep_kernel_matches_plain(cuda, shift, n, riemann,
                                         slope_type):
    from ramses_tpu_torch.hydro import oct_muscl as om
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=slope_type)
    u, ok = _batch((1 << (shift + 1)) + 4, n, cfg.gamma, n)
    u, ok = torch.from_numpy(u).to(cuda), torch.from_numpy(ok).to(cuda)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    got = om.tile_sweep(u, ok, dt, cfg, 0.05, shift)
    want = om.tile_sweep_ref(u, ok, dt, cfg, 0.05, shift)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("n,riemann,slope_type", [
    (13, "llf", 1), (200, "hllc", 8), (256, "hllc", 2)])
def test_oct_sweep_kernel_matches_plain(cuda, n, riemann, slope_type):
    from ramses_tpu_torch.hydro import oct_muscl as om
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=slope_type)
    u, ok = _batch(6, n, cfg.gamma, n)
    u, ok = torch.from_numpy(u).to(cuda), torch.from_numpy(ok).to(cuda)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    got = om.oct_sweep(u, ok, dt, cfg, 0.05)
    want = om.oct_sweep_ref(u, ok, dt, cfg, 0.05)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


def test_oct_kernels_count_launches_and_refuse_outside_scope(cuda):
    from ramses_tpu_torch.hydro import oct_muscl as om
    cfg = HydroStatic(ndim=3)
    u, ok = _batch(8, 8, cfg.gamma, 0)
    u, ok = torch.from_numpy(u).to(cuda), torch.from_numpy(ok).to(cuda)
    dt = torch.tensor(1e-3, dtype=torch.float32, device=cuda)
    before = dict(om.launches)
    om.tile_sweep(u, ok, dt, cfg, 0.1, 1)
    om.tile_sweep_ref(u, ok, dt, cfg, 0.1, 1)
    assert om.launches["tile_sweep"] == before["tile_sweep"] + 1
    assert om.launches["oct_sweep"] == before["oct_sweep"]
    with pytest.raises(ValueError):
        om.tile_sweep(u.double(), ok, dt.double(), cfg, 0.1, 1)
    with pytest.raises(ValueError):
        om.tile_sweep(u, ok, dt, cfg, 0.1, 2)        # td 8 is shift 1
    with pytest.raises(ValueError):
        om.tile_sweep(u, ok, 1e-3, cfg, 0.1, 1)
    with pytest.raises(ValueError):
        om.oct_sweep(u, ok, dt, cfg, 0.1)            # not a 6^3 stencil


def test_amr_on_cuda_matches_cpu(cuda):
    """The AMR slice end to end at levelmin 4, levelmax 5: K1 and K3 on
    the card (K2 with oct_blocking off) against the plain versions on the
    CPU."""
    import os
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.hydro import oct_muscl as om
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for blocked, name in ((True, "tile_sweep"), (False, "oct_sweep")):
        p = load_params(os.path.join(root, "namelists", "sedov3d.nml"),
                        ndim=3)
        p.amr.levelmin, p.amr.levelmax = 4, 5
        p.amr.oct_blocking = blocked
        p.refine.err_grad_d = p.refine.err_grad_p = 0.1
        gpu, cpu = AmrSim(p), AmrSim(p, device="cpu")
        k1, kn = fm.launches, om.launches[name]
        for s in (gpu, cpu):
            s.evolve(1e9, nstepmax=3)
        assert fm.launches - k1 == 3
        assert om.launches[name] - kn == 3 * 2     # level 5 substeps
        assert gpu.levels() == cpu.levels() == [4, 5]
        assert gpu.t == pytest.approx(cpu.t, rel=1e-5)
        for l in gpu.levels():
            got, want = gpu.u[l].cpu().numpy(), cpu.u[l].numpy()
            scale = np.abs(want).max(axis=0)
            assert (np.abs(got - want) <= 1e-4 * scale).all(), (blocked, l)


@pytest.mark.parametrize("shape,kinds,masked,courant", [
    ((12, 10, 40), ((0, 0), (0, 0), (0, 0)), True, True),
    ((5, 7, 33), ((1, 2), (2, 1), (1, 1)), False, False),
])
def test_fused_kernel_want_flux_matches_plain(cuda, shape, kinds, masked,
                                              courant):
    """K1's face mass fluxes (the MC-tracer capture) beside the step,
    counted under their own key."""
    cfg = HydroStatic(ndim=3, riemann="hllc", slope_type=2)
    u = torch.from_numpy(_state(shape, cfg.gamma, 7)).to(cuda)
    ok = None
    if masked:
        rng = np.random.default_rng(2)
        ok = torch.from_numpy(rng.random(shape) < 0.2).to(cuda)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    bc = _bc(kinds)
    before = (fm.launches, fm.flux_launches)
    got = fm.fused_step(u, dt, cfg, 0.05, bc, ok=ok, courant=courant,
                        want_flux=True)
    assert (fm.launches, fm.flux_launches) == (before[0], before[1] + 1)
    want = fm.fused_step_ref(u, dt, cfg, 0.05, bc, ok=ok, courant=courant,
                             want_flux=True)
    assert len(got) == len(want) == 2 + courant
    assert tuple(got[-1].shape) == (3, 2) + shape
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(got[-1], want[-1], rtol=2e-5, atol=2e-6)
    if courant:
        assert float(got[1]) == pytest.approx(float(want[1]), rel=3e-3)


@pytest.mark.parametrize("shift,n", [(0, 5), (1, 33), (2, 70), (3, 9),
                                     (None, 13), (None, 200)])
def test_oct_kernels_want_flux_match_plain(cuda, shift, n):
    """K3's mass-flux planes and K2's per-cell face fluxes, counted under
    their own keys."""
    from ramses_tpu_torch.hydro import oct_muscl as om
    cfg = HydroStatic(ndim=3, riemann="llf", slope_type=8)
    block = 6 if shift is None else (1 << (shift + 1)) + 4
    u, ok = _batch(block, n, cfg.gamma, n + 1)
    u, ok = torch.from_numpy(u).to(cuda), torch.from_numpy(ok).to(cuda)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    name = "oct_sweep" if shift is None else "tile_sweep"
    extra = () if shift is None else (shift,)
    before = dict(om.launches)
    got = getattr(om, name)(u, ok, dt, cfg, 0.05, *extra, want_flux=True)
    want = getattr(om, name + "_ref")(u, ok, dt, cfg, 0.05, *extra,
                                      want_flux=True)
    assert om.launches[name + "_flux"] == before[name + "_flux"] + 1
    assert om.launches[name] == before[name]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


def test_amr_tracers_on_cuda_match_cpu(cuda):
    """The tracer path at levelmin 4, levelmax 5: K1 and K3 with the face
    mass fluxes on the card (K2 with oct_blocking off), the capture's mass
    identity on every leaf cell, and the tracer count conserved."""
    import os
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.hydro import oct_muscl as om
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for blocked, name in ((True, "tile_sweep_flux"),
                          (False, "oct_sweep_flux")):
        p = load_params(os.path.join(root, "namelists", "sedov3d.nml"),
                        ndim=3)
        p.amr.levelmin, p.amr.levelmax = 4, 5
        p.amr.oct_blocking = blocked
        p.refine.err_grad_d = p.refine.err_grad_p = 0.1
        p.run.tracer = True
        sim = AmrSim(p)
        n0 = len(sim.tracer_x)
        k1, kn = fm.flux_launches, om.launches[name]
        for _ in range(2):
            sim.regrid()
            u0 = {l: sim.u[l].clone() for l in sim.levels()}
            captured = {}
            real = sim._source_passes

            def grab(dt):
                captured.update({l: v.clone()
                                 for l, v in sim._tracer_phi.items()})
                real(dt)
            sim._source_passes = grab
            sim.step_coarse(sim.coarse_dt())
            del sim._source_passes
            for l in sim.levels():
                nc = sim.tree.noct(l) * 8
                leaf = torch.from_numpy(~sim.tree.refined_mask(l)).to(cuda)
                drho = (sim.u[l] - u0[l])[:nc, 0][leaf]
                phi = captured[l][:nc][leaf]
                net = (phi[:, :, 0] - phi[:, :, 1]).sum(dim=1)
                torch.testing.assert_close(net, drho, rtol=2e-4, atol=2e-6)
        assert fm.flux_launches > k1 and om.launches[name] > kn
        assert len(sim.tracer_x) == n0


def test_amr_coarse_step_never_waits_for_the_host(cuda):
    """One coarse step (K1, K3, interpolation, corrections, restriction,
    the next Courant dt) issues device work only: no synchronisation."""
    import os
    from ramses_tpu_torch.amr import hierarchy
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = load_params(os.path.join(root, "namelists", "sedov3d.nml"), ndim=3)
    p.amr.levelmin, p.amr.levelmax = 4, 6
    p.refine.err_grad_d = p.refine.err_grad_p = 0.1
    sim = hierarchy.AmrSim(p)
    sim.evolve(1e9, nstepmax=2)
    dt = torch.tensor(sim.coarse_dt(), dtype=torch.float32, device=cuda)
    spec = sim._fused_spec()
    assert len(spec.levels) == 3 and any(spec.blocked)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        u, dtn = hierarchy._coarse_step(sim.u, sim.dev, dt, spec)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(dtn) > 0.0
    assert all(bool(torch.isfinite(u[l]).all()) for l in u)


# ---------------------------------------------------------------------------
# K4: the MHD constrained-transport step (csrc/mhd_ct.cu)

def _mhd_box(sp, seed, masked, npassive=0):
    """A random padded MHD box on the card: (up, bfp_ext, okp, ovr); 1D
    has no edge to override."""
    rng = np.random.default_rng(seed)
    nd = len(sp)
    spp = tuple(n + 4 for n in sp)
    spe = tuple(n + 6 for n in sp)
    r = 1.0 + 0.3 * rng.random(spp)
    v = 0.2 * rng.standard_normal((3,) + spp)
    p = 0.5 + 0.2 * rng.random(spp)
    e = p / (2.0 / 3.0) + 0.5 * r * (v ** 2).sum(axis=0) + 0.2
    up = np.stack([r, r * v[0], r * v[1], r * v[2], e,
                   *np.zeros((3,) + spp)])
    bf = 0.3 + 0.2 * rng.standard_normal((3,) + spe)
    dev = torch.device("cuda")

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    okp = ovr = None
    if masked:
        okp = torch.from_numpy(rng.random(spp) < 0.15).to(dev)
        ovr = {(a, b): (torch.from_numpy(rng.random(spp) < 0.2).to(dev),
                        t(0.05 * rng.standard_normal(spp)))
               for a in range(nd) for b in range(a + 1, nd)} or None
    if npassive:
        up = np.concatenate([up, r * rng.random((npassive,) + spp)])
    return t(up), t(bf), okp, ovr


@pytest.mark.parametrize("sp,riemann,corner,slope_type,masked", [
    ((37, 19), "hlld", "llf", 1, False),
    ((9, 13, 7), "hll", "average", 8, True),
    ((5, 3), "llf", "llf", 2, True),
    ((6, 4, 5), "hlld", "llf", 1, False),
    ((300,), "roe", "average", 1, True),
    ((3,), "upwind", "average", 7, False),
    ((37, 19), "roe", "roe", 1, True),
    ((21, 8), "hlld", "hlld", 2, False),
    ((17, 5), "hll", "hlla", 0, True),
    ((7, 6, 5), "roe", "hlld", 8, True),
])
def test_ct_kernel_matches_plain(cuda, sp, riemann, corner, slope_type,
                                 masked):
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd.core import MhdStatic
    cfg = MhdStatic(ndim=len(sp), riemann=riemann, riemann2d=corner,
                    slope_type=slope_type, npassive=int(masked))
    up, bfp, okp, ovr = _mhd_box(sp, sum(sp), masked, cfg.npassive)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    dx = (1.0 / 32,) * len(sp)
    got = ct_slab.ct_step_slab(up, bfp, dt, dx, cfg, okp=okp, ovr=ovr)
    want = ct_slab.ct_step_slab_ref(up, bfp, dt, dx, cfg, okp=okp, ovr=ovr)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


def test_scratch_matches_the_kernel_layout(cuda):
    # the layout lives in csrc/mhd_ct.cu alone: q, dq, du_half, q_half,
    # bf_half, fluxes, edge EMFs; the passive maximum there and in the gate
    from ramses_tpu_torch.mhd import ct_slab
    lib = ct_slab._library()
    assert lib.ramses_mhd_ct_scratch_len(1, 10, 8) == 10 * (
        8 + 8 + 8 + 8 + 1 + 8 + 0)
    assert lib.ramses_mhd_ct_scratch_len(2, 10, 8) == 10 * (
        8 + 16 + 8 + 8 + 2 + 16 + 1)
    assert lib.ramses_mhd_ct_scratch_len(3, 10, 9) == 10 * (
        9 + 27 + 9 + 8 + 3 + 27 + 3)
    assert lib.ramses_mhd_ct_max_passive() == ct_slab.MAX_PASSIVE

def test_ct_kernel_counts_launches_and_refuses_outside_scope(cuda):
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd.core import MhdStatic
    cfg = MhdStatic(ndim=2, riemann="hlld", riemann2d="llf")
    up, bfp, _, _ = _mhd_box((8, 8), 0, False)
    dt = torch.tensor(1e-3, dtype=torch.float32, device=cuda)
    before = ct_slab.launches
    ct_slab.ct_step_slab(up, bfp, dt, (0.1, 0.1), cfg)
    ct_slab.ct_step_slab_ref(up, bfp, dt, (0.1, 0.1), cfg)
    assert ct_slab.launches == before + 1
    assert not ct_slab.supports(MhdStatic(ndim=2, slope_type=3), (8, 8),
                                torch.float32)
    assert not ct_slab.supports(cfg, (8, 8), torch.float64)
    with pytest.raises(ValueError):        # no fallback on a CUDA tensor
        ct_slab.ct_step_slab(up, bfp, dt, (0.1, 0.1),
                             MhdStatic(ndim=2, slope_type=3))
    with pytest.raises(ValueError):
        ct_slab.ct_step_slab(up.double(), bfp.double(), dt, (0.1, 0.1), cfg)
    with pytest.raises(ValueError):
        ct_slab.ct_step_slab(up, bfp[:, 1:], dt, (0.1, 0.1), cfg)
    assert ct_slab.launches == before + 1


def test_mhd_on_cuda_matches_cpu_and_never_waits(cuda):
    """A 2D MHD run at 16² (hlld, llf corners): the kernel path on the card
    against the plain path on the CPU, one launch per step, and a chunk of
    steps that issues device work only."""
    import os
    from ramses_tpu_torch.config import load_params
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd import uniform as mu
    from ramses_tpu_torch.mhd.driver import MhdSimulation
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = load_params(os.path.join(root, "namelists", "orszag2d.nml"), ndim=2)
    p.amr.levelmin = p.amr.levelmax = 4
    gpu = MhdSimulation(p)
    cpu = MhdSimulation(p, device="cpu")
    rng = np.random.default_rng(3)
    vel = 0.3 * rng.standard_normal((2, 16, 16))
    for sim in (gpu, cpu):
        u = sim.u.cpu().clone()
        u[1:3] = u[0] * torch.tensor(vel, dtype=torch.float32)
        u[4] = u[4] + 0.5 * (u[1] ** 2 + u[2] ** 2) / u[0]
        sim.u = u.to(sim.device)
    before = ct_slab.launches
    gpu.evolve(nstepmax=6, chunk=3)
    cpu.evolve(nstepmax=6, chunk=3)
    assert ct_slab.launches - before == gpu.nstep == cpu.nstep == 6
    assert gpu.t == pytest.approx(cpu.t, rel=1e-5)
    for got, want in ((gpu.u, cpu.u), (gpu.bf, cpu.bf)):
        got, want = got.cpu().numpy(), want.numpy()
        for c in range(got.shape[0]):
            assert np.abs(got[c] - want[c]).max() <= \
                1e-4 * max(np.abs(want[c]).max(), 1e-6)
    t = torch.tensor(gpu.t, dtype=torch.float64, device=cuda)
    tend = torch.tensor(1e9, dtype=torch.float64, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        u, bf, t, n = mu.run_steps(gpu.grid, gpu.u, gpu.bf, t, tend, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(n) == 2 and bool(torch.isfinite(u).all())


def test_tube_mhd_runs_k4_every_step_and_never_waits(cuda):
    """``namelists/tube_mhd.nml`` (1D, Roe, outflow) as ``run_namelist``
    runs it: one K4 launch a step, Bx untouched, and steps that issue
    device work only."""
    import os
    from ramses_tpu_torch.driver import run_namelist
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd import uniform as mu
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    nml = os.path.join(root, "namelists", "tube_mhd.nml")
    before = ct_slab.launches
    sim = run_namelist(nml, ndim=1, nstepmax=5)
    assert sim.nstep == 5 and ct_slab.launches - before == 5
    assert bool(torch.isfinite(sim.u).all())
    bx = sim.bf[0].clone()
    t = torch.tensor(sim.t, dtype=torch.float64, device=cuda)
    tend = torch.tensor(1e9, dtype=torch.float64, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        u, bf, t, n = mu.run_steps(sim.grid, sim.u, sim.bf, t, tend, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(n) == 2 and ct_slab.launches - before == 7
    assert torch.equal(bf[0], bx) and bool(torch.isfinite(u).all())


# ---------------------------------------------------------------------------
# MHD on the AMR hierarchy: K4 on the complete levels

MHD_BLOB = """
&RUN_PARAMS
hydro=.true.
nremap=1
/
&AMR_PARAMS
levelmin=4
levelmax=5
boxlen=1.0
/
&INIT_PARAMS
nregion=2
region_type(1)='square'
region_type(2)='square'
x_center=0.5,0.5
y_center=0.5,0.5
length_x=10.0,0.4
length_y=10.0,0.4
exp_region=10.0,2.0
d_region=1.0,4.0
p_region=1.0,3.0
u_region=0.0,0.6
v_region=0.0,-0.4
A_region=0.5,0.5
B_region=0.3,0.3
C_region=0.2,0.2
/
&HYDRO_PARAMS
gamma=1.6666667
courant_factor=0.8
riemann='hlld'
slope_type=1
/
&REFINE_PARAMS
err_grad_d=0.05
err_grad_p=0.05
/
"""


def test_mhd_amr_on_cuda_matches_cpu(cuda):
    """A magnetised disc at levelmin 4, levelmax 5 (hlld, llf corners):
    K4 on the complete level 4, with its refined mask and EMF override,
    once per coarse step, against the plain path on the CPU; the same tree,
    each field within 1e-5 of its max on the level."""
    from ramses_tpu_torch.config import params_from_string
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd.amr import MhdAmrSim
    p = params_from_string(MHD_BLOB, ndim=2)
    gpu, cpu = MhdAmrSim(p), MhdAmrSim(p, device="cpu")
    stepped = []
    real = gpu.step_coarse
    gpu.step_coarse = lambda dt: (stepped.append(gpu._fused_spec()),
                                  real(dt))
    before = ct_slab.launches
    for s in (gpu, cpu):
        s.evolve(1e9, nstepmax=3)
    want = sum(2 ** (l - spec.lmin) for spec in stepped
               for l, c in zip(spec.levels, spec.complete) if c)
    assert len(stepped) == 3 and want == 3
    assert ct_slab.launches - before == want
    assert gpu.levels() == cpu.levels() == [4, 5]
    assert gpu.t == pytest.approx(cpu.t, rel=1e-5)
    for l in gpu.levels():
        assert np.array_equal(gpu.tree.levels[l].keys, cpu.tree.levels[l].keys)
        for a, b in ((gpu.u, cpu.u), (gpu.bfs, cpu.bfs)):
            got, want_ = a[l].cpu().numpy(), b[l].numpy()
            scale = np.abs(want_).reshape(len(want_), -1).max(axis=0)
            assert (np.abs(got - want_).reshape(len(got), -1)
                    <= 1e-5 * np.maximum(scale, 1e-30)).all(), l
    assert gpu.max_divb() < 1e-5 and gpu.max_face_gap() == 0.0


def test_mhd_amr_coarse_step_never_waits_for_the_host(cuda):
    """One MHD coarse step (K4 with the override, the tile sweep, the
    corrections, the restriction, the next Courant dt) issues device work
    only."""
    from ramses_tpu_torch.config import params_from_string
    from ramses_tpu_torch.mhd import amr
    sim = amr.MhdAmrSim(params_from_string(MHD_BLOB, ndim=2))
    sim.evolve(1e9, nstepmax=1)
    dt = torch.tensor(sim.coarse_dt(), dtype=torch.float32, device=cuda)
    spec = sim._fused_spec()
    assert spec.complete == (True, False) and spec.blocked == (False, True)
    assert "emf_plan" in sim.dev[5]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        u, bf, dtn = amr._coarse_step(sim.u, sim.bfs, sim.dev, dt, spec)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(dtn) > 0.0
    assert all(bool(torch.isfinite(u[l]).all()) for l in u)
