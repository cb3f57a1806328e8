"""The port's CUDA kernels on the card: each kernel against its plain version.

Every test here needs a CUDA device and skips without one (marker ``gpu``).
On a machine with a card, run them without the JAX package's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Shapes are ragged against K1's 32 x 8 column tiles and 16-plane x chunks
(and thin: axes of 2-3 cells whose periodic ring wraps onto the tile), and the
boundaries mix every kind the kernel maps itself, which ``chip_smoke.py``
(64³ and 256³, mostly periodic) does not reach.  Tolerances are the table
of ``tests/test_pallas_kernel.py``: rtol 2e-5 / atol 2e-6 for the state,
rel 3e-3 for the Courant dt.
"""

import os

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
    ((19, 13, 37), ((0, 0), (0, 0), (0, 0)), "hllc", 2, True),
    ((2, 16, 16), ((0, 0), (1, 1), (2, 2)), "llf", 8, False),
    ((16, 3, 33), ((2, 2), (0, 0), (1, 0)), "hllc", 1, True),
    ((3, 2, 2), ((0, 0), (0, 0), (0, 0)), "llf", 2, False),
    ((40, 17, 70), ((1, 2), (2, 1), (0, 0)), "hllc", 8, True),
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


def _tiles(block, n, gamma, seed, dev):
    """:func:`_batch` in K3's tile-major layout, on ``dev``."""
    u, ok = _batch(block, n, gamma, seed)
    return (torch.from_numpy(u).movedim(-1, 1).contiguous().to(dev),
            torch.from_numpy(ok).movedim(-1, 0).contiguous().to(dev))


@pytest.mark.parametrize("shift,n,riemann,slope_type", [
    (0, 5, "llf", 1), (1, 33, "hllc", 2), (2, 70, "hllc", 8),
    (2, 8, "llf", 2), (3, 9, "hllc", 1),
])
def test_tile_sweep_kernel_matches_plain(cuda, shift, n, riemann,
                                         slope_type):
    from ramses_tpu_torch.hydro import oct_muscl as om
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=slope_type)
    u, ok = _tiles((1 << (shift + 1)) + 4, n, cfg.gamma, n, cuda)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    got = om.tile_sweep(u, ok, dt, cfg, 0.05, shift)
    want = om.tile_sweep_ref(u, ok, dt, cfg, 0.05, shift)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("shift,n", [(1, 3), (2, 64), (3, 5)])
def test_tile_sweep_chunk_cuts_are_bitwise(cuda, shift, n):
    """Every x chunk of a tile that a block can take gives the same bits
    as the chunk the launch chooses."""
    from ramses_tpu_torch.hydro import oct_muscl as om
    cfg = HydroStatic(ndim=3, riemann="hllc", slope_type=2)
    u, ok = _tiles((1 << (shift + 1)) + 4, n, cfg.gamma, 3 * n, cuda)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    lib = om._library()
    want = om.call(lib, u, ok, dt, cfg, 0.05, shift, True)
    chunks = om.launch_info(shift, n, "hllc")["chunks"]
    # every chunk up to the tile, but at shift 3 past 2 planes the shared
    # memory
    assert chunks == {1: [1, 2, 4], 2: [1, 2, 4, 8], 3: [1, 2]}[shift]
    for cx in chunks:
        got = om.call(lib, u, ok, dt, cfg, 0.05, shift, True, chunk=cx)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), cx


@pytest.mark.parametrize("n,riemann,slope_type", [
    (1, "hllc", 2), (7, "llf", 8), (13, "llf", 1), (45, "hllc", 1),
    (200, "hllc", 8), (256, "hllc", 2), (300, "llf", 2), (2048, "llf", 1)])
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


def _octs(n, gamma, seed, dev):
    u, ok = _batch(6, n, gamma, seed)
    return torch.from_numpy(u).to(dev), torch.from_numpy(ok).to(dev)


@pytest.mark.parametrize("n,riemann,want_flux", [
    (7, "llf", True), (300, "hllc", True), (2048, "llf", False)])
def test_oct_sweep_octs_a_block_are_bitwise(cuda, n, riemann, want_flux):
    """Every count of octs a block that fits the shared memory gives the
    bits of one oct a block and of the launch's own choice."""
    from ramses_tpu_torch.hydro import oct_muscl as om
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=2)
    u, ok = _octs(n, cfg.gamma, 5 * n, cuda)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    lib = om._library()
    want = om.call(lib, u, ok, dt, cfg, 0.05, None, want_flux)
    chunks = om.launch_info(None, n, riemann)["chunks"]
    assert chunks == list(range(1, len(chunks) + 1)) and len(chunks) > 8
    for b in [1] + chunks:
        got = om.call(lib, u, ok, dt, cfg, 0.05, None, want_flux, chunk=b)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), b


def test_oct_sweep_reports_its_launch(cuda):
    """K2's launch: the octs a block takes, its blocks, shared memory (11,024
    bytes an oct), resident blocks, registers and spill; a count of octs
    past the shared memory raises."""
    from ramses_tpu_torch.hydro import oct_muscl as om
    for n in (1, 45, 2048):
        info = om.launch_info(None, n, "hllc")
        assert info["chunk"] in info["chunks"] and info["threads"] == 256
        assert info["smem_bytes"] == 11024 * info["chunk"]
        assert info["blocks"] == -(-n // info["chunk"])
        assert info["blocks_per_sm"] >= 1 and info["registers"] > 0
    with pytest.raises(RuntimeError):
        om.launch_info(None, 64, "llf", chunk=info["chunks"][-1] + 1)


@pytest.mark.parametrize("n,riemann,slope_type,want_flux", [
    (9, "hllc", 2, True), (300, "llf", 8, True), (2048, "llf", 1, False)])
def test_oct_sweep_is_tile_sweep_at_shift_0(cuda, n, riemann, slope_type,
                                            want_flux):
    """K2 and K3 share their stage code: on the same octs K2's du and mass
    fluxes are bitwise K3's at shift 0, and its per-oct sums are K3's face
    planes added in K2's fixed order."""
    from ramses_tpu_torch.hydro import oct_muscl as om
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=slope_type)
    u, ok = _octs(n, cfg.gamma, 7 * n, cuda)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    got = om.oct_sweep(u, ok, dt, cfg, 0.05, want_flux=want_flux)
    want = om.oct_from_tiles(om.tile_sweep(
        u.movedim(-1, 1).contiguous(), ok.movedim(-1, 0).contiguous(), dt,
        cfg, 0.05, 0, want_flux=want_flux))
    assert len(got) == len(want) == 2 + want_flux
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_oct_kernels_count_launches_and_refuse_outside_scope(cuda):
    from ramses_tpu_torch.hydro import oct_muscl as om
    cfg = HydroStatic(ndim=3)
    u, ok = _tiles(8, 8, cfg.gamma, 0, cuda)
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
        om.tile_sweep(u.movedim(1, -1), ok.movedim(0, -1), dt, cfg, 0.1, 1)
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
    if shift is None:
        u, ok = _batch(6, n, cfg.gamma, n + 1)
        u, ok = torch.from_numpy(u).to(cuda), torch.from_numpy(ok).to(cuda)
    else:
        u, ok = _tiles((1 << (shift + 1)) + 4, n, cfg.gamma, n + 1, cuda)
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
    # the fused kernel keeps every intermediate in shared memory: no
    # scratch entry, and the launch's rings sized from the passive count;
    # the passive maximum there and in the gate; no spill for the llf,
    # hll and hlld solvers with average, llf and hlld corners
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd.core import MhdStatic
    lib = ct_slab._library()
    assert not hasattr(lib, "ramses_mhd_ct_scratch_len")
    assert lib.ramses_mhd_ct_max_passive() == ct_slab.MAX_PASSIVE
    for nd in (2, 3):
        for rs in ("llf", "hll", "hlld"):
            for r2 in ("average", "llf", "hlld"):
                info = ct_slab.launch_info(MhdStatic(ndim=nd, riemann=rs,
                                                     riemann2d=r2))
                assert info["local_bytes"] == 0, (nd, rs, r2, info)
                assert info["blocks_per_sm"] >= 1
    small = ct_slab.launch_info(MhdStatic(ndim=3, riemann="hlld"))
    big = ct_slab.launch_info(MhdStatic(ndim=3, riemann="hlld",
                                        npassive=ct_slab.MAX_PASSIVE))
    assert 0 < small["smem_bytes"] < big["smem_bytes"] <= 232448


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


# Ragged against K4's tiles (2D: 126 columns; 3D: 12 x 16 columns; 1D: 126
# cells) on every axis, crossing at least two of them
CT_RAGGED = [((300,), "hlld", "average", 1, True, 2),
             ((70, 131), "hlld", "llf", 1, True, 0),
             ((70, 131), "roe", "hlld", 2, True, 2),
             ((34, 13, 20), "hlld", "hlld", 8, True, 0),
             ((34, 13, 20), "roe", "roe", 2, True, 1)]


@pytest.mark.parametrize("sp,riemann,corner,slope_type,masked,npassive",
                         CT_RAGGED)
def test_ct_kernel_on_ragged_multi_tile_boxes(cuda, sp, riemann, corner,
                                              slope_type, masked, npassive):
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd.core import MhdStatic
    cfg = MhdStatic(ndim=len(sp), riemann=riemann, riemann2d=corner,
                    slope_type=slope_type, npassive=npassive)
    up, bfp, okp, ovr = _mhd_box(sp, 3 + sum(sp), masked, npassive)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    dx = (1.0 / sp[0],) * len(sp)
    got = ct_slab.ct_step_slab(up, bfp, dt, dx, cfg, okp=okp, ovr=ovr)
    want = ct_slab.ct_step_slab_ref(up, bfp, dt, dx, cfg, okp=okp, ovr=ovr)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("sp,riemann,corner", [
    ((70, 131), "hlld", "llf"),
    ((34, 13, 20), "roe", "hlld"),
])
def test_ct_kernel_row_chunks_are_bitwise(cuda, sp, riemann, corner):
    """Chunks of rows ragged against the box (a row a warm-up row in one
    cut, a steady one in another) give the same bits as the kernel's own
    choice, with the mask, the override and passives."""
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd.core import MhdStatic
    cfg = MhdStatic(ndim=len(sp), riemann=riemann, riemann2d=corner,
                    npassive=2)
    up, bfp, okp, ovr = _mhd_box(sp, 17, True, 2)
    okf = okp.to(torch.float32)
    pairs = sorted(ovr)
    ovm = torch.stack([ovr[p][0].to(torch.float32) for p in pairs])
    ovv = torch.stack([ovr[p][1] for p in pairs])
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    dx = (1.0 / sp[0],) * len(sp)
    lib = ct_slab._library()
    stream = torch.cuda.current_stream().cuda_stream
    ref = ct_slab.call(lib, up, bfp, dt, dx, cfg, okf, ovm, ovv, stream)
    for chunk in (1, 3, 5, 32):
        got = ct_slab.call(lib, up, bfp, dt, dx, cfg, okf, ovm, ovv, stream,
                           chunk)
        for g, w in zip(got, ref):
            assert torch.equal(g, w), chunk
    want = ct_slab.ct_step_slab_ref(up, bfp, dt, dx, cfg, okp=okp, ovr=ovr)
    for g, w in zip(ref, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("sp,shift,riemann,corner", [
    ((300,), (77,), "roe", "average"),
    ((70, 131), (13, 57), "hlld", "llf"),
    ((40, 130), (21, 101), "roe", "roe"),
    ((34, 13, 20), (5, 3, 7), "hlld", "hlld"),
])
def test_ct_kernel_is_roll_invariant_on_the_card(cuda, sp, shift, riemann,
                                                 corner):
    """On a periodic box the step of the rolled state is the rolled step,
    bitwise, with nvcc's FMA contraction on: a value that two blocks
    compute (halo items, warm-up rows) has the same bits in both, and the
    centred B is its two new faces' mean."""
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd import uniform as mu
    from ramses_tpu_torch.mhd.core import MhdStatic
    nd = len(sp)
    cfg = MhdStatic(ndim=nd, riemann=riemann, riemann2d=corner)
    up, bfp, _, _ = _mhd_box(sp, 11 + sum(sp), False)
    inner = (slice(None),) + tuple(slice(2, -2) for _ in sp)
    u = up[inner].contiguous()
    bf = bfp[(slice(None),) + tuple(slice(3, -3) for _ in sp)].contiguous()
    kinds = ((bmod.PERIODIC, bmod.PERIODIC),) * nd
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    dx = (1.0 / sp[0],) * nd
    dims = tuple(range(1, nd + 1))

    def step(u, bf):
        return ct_slab.ct_step_slab(mu._pad(u, nd, kinds).contiguous(),
                                    mu._pad(bf, nd, kinds,
                                            mu.NGHOST + 1).contiguous(),
                                    dt, dx, cfg)
    ref = step(u, bf)
    got = step(torch.roll(u, shift, dims), torch.roll(bf, shift, dims))
    for g, w in zip(got, ref):
        assert torch.equal(g, torch.roll(w, shift, dims)), \
            float((g - torch.roll(w, shift, dims)).abs().max())
    un, bfn = ref
    for c in range(nd):
        n = sp[c] - 1
        mean = 0.5 * (bfn[c].narrow(c, 0, n) + bfn[c].narrow(c, 1, n))
        assert torch.equal(un[5 + c].narrow(c, 0, n), mean)


@pytest.mark.parametrize("sp", [(300,), (70, 131), (34, 13, 20)])
def test_ct_kernel_is_one_launch_a_call(cuda, sp):
    """One count and one CUDA kernel a call in a profiler trace: the stages
    are fused, and the wrapper allocates only the outputs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ramses_tpu_torch.mhd import ct_slab
    from ramses_tpu_torch.mhd.core import MhdStatic
    cfg = MhdStatic(ndim=len(sp), riemann="hlld", riemann2d="llf")
    up, bfp, _, _ = _mhd_box(sp, 5, False)
    dt = torch.tensor(1e-3, dtype=torch.float32, device=cuda)
    dx = (1.0 / sp[0],) * len(sp)
    ct_slab.ct_step_slab(up, bfp, dt, dx, cfg)
    torch.cuda.synchronize()
    before = ct_slab.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ct_slab.ct_step_slab(up, bfp, dt, dx, cfg)
        torch.cuda.synchronize()
    assert ct_slab.launches == before + 3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    assert [e.count for e in rows] == [3], [(e.key, e.count) for e in rows]
    assert "mhd_ct_fused" in rows[0].key


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


# ---------------------------------------------------------------------------
# K5: the ring halo exchange (csrc/halo_exchange.cu) and K1's padded entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nshard", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_halo_kernel_matches_plain(cuda, nshard, dtype):
    """Every slab of every shard in one launch, bitwise the plain copy: the
    three cut axes, both depths, into fresh tensors and into the ghost
    regions of extended blocks."""
    from ramses_tpu_torch.parallel import dma_halo
    g = torch.Generator(device="cpu").manual_seed(nshard)
    blocks = [torch.randn((5, 6, 10, 13), generator=g, dtype=dtype)
              .to(cuda) for _ in range(nshard)]
    for ax in (1, 2, 3):
        for ng in (1, 2):
            eshape = list(blocks[0].shape)
            eshape[ax] += 2 * ng
            ext = [torch.zeros(eshape, dtype=dtype, device=cuda)
                   for _ in range(nshard)]
            pairs = []
            for s in range(nshard):
                d = (s + 1) % nshard
                pairs.append((blocks[s].narrow(ax, blocks[s].shape[ax] - ng,
                                               ng),
                              ext[d].narrow(ax, 0, ng)))
                pairs.append((blocks[s].narrow(ax, 0, ng),
                              torch.empty_like(blocks[d].narrow(ax, 0, ng),
                                               memory_format=torch.
                                               contiguous_format)))
            want = [torch.zeros_like(e) for e in ext]
            want_fresh = [torch.empty_like(p[1]) for p in pairs[1::2]]
            ref_pairs = []
            for i, (src, _) in enumerate(pairs):
                dst = (want[(i // 2 + 1) % nshard].narrow(ax, 0, ng)
                       if i % 2 == 0 else want_fresh[i // 2])
                ref_pairs.append((src, dst))
            before = dma_halo.launches
            dma_halo.halo_exchange(pairs)
            dma_halo.halo_exchange_ref(ref_pairs)
            torch.cuda.synchronize()
            assert dma_halo.launches == before + 1
            for a, b in zip(ext, want):
                assert torch.equal(a, b)
            for (_, a), b in zip(pairs[1::2], want_fresh):
                assert torch.equal(a, b)


def test_halo_kernel_refuses_what_it_does_not_take(cuda):
    from ramses_tpu_torch.parallel import dma_halo
    a = torch.zeros(4, 5, 6, device=cuda)
    with pytest.raises(ValueError):
        dma_halo.halo_exchange([(a[:, 1:3, 2:4], torch.zeros(4, 2, 2,
                                                             device=cuda))])
    with pytest.raises(NotImplementedError):
        dma_halo.halo_exchange([(a, torch.zeros(4, 5, 6))])


@pytest.mark.parametrize("shape,masked,want_flux", [
    ((12, 10, 40), False, False), ((2, 7, 33), True, True),
    ((9, 6, 3), True, False), ((19, 13, 37), True, True),
    ((3, 16, 33), False, True)])
def test_fused_padded_entry_is_the_unpadded_one(cuda, shape, masked,
                                                want_flux):
    """The padded entry on a periodic box padded by the plain ``pad`` is
    bitwise the unpadded entry (one kernel, one instruction stream), and
    within the table of its own plain version."""
    cfg = HydroStatic(ndim=3, riemann="hllc", slope_type=2)
    u = torch.from_numpy(_state(shape, cfg.gamma, 3)).to(cuda)
    bc = bmod.BoundarySpec.periodic(3)
    ok = (torch.from_numpy(np.random.default_rng(2).random(shape) < 0.2)
          .to(cuda) if masked else None)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    up = bmod.pad(u, bc, cfg, fm.NG).contiguous()
    okp = fm._pad_mask(ok.float(), bc) if masked else None
    before = fm.padded_flux_launches if want_flux else fm.padded_launches
    got = fm.fused_step_padded(up, dt, cfg, 0.05, ok_pad=okp, courant=True,
                               want_flux=want_flux)
    after = fm.padded_flux_launches if want_flux else fm.padded_launches
    assert after == before + 1
    want = fm.fused_step(u, dt, cfg, 0.05, bc, ok=ok, courant=True,
                         want_flux=want_flux)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ref = fm.fused_step_padded_ref(up, dt, cfg, 0.05, ok_pad=okp,
                                   courant=True, want_flux=want_flux)
    torch.testing.assert_close(got[0], ref[0], rtol=2e-5, atol=2e-6)
    assert float(got[1]) == pytest.approx(float(ref[1]), rel=3e-3)


@pytest.mark.parametrize("shape,cuts,riemann,masked", [
    ((20, 9, 35), ((0, 1, 3, 4, 20), (0, 2, 18, 19, 20)), "hllc", True),
    ((40, 33, 70), ((0, 16, 17, 19, 40), (0, 1, 33, 35, 40)), "llf", True),
    ((17, 5, 33), ((0, 16, 17), (0, 1, 17)), "llf", False),
])
def test_fused_padded_slabs_are_the_whole_box(cuda, shape, cuts, riemann,
                                              masked):
    """A periodic box cut into x slabs (1- and 2-plane slabs among them)
    swept slab by slab through the padded entry, ghosts from the box padded
    by the plain ``pad``: update, face fluxes and Courant dt bitwise those
    of the unpadded entry on the whole box, at two cuts."""
    cfg = HydroStatic(ndim=3, riemann=riemann, slope_type=2)
    u = torch.from_numpy(_state(shape, cfg.gamma, 5)).to(cuda)
    bc = bmod.BoundarySpec.periodic(3)
    ok = (torch.from_numpy(np.random.default_rng(4).random(shape) < 0.2)
          .to(cuda) if masked else None)
    dt = torch.tensor(2e-3, dtype=torch.float32, device=cuda)
    un, dtn, phi = fm.fused_step(u, dt, cfg, 0.05, bc, ok=ok, courant=True,
                                 want_flux=True)
    up = bmod.pad(u, bc, cfg, fm.NG)
    okp = fm._pad_mask(ok.float(), bc) if masked else None
    for cut in cuts:
        got = [fm.fused_step_padded(
            up[:, a:b + 4].contiguous(), dt, cfg, 0.05,
            ok_pad=okp[a:b + 4].contiguous() if masked else None,
            courant=True, want_flux=True) for a, b in zip(cut[:-1], cut[1:])]
        assert torch.equal(torch.cat([g[0] for g in got], 1), un)
        assert torch.equal(torch.stack([g[1] for g in got]).min(), dtn)
        assert torch.equal(torch.cat([g[2] for g in got], 2), phi)


def test_slab_paths_on_cuda_are_the_single_device_ones(cuda):
    """8 shards on the card: run_steps_halo (split on, K5 once a step, K1's
    padded entry 3 times a shard a step) and ShardedAmrSim bitwise equal to
    the single-device runs."""
    import os
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.parallel import dma_halo
    from ramses_tpu_torch.parallel.amr_sharded import ShardedAmrSim
    from ramses_tpu_torch.parallel.halo import run_steps_halo
    from ramses_tpu_torch.parallel.mesh import ShardMesh
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = load_params(os.path.join(root, "namelists", "sedov3d.nml"), ndim=3)
    p.amr.levelmin = p.amr.levelmax = 6
    sim = Simulation(p)
    mesh = ShardMesh([cuda] * 8)
    k5, k1p = dma_halo.launches, fm.padded_launches
    uh, th, nh = run_steps_halo(sim.grid, mesh, sim.state.u, 0.0, 1e9, 3)
    assert dma_halo.launches - k5 == 3 and fm.padded_launches - k1p == 72
    ur, tr, nr = uniform.run_steps(sim.grid, sim.state.u, 0.0, 1e9, 3)
    assert float(th) == float(tr) and torch.equal(uh, ur)
    p.amr.levelmin, p.amr.levelmax = 5, 6
    p.refine.err_grad_d = p.refine.err_grad_p = 0.1
    s8 = ShardedAmrSim(p, devices=mesh)
    s1 = AmrSim(p)
    assert s8._fused_spec().slab[0].backend == "dma"
    s8.evolve(1e9, nstepmax=3)
    s1.evolve(1e9, nstepmax=3)
    for l in s1.levels():
        assert torch.equal(s8.u[l], s1.u[l])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_mg_solve_on_cuda_matches_its_cpu_run(cuda, dtype, tol):
    """Config 3's solver at 32³: 4 V-cycles on the card against the same
    on the CPU, within ``tol`` of max|phi|."""
    from ramses_tpu_torch.poisson import solver
    rhs = np.random.default_rng(0).standard_normal((32, 32, 32))
    rhs = torch.from_numpy(rhs - rhs.mean()).to(dtype)
    want = solver.mg_solve(rhs, 1.0 / 32, ncycle=4)
    got = solver.mg_solve(rhs.to(cuda), 1.0 / 32, ncycle=4).cpu()
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_pcg_level_on_cuda_matches_its_cpu_run(cuda):
    """The hierarchy's solve of a 2D blob (levelmin 4, levelmax 5) in f64 on
    the card and on the CPU: the same PCG iteration count, phi within 1e-9
    of its scale, and the card's solve bitwise equal to itself."""
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.config import params_from_dict
    g = {"run_params": {"hydro": True, "poisson": True},
         "amr_params": {"levelmin": 4, "levelmax": 5, "boxlen": 1.0},
         "init_params": {"nregion": 2, "region_type": ["square", "square"],
                         "x_center": [0.5, 0.5], "y_center": [0.5, 0.5],
                         "length_x": [10.0, 0.25], "length_y": [10.0, 0.25],
                         "exp_region": [10.0, 2.0], "d_region": [1.0, 50.0],
                         "p_region": [10.0, 10.0]},
         "hydro_params": {"gamma": 1.4, "courant_factor": 0.5,
                          "riemann": "hllc"},
         "refine_params": {"err_grad_d": 0.2}}
    sims = [AmrSim(params_from_dict(g, ndim=2), dtype=torch.float64,
                   device=dev) for dev in ("cpu", cuda)]
    for s in sims:
        s.solve_gravity()
    cpu, card = sims
    assert int(card.poisson_iters[5]) == int(cpu.poisson_iters[5]) > 0
    scale = float(cpu.phi[5].abs().max())
    assert float((card.phi[5].cpu() - cpu.phi[5]).abs().max()) <= 1e-9 * scale
    phi = card.phi[5].clone()
    card.phi.pop(5)
    card.solve_gravity()
    assert torch.equal(card.phi[5], phi)


def test_solves_on_cuda_never_wait_on_the_host(cuda):
    """With the card's sync debug mode at "error" (a call that waits on the
    device raises): ``mg_solve``, ``cg_solve``, ``fft_solve``, the uniform
    gravity steps and the hierarchy's PCG, each after a first call that
    puts its cached tables on the card."""
    from ramses_tpu_torch.amr import kernels as K
    from ramses_tpu_torch.amr.hierarchy import AmrSim, _Cfg1
    from ramses_tpu_torch.config import params_from_dict
    from ramses_tpu_torch.pm.coupling import run_steps_pm
    from ramses_tpu_torch.poisson import amr_solve as gs
    from ramses_tpu_torch.poisson import solver
    g = {"run_params": {"hydro": True, "poisson": True},
         "amr_params": {"levelmin": 4, "levelmax": 5, "boxlen": 1.0},
         "init_params": {"nregion": 2, "region_type": ["square", "square"],
                         "x_center": [0.5, 0.5], "y_center": [0.5, 0.5],
                         "z_center": [0.5, 0.5],
                         "length_x": [10.0, 0.25], "length_y": [10.0, 0.25],
                         "length_z": [10.0, 0.25],
                         "exp_region": [10.0, 2.0], "d_region": [1.0, 50.0],
                         "p_region": [10.0, 10.0]},
         "refine_params": {"err_grad_d": 0.2}}
    sim = AmrSim(params_from_dict(g, ndim=3), device=cuda)
    sim.solve_gravity()
    d = sim.dev[5]
    ghosts = K.interp_cells(sim.phi[4][:, None], d["g_cell"], d["g_gnb"],
                            d["g_sgn"], _Cfg1(3), itype=1)[:, 0]
    rhs = 4.0 * torch.pi * (sim.u[5][:, 0] - 1.0)
    g["amr_params"]["levelmax"] = 4
    usim = Simulation(params_from_dict(g, ndim=3), device=cuda)
    t = torch.zeros((), dtype=torch.float64, device=cuda)
    tend = torch.full((), 1.0, dtype=torch.float64, device=cuda)

    def calls():
        r = torch.randn(16, 16, 16, device=cuda)
        solver.mg_solve(r, 1.0 / 16, ncycle=2)
        solver.cg_solve(r, 1.0 / 16, iters=5, tol=1e-6)
        solver.fft_solve(r, 1.0 / 16)
        run_steps_pm(usim.grid, usim.gspec, usim.pspec, usim.state.u,
                     None, usim.state.f, t, tend, t.new_zeros(()), 2)
        gs.pcg_level(rhs, ghosts, d["g_nb"], d["g_octnb"], sim.dx(5),
                     d["g_valid"], 3, iters=5, phi0=sim.phi[5],
                     mg=d["g_mg"])
    calls()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        calls()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _cosmo_sim(initdir, deposit, device):
    """``tests/test_cosmo_ics.py``'s single mode at 16³ with baryons (the
    port's own grafic writer), the deposit scheme ``deposit``."""
    from ramses_tpu_torch.config import Params
    from ramses_tpu_torch.io import grafic
    from ramses_tpu_torch.pm.init_part import fpeebl
    n = 16
    if not os.path.isdir(initdir):
        x = (np.arange(n) + 0.5) / n
        delta = (0.02 * np.cos(2 * np.pi * x))[:, None, None] \
            * np.ones((1, n, n))
        hdr = grafic.GraficHeader(n, n, n, dx=100.0 / n, astart=0.02,
                                  omega_m=1.0, omega_v=0.0, h0=70.0)
        grafic.write_zeldovich_ics(initdir, delta, hdr,
                                   fpeebl(0.02, 1.0, 0.0, 0.0))
    p = Params(ndim=3)
    p.run.cosmo = p.run.pic = p.run.poisson = p.run.hydro = True
    p.amr.levelmin, p.amr.levelmax, p.amr.boxlen = 4, 4, 1.0
    p.init.filetype = "grafic"
    p.init.initfile = [initdir]
    p.init.aexp_ini = 0.02
    p.raw = {"cosmo_params": {"omega_m": 1.0, "omega_l": 0.0,
                              "omega_b": 0.045, "h0": 70.0, "aexp": 0.02,
                              "boxlen_ini": 100.0},
             "pm_params": {"deposit": deposit}}
    return Simulation(p, device=device)


@pytest.mark.parametrize("deposit", ["ngp", "cic", "tsc"])
def test_particle_steps_on_cuda_never_wait_and_replay_bitwise(cuda,
                                                              tmp_path,
                                                              deposit):
    """``run_steps_pm`` with a ``ParticleSet``, gas and the supercomoving
    clock (aexp and hexp looked up on the card): after a first call that
    puts the tables on the card, two steps with the sync debug mode at
    "error" (a call that waits on the device raises); and the deposit sums
    in a fixed order, so four steps run twice from one state are bitwise
    equal."""
    from ramses_tpu_torch.pm.coupling import run_steps_pm
    sim = _cosmo_sim(os.path.join(str(tmp_path), "ics"), deposit, cuda)
    st = sim.state
    assert st.p is not None and sim.cosmo is not None
    f64 = dict(dtype=torch.float64, device=cuda)
    t0 = torch.tensor(st.t, **f64)
    tend = torch.tensor(float(sim.cosmo.tau_of_aexp(0.5)), **f64)
    dt0 = torch.tensor(st.dt_old, **f64)

    def steps(n):
        return run_steps_pm(sim.grid, sim.gspec, sim.pspec, st.u, st.p,
                            st.f, t0, tend, dt0, n, cosmo=sim.cosmo)
    steps(2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        steps(2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    a, b = steps(4), steps(4)
    assert int(a[5]) == 4
    for x, y in ((a[0], b[0]), (a[1].x, b[1].x), (a[1].v, b[1].v),
                 (a[2], b[2]), (a[3], b[3])):
        assert bool(torch.isfinite(x).all()) and torch.equal(x, y)
