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


# ---------------------------------------------------------------------------
# the coarse-step source passes: MHD gravity, sinks, turbulence forcing
# ---------------------------------------------------------------------------

MHD_GRAV_BLOB = MHD_BLOB.replace("hydro=.true.",
                                 "hydro=.true.\npoisson=.true.")


def test_mhd_gravity_step_never_waits_and_replays_bitwise(cuda):
    """One MHD coarse step with self-gravity (the half kicks at every
    level substep, K4 on the complete level, the gravity-corrected next
    Courant dt) issues device work only; and two coarse steps (the
    per-level solve included) run twice from one state are bitwise."""
    from ramses_tpu_torch.config import params_from_string
    from ramses_tpu_torch.convert import mhd_amr_state_from
    from ramses_tpu_torch.mhd import amr
    p = params_from_string(MHD_GRAV_BLOB, ndim=2)
    sim = amr.MhdAmrSim(p)
    assert sim.gravity
    sim.evolve(1e9, nstepmax=1)
    sim.solve_gravity()
    dt = torch.tensor(sim.coarse_dt(), dtype=torch.float32, device=cuda)
    spec = sim._fused_spec()
    assert spec.gravity
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        u, bf, dtn = amr._coarse_step(sim.u, sim.bfs, sim.dev, dt, spec,
                                      sim.fg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(dtn) > 0.0
    state = mhd_amr_state_from(sim)

    def replay():
        s = amr.MhdAmrSim.from_state(p, **state, device=cuda)
        s.evolve(1e9, nstepmax=s.nstep + 2)
        return s
    a, b = replay(), replay()
    for l in a.levels():
        for x, y in ((a.u[l], b.u[l]), (a.bfs[l], b.bfs[l]),
                     (a.phi[l], b.phi[l]), (a.fg[l], b.fg[l])):
            assert bool(torch.isfinite(x).all()) and torch.equal(x, y), l


def test_sink_pass_fetches_only_the_density_columns_when_quiet(cuda):
    """The hierarchy's coarse step with sinks on issues device work only;
    the sink pass on a state with no candidate cell and no sink fetches
    one density column a level (counted as the synchronisations the sync
    debug mode warns about), as the JAX package's pass does."""
    import re
    import warnings

    from ramses_tpu_torch.amr import hierarchy as H
    from ramses_tpu_torch.config import params_from_string
    from ramses_tpu_torch.pm import amr_physics
    text = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "namelists", "smbh_bondi.nml")).read()
    text = re.sub(r"levelmin=\d+", "levelmin=4", text)
    text = re.sub(r"levelmax=\d+", "levelmax=5", text)
    text = text.replace("n_sink=500.0", "n_sink=1e30")
    sim = H.AmrSim(params_from_string(text, ndim=2))
    sim.evolve(1e9, nstepmax=1)
    assert sim.sinks is not None and sim.sinks.n == 0
    spec = sim._fused_spec()
    dt = torch.tensor(1e-4, dtype=torch.float32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        H._coarse_step(sim.u, sim.dev, dt, spec, sim.fg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            amr_physics.sink_passes_amr(sim, 1e-4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == len(sim.levels()), [str(w.message) for w in syncs]
    assert sim.sinks.n == 0


def test_turbulence_forcing_same_seed_same_bits(cuda):
    """The OU forcing on the card: two forcings with one seed give the
    same field and acceleration bit for bit, through three updates; the
    acceleration's rms is turb_rms."""
    from ramses_tpu_torch.turb.forcing import TurbForcing, TurbSpec
    spec = TurbSpec(enabled=True, seed=7, turb_T=0.5, comp_frac=0.3333)
    a = TurbForcing((64, 64, 64), spec, device=cuda)
    b = TurbForcing((64, 64, 64), spec, device=cuda)
    for dt in (0.01, 0.02, 0.03):
        a.update(dt)
        b.update(dt)
    assert torch.equal(a.fhat, b.fhat)
    acc_a, acc_b = a.acceleration(), b.acceleration()
    assert torch.equal(acc_a, acc_b)
    rms = float(torch.sqrt(torch.mean(torch.sum(acc_a ** 2, dim=0))))
    assert abs(rms - 1.0) < 1e-12


# ---------------------------------------------------------------------------
# cooling: K6 and the cooled uniform step
# ---------------------------------------------------------------------------

def _cooling_cells(n, seed):
    rng = np.random.default_rng(seed)
    return (10 ** rng.uniform(-6, 4, n), 10 ** rng.uniform(1, 8.5, n),
            rng.uniform(0, 1, n))


def _cooling_inputs(cuda, dtype, uv):
    from ramses_tpu_torch.hydro import cooling as pc
    tabs = pc.build_tables(aexp=0.25 if uv else 1.0, J21=1.0 if uv else 0.0,
                           device=cuda)
    nH, T2, z = _cooling_cells(20000, 3)
    boost = np.maximum(np.exp(-nH / 0.01), 1e-20)
    t = [torch.tensor(a, dtype=dtype, device=cuda) for a in (nH, T2, z,
                                                             boost)]
    return tabs, t, torch.tensor(3e15, dtype=dtype, device=cuda)


@pytest.mark.parametrize("uv", [False, True])
def test_cooling_kernel_matches_plain_f64(cuda, uv):
    """K6 against its plain version on the card in f64, 20,000 random
    cells (nH 1e-6..1e4, T2 10..3e8, metallicity, self-shielding boost):
    each cell within rel 1e-10 or, where the plain version's own result
    moves when nH, T2 or dt change by 1 to 64 ulps (a cell that ends next
    to one of the march's decisions), ten times that move; the iteration
    counts equal wherever the result is well conditioned; one launch a
    call, none for a call with no cells."""
    from ramses_tpu_torch.hydro import cooling as pc
    tabs, t, dt_s = _cooling_inputs(cuda, torch.float64, uv)
    before = pc.launches
    got, it_k = pc.solve_cooling(tabs, *t, dt_s, want_iters=True)
    assert pc.launches == before + 1
    empty = t[0][:0]
    pc.solve_cooling(tabs, empty, empty, t[2], 1.0, dt_s)
    assert pc.launches == before + 1       # no cells: nothing launched
    want, it_p = pc.solve_cooling_ref(tabs, *t, dt_s, want_iters=True)
    moves = []
    for i in (0, 1, 4):
        for k in (1, -2, 4, -8, 16, -64):
            args = list(t) + [dt_s]
            args[i] = args[i] * (1 + k * 1.1e-16)
            moves.append((pc.solve_cooling_ref(tabs, *args) - want).abs())
    move = torch.stack(moves).amax(0) / want.abs()
    rel = (got - want).abs() / want.abs()
    tol = torch.clamp(10 * move, min=1e-10)
    assert bool((rel <= tol).all()), (float(rel.max()),
                                      int((rel > 1e-10).sum()))
    well = move <= 1e-11
    assert bool(torch.equal(it_k[well], it_p[well]))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("uv", [False, True])
def test_cooling_kernel_f32_is_as_accurate_as_plain(cuda, uv):
    """K6 in f32 on the same cells, held cell by cell to the plain f32
    version: each cell within rel 2e-5 or, where the plain f32 result
    itself moves when nH, T2 or dt change by 1 to 4 ulps, ten times that
    move, with at most 0.1 % of the cells in that second form (the two
    agree bit for bit on an H100: K6's 10^x is torch.pow's powf, and the
    plain version divides by tensors, not by Python numbers).  The f32
    march departs from the f64 one far past 2e-5 on such cells
    (``chip_smoke.py`` phase 50 reports by how much), so against the f64
    result the kernel is held to the plain f32 version's accuracy: at each
    quantile of the cells' relative error (median, 90 %, 99 %, 99.9 %,
    max) within twice the plain version's plus 1e-6."""
    from ramses_tpu_torch.hydro import cooling as pc
    tabs, t, dt_s = _cooling_inputs(cuda, torch.float32, uv)
    got = pc.solve_cooling(tabs, *t, dt_s)
    plain = pc.solve_cooling_ref(tabs, *t, dt_s)
    moves = []
    for i in (0, 1, 4):
        for k in (1, -1, 2, -2, 4, -4):
            args = list(t) + [dt_s]
            args[i] = args[i] * (1 + k * 2.0 ** -23)
            moves.append((pc.solve_cooling_ref(tabs, *args) - plain).abs())
    move = torch.stack(moves).amax(0) / plain.abs()
    rel = (got - plain).abs() / plain.abs()
    tol = torch.clamp(10 * move, min=2e-5)
    assert bool((rel <= tol).all()), (float(rel.max()),
                                      int((rel > tol).sum()))
    assert int((rel > 2e-5).sum()) <= 1e-3 * rel.numel()
    exact = pc.solve_cooling_ref(tabs, *[a.double() for a in t],
                                 dt_s.double())
    q = torch.tensor([0.5, 0.9, 0.99, 0.999, 1.0], dtype=torch.float64,
                     device=cuda)

    def err(x):
        return torch.quantile((x.double() - exact).abs() / exact.abs(), q)
    ek, ep = err(got), err(plain)
    assert bool((ek <= 2 * ep + 1e-6).all()), (ek.tolist(), ep.tolist())
    assert bool(torch.isfinite(got).all())


COOL_NML = "\n".join([
    "&RUN_PARAMS", "hydro=.true.", "nstepmax=100", "/",
    "&AMR_PARAMS", "levelmin=5", "levelmax=5", "boxlen=1.0", "/",
    "&INIT_PARAMS", "nregion=2", "region_type(1)='square'",
    "region_type(2)='point'", "x_center=0.5,0.5", "y_center=0.5,0.5",
    "z_center=0.5,0.5", "length_x=10.0,1.0", "length_y=10.0,1.0",
    "length_z=10.0,1.0", "exp_region=10.0,10.0", "d_region=1.0,0.0",
    "p_region=1e-5,0.4", "/",
    "&HYDRO_PARAMS", "gamma=1.4", "courant_factor=0.8", "riemann='hllc'",
    "/",
    "&COOLING_PARAMS", "cooling=.true.", "/",
    "&UNITS_PARAMS", "units_density=1.66e-24", "units_time=3.15e13",
    "units_length=3.08e18", "/",
    "&OUTPUT_PARAMS", "noutput=1", "tout=100.0", "/",
])


def test_run_steps_cool_never_waits_and_replays_bitwise(cuda):
    """``run_steps_cool`` on the card at 32³ (K1's scope): after a first
    call that puts the packed tables on the card, two steps with the sync
    debug mode at "error"; K1 and K6's fused entry each once a step (the
    march entry never); four steps run
    twice from one state bitwise equal, finite, with less energy than at
    the start."""
    from ramses_tpu_torch.config import params_from_string
    from ramses_tpu_torch.grid.uniform import run_steps_cool
    from ramses_tpu_torch.hydro import cooling as pc
    sim = Simulation(params_from_string(COOL_NML, ndim=3))
    assert uniform.fused_ok(sim.grid, torch.float32)
    f64 = dict(dtype=torch.float64, device=cuda)
    t0, tend = torch.tensor(0.0, **f64), torch.tensor(1.0, **f64)
    u0 = sim.state.u

    def steps(n):
        return run_steps_cool(sim.grid, u0, t0, tend, n, sim.cool_tables,
                              sim.cool_spec)
    steps(1)
    torch.cuda.synchronize()
    k1, k6, k6m = fm.launches, pc.step_launches, pc.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        steps(2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fm.launches - k1 == 2 and pc.step_launches - k6 == 2
    assert pc.launches == k6m          # the fused entry, not the march
    a, b = steps(4), steps(4)
    assert int(a[2]) == 4 and torch.equal(a[0], b[0]) and torch.equal(a[1],
                                                                      b[1])
    assert bool(torch.isfinite(a[0]).all())
    # the periodic box keeps its energy without cooling
    assert float(a[0][4].sum()) < float(u0[4].sum())


def _cooling_host():
    """``tests/test_torch_cooling_host.py``'s states, cases and gates,
    imported by path (another installed package may own the top-level name
    ``tests``)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_torch_cooling_host.py")
    spec = importlib.util.spec_from_file_location("_cooling_host", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", range(7))
def test_cooling_fused_entry_matches_cooling_step(cuda, dtype, case):
    """K6's fused entry on the card against ``cooling_step_ref`` on the
    same CUDA state (the host test's cases: dense states and a level's
    transposed rows, scales and dt as tensors and numbers, extra
    energies, self-shielding, a T2max clip, a polytrope floor and a given
    per-cell floor), with the host test's gates;
    one launch of the fused entry a call and none of the march, the other
    rows untouched, in place the same bits."""
    from ramses_tpu_torch.hydro import cooling as pc
    from ramses_tpu_torch.hydro.core import HydroStatic
    h = _cooling_host()
    ndim, nener, opts, tensor_scales, tensor_dt, rows = h.STEP[case]
    tabs = pc.build_tables(aexp=0.25, J21=1.0, device=cuda)
    cfg = HydroStatic(ndim=ndim, gamma=5.0 / 3.0, nener=nener)
    spec = h._spec(**opts)
    shape = {1: (20011,), 2: (151, 149), 3: (41, 37, 33)}[ndim]
    u = h._state(shape, ndim, nener, 7 * ndim + nener, dtype).to(cuda)
    if rows:
        u = u.reshape(u.shape[0], -1).t().contiguous().t()
    scales = (torch.tensor([0.9 * h.ISM.scale_T2, 1.1 * h.ISM.scale_nH,
                            h.ISM.scale_t], dtype=dtype, device=cuda)
              if tensor_scales else None)
    dt = (torch.tensor(30.0, dtype=dtype, device=cuda) if tensor_dt
          else 30.0)
    fl = h._given_floor(opts, u)
    n0, m0 = pc.step_launches, pc.launches
    got = pc.cooling_step(u, tabs, spec, dt, cfg, fl, scales)
    assert pc.step_launches == n0 + 1 and pc.launches == m0
    want = pc.cooling_step_ref(u, tabs, spec, dt, cfg, fl, scales)
    e = ndim + 1
    keep = [k for k in range(u.shape[0]) if k != e]
    assert torch.equal(got[keep], u[keep])
    own = u.clone()
    assert pc.cooling_step(own, tabs, spec, dt, cfg, fl, scales,
                           inplace=True) is own
    assert torch.equal(own, got)
    p = pc.cooling_inputs(u, spec, dt, cfg, fl, scales)
    march = [p["nH"], p["T2"], p["zsolar"], p["boost"], p["dt_s"]]
    T2n = pc.solve_cooling_ref(tabs, *march)
    eint = pc.cooling_energy(T2n, p, spec, cfg, scales)
    ks, ulp = (((1, -2, 4, -8, 16, -64), 1.1e-16) if dtype == torch.float64
               else ((1, -1, 2, -2, 4, -4), 2.0 ** -23))
    args = [a.reshape(-1) if torch.is_tensor(a) and a.dim() else a
            for a in march]

    def move(cells):
        return h._move(lambda *a: pc.solve_cooling_ref(tabs, *a), args,
                       T2n.reshape(-1), cells, ks, ulp)
    ulp_e = torch.finfo(dtype).eps * want[e].abs() / eint.abs()
    h._held(got[e], want[e], eint.abs(), move, dtype, slack=2 * ulp_e)


def _regrid_keys(ndim, root, lvl, seed, device):
    """A random regrid's sentinel-padded sorted key arrays at level
    ``lvl`` (new octs on 30 % of the slots, an old level keeping 80 % of
    them plus others, a coarser level with every father plus others) and
    the lvl-1 cell counts."""
    from ramses_tpu_torch.amr import device_regrid as dr
    from ramses_tpu_torch.amr import keys as kmod
    rng = np.random.default_rng(seed)
    dims = tuple(r << (lvl - 1) for r in root)

    def some(shape, p):
        c = np.stack(np.meshgrid(*[np.arange(n) for n in shape],
                                 indexing="ij"), -1).reshape(-1, ndim)
        return c[rng.random(len(c)) < p]
    new = some(dims, 0.3)
    old = np.concatenate([new[rng.random(len(new)) < 0.8], some(dims, 0.1)])
    coarse = np.concatenate([new >> 1, some(tuple(n // 2 for n in dims),
                                            0.2)])
    enc = [np.unique(kmod.encode(c, ndim)) for c in (new, old, coarse)]
    return tuple(dr.upload_keys(k, len(k) + pad, device)
                 for k, pad in zip(enc, (29, 5, 3))) + (dims,)


@pytest.mark.parametrize("ndim,root,lvl,kinds", [
    (1, (1,), 9, ((1, 2),)),
    (2, (1, 1), 8, ((0, 0), (0, 0))),
    (2, (2, 1), 7, ((1, 1), (0, 0))),
    (2, (1, 3), 6, ((2, 2), (0, 2))),
    (3, (1, 1, 1), 6, ((0, 0), (0, 0), (0, 0))),
    (3, (1, 1, 1), 6, ((1, 1), (2, 1), (1, 2))),
    (3, (2, 1, 1), 6, ((0, 0), (1, 1), (2, 2))),
])
def test_regrid_maps_kernel_is_bitwise_plain(cuda, ndim, root, lvl, kinds):
    from ramses_tpu_torch.amr import device_regrid as dr
    new, old, coarse, dims = _regrid_keys(ndim, root, lvl, lvl + ndim, cuda)
    n0 = dr.launches
    got = dr.regrid_maps(new, old, coarse, ndim, kinds, dims)
    want = dr.regrid_maps_ref(new, old, coarse, ndim, kinds, dims)
    torch.cuda.synchronize()
    assert dr.launches == n0 + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.device == w.device
        assert torch.equal(g, w)


@pytest.mark.parametrize("lvl,staged", [(5, True), (6, False)])
def test_regrid_maps_kernel_branches_are_bitwise_plain(cuda, lvl, staged):
    """K7's two branches on the card (3D, mixed faces): old and coarse keys
    staged whole (level 5, also from views 8 bytes into their storage,
    which take 8-byte copies) and the keys read through L1 (level 6,
    ~14,000 keys)."""
    from ramses_tpu_torch.amr import device_regrid as dr
    new, old, coarse, dims = _regrid_keys(3, (1, 1, 1), lvl, 40 + lvl, cuda)
    kinds = ((0, 0), (1, 1), (2, 1))
    assert dr.staged(dr._library(), old.numel(), coarse.numel()) == staged
    for o, c in ((old, coarse), (old[1:], coarse[1:])):
        got = dr.regrid_maps(new, o, c, 3, kinds, dims)
        want = dr.regrid_maps_ref(new, o, c, 3, kinds, dims)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_regrid_maps_kernel_refuses_what_it_does_not_take(cuda):
    from ramses_tpu_torch.amr import device_regrid as dr
    new, old, coarse, dims = _regrid_keys(2, (1, 1), 5, 1, cuda)
    with pytest.raises(ValueError, match="int64"):
        dr.regrid_maps(new.to(torch.int32), old, coarse, 2, ((0, 0),) * 2,
                       dims)
    with pytest.raises(ValueError, match="CUDA device"):
        dr.regrid_maps(new, old.cpu(), coarse, 2, ((0, 0),) * 2, dims)


def test_config2_regrid_is_bitwise_with_device_regrid_on_and_off(cuda):
    """sedov3d with config 2's criteria at levelmin 5 / levelmax 7 (f32,
    the card): from one state, 3 coarse steps a regrid each with
    ``device_regrid`` on (K7 launched) and off (host maps), the trees and
    every level's rows bitwise equal after each regrid."""
    from ramses_tpu_torch.amr import device_regrid as dr
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.convert import amr_state_from
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def params(on):
        p = load_params(os.path.join(ROOT, "namelists", "sedov3d.nml"),
                        ndim=3)
        p.amr.levelmin, p.amr.levelmax = 5, 7
        p.refine.err_grad_d = p.refine.err_grad_p = 0.1
        p.amr.device_regrid = on
        return p
    state = amr_state_from(AmrSim(params(True)))
    sims = {on: AmrSim.from_state(params(on), **state)
            for on in (True, False)}
    k7 = {True: 0, False: 0}
    for _ in range(3):
        for on, s in sims.items():
            n0 = dr.launches
            s.regrid()
            k7[on] += dr.launches - n0
        a, b = sims[True], sims[False]
        assert a.levels() == b.levels()
        for l in a.levels():
            assert np.array_equal(a.tree.levels[l].keys,
                                  b.tree.levels[l].keys)
            assert torch.equal(a.u[l], b.u[l]), l
        for s in (a, b):
            s.step_coarse(s.coarse_dt())
    assert k7[True] > 0 and k7[False] == 0


# ---------------------------------------------------------------------------
# RT: K8 (csrc/rt_m1.cu) and K9 (csrc/rt_chem.cu) against their plain
# versions on the card: K8 within 1e-13 × the field's max over the cell's
# 3^d stencil, K9 within rel 1e-12 (both built without FMA contraction, so
# both agree bit for bit where they call the same libdevice functions)
# ---------------------------------------------------------------------------

def _rt_states():
    """``tests/test_torch_rt_host.py``'s state makers, imported by path
    (another installed package may own the top-level name ``tests``)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_torch_rt_host.py")
    spec = importlib.util.spec_from_file_location("_rt_host_states", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape,ng,periodic,beams", [
    ((33,), 1, True, False), ((33,), 3, False, True),
    ((9, 14), 1, False, False), ((9, 14), 3, True, True),
    ((5, 7, 6), 1, True, True), ((6, 5, 9), 3, False, False),
    ((1, 4, 3), 2, True, False), ((37, 29, 41), 1, True, False),
    # ragged against K8's staged tiles, or fewer than three x planes
    ((300,), 1, True, True), ((513,), 3, False, False),
    ((19, 45), 3, True, False), ((33, 8), 1, False, True),
    ((1, 9, 33), 1, True, True), ((2, 9, 33), 3, False, False),
    ((2, 17, 65), 1, True, False), ((7, 37, 41), 3, True, True),
    ((7, 37, 41), 1, False, True), ((4, 2, 3), 2, True, False)])
def test_rt_m1_dense_kernel_matches_plain(cuda, shape, ng, periodic, beams):
    from ramses_tpu_torch.rt import m1
    h = _rt_states()
    dense_close, rt_state = h.dense_close, h.rt_state
    nd, c_red = len(shape), 3e7
    U, src, srcF = [None if t is None else t.to(cuda)
                    for t in rt_state(shape, ng, c_red, 7 * ng + nd, beams)]
    dt, dx = 0.8 * 3e19 / 3.0 / c_red, 3e19
    n0 = m1.launches
    got = m1.transport(U, dt, dx, c_red, nd, periodic, src, srcF)
    assert m1.launches == n0 + 1
    want = m1.transport_ref(U, dt, dx, c_red, nd, periodic, src, srcF)
    dense_close(got, want, nd, periodic)


@pytest.mark.parametrize("nd,ng,noct", [(1, 1, 7), (2, 3, 500), (3, 1, 11),
                                        (3, 2, 3000), (3, 1, 45), (3, 3, 33),
                                        (2, 2, 130), (1, 3, 300),
                                        (3, 1, 70001)])
def test_rt_m1_block_kernel_matches_plain(cuda, nd, ng, noct):
    from ramses_tpu_torch.rt import m1
    blk = _rt_states()._blocks(nd, ng, noct, 5 * nd + ng, 3e7).to(cuda)
    rad = torch.rand((noct * 2 ** nd + 5, ng * (1 + nd)), dtype=torch.float64,
                     device=cuda)
    dt, dx = 0.8 * 3e19 / 3.0 / 3e7, 3e19
    n0 = m1.block_launches
    got = m1.block_update(rad, blk, dt, dx, 3e7, nd, ng)
    assert m1.block_launches == n0 + 1
    want = m1.block_update_ref(rad, blk, dt, dx, 3e7, nd, ng)
    scale = want.abs().amax(dim=0, keepdim=True)
    assert bool(((got - want).abs() <= 1e-13 * scale).all())
    assert torch.equal(got[noct * 2 ** nd:], rad[noct * 2 ** nd:])


@pytest.mark.parametrize("shape,periodic", [((7, 9, 33), True),
                                            ((5, 10, 40), False),
                                            ((64, 33, 70), True)])
def test_rt_m1_dense_kernel_chunk_cuts_are_bitwise(cuda, shape, periodic):
    """Copies of one group give the bits of the group alone, on the card:
    the launch cuts the x planes into as many chunks as keep every block
    resident, so 1 to 128 groups march chunks of one plane up to the
    whole box."""
    from ramses_tpu_torch.rt import m1
    h = _rt_states()
    c_red = 3e7
    U, src, srcF = [t.to(cuda) for t in h.rt_state(shape, 1, c_red, 5,
                                                   True)]
    dt, dx = 0.8 * 3e19 / 3.0 / c_red, 3e19
    one = m1.transport(U, dt, dx, c_red, 3, periodic, src, srcF)
    for ng in (2, 8, 32, 128):
        got = m1.transport(U.repeat(ng, 1, 1, 1, 1), dt, dx, c_red, 3,
                           periodic, src.repeat(ng, 1, 1, 1),
                           srcF.repeat(ng, 1, 1, 1, 1))
        assert all(torch.equal(g, one[0]) for g in got), ng
    want = m1.transport_ref(U, dt, dx, c_red, 3, periodic, src, srcF)
    h.dense_close(one, want, 3, periodic)


def _k9_rel(got, want):
    rel = ((got - want).abs() / want.abs()).nan_to_num(0.0)
    assert bool((rel <= 1e-12).all()), float(rel.max())


@pytest.mark.parametrize("uv,heating", [(False, True), (True, True),
                                        (True, False)])
def test_rt_chem_gray_kernel_matches_plain(cuda, uv, heating):
    from ramses_tpu_torch.rt import chem
    h = _rt_states()
    N, x, _, _, T, nH = [t.to(cuda) for t in h.chem_cells(100003, 11)]
    uvv = h._uv() if uv else None
    want = chem.chem_step_ref(N[0], x, T, nH, 3e10, 3e7, chem.GroupSpec(),
                              heating=heating, uv=uvv)
    rows = torch.zeros((N.shape[1], 4), dtype=torch.float64, device=cuda)
    rows[:, 0] = N[0]
    n0 = chem.launches
    got = chem.chem_gray(rows[:, 0], x, T, nH, 3e10, 3e7, chem.GroupSpec(),
                         heating=heating, uv=uvv)
    assert chem.launches == n0 + 1
    for g, w in zip((rows[:, 0],) + got, want):
        _k9_rel(g, w)


@pytest.mark.parametrize("ng,uv,heating", [(1, False, True), (3, True, True),
                                           (2, False, False),
                                           (8, True, True)])
def test_rt_chem_3ion_kernel_matches_plain(cuda, ng, uv, heating):
    from ramses_tpu_torch.rt import chem, spectra
    h = _rt_states()
    N, x, xhe2, xhe3, T, nH = [t.to(cuda) for t in h.chem_cells(50021,
                                                                13 + ng, ng)]
    nHe = nH * 0.08
    groups = spectra.blackbody_groups(1e5, list(np.geomspace(13.6, 1e3,
                                                             ng + 1)))
    uvv = h._uv() if uv else None
    want = chem.chem_step_3ion_ref(list(N), (x, xhe2, xhe3), T, nH, nHe,
                                   1e11, 3e7, groups, heating=heating,
                                   uv=uvv)
    he = torch.stack([xhe2, xhe3], dim=1)
    n0 = chem.launches
    Nv = N.clone()
    got = chem.chem_3ion(Nv, x, he[:, 0], he[:, 1], T, nH, nHe, 1e11, 3e7,
                         groups, heating=heating, uv=uvv)
    assert chem.launches == n0 + 1
    for g in range(ng):
        _k9_rel(Nv[g], want[0][g])
    for g, w in zip(got, list(want[1]) + [want[2]]):
        _k9_rel(g, w)


def test_rt_kernels_refuse_what_they_do_not_take(cuda):
    from ramses_tpu_torch.rt import chem, m1
    U = torch.zeros((1, 4, 4, 4, 4), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="float64"):
        m1.transport(U, 1.0, 1.0, 1.0, 3)
    x = torch.zeros(8, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="contiguous float64"):
        chem.chem_gray(x, x, x.cpu(), x, 1.0, 1.0, chem.GroupSpec())


@pytest.mark.parametrize("full3,beams", [(False, False), (True, True)])
def test_rt_substeps_never_wait_on_the_host(cuda, full3, beams):
    """An RtSim advance is nsub × (K8, K9) queued on the card: no host
    synchronisation (sync debug mode "error" raises at one)."""
    from ramses_tpu_torch.rt import driver as rtd
    from ramses_tpu_torch.rt import m1, spectra
    kw = dict(groups3=spectra.blackbody_groups(1e5, spectra.DEFAULT_BOUNDS),
              y_he=0.24) if full3 else {}
    spec = rtd.RtSpec(ndim=3, c_fraction=1e-3, **kw)
    n, dx = 32, 1e19
    sim = rtd.RtSim((n,) * 3, dx, spec, nH=np.full((n,) * 3, 1e-2),
                    device=cuda)
    sim.point_source((n * dx / 2,) * 3, 5e48,
                     direction=(1.0, 0.0, 0.0) if beams else None)
    dt = m1.rt_courant_dt(dx, spec.c_red, spec.courant)
    sim.advance(2 * dt)                # loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert sim.advance(20 * dt) == 20
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(sim.U).all())


def test_rt_hierarchy_advance_never_waits_on_the_host(cuda):
    """``RtAmrCoupled.advance`` with the point source on a 4/5 hierarchy
    (f32 gas): the substeps' transport on both entries, the chemistry, the
    restriction and the heating write-back queue without a host sync."""
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.config import params_from_dict
    g = {"run_params": {"hydro": True, "rt": True},
         "amr_params": {"levelmin": 4, "levelmax": 5, "boxlen": 1.0},
         "init_params": {"nregion": 1, "region_type": ["square"],
                         "x_center": [0.5], "y_center": [0.5],
                         "z_center": [0.5], "length_x": [10.0],
                         "length_y": [10.0], "length_z": [10.0],
                         "exp_region": [10.0], "d_region": [10.0],
                         "p_region": [1e-4]},
         "hydro_params": {"gamma": 5.0 / 3.0},
         "rt_params": {"rt_ndot": 1e44, "rt_c_fraction": 1e-4,
                       "rt_src_pos": [0.5, 0.5, 0.5]},
         "refine_params": {"r_refine": [0.15] * 8, "x_refine": [0.5] * 8,
                           "y_refine": [0.5] * 8, "z_refine": [0.5] * 8},
         "units_params": {"units_density": 1.66e-24,
                          "units_time": 3.15e13, "units_length": 3.08e18}}
    sim = AmrSim(params_from_dict(g, ndim=3))
    assert sim.tree.noct(5) > 0
    sim.rt_amr.advance(sim, 1e-5)      # loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nsub = sim.rt_amr.advance(sim, 2e-3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert nsub > 1
    for l in sim.levels():
        assert bool(torch.isfinite(sim.rt_amr.rad[l]).all())


@pytest.mark.parametrize("shape,kind", [((300,), "plateau"),
                                        ((40, 27), "random"),
                                        ((20, 17, 24), "smooth"),
                                        ((64, 64, 64), "plateau"),
                                        ((1, 5, 2), "random")])
def test_watershed_kernel_is_bitwise_plain(cuda, shape, kind):
    """K10 against ``watershed_ref`` on the card: labels bitwise, at
    thresholds that cut off none, half and nearly all of the cells."""
    from ramses_tpu_torch.pm import clumps
    from test_torch_clumps_host import field, thresholds
    host = field(kind, shape, len(shape))
    rho = torch.tensor(host, dtype=torch.float64, device=cuda)
    for thr in thresholds(host):
        n0 = clumps.launches
        got = clumps.watershed(rho, thr, len(shape))
        want = clumps.watershed_ref(rho, thr, len(shape))
        torch.cuda.synchronize()
        assert clumps.launches == n0 + 1
        assert got.dtype == want.dtype == torch.int64
        assert got.device == rho.device and torch.equal(got, want)


@pytest.mark.parametrize("shape,kind", [((5, 11, 37), "random"),
                                        ((9, 17, 70), "peak"),
                                        ((33, 65), "plateau"),
                                        ((2, 33, 1), "flat"),
                                        ((3000,), "steps")])
def test_watershed_kernel_tiles_and_wide_are_bitwise_plain(cuda, shape,
                                                            kind):
    """K10 on the card on grids its tiles do not divide, chains across
    tiles and thin axes, through both instantiations (32-bit, and the
    64-bit one through ``ramses_watershed_wide``): labels bitwise."""
    from ramses_tpu_torch.pm import clumps
    from test_torch_clumps_host import field, thresholds
    host = field(kind, shape, len(shape))
    rho = torch.tensor(host, dtype=torch.float64, device=cuda)
    lib = clumps._library()
    stream = torch.cuda.current_stream().cuda_stream
    for thr in thresholds(host):
        want = clumps.watershed_ref(rho, thr, len(shape))
        for wide in (False, True):
            got = clumps.call(lib, rho, thr, len(shape), stream, wide)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (thr, wide)


def test_watershed_kernel_refuses_what_it_does_not_take(cuda):
    from ramses_tpu_torch.pm import clumps
    with pytest.raises(ValueError, match="float64"):
        clumps.watershed(torch.ones((4, 4), dtype=torch.float32,
                                    device=cuda), 0.5, 2)
    with pytest.raises(ValueError, match="ndim"):
        clumps.watershed(torch.ones((4, 4), dtype=torch.float64,
                                    device=cuda), 0.5, 3)
    n0 = clumps.launches
    empty = clumps.watershed(torch.ones((0, 4), dtype=torch.float64,
                                        device=cuda), 0.5, 2)
    assert empty.shape == (0, 4) and clumps.launches == n0
