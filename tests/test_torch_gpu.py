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
