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
