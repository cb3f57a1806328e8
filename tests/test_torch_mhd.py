"""Parity of the port's uniform MHD solver with the JAX package in f64.

Same seeded numpy inputs through ``ramses_tpu.mhd`` and
``ramses_tpu_torch.mhd`` (CPU tensors): the state conversions and wave
speeds, every 1D Riemann solver (llf, hll, hlld, roe, upwind), every 2D
corner solver, the CT step (``step_padded``) in 1D, 2D and 3D with and
without the refined mask and the EMF override, and whole runs through
``MhdSimulation`` (Orszag-Tang 32², ``namelists/tube_mhd.nml``, a 3D
solenoidal field).  Both sides run the same algorithm in the same order,
so single calls agree to 1e-12 relative; Roe's batched 7x7 solve goes
through two LAPACK calls and is held to 1e-10; runs of many steps to
1e-10.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.config import load_params as jload_params  # noqa: E402
from ramses_tpu.config import params_from_dict as jparams  # noqa: E402
from ramses_tpu.mhd import core as jcore  # noqa: E402
from ramses_tpu.mhd import riemann as jriemann  # noqa: E402
from ramses_tpu.mhd import riemann2d as jr2d  # noqa: E402
from ramses_tpu.mhd import roe as jroe  # noqa: E402
from ramses_tpu.mhd import uniform as jmu  # noqa: E402
from ramses_tpu.mhd.core import MhdStatic as JMhdStatic  # noqa: E402
from ramses_tpu.mhd.driver import MhdSimulation as JMhdSimulation  # noqa: E402

from ramses_tpu_torch.config import load_params, params_from_dict  # noqa: E402
from ramses_tpu_torch.convert import mhd_state_from, mhd_static_from  # noqa: E402
from ramses_tpu_torch.driver import Simulation, run_namelist  # noqa: E402
from ramses_tpu_torch.mhd import core, riemann, riemann2d, roe  # noqa: E402
from ramses_tpu_torch.mhd import ct_slab, uniform as mu  # noqa: E402
from ramses_tpu_torch.mhd.core import IBX, IP, MhdStatic  # noqa: E402
from ramses_tpu_torch.mhd.driver import MhdSimulation, mhd_condinit  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUBE = os.path.join(ROOT, "namelists", "tube_mhd.nml")
OT_NML = os.path.join(ROOT, "namelists", "orszag2d.nml")
RTOL = 1e-12
RUN_RTOL = 1e-10


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _field_close(got, want, rtol, atol=1e-20):
    """Each field within ``rtol`` of its own max magnitude (fields that
    cross zero, such as momenta, have no meaningful pointwise rtol); the
    atol admits fields that are rounding noise around zero on both sides
    (the z momentum of the 1D tube reads 1e-29)."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= rtol * scale + atol


def _cfg(**kw):
    jc = JMhdStatic(**kw)
    return jc, mhd_static_from(jc)


def _prims(shape, seed):
    """Random primitive MHD states [8, *shape]."""
    rng = np.random.default_rng(seed)
    q = np.empty((8,) + tuple(shape))
    q[0] = 0.5 + rng.random(shape)
    q[1:4] = 0.5 * rng.standard_normal((3,) + tuple(shape))
    q[4] = 0.1 + rng.random(shape)
    q[5:8] = 0.7 * rng.standard_normal((3,) + tuple(shape))
    return q


def _padded(nd, shape, seed, masked):
    """(up, bfp_ext, okp, ovr) of a random padded box as numpy."""
    rng = np.random.default_rng(seed)
    sp = tuple(n + 4 for n in shape)
    spe = tuple(n + 6 for n in shape)
    q = _prims(sp, seed)
    cfg = JMhdStatic(ndim=nd)
    up = np.array(jcore.prim_to_cons(jnp.asarray(q), cfg))
    bfp = 0.5 * rng.standard_normal((3,) + spe)
    okp = ovr = None
    if masked:
        okp = rng.random(sp) < 0.2
        ovr = {(a, b): (rng.random(sp) < 0.3, 0.1 * rng.standard_normal(sp))
               for a in range(nd) for b in range(a + 1, nd)}
    return up, bfp, okp, ovr


def test_from_params_refuses_unknown_solvers():
    p = load_params(TUBE, ndim=1)
    p.hydro.riemann = "exact"
    with pytest.raises(NotImplementedError, match="riemann='exact'"):
        MhdStatic.from_params(p)
    p = load_params(TUBE, ndim=1)
    p.hydro.riemann2d = "bogus"
    with pytest.raises(NotImplementedError, match="riemann2d='bogus'"):
        MhdStatic.from_params(p)
    p = load_params(TUBE, ndim=1)
    assert MhdStatic.from_params(p) == mhd_static_from(
        JMhdStatic.from_params(jload_params(TUBE, ndim=1)))


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_core_parity(nd):
    jc, c = _cfg(ndim=nd)
    shape = {1: (16,), 2: (8, 6), 3: (5, 4, 6)}[nd]
    u = np.asarray(jcore.prim_to_cons(jnp.asarray(_prims(shape, nd)), jc))
    ut = torch.tensor(u)
    _close(core.ctoprim(ut, c), jcore.ctoprim(jnp.asarray(u), jc))
    _close(core.prim_to_cons(ut, c), jcore.prim_to_cons(jnp.asarray(u), jc))
    for d in range(3):
        _close(core.fast_speed(ut, d, c),
               jcore.fast_speed(jnp.asarray(u), d, jc))
        _close(core.flux_along(ut, d, c),
               jcore.flux_along(jnp.asarray(u), d, jc), atol=1e-15)
    bf = np.random.default_rng(7).standard_normal((3,) + shape)
    for got, want in zip(core.cell_center_b(list(torch.tensor(bf)), nd),
                         jcore.cell_center_b(list(jnp.asarray(bf)), nd)):
        _close(got, want)
    dx = [0.1, 0.2, 0.3][:nd]
    _close(core.div_b(list(torch.tensor(bf)), dx, nd),
           jcore.div_b(list(jnp.asarray(bf)), dx, nd), atol=1e-14)


@pytest.mark.parametrize("solver", ["llf", "hll", "hlld", "roe", "upwind"])
def test_riemann_1d_parity(solver):
    jc, c = _cfg(ndim=3, riemann=solver)
    n = 64
    ql, qr = _prims((n,), 1), _prims((n,), 2)
    bn = 0.7 * np.random.default_rng(3).standard_normal(n)
    bn[:4] = 0.0                 # sign(0) = 0 on both sides
    qr[:, 4:8] = ql[:, 4:8]      # contacts and shears: a few equal states
    got = riemann.solve(torch.tensor(ql), torch.tensor(qr), torch.tensor(bn),
                        c)
    want = jriemann.solve(jnp.asarray(ql), jnp.asarray(qr), jnp.asarray(bn),
                          jc)
    rtol = RUN_RTOL if solver == "roe" else RTOL
    _close(got, want, rtol=rtol, atol=1e-13)


@pytest.mark.parametrize("kind", ["llf", "roe", "upwind", "hll", "hlla",
                                  "hlld"])
def test_corner_emf_parity(kind):
    jc, c = _cfg(ndim=2, riemann2d=kind)
    n = 48
    rng = np.random.default_rng(11)
    states = {}
    for i, k in enumerate(jr2d.QUADS):
        q = _prims((n,), 20 + i)
        states[k] = (q[0], q[4], q[1], q[2], q[3], q[7])
    fields = 0.6 * rng.standard_normal((4, n))
    got = riemann2d.corner_emf(
        {k: tuple(torch.tensor(x) for x in s) for k, s in states.items()},
        *torch.tensor(fields), c)
    want = jr2d.corner_emf(
        {k: tuple(jnp.asarray(x) for x in s) for k, s in states.items()},
        *jnp.asarray(fields), jc)
    rtol = RUN_RTOL if kind == "roe" else RTOL
    _close(got, want, rtol=rtol, atol=1e-13)


def test_roe_pieces_parity():
    jc, c = _cfg(ndim=3, riemann="roe")
    ql, qr = _prims((32,), 5), _prims((32,), 6)
    bn = 0.5 * np.random.default_rng(8).standard_normal(32)
    args = (torch.tensor(ql), torch.tensor(qr), torch.tensor(bn))
    jargs = (jnp.asarray(ql), jnp.asarray(qr), jnp.asarray(bn))
    m, jm = roe.roe_mean(*args, c.gamma), jroe.roe_mean(*jargs, jc.gamma)
    for key in ("d", "h", "a", "cf", "cs", "ca", "alf", "als", "s"):
        _close(m[key], jm[key])
    lam, R = roe._right_eigenvectors(m)
    jlam, jR = jroe._right_eigenvectors(jm)
    _close(lam, jlam)
    _close(R, jR, atol=1e-14)
    for f, jf in ((roe.llf_dissipation, jroe.llf_dissipation),
                  (roe.upwind_dissipation, jroe.upwind_dissipation),
                  (roe.roe_dissipation, jroe.roe_dissipation)):
        _close(f(*args, c), jf(*jargs, jc), rtol=RUN_RTOL, atol=1e-13)


# (ndim, riemann, riemann2d): the kernel's scope and the torch formulation's
STEP_CASES = [(1, "roe", "average"), (1, "hlld", "average"),
              (2, "hlld", "llf"), (2, "llf", "average"), (2, "roe", "hlld"),
              (2, "upwind", "hll"), (3, "hll", "llf"), (3, "hlld", "average"),
              (3, "llf", "hlla"), (3, "hlld", "roe")]


@pytest.mark.parametrize("nd,solver,corner", STEP_CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_step_padded_parity(nd, solver, corner, masked):
    jc, c = _cfg(ndim=nd, riemann=solver, riemann2d=corner, slope_type=2)
    shape = {1: (12,), 2: (8, 6), 3: (4, 5, 3)}[nd]
    up, bfp, okp, ovr = _padded(nd, shape, 31 + nd, masked)
    dx = (1.0 / 16,) * nd
    dt = 2e-3
    jun, jbfn = jmu.step_padded(
        jc, dx, jnp.asarray(up), jnp.asarray(bfp), jnp.asarray(dt),
        okp=None if okp is None else jnp.asarray(okp),
        ovr=None if ovr is None else {
            k: (jnp.asarray(m), jnp.asarray(v)) for k, (m, v) in ovr.items()})
    un, bfn = mu.step_padded(
        c, dx, torch.tensor(up), torch.tensor(bfp),
        torch.tensor(dt, dtype=torch.float64),
        okp=None if okp is None else torch.tensor(okp),
        ovr=None if ovr is None else {
            k: (torch.tensor(m), torch.tensor(v)) for k, (m, v) in ovr.items()})
    inner = tuple([slice(None)] + [slice(2, -2)] * nd)
    rtol = RUN_RTOL if "roe" in (solver, corner) else RTOL
    _field_close(un[inner], np.asarray(jun)[inner], rtol)
    _field_close(torch.stack(bfn)[inner], np.stack(jbfn)[inner], rtol)
    # the CT kernel's plain version is this step on the interior
    ku, kb = ct_slab.ct_step_slab_ref(
        torch.tensor(up), torch.tensor(bfp), dt, dx, c,
        okp=None if okp is None else torch.tensor(okp),
        ovr=None if ovr is None else {
            k: (torch.tensor(m), torch.tensor(v)) for k, (m, v) in ovr.items()})
    assert torch.equal(ku, un[inner]) and torch.equal(kb, torch.stack(bfn)[inner])


def test_ct_core_options_parity():
    """``bn_faces`` and ``flux_mask`` of ``ct_core`` (the AMR stencil
    options): the fluxes and edge EMFs it returns agree too."""
    jc, c = _cfg(ndim=2, riemann="hlld", riemann2d="average")
    up, bfp, okp, _ = _padded(2, (6, 6), 5, True)
    rng = np.random.default_rng(9)
    sp = up.shape[1:]
    bcell = np.asarray(jcore.cell_center_b(
        list(jnp.asarray(bfp[:, 1:-1, 1:-1])), 2))
    up[IBX:IBX + 3] = bcell
    faces = bfp[:, 1:-1, 1:-1]
    bn = faces + 1e-3 * rng.standard_normal(faces.shape)
    mask = [(rng.random(sp) < 0.8).astype(float) for _ in range(2)]
    dx = (0.1, 0.1)
    jout = jmu.ct_core(jnp.asarray(up), list(jnp.asarray(faces)),
                       jnp.asarray(1e-3), dx, jc,
                       bn_faces=list(jnp.asarray(bn)),
                       flux_mask=[jnp.asarray(m) for m in mask])
    out = mu.ct_core(torch.tensor(up), list(torch.tensor(faces)),
                     torch.tensor(1e-3, dtype=torch.float64), dx, c,
                     bn_faces=list(torch.tensor(bn)),
                     flux_mask=[torch.tensor(m) for m in mask])
    inner = (slice(None), slice(2, -2), slice(2, -2))
    _field_close(out[0][inner], np.asarray(jout[0])[inner], RTOL)
    for got, want in zip(out[1], jout[1]):
        _close(got[2:-2, 2:-2], np.asarray(want)[2:-2, 2:-2], atol=1e-14)
    for got, want in zip(out[2], jout[2]):
        _field_close(got[inner], np.asarray(want)[inner], RTOL)
    _close(out[3][(0, 1)][2:-2, 2:-2],
           np.asarray(jout[3][(0, 1)])[2:-2, 2:-2], atol=1e-14)


def test_condinit_and_cfl_dt_parity():
    p, jp = load_params(TUBE, ndim=1), jload_params(TUBE, ndim=1)
    jsim = JMhdSimulation(jp, dtype=jnp.float64)
    sim = MhdSimulation(p, dtype=torch.float64, device="cpu")
    _close(sim.u, jsim.u)
    _close(sim.bf, jsim.bf)
    jgrid = jsim.grid
    _close(mu.cfl_dt(sim.grid, sim.u, sim.bf),
           jmu.cfl_dt(jgrid, jsim.u, jsim.bf))
    shape = (6, 5)
    q = _prims(shape, 4)
    u = np.asarray(jcore.prim_to_cons(jnp.asarray(q), JMhdStatic(ndim=2)))
    bf = 0.4 * np.random.default_rng(1).standard_normal((3,) + shape)
    jc, c = _cfg(ndim=2)
    jg = jmu.MhdGrid(cfg=jc, shape=shape, dx=0.2, bc_kinds=((0, 0), (0, 0)))
    g = mu.MhdGrid(cfg=c, shape=shape, dx=0.2, bc_kinds=((0, 0), (0, 0)))
    _close(mu.cfl_dt(g, torch.tensor(u), torch.tensor(bf)),
           jmu.cfl_dt(jg, jnp.asarray(u), jnp.asarray(bf)))
    u0, bf0 = mhd_condinit((256,), sim.dx, p, sim.cfg)
    assert u0.dtype == np.float64 and bf0.shape == (3, 256)


def _pair_runs(jsim, sim, nsteps):
    jsim.evolve(nstepmax=nsteps, chunk=nsteps)
    sim.evolve(nstepmax=nsteps)
    assert sim.nstep == jsim.nstep == nsteps
    assert sim.t == pytest.approx(jsim.t, rel=1e-13)
    _field_close(sim.u, jsim.u, RUN_RTOL)
    _field_close(sim.bf, jsim.bf, RUN_RTOL)


def _ot_state(n):
    """Orszag-Tang at n² as ``tests/test_mhd.py::_orszag_tang`` builds it:
    (u, bf) with faces from the corner vector potential."""
    dx = 1.0 / n
    gamma = 5.0 / 3.0
    d0 = 25.0 / (36.0 * np.pi)
    p0 = 5.0 / (12.0 * np.pi)
    b0 = 1.0 / np.sqrt(4.0 * np.pi)
    xc = (np.arange(n) + 0.5) * dx
    X, Y = np.meshgrid(xc, xc, indexing="ij")
    vx, vy = -np.sin(2 * np.pi * Y), np.sin(2 * np.pi * X)
    xf = np.arange(n) * dx
    Xf, Yf = np.meshgrid(xf, xf, indexing="ij")
    Az = (b0 / (4 * np.pi) * np.cos(4 * np.pi * Xf)
          + b0 / (2 * np.pi) * np.cos(2 * np.pi * Yf))
    bfx = (np.roll(Az, -1, 1) - Az) / dx
    bfy = -(np.roll(Az, -1, 0) - Az) / dx
    bf = np.stack([bfx, bfy, np.zeros((n, n))])
    bcx = 0.5 * (bfx + np.roll(bfx, -1, 0))
    bcy = 0.5 * (bfy + np.roll(bfy, -1, 1))
    u = np.zeros((8, n, n))
    u[0] = d0
    u[1], u[2] = d0 * vx, d0 * vy
    u[IBX], u[IBX + 1] = bcx, bcy
    u[IP] = (p0 / (gamma - 1.0) + 0.5 * d0 * (vx ** 2 + vy ** 2)
             + 0.5 * (bcx ** 2 + bcy ** 2))
    return u, bf


def _ot_groups(level):
    return {
        "run_params": {"hydro": True},
        "amr_params": {"levelmin": level, "levelmax": level,
                       "boxlen": 1.0},
        "init_params": {"nregion": 1, "region_type": ["square"],
                        "x_center": [0.5], "y_center": [0.5],
                        "length_x": [10.0], "length_y": [10.0],
                        "exp_region": [10.0], "d_region": [1.0],
                        "p_region": [1.0], "A_region": [0.0]},
        "hydro_params": {"gamma": 5.0 / 3.0, "riemann": "hlld",
                         "courant_factor": 0.8, "riemann2d": "llf"},
        "output_params": {"tend": 0.5},
    }


def test_orszag_tang_32_matches_jax():
    """Orszag-Tang at 32² for 10 steps (hlld, llf corners), f64."""
    groups = _ot_groups(5)
    jsim = JMhdSimulation(jparams(groups, ndim=2), dtype=jnp.float64)
    u, bf = _ot_state(32)
    jsim.u, jsim.bf = jnp.asarray(u), jnp.asarray(bf)
    sim = MhdSimulation.from_state(params_from_dict(groups, ndim=2), u, bf,
                                   device="cpu")
    assert sim.dtype == torch.float64
    m0 = float(sim.totals()["mass"])
    _pair_runs(jsim, sim, 10)
    assert float(sim.max_divb()) * sim.dx < 1e-13
    assert float(sim.totals()["mass"]) == pytest.approx(m0, rel=1e-13)
    back = MhdSimulation.from_state(sim.params, device="cpu",
                                    **mhd_state_from(jsim))
    assert back.nstep == 10 and torch.equal(back.u, torch.tensor(
        np.asarray(jsim.u)))


def test_tube_mhd_matches_jax():
    """``namelists/tube_mhd.nml`` (1D, 256 cells, Roe, outflow) for 20
    steps, f64: the same steps, the same time, the same state."""
    jsim = JMhdSimulation(jload_params(TUBE, ndim=1), dtype=jnp.float64)
    sim = MhdSimulation(load_params(TUBE, ndim=1), dtype=torch.float64,
                        device="cpu")
    assert sim.grid.shape == (256,) and sim.grid.bc_kinds == ((2, 2),)
    # in f32 the tube runs through K4; this f64 run takes step_padded
    assert ct_slab.supports(sim.cfg, sim.grid.shape, torch.float32)
    assert not ct_slab.supports(sim.cfg, sim.grid.shape, torch.float64)
    bx0 = sim.bf[0].clone()
    _pair_runs(jsim, sim, 20)
    assert torch.equal(sim.bf[0], bx0)        # 1D CT leaves Bx untouched
    assert bool(torch.isfinite(sim.u).all())


def test_solenoidal_3d_matches_jax():
    """A random solenoidal field in 3D at 8³ for 3 steps (hlld, llf
    corners), as ``tests/test_mhd.py::test_divb_zero_3d_random_field``
    builds it: div B stays below 1e-10."""
    groups = _ot_groups(3)
    groups["init_params"].update(
        z_center=[0.5], length_z=[10.0], u_region=[0.5], v_region=[-0.3],
        w_region=[0.2], A_region=[0.3], B_region=[0.4], C_region=[0.5])
    jsim = JMhdSimulation(jparams(groups, ndim=3), dtype=jnp.float64)
    sim = MhdSimulation(params_from_dict(groups, ndim=3),
                        dtype=torch.float64, device="cpu")
    n, dx = 8, sim.dx
    rng = np.random.default_rng(0)
    ax, ay, az = rng.standard_normal((3, n, n, n))
    bfx = (np.roll(az, -1, 1) - az) / dx - (np.roll(ay, -1, 2) - ay) / dx
    bfy = (np.roll(ax, -1, 2) - ax) / dx - (np.roll(az, -1, 0) - az) / dx
    bfz = (np.roll(ay, -1, 0) - ay) / dx - (np.roll(ax, -1, 1) - ax) / dx
    bf = np.stack([bfx, bfy, bfz]) * 0.05
    u = sim.u.numpy().copy()
    bc = jcore.cell_center_b(list(jnp.asarray(bf)), 3)
    for c in range(3):
        u[IBX + c] = np.asarray(bc[c])
    u[IP] = 1.0 / (5.0 / 3.0 - 1.0) + 0.5 * (
        u[1] ** 2 + u[2] ** 2 + u[3] ** 2) / u[0] + 0.5 * sum(
        np.asarray(b) ** 2 for b in bc)
    jsim.u, jsim.bf = jnp.asarray(u), jnp.asarray(bf)
    sim.u, sim.bf = torch.tensor(u), torch.tensor(bf)
    _pair_runs(jsim, sim, 3)
    assert float(sim.max_divb()) < 1e-10


def test_run_steps_masks_past_tend():
    """``run_steps`` clips the last dt onto ``tend`` and leaves the state
    alone after it, with the step count on the device."""
    sim = MhdSimulation(load_params(TUBE, ndim=1), dtype=torch.float64,
                        device="cpu")
    dt0 = float(mu.cfl_dt(sim.grid, sim.u, sim.bf))
    tend = 1.5 * dt0
    u, bf, t, ndone = mu.run_steps(sim.grid, sim.u, sim.bf, 0.0, tend, 4)
    assert int(ndone) == 2 and float(t) == pytest.approx(tend, rel=1e-14)
    u2, bf2, t2, n2 = mu.run_steps(sim.grid, u, bf, t, tend, 2)
    assert int(n2) == 0 and torch.equal(u2, u) and torch.equal(bf2, bf)


def test_cli_runs_mhd_on_cpu(tmp_path):
    text = open(TUBE).read().replace("nremap=0", "nremap=0\nnstepmax=5")
    nml = tmp_path / "tube_mhd_5.nml"
    nml.write_text(text)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "ramses_tpu_torch", str(nml), "--ndim", "1",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["5"]
    assert "divb=" in lines[0]
    assert lines[-1].startswith("totals: ") and "nstep=5" in lines[-1]
    assert "max|divB|=" in lines[-1]


def test_solver_dispatch_and_refusals():
    sim = run_namelist(TUBE, ndim=1, device="cpu", nstepmax=2,
                       dtype=torch.float64)
    assert isinstance(sim, MhdSimulation) and sim.nstep == 2
    # orszag2d.nml runs the MHD AMR hierarchy (levelmax > levelmin)
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.mhd.amr import MhdAmrSim
    sim = run_namelist(OT_NML, ndim=2, device="cpu", nstepmax=1)
    assert isinstance(sim, MhdAmrSim) and sim.nstep == 1
    with pytest.raises(NotImplementedError, match="MhdAmrSim"):
        MhdSimulation(load_params(OT_NML, ndim=2), device="cpu")
    with pytest.raises(NotImplementedError, match="MhdAmrSim"):
        AmrSim(load_params(OT_NML, ndim=2), device="cpu")
    with pytest.raises(NotImplementedError, match="MhdSimulation"):
        Simulation(load_params(TUBE, ndim=1), device="cpu")
    with pytest.raises(ValueError, match="solver"):
        run_namelist(TUBE, ndim=1, device="cpu", solver="rhd")
    for key, value, name in (("max_step_retries", 2, "step guard"),
                             ("step_deadline_s", 5.0, "watchdog"),
                             ("fault_inject", "nan@3", "fault injection")):
        p = load_params(TUBE, ndim=1)
        setattr(p.run, key, value)
        with pytest.raises(NotImplementedError, match=name):
            MhdSimulation(p, device="cpu")
    p = load_params(TUBE, ndim=1)
    p.output.telemetry = "jsonl"
    with pytest.raises(NotImplementedError, match="telemetry"):
        MhdSimulation(p, device="cpu")


@pytest.mark.parametrize("levelmax", [None, 9], ids=["uniform", "amr"])
def test_mhd_refusals_listed_once(levelmax):
    from ramses_tpu_torch.mhd.driver import unported_mhd_features
    p = load_params(TUBE, ndim=1)
    if levelmax is not None:
        p.amr.levelmax = levelmax
    r = p.run
    r.poisson = r.tracer = True
    r.max_step_retries = 2
    r.step_deadline_s, r.fault_inject = 5.0, "nan@3"
    p.output.telemetry = "jsonl"
    names = unported_mhd_features(p)
    assert len(names) == len(set(names)), names
    for name in ("step guard", "watchdog", "fault injection", "telemetry"):
        assert sum(name in n for n in names) == 1, (name, names)
    # gravity and tracers run on the MHD hierarchy; the uniform MHD driver
    # refuses each once
    for name in ("gravity", "tracers"):
        assert sum(name in n for n in names) == (levelmax is None), \
            (name, names)


def test_mhd_entry_points_require_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot occur")
    with pytest.raises(RuntimeError):
        MhdSimulation(load_params(TUBE, ndim=1))
    with pytest.raises(RuntimeError):
        run_namelist(TUBE, ndim=1)
