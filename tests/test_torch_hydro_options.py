"""The port's remaining hydro options against the JAX package's, on the CPU.

Each function of ``ramses_tpu_torch.hydro`` that the port gained with
them — the two-shock ``riemann_approx`` (``riemann='exact'``), the
linearized ``riemann_acoustic``, the positivity slopes (slope_type 3),
the PLMDE predictor (``trace_plmde``) and the dual-energy
``dual_energy_fix`` / ``pressure_fix`` — against its JAX counterpart in
f64 on seeded random states (the exact solver also on vacuum-adjacent
rarefactions), then whole steps through ``muscl.unsplit`` with each
option, and ``namelists/detente.nml`` (``riemann='exact'``) through
``run_namelist`` at a cut step count against ``ramses_tpu.driver.
run_namelist``.  Tolerance: f64 roundoff of the same formulation, rtol
1e-12 (atol 1e-14 on values that cancel to zero).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.driver import run_namelist as jrun_namelist  # noqa: E402
from ramses_tpu.hydro import muscl as jmuscl  # noqa: E402
from ramses_tpu.hydro import riemann as jriemann  # noqa: E402
from ramses_tpu.hydro.core import HydroStatic as JHydroStatic  # noqa: E402

from ramses_tpu_torch.convert import hydro_static_from  # noqa: E402
from ramses_tpu_torch.driver import run_namelist  # noqa: E402
from ramses_tpu_torch.hydro import muscl, riemann  # noqa: E402
from ramses_tpu_torch.hydro.core import HydroStatic  # noqa: E402

RTOL, ATOL = 1e-12, 1e-14


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _cfgs(**kw):
    jc = JHydroStatic(**kw)
    return jc, hydro_static_from(jc)


def _iface(nd, n, seed, nener=0, npassive=0, vacuum=False):
    """Interface-layout states (rho, v_n, P, v_t..., erad..., passives...)
    for the left and right of n faces.  ``vacuum``: a strongly divergent
    flow at low pressure, whose two rarefactions leave p* at the floor."""
    rng = np.random.default_rng(seed)
    nv = nd + 2 + nener + npassive

    def side(sgn):
        q = np.empty((nv, n))
        q[0] = 0.2 + rng.random(n)
        q[1] = 0.5 * rng.standard_normal(n)
        q[2] = 0.05 + rng.random(n)
        q[3:nd + 2] = 0.3 * rng.standard_normal((nd - 1, n))
        q[nd + 2:] = rng.random((nener + npassive, n))
        if vacuum:
            q[1] = sgn * (3.0 + rng.random(n))
            q[2] = 1e-6 * (1.0 + rng.random(n))
        return q
    return side(-1.0), side(1.0)


@pytest.mark.parametrize("solver", ["exact", "acoustic"])
@pytest.mark.parametrize("nd,nener,npassive,vacuum", [
    (1, 0, 0, False), (2, 0, 1, False), (3, 1, 1, False), (1, 0, 0, True),
    (3, 0, 0, True)])
def test_riemann_solver_matches_jax(solver, nd, nener, npassive, vacuum):
    jc, cfg = _cfgs(ndim=nd, nener=nener, npassive=npassive,
                    gamma_rad=(4.0 / 3.0,) * nener, riemann=solver)
    ql, qr = _iface(nd, 256, 3 * nd + nener + 10 * vacuum, nener, npassive,
                    vacuum)
    want = jriemann.SOLVERS[solver](jnp.asarray(ql), jnp.asarray(qr), jc)
    got = riemann.solve(torch.from_numpy(ql), torch.from_numpy(qr), cfg)
    assert got.shape == (cfg.nvar + 1, 256)
    assert bool(torch.isfinite(got).all())
    _close(got, want)
    if vacuum and solver == "exact":
        # the mass flux vanishes between the two rarefactions
        assert float(got[0].abs().max()) < 1e-3


def _prim(nd, shape, seed, nener=0, npassive=0):
    rng = np.random.default_rng(seed)
    q = np.empty((nd + 2 + nener + npassive,) + shape)
    q[0] = 0.5 + rng.random(shape)
    q[1:nd + 1] = 0.4 * rng.standard_normal((nd,) + shape)
    q[nd + 1] = 0.2 + rng.random(shape)
    q[nd + 2:] = rng.random((nener + npassive,) + shape)
    return q


@pytest.mark.parametrize("nd", [2, 3])
def test_positivity_slopes_match_jax(nd):
    jc, cfg = _cfgs(ndim=nd, slope_type=3, npassive=1)
    q = _prim(nd, (9,) * nd, 40 + nd, npassive=1)
    # a flat patch: dff = 0 takes the limiter's other branch
    q[:, :3, :3] = 1.0
    want = jmuscl.uslope(jnp.asarray(q), jc)
    got = muscl.uslope(torch.from_numpy(q), cfg)
    _close(got, want)


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_trace_plmde_matches_jax(nd):
    jc, cfg = _cfgs(ndim=nd, scheme="plmde", slope_type=2, npassive=1)
    shape = (8,) * nd
    q = _prim(nd, shape, 50 + nd, npassive=1)
    rng = np.random.default_rng(60 + nd)
    c = np.sqrt(cfg.gamma * q[nd + 1] / q[0])
    dq = 0.1 * rng.standard_normal((nd,) + q.shape)
    dq[0, 1, :2] = 5.0                 # supersonic fix: |du| > 3c
    dt, dx = 0.01, (0.05,) * nd
    want = jmuscl.trace_plmde(jnp.asarray(q), jnp.asarray(c),
                              jnp.asarray(dq), dt, dx, jc)
    got = muscl.trace_plmde(torch.from_numpy(q), torch.from_numpy(c),
                            torch.from_numpy(dq), dt, dx, cfg)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("nd,nener,pressure_fix", [
    (1, 0, True), (2, 1, True), (3, 1, False), (3, 0, True)])
def test_dual_energy_fix_matches_jax(nd, nener, pressure_fix):
    jc, cfg = _cfgs(ndim=nd, nener=nener, gamma_rad=(4.0 / 3.0,) * nener,
                    pressure_fix=pressure_fix, beta_fix=0.5)
    shape = (8,) * nd
    rng = np.random.default_rng(70 + nd + nener)
    nv = cfg.nvar

    def cons():
        u = np.empty((nv,) + shape)
        u[0] = 0.5 + rng.random(shape)
        u[1:nd + 1] = 0.5 * rng.standard_normal((nd,) + shape) * u[0]
        u[nd + 2:] = rng.random((nener,) + shape)
        # about half the cells with a tiny internal energy, which the
        # truncation test replaces
        eint = np.where(rng.random(shape) < 0.5, 1e-6,
                        0.5 + rng.random(shape))
        u[nd + 1] = (eint + 0.5 * (u[1:nd + 1] ** 2).sum(axis=0) / u[0]
                     + u[nd + 2:].sum(axis=0))
        return u
    up, un = cons(), cons()
    tmp = 0.05 * rng.standard_normal((nd, 2) + shape)
    dt, dx = 0.01, (0.05,) * nd
    want = jmuscl.dual_energy_fix(jnp.asarray(up), jnp.asarray(un),
                                  jnp.asarray(tmp), dt, dx, jc, hexp=0.1)
    got = muscl.dual_energy_fix(torch.from_numpy(up), torch.from_numpy(un),
                                torch.from_numpy(tmp), dt, dx, cfg, hexp=0.1)
    _close(got, want)
    assert not torch.equal(got, torch.from_numpy(un))


@pytest.mark.parametrize("nd,kw", [
    (1, dict(riemann="exact")),
    (2, dict(riemann="exact", slope_type=3)),
    (2, dict(riemann="acoustic", scheme="plmde")),
    (3, dict(riemann="hllc", pressure_fix=True, beta_fix=0.1)),
    (2, dict(riemann="llf", nener=1, gamma_rad=(4.0 / 3.0,),
             scheme="plmde", slope_type=1)),
])
def test_unsplit_step_with_option_matches_jax(nd, kw):
    """A whole padded step: unsplit, the update and the dual-energy fix
    where the configuration asks for it."""
    jc, cfg = _cfgs(ndim=nd, **kw)
    shape = (10,) * nd
    q = _prim(nd, shape, 80 + nd, nener=cfg.nener)
    u = q.copy()
    u[1:nd + 1] = q[1:nd + 1] * q[0]
    u[nd + 1] = (q[nd + 1] / (cfg.gamma - 1.0)
                 + 0.5 * (q[1:nd + 1] ** 2).sum(axis=0) * q[0]
                 + q[nd + 2:].sum(axis=0))
    dt, dx = 2e-3, (0.1,) * nd

    def run(mod, arr, c):
        flux, tmp = mod.unsplit(arr, None, dt, dx, c)
        new = mod.apply_fluxes(arr, flux, c)
        if c.pressure_fix or c.nener:
            new = mod.dual_energy_fix(arr, new, tmp, dt, dx, c)
        return new
    want = run(jmuscl, jnp.asarray(u), jc)
    got = run(muscl, torch.from_numpy(u), cfg)
    inner = (slice(None),) + (slice(2, -2),) * nd
    _close(got[inner], np.asarray(want)[inner])


def test_no_option_raises_any_more():
    q = torch.ones((4, 6, 6), dtype=torch.float64)
    cfg = HydroStatic(ndim=2, slope_type=3)
    assert muscl.uslope(q, cfg).shape == (2, 4, 6, 6)
    for name in ("exact", "acoustic"):
        c = dataclasses.replace(cfg, riemann=name)
        assert riemann.solve(q[:, 0], q[:, 0], c).shape == (5, 6)


def test_detente_matches_jax(tmp_path):
    """``namelists/detente.nml`` (1D double rarefaction, outflow,
    ``riemann='exact'``) through ``run_namelist`` in both packages, cut to
    20 steps."""
    src = open("namelists/detente.nml").read()
    nml = tmp_path / "detente.nml"
    nml.write_text(src.replace("nremap=100000", "nremap=100000\nnstepmax=20"))
    want = jrun_namelist(str(nml), ndim=1, dtype=jnp.float64)
    got = run_namelist(str(nml), ndim=1, dtype=torch.float64, device="cpu")
    assert got.cfg.riemann == "exact"
    assert got.nstep == want.state.nstep == 20
    assert got.t == pytest.approx(float(want.state.t), rel=1e-12)
    _close(got.state.u, want.state.u)
