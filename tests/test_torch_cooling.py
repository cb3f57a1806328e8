"""Cooling in the port (``ramses_tpu_torch.hydro.cooling`` and ``eos``, the
uniform ``run_steps_cool`` and the hierarchy's in-step cooling) against
the JAX package's, on the CPU in f64.

* the tables: bitwise (the same host numpy);
* ``solve_cooling`` (K6's plain version), ``solve_cooling_ism`` and
  ``cooling_step``: rel 1e-10 per cell.  The pseudo-time march decides at
  each iteration whether a cell is done (``time < time_max``) and which
  table bin its temperature falls in; where the JAX function's own output
  moves by more than 1e-10 when nH, T2 or dt change by an ulp or a few
  (a few of thousands of random cells, near the UV-heating equilibrium),
  one-ulp differences between the two packages' ``log10`` and ``pow`` can
  take the other branch, and such a cell is held to ten times that move;
* ``run_steps_cool`` through ``Simulation`` and ``AmrSim`` with cooling at
  levelmin 4, levelmax 5: the state within rel 1e-10 of each field's max,
  the dt within rel 1e-10;
* the JAX package's own oracles (``tests/test_cooling.py``,
  ``tests/test_amr_physics.py``, the ISM cases of
  ``tests/test_plmde_pfix.py``) on the port;
* the refusals, and K6's wrapper on a CPU tensor (its plain version, no
  launch).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.config import params_from_dict as jdict  # noqa: E402
from ramses_tpu.driver import Simulation as JSimulation  # noqa: E402
from ramses_tpu.hydro import cooling as jc  # noqa: E402
from ramses_tpu.hydro import eos as jeos  # noqa: E402
from ramses_tpu.hydro.core import HydroStatic as JHydroStatic  # noqa: E402

from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import params_from_dict as pdict  # noqa: E402
from ramses_tpu_torch.convert import (amr_state_from,  # noqa: E402
                                      cooling_tables_from)
from ramses_tpu_torch.driver import Simulation  # noqa: E402
from ramses_tpu_torch.hydro import cooling as pc  # noqa: E402
from ramses_tpu_torch.hydro import eos as peos  # noqa: E402
from ramses_tpu_torch.hydro.core import HydroStatic  # noqa: E402

RTOL = 1e-10
UNITS = {"units_density": 1.66e-24, "units_time": 3.15e13,
         "units_length": 3.08e18}


@pytest.fixture(scope="module")
def tables():
    """(JAX, port) tables at z = 0 without UV, and at z = 3 with it."""
    return {key: (jc.build_tables(aexp=a, J21=j),
                  pc.build_tables(aexp=a, J21=j))
            for key, a, j in (("z0", 1.0, 0.0), ("uv", 0.25, 1.0))}


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _blob(lmin=4, lmax=4, d_in=10.0, p_in=100.0, tend=0.01, **extra):
    """``tests/test_amr_physics.py``'s blob."""
    g = {
        "run_params": {"hydro": True},
        "amr_params": {"levelmin": lmin, "levelmax": lmax, "boxlen": 1.0,
                       "npartmax": 10000},
        "init_params": {"nregion": 2,
                        "region_type": ["square", "square"],
                        "x_center": [0.5, 0.5], "y_center": [0.5, 0.5],
                        "z_center": [0.5, 0.5],
                        "length_x": [10.0, 0.25], "length_y": [10.0, 0.25],
                        "length_z": [10.0, 0.25],
                        "exp_region": [10.0, 2.0],
                        "d_region": [0.1, d_in],
                        "p_region": [0.05, p_in]},
        "hydro_params": {"gamma": 5.0 / 3.0, "courant_factor": 0.5},
        "units_params": dict(UNITS),
        "output_params": {"tend": tend},
    }
    g.update(extra)
    return g


def _both(g, ndim):
    return (jdict(copy.deepcopy(g), ndim=ndim),
            pdict(copy.deepcopy(g), ndim=ndim))


def _field_close(got, want, axis=0):
    """Each field within rel 1e-10 of its max magnitude (at least 1e-6 of
    the state's largest: a momentum of gas at rest is roundoff)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max(axis=tuple(i for i in range(want.ndim)
                                        if i != axis), keepdims=True)
    scale = np.maximum(scale, 1e-6 * scale.max())
    assert np.all(np.abs(got - want) <= RTOL * scale), \
        float(np.max(np.abs(got - want) / scale))


# ---------------------------------------------------------------------------
# the tables and the solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["z0", "uv"])
def test_tables_bitwise(tables, key):
    jt, pt = tables[key]
    for name in ("log_nH", "log_T2", "mu") + pc.TABLE_NAMES:
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    back = cooling_tables_from(jt)
    for name in pc.TABLE_NAMES:
        assert torch.equal(getattr(back, name), getattr(pt, name))
    # the rate fits and the UV quadrature are the same host numpy
    T = np.logspace(2, 8, 50)
    np.testing.assert_array_equal(pc.metal_cooling_solar(T),
                                  jc.metal_cooling_solar(T))
    assert pc.uv_amplitude(0.3, 1.0, haardt_madau=True) == \
        jc.uv_amplitude(0.3, 1.0, haardt_madau=True)
    gp, hp = pc.uv_rates(1.0, 1.0)
    gj, hj = jc.uv_rates(1.0, 1.0)
    assert gp == gj and hp == hj


@pytest.mark.parametrize("key", ["z0", "uv"])
@pytest.mark.parametrize("dt_s", [3e13, 3e15, 4e17])
def test_solve_cooling_matches_jax(tables, key, dt_s):
    """K6's plain version against JAX's ``solve_cooling`` on 2,000 random
    cells (nH 1e-6..1e4, T2 10..3e8, metallicity, self-shielding boost),
    per cell at rel 1e-10 or, where the JAX function's own output moves
    when nH, T2 or dt change by 1, 2 or 4 ulps, ten times that move."""
    jt, pt = tables[key]
    rng = np.random.default_rng(7)
    n = 2000
    nH = 10 ** rng.uniform(-6, 4, n)
    T2 = 10 ** rng.uniform(1, 8.5, n)
    z = rng.uniform(0, 1, n)
    boost = np.maximum(np.exp(-nH / 0.01), 1e-20)

    def jax_at(dn=0, dT=0, dd=0):
        return np.asarray(jc.solve_cooling(
            jt, jnp.asarray(nH * (1 + dn * 1.1e-16)),
            jnp.asarray(T2 * (1 + dT * 1.1e-16)), jnp.asarray(z),
            jnp.asarray(boost), dt_s * (1 + dd * 1.1e-16)))
    want = jax_at()
    move = np.max([np.abs(jax_at(**{w: k}) - want) for w in ("dn", "dT", "dd")
                   for k in (-4, -2, -1, 1, 2, 4)], axis=0) / np.abs(want)
    got, iters = pc.solve_cooling(pt, _t(nH), _t(T2), _t(z), _t(boost),
                                  dt_s, want_iters=True)
    rel = np.abs(got.numpy() - want) / np.abs(want)
    tol = np.maximum(RTOL, 10 * move)
    assert np.all(rel <= tol), (float(rel.max()),
                                int(np.sum(rel > RTOL)))
    # the conditioned cells are a few of thousands
    assert np.sum(tol > RTOL) <= 0.01 * n
    assert int(iters.min()) >= 1 and int(iters.max()) <= pc.MAX_ITER
    # scalars broadcast as the JAX function broadcasts them
    got_s = pc.solve_cooling(pt, _t(nH[:50]), _t(T2[:50]), 0.3, 1.0, dt_s)
    full = pc.solve_cooling(pt, _t(nH[:50]), _t(T2[:50]),
                            torch.full((50,), 0.3, dtype=torch.float64),
                            torch.ones(50, dtype=torch.float64), dt_s)
    assert torch.equal(got_s, full)


def test_solve_cooling_iteration_counts(tables):
    """The plain version's per-cell iteration counts: a cell is done when
    its pseudo-time passes time_max, so a zero dt takes one iteration and
    returns T2 unchanged, and a longer dt never takes fewer."""
    _, pt = tables["z0"]
    nH = _t([0.1, 1.0, 10.0])
    T2 = _t([1e6, 1e6, 1e6])
    out0, it0 = pc.solve_cooling(pt, nH, T2, 0.0, 1.0, 0.0, want_iters=True)
    assert torch.equal(out0, T2) and it0.tolist() == [1, 1, 1]
    _, it1 = pc.solve_cooling(pt, nH, T2, 0.0, 1.0, 3e13, want_iters=True)
    _, it2 = pc.solve_cooling(pt, nH, T2, 0.0, 1.0, 3e15, want_iters=True)
    assert bool((it2 >= it1).all()) and int(it1.min()) >= 1


def test_solve_cooling_ism_matches_jax():
    rng = np.random.default_rng(3)
    nH = 10 ** rng.uniform(-2, 3, 300)
    T2 = 10 ** rng.uniform(0.7, 7, 300)
    for dt in (3.15e11, 3.15e13):
        want = np.asarray(jc.solve_cooling_ism(jnp.asarray(nH),
                                               jnp.asarray(T2), dt))
        got = pc.solve_cooling_ism(_t(nH), _t(T2), dt).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL)
    r_j = np.asarray(jc._ism_rate(jnp.asarray(T2), jnp.asarray(nH)))
    r_p = pc._ism_rate(_t(T2), _t(nH)).numpy()
    np.testing.assert_allclose(r_p, r_j, rtol=RTOL)


@pytest.mark.parametrize("case", ["plain", "floor", "shield", "ism",
                                  "scales"])
def test_cooling_step_matches_jax(tables, case):
    """``cooling_step`` on a random 2D state, per case: the plain pass, a
    polytrope floor, self-shielding with metals (zsolar from z_ave, as the
    JAX package takes it), the ISM module, and the scales as a tensor."""
    jt, pt = tables["uv"]
    cfg_j = JHydroStatic(ndim=2, gamma=5.0 / 3.0)
    cfg_p = HydroStatic(ndim=2, gamma=5.0 / 3.0)
    rng = np.random.default_rng(11)
    n = 12
    rho = 10 ** rng.uniform(-1, 2, (n, n))
    v = 0.3 * rng.standard_normal((2, n, n))
    p = 10 ** rng.uniform(-3, 0, (n, n))
    u = np.stack([rho, rho * v[0], rho * v[1],
                  p / (cfg_p.gamma - 1) + 0.5 * rho * (v ** 2).sum(0)])
    kw = dict(enabled=True, scale_T2=1e7, scale_nH=1.0, scale_t=1e14)
    kw.update({"floor": dict(floor_form="polytrope", T2_eos=3e3,
                             polytrope_index=1.4),
               "shield": dict(self_shielding=True, metal=True, z_ave=0.5),
               "ism": dict(ism=True, ism_nsub=50)}.get(case, {}))
    sj, sp = jc.CoolingSpec(**kw), pc.CoolingSpec(**kw)
    scales = None
    if case == "scales":
        scales = [2e7, 0.5, 3e14]
    want = np.asarray(jc.cooling_step(
        jnp.asarray(u), jt, sj, 0.7, cfg_j,
        scales=None if scales is None else jnp.asarray(scales)))
    got = pc.cooling_step(_t(u), pt, sp, 0.7, cfg_p,
                          scales=None if scales is None else _t(scales))
    got = got.numpy()
    np.testing.assert_array_equal(got[:3], u[:3])
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_eos_matches_jax():
    nH = np.array([0.1, 1.0, 10.0, 1000.0])
    for form in ("isothermal", "polytrope", "double_polytrope", "custom"):
        want = np.asarray(jeos.barotropic_eos_temperature(
            jnp.asarray(nH), form, 10.0, 1.0, 1.4))
        got = peos.barotropic_eos_temperature(_t(nH), form, 10.0, 1.0, 1.4)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)
    with pytest.raises(ValueError, match="unknown"):
        peos.barotropic_eos_temperature(_t(nH), "nope", 1.0, 1.0, 1.0)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

WIRING = {
    "run_params": {"hydro": True},
    "amr_params": {"levelmin": 4, "levelmax": 4, "boxlen": 1.0},
    "init_params": {"nregion": 2, "region_type": ["square", "point"],
                    "x_center": [0.5, 0.5], "y_center": [0.5, 0.5],
                    "length_x": [10.0, 1.0], "length_y": [10.0, 1.0],
                    "exp_region": [10.0, 10.0],
                    "d_region": [1.0, 0.0], "p_region": [1e-3, 20.0]},
    "hydro_params": {"gamma": 1.4, "courant_factor": 0.5,
                     "riemann": "hllc"},
    "cooling_params": {"cooling": True},
    "units_params": {"units_density": 1.66e-24, "units_time": 3.15e13,
                     "units_length": 3.086e18},
    "output_params": {"noutput": 1, "tout": [0.02], "tend": 0.02},
}


def test_uniform_run_steps_cool_matches_jax():
    """``tests/test_cooling.py::test_driver_wiring``'s hot blast through
    both drivers (``run_steps_cool``, chunks of 16): the same step count
    and time, the state within rel 1e-10 of each field's max; the run
    loses energy."""
    jp, pp = _both(WIRING, 2)
    js = JSimulation(jp, dtype=jnp.float64)
    ps = Simulation(pp, dtype=torch.float64, device="cpu")
    e0 = float(ps.totals()["energy"])
    js.evolve()
    ps.evolve()
    assert ps.nstep == js.state.nstep > 0
    assert ps.t == pytest.approx(js.state.t, rel=RTOL)
    _field_close(ps.state.u.numpy(), np.asarray(js.state.u))
    assert float(ps.totals()["energy"]) < e0
    assert bool(torch.isfinite(ps.state.u).all())


def test_run_steps_cool_steps():
    """``run_steps_cool`` on the device-side clock: steps past tend are
    no-ops, and a zero-length window changes nothing."""
    from ramses_tpu_torch.grid.uniform import run_steps_cool
    _, pp = _both(WIRING, 2)
    ps = Simulation(pp, dtype=torch.float64, device="cpu")
    u0 = ps.state.u
    u, t, n = run_steps_cool(ps.grid, u0, 0.0, 0.0, 3, ps.cool_tables,
                             ps.cool_spec)
    assert int(n) == 0 and float(t) == 0.0 and torch.equal(u, u0)
    u, t, n = run_steps_cool(ps.grid, u0, 0.0, 1e-4, 50, ps.cool_tables,
                             ps.cool_spec)
    assert 0 < int(n) < 50 and float(t) == pytest.approx(1e-4, rel=1e-14)


def test_amr_cooling_matches_jax():
    """The blob with cooling at levelmin 4, levelmax 5 in 3D: the port's
    hierarchy started from the JAX run's state, 3 coarse steps (a regrid
    each): every level's rows within rel 1e-10 of each field's max, the
    dts within rel 1e-10."""
    g = _blob(4, 5, d_in=100.0, p_in=1e4, refine_params={"err_grad_d": 0.2},
              cooling_params={"cooling": True})
    jp, pp = _both(g, 3)
    js = JAmrSim(jp, dtype=jnp.float64)
    ps = AmrSim.from_state(pp, device="cpu", **amr_state_from(js))
    assert ps.cool_tables is not None and ps._fused_spec().cool is not None
    for _ in range(3):
        js.regrid()
        ps.regrid()
        dj, dp = js.coarse_dt(), ps.coarse_dt()
        assert dp == pytest.approx(dj, rel=RTOL)
        js.step_coarse(dj)
        ps.step_coarse(dj)
    assert ps.levels() == js.levels() == [4, 5]
    for l in js.levels():
        _field_close(ps.u[l].numpy(), np.asarray(js.u[l]), axis=1)


def test_amr_cooling_matches_uniform_and_radiates():
    """The JAX package's oracles on the port: the complete-level hierarchy
    with cooling equals the uniform ``run_steps_cool`` run to 1e-12, and a
    hot dense blob loses energy against the adiabatic run."""
    g = _blob(cooling_params={"cooling": True})
    _, pp = _both(g, 3)
    amr = AmrSim(pp, dtype=torch.float64, device="cpu")
    amr.evolve(0.01)
    _, pp = _both(g, 3)
    uni = Simulation(pp, dtype=torch.float64, device="cpu")
    uni.evolve()
    e_uni = float(uni.state.u[4].sum()) * uni.dx ** 3
    assert amr.totals()["energy"] == pytest.approx(e_uni, rel=1e-12)

    def run(cool):
        extra = {"cooling_params": {"cooling": True}} if cool else {}
        _, pp = _both(_blob(d_in=100.0, p_in=1e4, tend=0.02, **extra), 3)
        s = AmrSim(pp, dtype=torch.float64, device="cpu")
        s.evolve(0.02, nstepmax=4)
        return s.totals()["energy"]
    assert run(True) < run(False) * (1 - 1e-6)


def test_jax_oracles_on_the_port(tables):
    """``tests/test_cooling.py``'s physical checks on the port's functions:
    the cooling function's shape, stiff stability, UV heating, metals,
    the energy bookkeeping of ``cooling_step`` and the polytrope floor."""
    _, pt = tables["z0"]
    _, puv = tables["uv"]
    lam = 10.0 ** pt.cool[80].numpy()
    log_T2 = pt.log_T2.numpy()
    assert lam[np.searchsorted(log_T2, 3.0)] < 1e-25
    assert 4.2 < log_T2[np.argmax(lam)] < 5.7
    out = pc.solve_cooling(pt, _t([1e-4, 1.0, 1e4]), _t([1e7] * 3), 1.0,
                           1.0, 4e17).numpy()
    assert np.all(np.isfinite(out)) and np.all(out > 0) and \
        np.all(out < 1e7)
    assert float(pc.solve_cooling(puv, _t([1e-5]), _t([100.0]), 0.0, 1.0,
                                  1e18)[0]) > 1e3
    T2 = _t([10 ** 5.3])
    assert float(pc.solve_cooling(pt, _t([1.0]), T2, 1.0, 1.0, 1e13)[0]) < \
        float(pc.solve_cooling(pt, _t([1.0]), T2, 0.0, 1.0, 1e13)[0])
    cfg = HydroStatic(ndim=2, gamma=5.0 / 3.0)
    spec = pc.CoolingSpec(enabled=True, scale_T2=1e7, scale_nH=1.0,
                          scale_t=1e15)
    rho = torch.ones((8, 8), dtype=torch.float64)
    vx = 0.3 * torch.ones_like(rho)
    p = 0.1 * torch.ones_like(rho)
    u = torch.stack([rho, rho * vx, torch.zeros_like(rho),
                     p / (cfg.gamma - 1) + 0.5 * rho * vx ** 2])
    un = pc.cooling_step(u, pt, spec, 1.0, cfg)
    assert torch.equal(un[:3], u[:3]) and float(un[3].sum()) < \
        float(u[3].sum())
    eint = un[3] - 0.5 * rho * vx ** 2
    assert float(eint.min()) > 0 and \
        float((eint / (u[3] - 0.5 * rho * vx ** 2)).max()) < 1.0
    cfg1 = HydroStatic(ndim=1, gamma=5.0 / 3.0)
    floor = pc.CoolingSpec(enabled=True, scale_T2=1e7, scale_nH=10.0,
                           scale_t=1e18, floor_form="isothermal",
                           T2_eos=3e4)
    u1 = torch.stack([torch.ones(16, dtype=torch.float64),
                      torch.zeros(16, dtype=torch.float64),
                      0.1 * torch.ones(16, dtype=torch.float64)
                      / (cfg1.gamma - 1)])
    un1 = pc.cooling_step(u1, pt, floor, 10.0, cfg1)
    T2o = (cfg1.gamma - 1) * un1[2] / un1[0] * floor.scale_T2
    assert bool((T2o > 0.9 * 3e4).all())


def test_ism_oracles_on_the_port():
    """The ISM cases of ``tests/test_plmde_pfix.py``: the two-phase
    equilibria of the Audit & Hennebelle rate, the integrator relaxing
    from both sides, and ``cooling_ism`` through the uniform driver."""
    for n, lo, hi in ((0.5, 4000.0, 12000.0), (100.0, 10.0, 120.0)):
        Ts = np.logspace(1, 4.3, 200)
        r = pc._ism_rate(_t(Ts), torch.full((200,), n,
                                            dtype=torch.float64)).numpy()
        sc = np.where(np.diff(np.sign(r)))[0]
        assert len(sc) >= 1 and lo < Ts[sc[0]] < hi
    out = pc.solve_cooling_ism(_t([100.0, 100.0]), _t([1e5, 3.0]),
                               3.15e13).numpy()
    assert out[0] < 1e4 and out[1] > 3.0
    g = {
        "run_params": {"hydro": True},
        "amr_params": {"levelmin": 3, "levelmax": 3, "boxlen": 1.0},
        "init_params": {"nregion": 1, "region_type": ["square"],
                        "x_center": [0.5], "y_center": [0.5],
                        "z_center": [0.5], "length_x": [10.0],
                        "length_y": [10.0], "length_z": [10.0],
                        "exp_region": [10.0], "d_region": [100.0],
                        "p_region": [100.0]},
        "hydro_params": {"gamma": 1.6666667, "courant_factor": 0.5},
        "cooling_params": {"cooling": True, "cooling_ism": True},
        "units_params": dict(UNITS),
        "output_params": {"tend": 0.05},
    }
    jp, pp = _both(g, 3)
    ps = Simulation(pp, dtype=torch.float64, device="cpu")
    assert ps.cool_spec.ism
    e0 = float(ps.state.u[4].sum())
    ps.evolve()
    assert float(ps.state.u[4].sum()) < e0 * (1 - 1e-6)
    js = JSimulation(jp, dtype=jnp.float64)
    js.evolve()
    assert ps.nstep == js.state.nstep
    _field_close(ps.state.u.numpy(), np.asarray(js.state.u))


def test_cosmological_retabulation():
    """Under cosmology the hierarchy refreshes its cooling scales every
    coarse step and rebuilds the tables once aexp has moved by 2 %, as
    the JAX package's ``step_coarse`` does."""
    g = _blob(4, 4, cooling_params={"cooling": True})
    g["run_params"]["cosmo"] = True
    g["init_params"]["aexp_ini"] = 0.1
    g["cosmo_params"] = {"omega_m": 1.0, "omega_l": 0.0, "omega_b": 0.045,
                         "h0": 70.0}
    jp, pp = _both(g, 3)
    js = JAmrSim(jp, dtype=jnp.float64)
    ps = AmrSim.from_state(pp, device="cpu", **amr_state_from(js))
    assert ps.cool_tabulations == 1 and ps._cool_aexp == js._cool_aexp
    # move both clocks to aexp 0.1025 (2.5 % on): the next coarse step
    # re-tabulates
    js.t = ps.t = float(js.cosmo.tau_of_aexp(0.1025))
    for _ in range(2):
        dj = js.coarse_dt()
        assert ps.coarse_dt() == pytest.approx(dj, rel=RTOL)
        js.step_coarse(dj)
        ps.step_coarse(dj)
    assert ps._cool_aexp == js._cool_aexp
    np.testing.assert_allclose(ps._cool_scales.numpy(),
                               np.asarray(js._cool_scales), rtol=1e-14)
    assert ps.cool_tabulations == 2 and js._cool_aexp > 0.102
    for name in pc.TABLE_NAMES:
        np.testing.assert_array_equal(getattr(ps.cool_tables, name).numpy(),
                                      np.asarray(getattr(js.cool_tables,
                                                         name)))
    for l in js.levels():
        _field_close(ps.u[l].numpy(), np.asarray(js.u[l]), axis=1)


# ---------------------------------------------------------------------------
# refusals and the wrapper
# ---------------------------------------------------------------------------

def test_uniform_cooling_with_pm_refused_by_name():
    for extra in ({"poisson": True}, {"pic": True}):
        g = copy.deepcopy(WIRING)
        g["run_params"].update(extra)
        with pytest.raises(NotImplementedError,
                           match="cooling with gravity, particles or "
                                 "cosmology on the uniform grid"):
            Simulation(pdict(g, ndim=2), device="cpu")


def test_cooling_no_longer_refused():
    from ramses_tpu_torch.driver import unported_features
    _, pp = _both(WIRING, 2)
    assert not any("cooling" in n for n in unported_features(pp))


def test_k6_wrapper_on_cpu_is_the_plain_version(tables):
    _, pt = tables["z0"]
    before = pc.launches
    nH, T2 = _t([0.1, 1.0]), _t([1e6, 2e5])
    a = pc.solve_cooling(pt, nH, T2, 0.1, 1.0, 3e13)
    b = pc.solve_cooling_ref(pt, nH, T2, 0.1, 1.0, 3e13)
    assert pc.launches == before and torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        pc._launch(pt, nH, T2, 0.1, 1.0, 3e13, False)
    f32 = pt.packed(torch.float32)
    assert f32[0].shape == (10, pc.NBIN_N, pc.NBIN_T) and \
        f32[0].dtype == torch.float32 and pt.packed(torch.float32) is f32


def test_k6_counts_a_launch_only_where_it_launches(tables, monkeypatch):
    """K6's wrapper adds one to ``launches`` where it calls the kernel's
    entry and nowhere else: with the device check and the build replaced
    by a recording stand-in, a call with no cells calls nothing and counts
    nothing, a call with three cells calls the entry once and counts one,
    a number for zsolar, boost or dt reaching it at stride 0."""
    import contextlib
    _, pt = tables["z0"]
    calls = []

    class Lib:
        def ramses_cooling_f64(self, *args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(pc, "_check_args", lambda *a: None)
    monkeypatch.setattr(pc, "_library", Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    before = pc.launches
    empty = _t(np.zeros((0, 4)))
    out, it = pc._launch(pt, empty, empty, 0.1, 1.0, 3e13, True)
    assert out.shape == it.shape == (0, 4) and not calls
    assert pc.launches == before
    nH, T2 = _t([0.1, 1.0, 10.0]), _t([1e6, 2e5, 3e4])
    pc._launch(pt, nH, T2, 0.1, 1.0, 3e13, False)
    assert pc.launches == before + 1 and len(calls) == 1
    zs_stride, bs_stride, n = calls[0][3], calls[0][5], calls[0][12]
    assert (zs_stride, bs_stride, n) == (0, 0, 3)
