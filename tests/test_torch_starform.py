"""Star formation, SN feedback and stellar objects in the port
(``ramses_tpu_torch.pm.star_formation``, ``pm.stellar``, the SF part of
``pm.amr_physics`` and the drivers' wiring) against the JAX package's, on
the CPU in f64.

* every function of ``pm/star_formation.py`` and ``pm/stellar.py`` on
  seeded inputs with the same ``default_rng`` draws: the same stars, ids,
  masses and flags, and the gas state, bitwise (the same host numpy);
* the uniform ``Simulation`` with ``pic``, SF and thermal or kinetic
  feedback, and the hierarchy (levelmin 4, levelmax 5) with SF and
  feedback, with sinks and stellar objects: the same stars, ids and
  masses bitwise from the same ``default_rng(1234)`` draws, the state
  within rel 1e-10 of each field's max (the hydro's roundoff);
* ``write_stellar_csv`` byte for byte, and the dump's CSVs;
* the JAX package's own oracles (``tests/test_starform.py``,
  ``tests/test_sf_driver.py``, ``tests/test_amr_physics.py``) on the port;
* ``cosmo_gal.nml`` shrunk against the JAX hierarchy and through the CLI;
* every refusal by name.
"""

import copy
import dataclasses
import filecmp
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.driver import Simulation as JSimulation  # noqa: E402
from ramses_tpu.io import snapshot as jsnap  # noqa: E402
from ramses_tpu.pm import star_formation as J  # noqa: E402
from ramses_tpu.pm import stellar as JST  # noqa: E402
from ramses_tpu.pm.particles import ParticleSet as JParticleSet  # noqa
from ramses_tpu.units import Units as JUnits  # noqa: E402

from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import params_from_dict as pdict  # noqa: E402
from ramses_tpu_torch.convert import (amr_state_from,  # noqa: E402
                                      particles_from, sf_state_from,
                                      stellar_from)
from ramses_tpu_torch.driver import Simulation  # noqa: E402
from ramses_tpu_torch.io import snapshot as psnap  # noqa: E402
from ramses_tpu_torch.pm import star_formation as P  # noqa: E402
from ramses_tpu_torch.pm import stellar as PST  # noqa: E402
from ramses_tpu_torch.pm.particles import FAM_STAR, ParticleSet  # noqa
from ramses_tpu_torch.units import Units, yr2sec  # noqa: E402

from test_torch_cooling import _blob, _both, _field_close  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAL_NML = os.path.join(ROOT, "namelists", "cosmo_gal.nml")


def _units(cls=Units):
    return cls(scale_l=3.086e18, scale_t=3.156e13, scale_d=1.66e-24)


def _pair(x, v, m, nmax, family=None, idp=None, tp=None):
    """(JAX, port) particle sets with the same lanes."""
    kw = {} if family is None else dict(family=family)
    if idp is not None:
        kw["idp"] = idp
    jp = JParticleSet.make(x, v, m, nmax=nmax, dtype=jnp.float64, **kw)
    pp = ParticleSet.make(x, v, m, dtype=torch.float64, device="cpu",
                          nmax=nmax, **kw)
    if tp is not None:
        tp = np.pad(tp, (0, nmax - len(tp)))
        jp = dataclasses.replace(jp, tp=jnp.asarray(tp))
        pp.tp = torch.tensor(tp)
    return jp, pp


def _same_particles(jp, pp, exact=True):
    """Every lane's fields equal, bitwise; without ``exact`` the positions
    and velocities (which a run takes from its gas, the hydro's roundoff)
    within rtol 1e-10 / atol 1e-12."""
    for k in ("x", "v", "m", "active", "idp", "family", "tp", "flags"):
        got, want = getattr(pp, k).numpy(), np.asarray(getattr(jp, k))
        if exact or k not in ("x", "v"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12,
                                       err_msg=k)


def _box(n=8, rho=100.0, ndim=3, p=1.0, seed=None):
    u = np.zeros((ndim + 2,) + (n,) * ndim)
    u[0] = rho
    u[ndim + 1] = p / 0.4
    if seed is not None:
        rng = np.random.default_rng(seed)
        u[0] *= 1.0 + rng.random(u[0].shape)
        for d in range(ndim):
            u[1 + d] = 0.1 * u[0] * rng.standard_normal(u[0].shape)
        u[ndim + 1] += 0.5 * (u[1:1 + ndim] ** 2).sum(0) / u[0]
    return u


def _stars(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, 3)), 0.3 * rng.standard_normal((n, 3)),
            rng.uniform(0.5, 2.0, n))


# ---------------------------------------------------------------------------
# the host functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_star", [0.1, 0.0])
def test_star_formation_matches_jax(t_star):
    """One SF pass on a random box (t_star or the free-fall eps_star
    timescale), and one against a lane budget smaller than the draw (the
    overflow truncation keeps the earliest cells)."""
    spec_kw = dict(enabled=True, n_star=1.0, t_star=t_star, eps_star=0.05)
    sj, sp = J.SfSpec(**spec_kw), P.SfSpec(**spec_kw)
    for nmax in (200000, 40):
        u = _box(n=8, rho=100.0, seed=3)
        jp, pp = _pair(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0), nmax)
        uj, jp2, nj = J.star_formation(u, jp, np.random.default_rng(1), sj,
                                       _units(JUnits), 1.0 / 8, 0.5, 0.01, 7)
        up, pp2, np_ = P.star_formation(u, pp, np.random.default_rng(1), sp,
                                        _units(), 1.0 / 8, 0.5, 0.01, 7)
        assert nj == np_ > 7
        np.testing.assert_array_equal(up, uj)
        _same_particles(jp2, pp2)
    assert P.mstar_quantum(sp, _units(), 0.125, 3) == \
        J.mstar_quantum(sj, _units(JUnits), 0.125, 3)


@pytest.mark.parametrize("kinetic", [False, True])
def test_feedback_matches_jax(kinetic):
    """Thermal and kinetic SN feedback of 30 stars (some sharing a host
    cell, some already exploded, some too young) on a random box, the
    kinetic one with reflecting walls on x: state and particles bitwise."""
    from ramses_tpu.grid import boundary as jb
    from ramses_tpu_torch.grid import boundary as pb
    kw = dict(enabled=True, eta_sn=0.2, t_sne=10.0, f_w=5.0 if kinetic
              else 0.0)
    sj, sp = J.SfSpec(**kw), P.SfSpec(**kw)
    x, v, m = _stars(30, 5)
    x[:6] = x[0]                          # six SNe in one host cell
    fam = np.full(30, FAM_STAR, dtype=np.int8)
    fam[-3:] = 1                          # three dark-matter particles
    t_sne = 10.0 * 1e6 * yr2sec / _units().scale_t
    tp = np.where(np.arange(30) % 7 == 3, 1.5 * t_sne, 0.0)  # too young
    jp, pp = _pair(x, v, m, 40, family=fam, tp=tp)
    t = 2.0 * t_sne
    u = _box(n=8, rho=1.0, seed=4)
    if kinetic:
        faces = lambda B: B.BoundarySpec(faces=(  # noqa: E731
            (B.FaceBC(1), B.FaceBC(1)), (B.FaceBC(0), B.FaceBC(0)),
            (B.FaceBC(0), B.FaceBC(0))))
        uj, jp2 = J.kinetic_feedback(u, jp, sj, _units(JUnits), 0.125, t,
                                     bc=faces(jb))
        up, pp2 = P.kinetic_feedback(u, pp, sp, _units(), 0.125, t,
                                     bc=faces(pb))
    else:
        uj, jp2 = J.thermal_feedback(u, jp, sj, _units(JUnits), 0.125, t)
        up, pp2 = P.thermal_feedback(u, pp, sp, _units(), 0.125, t)
    np.testing.assert_array_equal(up, uj)
    _same_particles(jp2, pp2)
    assert int((pp2.flags.numpy() & P.FLAG_SN_DONE).sum()) > 0
    np.testing.assert_array_equal(
        P.sn_due_mask(pp2, sp, _units(), 3 * t_sne),
        np.asarray(J.sn_due_mask(jp2, sj, _units(JUnits), 3 * t_sne)))
    offs, rhat = P.wind_shell(3)
    offj, rhj = J.wind_shell(3)
    assert np.array_equal(offs, offj) and np.array_equal(rhat, rhj)


def test_sf_oracles_on_the_port():
    """``tests/test_starform.py``'s checks on the port: no stars below the
    threshold; the Poisson-sampled mass near mgas·dt/t_star with the gas
    and stars summing to the start; one thermal SN after t_sne, its mass
    and energy, and not twice; the kinetic wind's mass, energy and
    momentum budget and its outflow."""
    un = _units()
    u = _box(rho=1.0)
    pe = ParticleSet.make(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0),
                          dtype=torch.float64, device="cpu", nmax=4096)
    _, p2, _ = P.star_formation(u, pe, np.random.default_rng(0),
                                P.SfSpec(enabled=True, n_star=1e4,
                                         t_star=1.0), un, 0.125, 0.0, 0.1, 1)
    assert int(p2.active.sum()) == 0
    spec = P.SfSpec(enabled=True, n_star=1.0, t_star=0.1)
    u = _box(n=8, rho=100.0)
    pe = ParticleSet.make(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0),
                          dtype=torch.float64, device="cpu", nmax=200000)
    dx, dt = 0.125, 0.01
    u2, p2, _ = P.star_formation(u, pe, np.random.default_rng(1), spec, un,
                                 dx, 0.0, dt, 1)
    act = p2.active.numpy()
    m_star = float(p2.m.numpy()[act].sum())
    assert np.isclose(u[0].sum() * dx ** 3, u2[0].sum() * dx ** 3 + m_star,
                      rtol=1e-12)
    nH = 100.0 * un.scale_nH
    tstar = (0.1 * 1e9 * yr2sec * np.sqrt(1.0 / nH)) / un.scale_t
    expected = u[0].sum() * dx ** 3 * dt / tstar
    assert abs(m_star - expected) < 0.2 * expected
    assert np.all(p2.family.numpy()[act] == FAM_STAR)
    t_sne = 10.0 * 1e6 * yr2sec / un.scale_t
    esn = (1e51 / (10 * 1.9891e33)) / un.scale_v ** 2
    star = ParticleSet.make(np.array([[0.5, 0.5, 0.5]]),
                            np.array([[0.5, 0.0, 0.0]]), np.array([2.0]),
                            dtype=torch.float64, device="cpu", nmax=4,
                            family=np.array([FAM_STAR], dtype=np.int8))
    th = P.SfSpec(enabled=True, eta_sn=0.2, t_sne=10.0)
    u = _box(n=4, rho=1.0)
    u1, _ = P.thermal_feedback(u.copy(), star, th, un, 0.25, 0.5 * t_sne)
    assert np.allclose(u1, u)
    u2, p2 = P.thermal_feedback(u.copy(), star, th, un, 0.25, 2 * t_sne)
    mej = 0.4
    assert np.isclose(float(p2.m[0]), 2.0 - mej)
    de = (u2[4].sum() - u[4].sum()) * 0.25 ** 3
    assert np.isclose(de, mej * esn + 0.5 * mej * 0.25, rtol=1e-10)
    u3, _ = P.thermal_feedback(u2.copy(), p2, th, un, 0.25, 3 * t_sne)
    assert np.allclose(u3, u2)
    kin = P.SfSpec(enabled=True, eta_sn=0.2, t_sne=10.0, f_w=5.0)
    still = ParticleSet.make(np.array([[0.5, 0.5, 0.5]]), np.zeros((1, 3)),
                             np.array([2.0]), dtype=torch.float64,
                             device="cpu", nmax=4,
                             family=np.array([FAM_STAR], dtype=np.int8))
    u = _box(n=8, rho=1.0)
    u2, p2 = P.kinetic_feedback(u.copy(), still, kin, un, 0.125, 2 * t_sne)
    assert np.isclose(u2[0].sum() * dx ** 3 + float(p2.m[0]),
                      u[0].sum() * dx ** 3 + 2.0, rtol=1e-12)
    assert np.isclose((u2[4].sum() - u[4].sum()) * dx ** 3, mej * esn,
                      rtol=1e-10)
    assert np.allclose([u2[1 + d].sum() for d in range(3)], 0.0, atol=1e-12)
    assert u2[1][5, 4, 4] > 0 and u2[1][3, 4, 4] < 0


def test_stellar_functions_match_jax():
    """The IMF draws, the lifetimes, the spawning from the sinks' accreted
    mass (merged-away accumulators dropped) and the CSV, bitwise."""
    from ramses_tpu.pm.sinks import SinkSet as JSinkSet
    from ramses_tpu_torch.pm.sinks import SinkSet as PSinkSet
    a = JST.sample_powerlaw(np.random.default_rng(0), 8.0, 120.0, -2.35, 500)
    b = PST.sample_powerlaw(np.random.default_rng(0), 8.0, 120.0, -2.35, 500)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        JST.sample_powerlaw(np.random.default_rng(1), 8.0, 120.0, -1.0, 9),
        PST.sample_powerlaw(np.random.default_rng(1), 8.0, 120.0, -1.0, 9))
    kw = dict(enabled=True, stellar_msink_th=0.002, lt_t0=1.0)
    sj, sp = JST.StellarSpec(**kw), PST.StellarSpec(**kw)
    m = np.array([8.0, 40.0, 120.0])
    np.testing.assert_array_equal(PST.lifetime(m, sp), JST.lifetime(m, sj))
    assert np.median(b) < 20.0
    tl = PST.lifetime(m, sp)
    assert tl[0] > tl[1] > tl[2]
    rng = np.random.default_rng(5)
    sk = dict(x=rng.uniform(0, 1, (4, 3)), v=np.zeros((4, 3)),
              m=np.ones(4), tform=np.zeros(4),
              idp=np.array([3, 5, 8, 9], np.int64), next_id=10)
    js_, ps_ = JST.StellarSet.empty(3), PST.StellarSet.empty(3)
    for st in (js_, ps_):
        for sid, dm in ((3, 0.0071), (5, 0.0019), (8, 0.0042), (7, 0.5)):
            st.add_accreted(sid, dm)
    gj, gp = np.random.default_rng(2), np.random.default_rng(2)
    js_ = JST.make_stellar_from_sinks(JSinkSet(**sk), js_, sj, gj, 0.25)
    ps_ = PST.make_stellar_from_sinks(PSinkSet(**sk), ps_, sp, gp, 0.25)
    assert ps_.n == js_.n == 5 and ps_.dmf == js_.dmf and 7 not in ps_.dmf
    for k in ("m", "tform", "tlife", "x", "sink_idp", "idp"):
        np.testing.assert_array_equal(getattr(ps_, k), getattr(js_, k))
    assert gj.random() == gp.random()
    back = stellar_from(js_)
    assert back.next_id == js_.next_id and back.dmf == js_.dmf


def test_write_stellar_csv_byte_identical(tmp_path):
    st = PST.StellarSet(m=np.array([9.5, 33.0]), tform=np.array([0.1, 0.2]),
                        tlife=np.array([1e-3, 2e-4]),
                        x=np.zeros((2, 3)), sink_idp=np.array([1, 1]),
                        idp=np.array([4, 12]), next_id=13)
    psnap.write_stellar_csv(str(tmp_path / "p.csv"), st)
    jsnap.write_stellar_csv(str(tmp_path / "j.csv"), st)
    assert filecmp.cmp(tmp_path / "p.csv", tmp_path / "j.csv", shallow=False)
    assert open(tmp_path / "p.csv").readline() == " # id,mstellar,tform,tlife \n"


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

SF_UNIFORM = {
    "run_params": {"hydro": True, "pic": True},
    "amr_params": {"levelmin": 3, "levelmax": 3, "boxlen": 1.0,
                   "npartmax": 50000},
    "init_params": {"nregion": 1, "region_type": ["square"],
                    "x_center": [0.5], "y_center": [0.5], "z_center": [0.5],
                    "length_x": [10.0], "length_y": [10.0],
                    "length_z": [10.0], "exp_region": [10.0],
                    "d_region": [100.0], "p_region": [10.0]},
    "hydro_params": {"gamma": 1.4, "courant_factor": 0.5,
                     "riemann": "hllc"},
    "sf_params": {"n_star": 1.0, "t_star": 0.05},
    "feedback_params": {"eta_sn": 0.1, "t_sne": 1e-6},
    "units_params": {"units_density": 1.66e-24, "units_time": 3.156e13,
                     "units_length": 3.086e18},
    "output_params": {"noutput": 1, "tout": [0.02], "tend": 0.02},
}


@pytest.mark.parametrize("f_w", [0.0, 1.0])
def test_uniform_sf_matches_jax(f_w):
    """``tests/test_sf_driver.py``'s dense box through both uniform drivers
    (chunks of 4): the same stars, ids, masses and flags from the same
    draws, the state within rel 1e-10; the gas and stars keep the mass."""
    g = copy.deepcopy(SF_UNIFORM)
    g["feedback_params"]["f_w"] = f_w
    jp, pp = _both(g, 3)
    js = JSimulation(jp, dtype=jnp.float64)
    ps = Simulation(pp, dtype=torch.float64, device="cpu")
    m0 = float(ps.state.u[0].sum()) * ps.dx ** 3
    js.evolve(chunk=4)
    ps.evolve(chunk=4)
    assert ps.nstep == js.state.nstep
    act = ps.state.p.active.numpy()
    assert act.sum() > 0 and ps.n_stars() == int(act.sum())
    _same_particles(js.state.p, ps.state.p, exact=False)
    _field_close(ps.state.u.numpy(), np.asarray(js.state.u))
    m_gas = float(ps.state.u[0].sum()) * ps.dx ** 3
    assert np.isclose(m_gas + float(ps.state.p.m.numpy()[act].sum()), m0,
                      rtol=1e-10)
    # both generators drew the same numbers
    assert sf_state_from(ps) == sf_state_from(js)
    assert "stars=" in ps.status_note()
    carried = Simulation.from_state(pp, u=np.asarray(js.state.u),
                                    t=js.state.t, nstep=js.state.nstep,
                                    device="cpu",
                                    particles=particles_from(js.state.p),
                                    **sf_state_from(js))
    assert sf_state_from(carried) == sf_state_from(js)


def test_uniform_sf_restart_ids_and_headroom(tmp_path):
    """A dump and restore of the SF box: the star-id counter resumes past
    the restored ids and the restored set keeps free lanes, as the JAX
    driver's ``from_snapshot``; the next stars take new ids."""
    _, pp = _both(SF_UNIFORM, 3)
    ps = Simulation(pp, dtype=torch.float64, device="cpu")
    ps.evolve(chunk=4)
    out = ps.dump(1, str(tmp_path))
    back = Simulation.from_snapshot(pp, out, dtype=torch.float64,
                                    device="cpu")
    ids = ps.state.p.idp.numpy()[ps.state.p.active.numpy()]
    assert back._next_star_id == int(ids.max()) + 1
    assert int((~back.state.p.active).sum()) > 0
    _, p2, nid = P.star_formation(back.state.u.numpy(), back.state.p,
                                  np.random.default_rng(3), back.sf_spec,
                                  back.units, back.dx, back.t, 0.01,
                                  back._next_star_id)
    new = p2.idp.numpy()[p2.active.numpy() & ~back.state.p.active.numpy()]
    assert len(new) and not set(new) & set(ids) and nid > new.max()


def test_amr_restart_star_ids_and_headroom(tmp_path):
    """``tests/test_starform.py::test_restart_star_id_counter_and_headroom``
    on the port's hierarchy: after a dump and a restore the star-id
    counter resumes past the restored ids and the restored set keeps free
    lanes, so SF continues."""
    from ramses_tpu_torch.config import params_from_string
    txt = "\n".join([
        "&RUN_PARAMS", "hydro=.true.", "poisson=.true.", "pic=.true.", "/",
        "&AMR_PARAMS", "levelmin=4", "levelmax=4", "boxlen=1.0", "/",
        "&HYDRO_PARAMS", "courant_factor=0.5", "/",
        "&SF_PARAMS", "n_star=1e12", "t_star=1.0", "/",
        "&INIT_PARAMS", "nregion=1", "region_type(1)='square'",
        "d_region=1.0", "p_region=1.0", "/"])
    p = params_from_string(txt, ndim=2)
    rng = np.random.default_rng(9)
    n = 17
    ps = ParticleSet.make(rng.uniform(0.1, 0.9, (n, 2)), np.zeros((n, 2)),
                          np.full(n, 1.0 / n), dtype=torch.float64,
                          device="cpu", idp=np.arange(5, 5 + n))
    sim = AmrSim(p, dtype=torch.float64, device="cpu", particles=ps)
    assert sim.pic and sim.sf_spec.enabled
    out = sim.dump(1, str(tmp_path))
    back = AmrSim.from_snapshot(p, out, dtype=torch.float64, device="cpu")
    assert back._next_star_id == 5 + n
    assert int((~back.p.active).sum()) > 0


def _step_pair(js, ps, n):
    for _ in range(n):
        js.regrid()
        ps.regrid()
        dt = js.coarse_dt()
        assert ps.coarse_dt() == pytest.approx(dt, rel=1e-10)
        js.step_coarse(dt)
        ps.step_coarse(dt)
    for l in js.levels():
        _field_close(ps.u[l].numpy(), np.asarray(js.u[l]), axis=1)


@pytest.mark.parametrize("f_w", [0.0, 1.0])
def test_amr_sf_matches_jax(f_w):
    """``tests/test_amr_physics.py``'s SF blob at levelmin 4, levelmax 5
    (with self-gravity for thermal feedback), 3 coarse steps from the same
    ICs: stars on levels above levelmin with the same ids, masses,
    positions and flags, SNe fired, the state within rel 1e-10; the gas
    and stars keep the mass."""
    g = _blob(4, 5, d_in=50.0, p_in=0.5, tend=0.05,
              refine_params={"err_grad_d": 0.2},
              sf_params={"n_star": 1.0, "t_star": 0.1, "m_star": 1.0},
              feedback_params={"eta_sn": 0.1, "t_sne": 0.001, "f_w": f_w})
    g["run_params"]["poisson"] = f_w == 0.0
    jp, pp = _both(g, 3)
    js = JAmrSim(jp, dtype=jnp.float64)
    ps = AmrSim(pp, dtype=torch.float64, device="cpu")
    assert ps.pic and ps.p is not None
    m0 = ps.totals()["mass"]
    _step_pair(js, ps, 3)
    _same_particles(js.p, ps.p, exact=False)
    act = ps.p.active.numpy()
    assert act.sum() > 0 and ps._next_star_id == js._next_star_id
    assert int((ps.p.flags.numpy() & P.FLAG_SN_DONE).sum()) > 0
    from ramses_tpu_torch.pm.amr_physics import _levels_of
    assert (_levels_of(ps, ps.p.x.numpy()[act]) > ps.lmin).all()
    assert abs(ps.totals()["mass"] + float(ps.p.m.numpy()[act].sum())
               - m0) < 1e-11
    assert "stars=" in ps.status_note()
    # the SF state carries across: one more step from a carried state
    state = amr_state_from(js)
    assert state["next_star_id"] == js._next_star_id
    carried = AmrSim.from_state(pp, device="cpu",
                                particles=particles_from(js.p), **state)
    js.step_coarse(0.5 * js.coarse_dt())
    carried.step_coarse(js.dt_old)
    _same_particles(js.p, carried.p, exact=False)


@pytest.mark.parametrize("direct", [True, False])
def test_stellar_objects_match_jax(direct, tmp_path):
    """``tests/test_amr_physics.py``'s stellar set-up at levelmin 4,
    levelmax 5: sinks accrete, objects spawn every ``stellar_msink_th`` and
    explode (at birth with ``sn_direct``, else after their lifetimes),
    drawing from the SF generator: objects, sinks and state as the JAX
    run's; the dump's stellar and sink CSVs byte for byte."""
    g = _blob(4, 5, d_in=100.0, p_in=1.0, tend=0.03,
              refine_params={"err_grad_d": 0.2},
              sink_params={"create_sinks": True, "n_sink": 10.0,
                           "accretion_scheme": "threshold", "c_acc": 0.2},
              stellar_params={"stellar_msink_th": 0.002, "imf_index": -2.35,
                              "imf_low": 8.0, "imf_high": 120.0,
                              "lt_t0": 0.01 if direct else 1e-3,
                              "sn_e_ref": 0.02, "sn_direct": direct})
    jp, pp = _both(g, 3)
    js = JAmrSim(jp, dtype=jnp.float64)
    ps = AmrSim(pp, dtype=torch.float64, device="cpu")
    assert ps.stellar is not None
    e0 = ps.totals()["energy"]
    _step_pair(js, ps, 4)
    assert ps.sinks.n == js.sinks.n > 0
    assert ps.stellar.next_id == js.stellar.next_id > 1
    assert ps.stellar.dmf == pytest.approx(js.stellar.dmf, rel=1e-10)
    for k in ("m", "tform", "tlife", "idp"):
        np.testing.assert_array_equal(getattr(ps.stellar, k),
                                      getattr(js.stellar, k))
    assert ps._sf_rng.random() == js._sf_rng.random()
    if direct:
        assert ps.stellar.n == 0 and ps.totals()["energy"] > e0 + 0.015
    else:
        assert ps.stellar.n > 0
    out = ps.dump(1, str(tmp_path / "p"))
    jout = js.dump(1, str(tmp_path / "j"))
    for name in ("stellar_00001.csv", "sink_00001.csv"):
        got = open(os.path.join(out, name)).read()
        want = open(os.path.join(jout, name)).read()
        assert got.splitlines()[:2] == want.splitlines()[:2]
        if name.startswith("stellar"):
            assert got == want


def test_cosmo_gal_matches_jax(tmp_path):
    """``namelists/cosmo_gal.nml`` shrunk (16³ grafic ICs, levelmin 4,
    levelmax 5): cosmology, gravity, particles, metal cooling with
    ``pressure_fix`` (the general formulation), SF and thermal feedback;
    the port's hierarchy from the JAX run's state, 2 coarse steps: the
    state within rel 1e-10, the particles and the SF generator as JAX's."""
    from ramses_tpu.config import load_params as jload
    from ramses_tpu.driver import load_cosmo_ics as jics
    from ramses_tpu.hydro.core import HydroStatic as JHydro
    from ramses_tpu.pm.cosmology import Cosmology as JCosmology
    from ramses_tpu_torch.config import load_params as pload
    nml = _gal_nml(tmp_path)
    jp, pp = jload(nml, ndim=3), pload(nml, ndim=3)
    jpart, dense = jics(jp, JCosmology.from_params(jp),
                        JHydro.from_params(jp), (16, 16, 16))
    js = JAmrSim(jp, dtype=jnp.float64, particles=jpart, init_dense_u=dense)
    assert js.cool_tables is not None and js.sf_spec.enabled
    ps = AmrSim.from_state(pp, device="cpu", particles=particles_from(js.p),
                           **amr_state_from(js))
    assert ps.cool_tables is not None and ps.pic and ps.cfg.pressure_fix
    for _ in range(2):
        dt = js.coarse_dt()
        assert ps.coarse_dt() == pytest.approx(dt, rel=1e-10)
        js.step_coarse(dt)
        ps.step_coarse(dt)
    for l in js.levels():
        _field_close(ps.u[l].numpy(), np.asarray(js.u[l]), axis=1)
    np.testing.assert_allclose(ps.p.x.numpy(), np.asarray(js.p.x),
                               rtol=1e-10, atol=1e-12)
    assert ps._next_star_id == js._next_star_id
    assert ps._sf_rng.random() == js._sf_rng.random()


def _gal_nml(tmp_path):
    """cosmo_gal.nml at levelmin 4, levelmax 5, 2 coarse steps, its ICs a
    16³ grafic set written beside it."""
    from test_torch_cosmo import _mode_ics
    txt = open(GAL_NML).read()
    txt = re.sub(r"levelmin=\d+", "levelmin=4", txt)
    txt = re.sub(r"levelmax=\d+", "levelmax=5", txt)
    txt = txt.replace("&RUN_PARAMS", "&RUN_PARAMS\nnstepmax=2", 1)
    ics = tmp_path / "grafic_files"
    txt = txt.replace("initfile(1)='grafic_files'", f"initfile(1)='{ics}'")
    _mode_ics(str(ics), n=16, amp=0.02)
    nml = tmp_path / "cosmo_gal.nml"
    nml.write_text(txt)
    return str(nml)


def test_cosmo_gal_through_the_cli(tmp_path, monkeypatch, capsys):
    """The shrunk ``cosmo_gal.nml`` through ``python -m ramses_tpu_torch``
    (in process, f64, the CPU): rc 0, the ``cosmo-amr`` line with the star
    count, an ``output_00001`` that validates."""
    import signal

    from ramses_tpu_torch.__main__ import main
    from ramses_tpu_torch.resilience import checkpoint as ckpt
    nml = _gal_nml(tmp_path)
    monkeypatch.chdir(tmp_path)
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT,
                                              signal.SIGUSR1)}
    try:
        assert main([nml, "--dtype", "float64", "--device", "cpu"]) == 0
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    lines = capsys.readouterr().out.strip().splitlines()
    cosmo = [ln for ln in lines if ln.startswith("cosmo-amr aexp=")]
    assert len(cosmo) == 1 and "nstep=2" in cosmo[0]
    assert re.search(r" stars=\d+$", cosmo[0])
    assert ckpt.validate_checkpoint(str(tmp_path / "output_00001"))[0]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals_by_name():
    from ramses_tpu_torch.driver import unported_features
    from ramses_tpu_torch.mhd.amr import MhdAmrSim
    from ramses_tpu_torch.mhd.driver import MhdSimulation
    from ramses_tpu_torch.parallel.amr_sharded import ShardedAmrSim
    from ramses_tpu_torch.parallel.mesh import ShardMesh
    g = copy.deepcopy(SF_UNIFORM)
    g["cooling_params"] = {"cooling": True}
    g["stellar_params"] = {"stellar_msink_th": 0.1}
    names = unported_features(pdict(copy.deepcopy(g), ndim=3))
    assert not any(w in n for n in names for w in
                   ("cooling", "star formation", "stellar"))
    stellar = copy.deepcopy(SF_UNIFORM)
    stellar["stellar_params"] = {"stellar_msink_th": 0.1}
    with pytest.raises(NotImplementedError, match="stellar objects on the "
                                                  "uniform grid"):
        Simulation(pdict(stellar, ndim=3), device="cpu")
    nopic = copy.deepcopy(SF_UNIFORM)
    nopic["run_params"]["pic"] = False
    with pytest.raises(NotImplementedError, match="star formation on the "
                                                  "uniform grid without "
                                                  "particles"):
        Simulation(pdict(nopic, ndim=3), device="cpu")
    mhd = copy.deepcopy(SF_UNIFORM)
    mhd["run_params"]["pic"] = False
    mhd["init_params"]["A_region"] = [1.0]
    mhd["hydro_params"]["riemann"] = "llf"
    mhd["cooling_params"] = {"cooling": True}
    mhd["stellar_params"] = {"stellar_msink_th": 0.1}
    for cls, lmax in ((MhdSimulation, 3), (MhdAmrSim, 4)):
        m = copy.deepcopy(mhd)
        m["amr_params"]["levelmax"] = lmax
        with pytest.raises(NotImplementedError) as err:
            cls(pdict(m, ndim=3), device="cpu")
        for name in ("cooling on the MHD drivers",
                     "star formation on the MHD drivers",
                     "stellar objects on the MHD drivers"):
            assert name in str(err.value)
    sharded = _blob(4, 5, sf_params={"n_star": 1.0})
    with pytest.raises(NotImplementedError,
                       match="star formation on ShardedAmrSim"):
        ShardedAmrSim(pdict(sharded, ndim=3), devices=ShardMesh(["cpu"] * 2))
