"""Cosmology and the cosmological ICs of the port against the JAX package's,
on the CPU in f64.

* ``pm/cosmology``: the Friedmann tables and the interpolators (host
  numbers and tensors) within ``FIELD`` (1e-12);
* ``io/grafic`` and ``io/gadget``: the files the port writes are byte for
  byte the JAX package's (``write_grafic``, ``write_zeldovich_ics`` on the
  same δ, ``write_gadget``, ``dump_gadget_particles``);
  ``particles_from_grafic``, ``baryons_from_grafic`` and
  ``particles_from_gadget`` give equal arrays;
* the uniform ``Simulation`` on ``tests/test_cosmo_ics.py``'s single-mode
  ICs at 16³ (N-body, and with baryons), 5 steps: u, the particles and the
  force within 1e-10 of their scale, the same conformal time; the JAX
  run's state carried across dumps JAX's bytes (the gadget side file
  too), and its dump restored by both steps on equal;
* ``AmrSim`` at levelmin 4, levelmax 5 with particles, gas, self-gravity
  and the supercomoving clock on a single mode: 3 coarse steps across a
  regrid at the JAX run's dt: equal trees, rows within
  ``test_torch_amr.py``'s tolerances, phi, fg and the particles within
  1e-10 of their scale, equal ``poisson_iters``; a dump with particles
  byte for byte JAX's, restored by both and stepped on;
* ``namelists/cosmo.nml`` through the port's CLI, shrunk as
  ``tests/test_cosmo_ics.py``'s namelist runs shrink it;
* the refusals that stay: cosmology on the MHD drivers and on
  ``ShardedAmrSim``, the lightcone and the clump finder on the uniform
  ``Simulation`` and the MHD drivers (the hydro hierarchy runs both).

The hierarchy's mode is δ = −A·cos(2πx) (the density peak in the middle
of the box): with the peak at the origin the refined flat cell 0 of the
base level meets the JAX package's own fault in ``restrict_upload``
(ROADMAP §C1, pinned by ``tests/test_torch_amr.py::
test_corner_blast_restricts_every_refined_cell``), whose stale value the
base level's FFT solve then spreads through the whole box.
"""

import filecmp
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.config import Params as JParams  # noqa: E402
from ramses_tpu.driver import Simulation as JSimulation  # noqa: E402
from ramses_tpu.driver import load_cosmo_ics as jload_ics  # noqa: E402
from ramses_tpu.hydro.core import HydroStatic as JHydro  # noqa: E402
from ramses_tpu.io import gadget as jgadget  # noqa: E402
from ramses_tpu.io import grafic as jgrafic  # noqa: E402
from ramses_tpu.pm import init_part as jinit  # noqa: E402
from ramses_tpu.pm import particles as jp  # noqa: E402
from ramses_tpu.pm.cosmology import Cosmology as JCosmology  # noqa: E402

from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import Params  # noqa: E402
from ramses_tpu_torch.convert import particles_from  # noqa: E402
from ramses_tpu_torch.driver import Simulation  # noqa: E402
from ramses_tpu_torch.driver import load_cosmo_ics  # noqa: E402
from ramses_tpu_torch.hydro.core import HydroStatic  # noqa: E402
from ramses_tpu_torch.io import gadget as pgadget  # noqa: E402
from ramses_tpu_torch.io import grafic as pgrafic  # noqa: E402
from ramses_tpu_torch.pm import cosmology as pcosmo  # noqa: E402
from ramses_tpu_torch.pm import init_part as pinit  # noqa: E402
from ramses_tpu_torch.resilience import checkpoint as ckpt  # noqa: E402

from test_torch_amr import ATOL, RTOL  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COSMO_NML = os.path.join(ROOT, "namelists", "cosmo.nml")
FIELD = 1e-12     # tables, interpolators and IC arrays against their scale
STATE = 1e-10     # stepped states (u, phi, fg, particles) against their scale


def _close(got, want, tol=STATE, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} of scale {scale:.3e}"


def _same_files(a, b):
    names = sorted(n for n in os.listdir(a) if n != "manifest.json")
    assert names == sorted(n for n in os.listdir(b) if n != "manifest.json")
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n
    return names


def _mode_ics(dirname, n=16, amp=0.02, sign=1.0):
    """A grafic directory of δ = sign·amp·cos(2πx) and its Zel'dovich
    velocities (EdS, astart 0.02), written by the JAX package."""
    x = (np.arange(n) + 0.5) / n
    delta = (sign * amp * np.cos(2 * np.pi * x))[:, None, None] \
        * np.ones((1, n, n))
    hdr = jgrafic.GraficHeader(n, n, n, dx=100.0 / n, astart=0.02,
                               omega_m=1.0, omega_v=0.0, h0=70.0)
    jgrafic.write_zeldovich_ics(dirname, delta, hdr,
                                jinit.fpeebl(0.02, 1.0, 0.0, 0.0))


def _params(cls, lmin, lmax, initdir, hydro, omega_b=0.045):
    """``tests/test_cosmo_ics.py``'s ``_cosmo_params`` for either package's
    ``Params``."""
    p = cls(ndim=3)
    p.run.cosmo = p.run.pic = p.run.poisson = True
    p.run.hydro = hydro
    p.amr.levelmin, p.amr.levelmax, p.amr.boxlen = lmin, lmax, 1.0
    p.init.filetype = "grafic"
    p.init.initfile = [initdir]
    p.init.aexp_ini = 0.02
    p.raw = {"cosmo_params": {"omega_m": 1.0, "omega_l": 0.0,
                              "omega_b": omega_b if hydro else 0.0,
                              "h0": 70.0, "aexp": 0.02,
                              "boxlen_ini": 100.0}}
    return p


# ---------------------------------------------------------------------------
# the Friedmann tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("om,ol", [(1.0, 0.0), (0.3, 0.7), (0.27, 0.6)])
def test_friedmann_tables_match_jax(om, ol):
    kw = dict(omega_m=om, omega_l=ol, omega_k=1.0 - om - ol, aexp_ini=0.02)
    jc, pc = JCosmology(**kw), pcosmo.Cosmology(**kw)
    for name in ("axp_frw", "hexp_frw", "tau_frw", "t_frw", "chi_frw"):
        _close(np.array(getattr(pc, name)), np.array(getattr(jc, name)),
               tol=FIELD, what=name)
    assert pc.tau_ini == pytest.approx(jc.tau_ini, rel=FIELD)
    assert pc.age_of_universe() == pytest.approx(jc.age_of_universe(),
                                                 rel=FIELD)
    # sign-safe round trip through the conformal time
    for a in (0.02, 0.05, 0.3, 1.0):
        assert pc.aexp_of_tau(pc.tau_of_aexp(a)) == pytest.approx(a,
                                                                  rel=1e-6)


@pytest.mark.parametrize("fn", ["aexp_of_tau", "hexp_of_tau", "t_of_tau",
                                "tau_of_aexp", "chi_of_aexp"])
def test_interpolators_match_jax(fn):
    jc = JCosmology(omega_m=0.3, omega_l=0.7, aexp_ini=0.02)
    pc = pcosmo.Cosmology(omega_m=0.3, omega_l=0.7, aexp_ini=0.02)
    src = "axp_frw" if fn.endswith("aexp") else "tau_frw"
    lo, hi = min(getattr(pc, src)), max(getattr(pc, src))
    # inside the table, on its knots and past both ends (clamped)
    xs = np.concatenate([np.linspace(lo, hi, 37), getattr(pc, src)[::97],
                         [lo - 1.0, hi + 0.5]])
    want = np.asarray(getattr(jc, fn)(jnp.asarray(xs)))
    got_t = getattr(pc, fn)(torch.tensor(xs))
    assert got_t.dtype == torch.float64
    _close(got_t, want, tol=FIELD, what=f"{fn} on a tensor")
    got_h = np.array([getattr(pc, fn)(float(x)) for x in xs])
    _close(got_h, want, tol=FIELD, what=f"{fn} on host numbers")


def test_hierarchy_epoch_is_the_jax_hierarchys_to_the_bit():
    """``AmrSim.aexp_now``, ``hexp_now`` and ``grav_coeff`` equal the JAX
    hierarchy's bitwise at 200 random conformal times from aexp 0.02 to 1
    and at those of 20000 where numpy's interpolation, which both
    hierarchies take, rounds otherwise than ``jnp.interp``'s
    (``Cosmology.aexp_of_tau`` on a tensor)."""
    from types import SimpleNamespace
    kw = dict(omega_m=0.3, omega_l=0.7, aexp_ini=0.02)
    jc, pc = JCosmology(**kw), pcosmo.Cosmology(**kw)
    taus = np.random.default_rng(13).uniform(pc.tau_of_aexp(0.02),
                                             pc.tau_of_aexp(1.0), 20000)
    apart = np.zeros(len(taus), dtype=bool)
    for tab in ("axp_frw", "hexp_frw"):
        jnp_style = pcosmo.interp_tensor(
            torch.tensor(taus), torch.tensor(pc.tau_frw),
            torch.tensor(getattr(pc, tab))).numpy()
        apart |= np.interp(taus, pc.tau_frw, getattr(pc, tab)) != jnp_style
    assert apart.any()
    for tau in np.concatenate([taus[apart], taus[:200]]):
        js = SimpleNamespace(cosmo=jc, t=float(tau))
        ps = SimpleNamespace(cosmo=pc, t=float(tau))
        js.aexp_now = lambda: JAmrSim.aexp_now(js)
        ps.aexp_now = lambda: AmrSim.aexp_now(ps)
        for fn in ("aexp_now", "hexp_now", "grav_coeff"):
            assert getattr(AmrSim, fn)(ps) == getattr(JAmrSim, fn)(js), \
                (fn, tau)


# ---------------------------------------------------------------------------
# IC files
# ---------------------------------------------------------------------------

def test_grafic_and_zeldovich_files_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    hdr = dict(np1=8, np2=6, np3=4, dx=1.5, x1o=0.25, astart=0.02,
               omega_m=0.3, omega_v=0.7, h0=68.0)
    field = rng.standard_normal((8, 6, 4)).astype(np.float32)
    jgrafic.write_grafic(str(tmp_path / "j"), jgrafic.GraficHeader(**hdr),
                         field)
    pgrafic.write_grafic(str(tmp_path / "p"), pgrafic.GraficHeader(**hdr),
                         field)
    assert filecmp.cmp(tmp_path / "j", tmp_path / "p", shallow=False)
    h, f = pgrafic.read_grafic(str(tmp_path / "j"))
    assert np.array_equal(f, field) and (h.np1, h.np2, h.np3) == (8, 6, 4)
    delta = 0.1 * rng.standard_normal((8, 8, 8))
    cube = dict(hdr, np2=8, np3=8)
    f_om = pinit.fpeebl(0.02, 0.3, 0.7, 0.0)
    assert f_om == jinit.fpeebl(0.02, 0.3, 0.7, 0.0)
    jgrafic.write_zeldovich_ics(str(tmp_path / "jz"), delta,
                                jgrafic.GraficHeader(**cube), f_om)
    pgrafic.write_zeldovich_ics(str(tmp_path / "pz"), delta,
                                pgrafic.GraficHeader(**cube), f_om)
    names = _same_files(str(tmp_path / "jz"), str(tmp_path / "pz"))
    assert len(names) == 7
    ph, pf = pgrafic.read_grafic_dir(str(tmp_path / "jz"))
    jh, jf = jgrafic.read_grafic_dir(str(tmp_path / "jz"))
    assert ph.__dict__ == jh.__dict__ and sorted(pf) == sorted(jf)


def test_grafic_ics_match_jax(tmp_path):
    _mode_ics(str(tmp_path), n=8, amp=0.03)
    jc = JCosmology(aexp_ini=0.02)
    pc = pcosmo.Cosmology(aexp_ini=0.02)
    jx = jinit.particles_from_grafic(str(tmp_path), jc, omega_b=0.045)
    px = pinit.particles_from_grafic(str(tmp_path), pc, omega_b=0.045)
    for a, b in zip(px[:3], jx[:3]):
        assert np.array_equal(a, b)
    jb, _ = jinit.baryons_from_grafic(str(tmp_path), jc, 5 / 3, 0.045)
    pb, _ = pinit.baryons_from_grafic(str(tmp_path), pc, 5 / 3, 0.045)
    assert np.array_equal(pb, jb)


def test_gadget_files_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    n = 64
    kw = dict(npart=(0, n, 0, 0, 0, 0), mass=(0, 0.1, 0, 0, 0, 0),
              time=0.05, redshift=19.0, boxsize=10000.0, omega0=1.0,
              omega_l=0.0, hubble=0.7)
    pos = rng.random((n, 3)) * 10000.0
    vel = rng.standard_normal((n, 3)) * 100.0
    ids = np.arange(n, dtype=np.uint32)
    jgadget.write_gadget(str(tmp_path / "j"), jgadget.GadgetHeader(**kw),
                         pos, vel, ids)
    pgadget.write_gadget(str(tmp_path / "p"), pgadget.GadgetHeader(**kw),
                         pos, vel, ids)
    assert filecmp.cmp(tmp_path / "j", tmp_path / "p", shallow=False)
    jx = jinit.particles_from_gadget(str(tmp_path / "j"), None)
    px = pinit.particles_from_gadget(str(tmp_path / "j"), None)
    for a, b in zip(px[:3], jx[:3]):
        assert np.array_equal(a, b)
    # &OUTPUT_PARAMS savegadget's writer on a set with inactive lanes
    jset = jp.ParticleSet.make(jnp.asarray(rng.random((10, 2))),
                               jnp.asarray(rng.random((10, 2))),
                               jnp.asarray(rng.random(10)), nmax=13)
    jgadget.dump_gadget_particles(str(tmp_path / "jg"), jset, 2.0, 0.7)
    pgadget.dump_gadget_particles(str(tmp_path / "pg"),
                                  particles_from(jset), 2.0, 0.7)
    assert filecmp.cmp(tmp_path / "jg", tmp_path / "pg", shallow=False)


# ---------------------------------------------------------------------------
# the uniform driver
# ---------------------------------------------------------------------------

def _uniform_pair(d, hydro, nstep=5, savegadget=False):
    _mode_ics(d, n=16, amp=0.02)
    tau_end = JCosmology(aexp_ini=0.02).tau_of_aexp(0.06)
    out = []
    for cls in (JParams, Params):
        p = _params(cls, 4, 4, d, hydro)
        p.run.nstepmax = nstep
        p.output.tout, p.output.noutput = [float(tau_end)], 1
        p.output.savegadget = savegadget
        out.append(p)
    jsim = JSimulation(out[0], dtype=jnp.float64)
    psim = Simulation(out[1], dtype=torch.float64, device="cpu")
    return jsim, psim


def _same_uniform(jsim, psim):
    assert psim.state.nstep == jsim.state.nstep
    assert psim.t == jsim.t
    assert psim.cosmo.aexp_of_tau(psim.t) == float(
        jsim.cosmo.aexp_of_tau(jsim.t))
    _close(psim.state.u, jsim.state.u, what="u")
    _close(psim.state.f, jsim.state.f, what="f")
    _close(psim.state.p.x, jsim.state.p.x, what="x")
    _close(psim.state.p.v, jsim.state.p.v, what="v")
    assert psim.state.dt_old == pytest.approx(jsim.state.dt_old, rel=1e-12)


@pytest.mark.parametrize("hydro", [False, True], ids=["nbody", "baryons"])
def test_uniform_cosmo_matches_jax(hydro, tmp_path):
    jsim, psim = _uniform_pair(str(tmp_path), hydro)
    assert psim.t == jsim.t < 0 and psim.output_times == jsim.output_times
    _close(psim.state.f, jsim.state.f, what="initial f")
    jsim.evolve(chunk=2)
    psim.evolve(chunk=2)
    assert psim.state.nstep == 5
    _same_uniform(jsim, psim)


def test_uniform_cosmo_dump_and_restore(tmp_path):
    """The JAX run's state after 3 steps carried to the port
    (``from_state``) dumps the JAX package's bytes, the gadget side file
    included; the JAX dump restored by both packages (the force at the
    restored epoch) steps on equal for 2 more steps."""
    jsim, psim = _uniform_pair(str(tmp_path / "ics"), True, nstep=3,
                               savegadget=True)
    jsim.evolve(chunk=3)
    st = jsim.state
    psim = Simulation.from_state(
        psim.params, np.asarray(st.u), st.t, st.nstep, device="cpu",
        particles=particles_from(st.p), f=np.asarray(st.f),
        dt_old=st.dt_old)
    jo = jsim.dump(1, str(tmp_path / "j"))
    po = psim.dump(1, str(tmp_path / "p"))
    names = _same_files(jo, po)
    assert "part_00001.out00001" in names and "gadget_00001.dat" in names
    assert ckpt.validate_checkpoint(po)[0]
    jp_, pp_ = jsim.params, psim.params
    jp_.run.nstepmax = pp_.run.nstepmax = 5
    jr = JSimulation.from_snapshot(jp_, jo, dtype=jnp.float64)
    pr = Simulation.from_snapshot(pp_, jo, dtype=torch.float64,
                                  device="cpu")
    assert pr.state.p.n == 16 ** 3 and pr.t == jr.t
    _close(pr.state.f, jr.state.f, what="restored f")
    # the dump keeps no dt_old: both restart their split kick from 0
    jr.evolve(chunk=2)
    pr.evolve(chunk=2)
    _same_uniform(jr, pr)


# ---------------------------------------------------------------------------
# the hierarchy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def amr_pair(tmp_path_factory):
    """Both packages' hierarchies from one grafic set (module scope: one
    JAX run for the tests below)."""
    d = str(tmp_path_factory.mktemp("ics"))
    _mode_ics(d, n=16, amp=0.05, sign=-1.0)
    sims = []
    for cls, load, hydro_cls, sim_cls, kw in (
            (JParams, jload_ics, JHydro, JAmrSim,
             dict(dtype=jnp.float64)),
            (Params, load_cosmo_ics, HydroStatic, AmrSim,
             dict(dtype=torch.float64, device="cpu"))):
        p = _params(cls, 4, 5, d, True)
        # with 16³ particles on 16³ level-4 cells one particle a cell is
        # the mean: 1.08 mean masses flags the overdense slab, a partial
        # level 5 (the value 4 of test_cosmo_amr_growth flags none here)
        p.refine.m_refine = [1.08] * 10
        cosmo = (JCosmology if cls is JParams
                 else pcosmo.Cosmology).from_params(p)
        extra = (() if cls is JParams else (torch.float64, "cpu"))
        parts, dense = load(p, cosmo, hydro_cls.from_params(p), (16,) * 3,
                            *extra)
        sims.append(sim_cls(p, particles=parts, init_dense_u=dense, **kw))
    jsim, psim = sims
    record = []
    for k in range(3):
        if k == 1:
            jsim.regrid()
            psim.regrid()
        dt = jsim.coarse_dt()
        record.append((dt, psim.coarse_dt()))
        jsim.step_coarse(dt)
        psim.step_coarse(dt)
    return jsim, psim, record


def test_amr_cosmo_matches_jax_across_a_regrid(amr_pair):
    jsim, psim, record = amr_pair
    for want, got in record:
        assert got == pytest.approx(want, rel=1e-12)
    assert psim.aexp_now() == jsim.aexp_now() > 0.02
    assert psim.grav_coeff() == jsim.grav_coeff()
    assert jsim.levels() == psim.levels() == [4, 5]
    assert 0 < psim.tree.noct(5) < 8 ** 4
    for l in jsim.levels():
        assert np.array_equal(jsim.tree.levels[l].keys,
                              psim.tree.levels[l].keys), l
        n = jsim.tree.noct(l) * 8
        np.testing.assert_allclose(psim.u[l].numpy()[:n],
                                   np.asarray(jsim.u[l])[:n], rtol=RTOL,
                                   atol=ATOL, err_msg=f"level {l}")
        _close(psim.phi[l][:n], np.asarray(jsim.phi[l])[:n],
               what=f"phi {l}")
        _close(psim.fg[l][:n], np.asarray(jsim.fg[l])[:n], what=f"fg {l}")
    assert ({l: int(v) for l, v in psim.poisson_iters.items()}
            == {l: int(v) for l, v in jsim.poisson_iters.items()} != {})
    _close(psim.p.x, jsim.p.x, what="x")
    _close(psim.p.v, jsim.p.v, what="v")
    assert psim._rho_max == pytest.approx(jsim._rho_max, rel=1e-12)


def test_amr_cosmo_dump_and_restore(amr_pair, tmp_path):
    """The JAX run's state carried to the port (``particles_from``) dumps
    the JAX package's bytes; the JAX dump, restored by both (maps, solve
    and free-fall cap primed at the restored epoch, ``dtold`` and the next
    dt from the amr file), steps on equal."""
    from ramses_tpu_torch.convert import amr_state_from
    jsim, psim, _ = amr_pair
    carried = AmrSim.from_state(psim.params, **amr_state_from(jsim),
                                particles=particles_from(jsim.p),
                                dt_next=float(jsim._dt_cache), device="cpu")
    assert carried.pic and carried.cosmo is not None
    jo = jsim.dump(1, str(tmp_path / "j"))
    po = carried.dump(1, str(tmp_path / "p"))
    names = _same_files(jo, po)
    assert "part_00001.out00001" in names
    jr = JAmrSim.from_snapshot(jsim.params, jo, dtype=jnp.float64)
    pr = AmrSim.from_snapshot(psim.params, jo, dtype=torch.float64,
                              device="cpu")
    assert pr.p.n == 16 ** 3 and pr.dt_old == jr.dt_old == jsim.dt_old
    assert pr.t == jr.t and pr._rho_max == pytest.approx(jr._rho_max,
                                                         rel=1e-12)
    dt = jr.coarse_dt()
    assert pr.coarse_dt() == pytest.approx(dt, rel=1e-12)
    jr.step_coarse(dt)
    pr.step_coarse(dt)
    for l in jr.levels():
        n = jr.tree.noct(l) * 8
        np.testing.assert_allclose(pr.u[l].numpy()[:n],
                                   np.asarray(jr.u[l])[:n], rtol=RTOL,
                                   atol=ATOL, err_msg=f"level {l}")
    _close(pr.p.x, jr.p.x, what="x")
    _close(pr.p.v, jr.p.v, what="v")


def test_cosmo_nml_through_the_cli(tmp_path, monkeypatch, capsys):
    """``namelists/cosmo.nml`` shrunk as ``tests/test_cosmo_ics.py:262-290``
    shrinks its siblings (16³ ICs, levelmin 4, levelmax 5, 2 coarse steps,
    aout=1.0): the port's CLI runs the hierarchy, prints the ``cosmo-amr``
    line and writes an ``output_00001`` whose part file holds the 16³
    particles and validates."""
    from ramses_tpu_torch.__main__ import main
    from ramses_tpu_torch.io import reader
    txt = open(COSMO_NML).read()
    txt = re.sub(r"levelmin=\d+", "levelmin=4", txt)
    txt = re.sub(r"levelmax=\d+", "levelmax=5", txt)
    txt = txt.replace("&RUN_PARAMS", "&RUN_PARAMS\nnstepmax=2", 1)
    txt = re.sub(r"aout=[0-9.,]+", "aout=1.0", txt)
    txt = re.sub(r"noutput=\d+", "noutput=1", txt)
    nml = tmp_path / "cosmo.nml"
    nml.write_text(txt)
    _mode_ics(str(tmp_path / "grafic_files"), n=16, amp=0.02)
    monkeypatch.chdir(tmp_path)
    import signal
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT,
                                              signal.SIGUSR1)}
    try:
        assert main([str(nml), "--dtype", "float64", "--device", "cpu"]) == 0
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    lines = capsys.readouterr().out.strip().splitlines()
    cosmo = [ln for ln in lines if ln.startswith("cosmo-amr aexp=")]
    assert len(cosmo) == 1 and "nstep=2" in cosmo[0]
    assert float(cosmo[0].split()[1].split("=")[1]) > 0.02
    out = tmp_path / "output_00001"
    assert ckpt.validate_checkpoint(str(out))[0]
    snap = reader.load_snapshot(str(out))
    assert len(snap["part"][0]["mass"]) == 16 ** 3


def test_cosmology_refusals_and_the_end_time():
    from ramses_tpu_torch.driver import namelist_driver, unported_features
    from ramses_tpu_torch.mhd.driver import unported_mhd_features
    from ramses_tpu_torch.parallel.amr_sharded import ShardedAmrSim
    from ramses_tpu_torch.parallel.mesh import ShardMesh
    p = _params(Params, 4, 5, "", True)
    p.run.pic = False
    p.output.aout = [0.1, 0.5]
    cls, tend = namelist_driver(p)
    assert cls is AmrSim and tend < 0
    assert tend == pcosmo.Cosmology.from_params(p).tau_of_aexp(0.5)
    assert [n for n in unported_mhd_features(p) if "cosmology" in n]
    with pytest.raises(NotImplementedError, match="cosmology on Sharded"):
        ShardedAmrSim(p, devices=ShardMesh(["cpu"] * 2))
    # the hydro hierarchy runs the lightcone and the clump finder (its
    # shell chain seeded at the run's start); the uniform Simulation and
    # the MHD drivers refuse both by name; the non-cubic gate names
    # clumpfind
    p.run.lightcone = True
    p.run.clumpfind = True
    assert not [n for n in unported_features(p)
                if "lightcone" in n or "clump" in n]
    sim = AmrSim(p, device="cpu")
    assert sim._cone_aexp_prev == sim.cosmo.aexp_ini
    names = unported_mhd_features(p)
    for key in ("lightcone", "clump finder"):
        assert [n for n in names if key in n and "MHD drivers" in n]
    u = _params(Params, 3, 3, "", False)
    u.run.lightcone = u.run.clumpfind = True
    with pytest.raises(NotImplementedError,
                       match="lightcone .*uniform Simulation.*clump finder"):
        Simulation(u, device="cpu")
    p.amr.nx = 2
    with pytest.raises(NotImplementedError, match="non-cubic.*clumpfind"):
        AmrSim(p, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Simulation(_params(Params, 3, 3, "", False))
