"""Self-gravity in the port's drivers against the JAX package's, on the CPU
in f64.

* ``amr/maps``: ``build_gravity_maps`` and ``build_mg_lattices``
  integer-equal on small hierarchies' trees (periodic and open), and the
  restriction's child tables (``mg_children``) summing as a scatter-add;
* ``pcg_level`` on the input of ``tests/test_amr_gravity.py::
  test_pcg_convergence_control_and_iters``: equal iteration counts, phi
  within 1e-9;
* the uniform ``Simulation`` with ``poisson`` (FFT, multigrid and the
  isolated solve of an open box), a few steps: u and f within 1e-10 of
  their scale;
* ``AmrSim`` sedov3d at levelmin 4, levelmax 5 with ``poisson``: 2 coarse
  steps, a regrid and 1 step, rows within ``test_torch_amr.py``'s
  tolerances, phi and fg within 1e-10 of their scale, equal
  ``poisson_iters``; and a step from the JAX run's state;
* the point-mass force law on the port alone, as the JAX test judges it;
* the refusals that stay: MHD with ``poisson``, ``pic`` or ``cosmo``,
  ``ShardedAmrSim`` with ``poisson``, ``pic`` or ``cosmo``, and reflecting
  walls with self-gravity (``pic`` itself runs on the hydro drivers);
* ``namelists/pointmass.nml`` through the CLI and ``run_namelist``.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr import maps as jmaps  # noqa: E402
from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.amr.hierarchy import _Cfg1 as JCfg1  # noqa: E402
from ramses_tpu.amr import kernels as JK  # noqa: E402
from ramses_tpu.config import params_from_dict as jdict  # noqa: E402
from ramses_tpu.config import params_from_string as jparams  # noqa: E402
from ramses_tpu.driver import Simulation as JSimulation  # noqa: E402
from ramses_tpu.poisson import amr_solve as jgs  # noqa: E402

from ramses_tpu_torch.amr import maps as pmaps  # noqa: E402
from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.amr.tree import Octree  # noqa: E402
from ramses_tpu_torch.config import load_params  # noqa: E402
from ramses_tpu_torch.config import params_from_dict as pdict  # noqa: E402
from ramses_tpu_torch.config import params_from_string as pparams  # noqa: E402
from ramses_tpu_torch.convert import amr_state_from  # noqa: E402
from ramses_tpu_torch.convert import gravity_maps_from  # noqa: E402
from ramses_tpu_torch.driver import Simulation, run_namelist  # noqa: E402
from ramses_tpu_torch.poisson import amr_solve as pgs  # noqa: E402

from test_torch_amr import ATOL, RTOL, _same_run, _text  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTMASS = os.path.join(ROOT, "namelists", "pointmass.nml")
TUBE = os.path.join(ROOT, "namelists", "tube_mhd.nml")
OT_NML = os.path.join(ROOT, "namelists", "orszag2d.nml")
FIELD = 1e-10            # phi, fg and the uniform state against their scale


def _blob(lmin=4, lmax=5, ndim=2, d0=50.0, bound=False, solver=None,
          nstepmax=None):
    """``tests/test_amr_gravity.py``'s blob: a dense square in a uniform
    box, as a groups dict both packages load."""
    g = {
        "run_params": {"hydro": True, "poisson": True},
        "amr_params": {"levelmin": lmin, "levelmax": lmax, "boxlen": 1.0},
        "init_params": {"nregion": 2,
                        "region_type": ["square", "square"],
                        "x_center": [0.5, 0.5], "y_center": [0.5, 0.5],
                        "z_center": [0.5, 0.5],
                        "length_x": [10.0, 0.25], "length_y": [10.0, 0.25],
                        "length_z": [10.0, 0.25],
                        "exp_region": [10.0, 2.0],
                        "d_region": [1.0, d0],
                        "p_region": [10.0, 10.0]},
        "hydro_params": {"gamma": 1.4, "courant_factor": 0.5,
                         "riemann": "hllc"},
        "refine_params": {"err_grad_d": 0.2},
        "output_params": {"tend": 0.01},
    }
    if bound:
        # outflow on every face: the isolated solve
        g["boundary_params"] = {
            "nboundary": 2 * ndim, "bound_type": [2] * (2 * ndim),
            "ibound_min": [-1, 1] + [0] * (2 * ndim - 2),
            "ibound_max": [-1, 1] + [0] * (2 * ndim - 2),
            "jbound_min": [0, 0, -1, 1] + [0] * (2 * ndim - 4),
            "jbound_max": [0, 0, -1, 1] + [0] * (2 * ndim - 4),
            "kbound_min": [0] * 4 + [-1, 1][:2 * ndim - 4],
            "kbound_max": [0] * 4 + [-1, 1][:2 * ndim - 4]}
    if solver is not None:
        g["poisson_params"] = {"solver": solver}
    if nstepmax is not None:
        g["run_params"]["nstepmax"] = nstepmax
    return g


def _port_tree(jtree):
    t = Octree(jtree.ndim, jtree.levelmin, jtree.levelmax)
    for l, lev in jtree.levels.items():
        t.set_level(l, lev.og)
    return t


def _scale_close(got, want, tol=FIELD, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: max|Δ|/max|want| = {err:.3e}"


# ---------------------------------------------------------------------------
# maps
# ---------------------------------------------------------------------------

GMAP_FIELDS = ("nb", "g_cell", "g_nb", "g_sgn", "valid_cell", "oct_nb")


@pytest.fixture(scope="module")
def trees():
    """The JAX package's initial trees: the sedov3d hierarchy of
    ``test_torch_amr.py`` (periodic) and the 2D blob refined to level 6 in
    an open box."""
    sed = JAmrSim(jparams(_text(), ndim=3), dtype=jnp.float64)
    blob = JAmrSim(jdict(_blob(lmin=4, lmax=6, bound=True), ndim=2),
                   dtype=jnp.float64)
    return {"sedov3d": (sed.tree, sed.bc_kinds, sed.maps),
            "blob2d-open": (blob.tree, blob.bc_kinds, blob.maps)}


@pytest.mark.parametrize("name", ["sedov3d", "blob2d-open"])
def test_gravity_maps_match(trees, name):
    jtree, kinds, jm = trees[name]
    ptree = _port_tree(jtree)
    partial = [l for l in jtree.levels if not jm[l].complete]
    assert partial, name
    for l in partial:
        want = jmaps.build_gravity_maps(jtree, l, kinds,
                                        noct_pad=jm[l].noct_pad)
        got = pmaps.build_gravity_maps(ptree, l, list(kinds),
                                       noct_pad=jm[l].noct_pad)
        for f in ("lvl", "ncell", "ncell_pad", "ng", "ng_pad"):
            assert getattr(got, f) == getattr(want, f), (l, f)
        for f in GMAP_FIELDS:
            a, b = getattr(got, f), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (l, f)
        assert len(got.mg) == len(want.mg) >= 1, (l, len(want.mg))
        for (nb, par, n), (jnb, jpar, jn) in zip(got.mg, want.mg):
            assert n == jn and np.array_equal(nb, jnb) \
                and np.array_equal(par, jpar), l
        # the converter carries the JAX package's maps across unchanged
        conv = gravity_maps_from(want)
        for f in GMAP_FIELDS:
            assert np.array_equal(getattr(conv, f), getattr(got, f)), f


@pytest.mark.parametrize("name", ["sedov3d", "blob2d-open"])
def test_mg_lattices_and_child_tables(trees, name):
    """``build_mg_lattices`` integer-equal from the level's oct set alone,
    with a lower stop; each depth's child table sums a residual exactly as
    a sequential scatter-add does."""
    jtree, kinds, jm = trees[name]
    rng = np.random.default_rng(3)
    for l in (l for l in jtree.levels if not jm[l].complete):
        og = jtree.levels[l].og
        noct, pad = jtree.noct(l), jm[l].noct_pad
        want = jmaps.build_mg_lattices(og, l, kinds, noct, pad, min_n=4)
        got = pmaps.build_mg_lattices(og, l, list(kinds), noct, pad,
                                      min_n=4)
        assert len(got) == len(want)
        for (nb, par, n), (jnb, jpar, jn) in zip(got, want):
            assert n == jn and np.array_equal(nb, jnb) \
                and np.array_equal(par, jpar)
            kids = pmaps.mg_children(par, nb.shape[0])
            x = rng.standard_normal(len(par))
            ref = np.zeros(nb.shape[0])
            ok = par < nb.shape[0]
            np.add.at(ref, par[ok], x[ok])
            got_sum = pgs._restrict_children(torch.from_numpy(x),
                                             torch.from_numpy(kids))
            assert np.array_equal(got_sum.numpy(), ref)


# ---------------------------------------------------------------------------
# the PCG on the JAX test's input
# ---------------------------------------------------------------------------

def test_pcg_level_matches_on_the_blob():
    """``test_pcg_convergence_control_and_iters``'s input: the 2D blob at
    levelmin 4, levelmax 5.  The solve of both hierarchies (equal
    ``poisson_iters``, phi and fg within 1e-9), then ``pcg_level`` alone on
    the JAX package's own arrays at tol 1e-10 with the multigrid ladder."""
    jsim = JAmrSim(jdict(_blob(), ndim=2), dtype=jnp.float64)
    psim = AmrSim(pdict(_blob(), ndim=2), dtype=torch.float64, device="cpu")
    jsim.solve_gravity()
    psim.solve_gravity()
    assert set(psim.poisson_iters) == set(jsim.poisson_iters) == {5}
    nit = int(psim.poisson_iters[5])
    assert nit == int(jsim.poisson_iters[5]) and 0 < nit < 200, nit
    for l in jsim.levels():
        n = jsim.tree.noct(l) * 4
        _scale_close(psim.phi[l][:n], np.asarray(jsim.phi[l])[:n], 1e-9,
                     f"phi {l}")
        _scale_close(psim.fg[l][:n], np.asarray(jsim.fg[l])[:n], 1e-9,
                     f"fg {l}")

    d = jsim.dev[5]
    rho = np.asarray(jsim.u[5][:, 0])
    rhs = 4 * np.pi * (rho - float(jsim.totals()[0]))
    ghosts = np.array(JK.interp_cells(
        jsim.phi[4][:, None], d["g_cell"], d["g_gnb"],
        d["g_sgn"].astype(jsim.phi[4].dtype), JCfg1(2), itype=1)[:, 0])
    dx = jsim.dx(5)
    want, jnit = jgs.pcg_level(
        jnp.asarray(rhs), jnp.asarray(ghosts), d["g_nb"], d["g_octnb"],
        jnp.asarray(dx), d["g_valid"], 2, tol=1e-10, iters=400,
        mg=d["g_mg"])

    def t(a):
        return torch.from_numpy(np.array(np.asarray(a)))
    mg = tuple((t(nb).long(), t(par).long(),
                torch.from_numpy(pmaps.mg_children(np.asarray(par),
                                                   nb.shape[0])))
               for nb, par in d["g_mg"])
    got, pnit = pgs.pcg_level(
        torch.from_numpy(rhs), torch.from_numpy(ghosts), t(d["g_nb"]).long(),
        t(d["g_octnb"]).long(), dx, t(d["g_valid"]), 2, tol=1e-10,
        iters=400, mg=mg)
    assert int(pnit) == int(jnit) and 0 < int(pnit) < 400, (pnit, jnit)
    _scale_close(got, want, 1e-9, "pcg phi")


# ---------------------------------------------------------------------------
# the uniform driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndim,solver,bound", [
    (3, None, False), (3, "mg", False), (2, None, True)],
    ids=["3d-fft", "3d-mg", "2d-open-isolated"])
def test_uniform_gravity_matches_jax(ndim, solver, bound):
    """The blob at 32^ndim, 4 steps through ``run_steps_pm``: u and f within
    1e-10 of their scale, the same t."""
    g = _blob(lmin=5, lmax=5, ndim=ndim, bound=bound, solver=solver,
              nstepmax=4)
    jsim = JSimulation(jdict(g, ndim=ndim), dtype=jnp.float64)
    psim = Simulation(pdict(g, ndim=ndim), dtype=torch.float64, device="cpu")
    assert psim.gspec.periodic == (not bound)
    _scale_close(psim.state.f, jsim.state.f, what="initial f")
    jsim.evolve()
    psim.evolve()
    assert psim.nstep == jsim.nstep == 4
    assert psim.t == pytest.approx(jsim.t, rel=1e-12)
    _scale_close(psim.state.u, jsim.state.u, what="u")
    _scale_close(psim.state.f, jsim.state.f, what="f")


# ---------------------------------------------------------------------------
# the hierarchy
# ---------------------------------------------------------------------------

def _sedov_grav():
    return _text().replace("hydro=.true.", "hydro=.true.\npoisson=.true.")


def _same_gravity(jsim, psim):
    assert set(psim.phi) == set(jsim.phi) and set(psim.fg) == set(jsim.fg)
    assert {l: int(v) for l, v in psim.poisson_iters.items()} == \
        {l: int(v) for l, v in jsim.poisson_iters.items()}
    for l in jsim.levels():
        n = jsim.tree.noct(l) * 2 ** jsim.cfg.ndim
        _scale_close(psim.phi[l][:n], np.asarray(jsim.phi[l])[:n],
                     what=f"phi {l}")
        _scale_close(psim.fg[l][:n], np.asarray(jsim.fg[l])[:n],
                     what=f"fg {l}")


def test_amr_gravity_matches_jax():
    """sedov3d at levelmin 4, levelmax 5 with self-gravity: 2 coarse steps,
    a regrid and 1 step (the Courant dt of each step, gravity term
    included, taken from the JAX run), then one more step of both from the
    JAX run's state carried across."""
    jsim = JAmrSim(jparams(_sedov_grav(), ndim=3), dtype=jnp.float64)
    psim = AmrSim(pparams(_sedov_grav(), ndim=3), dtype=torch.float64,
                  device="cpu")
    assert psim.gravity and psim.grav_periodic
    for i in range(3):
        if i == 2:
            jsim.regrid()
            psim.regrid()
        dt = jsim.coarse_dt()
        assert psim.coarse_dt() == pytest.approx(dt, rel=1e-12)
        jsim.step_coarse(dt)
        psim.step_coarse(dt)
    _same_run(jsim, psim)
    _same_gravity(jsim, psim)
    assert int(psim.poisson_iters[5]) > 0

    state = amr_state_from(jsim)
    csim = AmrSim.from_state(pparams(_sedov_grav(), ndim=3), **state,
                             device="cpu")
    dt = jsim.coarse_dt()
    assert csim.coarse_dt() == pytest.approx(dt, rel=1e-12)
    jsim.step_coarse(dt)
    csim.step_coarse(dt)
    _same_run(jsim, csim, rtol=RTOL, atol=ATOL)
    _same_gravity(jsim, csim)


def test_amr_evolve_steps_one_at_a_time_with_gravity():
    p = pparams(_sedov_grav().replace("nremap=0", "nremap=4"), ndim=3)
    sim = AmrSim(p, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="gravity"):
        sim.step_chunk(2, 1.0)
    sim.evolve(1.0, nstepmax=2)
    assert sim.nstep == 2 and set(sim.fg) == set(sim.levels())
    assert all(bool(torch.isfinite(sim.u[l]).all()) for l in sim.levels())


def test_point_mass_force_law_3d():
    """``tests/test_amr_gravity.py::test_point_mass_force_law_3d`` on the
    port: the radial force of a central concentration ~ GM/r²."""
    sim = AmrSim(pdict(_blob(lmin=4, lmax=4, ndim=3, d0=1000.0), ndim=3),
                 dtype=torch.float64, device="cpu")
    sim.solve_gravity()
    m = sim.maps[4]
    cc = sim.tree.cell_centers(4)
    f = sim.fg[4].numpy()[:m.noct * 8]
    rvec = cc - 0.5
    r = np.sqrt((rvec ** 2).sum(1))
    fr = -(f * rvec).sum(1) / np.maximum(r, 1e-12)
    u0 = sim.u[4].numpy()[:m.noct * 8, 0]
    mass_c = ((u0 - 1.0) * sim.dx(4) ** 3).sum()
    shell = (r > 0.2) & (r < 0.3)
    got = fr[shell] / (mass_c / r[shell] ** 2)
    assert np.median(np.abs(got - 1.0)) < 0.2


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals_that_stay():
    from ramses_tpu_torch.mhd.amr import MhdAmrSim
    from ramses_tpu_torch.mhd.driver import MhdSimulation
    from ramses_tpu_torch.parallel.amr_sharded import ShardedAmrSim
    from ramses_tpu_torch.parallel.mesh import ShardMesh

    p = load_params(TUBE, ndim=1)
    p.run.poisson = True
    with pytest.raises(NotImplementedError, match="gravity on the MHD"):
        MhdSimulation(p, device="cpu")
    p = load_params(OT_NML, ndim=2)
    p.run.poisson = True
    with pytest.raises(NotImplementedError, match="gravity on the MHD"):
        MhdAmrSim(p, device="cpu")
    with pytest.raises(NotImplementedError, match="gravity on ShardedAmrSim"):
        ShardedAmrSim(pparams(_sedov_grav(), ndim=3),
                      devices=ShardMesh(["cpu"] * 2))
    # particles and cosmology run on the hydro drivers (pic without ICs:
    # an empty particle set on the uniform grid, the layer off on the
    # hierarchy) and stay refused on the MHD drivers and ShardedAmrSim
    for key, name in (("pic", "particles"), ("cosmo", "cosmology")):
        for cls, g in ((MhdSimulation, None), (MhdAmrSim, None),
                       (ShardedAmrSim, _blob())):
            p = (pdict(g, ndim=2) if g is not None
                 else load_params(OT_NML, ndim=2))
            if cls is MhdSimulation:
                p.amr.levelmax = p.amr.levelmin = 4
            setattr(p.run, key, True)
            p.run.poisson = False
            with pytest.raises(NotImplementedError, match=name):
                if cls is ShardedAmrSim:
                    cls(p, devices=ShardMesh(["cpu"] * 2))
                else:
                    cls(p, device="cpu")
    p = pdict(_blob(lmin=4, lmax=4), ndim=2)
    p.run.pic = True
    sim = Simulation(p, device="cpu")
    assert sim.state.p.n == 1 and not sim.state.p.active.any()
    p = pdict(_blob(), ndim=2)
    p.run.pic = True
    assert not AmrSim(p, device="cpu").pic
    for cls, g in ((Simulation, _blob(lmin=4, lmax=4)), (AmrSim, _blob())):
        g["boundary_params"] = {"nboundary": 2, "bound_type": [1, 1],
                                "ibound_min": [-1, 1],
                                "ibound_max": [-1, 1],
                                "jbound_min": [0, 0], "jbound_max": [0, 0]}
        with pytest.raises(NotImplementedError, match="reflecting walls"):
            cls(pdict(g, ndim=2), device="cpu")


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_pointmass_through_the_cli_and_run_namelist(tmp_path):
    """``python -m ramses_tpu_torch namelists/pointmass.nml --device cpu``
    runs the hierarchy (levelmin 4, levelmax 7) to nstepmax=4, and
    ``run_namelist`` the uniform driver at levelmin=levelmax=4."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "ramses_tpu_torch", POINTMASS, "--device",
         "cpu"], capture_output=True, text=True, cwd=tmp_path, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["1", "2", "3", "4"]
    assert lines[-1].startswith("totals: ") and "nstep=4" in lines[-1]
    assert "octs=[512, " in lines[-1]
    nml = tmp_path / "pointmass_uniform.nml"
    nml.write_text(open(POINTMASS).read().replace("levelmax=7",
                                                  "levelmax=4"))
    sim = run_namelist(str(nml), ndim=3, dtype=torch.float64, device="cpu")
    assert isinstance(sim, Simulation) and sim.nstep == 4
    assert sim.state.f is not None and bool(torch.isfinite(sim.state.u).all())
    mass = float(sim.totals()["mass"])
    assert mass == pytest.approx(float(Simulation(
        load_params(str(nml), ndim=3), dtype=torch.float64,
        device="cpu").totals()["mass"]), rel=1e-12)
