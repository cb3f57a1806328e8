"""Gravity and particles on the port's MHD hierarchy (``ramses_tpu_torch.
mhd.amr``) against the JAX package's ``ramses_tpu.mhd.amr``, on the CPU in
f64.

* ``mhd_kick_flat`` on random rows (1D-3D) and the gravity-corrected
  ``mhd_level_courant``: rel 1e-14 / 1e-13;
* ``poisson=.true.`` on the JAX test's magnetised blob
  (``tests/test_mhd_amr.py:218``) in 2D at levelmin 4, levelmax 5: two
  coarse steps (a regrid and a step each) with the JAX run's dts; u and the
  faces at rtol 1e-10 / atol 1e-12, phi and fg within 1e-10 of their
  scale, each dt at rel 1e-12;
* ``pic`` on the MHD hierarchy (the setup of ``tests/test_mhd_amr.py:274-
  323``): 3 coarse steps, particle x and v at 1e-10, the state as above;
* the MHD particle restart: the port's dump of the JAX run's f64 state is
  the JAX package's byte for byte, ``from_snapshot`` restores the
  particles and ``dt_old``, and a restored run follows the straight one
  to the JAX test's tolerances;
* the refusals that stay (cosmology and sinks on the MHD drivers; gravity,
  particles, tracers and turbulence on the uniform MHD driver).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.config import params_from_string as jparams  # noqa: E402
from ramses_tpu.mhd import amr as JA  # noqa: E402
from ramses_tpu.mhd.core import MhdStatic as JMhdStatic  # noqa: E402
from ramses_tpu.pm.particles import ParticleSet as JParticleSet  # noqa: E402

from ramses_tpu_torch.config import params_from_string as pparams  # noqa: E402
from ramses_tpu_torch.convert import (mhd_amr_state_from,  # noqa: E402
                                      mhd_static_from, particles_from)
from ramses_tpu_torch.mhd import amr as PA  # noqa: E402
from ramses_tpu_torch.mhd.driver import (MhdSimulation,  # noqa: E402
                                         unported_mhd_features)

from test_torch_io import assert_same_files, dump_both  # noqa: E402

RTOL, ATOL = 1e-10, 1e-12
FIELD = 1e-10

# tests/test_mhd_amr.py::test_mhd_amr_self_gravity_collapse's setup
# (tube_mhd.nml's roe/llf with a periodic box), as a namelist both
# packages read
BLOB = """
&RUN_PARAMS
hydro=.true.
poisson=.true.
/
&AMR_PARAMS
levelmin={lmin}
levelmax={lmax}
boxlen=1.0
/
&INIT_PARAMS
nregion=2
region_type='square','square'
x_center=0.5,0.5
y_center=0.5,0.5
z_center=0.5,0.5
length_x=10.0,0.25
length_y=10.0,0.25
length_z=10.0,0.25
exp_region=10.0,2.0
d_region=0.1,50.0
p_region=0.05,0.05
A_region=0.1,0.1
B_region=0.0,0.0
C_region=0.0,0.0
/
&HYDRO_PARAMS
gamma=1.6666667
courant_factor=0.8
riemann='roe'
slope_type=1
/
&REFINE_PARAMS
err_grad_d=0.2
/
"""


def _pm_text(extra_init):
    """``tests/test_mhd_amr.py::_pm_params``'s namelist."""
    return "\n".join([
        "&RUN_PARAMS", "poisson=.true.", "pic=.true.", "/",
        "&AMR_PARAMS", "levelmin=4", "levelmax=5", "boxlen=1.0", "/",
        "&HYDRO_PARAMS", "courant_factor=0.5", "/",
        "&REFINE_PARAMS", "x_refine=0,0,0,0.5", "y_refine=0,0,0,0.5",
        "r_refine=-1,-1,-1,0.2", "/",
        "&INIT_PARAMS", "nregion=1", "region_type(1)='square'",
        "d_region=1.0", "p_region=1.0"] + extra_init + ["/"])


def _pset(n, ndim, seed, vmax=0.05):
    """``tests/test_mhd_amr.py::_pm_pset``'s particles (host arrays)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.95, (n, ndim)),
            rng.uniform(-vmax, vmax, (n, ndim)), np.full(n, 1.0 / n))


def _both_particles(n, ndim, seed):
    x, v, m = _pset(n, ndim, seed)
    jp = jax.device_put(JParticleSet.make(x, v, m))
    return jp, particles_from(jp, dtype=torch.float64, device="cpu")


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(
        got.numpy() if torch.is_tensor(got) else np.asarray(got),
        np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _scale_close(got, want, tol=FIELD, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= tol, f"{what}: max|Δ|/max|want| = {err:.3e}"


def _same_state(jsim, psim):
    assert jsim.levels() == psim.levels()
    for l in jsim.levels():
        assert np.array_equal(jsim.tree.levels[l].keys,
                              psim.tree.levels[l].keys), l
        n = jsim.tree.noct(l) * 2 ** jsim.cfg.ndim
        _close(psim.u[l][:n], np.asarray(jsim.u[l])[:n], what=f"u {l}")
        _close(psim.bfs[l][:n], np.asarray(jsim.bfs[l])[:n],
               what=f"bf {l}")
        if jsim.gravity:
            _scale_close(psim.phi[l][:n], np.asarray(jsim.phi[l])[:n],
                         what=f"phi {l}")
            _scale_close(psim.fg[l][:n], np.asarray(jsim.fg[l])[:n],
                         what=f"fg {l}")


# ---------------------------------------------------------------------------
# the kick and the Courant dt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd", [1, 2, 3])
def test_mhd_kick_flat_matches_jax(nd):
    rng = np.random.default_rng(10 + nd)
    n, nvar = 200, 9
    u = rng.standard_normal((n, nvar))
    u[:, 0] = rng.uniform(0.0, 2.0, n)        # some below smallr
    u[:, 4] = rng.uniform(5.0, 10.0, n)
    fg = rng.standard_normal((n, nd))
    want = JA.mhd_kick_flat(jnp.asarray(u), jnp.asarray(fg), 0.013, nd, 0.1)
    got = PA.mhd_kick_flat(torch.from_numpy(u), torch.from_numpy(fg), 0.013,
                           nd, 0.1)
    _close(got, want, rtol=1e-14, atol=0.0)
    # the components beyond ndim and the field are untouched
    assert torch.equal(got[:, 1 + nd:4], torch.from_numpy(u[:, 1 + nd:4]))
    assert torch.equal(got[:, 5:], torch.from_numpy(u[:, 5:]))


@pytest.mark.parametrize("with_fg", [False, True])
def test_mhd_level_courant_gravity_matches_jax(with_fg):
    rng = np.random.default_rng(3)
    nd, n = 2, 300
    jcfg = JMhdStatic(ndim=nd, courant_factor=0.6)
    cfg = mhd_static_from(jcfg)
    u = rng.standard_normal((n, cfg.nvar)) * 0.1
    u[:, 0] = rng.uniform(0.5, 2.0, n)
    u[:, 4] = rng.uniform(2.0, 4.0, n)
    bf = rng.standard_normal((n, 3, 2)) * 0.3
    valid = rng.random(n) < 0.8
    fg = rng.standard_normal((n, nd)) * 50.0 if with_fg else None
    want = JA.mhd_level_courant(
        jnp.asarray(u), jnp.asarray(bf), jnp.asarray(valid), 0.03, jcfg,
        None if fg is None else jnp.asarray(fg))
    got = PA.mhd_level_courant(
        torch.from_numpy(u), torch.from_numpy(bf), torch.from_numpy(valid),
        0.03, cfg, None if fg is None else torch.from_numpy(fg))
    assert float(got) == pytest.approx(float(want), rel=1e-13)


# ---------------------------------------------------------------------------
# the hierarchy with self-gravity, with particles
# ---------------------------------------------------------------------------

def test_mhd_gravity_hierarchy_matches_jax():
    text = BLOB.format(lmin=4, lmax=5)
    jsim = JA.MhdAmrSim(jparams(text, ndim=2), dtype=jnp.float64)
    psim = PA.MhdAmrSim(pparams(text, ndim=2), dtype=torch.float64,
                        device="cpu")
    assert psim.gravity and not psim.pic
    for _ in range(2):
        jsim.regrid()
        psim.regrid()
        dt = jsim.coarse_dt()
        assert psim.coarse_dt() == pytest.approx(dt, rel=1e-12)
        jsim.step_coarse(dt)
        psim.step_coarse(dt)
    assert len(jsim.levels()) == 2
    _same_state(jsim, psim)
    assert psim.coarse_dt() == pytest.approx(jsim.coarse_dt(), rel=1e-12)
    assert psim.totals()["mass"] == pytest.approx(
        float(jsim.totals()[0]), rel=1e-12)
    with pytest.raises(ValueError, match="gravity"):
        psim.step_chunk(2, 1.0)

    # from the JAX run's state carried across: one more step of both
    csim = PA.MhdAmrSim.from_state(pparams(text, ndim=2),
                                   **mhd_amr_state_from(jsim), device="cpu")
    dt = jsim.coarse_dt()
    assert csim.coarse_dt() == pytest.approx(dt, rel=1e-12)
    jsim.step_coarse(dt)
    csim.step_coarse(dt)
    _same_state(jsim, csim)


def test_mhd_particles_match_jax():
    text = _pm_text(["A_region=0.02"])
    jp, pp = _both_particles(40, 2, seed=7)
    jsim = JA.MhdAmrSim(jparams(text, ndim=2), dtype=jnp.float64,
                        particles=jp)
    psim = PA.MhdAmrSim(pparams(text, ndim=2), dtype=torch.float64,
                        device="cpu", particles=pp)
    assert psim.pic and psim.gravity
    for _ in range(3):
        dt = jsim.coarse_dt()
        assert psim.coarse_dt() == pytest.approx(dt, rel=1e-12)
        jsim.step_coarse(dt)
        psim.step_coarse(dt)
    _close(psim.p.x, jsim.p.x, what="x")
    _close(psim.p.v, jsim.p.v, what="v")
    _same_state(jsim, psim)
    assert psim._rho_max == pytest.approx(jsim._rho_max, rel=1e-12)
    assert len(psim._aux_dts()) >= 2
    assert psim.max_divb() < 1e-11


def test_mhd_particle_restart(tmp_path):
    """The JAX run's f64 state (2 coarse steps with particles) carried into
    the port: both dumps the same bytes; the port's restore brings the
    particles and ``dt_old`` back, and one more step of the restored and
    the carried sim agree to the JAX test's tolerances (the partial
    level's PCG re-converges from the restore's own solve)."""
    text = _pm_text(["A_region=0.02"])
    jp, _ = _both_particles(24, 2, seed=11)
    jsim = JA.MhdAmrSim(jparams(text, ndim=2), dtype=jnp.float64,
                        particles=jp)
    for _ in range(2):
        jsim.step_coarse(jsim.coarse_dt())
    psim = PA.MhdAmrSim.from_state(
        pparams(text, ndim=2), **mhd_amr_state_from(jsim),
        dt_next=float(jsim._dt_cache), device="cpu",
        particles=particles_from(jsim.p, dtype=torch.float64, device="cpu"))
    a, b = dump_both(jsim, psim, tmp_path)
    assert_same_files(a, b)
    assert "part_00001.out00001" in os.listdir(b)

    back = PA.MhdAmrSim.from_snapshot(pparams(text, ndim=2), b,
                                      dtype=torch.float64, device="cpu")
    assert back.pic and back.p is not None
    o1 = np.argsort(psim.p.idp.numpy())
    o2 = np.argsort(back.p.idp.numpy())
    _close(back.p.x.numpy()[o2], psim.p.x.numpy()[o1], rtol=1e-12, atol=0)
    _close(back.p.v.numpy()[o2], psim.p.v.numpy()[o1], rtol=1e-12, atol=0)
    assert back.dt_old == pytest.approx(psim.dt_old, rel=1e-12)
    psim.step_coarse(psim.coarse_dt())
    back.step_coarse(back.coarse_dt())
    _close(back.p.x.numpy()[o2], psim.p.x.numpy()[o1], rtol=0, atol=1e-7)
    _close(back.p.v.numpy()[o2], psim.p.v.numpy()[o1], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the refusals that stay
# ---------------------------------------------------------------------------

SINKS = "&SINK_PARAMS\ncreate_sinks=.true.\n/\n"
TURB = "&TURB_PARAMS\nturb=.true.\n/\n"


@pytest.mark.parametrize("amr", [False, True], ids=["uniform", "amr"])
def test_mhd_refusals_that_stay(amr):
    lmax = 5 if amr else 4
    text = BLOB.format(lmin=4, lmax=lmax).replace("poisson=.true.\n", "")
    p = pparams(text + SINKS, ndim=2)
    assert [n for n in unported_mhd_features(p) if "sinks" in n]
    p = pparams(text, ndim=2)
    p.run.cosmo = True
    assert [n for n in unported_mhd_features(p) if "cosmology" in n]
    for key in ("poisson", "pic", "tracer"):
        p = pparams(text, ndim=2)
        setattr(p.run, key, True)
        named = [n for n in unported_mhd_features(p)
                 if "uniform MHD driver" in n]
        assert len(named) == (0 if amr else 1), (key, named)
    p = pparams(text + TURB, ndim=2)
    names = unported_mhd_features(p)
    assert sum("turbulence" in n for n in names) == 1, names
    cls = PA.MhdAmrSim if amr else MhdSimulation
    with pytest.raises(NotImplementedError, match="turbulence"):
        cls(p, device="cpu")
