"""Sink particles in the port (``ramses_tpu_torch.pm.sinks``, the sink pass
of ``pm/amr_physics``, the drivers' wiring and the sink CSV) against the
JAX package's, on the CPU in f64.

* every function of ``pm/sinks.py`` on seeded inputs (host numpy in both
  packages): equal to rel 1e-14 (the same numpy arithmetic);
* ``sink_passes_amr`` on a 2D ``smbh_bondi.nml``-like hierarchy (levelmin
  4, levelmax 5, Bondi accretion, AGN, ``direct_force``) and on the
  threshold scheme of ``collapse_iso.nml``, stepped with the JAX run's
  dts: the state at rtol 1e-10 / atol 1e-12, the sinks' x, v, m at rtol
  1e-10, ids and count equal;
* the uniform ``Simulation``'s sink pass in 2D at 16² (chunks of 2 steps);
* ``write_sink_csv`` byte for byte, and the dump's ``sink_00001.csv``;
* ``collapse_iso.nml`` and ``smbh_bondi.nml`` through ``python -m
  ramses_tpu_torch --device cpu``, shrunk as
  ``tests/test_namelist_suite.py`` shrinks them.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.config import params_from_string as jparams  # noqa: E402
from ramses_tpu.driver import Simulation as JSimulation  # noqa: E402
from ramses_tpu.io import snapshot as jsnap  # noqa: E402
from ramses_tpu.pm import sinks as J  # noqa: E402
from ramses_tpu.units import units as junits  # noqa: E402

from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import params_from_string as pparams  # noqa: E402
from ramses_tpu_torch.convert import amr_state_from, sinks_from  # noqa: E402
from ramses_tpu_torch.driver import Simulation  # noqa: E402
from ramses_tpu_torch.io import snapshot as psnap  # noqa: E402
from ramses_tpu_torch.pm import sinks as P  # noqa: E402
from ramses_tpu_torch.units import units as punits  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NMLS = os.path.join(ROOT, "namelists")
RTOL, ATOL = 1e-10, 1e-12


def _nml(name, lmin, lmax, nstepmax=None):
    """A shipped namelist with its levels (and ``nstepmax``) replaced."""
    txt = open(os.path.join(NMLS, name)).read()
    txt = re.sub(r"levelmin=\d+", f"levelmin={lmin}", txt)
    txt = re.sub(r"levelmax=\d+", f"levelmax={lmax}", txt)
    if nstepmax is not None:
        txt = re.sub(r"nstepmax=\d+\n", "", txt)
        txt = txt.replace("&RUN_PARAMS", f"&RUN_PARAMS\nnstepmax={nstepmax}",
                          1)
    return txt


def _sinks_close(got, want, rtol=RTOL):
    assert got.n == want.n
    assert np.array_equal(got.idp, np.asarray(want.idp))
    assert got.next_id == want.next_id
    for f in ("x", "v", "m", "tform"):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(want, f)),
                                   rtol=rtol, atol=1e-300, err_msg=f)


def _jsinks(rng, n, nd, box=1.0):
    return J.SinkSet(x=rng.uniform(0, box, (n, nd)),
                     v=rng.standard_normal((n, nd)) * 0.1,
                     m=rng.uniform(0.01, 1.0, n), tform=rng.random(n),
                     idp=np.arange(1, n + 1, dtype=np.int64),
                     next_id=n + 1)


SMBH_SPEC = dict(enabled=True, n_sink=500.0, accretion_scheme="bondi",
                 agn=True, eps_r=0.1, eps_c=0.15, direct_force=True)


# ---------------------------------------------------------------------------
# pm/sinks.py
# ---------------------------------------------------------------------------

def test_spec_and_cloud_offsets_match_jax():
    text = _nml("smbh_bondi.nml", 4, 5)
    assert P.SinkSpec.from_params(pparams(text, ndim=2)).__dict__ == \
        J.SinkSpec.from_params(jparams(text, ndim=2)).__dict__
    for nd in (1, 2, 3):
        for irc in (1, 2, 4, 5):
            assert np.array_equal(P.cloud_offsets(nd, irc, 0.1),
                                  J.cloud_offsets(nd, irc, 0.1))


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("scheme,agn", [("threshold", False),
                                        ("bondi", False), ("bondi", True)])
def test_create_accrete_merge_drift_match_jax(nd, scheme, agn):
    rng = np.random.default_rng(20 + nd)
    n = 12
    shape = (n,) * nd
    u = np.empty((2 + nd,) + shape)
    u[0] = rng.uniform(0.5, 2.0, shape)
    peaks = tuple(rng.integers(0, n, (nd, 3)))
    u[0][peaks] = 5e4                                   # above n_sink
    u[1:1 + nd] = rng.standard_normal((nd,) + shape) * 0.1
    u[1 + nd] = 10.0 + rng.random(shape)
    dx = 1.0 / n
    un = dict(units_density=1.66e-24, units_time=3.15e13,
              units_length=3.08e18)
    text = ("&UNITS_PARAMS\n" + "\n".join(f"{k}={v}" for k, v in un.items())
            + "\n/\n")
    ju, pu = junits(jparams(text, ndim=nd)), punits(pparams(text, ndim=nd))
    kw = dict(SMBH_SPEC, accretion_scheme=scheme, agn=agn, n_sink=1e4,
              merging_cells=3.0)
    jspec, pspec = J.SinkSpec(**kw), P.SinkSpec(**kw)
    empty = np.zeros((0, nd))
    j_s = J.SinkSet(x=empty, v=empty.copy(), m=np.zeros(0),
                    tform=np.zeros(0), idp=np.zeros(0, dtype=np.int64))
    p_s = sinks_from(j_s)
    ju_, j_s = J.create_sinks(u, j_s, jspec, ju, dx, 0.5, 5 / 3)
    pu_, p_s = P.create_sinks(u, p_s, pspec, pu, dx, 0.5, 5 / 3)
    assert j_s.n > 0
    np.testing.assert_array_equal(pu_, ju_)
    _sinks_close(p_s, j_s, rtol=0.0)
    ju_, j_s = J.accrete(ju_, j_s, jspec, ju, dx, 1e-3, 5 / 3)
    pu_, p_s = P.accrete(pu_, p_s, pspec, pu, dx, 1e-3, 5 / 3)
    np.testing.assert_allclose(pu_, ju_, rtol=1e-14, atol=0)
    _sinks_close(p_s, j_s, rtol=1e-14)
    j_s = J.merge_sinks(j_s, jspec, dx)
    p_s = P.merge_sinks(p_s, pspec, dx)
    _sinks_close(p_s, j_s, rtol=1e-14)
    f = rng.standard_normal((nd,) + shape)
    j_s = J.drift_kick(j_s, f, dx, 1e-2, 1.0, spec=jspec, units=ju)
    p_s = P.drift_kick(p_s, f, dx, 1e-2, 1.0, spec=pspec, units=pu)
    _sinks_close(p_s, j_s, rtol=1e-14)


def test_pair_forces_and_merging_match_jax():
    rng = np.random.default_rng(5)
    for nd in (2, 3):
        js = _jsinks(rng, 9, nd)
        for box in (None, 1.0):
            np.testing.assert_allclose(
                P.sink_sink_accel(sinks_from(js), 2.5, 0.05, boxlen=box),
                J.sink_sink_accel(js, 2.5, 0.05, boxlen=box),
                rtol=1e-14, atol=0)
        spec = dict(enabled=True, merging_cells=4.0)
        un = dict(units_density=1.66e-24, units_time=3.15e13,
                  units_length=3.08e18)
        text = ("&UNITS_PARAMS\n"
                + "\n".join(f"{k}={v}" for k, v in un.items()) + "\n/\n")
        jk = J.direct_force_kick(_jsinks(np.random.default_rng(6), 9, nd),
                                 junits(jparams(text, ndim=nd)), 0.02, 0.1,
                                 1.0)
        pk = P.direct_force_kick(
            sinks_from(_jsinks(np.random.default_rng(6), 9, nd)),
            punits(pparams(text, ndim=nd)), 0.02, 0.1, 1.0)
        _sinks_close(pk, jk, rtol=1e-14)
        jm = J.merge_sinks(_jsinks(np.random.default_rng(7), 30, nd),
                           J.SinkSpec(**spec), 0.05)
        pm = P.merge_sinks(sinks_from(_jsinks(np.random.default_rng(7), 30,
                                              nd)), P.SinkSpec(**spec), 0.05)
        assert pm.n < 30
        _sinks_close(pm, jm, rtol=0.0)
    e_j, g_j = J.agn_energy(np.array([1e-3, 2.0]), J.SinkSpec(**SMBH_SPEC),
                            junits(jparams("", ndim=2)))
    e_p, g_p = P.agn_energy(np.array([1e-3, 2.0]), P.SinkSpec(**SMBH_SPEC),
                            punits(pparams("", ndim=2)))
    assert np.array_equal(e_p, e_j) and np.array_equal(g_p, g_j)


def test_write_sink_csv_same_bytes(tmp_path):
    rng = np.random.default_rng(9)
    for nd in (2, 3):
        js = _jsinks(rng, 5, nd)
        jsnap.write_sink_csv(str(tmp_path / f"j{nd}.csv"), js,
                             {2: 0.25})
        psnap.write_sink_csv(str(tmp_path / f"p{nd}.csv"), sinks_from(js),
                             {2: 0.25})
        assert (tmp_path / f"j{nd}.csv").read_bytes() == \
            (tmp_path / f"p{nd}.csv").read_bytes()


# ---------------------------------------------------------------------------
# the hierarchy's sink pass and the uniform driver's
# ---------------------------------------------------------------------------

def _carried(text, nd, gravity):
    """A JAX hierarchy on its ICs (and, with ``gravity``, its first solve)
    and the port's on the same state, sinks and force carried across: the
    sink passes then see the same f64 state, bit for bit.  (Stepped side by
    side, the two states part at roundoff, and the creation pass's
    density order among the clump's equal cells amplifies that.)"""
    jsim = JAmrSim(jparams(text, ndim=nd), dtype=jnp.float64)
    if gravity:
        jsim.solve_gravity()
    psim = AmrSim.from_state(pparams(text, ndim=nd), **amr_state_from(jsim),
                             sinks=sinks_from(jsim.sinks), device="cpu")
    assert psim.sinks is not None and psim.sinks.n == 0
    return jsim, psim


def _same_hierarchy(jsim, psim, rtol=RTOL, atol=ATOL):
    assert jsim.levels() == psim.levels()
    for l in jsim.levels():
        assert np.array_equal(jsim.tree.levels[l].keys,
                              psim.tree.levels[l].keys), l
        n = jsim.tree.noct(l) * 2 ** jsim.cfg.ndim
        np.testing.assert_allclose(psim.u[l][:n].numpy(),
                                   np.asarray(jsim.u[l])[:n], rtol=rtol,
                                   atol=atol, err_msg=f"u {l}")


def _passes(jsim, psim, dts):
    """The sink passes of both packages, one per dt, each compared."""
    from ramses_tpu.pm import amr_physics as jap

    from ramses_tpu_torch.pm import amr_physics as pap
    for dt in dts:
        jap.sink_passes_amr(jsim, dt)
        pap.sink_passes_amr(psim, dt)
        _same_hierarchy(jsim, psim, rtol=1e-14, atol=0.0)
        _sinks_close(psim.sinks, jsim.sinks, rtol=1e-14)


def test_sink_passes_amr_bondi_agn_match_jax(tmp_path):
    """smbh_bondi.nml in 2D at levelmin 4, levelmax 5: creation in the
    clump, Bondi accretion with the AGN dump, merging, the drift in the
    force field with the direct sink-sink force, three passes."""
    text = _nml("smbh_bondi.nml", 4, 5)
    jsim, psim = _carried(text, 2, gravity=True)
    _passes(jsim, psim, [1e-4, 2e-4, 2e-4])
    assert jsim.sinks.n > 1 and float(jsim.sinks.m.min()) > 0.0
    # the dump's sink CSV is the JAX package's, byte for byte
    a = jsim.dump(1, str(tmp_path / "jax"))
    b = psim.dump(1, str(tmp_path / "port"))
    assert (open(os.path.join(a, "sink_00001.csv"), "rb").read()
            == open(os.path.join(b, "sink_00001.csv"), "rb").read())
    # a restore starts with no sinks, as the JAX package's
    back = AmrSim.from_snapshot(pparams(text, ndim=2), b,
                                dtype=torch.float64, device="cpu")
    assert back.sinks is not None and back.sinks.n == 0


def test_sink_passes_amr_threshold_match_jax():
    """collapse_iso.nml's threshold scheme in an open box, in 2D at
    levelmin 4, levelmax 5, with the threshold lowered in code so that the
    clump forms sinks; without gravity, two passes."""
    text = _nml("collapse_iso.nml", 4, 5).replace("n_sink=1e4", "n_sink=10")
    text = text.replace("poisson=.true.", "poisson=.false.")
    text = re.sub(r"kbound_\w+=.*\n", "", text)
    text = text.replace("nboundary=6", "nboundary=4")
    for k in ("ibound_min", "ibound_max", "jbound_min", "jbound_max",
              "bound_type"):
        text = re.sub(rf"({k}=\S+?),\S+?,\S+?\n", r"\1\n", text)
    jsim, psim = _carried(text, 2, gravity=False)
    assert not psim.grav_periodic
    _passes(jsim, psim, [1e-3, 1e-3])
    assert jsim.sinks.n > 0


def test_sink_run_conserves_gas_and_sink_mass():
    """Three coarse steps of the port's hierarchy with Bondi accretion (no
    AGN, which radiates eps_r of the accreted mass): the leaf gas mass plus
    the sink mass is conserved in the periodic box, and the passes drop
    the cached Courant dt."""
    text = _nml("smbh_bondi.nml", 4, 5).replace("agn=.true.", "agn=.false.")
    sim = AmrSim(pparams(text, ndim=2), dtype=torch.float64, device="cpu")
    m0 = sim.totals()["mass"]
    for _ in range(3):
        sim.regrid()
        sim.step_coarse(min(sim.coarse_dt(), 1e-4))
        assert sim._dt_cache is None
    assert sim.sinks.n > 0
    total = sim.totals()["mass"] + sim.sinks.m.sum()
    assert total == pytest.approx(m0, rel=1e-12)
    assert "sinks=" in sim.status_note()
    with pytest.raises(ValueError, match="sink"):
        sim.step_chunk(2, 1.0)


def test_uniform_sink_pass_matches_jax():
    """The uniform ``Simulation``'s source pass in 2D at 16² on the JAX
    run's ICs and force, carried across: two passes."""
    text = _nml("smbh_bondi.nml", 4, 4, nstepmax=6)
    jsim = JSimulation(jparams(text, ndim=2), dtype=jnp.float64)
    psim = Simulation.from_state(pparams(text, ndim=2),
                                 np.asarray(jsim.state.u), 0.0, 0,
                                 device="cpu", f=np.asarray(jsim.state.f))
    for dt in (1e-4, 2e-4):
        jsim._source_passes(dt)
        psim._source_passes(dt)
        np.testing.assert_allclose(psim.state.u.numpy(),
                                   np.asarray(jsim.state.u), rtol=1e-14,
                                   atol=0.0)
        _sinks_close(psim.sinks, jsim.sinks, rtol=1e-14)
    assert jsim.sinks.n > 0
    # the driver runs the pass once a chunk
    psim.evolve(chunk=2)
    assert psim.nstep == 6 and psim.sinks.n > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _shrunk(name, tmp_path):
    """``tests/test_namelist_suite.py::_shrunk_copy``: levelmin at most 4,
    levelmax at most 5, 2 steps."""
    txt = open(os.path.join(NMLS, name)).read()
    txt = re.sub(r"(levelmin=)(\d+)",
                 lambda m: f"{m.group(1)}{min(int(m.group(2)), 4)}", txt)
    txt = re.sub(r"(levelmax=)(\d+)",
                 lambda m: f"{m.group(1)}{min(int(m.group(2)), 5)}", txt)
    if "nstepmax" in txt:
        txt = re.sub(r"nstepmax=\d+", "nstepmax=2", txt)
    else:
        txt = txt.replace("&RUN_PARAMS", "&RUN_PARAMS\nnstepmax=2", 1)
    dst = tmp_path / name
    dst.write_text(txt)
    return str(dst)


@pytest.mark.parametrize("name,ndim", [("collapse_iso.nml", 3),
                                       ("smbh_bondi.nml", 2)])
def test_sink_namelists_through_the_cli(name, ndim, tmp_path):
    nml = _shrunk(name, tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "ramses_tpu_torch", nml, "--ndim", str(ndim),
         "--device", "cpu", "--dtype", "float64"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("totals: ") and "nstep=2" in last
    nsink = int(re.search(r"sinks=(\d+)", last).group(1))
    csv = tmp_path / "output_00001" / "sink_00001.csv"
    lines = csv.read_text().splitlines()
    assert lines[0].startswith(" # id,msink,x,y,z,vx,vy,vz")
    assert len(lines) == 2 + nsink
    if name == "smbh_bondi.nml":
        assert nsink > 0
