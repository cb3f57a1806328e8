"""Restarts of the port (``from_snapshot``, ``nrestart``) against the JAX
package, on the CPU.

* cross-restore, both ways: the port restores a JAX-written
  ``output_00001/`` and the JAX package's ``from_snapshot`` restores a
  port-written one, each within rtol = atol = 1e-13 of the state dumped
  (``tests/test_io.py``'s tolerance, f64), for the uniform hydro driver
  (with gravity too), the hierarchy with gravity and with MC tracers, an
  ``ncpu=8`` dump onto one device, and both MHD drivers; then both keep
  evolving (the uniform drivers in step with each other);
* the f32 round trip: a restored f32 state is within one ulp of the
  dumped one (E is rebuilt from f64 primitives), MHD faces bitwise;
* ``&RUN_PARAMS nrestart=N`` resumes ``output_0000N`` through
  ``run_namelist`` for every driver, and through the CLI (with
  ``debug_nan``'s dt probe armed too), matching the uninterrupted run
  within rtol 1e-9 / atol 1e-12;
* an emergency checkpoint (iout >= 900) resumes the output schedule from
  its time;
* ``&OUTPUT_PARAMS pario=.true.`` is refused by name by every entry point.
"""

import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_io import (BUILD, MHD_BLOB, NMLS, ROOT,  # noqa: E402
                           UNIFORM, _uniform_params, dump_both, sod_text)

from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.config import load_params as jload  # noqa: E402
from ramses_tpu.config import params_from_string as jparams  # noqa: E402
from ramses_tpu.driver import Simulation as JSimulation  # noqa: E402
from ramses_tpu.mhd.amr import MhdAmrSim as JMhdAmrSim  # noqa: E402
from ramses_tpu.mhd.driver import MhdSimulation as JMhdSimulation  # noqa: E402,E501

from ramses_tpu_torch.__main__ import run_cli  # noqa: E402
from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import load_params as pload  # noqa: E402
from ramses_tpu_torch.config import params_from_string as pparams  # noqa: E402,E501
from ramses_tpu_torch.driver import Simulation, run_namelist  # noqa: E402
from ramses_tpu_torch.mhd.amr import MhdAmrSim  # noqa: E402
from ramses_tpu_torch.mhd.driver import MhdSimulation  # noqa: E402
from ramses_tpu_torch.parallel.amr_sharded import ShardedAmrSim  # noqa: E402
from ramses_tpu_torch.parallel.mesh import ShardMesh  # noqa: E402

TOL = dict(rtol=1e-13, atol=1e-13)
RUN_TOL = dict(rtol=1e-9, atol=1e-12)

# case: (JAX class, port class); the sharded case restores onto one device
CLASSES = {
    "uniform_sedov2d": (JSimulation, Simulation),
    "uniform_pointmass": (JSimulation, Simulation),
    "amr_gravity": (JAmrSim, AmrSim),
    "amr_tracers": (JAmrSim, AmrSim),
    "sharded_ncpu8": (JAmrSim, AmrSim),
    "mhd": (JMhdSimulation, MhdSimulation),
    "mhd_amr": (JMhdAmrSim, MhdAmrSim),
}


@pytest.fixture(autouse=True)
def _restore_signal_handlers():
    """The CLI guards each attempt with an OpsGuard, which installs
    SIGTERM/SIGINT/SIGUSR1 handlers: put back the ones each test found."""
    sigs = (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1)
    prev = {s: signal.getsignal(s) for s in sigs}
    yield
    for s, h in prev.items():
        signal.signal(s, h)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _state(sim):
    """The sim's state as numpy: {name: array}, real rows only on the
    hierarchies (the JAX package's and the port's alike)."""
    if hasattr(sim, "levels"):
        out = {}
        ttd = 2 ** sim.tree.ndim
        for lvl in sim.levels():
            n = sim.tree.noct(lvl) * ttd
            out[f"u{lvl}"] = _np(sim.u[lvl])[:n]
            if hasattr(sim, "bfs"):
                out[f"bf{lvl}"] = _np(sim.bfs[lvl])[:n]
        return out
    if hasattr(sim, "bf"):
        return {"u": _np(sim.u), "bf": _np(sim.bf)}
    return {"u": _np(sim.state.u)}


def _stale_cell0(sim):
    """Per level, the refined flat cell 0 of a level above a partial one:
    the JAX package's ``restrict_upload`` leaves it stale (ROADMAP §C1),
    so a restore, which restricts, may move it."""
    out = {}
    if not hasattr(sim, "levels"):
        return out
    for lvl in sim.levels():
        if sim.tree.has(lvl + 1) and sim.tree.refined_mask(lvl)[0]:
            out[f"u{lvl}"] = 0
    return out


def _assert_state_close(got, want, skip=None, **tol):
    g, w = _state(got), _state(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = g[k].copy(), w[k].copy()
        if skip and k in skip:
            a[skip[k]] = b[skip[k]] = 0.0
        np.testing.assert_allclose(a, b, err_msg=k, **tol)


def _restore(cls, case, outdir, port):
    kw = dict(dtype=torch.float64, device="cpu") if port else \
        dict(dtype=jnp.float64)
    return cls.from_snapshot(_params(case, port), outdir, **kw)


def _params(case, port):
    """Each case's parameters, loaded by the port (``port``) or the JAX
    package."""
    load, text = (pload, pparams) if port else (jload, jparams)
    if case.startswith("uniform_"):
        nml, ndim, level, _n = UNIFORM[case[len("uniform_"):]]
        return _uniform_params(load, nml, ndim, level)
    if case == "amr_gravity":
        return text(sod_text(run="poisson=.true."), ndim=2)
    if case == "amr_tracers":
        return text(sod_text(run="tracer=.true.\ntracer_per_cell=1.0"),
                    ndim=2)
    if case == "sharded_ncpu8":
        return text(sod_text(), ndim=2)
    if case == "mhd":
        p = load(os.path.join(NMLS, "orszag2d.nml"), ndim=2)
        p.amr.levelmin = p.amr.levelmax = 5
        return p
    return text(MHD_BLOB, ndim=2)


def _advance(sim, n):
    """``n`` more steps (coarse steps on the hierarchies)."""
    if hasattr(sim, "levels"):
        sim.evolve(1.0, nstepmax=sim.nstep + n)
    elif hasattr(sim, "bf"):
        sim.evolve(nstepmax=sim.nstep + n)
    else:
        sim.params.run.nstepmax = sim.nstep + n
        sim.output_times = [1e9]
        sim.state.iout = 1
        sim.evolve()


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_cross_restore_both_ways(case, tmp_path):
    jsim, psim = BUILD[case]()
    jdir, pdir = dump_both(jsim, psim, tmp_path,
                           ncpu=8 if case == "sharded_ncpu8" else None)
    jcls, pcls = CLASSES[case]
    # the port restores the JAX package's directory and vice versa
    p_of_j = _restore(pcls, case, jdir, port=True)
    j_of_p = _restore(jcls, case, pdir, port=False)
    skip = _stale_cell0(jsim)
    _assert_state_close(p_of_j, jsim, skip, **TOL)
    _assert_state_close(j_of_p, psim, skip, **TOL)
    for a, b in ((p_of_j, jsim), (j_of_p, psim)):
        assert a.t == b.t and a.nstep == b.nstep
    if case == "amr_tracers":
        for a, b in ((p_of_j, jsim), (j_of_p, psim)):
            np.testing.assert_array_equal(a.tracer_x, b.tracer_x)
            np.testing.assert_array_equal(a.tracer_id, b.tracer_id)
    # both keep evolving
    t0 = p_of_j.t
    _advance(p_of_j, 2)
    _advance(j_of_p, 2)
    assert p_of_j.t > t0 and j_of_p.t > t0
    for s in (p_of_j, j_of_p):
        assert all(np.isfinite(v).all() for v in _state(s).values())
    if not hasattr(jsim, "levels"):
        # the uniform drivers step in step from the two restores
        _assert_state_close(p_of_j, j_of_p, **RUN_TOL)


def test_sharded_dump_restores_onto_any_shard_count(tmp_path):
    _, psim = BUILD["sharded_ncpu8"]()
    out = psim.dump(1, str(tmp_path))
    for mesh in (ShardMesh(["cpu"] * 2), ShardMesh(["cpu"] * 4)):
        back = ShardedAmrSim.from_snapshot(psim.params, out,
                                           dtype=torch.float64, devices=mesh)
        assert back.ndev == mesh.ndev
        # psim holds the JAX run's rows, stale cell 0 included
        _assert_state_close(back, psim, _stale_cell0(psim), **TOL)
        _advance(back, 1)


def test_f32_round_trip_within_one_ulp(tmp_path):
    """f32 state → f64 primitives on disk → f32: every value within one
    ulp of the dumped one (uniform and hierarchy); MHD faces bitwise."""
    p = pload(os.path.join(NMLS, "sedov3d.nml"), ndim=3)
    p.amr.levelmin = p.amr.levelmax = 4
    p.run.nstepmax = 5
    sim = Simulation(p, device="cpu")
    sim.evolve()
    back = Simulation.from_snapshot(p, sim.dump(1, str(tmp_path / "u")),
                                    device="cpu")
    amr = AmrSim(pparams(sod_text(), ndim=2), device="cpu")
    amr.evolve(1.0, nstepmax=3)
    amr_back = AmrSim.from_snapshot(amr.params,
                                    amr.dump(1, str(tmp_path / "a")),
                                    device="cpu")
    mhd = MhdAmrSim(pparams(MHD_BLOB, ndim=2), device="cpu")
    mhd.evolve(1.0, nstepmax=1)
    mhd_back = MhdAmrSim.from_snapshot(mhd.params,
                                       mhd.dump(1, str(tmp_path / "m")),
                                       device="cpu")
    worst = 0.0
    for got, want in ((back, sim), (amr_back, amr), (mhd_back, mhd)):
        g, w = _state(got), _state(want)
        for k in w:
            assert g[k].dtype == np.float32
            if k.startswith("bf"):
                assert np.array_equal(g[k], w[k]), k
                continue
            ulps = np.abs(g[k].astype(np.float64) - w[k]) \
                / np.spacing(np.abs(w[k]))
            worst = max(worst, float(ulps.max()))
    assert worst <= 1.0, worst


# ---------------------------------------------------------------------------
# nrestart through run_namelist and the CLI
# ---------------------------------------------------------------------------

UNI_OUT = "noutput=2\ntout=0.02,0.04\ntend=0.04"


def _namelist(tmp_path, driver, run=""):
    """A small namelist of each driver; ``run`` goes into &RUN_PARAMS."""
    if driver == "uniform":
        text = sod_text(lmin=4, lmax=4, run=run)
        text = text.replace("noutput=1\ntout=0.1\ntend=0.1", UNI_OUT)
    elif driver == "amr":
        text = sod_text(run=run)
    elif driver == "mhd":
        text = open(os.path.join(NMLS, "orszag2d.nml")).read() \
            .replace("levelmin=5", "levelmin=4") \
            .replace("levelmax=7", "levelmax=4") \
            .replace("&RUN_PARAMS\n", f"&RUN_PARAMS\n{run}\n")
    else:
        text = MHD_BLOB.replace("&RUN_PARAMS\n", f"&RUN_PARAMS\n{run}\n") \
            + "&OUTPUT_PARAMS\ntend=1.0\n/\n"
    path = tmp_path / f"{driver}_{abs(hash(run))}.nml"
    path.write_text(text)
    return str(path)


NDIM = {"uniform": 2, "amr": 2, "mhd": 2, "mhd_amr": 2}


def _cli(nml, *flags):
    """The CLI in process on the CPU in f64 (``run_cli``: the final sim)."""
    return run_cli([nml, "--ndim", "2", "--device", "cpu", "--dtype",
                    "float64", *flags])


def _first_output(tmp_path, driver, run=""):
    """A CLI run that writes ``output_00001/`` (the uniform hydro driver at
    its first output time, the others at their end, after 2 steps);
    returns (the run's sim, the ``nstepmax`` the resumed run takes to end
    where an uninterrupted 4-step run, or the uniform run, ends)."""
    if driver == "uniform":
        first = _cli(_namelist(tmp_path, driver, run))
        assert os.path.isdir("output_00001") and os.path.isdir(
            "output_00002")
        assert os.path.exists(os.path.join("output_00001", "namelist.txt"))
        return first, 10 ** 6
    first = _cli(_namelist(tmp_path, driver, f"nstepmax=2\n{run}"))
    assert first.nstep == 2 and os.path.isdir("output_00001")
    return first, 4


@pytest.mark.parametrize("driver", ["uniform", "amr", "mhd", "mhd_amr"])
def test_nrestart_resumes_through_run_namelist(driver, tmp_path,
                                               monkeypatch):
    """The CLI writes ``output_00001/``; the same namelist with
    ``nrestart=1`` through ``run_namelist`` is equal to the uninterrupted
    run (4 steps; the uniform hydro driver to its last output time)."""
    monkeypatch.chdir(tmp_path)
    ref = run_namelist(_namelist(tmp_path, driver, "nstepmax=4"), ndim=2,
                       dtype=torch.float64, device="cpu")
    for name in os.listdir(tmp_path):
        assert not name.startswith("output_")
    first, nstepmax = _first_output(tmp_path, driver)
    if driver == "uniform":
        ref = first
    back = run_namelist(
        _namelist(tmp_path, driver, f"nrestart=1\nnstepmax={nstepmax}"),
        ndim=2, dtype=torch.float64, device="cpu")
    assert back.nstep == ref.nstep and back.t == pytest.approx(ref.t,
                                                               rel=1e-12)
    _assert_state_close(back, ref, **RUN_TOL)


@pytest.mark.parametrize("driver", ["uniform", "amr", "mhd", "mhd_amr"])
def test_nrestart_with_debug_nan_runs_to_its_end(driver, tmp_path,
                                                 monkeypatch, capsys):
    """``&RUN_PARAMS debug_nan`` arms OpsGuard's dt probe.  A resumed run
    has taken steps but knows no dt of its own until its first chunk after
    the restore: the CLI with ``nrestart=1`` runs to its end, with no NaN
    trap and no emergency dump, equal to the uninterrupted run."""
    monkeypatch.chdir(tmp_path)
    first, nstepmax = _first_output(tmp_path, driver, "debug_nan=.true.")
    ref = first if driver == "uniform" else run_namelist(
        _namelist(tmp_path, driver, "nstepmax=4"), ndim=2,
        dtype=torch.float64, device="cpu")
    capsys.readouterr()
    back = _cli(_namelist(tmp_path, driver, f"nrestart=1\ndebug_nan=.true."
                          f"\nnstepmax={nstepmax}"))
    out = capsys.readouterr().out
    assert "NaN TRAP" not in out, out
    assert not [n for n in os.listdir(tmp_path)
                if n.startswith("output_009")]
    assert back.nstep == ref.nstep and back.t == pytest.approx(ref.t,
                                                               rel=1e-12)
    _assert_state_close(back, ref, **RUN_TOL)


def test_nrestart_through_the_cli(tmp_path):
    """The CLI writes each output time's snapshot; a second CLI run with
    ``nrestart=1`` resumes from the first and writes the second again,
    equal to the first run's within the run tolerance."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")

    def cli(nml):
        out = subprocess.run(
            [sys.executable, "-m", "ramses_tpu_torch", nml, "--ndim", "2",
             "--device", "cpu", "--dtype", "float64"],
            capture_output=True, text=True, cwd=tmp_path, env=env,
            timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout

    cli(_namelist(tmp_path, "uniform"))
    from ramses_tpu_torch.io import reader as rdr
    first = rdr.leaf_cells(rdr.load_snapshot(
        str(tmp_path / "output_00002")))
    os.rename(tmp_path / "output_00002", tmp_path / "first_00002")
    text = cli(_namelist(tmp_path, "uniform", "nrestart=1"))
    assert "totals: t=4.000000e-02" in text
    again = rdr.leaf_cells(rdr.load_snapshot(
        str(tmp_path / "output_00002")))
    for k in ("density", "velocity_x", "pressure"):
        np.testing.assert_allclose(again[k], first[k], **RUN_TOL)


def test_emergency_checkpoint_resumes_the_output_schedule(tmp_path):
    """An OpsGuard dump (iout 900 on) is no output-schedule index: the
    restore derives the next output from its time."""
    p = pparams(sod_text(lmin=4, lmax=4).replace(
        "noutput=1\ntout=0.1\ntend=0.1", UNI_OUT), ndim=2)
    sim = Simulation(p, dtype=torch.float64, device="cpu")
    sim.evolve()
    assert sim.state.iout == 3
    back = Simulation.from_snapshot(p, sim.dump(900, str(tmp_path)),
                                    dtype=torch.float64, device="cpu")
    assert back.state.iout == 3
    sim.state.t = 0.03
    back = Simulation.from_snapshot(p, sim.dump(901, str(tmp_path)),
                                    dtype=torch.float64, device="cpu")
    assert back.state.iout == 2
    back = Simulation.from_snapshot(p, sim.dump(1, str(tmp_path)),
                                    dtype=torch.float64, device="cpu")
    assert back.state.iout == 2


# ---------------------------------------------------------------------------
# the pario refusal
# ---------------------------------------------------------------------------

PARIO = "elastic sharded checkpoints (&OUTPUT_PARAMS pario)"


def _pario_params(kind):
    if kind == "uniform":
        p = pparams(sod_text(lmin=3, lmax=3), ndim=2)
    elif kind in ("amr", "sharded"):
        p = pparams(sod_text(), ndim=2)
    elif kind == "mhd":
        p = pparams(MHD_BLOB.replace("levelmax=5", "levelmax=4"), ndim=2)
    else:
        p = pparams(MHD_BLOB, ndim=2)
    p.output.pario = True
    return p


@pytest.mark.parametrize("kind", ["uniform", "amr", "sharded", "mhd",
                                  "mhd_amr", "run_namelist", "cli"])
def test_pario_refused_by_name(kind, tmp_path):
    cls = {"uniform": Simulation, "amr": AmrSim, "mhd": MhdSimulation,
           "mhd_amr": MhdAmrSim}.get(kind)
    if cls is not None:
        with pytest.raises(NotImplementedError, match=PARIO.replace(
                "(", r"\(").replace(")", r"\)")):
            cls(_pario_params(kind), device="cpu")
        return
    if kind == "sharded":
        with pytest.raises(NotImplementedError, match="pario"):
            ShardedAmrSim(_pario_params(kind),
                          devices=ShardMesh(["cpu"] * 2))
        return
    nml = tmp_path / "pario.nml"
    nml.write_text(sod_text(lmin=3, lmax=3).replace(
        "tend=0.1", "tend=0.1\npario=.true."))
    if kind == "run_namelist":
        with pytest.raises(NotImplementedError, match="pario"):
            run_namelist(str(nml), ndim=2, device="cpu")
        return
    from ramses_tpu_torch.__main__ import main
    with pytest.raises(NotImplementedError, match="pario") as err:
        main([str(nml), "--ndim", "2", "--device", "cpu"])
    assert PARIO in str(err.value)


def test_particles_in_a_snapshot_refused(tmp_path):
    """A JAX dump that carries particles restores them (``restore_particles``)
    on the uniform driver and the hydro hierarchy, lane for lane the JAX
    package's restore (the uniform driver keeps them under ``pic``, as
    the JAX one does); the MHD hierarchy, which runs no particles, refuses
    them by name."""
    from ramses_tpu.io.restart import restore_particles as jrestore
    from ramses_tpu.io.restart import restore_uniform as jrestore_uniform
    from ramses_tpu.pm.particles import ParticleSet
    from ramses_tpu_torch.io.restart import restore_particles
    jp = jparams(sod_text(lmin=3, lmax=3), ndim=2)
    jsim = JSimulation(jp, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    jsim.state.p = ParticleSet.make(rng.random((20, 2)),
                                    rng.standard_normal((20, 2)),
                                    rng.random(20))
    out = jsim.dump(1, str(tmp_path))
    _, _, parts = jrestore_uniform(out, jp, jsim.cfg)
    want = jrestore(parts, 2, nmax=24)
    got = restore_particles(parts, 2, dtype=torch.float64, device="cpu",
                            nmax=24)
    for f in ("x", "v", "m", "active", "idp", "family", "tp", "zp"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    text = sod_text(lmin=3, lmax=3).replace("&RUN_PARAMS",
                                            "&RUN_PARAMS\npic=.true.")
    usim = Simulation.from_snapshot(pparams(text, ndim=2), out,
                                    dtype=torch.float64, device="cpu")
    assert np.array_equal(usim.state.p.x.numpy(), np.asarray(jsim.state.p.x))
    asim = AmrSim.from_snapshot(pparams(sod_text(), ndim=2), out,
                                dtype=torch.float64, device="cpu")
    assert np.array_equal(asim.p.idp.numpy(), np.asarray(jsim.state.p.idp))
    with pytest.raises(NotImplementedError, match="particles in a snapshot"):
        MhdAmrSim.from_snapshot(
            pparams(sod_text().replace("hllc", "llf"), ndim=2), out,
            device="cpu")


def test_pario_checkpoint_dir_refused(tmp_path):
    d = tmp_path / "pario_00001"
    d.mkdir()
    with pytest.raises(NotImplementedError, match="pario"):
        AmrSim.from_checkpoint_dir(pparams(sod_text(), ndim=2), str(d),
                                   device="cpu")
