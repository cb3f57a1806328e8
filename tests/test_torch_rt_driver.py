"""Radiative transfer in the port's uniform driver and CLI against the JAX
package's, on the CPU in f64.

* ``Simulation`` with ``&RUN_PARAMS rt`` on shrunk copies of the five RT
  namelists (``iliev1``: hydro steps with RT once a chunk; ``rad_beams``:
  rt_pp beams in an outflow box; ``stromgren2d``, ``stromgren3``,
  ``twin_rad_src``: static): after the run the gas ``u`` and the RT state
  (N, F, x, T) within 1e-9 × each field's max, the same step count and
  time;
* the static branch (one RT advance to each output time, one step) and the
  chunk cadence (one advance a chunk, by the chunk's time: the substeps
  the port runs are the ones the chunk lengths ask for);
* ``rt_stats`` against the JAX package's;
* the CLI on the CPU (``python -m ramses_tpu_torch … --device cpu``) on a
  shrunk stromgren3 and rad_beams;
* the refusals that stay: MHD, ``ShardedAmrSim``, a non-cubic root with
  rt, a source type other than 'point'.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.config import load_params as jload  # noqa: E402
from ramses_tpu.driver import Simulation as JSimulation  # noqa: E402

from ramses_tpu_torch.config import load_params  # noqa: E402
from ramses_tpu_torch.driver import Simulation, unported_features  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_REL = 1e-9


def _shrunk(tmp_path, name, subs):
    text = open(os.path.join(ROOT, "namelists", f"{name}.nml")).read()
    for pat, rep in subs:
        text, n = re.subn(pat, rep, text)
        assert n, pat
    path = tmp_path / f"{name}.nml"
    path.write_text(text)
    return str(path)


LEVEL4 = [(r"levelmin=\d+", "levelmin=4"), (r"levelmax=\d+", "levelmax=4")]
CASES = {
    "iliev1": (3, LEVEL4 + [(r"tout=0\.03", "tout=100.0")]),
    "rad_beams": (2, LEVEL4 + [(r"tout=0\.02", "tout=0.1")]),
    "stromgren2d": (2, LEVEL4 + [(r"tout=15\.0", "tout=1.0")]),
    "stromgren3": (3, LEVEL4 + [(r"tout=1\.9e14", "tout=4e13")]),
    "twin_rad_src": (2, LEVEL4 + [(r"tout=0\.02", "tout=0.1")]),
}


def close(got, want, rel=RUN_REL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want),
                                 rel * np.abs(want).max() + 1e-300)


def _pair(path, ndim):
    js = JSimulation(jload(path, ndim=ndim), dtype=jnp.float64)
    ps = Simulation(load_params(path, ndim=ndim), dtype=torch.float64,
                    device="cpu")
    return js, ps


def _held(js, ps):
    assert ps.nstep == js.state.nstep
    assert ps.t == pytest.approx(js.state.t, rel=1e-14)
    close(ps.state.u, js.state.u)
    for f in ("N", "F", "x", "T"):
        close(getattr(ps.rt.sim, f), getattr(js.rt.sim, f))


@pytest.mark.parametrize("name", sorted(CASES))
def test_rt_namelist_matches_jax(tmp_path, name):
    ndim, subs = CASES[name]
    js, ps = _pair(_shrunk(tmp_path, name, subs), ndim)
    assert ps.rt is not None
    js.evolve(chunk=4)
    ps.evolve(chunk=4)
    _held(js, ps)
    st, jst = ps.rt.rt_stats(), js.rt.rt_stats()
    for k in ("photons", "injected", "ratio"):
        assert st[k] == pytest.approx(jst[k], rel=1e-9)


def test_static_branch_is_one_advance_an_output(tmp_path, monkeypatch):
    path = _shrunk(tmp_path, "stromgren3", LEVEL4 + [
        (r"noutput=1", "noutput=2"), (r"tout=1\.9e14", "tout=2e13,4e13")])
    ps = Simulation(load_params(path, ndim=3), dtype=torch.float64,
                    device="cpu")
    calls = []
    real = ps.rt.advance
    monkeypatch.setattr(ps.rt, "advance",
                        lambda u, dt: calls.append(dt) or real(u, dt))
    seen = []
    ps.on_output = lambda s, i: seen.append((i, s.nstep, s.t))
    ps.evolve()
    assert calls == [2e13, 2e13]
    assert seen == [(1, 1, 2e13), (2, 2, 4e13)]
    # no hydro: the gas moved only by its photoheated energy
    u0 = Simulation(load_params(path, ndim=3), dtype=torch.float64,
                    device="cpu").state.u
    assert torch.equal(ps.state.u[:4], u0[:4])
    assert bool((ps.state.u[4] >= u0[4]).all())


def test_chunk_cadence_advances_rt_by_each_chunk(tmp_path, monkeypatch):
    ndim, subs = CASES["iliev1"]
    ps = Simulation(load_params(_shrunk(tmp_path, "iliev1", subs), ndim=3),
                    dtype=torch.float64, device="cpu")
    steps = []
    real = ps.rt.advance

    def advance(u, dt):
        steps.append((ps.nstep, dt))
        return real(u, dt)
    monkeypatch.setattr(ps.rt, "advance", advance)
    ts = [ps.t]
    real_sp = ps._source_passes
    monkeypatch.setattr(ps, "_source_passes",
                        lambda dt: ts.append(ps.t) or real_sp(dt))
    ps.evolve(chunk=2)
    assert ps.nstep > 2 and len(steps) == (ps.nstep + 1) // 2
    assert [dt for _, dt in steps] == pytest.approx(np.diff(ts), rel=1e-15)


def test_rt_state_carries_across(tmp_path):
    from ramses_tpu_torch.convert import rt_state_from
    path = _shrunk(tmp_path, "stromgren3", CASES["stromgren3"][1])
    js, ps = _pair(path, 3)
    js.evolve()
    ps.rt.load_state(**rt_state_from(js.rt))
    for f in ("N", "F", "x", "T", "nH", "src"):
        assert np.array_equal(getattr(ps.rt.sim, f).numpy(),
                              np.asarray(getattr(js.rt.sim, f)))
    assert ps.rt.rt_stats()["injected"] == js.rt.rt_stats()["injected"]
    # both step the same state on: one more static advance
    js.rt.advance(js.state.u, 1e13)
    ps.rt.advance(torch.from_numpy(np.array(js.state.u)), 1e13)
    for f in ("N", "F", "x", "T"):
        close(getattr(ps.rt.sim, f), getattr(js.rt.sim, f))


@pytest.mark.parametrize("name", ["stromgren3", "rad_beams"])
def test_cli_runs_rt_namelists_on_the_cpu(tmp_path, name):
    import subprocess
    import sys
    ndim, subs = CASES[name]
    nml = _shrunk(tmp_path, name, subs)
    out = subprocess.run(
        [sys.executable, "-m", "ramses_tpu_torch", nml, "--ndim", str(ndim),
         "--device", "cpu", "--dtype", "float64"], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("totals: ") and "nstep=1" in last
    assert (tmp_path / "output_00001" / "info_00001.txt").exists()


def test_rt_refusals_that_stay(tmp_path):
    from ramses_tpu_torch.amr.hierarchy import AmrSim
    from ramses_tpu_torch.mhd.driver import (MhdSimulation,
                                             unported_mhd_features)
    from ramses_tpu_torch.parallel.amr_sharded import ShardedAmrSim
    p = load_params(_shrunk(tmp_path, "stromgren3", CASES["stromgren3"][1]),
                    ndim=3)
    assert unported_features(p) == []
    assert any("radiative transfer" in n for n in unported_mhd_features(p))
    with pytest.raises(NotImplementedError, match="radiative transfer"):
        MhdSimulation(p, device="cpu")
    p.amr.levelmax = 5
    with pytest.raises(NotImplementedError, match="radiative transfer on "
                                                  "ShardedAmrSim"):
        ShardedAmrSim(p, devices=["cpu"] * 2)
    p.amr.nx = 2
    with pytest.raises(NotImplementedError, match="non-cubic.*rt"):
        AmrSim(p, device="cpu")
    q = load_params(_shrunk(tmp_path, "twin_rad_src",
                            CASES["twin_rad_src"][1]), ndim=2)
    q.rt.rt_source_type = ["'shell'", "'point'"]
    with pytest.raises(NotImplementedError, match="only 'point' sources"):
        Simulation(q, dtype=torch.float64, device="cpu")


def test_rt_runs_in_f64_whatever_the_gas_dtype(tmp_path):
    ps = Simulation(load_params(_shrunk(tmp_path, "stromgren3",
                                        CASES["stromgren3"][1]), ndim=3),
                    dtype=torch.float32, device="cpu")
    ps.evolve()
    sim = ps.rt.sim
    assert ps.state.u.dtype == torch.float32
    for f in ("N", "F", "x", "T"):
        t = getattr(sim, f)
        assert t.dtype == torch.float64 and bool(torch.isfinite(t).all())
    assert float(sim.N.min()) >= 0.0
    st = ps.rt.rt_stats()
    assert 0.0 < st["photons"] <= 1.05 * st["injected"]


def test_restart_rebuilds_the_rt_state_fresh(tmp_path):
    # the snapshot holds no radiation: a restore starts RT from the gas,
    # as the JAX package's does
    path = _shrunk(tmp_path, "stromgren3", CASES["stromgren3"][1])
    ps = Simulation(load_params(path, ndim=3), dtype=torch.float64,
                    device="cpu")
    ps.evolve()
    out = ps.dump(1, str(tmp_path))
    back = Simulation.from_snapshot(load_params(path, ndim=3), out,
                                    dtype=torch.float64, device="cpu")
    fresh = Simulation(load_params(path, ndim=3), dtype=torch.float64,
                       device="cpu")
    assert back.t == ps.t and back.rt.rt_stats()["injected"] == 0.0
    for f in ("N", "F", "x", "src"):
        assert torch.equal(getattr(back.rt.sim, f), getattr(fresh.rt.sim, f))
