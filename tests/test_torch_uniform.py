"""The uniform-grid slice as a whole: the port's driver against the JAX one.

``namelists/sedov3d.nml`` cut to 32³ is loaded through each package's own
``load_params``; both simulations start from the JAX one's initial state
(through ``convert``), evolve 10 steps in chunks of 4, and are compared on
``u``, ``t`` and ``nstep``.

- f64: the port runs ``muscl.unsplit`` like the JAX package's XLA path;
  same algorithm, same order → rtol 1e-10.
- f32: the port runs the fused kernel's plain version, whose JAX
  counterpart is the Pallas path (``_run_steps_pallas``, Courant dt from
  the kernel), run here in interpreter mode as the JAX package's own kernel
  tests run it.  Fields are compared at 1e-4 of each field's max: the
  Sedov contrast of 1e-5 against the blast amplifies f32 rounding.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.config import load_params as jload_params  # noqa: E402
from ramses_tpu.driver import Simulation as JSimulation  # noqa: E402
from ramses_tpu.grid import uniform as juniform  # noqa: E402
from ramses_tpu.hydro import pallas_muscl as pk  # noqa: E402

from ramses_tpu_torch.config import load_params  # noqa: E402
from ramses_tpu_torch.convert import hydro_static_from  # noqa: E402
from ramses_tpu_torch.driver import Simulation, run_namelist  # noqa: E402
from ramses_tpu_torch.grid import uniform  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NML = os.path.join(ROOT, "namelists", "sedov3d.nml")
LEVEL = 5                      # 32³


def _params(loader, level=LEVEL):
    p = loader(NML, ndim=3)
    p.amr.levelmin = p.amr.levelmax = level
    return p


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """Route the JAX driver's uniform f32 3D steps through the Pallas
    kernel in interpreter mode (its TPU path), for this test only."""
    jax.clear_caches()
    monkeypatch.setattr(juniform, "_pallas_ok",
                        lambda grid, dtype: grid.cfg.ndim == 3
                        and dtype == jnp.float32)
    monkeypatch.setattr(pk, "fused_step_padded",
                        functools.partial(pk.fused_step_padded,
                                          interpret=True))
    yield
    jax.clear_caches()


def _evolve_both(dtype_j, dtype_t):
    jsim = JSimulation(_params(jload_params), dtype=dtype_j)
    sim = Simulation.from_state(_params(load_params),
                                np.asarray(jsim.state.u), jsim.state.t,
                                jsim.state.nstep, device="cpu")
    assert sim.state.u.dtype == dtype_t
    assert hydro_static_from(jsim.cfg) == sim.cfg
    jsim.evolve(chunk=4)
    sim.evolve(chunk=4)
    return jsim, sim


def test_slice_f64_matches_jax():
    jsim, sim = _evolve_both(jnp.float64, torch.float64)
    assert not uniform.fused_ok(sim.grid, torch.float64)
    assert sim.nstep == jsim.nstep == 10
    assert sim.t == pytest.approx(jsim.t, rel=1e-10)
    np.testing.assert_allclose(sim.state.u.numpy(), np.asarray(jsim.state.u),
                               rtol=1e-10, atol=1e-14)


def test_slice_f32_matches_jax_kernel_path(jax_pallas_interpret):
    jsim, sim = _evolve_both(jnp.float32, torch.float32)
    assert uniform.fused_ok(sim.grid, torch.float32)
    assert sim.nstep == jsim.nstep == 10
    assert sim.t == pytest.approx(jsim.t, rel=1e-5)
    got, want = sim.state.u.numpy(), np.asarray(jsim.state.u)
    assert np.isfinite(got).all()
    for c in range(got.shape[0]):
        scale = np.abs(want[c]).max()
        assert np.abs(got[c] - want[c]).max() <= 1e-4 * scale, c


def test_slice_totals_conserved_f32():
    """Periodic box: mass and energy are conserved by the fused step."""
    p = _params(load_params, level=4)
    sim = Simulation(p, device="cpu")
    before = {k: float(v) for k, v in sim.totals().items()
              if k != "momentum"}
    sim.evolve(chunk=4)
    after = sim.totals()
    assert sim.nstep == 10
    assert float(after["mass"]) == pytest.approx(before["mass"], rel=1e-5)
    assert float(after["energy"]) == pytest.approx(before["energy"],
                                                   rel=1e-5)


def test_run_steps_trace_and_tend_clipping_match_jax():
    """tend clipping: a chunk stops exactly on tend and later steps are
    no-ops; trace returns the per-step (t, dt) history, as in JAX (f64)."""
    jsim = JSimulation(_params(jload_params, level=3), dtype=jnp.float64)
    sim = Simulation.from_state(_params(load_params, level=3),
                                np.asarray(jsim.state.u), 0.0, 0,
                                device="cpu")
    tend = 2.5 * float(uniform.cfl_dt(sim.grid, sim.state.u))
    ju, jt, jn, (jts, jdts) = juniform.run_steps(
        jsim.grid, jsim.state.u, jnp.asarray(0.0), jnp.asarray(tend), 6,
        trace=True)
    u, t, ndone, (ts, dts) = uniform.run_steps(sim.grid, sim.state.u, 0.0,
                                               tend, 6, trace=True)
    assert int(ndone) == int(jn) < 6
    assert float(t) == float(jt) == tend
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), rtol=1e-10)
    np.testing.assert_allclose(dts.numpy(), np.asarray(jdts), rtol=1e-10)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-10,
                               atol=1e-14)
    # the fused path (f32) clips the same way
    u32 = sim.state.u.to(torch.float32)
    u, t, ndone, (ts, dts) = uniform.run_steps(sim.grid, u32, 0.0, tend, 6,
                                               trace=True)
    assert uniform.fused_ok(sim.grid, torch.float32)
    assert float(t) == tend and 0 < int(ndone) < 6
    assert float(dts[int(ndone):].abs().sum()) == 0.0
    assert torch.isfinite(u).all()


def test_entry_points_require_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot occur")
    with pytest.raises(RuntimeError):
        Simulation(_params(load_params, level=3))
    with pytest.raises(RuntimeError):
        run_namelist(NML, ndim=3)


def test_unported_features_raise():
    p = _params(load_params, level=3)
    p.run.pic = True
    with pytest.raises(NotImplementedError, match="particles"):
        Simulation(p, device="cpu")
    p = _params(load_params, level=3)
    p.amr.levelmax = 4
    with pytest.raises(NotImplementedError, match="AMR"):
        Simulation(p, device="cpu")

def test_supervised_run_namelist_completes(tmp_path, monkeypatch):
    """max_attempts > 1 runs under the supervisor: one attempt reaches
    nstepmax and returns; nothing is written without ``outputs``."""
    monkeypatch.chdir(tmp_path)
    text = open(NML).read().replace("levelmin=8", "levelmin=3") \
                           .replace("levelmax=8", "levelmax=3")
    nml = tmp_path / "sedov3d_8.nml"
    nml.write_text(text)
    sim = run_namelist(str(nml), ndim=3, max_attempts=2, device="cpu",
                       nstepmax=3)
    assert isinstance(sim, Simulation) and sim.nstep == 3
    assert not [n for n in os.listdir(tmp_path) if n.startswith("output_")]


# the uniform driver's refusals of the JAX driver's run-control layer
# (ramses_tpu/driver.py:239-252): (namelist line, the Params field it
# sets, its value, the name the refusal gives)
RUN_CONTROL = [
    ("max_step_retries=2", "run", "max_step_retries", 2, "step guard"),
    ("step_deadline_s=5.0", "run", "step_deadline_s", 5.0, "watchdog"),
    ("fault_inject='nan@3'", "run", "fault_inject", "nan@3",
     "fault injection"),
    (None, "output", "telemetry", "events.jsonl", "telemetry"),
]


@pytest.mark.parametrize("line,group,key,value,name", RUN_CONTROL,
                         ids=[c[2] for c in RUN_CONTROL])
def test_run_control_features_raise(tmp_path, line, group, key, value,
                                    name):
    from ramses_tpu_torch.__main__ import main
    p = _params(load_params, level=3)
    setattr(getattr(p, group), key, value)
    with pytest.raises(NotImplementedError, match=name):
        Simulation(p, device="cpu")
    # sedov3d_telemetry.nml (telemetry on), with the key added to
    # &RUN_PARAMS: each set key is named
    text = open(os.path.join(ROOT, "namelists",
                             "sedov3d_telemetry.nml")).read()
    if line is not None:
        text = text.replace("&RUN_PARAMS\n", f"&RUN_PARAMS\n{line}\n")
    nml = tmp_path / "run.nml"
    nml.write_text(text)
    for run in (lambda: run_namelist(str(nml), ndim=3, device="cpu"),
                lambda: main([str(nml), "--ndim", "3", "--device", "cpu"])):
        with pytest.raises(NotImplementedError, match=name) as err:
            run()
        assert "telemetry (&OUTPUT_PARAMS telemetry)" in str(err.value)


def test_cli_runs_on_cpu(tmp_path):
    text = open(NML).read().replace("levelmin=8", "levelmin=4") \
                           .replace("levelmax=8", "levelmax=4")
    nml = tmp_path / "sedov3d_16.nml"
    nml.write_text(text)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "ramses_tpu_torch", str(nml), "--ndim", "3",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["10"]
    assert lines[-1].startswith("totals: ") and "nstep=10" in lines[-1]
