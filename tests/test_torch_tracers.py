"""The port's Monte-Carlo gas tracers on the AMR hierarchy, on the CPU.

* the slice as a whole against the JAX package: a 3D Sedov blast in a
  bulk flow at levelmin 4, levelmax 6 with ``&RUN_PARAMS tracer`` in f64,
  seeded by
  each package on its own state, 3 coarse steps with a regrid before
  each: every level within the f64 tolerance (rtol 1e-10 / atol 1e-12)
  and ``tracer_x`` / ``tracer_id`` identical (the jumps draw from the same
  numpy generator, so equal captures give equal tracers);
* ``mc_tracer_amr`` against the JAX package's on one tree, one capture,
  one pre-step density and one generator state, periodic and with outflow
  walls (tracers that leave are dropped with their ids): identical;
* the ports of ``tests/test_mc_tracer_amr.py``'s oracles (2D, f32): the
  captured face fluxes reproduce the mass update on every leaf cell to
  rtol 2e-4 / atol 2e-6, and tracers drift at the gas velocity across a
  refinement boundary;
* the coarse step's capture runs through the kernels' flux variants only
  on CUDA tensors: here the plain versions, which count no launch.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.amr.tree import Octree as JOctree  # noqa: E402
from ramses_tpu.config import params_from_string as jparams  # noqa: E402
from ramses_tpu.pm import amr_physics as jap  # noqa: E402

from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.amr.tree import Octree  # noqa: E402
from ramses_tpu_torch.config import Params  # noqa: E402
from ramses_tpu_torch.config import params_from_string as pparams  # noqa: E402
from ramses_tpu_torch.convert import amr_state_from  # noqa: E402
from ramses_tpu_torch.hydro import fused_muscl as fm  # noqa: E402
from ramses_tpu_torch.hydro import oct_muscl as om  # noqa: E402
from ramses_tpu_torch.pm import amr_physics as ap  # noqa: E402
from ramses_tpu_torch.pm.particles import TRACER_ID0  # noqa: E402

SEDOV = """
&RUN_PARAMS
hydro=.true.
tracer=.true.
tracer_per_cell=1.0
/
&AMR_PARAMS
levelmin=4
levelmax=6
boxlen=1.0
/
&INIT_PARAMS
nregion=2
region_type(1)='square'
region_type(2)='point'
x_center=0.5,0.5
y_center=0.5,0.5
z_center=0.5,0.5
length_x=10.0,1.0
length_y=10.0,1.0
length_z=10.0,1.0
d_region=1.0,0.0
u_region=0.5,0.0
v_region=0.25,0.0
p_region=1e-5,0.1
/
&HYDRO_PARAMS
gamma=1.4
courant_factor=0.7
slope_type=1
riemann='llf'
/
&REFINE_PARAMS
err_grad_p=0.1
/
"""


@pytest.fixture(scope="module")
def sedov_runs():
    """Both packages' tracer runs, f64: the initial sims' tracers and each
    run after 3 coarse steps."""
    jsim = JAmrSim(jparams(SEDOV, ndim=3), dtype=jnp.float64)
    psim = AmrSim(pparams(SEDOV, ndim=3), dtype=torch.float64,
                  device="cpu")
    seeds = [(np.array(s.tracer_x), np.array(s.tracer_id))
             for s in (jsim, psim)]
    for sim in (jsim, psim):
        for _ in range(3):
            sim.evolve(1e9, nstepmax=sim.nstep + 1)
    return seeds, jsim, psim


def test_seeding_matches_jax(sedov_runs):
    (jx, jid), (px, pid) = sedov_runs[0]
    assert len(px) > 1000
    assert np.array_equal(px, jx) and np.array_equal(pid, jid)
    assert np.array_equal(pid, TRACER_ID0 + np.arange(len(px)))


def test_tracer_sedov_matches_jax(sedov_runs):
    seeds, jsim, psim = sedov_runs
    x0 = seeds[1][0]
    assert psim.nstep == jsim.nstep == 3
    assert psim.t == pytest.approx(jsim.t, rel=1e-12)
    assert psim._fused_spec().want_flux
    for l in jsim.levels():
        assert np.array_equal(jsim.tree.levels[l].keys,
                              psim.tree.levels[l].keys), l
        n = jsim.tree.noct(l) * 8
        np.testing.assert_allclose(psim.u[l].numpy()[:n],
                                   np.asarray(jsim.u[l])[:n], rtol=1e-10,
                                   atol=1e-12, err_msg=f"level {l}")
    assert np.array_equal(psim.tracer_x, jsim.tracer_x)
    assert np.array_equal(psim.tracer_id, jsim.tracer_id)
    moved = (psim.tracer_x != x0).any(axis=1).sum()
    assert moved > 50                 # the bulk flow moved some
    assert "tracers=" in psim.status_note()


def _fake(mod_tree, jtree, phi, rho0, x, ids, kinds, seed, torch_side):
    """A stand-in for a simulation as ``mc_tracer_amr`` reads it."""
    tree = mod_tree(jtree.ndim, jtree.levelmin, jtree.levelmax)
    for l, lev in jtree.levels.items():
        tree.set_level(l, lev.og)
    conv = torch.from_numpy if torch_side else np.asarray
    levels = sorted(jtree.levels)
    return types.SimpleNamespace(
        tracer_x=x.copy(), tracer_id=ids.copy(), tree=tree,
        cfg=types.SimpleNamespace(ndim=jtree.ndim), lmin=jtree.levelmin,
        levels=lambda: levels, boxlen=1.0, bc_kinds=kinds,
        dx=lambda l: 1.0 / (1 << l),
        _tracer_phi={l: conv(v) for l, v in phi.items()},
        _tracer_rho0={l: conv(v) for l, v in rho0.items()},
        _tracer_rng=np.random.default_rng(seed))


@pytest.mark.parametrize("outflow", [False, True])
def test_mc_tracer_amr_matches_jax(sedov_runs, outflow):
    """Large random captures, so that most tracers jump and, with outflow
    walls, some leave the box."""
    _, jsim, _ = sedov_runs
    rng = np.random.default_rng(4 + outflow)
    phi = {l: 0.5 * rng.standard_normal((jsim.u[l].shape[0], 3, 2))
           for l in jsim.levels()}
    rho0 = {l: 0.5 + rng.random(jsim.u[l].shape[0])
            for l in jsim.levels()}
    x = rng.random((4000, 3))
    x[:100] = rng.choice([0.002, 0.998], size=(100, 3))   # at the walls
    ids = TRACER_ID0 + np.arange(len(x))
    kinds = [(2, 2)] * 3 if outflow else [(0, 0)] * 3
    want = _fake(JOctree, jsim.tree, phi, rho0, x, ids, kinds, 7, False)
    got = _fake(Octree, jsim.tree, phi, rho0, x, ids, kinds, 7, True)
    jap.mc_tracer_amr(want)
    ap.mc_tracer_amr(got)
    assert got._tracer_phi is None
    assert np.array_equal(got.tracer_x, want.tracer_x)
    assert np.array_equal(got.tracer_id, want.tracer_id)
    assert (len(got.tracer_x) < len(x)) == outflow
    if not outflow:
        assert (got.tracer_x != x).any(axis=1).mean() > 0.5


def test_ngp_rows_matches_jax(sedov_runs):
    _, jsim, psim = sedov_runs
    x = np.random.default_rng(2).random((500, 3))
    for l in jsim.levels():
        assert np.array_equal(
            ap.ngp_rows(psim.tree, x, l, 1.0, psim.bc_kinds),
            jap.ngp_rows(jsim.tree, x, l, 1.0, jsim.bc_kinds))


def _uniform_flow_params(vx=0.5):
    """``tests/test_mc_tracer_amr.py``'s set-up: a uniform 2D flow with a
    statically refined ball in the middle (geometry criterion only)."""
    p = Params(ndim=2)
    p.run.tracer = True
    p.run.tracer_per_cell = 2.0
    p.amr.levelmin, p.amr.levelmax = 4, 5
    p.amr.boxlen = 1.0
    p.init.nregion = 1
    p.init.region_type = ["square"]
    p.init.x_center, p.init.y_center = [0.5], [0.5]
    p.init.length_x, p.init.length_y = [10.0], [10.0]
    p.init.exp_region = [10.0]
    p.init.d_region, p.init.p_region = [1.0], [1.0]
    p.init.u_region, p.init.v_region = [vx], [0.0]
    i = 4 - 1
    p.refine.r_refine[i] = 0.2
    p.refine.x_refine[i], p.refine.y_refine[i] = 0.5, 0.5
    return p


def test_mc_capture_matches_mass_update(monkeypatch):
    """Σ_d (φ_lo - φ_hi) == Δρ on every leaf cell of every level."""
    sim = AmrSim(_uniform_flow_params(), device="cpu")
    assert sim._fused_spec().want_flux
    captured = {}
    real = ap.mc_tracer_amr

    def grab(s):
        captured.update({l: v.numpy().copy()
                         for l, v in s._tracer_phi.items()})
        real(s)

    monkeypatch.setattr(ap, "mc_tracer_amr", grab)
    # the second step exercises a developed state too
    for _ in range(2):
        u0 = {l: sim.u[l].numpy().copy() for l in sim.levels()}
        captured.clear()
        sim.step_coarse(sim.coarse_dt())
        for l in sim.levels():
            ncell = sim.maps[l].noct * 2 ** sim.cfg.ndim
            leaf = ~sim.tree.refined_mask(l)
            drho = (sim.u[l].numpy() - u0[l])[:ncell, 0]
            phi = captured[l][:ncell]
            net = (phi[:, :, 0] - phi[:, :, 1]).sum(axis=1)
            np.testing.assert_allclose(net[leaf], drho[leaf],
                                       rtol=2e-4, atol=2e-6)


def test_mc_tracer_amr_uniform_advection():
    """Ensemble drift == v·t across the refinement boundary."""
    sim = AmrSim(_uniform_flow_params(vx=0.5), device="cpu")
    assert sim.tracer_x is not None and len(sim.tracer_x) > 200
    assert sim.tree.has(5) and sim.tree.noct(5) < sim.tree.noct(4)
    x0 = np.asarray(sim.tracer_x).copy()
    n0 = len(x0)
    sim.evolve(1e9, nstepmax=10)
    assert len(sim.tracer_x) == n0          # periodic: nothing escapes
    L = sim.boxlen
    disp = np.mod(sim.tracer_x - x0 + 0.5 * L, L) - 0.5 * L
    drift = disp.mean(axis=0)
    assert abs(drift[0] - 0.5 * sim.t) < 0.025
    assert abs(drift[1]) < 0.025
    for l in sim.levels():
        rho = sim.u[l].numpy()[:sim.maps[l].noct * 4, 0]
        assert np.allclose(rho, 1.0, atol=1e-3)


def test_tracer_run_on_cpu_launches_no_kernel():
    """A 3D f32 tracer step runs the flux variants' plain versions here,
    which count no launch, and a chunked step is refused while tracers
    exist (they move after every coarse step)."""
    p = pparams(SEDOV, ndim=3)
    sim = AmrSim(p, dtype=torch.float32, device="cpu")
    before = (fm.launches, fm.flux_launches, dict(om.launches))
    sim.step_coarse(sim.coarse_dt())
    assert (fm.launches, fm.flux_launches, dict(om.launches)) == before
    with pytest.raises(ValueError, match="step_coarse"):
        sim.step_chunk(2, 1e9)


def test_from_state_carries_tracers_and_generator(sedov_runs):
    _, jsim, _ = sedov_runs
    state = amr_state_from(jsim)
    psim = AmrSim.from_state(pparams(SEDOV, ndim=3), **state, device="cpu")
    assert np.array_equal(psim.tracer_x, jsim.tracer_x)
    assert np.array_equal(psim.tracer_id, jsim.tracer_id)
    # the same next draws as the JAX run's generator
    a = np.random.default_rng()
    a.bit_generator.state = state["tracer_rng"]
    assert np.array_equal(psim._tracer_rng.random(5), a.random(5))
    # without given tracers, the port seeds on the given state
    del state["tracer_x"], state["tracer_id"], state["tracer_rng"]
    c = AmrSim.from_state(pparams(SEDOV, ndim=3), **state, device="cpu")
    assert c.tracer_x is not None and len(c.tracer_x) > 1000


def test_tracer_sedov_nml_through_the_cli(tmp_path):
    """``namelists/tracer_sedov.nml`` (2D, the general formulation) as the
    CLI runs it, cut to 3 coarse steps: the closing line reports the
    tracer count, which the periodic box keeps at the JAX package's
    seeding."""
    import os
    import subprocess
    import sys
    from ramses_tpu.config import load_params as jload
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, "namelists", "tracer_sedov.nml")
    nml = tmp_path / "tracer_sedov.nml"
    nml.write_text(open(src).read().replace("nstepmax=100", "nstepmax=3"))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "ramses_tpu_torch", str(nml), "--ndim", "2",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("totals: ") and "nstep=3" in last
    count = int(last.split("tracers=")[1].split()[0])
    want = len(JAmrSim(jload(src, ndim=2)).tracer_x)
    assert count == want > 1000
