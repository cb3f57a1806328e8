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
  on CUDA tensors: here the plain versions, which count no launch;
* the MHD hierarchy's CIC velocity tracers (``tracer_drift_amr``; the MHD
  step captures no fluxes) against the JAX package's over 2 coarse steps
  and on a carried state: rtol 1e-10 / 1e-13;
* the uniform MC tracer functions: ``step_with_flux`` in f64 against the
  JAX package's (rtol 1e-10 / atol 1e-12) and through K1's ``want_flux``
  entry in f32 (its plain version here) against the general formulation
  (rtol 2e-5); ``mc_tracer_step`` with the JAX run's categorical choices
  fed to the port (rel 1e-14), and with its own generator.
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


# ---------------------------------------------------------------------------
# velocity tracers on the MHD hierarchy, and the uniform MC tracer step
# ---------------------------------------------------------------------------

MHD_TRACERS = """
&RUN_PARAMS
hydro=.true.
tracer=.true.
tracer_per_cell=1.0
nremap=1
/
&AMR_PARAMS
levelmin=4
levelmax=5
boxlen=1.0
/
&INIT_PARAMS
nregion=2
region_type='square','square'
x_center=0.5,0.5
y_center=0.5,0.5
length_x=10.0,0.4
length_y=10.0,0.4
exp_region=10.0,2.0
d_region=1.0,4.0
p_region=1.0,3.0
u_region=0.3,0.6
v_region=0.2,-0.4
A_region=0.5,0.5
B_region=0.3,0.3
/
&HYDRO_PARAMS
gamma=1.6666667
courant_factor=0.8
riemann='hlld'
slope_type=1
/
&REFINE_PARAMS
err_grad_d=0.05
/
"""


def test_mhd_velocity_tracers_match_jax():
    """The MHD hierarchy captures no face fluxes: its tracers drift with
    the CIC-gathered gas velocity (``tracer_drift_amr``).  Seeded by each
    package on its own state, then 2 coarse steps (a regrid each) with the
    JAX run's dts: positions at rtol 1e-10 / atol 1e-12, ids identical;
    then ``tracer_drift_amr`` on the JAX run's state carried across."""
    from ramses_tpu.mhd.amr import MhdAmrSim as JMhdAmrSim

    from ramses_tpu_torch.convert import mhd_amr_state_from
    from ramses_tpu_torch.mhd.amr import MhdAmrSim
    jsim = JMhdAmrSim(jparams(MHD_TRACERS, ndim=2), dtype=jnp.float64)
    psim = MhdAmrSim(pparams(MHD_TRACERS, ndim=2), dtype=torch.float64,
                     device="cpu")
    np.testing.assert_array_equal(psim.tracer_x, jsim.tracer_x)
    assert not psim._fused_spec().want_flux
    seeded = np.array(psim.tracer_x)
    for _ in range(2):
        jsim.regrid()
        psim.regrid()
        dt = jsim.coarse_dt()
        jsim.step_coarse(dt)
        psim.step_coarse(dt)
    assert psim._tracer_phi is None
    np.testing.assert_allclose(psim.tracer_x, jsim.tracer_x, rtol=1e-10,
                               atol=1e-12)
    assert np.array_equal(psim.tracer_id, jsim.tracer_id)
    assert np.abs(psim.tracer_x - seeded).max() > 0.0     # they moved
    csim = MhdAmrSim.from_state(pparams(MHD_TRACERS, ndim=2),
                                **mhd_amr_state_from(jsim), device="cpu")
    x0 = np.array(csim.tracer_x)
    jap.tracer_drift_amr(jsim, 0.01)
    ap.tracer_drift_amr(csim, 0.01)
    np.testing.assert_allclose(csim.tracer_x, jsim.tracer_x, rtol=1e-13,
                               atol=1e-15)
    assert np.abs(csim.tracer_x - x0).max() > 0.0
    with pytest.raises(ValueError, match="tracers"):
        csim.step_chunk(2, 1.0)


@pytest.mark.parametrize("nd", [2, 3])
def test_step_with_flux_matches_jax(nd):
    """The uniform step with its low-face mass fluxes, in f64 (the general
    formulation in both packages): rtol 1e-10 / atol 1e-12."""
    from ramses_tpu.grid import boundary as jb
    from ramses_tpu.grid import uniform as ju
    from ramses_tpu.hydro.core import HydroStatic as JStatic

    from ramses_tpu_torch.convert import hydro_static_from
    from ramses_tpu_torch.grid import boundary as pb
    from ramses_tpu_torch.grid import uniform as pu
    rng = np.random.default_rng(nd)
    shape = (12,) * nd
    jcfg = JStatic(ndim=nd, riemann="hllc", slope_type=2)
    u = np.empty((2 + nd,) + shape)
    u[0] = rng.uniform(0.5, 2.0, shape)
    u[1:1 + nd] = rng.standard_normal((nd,) + shape) * 0.3
    u[1 + nd] = rng.uniform(3.0, 5.0, shape)
    jgrid = ju.UniformGrid(cfg=jcfg, shape=shape, dx=1.0 / 12,
                           bc=jb.BoundarySpec.periodic(nd))
    pgrid = pu.UniformGrid(cfg=hydro_static_from(jcfg), shape=shape,
                           dx=1.0 / 12, bc=pb.BoundarySpec.periodic(nd))
    jun, jphi = ju.step_with_flux(jgrid, jnp.asarray(u), 0.01)
    pun, pphi = pu.step_with_flux(pgrid, torch.from_numpy(u), 0.01)
    np.testing.assert_allclose(pun.numpy(), np.asarray(jun), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(pphi.numpy(), np.asarray(jphi), rtol=1e-10,
                               atol=1e-12)
    # the fluxes account for the mass update
    du = -sum(pphi[d] - torch.roll(pphi[d], -1, d) for d in range(nd))
    np.testing.assert_allclose((pun[0] - torch.from_numpy(u[0])).numpy(),
                               -du.numpy(), rtol=1e-10, atol=1e-12)


def test_step_with_flux_takes_the_fused_entry_where_it_covers():
    """3D f32 within K1's scope: ``step_with_flux`` goes through K1's
    ``want_flux`` entry (its plain version on a CPU tensor) and its low-face
    flux is the general formulation's to f32 precision."""
    from ramses_tpu_torch.grid import boundary as pb
    from ramses_tpu_torch.grid import uniform as pu
    from ramses_tpu_torch.hydro.core import HydroStatic
    rng = np.random.default_rng(1)
    shape = (16, 16, 16)
    cfg = HydroStatic(ndim=3, riemann="hllc", slope_type=1)
    grid = pu.UniformGrid(cfg=cfg, shape=shape, dx=1.0 / 16,
                          bc=pb.BoundarySpec.periodic(3))
    assert pu.fused_ok(grid, torch.float32)
    u = np.empty((5,) + shape, dtype=np.float32)
    u[0] = rng.uniform(0.5, 2.0, shape)
    u[1:4] = rng.standard_normal((3,) + shape) * 0.3
    u[4] = rng.uniform(3.0, 5.0, shape)
    calls = []
    ref = fm.fused_step_ref

    def spy(*a, **k):
        calls.append(k.get("want_flux"))
        return ref(*a, **k)
    fm.fused_step_ref = spy
    try:
        un, phi = pu.step_with_flux(grid, torch.from_numpy(u), 1e-3)
    finally:
        fm.fused_step_ref = ref
    assert calls == [True]
    u64 = torch.from_numpy(u.astype(np.float64))
    grid64 = pu.UniformGrid(cfg=cfg, shape=shape, dx=1.0 / 16,
                            bc=pb.BoundarySpec.periodic(3))
    un64, phi64 = pu.step_with_flux(grid64, u64, 1e-3)
    np.testing.assert_allclose(phi.numpy(), phi64.numpy(), rtol=2e-5,
                               atol=2e-7)
    np.testing.assert_allclose(un.numpy(), un64.numpy(), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("nd", [2, 3])
def test_mc_tracer_step_matches_jax(nd):
    """``mc_tracer_step`` with the JAX run's categorical draws fed to the
    port (each tracer's move read off the JAX result): positions equal to
    rel 1e-14; the probabilities sum to 1 and the port's own draws keep
    every tracer in the box."""
    import jax

    from ramses_tpu.pm import tracers as jt

    from ramses_tpu_torch.pm import tracers as pt
    rng = np.random.default_rng(10 + nd)
    shape = (10,) * nd
    dx = 0.1
    rho = rng.uniform(0.5, 2.0, shape)
    flux = rng.standard_normal((nd,) + shape) * 0.2
    x = rng.uniform(0.0, 1.0, (500, nd))
    key = jax.random.PRNGKey(3)
    jnew = np.asarray(jt.mc_tracer_step(jnp.asarray(x), key,
                                        jnp.asarray(rho), jnp.asarray(flux),
                                        shape, dx))
    cell = np.clip((x / dx).astype(np.int64), 0, 9)
    jcell = np.clip(np.floor(jnew / dx + 1e-9).astype(np.int64), 0, 9)
    move = (jcell - cell + 5) % 10 - 5                   # -1, 0, +1
    assert set(np.abs(move).sum(1)) <= {0, 1}
    choice = np.zeros(len(x), dtype=np.int64)
    for d in range(nd):
        choice = np.where(move[:, d] == -1, 1 + 2 * d, choice)
        choice = np.where(move[:, d] == 1, 2 + 2 * d, choice)
    pnew = pt.mc_tracer_step(torch.from_numpy(x), torch.from_numpy(rho),
                             torch.from_numpy(flux), shape, dx,
                             choice=torch.from_numpy(choice))
    np.testing.assert_allclose(pnew.numpy(), jnew, rtol=1e-14, atol=1e-15)
    _, full = pt.jump_probs(torch.from_numpy(x), torch.from_numpy(rho),
                            torch.from_numpy(flux), shape, dx)
    np.testing.assert_allclose(full.sum(1).numpy(), 1.0, rtol=1e-14)
    assert (full.numpy()[np.arange(len(x)), choice] > 0).all()
    g = torch.Generator().manual_seed(0)
    own = pt.mc_tracer_step(torch.from_numpy(x), torch.from_numpy(rho),
                            torch.from_numpy(flux), shape, dx, generator=g)
    assert ((own >= 0) & (own < 1.0)).all()
    moved = (np.floor(own.numpy() / dx) != np.floor(x / dx)).any(1).mean()
    expect = float((1.0 - full[:, 0]).mean())
    assert abs(moved - expect) < 0.1
