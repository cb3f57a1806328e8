"""Non-cubic coarse grids (``&AMR_PARAMS nx, ny, nz``) on the port's hydro
hierarchy, on the CPU.

* the set-ups of ``tests/test_amr.py::TestNonCubicAmr`` (and a 3D Sedov
  on a (2, 1, 1) root) against the JAX package's ``AmrSim``, f64 within
  rtol 1e-10, with the device migrate on and off;
* inside the port: the equivalent cubic run (nx=ny=2, boxlen 0.5,
  levelmin 4 against one root at levelmin 5: the same cells), the
  snapshot/restart round trip, ``ShardedAmrSim`` on 8 CPU shards bitwise
  ``AmrSim`` (and its 8-domain dump restored);
* the JAX package's gate: each layer beyond plain hydro refused with
  "non-cubic", the MHD hierarchy refusing any non-cubic root.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.config import load_params as jload  # noqa: E402
from ramses_tpu.config import params_from_string as jparams  # noqa: E402

from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import load_params  # noqa: E402
from ramses_tpu_torch.config import params_from_string  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEDOV3D = os.path.join(ROOT, "namelists", "sedov3d.nml")
ORSZAG = os.path.join(ROOT, "namelists", "orszag2d.nml")
RTOL, ATOL = 1e-10, 1e-12

# tests/test_amr.py::TestNonCubicAmr.NML
NML = """
&RUN_PARAMS
hydro=.true.
/
&AMR_PARAMS
levelmin={lmin}
levelmax={lmax}
boxlen={boxlen}
nx={nx}
ny={ny}
/
&INIT_PARAMS
nregion=2
region_type(1)='square'
region_type(2)='square'
x_center={xc1},{xc2}
y_center={yc},{yc}
length_x={lx},{lx}
length_y=10.0,10.0
exp_region=10.0,10.0
d_region=1.0,0.125
p_region=1.0,0.1
/
&HYDRO_PARAMS
riemann='hllc'
/
&REFINE_PARAMS
err_grad_d=0.05
err_grad_p=0.05
/
&OUTPUT_PARAMS
tend=0.05
/
"""


def _mk(nx, ny, lmin, lmax, boxlen, parse=params_from_string):
    """TestNonCubicAmr._mk: the same physical set-up on [0,1]^2 whatever
    the root grid, in either package's parameters."""
    ext = nx * boxlen
    return parse(NML.format(lmin=lmin, lmax=lmax, boxlen=boxlen, nx=nx,
                            ny=ny, xc1=0.25 * ext / boxlen,
                            xc2=0.75 * ext / boxlen, yc=0.5 * ny,
                            lx=0.5 * ext / boxlen), ndim=2)


def _centre_interfaces(p):
    """test_matches_equivalent_cubic_run's regions: interfaces at x = 0.25
    and 0.75 of the unit extent."""
    p.init.x_center = [0.25, 0.75]
    p.init.y_center = [0.5, 0.5]
    p.init.length_x = [0.5, 0.5]


def _sedov3d(root, parse, load):
    p = load(SEDOV3D, ndim=3)
    p.amr.levelmin, p.amr.levelmax = 3, 5
    p.amr.nx, p.amr.ny, p.amr.nz = root
    p.amr.boxlen = 0.25
    p.refine.err_grad_d = p.refine.err_grad_p = 0.1
    # the blast off the corner: there the JAX package's restrict_upload
    # leaves the refined flat cell 0 stale (ROADMAP §C)
    for d, c in enumerate((p.init.x_center, p.init.y_center,
                           p.init.z_center)):
        c[1] = 0.5 * root[d] * p.amr.boxlen
    return p


def _same(jsim, psim, rtol=RTOL, atol=ATOL):
    assert psim.levels() == jsim.levels()
    assert psim.nstep == jsim.nstep
    assert psim.t == pytest.approx(jsim.t, rel=1e-12)
    assert psim.tree.root == jsim.tree.root
    ttd = 1 << psim.tree.ndim
    for l in psim.levels():
        assert np.array_equal(psim.tree.levels[l].keys,
                              jsim.tree.levels[l].keys), l
        n = psim.tree.noct(l) * ttd
        got, want = psim.u[l].numpy()[:n], np.asarray(jsim.u[l])[:n]
        if psim.tree.refined_mask(l)[0]:
            # ROADMAP C1: the JAX package's restrict_upload leaves a
            # refined flat cell 0 stale; the port holds its sons' mean
            got, want = got[1:], want[1:]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"level {l}")


@pytest.mark.parametrize("case", ["2x1", "1x3", "2x2", "3d-2x1x1"])
@pytest.mark.parametrize("device_regrid", [True, False])
def test_matches_jax(case, device_regrid):
    if case.startswith("3d"):
        jp = _sedov3d((2, 1, 1), jparams, jload)
        pp = _sedov3d((2, 1, 1), params_from_string, load_params)
        nsteps, tend = 3, 1.0
    else:
        nx, ny = int(case[0]), int(case[2])
        boxlen = 0.5 if case == "2x2" else 1.0
        jp = _mk(nx, ny, 4, 5, boxlen, jparams)
        pp = _mk(nx, ny, 4, 5, boxlen)
        if case == "2x2":
            for p in (jp, pp):
                _centre_interfaces(p)
        nsteps, tend = 4, 0.02
    jp.amr.device_regrid = pp.amr.device_regrid = device_regrid
    jsim = JAmrSim(jp, dtype=jnp.float64)
    psim = AmrSim(pp, dtype=torch.float64, device="cpu")
    assert psim.tree.root == jsim.root
    assert psim._device_regrid_ok() == device_regrid
    _same(jsim, psim)
    jsim.evolve(tend, nstepmax=nsteps)
    psim.evolve(tend, nstepmax=nsteps)
    assert len(psim.levels()) >= 2
    _same(jsim, psim)
    np.testing.assert_allclose(
        [psim.totals()["mass"]], [jsim.totals()[0]], rtol=1e-12)


def test_matches_equivalent_cubic_run():
    # nx=ny=2, boxlen=0.5, lmin=4  ==  nx=ny=1, boxlen=1, lmin=5: the same
    # cells (dx=1/32 on [0,1]^2) and the same physics
    pa = _mk(2, 2, 4, 5, 0.5)
    pb = _mk(1, 1, 5, 6, 1.0)
    for p in (pa, pb):
        _centre_interfaces(p)
    sa = AmrSim(pa, dtype=torch.float64, device="cpu")
    sb = AmrSim(pb, dtype=torch.float64, device="cpu")
    assert sa.tree.cell_dims(4) == (32, 32)
    ka = set(map(tuple, sa.tree.levels[5].og))
    kb = set(map(tuple, sb.tree.levels[6].og))
    assert ka == kb and ka
    sa.evolve(0.02, nstepmax=8)
    sb.evolve(0.02, nstepmax=8)
    assert sa.nstep == sb.nstep
    ca, ua = sa.leaf_sample(4)
    cb, ub = sb.leaf_sample(5)
    oa, ob = np.lexsort(ca.T), np.lexsort(cb.T)
    assert np.allclose(ca[oa], cb[ob], atol=1e-12)
    np.testing.assert_allclose(ua[oa], ub[ob], rtol=1e-10, atol=1e-12)
    assert abs(sa.totals()["mass"] - sb.totals()["mass"]) < 1e-12


def test_snapshot_restart_roundtrip(tmp_path):
    p = _mk(2, 1, 4, 5, 1.0)
    sim = AmrSim(p, dtype=torch.float64, device="cpu")
    assert sim.tree.has(5)
    sim.evolve(0.02, nstepmax=4)
    out = sim.dump(iout=1, base_dir=str(tmp_path))
    sim2 = AmrSim.from_snapshot(_mk(2, 1, 4, 5, 1.0), out,
                                dtype=torch.float64, device="cpu")
    assert sim2.tree.root == (2, 1)
    assert sim2.t == sim.t and sim2.nstep == sim.nstep
    for l in sim.levels():
        assert np.array_equal(sim.tree.levels[l].og, sim2.tree.levels[l].og)
        nc = sim.maps[l].noct * 4
        np.testing.assert_allclose(sim2.u[l].numpy()[:nc],
                                   sim.u[l].numpy()[:nc], rtol=1e-12,
                                   atol=1e-14)
    sim.evolve(0.04, nstepmax=sim.nstep + 3)
    sim2.evolve(0.04, nstepmax=sim2.nstep + 3)
    for l in sim.levels():
        nc = sim.maps[l].noct * 4
        np.testing.assert_allclose(sim2.u[l].numpy()[:nc],
                                   sim.u[l].numpy()[:nc], rtol=1e-10,
                                   atol=1e-12)


def test_sharded_matches_single_device(tmp_path):
    from ramses_tpu_torch.parallel.amr_sharded import ShardedAmrSim
    from ramses_tpu_torch.parallel.mesh import ShardMesh
    ss = ShardedAmrSim(_mk(2, 1, 4, 5, 1.0), devices=ShardMesh(["cpu"] * 8),
                       dtype=torch.float64)
    s1 = AmrSim(_mk(2, 1, 4, 5, 1.0), dtype=torch.float64, device="cpu")
    # a non-cubic level keeps the single-device sweep
    assert all(ss._slab_spec(l) is None for l in ss.levels()
               if ss.maps[l].complete)
    ss.evolve(0.02, nstepmax=4)
    s1.evolve(0.02, nstepmax=4)
    assert ss.nstep == s1.nstep >= 2
    for l in s1.levels():
        assert np.array_equal(ss.tree.levels[l].keys, s1.tree.levels[l].keys)
        nc = s1.maps[l].noct * 4
        assert torch.equal(ss.u[l][:nc], s1.u[l][:nc]), l
    # one file set a shard; the snapshot's coarse-grid header stays
    # (1, 1, 1) for a hierarchy in both packages, so the multi-domain
    # refusal of io/snapshot.dump_all does not apply: it restores
    out = ss.dump(iout=1, base_dir=str(tmp_path))
    back = AmrSim.from_snapshot(_mk(2, 1, 4, 5, 1.0), out,
                                dtype=torch.float64, device="cpu")
    for l in s1.levels():
        assert np.array_equal(back.tree.levels[l].og, ss.tree.levels[l].og)
        nc = s1.maps[l].noct * 4
        np.testing.assert_allclose(back.u[l].numpy()[:nc],
                                   ss.u[l].numpy()[:nc], rtol=1e-12,
                                   atol=1e-14)


@pytest.mark.parametrize("layer", ["pic", "tracer", "cosmo", "star formation",
                                   "sinks"])
def test_gated_layers_refuse(layer):
    p = load_params(SEDOV3D, ndim=3)
    p.amr.levelmin, p.amr.levelmax = 4, 5
    p.amr.ny = 3
    if layer in ("pic", "tracer", "cosmo"):
        setattr(p.run, layer, True)
    else:
        key = "sf_params" if layer == "star formation" else "sink_params"
        p.raw = dict(p.raw or {}, **{key: {"n_star": 0.1}})
    with pytest.raises(NotImplementedError,
                       match=f"non-cubic coarse grid \\(1, 3, 1\\).*"
                             f"plain hydro hierarchy only.*{layer}"):
        AmrSim(p, device="cpu")


def test_jax_gate_case_refused():
    # tests/test_io.py::test_noncubic_box_amr_gates_unsupported_physics
    p = load_params(SEDOV3D, ndim=3)
    p.amr.levelmin, p.amr.levelmax = 4, 5
    p.amr.ny = 3
    p.run.pic = True
    with pytest.raises(NotImplementedError, match="non-cubic"):
        AmrSim(p, device="cpu")


def test_mhd_hierarchy_refuses_noncubic_roots():
    from ramses_tpu_torch.mhd.amr import MhdAmrSim
    p = load_params(ORSZAG, ndim=2)
    p.amr.levelmin, p.amr.levelmax = 4, 5
    p.amr.nx = 2
    with pytest.raises(NotImplementedError,
                       match="non-cubic.*MhdAmrSim solver family"):
        MhdAmrSim(p, dtype=torch.float64, device="cpu")
