"""The port's snapshot writer and reader (``ramses_tpu_torch.io``) against
the JAX package's ``ramses_tpu.io``, on the CPU.

* byte identity: given the same f64 state (the JAX run's carried into the
  port through ``convert``), every file of the port's ``output_00001/``
  has the JAX package's sha256, and the manifests' ``files`` and ``meta``
  are equal: uniform tube1d (1D), sedov2d (2D), sedov3d at levelmin 4 and
  pointmass with self-gravity (the grav file), a hydro ``AmrSim``
  (levelmin 3, levelmax 5) with gravity and with MC tracers, the uniform
  and the hierarchy MHD drivers, and ``ncpu=8`` as ``ShardedAmrSim``
  writes it;
* the ports of ``tests/test_io.py``'s checks that need no unported layer:
  Fortran records, ``leaf_cells``, the reference oracle's byte-offset
  walk, primitive hydro columns, and the uniform and AMR round trips.

The case builders here serve ``tests/test_torch_restart.py`` too.
"""

import hashlib
import io
import json
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.config import load_params as jload  # noqa: E402
from ramses_tpu.config import params_from_string as jparams  # noqa: E402
from ramses_tpu.driver import Simulation as JSimulation  # noqa: E402
from ramses_tpu.mhd.amr import MhdAmrSim as JMhdAmrSim  # noqa: E402
from ramses_tpu.mhd.driver import MhdSimulation as JMhdSimulation  # noqa: E402,E501

from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import load_params as pload  # noqa: E402
from ramses_tpu_torch.config import params_from_string as pparams  # noqa: E402,E501
from ramses_tpu_torch.convert import (amr_state_from,  # noqa: E402
                                      mhd_amr_state_from, mhd_state_from)
from ramses_tpu_torch.driver import Simulation  # noqa: E402
from ramses_tpu_torch.io import fortran as frt  # noqa: E402
from ramses_tpu_torch.io import reader as rdr  # noqa: E402
from ramses_tpu_torch.io import snapshot as snapmod  # noqa: E402
from ramses_tpu_torch.mhd.amr import MhdAmrSim  # noqa: E402
from ramses_tpu_torch.mhd.driver import MhdSimulation  # noqa: E402
from ramses_tpu_torch.parallel.amr_sharded import ShardedAmrSim  # noqa: E402
from ramses_tpu_torch.parallel.mesh import ShardMesh  # noqa: E402
from ramses_tpu_torch.resilience import checkpoint as ckpt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NMLS = os.path.join(ROOT, "namelists")

# a Sod tube across x (tests/test_io.py's _sod_params), periodic, with the
# run keys of each case added to &RUN_PARAMS
SOD2D = """
&RUN_PARAMS
hydro=.true.
nremap=1
{run}
/
&AMR_PARAMS
levelmin={lmin}
levelmax={lmax}
boxlen=1.0
/
&INIT_PARAMS
nregion=2
region_type='square','square'
x_center=0.25,0.75
y_center=0.5,0.5
length_x=0.5,0.5
length_y=10.0,10.0
exp_region=10.0,10.0
d_region=1.0,0.125
u_region=0.3,0.0
p_region=1.0,0.1
/
&OUTPUT_PARAMS
noutput=1
tout=0.1
tend=0.1
/
&HYDRO_PARAMS
gamma=1.4
courant_factor=0.8
riemann='hllc'
slope_type=1
/
&REFINE_PARAMS
err_grad_d=0.05
err_grad_p=0.05
/
"""

# the magnetised blob of tests/test_torch_mhd_amr.py in 2D
MHD_BLOB = """
&RUN_PARAMS
hydro=.true.
nremap=1
/
&AMR_PARAMS
levelmin=4
levelmax=5
boxlen=1.0
/
&INIT_PARAMS
nregion=2
region_type(1)='square'
region_type(2)='square'
x_center=0.5,0.5
y_center=0.5,0.5
length_x=10.0,0.4
length_y=10.0,0.4
exp_region=10.0,2.0
d_region=1.0,4.0
p_region=1.0,3.0
u_region=0.0,0.6
v_region=0.0,-0.4
A_region=0.5,0.5
B_region=0.3,0.3
C_region=0.2,0.2
/
&HYDRO_PARAMS
gamma=1.6666667
courant_factor=0.8
riemann='hlld'
slope_type=1
/
&REFINE_PARAMS
err_grad_d=0.05
err_grad_p=0.05
/
"""


def sod_text(lmin=3, lmax=5, run=""):
    return SOD2D.format(lmin=lmin, lmax=lmax, run=run)


def _uniform_params(load, name, ndim, level):
    p = load(os.path.join(NMLS, name), ndim=ndim)
    p.amr.levelmin = p.amr.levelmax = level
    p.run.nstepmax = 1000000
    return p


UNIFORM = {            # name: (namelist, ndim, level, steps)
    "tube1d": ("tube1d.nml", 1, 6, 6),
    "sedov2d": ("sedov2d.nml", 2, 4, 5),
    "sedov3d": ("sedov3d.nml", 3, 4, 3),
    "pointmass": ("pointmass.nml", 3, 4, 2),
}


def build_uniform(name, steps=None):
    """(JAX sim after a few f64 steps, the port's sim on its state)."""
    nml, ndim, level, n = UNIFORM[name]
    jp = _uniform_params(jload, nml, ndim, level)
    jp.run.nstepmax = n if steps is None else steps
    jsim = JSimulation(jp, dtype=jnp.float64)
    jsim.output_times = [1e9]
    jsim.evolve()
    pp = _uniform_params(pload, nml, ndim, level)
    psim = Simulation.from_state(pp, np.asarray(jsim.state.u), jsim.state.t,
                                 jsim.state.nstep, device="cpu")
    if jsim.state.f is not None:
        # the force the JAX run carries (its last solve), not a new one
        psim.state.f = torch.from_numpy(np.array(jsim.state.f))
    return jsim, psim


def _carried(jsim, state_from=amr_state_from):
    """A JAX hierarchy's state for the port's ``from_state``, with its
    cached next dt, which the amr file records as ``dtnew``."""
    return dict(state_from(jsim), dt_next=float(jsim._dt_cache))


def build_amr(kind):
    """(JAX AmrSim after 2 coarse steps, the port's on its state):
    ``kind`` "gravity" (self-gravity) or "tracers" (MC gas tracers)."""
    run = {"gravity": "poisson=.true.",
           "tracers": "tracer=.true.\ntracer_per_cell=1.0"}[kind]
    jsim = JAmrSim(jparams(sod_text(run=run), ndim=2), dtype=jnp.float64)
    for _ in range(2):
        jsim.evolve(1.0, nstepmax=jsim.nstep + 1)
    psim = AmrSim.from_state(pparams(sod_text(run=run), ndim=2),
                             **_carried(jsim), device="cpu")
    return jsim, psim


def build_sharded():
    """(JAX AmrSim after 2 coarse steps, the port's ShardedAmrSim on 8
    CPU shards on its state)."""
    jsim = JAmrSim(jparams(sod_text(), ndim=2), dtype=jnp.float64)
    jsim.evolve(1.0, nstepmax=2)
    psim = ShardedAmrSim.from_state(pparams(sod_text(), ndim=2),
                                    devices=ShardMesh(["cpu"] * 8),
                                    **_carried(jsim))
    return jsim, psim


def build_mhd():
    """(JAX uniform Orszag-Tang at 32² after 3 f64 steps, the port's)."""
    def params(load):
        p = load(os.path.join(NMLS, "orszag2d.nml"), ndim=2)
        p.amr.levelmin = p.amr.levelmax = 5
        return p
    jsim = JMhdSimulation(params(jload), dtype=jnp.float64)
    jsim.evolve(nstepmax=3)
    psim = MhdSimulation.from_state(params(pload), **mhd_state_from(jsim),
                                    device="cpu")
    return jsim, psim


def build_mhd_amr():
    """(JAX MhdAmrSim on the magnetised blob after a coarse step, the
    port's on its state)."""
    jsim = JMhdAmrSim(jparams(MHD_BLOB, ndim=2), dtype=jnp.float64)
    jsim.evolve(1.0, nstepmax=1)
    psim = MhdAmrSim.from_state(pparams(MHD_BLOB, ndim=2),
                                **_carried(jsim, mhd_amr_state_from),
                                device="cpu")
    return jsim, psim


BUILD = {**{f"uniform_{k}": (lambda k=k: build_uniform(k)) for k in UNIFORM},
         "amr_gravity": lambda: build_amr("gravity"),
         "amr_tracers": lambda: build_amr("tracers"),
         "sharded_ncpu8": build_sharded,
         "mhd": build_mhd,
         "mhd_amr": build_mhd_amr}


def dump_both(jsim, psim, tmp_path, ncpu=None):
    """Each package's ``output_00001/`` of its sim, as its CLI calls dump
    (the namelist copied in too); the JAX sim writes ``ncpu`` domains when
    given (the port's ShardedAmrSim writes one a shard)."""
    nml = tmp_path / "run.nml"
    nml.write_text("&RUN_PARAMS\n/\n")
    jkw = {} if ncpu is None else {"ncpu": ncpu}
    a = jsim.dump(1, str(tmp_path / "jax"), namelist_path=str(nml), **jkw)
    b = psim.dump(1, str(tmp_path / "port"), namelist_path=str(nml))
    return a, b


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def assert_same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        if n != ckpt.MANIFEST_NAME:
            assert _sha(os.path.join(a, n)) == _sha(os.path.join(b, n)), n
    ma, mb = (json.load(open(os.path.join(d, ckpt.MANIFEST_NAME)))
              for d in (a, b))
    assert ma["files"] == mb["files"]
    assert ma["meta"] == mb["meta"]


@pytest.mark.parametrize("case", sorted(BUILD))
def test_same_bytes_as_jax(case, tmp_path):
    jsim, psim = BUILD[case]()
    a, b = dump_both(jsim, psim, tmp_path,
                     ncpu=8 if case == "sharded_ncpu8" else None)
    for d in (a, b):
        ok, reason = ckpt.validate_checkpoint(d)
        assert ok, reason
    assert_same_files(a, b)
    names = os.listdir(b)
    assert ("grav_00001.out00001" in names) == (case == "uniform_pointmass")
    assert ("part_00001.out00001" in names) == (case == "amr_tracers")
    if case == "sharded_ncpu8":
        assert sum(n.startswith("hydro_00001.out") for n in names) == 8


# ---------------------------------------------------------------------------
# ports of tests/test_io.py
# ---------------------------------------------------------------------------

def test_fortran_record_roundtrip():
    buf = io.BytesIO()
    a = np.arange(7, dtype=np.int32)
    b = np.linspace(0, 1, 5)
    frt.write_record(buf, a)
    frt.write_record(buf, b)
    frt.write_ints(buf, 3, 4, 5)
    frt.write_str(buf, "hilbert", 128)
    buf.seek(0)
    assert np.array_equal(frt.read_ints(buf), a)
    assert np.allclose(frt.read_reals(buf), b)
    assert np.array_equal(frt.read_ints(buf), [3, 4, 5])
    assert frt.read_str(buf) == "hilbert"
    buf.seek(0)
    assert frt.skip_record(buf) == 28
    with pytest.raises(EOFError):
        for _ in range(5):
            frt.read_record(buf)


def _sod_uniform(ndim=2, lmin=4, steps=0):
    p = pparams(sod_text(lmin=lmin, lmax=lmin), ndim=ndim)
    sim = Simulation(p, dtype=torch.float64, device="cpu")
    if steps:
        sim.params.run.nstepmax = steps
        sim.evolve()
    return sim


def test_uniform_dump_and_leaf_cells(tmp_path):
    sim = _sod_uniform(steps=4)
    out = sim.dump(iout=1, base_dir=str(tmp_path))
    s = rdr.load_snapshot(out)
    assert s["info"]["ncpu"] == 1 and s["info"]["ndim"] == 2
    cells = rdr.leaf_cells(s)
    n = 16
    assert len(cells["density"]) == n * n
    # mass conservation: sum rho*dx^2 equals the device total
    mass_snap = np.sum(cells["density"] * cells["dx"] ** 2)
    assert np.isclose(mass_snap, float(sim.totals()["mass"]), rtol=1e-12)
    xs = np.sort(np.unique(np.round(cells["x"], 12)))
    assert np.allclose(xs, (np.arange(n) + 0.5) / n)


def test_scaffold_hierarchy_complete(tmp_path):
    """Every level 1..levelmin is present, fully refined below levelmin."""
    sim = _sod_uniform(lmin=3)
    out = sim.dump(iout=1, base_dir=str(tmp_path))
    amr = rdr.read_amr_file(os.path.join(out, "amr_00001.out00001"))
    for lvl in range(1, 4):
        assert len(amr.levels[lvl]["ind_grid"]) == 4 ** (lvl - 1)
    assert np.all(amr.levels[1]["son"] > 0)
    assert np.all(amr.levels[2]["son"] > 0)
    assert np.all(amr.levels[3]["son"] == 0)
    assert set(amr.levels[1]["son"].ravel()) == \
        set(amr.levels[2]["ind_grid"])


def _visu_style_walk(amr_path, ncpu, levelmax, ndim):
    """The reference oracle's byte-offset arithmetic
    (``tests/visu/visu_ramses.py:144-310``, as ``tests/test_io.py`` walks
    it) for one cpu: (nx, noutput, ngridlevel, xg and son by level)."""
    with open(amr_path, "rb") as f:
        content = f.read()

    def offset(ninteg, nlines, nfloat, nstrin=0, nquadr=0):
        return 4 * ninteg + 8 * (nlines + nfloat) + nstrin + nquadr * 16

    o = offset(2, 2, 0) + 4
    nx, ny, nz = struct.unpack("3i", content[o:o + 12])
    ncoarse = nx * ny * nz
    o = offset(7, 5, 0) + 4
    nboundary = struct.unpack("i", content[o:o + 4])[0]
    o = offset(9, 8, 1) + 4
    noutput = struct.unpack("i", content[o:o + 4])[0]
    ninteg = 14 + 2 * ncpu * levelmax
    nfloat = 18 + 2 * noutput + 2 * levelmax
    o = offset(ninteg, 21, nfloat) + 4
    ngridlevel = np.asarray(struct.unpack(
        "%ii" % (ncpu * levelmax),
        content[o:o + 4 * ncpu * levelmax])).reshape(levelmax, ncpu).T
    ninteg = 14 + 3 * ncpu * levelmax + 10 * levelmax + 5
    nlines = 21 + 2 + 3 * min(1, nboundary) + 1 + 1
    o = offset(ninteg, nlines, nfloat, nstrin=128)
    key_size = struct.unpack("i", content[o:o + 4])[0]
    ninteg1 = 14 + 3 * ncpu * levelmax + 10 * levelmax + 5 + 3 * ncoarse
    nfloat1 = 18 + 2 * noutput + 2 * levelmax
    nlines1 = 21 + 2 + 3 * min(1, nboundary) + 1 + 1 + 1 + 3
    nstrin1 = 128 + key_size
    twotondim = 2 ** ndim
    xg_by_level, son_by_level = {}, {}
    for ilevel in range(levelmax):
        ninteg_a, nfloat_a = ninteg1, nfloat1
        nlines_a, nstrin_a = nlines1, nstrin1
        for j in range(nboundary + ncpu):
            ncache = ngridlevel[j, ilevel]
            if ncache > 0:
                ninteg = ninteg_a + ncache * 3
                nlines = nlines_a + 3
                xg = np.zeros((ncache, ndim))
                for n in range(ndim):
                    o = offset(ninteg, nlines,
                               nfloat_a + n * (ncache + 1), nstrin_a) + 4
                    xg[:, n] = struct.unpack(
                        "%id" % ncache, content[o:o + 8 * ncache])
                ninteg = ninteg_a + ncache * (4 + 2 * ndim)
                nfloat = nfloat_a + ncache * ndim
                nlines = nlines_a + 4 + 3 * ndim
                son = np.zeros((ncache, twotondim), dtype=np.int32)
                for ind in range(twotondim):
                    o = offset(ninteg + ind * ncache, nlines + ind,
                               nfloat, nstrin_a) + 4
                    son[:, ind] = struct.unpack(
                        "%ii" % ncache, content[o:o + 4 * ncache])
                xg_by_level[ilevel + 1] = xg
                son_by_level[ilevel + 1] = son
                ninteg_a += ncache * (4 + 3 * twotondim + 2 * ndim)
                nfloat_a += ncache * ndim
                nlines_a += 4 + 3 * twotondim + 3 * ndim
        ninteg1, nfloat1 = ninteg_a, nfloat_a
        nlines1, nstrin1 = nlines_a, nstrin_a
    return nx, noutput, ngridlevel, xg_by_level, son_by_level


def test_oracle_byte_offsets(tmp_path):
    """The amr file parses identically through the reference oracle's
    byte-offset arithmetic and through the record reader (3D scaffold and
    an AMR hierarchy)."""
    p = pload(os.path.join(NMLS, "sedov3d.nml"), ndim=3)
    p.amr.levelmin = p.amr.levelmax = 3
    paths = [Simulation(p, dtype=torch.float64, device="cpu")
             .dump(1, str(tmp_path / "uni"))]
    amr = AmrSim(pparams(sod_text(), ndim=2), dtype=torch.float64,
                 device="cpu")
    paths.append(amr.dump(1, str(tmp_path / "amr")))
    for out in paths:
        path = os.path.join(out, "amr_00001.out00001")
        ours = rdr.read_amr_file(path)
        h = ours.header
        nx, noutput, ngridlevel, xg_lv, son_lv = _visu_style_walk(
            path, h["ncpu"], h["nlevelmax"], h["ndim"])
        assert nx == h["nx"] and noutput == h["noutput"]
        assert np.array_equal(ngridlevel, h["numbl"])
        for lvl, lev in ours.levels.items():
            assert np.allclose(xg_lv[lvl], lev["xg"])
            assert np.array_equal(son_lv[lvl], lev["son"])


def test_hydro_file_primitive_vars(tmp_path):
    sim = _sod_uniform()
    out = sim.dump(iout=1, base_dir=str(tmp_path))
    s = rdr.load_snapshot(out)
    cells = rdr.leaf_cells(s)
    assert s["var_names"] == ["density", "velocity_x", "velocity_y",
                              "pressure"]
    left = cells["x"] < 0.5
    assert np.allclose(cells["density"][left], 1.0)
    assert np.allclose(cells["density"][~left], 0.125)
    assert np.allclose(cells["velocity_x"][left], 0.3)
    assert np.allclose(cells["pressure"][left], 1.0)
    assert np.allclose(cells["pressure"][~left], 0.1)


def test_amr_dump_and_leaf_cells(tmp_path):
    sim = AmrSim(pparams(sod_text(), ndim=2), dtype=torch.float64,
                 device="cpu")
    sim.evolve(0.02)
    out = sim.dump(iout=1, base_dir=str(tmp_path))
    cells = rdr.leaf_cells(rdr.load_snapshot(out))
    assert len(cells["density"]) == sim.ncell_leaf()
    assert np.isclose(np.sum(cells["dx"] ** 2), 1.0, rtol=1e-12)
    mass = np.sum(cells["density"] * cells["dx"] ** 2)
    assert np.isclose(mass, sim.totals()["mass"], rtol=1e-12)
    assert cells["level"].max() == 5 and cells["level"].min() >= 3


def test_restart_uniform_roundtrip(tmp_path):
    sim = _sod_uniform(steps=4)
    out = sim.dump(iout=1, base_dir=str(tmp_path))
    sim2 = Simulation.from_snapshot(pparams(sod_text(lmin=4, lmax=4),
                                            ndim=2), out,
                                    dtype=torch.float64, device="cpu")
    assert sim2.t == sim.t and sim2.nstep == sim.nstep
    np.testing.assert_allclose(sim2.state.u.numpy(), sim.state.u.numpy(),
                               rtol=1e-13, atol=1e-13)
    assert sim2.state.iout == 2
    sim2.output_times = [0.08]
    sim2.state.iout = 1
    sim2.evolve()
    assert sim2.t > sim.t


def test_restart_amr_roundtrip(tmp_path):
    sim = AmrSim(pparams(sod_text(), ndim=2), dtype=torch.float64,
                 device="cpu")
    sim.evolve(0.02)
    out = sim.dump(iout=1, base_dir=str(tmp_path))
    sim2 = AmrSim.from_snapshot(pparams(sod_text(), ndim=2), out,
                                dtype=torch.float64, device="cpu")
    assert sim2.t == sim.t and sim2.nstep == sim.nstep
    assert sim2.dt_old == sim.dt_old
    assert float(sim2._dt_cache) == float(sim._dt_cache)
    for lvl in sim.levels():
        assert sim2.tree.noct(lvl) == sim.tree.noct(lvl)
        nc = sim.tree.noct(lvl) * 4
        np.testing.assert_allclose(sim2.u[lvl].numpy()[:nc],
                                   sim.u[lvl].numpy()[:nc],
                                   rtol=1e-13, atol=1e-13)
    sim2.evolve(0.03)
    assert sim2.t > sim.t


def test_mhd_faces_round_trip_bitwise(tmp_path):
    """The uniform MHD driver's faces come back bitwise from the left
    columns, f32 and f64; the centred state within the f64 round trip."""
    for dtype in (torch.float64, torch.float32):
        p = pload(os.path.join(NMLS, "orszag2d.nml"), ndim=2)
        p.amr.levelmin = p.amr.levelmax = 5
        psim = MhdSimulation(p, dtype=dtype, device="cpu")
        psim.evolve(nstepmax=2)
        out = psim.dump(1, str(tmp_path / str(dtype)))
        back = MhdSimulation.from_snapshot(psim.params, out, dtype=dtype,
                                           device="cpu")
        assert torch.equal(back.bf, psim.bf)
        assert back.t == psim.t and back.nstep == psim.nstep
        if dtype == torch.float64:
            np.testing.assert_allclose(back.u.numpy(), psim.u.numpy(),
                                       rtol=1e-13, atol=1e-13)


def test_host64_is_exact():
    x = torch.tensor([1.0 / 3.0, 1e-30, -2.5e7], dtype=torch.float32)
    h = snapmod.host64(x)
    assert h.dtype == np.float64
    assert np.array_equal(h, np.asarray(x.numpy(), dtype=np.float64))
    assert np.array_equal(snapmod.host64(np.arange(3)), [0.0, 1.0, 2.0])
