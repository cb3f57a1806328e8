"""The port's AMR hierarchy (``ramses_tpu_torch.amr``) against the JAX
package's, on the CPU.

* maps and trees: integer arrays equal to the JAX package's on the
  ``tests/test_oct_blocking.py`` Sedov tree (levelmin 4, levelmax 5);
* ``amr/kernels``: each sweep against the JAX package's XLA formulation in
  f64 at rtol 1e-10 / atol 1e-14 (the roundoff of a different summation
  order, far below any physics);
* the hierarchy: 2 coarse steps, a regrid and 1 step (and a ``nremap=4``
  run through ``step_chunk``) from the same namelist, in f64, with
  ``oct_blocking`` on and off: equal trees, rows within rtol 1e-10;
* in f32, the same run through the kernels' plain versions (K1, K3, K2 on
  CPU tensors) within f32 roundoff of the JAX package's XLA path, and a
  bitwise replay;
* the corner blast, where the JAX package's ``restrict_upload`` leaves
  flat cell 0 stale (ROADMAP §C): every refined cell is its sons' mean;
* the CLI on a small AMR namelist.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr import flag as jflag  # noqa: E402
from ramses_tpu.amr import kernels as JK  # noqa: E402
from ramses_tpu.amr import maps as jmaps  # noqa: E402
from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.config import params_from_string as jparams  # noqa: E402

from ramses_tpu_torch.amr import flag as pflag  # noqa: E402
from ramses_tpu_torch.amr import kernels as PK  # noqa: E402
from ramses_tpu_torch.amr import maps as pmaps  # noqa: E402
from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.amr.tree import Octree  # noqa: E402
from ramses_tpu_torch.config import load_params  # noqa: E402
from ramses_tpu_torch.config import params_from_string as pparams  # noqa: E402
from ramses_tpu_torch.convert import amr_state_from  # noqa: E402
from ramses_tpu_torch.convert import hydro_static_from  # noqa: E402
from ramses_tpu_torch.grid import boundary as bmod  # noqa: E402
from ramses_tpu_torch.hydro import oct_muscl as om  # noqa: E402
from ramses_tpu_torch.hydro.core import HydroStatic  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NML = os.path.join(ROOT, "namelists", "sedov3d.nml")
RTOL, ATOL = 1e-10, 1e-14

# the centre-blast setup of tests/test_oct_blocking.py
SEDOV3D = """
&RUN_PARAMS
hydro=.true.
nremap={nremap}
/
&AMR_PARAMS
levelmin=4
levelmax=5
boxlen=1.0
oct_blocking={blk}
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


def _text(blk=".true.", nremap=0):
    return SEDOV3D.format(blk=blk, nremap=nremap)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), rtol=rtol, atol=atol)


def _script(sim, regrid=True):
    """2 coarse steps, a regrid, 1 step."""
    for _ in range(2):
        sim.step_coarse(sim.coarse_dt())
    if regrid:
        sim.regrid()
        sim.step_coarse(sim.coarse_dt())
    return sim


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's runs, f64: the initial blocked sim (its tree and
    state feed the map and kernel tests) and the scripted run per
    ``oct_blocking``."""
    init = JAmrSim(jparams(_text(), ndim=3), dtype=jnp.float64)
    tree0 = init.tree
    state0 = {l: np.asarray(init.u[l]) for l in init.levels()}
    runs = {blk: _script(JAmrSim(jparams(_text(blk), ndim=3),
                                 dtype=jnp.float64))
            for blk in (".true.", ".false.")}
    return init, tree0, state0, runs


def _port_tree(jtree):
    t = Octree(jtree.ndim, jtree.levelmin, jtree.levelmax)
    for l, lev in jtree.levels.items():
        t.set_level(l, lev.og)
    return t


# ---------------------------------------------------------------------------
# maps
# ---------------------------------------------------------------------------

LEVEL_FIELDS = ("stencil_src", "vsgn", "ok_ref", "interp_cell", "interp_nb",
                "interp_sgn", "corr_idx", "ref_cell", "son_oct", "valid_oct",
                "perm", "inv_perm", "ok_dense", "ok_flat")
BLOCK_FIELDS = ("tile_src", "tile_vsgn", "tile_ok", "interp_cell",
                "interp_nb", "interp_sgn", "cell_tile", "cell_slot",
                "oct_tile", "oct_slot", "tile_key", "slot_ckey")


def _same_fields(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.array_equal(np.asarray(x), np.asarray(y)), f


@pytest.mark.parametrize("lvl", [4, 5])
def test_level_and_block_maps_match(jax_runs, lvl):
    jsim = jax_runs[0]
    jt = jsim.tree
    pt = _port_tree(jt)
    kinds = jsim.bc_kinds
    pad = jsim.maps[lvl].noct_pad
    jm = jmaps.build_level_maps(jt, lvl, kinds, noct_pad=pad)
    pm = pmaps.build_level_maps(pt, lvl, kinds, noct_pad=pad)
    assert (jm.noct, jm.noct_pad, jm.ni, jm.nref, jm.complete) == \
        (pm.noct, pm.noct_pad, pm.ni, pm.nref, pm.complete)
    _same_fields(jm, pm, LEVEL_FIELDS)
    _same_fields(jmaps.refresh_restriction(jm, jt),
                 pmaps.refresh_restriction(pm, pt), LEVEL_FIELDS)
    if not jm.complete:
        jb = jmaps.build_block_maps(jt, lvl, kinds, noct_pad=pad)
        pb = pmaps.build_block_maps(pt, lvl, kinds, noct_pad=pad)
        assert (jb.ntile, jb.ntile_pad, jb.ni) == (pb.ntile, pb.ntile_pad,
                                                   pb.ni)
        _same_fields(jb, pb, BLOCK_FIELDS)


def test_prolong_maps_and_new_tree_match(jax_runs):
    jsim, tree0, _, runs = jax_runs
    jnew = runs[".true."].tree              # after the scripted regrid
    for l in range(tree0.levelmin + 1, tree0.levelmax + 1):
        if not jnew.has(l):
            continue
        want = jmaps.build_prolong_maps(jnew, tree0, l, jsim.bc_kinds)
        got = pmaps.build_prolong_maps(_port_tree(jnew), _port_tree(tree0),
                                       l, jsim.bc_kinds)
        for a, b in zip(want, got):
            assert np.array_equal(a, b)
    rng = np.random.default_rng(7)
    crit = {l: rng.random(tree0.noct(l) * 8) < 0.02
            for l in tree0.levels}
    jt = jflag.compute_new_tree(tree0, crit, jsim.bc_kinds, jsim.params)
    pt = pflag.compute_new_tree(_port_tree(tree0), crit, jsim.bc_kinds,
                                pparams(_text(), ndim=3))
    assert sorted(jt.levels) == sorted(pt.levels)
    for l in jt.levels:
        assert np.array_equal(jt.levels[l].keys, pt.levels[l].keys), l


# ---------------------------------------------------------------------------
# amr/kernels against the XLA formulation, f64
# ---------------------------------------------------------------------------

DT = 1.5e-3


@pytest.fixture(scope="module")
def level5(jax_runs):
    """Inputs of the partial level 5 from the JAX package's initial sim."""
    jsim, _, state0, _ = jax_runs
    d = jsim.dev[5]
    interp = JK.interp_cells(jnp.asarray(state0[4]), d["interp_cell"],
                             d["interp_nb"], d["interp_sgn"], jsim.cfg)
    binterp = JK.interp_cells(jnp.asarray(state0[4]), d["b_interp_cell"],
                              d["b_interp_nb"], d["b_interp_sgn"], jsim.cfg)
    return jsim, d, state0, interp, binterp


def test_interp_cells_matches(level5):
    jsim, d, state0, interp, binterp = level5
    for itype in (0, 1, 2, 3):
        want = JK.interp_cells(jnp.asarray(state0[4]), d["interp_cell"],
                               d["interp_nb"], d["interp_sgn"], jsim.cfg,
                               itype=itype)
        got = PK.interp_cells(_t(state0[4]), _t(d["interp_cell"]),
                              _t(d["interp_nb"]), _t(d["interp_sgn"]),
                              hydro_static_from(jsim.cfg), itype=itype)
        _close(got, want)


def test_level_sweep_matches(level5):
    jsim, d, state0, interp, _ = level5
    want = JK.level_sweep(jnp.asarray(state0[5]), interp, d["stencil_src"],
                          d["vsgn"], d["ok_ref"], None, DT, jsim.dx(5),
                          jsim.cfg)
    assert d["vsgn"] is None                # periodic box
    got = PK.level_sweep(_t(state0[5]), _t(interp), _t(d["stencil_src"]),
                         None, _t(d["ok_ref"]), DT, jsim.dx(5),
                         hydro_static_from(jsim.cfg))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_tile_sweep_matches(level5):
    jsim, d, state0, _, binterp = level5
    args = ("tile_src", "tile_vsgn", "tile_ok", "cell_tile", "cell_slot",
            "oct_tile", "oct_slot")
    want = JK.tile_sweep(jnp.asarray(state0[5]), binterp,
                         *[d[a] for a in args], DT, jsim.dx(5), jsim.cfg, 2,
                         pallas_ok=False)
    got = PK.tile_sweep(_t(state0[5]), _t(binterp),
                        *[None if d[a] is None else _t(d[a]) for a in args],
                        DT, jsim.dx(5), hydro_static_from(jsim.cfg), 2)
    _close(got[0], want[0])
    _close(got[1], want[1])
    # pad rows come out exactly zero
    nreal = jsim.tree.noct(5) * 8
    assert not got[0][nreal:].any()
    # the gathered batch is laid out as the kernel takes it: tile-major,
    # the batch-last gather's values
    ut = PK._gather_tiles(_t(state0[5]), _t(binterp), _t(d["tile_src"]),
                          None, hydro_static_from(jsim.cfg), 12)
    ntile = d["tile_src"].shape[0]
    assert tuple(ut.shape) == (5, ntile, 12, 12, 12) and ut.is_contiguous()
    assert torch.equal(ut, PK._gather_utile(
        _t(state0[5]), _t(binterp), _t(d["tile_src"]), None,
        hydro_static_from(jsim.cfg), 12).movedim(-1, 1))


def test_dense_sweep_with_mask_matches(level5):
    jsim, d, state0, _, _ = level5
    d4 = jsim.dev[4]
    shape = jsim.tree.cell_dims(4)
    assert np.asarray(d4["ok_dense"]).any()
    want = JK.dense_sweep(jnp.asarray(state0[4]), None, None, d4["ok_dense"],
                          DT, jsim.dx(4), shape, jsim.bspec, jsim.cfg)
    pbc = bmod.BoundarySpec.from_params(pparams(_text(), ndim=3))
    got = PK.dense_sweep(_t(state0[4]), None, None, _t(d4["ok_dense"]), DT,
                         jsim.dx(4), shape, pbc, hydro_static_from(jsim.cfg))
    _close(got, want)


def test_scatter_restrict_courant_match(level5):
    jsim, d, state0, interp, _ = level5
    cfg = hydro_static_from(jsim.cfg)
    _, corr = JK.level_sweep(jnp.asarray(state0[5]), interp,
                             d["stencil_src"], d["vsgn"], d["ok_ref"], None,
                             DT, jsim.dx(5), jsim.cfg)
    corr_idx = np.asarray(d["corr_idx"])
    assert (corr_idx >= 0).any()
    want = JK.scatter_corrections(jnp.asarray(state0[4]), corr, corr_idx,
                                  jsim.cfg)
    got = PK.scatter_corrections(_t(state0[4]), _t(corr),
                                 PK.corr_plan(corr_idx, "cpu"), cfg)
    _close(got, want)
    m4 = jsim.maps[4]
    want = JK.restrict_upload(jnp.asarray(state0[4]), jnp.asarray(state0[5]),
                              jsim.dev[4]["ref_cell"], jsim.dev[4]["son_oct"],
                              jsim.cfg)
    got = PK.restrict_upload(_t(state0[4]), _t(state0[5]),
                             _t(m4.ref_cell[:m4.nref]),
                             _t(m4.son_oct[:m4.nref]), cfg)
    _close(got, want)
    for l in (4, 5):
        want = JK.level_courant(jnp.asarray(state0[l]),
                                jsim.dev[l]["valid_cell"], jsim.dx(l),
                                jsim.cfg)
        got = PK.level_courant(_t(state0[l]), _t(jsim.dev[l]["valid_cell"]),
                               jsim.dx(l), cfg)
        _close(got, want)


FLUX_RTOL = 1e-12


def _flux_inputs(level5, f32):
    """The level-5 sweeps' inputs with a random velocity field added (the
    initial blast is at rest, where the mass fluxes vanish), in f32 (the
    plain versions of K1, K3 and K2 on CPU tensors) or f64 (the general
    formulation)."""
    jsim, d, state0, interp, binterp = level5
    dt = np.float32 if f32 else np.float64
    rng = np.random.default_rng(11)

    def moving(u):
        u = u.copy()
        mom = 0.3 * u[:, :1] * rng.standard_normal((u.shape[0], 3))
        u[:, 4] += 0.5 * (mom ** 2).sum(axis=1) / u[:, 0]
        u[:, 1:4] += mom
        return u.astype(dt)
    u4, u5 = moving(state0[4]), moving(state0[5])
    ints = [JK.interp_cells(jnp.asarray(u4.astype(np.float64)),
                            d[pre + "interp_cell"], d[pre + "interp_nb"],
                            d[pre + "interp_sgn"], jsim.cfg)
            for pre in ("", "b_")]
    return (jsim, d, u4, u5, *[np.asarray(x).astype(dt) for x in ints])


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("kind", ["dense", "level", "tile"])
def test_sweep_ret_flux_matches(level5, kind, f32):
    """``ret_flux``: each sweep's per-cell (low, high) face mass fluxes
    ``phi [ncell_pad, ndim, 2]`` against the JAX package's, f64 at rtol
    1e-12; in f32 through the kernels' plain versions (the layouts the
    CUDA kernels' outputs are read back in) against JAX's XLA path, to
    the f32 table.  The du and corrections are unchanged by it, and pad
    rows are 0."""
    jsim, d, u4, u5, interp, binterp = _flux_inputs(level5, f32)
    cfg = hydro_static_from(jsim.cfg)
    jdt = jnp.float32(DT) if f32 else DT
    if kind == "dense":
        d4 = jsim.dev[4]
        shape = jsim.tree.cell_dims(4)
        want = JK.dense_sweep(jnp.asarray(u4), None, None, d4["ok_dense"],
                              jdt, jsim.dx(4), shape, jsim.bspec, jsim.cfg,
                              ret_flux=True)
        pbc = bmod.BoundarySpec.from_params(pparams(_text(), ndim=3))
        args = (_t(u4), None, None, _t(d4["ok_dense"]), DT, jsim.dx(4),
                shape, pbc, cfg)
        got = PK.dense_sweep(*args, ret_flux=True)
        plain = PK.dense_sweep(*args)
        nreal = jsim.tree.noct(4) * 8
    elif kind == "level":
        want = JK.level_sweep(jnp.asarray(u5), jnp.asarray(interp),
                              d["stencil_src"], d["vsgn"], d["ok_ref"], None,
                              jdt, jsim.dx(5), jsim.cfg, ret_flux=True)
        args = (_t(u5), _t(interp), _t(d["stencil_src"]), None,
                _t(d["ok_ref"]), DT, jsim.dx(5), cfg)
        got = PK.level_sweep(*args, ret_flux=True)
        plain = PK.level_sweep(*args)
        nreal = jsim.tree.noct(5) * 8
    else:
        names = ("tile_src", "tile_vsgn", "tile_ok", "cell_tile",
                 "cell_slot", "oct_tile", "oct_slot")
        want = JK.tile_sweep(jnp.asarray(u5), jnp.asarray(binterp),
                             *[d[a] for a in names], jdt, jsim.dx(5),
                             jsim.cfg, 2, ret_flux=True, pallas_ok=False)
        args = (_t(u5), _t(binterp),
                *[None if d[a] is None else _t(d[a]) for a in names],
                DT, jsim.dx(5), cfg, 2)
        got = PK.tile_sweep(*args, ret_flux=True)
        plain = PK.tile_sweep(*args)
        nreal = jsim.tree.noct(5) * 8
    phi = got[-1]
    assert phi.dtype == (torch.float32 if f32 else torch.float64)
    assert tuple(phi.shape) == (u4.shape[0] if kind == "dense"
                                else u5.shape[0], 3, 2)
    assert not phi[nreal:].any()
    assert phi[:nreal].abs().max() > 0
    if kind == "dense":
        assert torch.equal(got[0], plain)
    else:
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    if f32:
        _close(phi, want[-1], rtol=2e-5, atol=2e-6)
    else:
        _close(phi, want[-1], rtol=FLUX_RTOL)


def _tile_sweep_before(u_flat, interp_vals, tile_src, tile_vsgn, tile_ok,
                       cell_tile, cell_slot, oct_tile, oct_slot, dt, dx,
                       cfg, shift, ret_flux=False):
    """``amr/kernels.tile_sweep`` as it was while K3 took the batch-last
    layout ``[5, td, td, td, N]``: the batch-last gather, the plain version
    on exactly those arrays, and the reindexing of its batch-last outputs."""
    nd, nvar = cfg.ndim, cfg.nvar
    c = 1 << (shift + 1)
    td = c + 4
    ut = PK._gather_utile(u_flat, interp_vals, tile_src, tile_vsgn, cfg, td)
    ntile = ut.shape[-1]
    okl = PK._block_mask(tile_ok, td, nd)
    if om.supports(cfg, u_flat.dtype):
        out = om.tile_sweep_ref(
            ut.movedim(-1, 1), okl.to(ut.dtype).movedim(-1, 0),
            torch.as_tensor(dt, dtype=ut.dtype), cfg, dx, shift,
            want_flux=ret_flux)
        du_t = out[0].movedim(1, -1)
        planes = [out[1][:, d].movedim(1, -1) for d in range(nd)]
        mass = ([out[2][d].movedim(0, -1) for d in range(nd)]
                if ret_flux else None)
    else:
        fluxes, du_t = PK._general_update(ut, okl, dt, dx, cfg, c)
        planes = [PK._face_planes(fluxes[d], d, nd, c) for d in range(nd)]
        mass = ([PK._mass_planes(fluxes[d][0], d, nd, c) for d in range(nd)]
                if ret_flux else None)
    flat_idx = cell_slot.to(torch.int64) * ntile + cell_tile
    du_src = torch.cat([du_t.reshape(nvar, c ** nd * ntile),
                        du_t.new_zeros(nvar, 1)], dim=1)
    du_flat = du_src[:, flat_idx].t()
    corr = []
    o = c // 2
    for d in range(nd):
        # the per-oct sums of the batch-last planes [nvar, o+1, c..., ntile]
        g = planes[d].reshape([nvar, o + 1] + [o, 2] * (nd - 1) + [ntile])
        g = torch.movedim(g, [3 + 2 * i for i in range(nd - 1)],
                          list(range(1, nd)))
        sm = g.sum(dim=tuple(range(1, nd)))
        lo, hi = (torch.movedim(x, 1, 1 + d).reshape(nvar, o ** nd, ntile)
                  for x in (sm[:, :o], sm[:, 1:]))
        corr.append(torch.stack([lo[:, oct_slot, oct_tile],
                                 hi[:, oct_slot, oct_tile]], dim=-1))
    corr = torch.movedim(torch.stack(corr, dim=-2), 0, -1)
    if not ret_flux:
        return du_flat, corr

    def cell_rows(x, d):
        x = torch.movedim(x, 0, d).reshape(c ** nd * ntile)
        return torch.cat([x, x.new_zeros(1)])[flat_idx]
    phi = torch.stack([torch.stack([cell_rows(mass[d][:c], d),
                                    cell_rows(mass[d][1:], d)], dim=-1)
                       for d in range(nd)], dim=-2)
    return du_flat, corr, phi


@pytest.mark.parametrize("f32,ret_flux", [(True, False), (True, True),
                                          (False, True)])
def test_tile_sweep_bitwise_as_before(level5, f32, ret_flux):
    """The tile-major batch (K3's layout) changes no bit of what
    ``tile_sweep`` returns: du, the coarse corrections and the mass fluxes
    equal the batch-last formulation's, through K3's plain version (f32)
    and the general formulation (f64)."""
    jsim, d, _, u5, _, binterp = _flux_inputs(level5, f32)
    cfg = hydro_static_from(jsim.cfg)
    names = ("tile_src", "tile_vsgn", "tile_ok", "cell_tile", "cell_slot",
             "oct_tile", "oct_slot")
    args = (_t(u5), _t(binterp),
            *[None if d[a] is None else _t(d[a]) for a in names],
            DT, jsim.dx(5), cfg, 2)
    got = PK.tile_sweep(*args, ret_flux=ret_flux)
    want = _tile_sweep_before(*args, ret_flux=ret_flux)
    assert len(got) == len(want) == 2 + ret_flux
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_tile_gather_flips_reflected_velocities_as_before():
    """With reflecting boundaries the tile-major gather flips the mirrored
    velocity components of exactly the cells the batch-last one does."""
    rng = np.random.default_rng(5)
    cfg = HydroStatic(ndim=3)
    u = torch.from_numpy(rng.standard_normal((40, 5)))
    interp = torch.from_numpy(rng.standard_normal((9, 5)))
    src = torch.from_numpy(rng.integers(0, 50, (3, 8 ** 3)))
    vsgn = torch.from_numpy(rng.integers(0, 8, (3, 8 ** 3)).astype(np.int8))
    want = PK._gather_utile(u, interp, src, vsgn, cfg, 8).movedim(-1, 1)
    got = PK._gather_tiles(u, interp, src, vsgn, cfg, 8)
    assert torch.equal(got, want) and got.is_contiguous()


def test_scatter_corr_flux_matches(level5):
    """The fine level's boundary mass fluxes into the coarse face slots of
    the capture, through the host-built plan of valid targets, against
    the JAX package's masked scatter-add (f64, rtol 1e-12); the slots no
    fine face reaches stay as they were."""
    jsim, d, state0, interp, _ = level5
    cfg = hydro_static_from(jsim.cfg)
    _, corr = JK.level_sweep(jnp.asarray(state0[5]), interp,
                             d["stencil_src"], d["vsgn"], d["ok_ref"], None,
                             DT, jsim.dx(5), jsim.cfg)
    corr_idx = np.asarray(d["corr_idx"])
    rng = np.random.default_rng(5)
    phi4 = rng.standard_normal((state0[4].shape[0], 3, 2))
    want = JK.scatter_corr_flux(jnp.asarray(phi4), corr, corr_idx, jsim.cfg)
    plan = PK.flux_plan(corr_idx, "cpu")
    got = PK.scatter_corr_flux(_t(phi4), _t(corr), plan, cfg)
    _close(got, want, rtol=FLUX_RTOL)
    touched = np.zeros(phi4.size, dtype=bool)
    touched[plan.target.numpy()] = True
    assert touched.any()
    assert np.array_equal(got.numpy().reshape(-1)[~touched],
                          phi4.reshape(-1)[~touched])


def test_refine_flags_match(level5):
    jsim, d, state0, interp, binterp = level5
    cfg = hydro_static_from(jsim.cfg)
    eg, fls = (0.1, 0.05, 0.1), (1e-10, 1e-10, 1e-10)
    want = JK.refine_flags(jnp.asarray(state0[5]), interp, d["stencil_src"],
                           d["vsgn"], eg, fls, jsim.cfg)
    got = PK.refine_flags(_t(state0[5]), _t(interp), _t(d["stencil_src"]),
                          None, eg, fls, cfg)
    assert np.array_equal(got.numpy(), np.asarray(want))
    want = JK.tile_refine_flags(jnp.asarray(state0[5]), binterp,
                                d["tile_src"], d["tile_vsgn"],
                                d["cell_tile"], d["cell_slot"], eg, fls,
                                jsim.cfg, 2)
    got = PK.tile_refine_flags(_t(state0[5]), _t(binterp), _t(d["tile_src"]),
                               None, _t(d["cell_tile"]), _t(d["cell_slot"]),
                               eg, fls, cfg, 2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.any()
    shape = jsim.tree.cell_dims(4)
    want = JK.dense_refine_flags(jnp.asarray(state0[4]), None, None, eg, fls,
                                 shape, jsim.bspec, jsim.cfg)
    pbc = bmod.BoundarySpec.from_params(pparams(_text(), ndim=3))
    got = PK.dense_refine_flags(_t(state0[4]), None, None, eg, fls, shape,
                                pbc, cfg)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kinds", [((0, 0), (0, 0), (0, 0)),
                                   ((1, 1), (2, 2), (0, 0))])
def test_k1_mask_ghosts_agree_with_pad_ok_dense(kinds):
    """K1 maps its mask's ghosts itself (``fused_muscl._pad_mask``); the
    general path pads with ``pad_ok_dense`` (wrap, else edge).  They agree
    everywhere on periodic axes and on the ghost layer next to the
    interior otherwise, the only ghosts whose faces reach an interior
    cell."""
    from ramses_tpu_torch.hydro import fused_muscl as fm
    shape = (6, 5, 7)
    ok = torch.from_numpy(np.random.default_rng(3).random(shape) < 0.3)
    bc = bmod.BoundarySpec(faces=tuple(
        (bmod.FaceBC(kind=lo), bmod.FaceBC(kind=hi)) for lo, hi in kinds))
    a = fm._pad_mask(ok.double(), bc)
    b = PK.pad_ok_dense(ok.reshape(-1), shape, bc, torch.float64, 2)
    keep = tuple(slice(None) if k == (0, 0) else slice(1, -1) for k in kinds)
    assert torch.equal(a[keep], b[keep])


def test_bitperm_round_trip():
    rows = torch.arange(8 ** 3 * 2, dtype=torch.float64).reshape(-1, 2)
    dense = PK.rows_to_dense(rows, None, (8, 8, 8))
    assert torch.equal(PK.dense_to_rows(dense, None, (8, 8, 8)), rows)
    # the first oct's 8 cells fill the 2x2x2 corner, x slowest
    assert torch.equal(dense[:2, :2, :2, 0].reshape(-1),
                       2 * torch.arange(8, dtype=torch.float64))


# ---------------------------------------------------------------------------
# the hierarchy
# ---------------------------------------------------------------------------

def _same_run(jsim, psim, rtol=RTOL, atol=ATOL):
    assert jsim.levels() == psim.levels()
    assert jsim.nstep == psim.nstep
    assert psim.t == pytest.approx(jsim.t, rel=1e-12)
    for l in jsim.levels():
        assert np.array_equal(jsim.tree.levels[l].keys,
                              psim.tree.levels[l].keys), l
        ju = np.asarray(jsim.u[l])
        pu = psim.u[l].numpy()
        assert ju.shape == pu.shape, l
        n = jsim.tree.noct(l) * 8
        np.testing.assert_allclose(pu[:n], ju[:n], rtol=rtol, atol=atol,
                                   err_msg=f"level {l}")


@pytest.mark.parametrize("blk", [".true.", ".false."])
def test_hierarchy_matches_jax(jax_runs, blk):
    jsim = jax_runs[3][blk]
    psim = AmrSim(pparams(_text(blk), ndim=3), dtype=torch.float64,
                  device="cpu")
    assert bool(psim.blocks) == (blk == ".true.")
    _script(psim)
    _same_run(jsim, psim)
    tot = psim.totals()
    np.testing.assert_allclose(
        [tot["mass"], *tot["momentum"], tot["energy"]], jsim.totals(),
        rtol=1e-12, atol=1e-14)
    assert psim.ncell_leaf() == jsim.ncell_leaf()


def test_step_chunk_matches_jax():
    """nremap=4: evolve regrids every 4 steps and runs the steps between
    as one chunk without host synchronisation (6 steps: 4 + 2)."""
    jsim = JAmrSim(jparams(_text(nremap=4), ndim=3), dtype=jnp.float64)
    jsim.evolve(1e9, nstepmax=6)
    psim = AmrSim(pparams(_text(nremap=4), ndim=3), dtype=torch.float64,
                  device="cpu")
    chunks = []
    real = psim.step_chunk
    psim.step_chunk = lambda n, tend: chunks.append(n) or real(n, tend)
    psim.evolve(1e9, nstepmax=6)
    assert chunks == [4, 2]
    _same_run(jsim, psim)


def test_from_state_carries_a_jax_run(jax_runs):
    jsim = jax_runs[3][".true."]
    psim = AmrSim.from_state(pparams(_text(), ndim=3), **amr_state_from(jsim),
                             device="cpu")
    _same_run(jsim, psim, rtol=0, atol=0)
    for l in jsim.levels():
        assert np.array_equal(psim.u[l].numpy(), np.asarray(jsim.u[l]))


def test_kernel_path_f32_matches_jax_and_replays_bitwise():
    """f32 through K1 and K3 (and K2) as plain versions on CPU tensors,
    held to f32 roundoff of the JAX package's XLA path; two replays of the
    same 2 steps from one state are bitwise equal; the stencil path agrees
    with the blocked one to f32 roundoff."""
    jsim = _script(JAmrSim(jparams(_text(), ndim=3), dtype=jnp.float32))
    psim = _script(AmrSim(pparams(_text(), ndim=3), dtype=torch.float32,
                          device="cpu"))
    assert jsim.levels() == psim.levels()

    def near(a, b):
        # each field to 2e-5 of its magnitude on the level (f32 eps 1.2e-7)
        return (np.abs(a - b) <= 2e-5 * np.abs(b).max(axis=0)).all()

    for l in jsim.levels():
        assert np.array_equal(jsim.tree.levels[l].keys,
                              psim.tree.levels[l].keys), l
        assert near(psim.u[l].numpy(), np.asarray(jsim.u[l])), l
    state = amr_state_from(psim)
    runs = [_script(AmrSim.from_state(pparams(_text(blk), ndim=3), **state,
                                      device="cpu"), regrid=False)
            for blk in (".true.", ".true.", ".false.")]
    assert runs[0].blocks and not runs[2].blocks
    for l in psim.levels():
        assert torch.equal(runs[0].u[l], runs[1].u[l]), l
        assert near(runs[2].u[l].numpy(), runs[0].u[l].numpy()), l


def test_corner_blast_restricts_every_refined_cell():
    """namelists/sedov3d.nml's blast sits at the corner (0,0,0), so flat
    cell 0 of level 4 is refined.  The JAX package's restrict_upload
    leaves it stale there (E = 4096.000025 against a son mean of 1348.085
    after 2 steps, ROADMAP §C); the port restricts every refined cell."""
    p = load_params(NML, ndim=3)
    p.amr.levelmin, p.amr.levelmax = 4, 5
    p.refine.err_grad_d = p.refine.err_grad_p = 0.1
    sim = AmrSim(p, dtype=torch.float64, device="cpu")
    _script(sim, regrid=False)
    for check in range(2):
        for l in sim.levels()[:-1]:
            ref = sim.tree.refined_mask(l)
            assert ref[0], "the blast corner cell must be refined"
            cells = np.nonzero(ref)[0]
            son = sim.tree.lookup(l + 1, sim.tree.cell_coords(l)[cells])
            fine = sim.u[l + 1].numpy()
            want = fine[(son[:, None] * 8 + np.arange(8))].mean(axis=1)
            np.testing.assert_allclose(sim.u[l].numpy()[cells], want,
                                       rtol=1e-13, atol=0)
        sim._restrict_all()


def test_unported_amr_features_raise():
    p = pparams(_text(), ndim=3)
    p.amr.load_balance = True
    with pytest.raises(NotImplementedError, match="load balance"):
        AmrSim(p, device="cpu")
    # pic without particles runs the hydro hierarchy with the particle
    # layer off, as the JAX package's AmrSim; offload stays refused
    p = pparams(_text(), ndim=3)
    p.run.pic = True
    sim = AmrSim(p, device="cpu")
    assert not sim.pic and sim.p is None
    p.amr.offload = "auto"
    with pytest.raises(NotImplementedError, match="offload"):
        AmrSim(p, device="cpu")


@pytest.mark.parametrize("key,value,name", [
    ("fault_inject", "nan@3", "fault injection"),
    ("max_step_retries", 2, "step guard"),
    ("step_deadline_s", 5.0, "watchdog"),
])
def test_amr_run_control_features_raise(key, value, name):
    from ramses_tpu_torch.amr.hierarchy import unported_amr_features
    p = pparams(_text(), ndim=3)
    setattr(p.run, key, value)
    with pytest.raises(NotImplementedError, match=name):
        AmrSim(p, device="cpu")
    assert [n for n in unported_amr_features(p) if name in n] != []


def test_cli_runs_amr_on_cpu(tmp_path):
    text = (open(NML).read().replace("levelmin=8", "levelmin=4")
            .replace("levelmax=8", "levelmax=5")
            .replace("nstepmax=10", "nstepmax=3")
            + "\n&REFINE_PARAMS\nerr_grad_d=0.1\nerr_grad_p=0.1\n/\n")
    nml = tmp_path / "sedov3d_amr.nml"
    nml.write_text(text)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "ramses_tpu_torch", str(nml), "--ndim", "3",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["1", "2", "3"]
    assert lines[-1].startswith("totals: ") and "nstep=3" in lines[-1]
    assert "octs=[512, " in lines[-1]


def test_oct_kernels_are_not_launched_on_cpu():
    before = dict(om.launches)
    sim = AmrSim(pparams(_text(), ndim=3), dtype=torch.float32, device="cpu")
    sim.step_coarse(sim.coarse_dt())
    assert om.launches == before
