"""The port's MHD on the AMR hierarchy (``ramses_tpu_torch.mhd.amr``) against
the JAX package's ``ramses_tpu.mhd.amr``, on the CPU, in f64 at rtol 1e-10
/ atol 1e-12 unless a case says otherwise.

* the div-free transfer operators, the donor maps and the EMF scatter maps
  (index arrays equal) on a 2D and a 3D tree;
* the stencil and tile sweeps, the restriction and the Courant dt on one
  level of a 2D hierarchy;
* the tube (``tube_mhd.nml``) at levelmin = levelmax = 6 against the port's
  uniform ``MhdSimulation``;
* the exact Orszag-Tang vortex at levelmin 4, levelmax 5 (the JAX package's
  ``tests/test_mhd_amr.py`` setup) for 3 coarse steps with regrids; a
  magnetised blob in 2D (levelmin 4, levelmax 6: two partial levels, the
  coarse-fine EMF override, new octs next to old ones) and in 3D (levelmin
  3, levelmax 4: all three EMF pairs), for a coarse step and a regrid;
* K4's plain version at a complete level with the real refined mask and
  EMF override, against the JAX package's Pallas CT kernel in interpret
  mode;
* the CLI on ``namelists/orszag2d.nml``.

The JAX package's restriction leaves flat cell 0 stale when that cell is
refined and the map has pad rows (ROADMAP §C); every run here asserts that
it does not arise on its input, so the two packages compare row for row.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr import kernels as JK  # noqa: E402
from ramses_tpu.config import load_params as jload  # noqa: E402
from ramses_tpu.config import params_from_string as jparams  # noqa: E402
from ramses_tpu.mhd import amr as JA  # noqa: E402
from ramses_tpu.mhd import pallas_ct  # noqa: E402

from ramses_tpu_torch.config import load_params as pload  # noqa: E402
from ramses_tpu_torch.config import params_from_string as pparams  # noqa: E402
from ramses_tpu_torch.convert import mhd_amr_state_from  # noqa: E402
from ramses_tpu_torch.convert import mhd_static_from  # noqa: E402
from ramses_tpu_torch.mhd import amr as PA  # noqa: E402
from ramses_tpu_torch.mhd import core as pcore  # noqa: E402
from ramses_tpu_torch.mhd import ct_slab  # noqa: E402
from ramses_tpu_torch.mhd.core import IBX, IP, NCOMP  # noqa: E402
from ramses_tpu_torch.mhd.driver import MhdSimulation  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUBE = os.path.join(ROOT, "namelists", "tube_mhd.nml")
OT_NML = os.path.join(ROOT, "namelists", "orszag2d.nml")
RTOL, ATOL = 1e-10, 1e-12

# a dense, moving disc (sphere in 3D) in a uniform oblique field: density
# and pressure jumps refine its rim, far from the corner cell 0; the field
# is uniform, so div B = 0, and C_region drives the degenerate 2D Bz
BLOB = """
&RUN_PARAMS
hydro=.true.
nremap=1
/
&AMR_PARAMS
levelmin={lmin}
levelmax={lmax}
boxlen=1.0
oct_blocking={blk}
/
&INIT_PARAMS
nregion=2
region_type(1)='square'
region_type(2)='square'
x_center=0.5,0.5
y_center=0.5,0.5
z_center=0.5,0.5
length_x=10.0,0.4
length_y=10.0,0.4
length_z=10.0,0.4
exp_region=10.0,2.0
d_region=1.0,4.0
p_region=1.0,3.0
u_region=0.0,0.6
v_region=0.0,-0.4
w_region=0.0,0.3
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


def _blob(nd, lmin, lmax, blk=".true."):
    return BLOB.format(lmin=lmin, lmax=lmax, blk=blk), nd


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), rtol=rtol, atol=atol)


def _no_stale_cell0(jsim):
    """The JAX package's restriction is exact on this hierarchy: no level
    whose flat cell 0 is refined has pad rows in its restriction map."""
    for l in jsim.levels()[:-1]:
        m = jsim.maps[l]
        assert m.nref == m.nref_pad or not jsim.tree.refined_mask(l)[0], l


def _same_run(jsim, psim, rtol=RTOL, atol=ATOL):
    assert jsim.levels() == psim.levels()
    assert jsim.nstep == psim.nstep
    assert psim.t == pytest.approx(jsim.t, rel=1e-12)
    _no_stale_cell0(jsim)
    ttd = 2 ** psim.tree_ndim
    for l in jsim.levels():
        assert np.array_equal(jsim.tree.levels[l].keys,
                              psim.tree.levels[l].keys), l
        n = jsim.tree.noct(l) * ttd
        for a, b in ((jsim.u, psim.u), (jsim.bfs, psim.bfs)):
            assert np.asarray(a[l]).shape == tuple(b[l].shape), l
            np.testing.assert_allclose(b[l].numpy()[:n], np.asarray(a[l])[:n],
                                       rtol=rtol, atol=atol,
                                       err_msg=f"level {l}")


def _script(sim, nstep=3, end_regrid=False):
    """``nstep`` times a regrid then a coarse step (and a last regrid when
    ``end_regrid``); the octs per level after each regrid."""
    trees = []
    for k in range(nstep + end_regrid):
        sim.regrid()
        trees.append({l: sim.tree.levels[l].keys.copy()
                      for l in sim.levels()})
        if k < nstep:
            sim.step_coarse(sim.coarse_dt())
    return trees


# ---------------------------------------------------------------------------
# the exact Orszag-Tang vortex (tests/test_mhd_amr.py:86-146)
# ---------------------------------------------------------------------------

def _ot_params(load, lmin, lmax):
    p = load(TUBE, ndim=2)
    p.amr.levelmin, p.amr.levelmax = lmin, lmax
    p.amr.boxlen = 1.0
    p.boundary.nboundary = 0          # fully periodic
    p.refine.err_grad_d = 0.05
    p.refine.err_grad_p = 0.1
    p.refine.err_grad_b = 0.1
    return p


def _ot_rows(sim, l):
    """(u rows, face rows) of level ``l``: faces from the vector potential
    Az, so div B = 0 to roundoff and a coarse face is the mean of its fine
    faces."""
    rho0, p0 = 25.0 / (36.0 * np.pi), 5.0 / (12.0 * np.pi)
    b0, two_pi = 1.0 / np.sqrt(4.0 * np.pi), 2.0 * np.pi

    def az(x, y):
        return b0 * (np.cos(4.0 * np.pi * x) / (4.0 * np.pi)
                     + np.cos(two_pi * y) / two_pi)

    m = sim.maps[l]
    dxl = sim.dx(l)
    cc = sim.tree.cell_coords(l).astype(np.float64)
    x0, y0 = cc[:, 0] * dxl, cc[:, 1] * dxl
    n = len(cc)
    bf = np.zeros((m.ncell_pad, NCOMP, 2))
    bf[:n, 0, 0] = (az(x0, y0 + dxl) - az(x0, y0)) / dxl
    bf[:n, 0, 1] = (az(x0 + dxl, y0 + dxl) - az(x0 + dxl, y0)) / dxl
    bf[:n, 1, 0] = -(az(x0 + dxl, y0) - az(x0, y0)) / dxl
    bf[:n, 1, 1] = -(az(x0 + dxl, y0 + dxl) - az(x0, y0 + dxl)) / dxl
    xc, yc = x0 + 0.5 * dxl, y0 + 0.5 * dxl
    q = np.zeros((8, m.ncell_pad))
    q[0] = sim.mcfg.smallr
    q[0, :n] = rho0
    q[1, :n] = -np.sin(two_pi * yc)
    q[2, :n] = np.sin(two_pi * xc)
    q[IP] = 1e-20
    q[IP, :n] = p0
    for c in range(NCOMP):
        q[IBX + c] = 0.5 * (bf[:, c, 0] + bf[:, c, 1])
    return pcore.prim_to_cons(torch.from_numpy(q),
                              mhd_static_from(sim.mcfg)).numpy().T, bf


def _set_ot(sim, jax):
    for l in sim.levels():
        u, bf = _ot_rows(sim, l)
        if jax:
            sim.u[l], sim.bfs[l] = jnp.asarray(u), jnp.asarray(bf)
        else:
            sim.u[l], sim.bfs[l] = _t(u), _t(bf)
    sim._restrict_all()
    sim._dt_cache = None


def _make_ot(jax, lmin=4, lmax=5):
    sim = (JA.MhdAmrSim(_ot_params(jload, lmin, lmax), dtype=jnp.float64)
           if jax else PA.MhdAmrSim(_ot_params(pload, lmin, lmax),
                                    dtype=torch.float64, device="cpu"))
    _set_ot(sim, jax)
    for _ in range(2):                # let the tree adapt to the state
        sim.regrid()
        _set_ot(sim, jax)
    return sim


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's runs, f64, each with the octs after every regrid:
    Orszag-Tang for 3 coarse steps; the 2D and 3D blobs for a coarse step
    and a regrid that refines next to existing fine octs (the 2D blob's
    final maps and state also feed the operator tests)."""
    ot = _make_ot(True)
    runs = dict(ot=(ot, _script(ot)))
    for case, nd, lmin, lmax in (("b2", 2, 4, 6), ("b3", 3, 3, 4)):
        sim = JA.MhdAmrSim(jparams(*_blob(nd, lmin, lmax)), dtype=jnp.float64)
        runs[case] = (sim, _script(sim, 1, end_regrid=True))
    return runs


# ---------------------------------------------------------------------------
# operators and maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd", [2, 3])
def test_balsara_and_matched_child_faces_match(nd):
    rng = np.random.default_rng(nd)
    n, nsub = 37, 2 ** (nd - 1)
    bff = rng.standard_normal((n, NCOMP, 2))
    sgn = rng.choice([-1.0, 1.0], size=(n, nd))
    outer = rng.standard_normal((n, nd, 2, nsub))
    _close(PA.balsara_child_faces(_t(bff), _t(sgn), nd),
           JA.balsara_child_faces(jnp.asarray(bff), jnp.asarray(sgn), nd))
    got = PA.matched_child_faces(_t(bff), _t(outer), nd)
    _close(got, JA.matched_child_faces(jnp.asarray(bff), jnp.asarray(outer),
                                       nd))
    # every child is divergence-free to roundoff when the outer faces sum
    # to the father's divergence (zero here)
    outer[:, :, 1] = outer[:, :, 0]
    outer[:, 0, 1] += outer[:, 1:, 0].sum(axis=(1, 2))[:, None] / nsub \
        - outer[:, 1:, 1].sum(axis=(1, 2))[:, None] / nsub
    rows = PA.matched_child_faces(_t(bff), _t(outer), nd).numpy()
    div = sum(rows[:, d, 1] - rows[:, d, 0] for d in range(nd))
    parent = sum(outer[:, d, 1].sum(1) - outer[:, d, 0].sum(1)
                 for d in range(nd))
    assert np.abs(div.reshape(n, -1).sum(1) - parent).max() < 1e-12


@pytest.mark.parametrize("case", ["b2", "b3"])
def test_donor_and_emf_maps_match(jax_runs, case):
    jsim = jax_runs[case][0]
    nd = jsim.tree_ndim
    psim = PA.MhdAmrSim.from_state(
        pparams(*_blob(nd, jsim.lmin, jsim.lmax)), **mhd_amr_state_from(jsim),
        device="cpu")
    fine = jsim.levels()[1:]
    assert fine and not jsim.maps[fine[-1]].complete
    for l in fine:
        new = np.arange(0, jsim.tree.noct(l), 3)
        want = jsim._donor_maps(l, new)
        got = psim._donor_maps(l, new)
        assert np.array_equal(got, want) and (got >= 0).any(), l
        jidx = jsim.dev[l].get("emf_dense_idx")
        pidx = psim.emf_dense_idx(l)
        assert (jidx is None) == (pidx is None), l
        if pidx is not None:
            assert np.array_equal(pidx, np.asarray(jidx)), l
            assert (pidx < (1 << ((l - 1) * nd))).any()
            assert len(psim.dev[l]["emf_plan"]) == nd * (nd - 1) // 2
    assert any(psim.emf_dense_idx(l) is not None for l in fine)


@pytest.fixture(scope="module")
def level5(jax_runs):
    """Inputs of the partial level 5 (complete parent 4, refined cells at
    6) of the 2D blob's hierarchy after its regrid."""
    jsim = jax_runs["b2"][0]
    assert not jsim.maps[5].complete and jsim.maps[4].complete
    state = mhd_amr_state_from(jsim)
    d = jsim.dev[5]
    ju4, jb4 = jnp.asarray(state["rows"][4]), jnp.asarray(state["bfs"][4])
    interp = {}
    for pre in ("", "b_"):
        iu = JK.interp_cells(ju4, d[pre + "interp_cell"], d[pre + "interp_nb"],
                             d[pre + "interp_sgn"], jsim.mcfg, itype=1)
        ib = JA.balsara_child_faces(jb4[d[pre + "interp_cell"]],
                                    d[pre + "interp_sgn"].astype(jb4.dtype),
                                    2)
        interp[pre] = (iu, ib)
    return jsim, d, state, interp


DT = 2e-3


@pytest.mark.parametrize("path", ["stencil", "tile"])
def test_level_sweeps_match(level5, path):
    jsim, d, state, interp = level5
    cfg = mhd_static_from(jsim.mcfg)
    u5, b5 = state["rows"][5], state["bfs"][5]
    if path == "stencil":
        iu, ib = interp[""]
        want = JA.mhd_level_sweep(jnp.asarray(u5), iu, jnp.asarray(b5), ib,
                                  d["stencil_src"], d["ok_ref"], DT,
                                  jsim.dx(5), jsim.mcfg)
        got = PA.mhd_level_sweep(_t(u5), _t(iu), _t(b5), _t(ib),
                                 _t(d["stencil_src"]), _t(d["ok_ref"]), DT,
                                 jsim.dx(5), cfg)
    else:
        iu, ib = interp["b_"]
        args = ("tile_src", "tile_ok", "cell_tile", "cell_slot", "oct_tile",
                "oct_slot")
        want = JA.mhd_tile_sweep(jnp.asarray(u5), iu, jnp.asarray(b5), ib,
                                 *[d[a] for a in args], DT, jsim.dx(5),
                                 jsim.mcfg, 2)
        got = PA.mhd_tile_sweep(_t(u5), _t(iu), _t(b5), _t(ib),
                                *[_t(d[a]) for a in args], DT, jsim.dx(5),
                                cfg, 2)
        nreal = jsim.tree.noct(5) * 4
        assert not got[0][nreal:].any() and not got[1][nreal:].any()
    assert np.asarray(d["ok_ref"]).any()          # refined cells in reach
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        _close(g, w)


def test_restrict_courant_and_flags_match(level5):
    jsim, d, state, _ = level5
    cfg = mhd_static_from(jsim.mcfg)
    m4 = jsim.maps[4]
    rows, bfs = state["rows"], state["bfs"]
    want = JA.mhd_restrict_upload(
        jnp.asarray(rows[4]), jnp.asarray(bfs[4]), jnp.asarray(rows[5]),
        jnp.asarray(bfs[5]), jsim.dev[4]["ref_cell"], jsim.dev[4]["son_oct"],
        jsim.mcfg)
    assert not jsim.tree.refined_mask(4)[0]       # cell 0 not refined
    got = PA.mhd_restrict_upload(
        _t(rows[4]), _t(bfs[4]), _t(rows[5]), _t(bfs[5]),
        _t(m4.ref_cell[:m4.nref]), _t(m4.son_oct[:m4.nref]), cfg)
    for g, w in zip(got, want):
        _close(g, w)
    for l in (4, 5, 6):
        want = JA.mhd_level_courant(jnp.asarray(rows[l]), jnp.asarray(bfs[l]),
                                    jsim.dev[l]["valid_cell"], jsim.dx(l),
                                    jsim.mcfg)
        got = PA.mhd_level_courant(_t(rows[l]), _t(bfs[l]),
                                   _t(jsim.dev[l]["valid_cell"]), jsim.dx(l),
                                   cfg)
        _close(got, want)
    psim = PA.MhdAmrSim.from_state(pparams(*_blob(2, 4, 6)), **state,
                                   device="cpu")
    spec = psim._fused_spec()
    assert spec.blocked == (False, True, True)
    want = jsim._criteria_flags(jsim._fused_spec())
    got = psim._criteria_flags(spec)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert any(g.any() for g in got)


# ---------------------------------------------------------------------------
# the hierarchy
# ---------------------------------------------------------------------------

def test_tube_complete_level_matches_uniform():
    """levelmin == levelmax: the hierarchy's dense path reproduces the
    port's uniform CT stepper step for step (1D Roe: the torch
    formulation)."""
    p = pload(TUBE, ndim=1)
    p.amr.levelmin = p.amr.levelmax = 6
    amr = PA.MhdAmrSim(p, dtype=torch.float64, device="cpu")
    uni = MhdSimulation(p, dtype=torch.float64, device="cpu")
    for _ in range(4):
        amr.step_coarse(amr.coarse_dt())
    uni.evolve(tend=amr.t + 1e-30, nstepmax=4)
    assert uni.nstep == 4
    assert uni.t == pytest.approx(amr.t, rel=1e-12)
    m = amr.maps[6]
    got = amr.u[6].numpy()[:m.noct * 2][m.inv_perm].T
    _close(got, uni.u.numpy().reshape(uni.cfg.nvar, -1))
    assert amr.max_divb() == 0.0                  # 1D: Bx never changes


def test_orszag_tang_matches_jax(jax_runs):
    jsim, jtrees = jax_runs["ot"]
    psim = _make_ot(False)
    tot0 = psim.totals()
    assert psim.max_divb() < 1e-12
    ptrees = _script(psim)
    for jt, pt in zip(jtrees, ptrees):
        assert jt.keys() == pt.keys()
        assert all(np.array_equal(jt[l], pt[l]) for l in jt)
    _same_run(jsim, psim)
    assert psim.max_divb() < 1e-11 and psim.max_face_gap() == 0.0
    tot1 = psim.totals()
    assert tot1["mass"] == pytest.approx(tot0["mass"], rel=1e-12)
    assert tot1["energy"] == pytest.approx(jsim.totals()[IP], rel=1e-12)


@pytest.mark.parametrize("case", ["b2", "b3"])
def test_blob_hierarchy_matches_jax(jax_runs, case):
    """Partial levels (blocked tile sweeps), the coarse-fine EMF override
    on the complete parent, and the face migration of new octs next to old
    fine ones: 2D at levelmin 4, levelmax 6; 3D at levelmin 3, levelmax 4
    (all three EMF pairs).  div B stays at roundoff on levels 4 and 5 (3D:
    3 and 4); in 2D level 6's parent is partial and keeps its own EMFs (the
    JAX package's first-order coupling), so the faces migrated below it
    read a divergence, the same in both packages (ROADMAP §C3)."""
    jsim, jtrees = jax_runs[case]
    nd = jsim.tree_ndim
    psim = PA.MhdAmrSim(pparams(*_blob(nd, jsim.lmin, jsim.lmax)),
                        dtype=torch.float64, device="cpu")
    tot0 = psim.totals()
    ptrees = _script(psim, 1, end_regrid=True)
    for jt, pt in zip(jtrees, ptrees):
        assert jt.keys() == pt.keys()
        assert all(np.array_equal(jt[l], pt[l]) for l in jt)
    lv = psim.levels()
    assert not psim.maps[lv[1]].complete and psim.maps[lv[0]].complete
    assert "emf_plan" in psim.dev[lv[1]]
    _same_run(jsim, psim)
    assert psim.max_face_gap() == 0.0
    div = psim.divb_levels()
    assert max(div[l] for l in lv[:2]) < 1e-11
    if nd == 2:
        assert div[6] > 1e-4
        assert psim.max_divb() == pytest.approx(jsim.max_divb(), rel=1e-6)
    tot1 = psim.totals()
    assert tot1["mass"] == pytest.approx(tot0["mass"], rel=1e-12)
    np.testing.assert_allclose(
        [tot1["mass"], *tot1["momentum"], tot1["energy"]],
        jsim.totals()[[0, 1, 2, 3, IP]], rtol=1e-12, atol=1e-14)


def test_stencil_path_and_chunks_match_the_blocked_run(jax_runs):
    """``oct_blocking=.false.`` (the per-oct stencil sweep) gives the rows
    of the blocked run, and ``nremap=2`` runs a 2-step chunk without host
    synchronisation that matches step-at-a-time stepping."""
    jsim, _ = jax_runs["b2"]
    text, nd = _blob(2, 4, 6, blk=".false.")
    psim = PA.MhdAmrSim(pparams(text, nd), dtype=torch.float64, device="cpu")
    assert not psim.blocks
    _script(psim, 1, end_regrid=True)
    _same_run(jsim, psim)
    chunked = PA.MhdAmrSim(pparams(text.replace("nremap=1", "nremap=2"), nd),
                           dtype=torch.float64, device="cpu")
    stepped = PA.MhdAmrSim(pparams(text, nd), dtype=torch.float64,
                           device="cpu")
    chunks = []
    real = chunked.step_chunk
    chunked.step_chunk = lambda n, tend: chunks.append(n) or real(n, tend)
    chunked.evolve(1e9, nstepmax=2)
    stepped.regrid()
    for _ in range(2):
        stepped.step_coarse(stepped.coarse_dt())
    assert chunks == [2] and chunked.nstep == 2
    assert chunked.t == pytest.approx(stepped.t, rel=1e-14)
    for l in stepped.levels():
        assert torch.equal(chunked.u[l], stepped.u[l])
        assert torch.equal(chunked.bfs[l], stepped.bfs[l])


def test_from_state_carries_a_jax_run_and_f32_replays_bitwise(jax_runs):
    jsim, _ = jax_runs["b2"]
    state = mhd_amr_state_from(jsim)
    psim = PA.MhdAmrSim.from_state(pparams(*_blob(2, 4, 6)), **state,
                                   device="cpu")
    for l in jsim.levels():
        assert torch.equal(psim.u[l], _t(jsim.u[l]))
        assert torch.equal(psim.bfs[l], _t(jsim.bfs[l]))
    assert (psim.t, psim.nstep) == (jsim.t, jsim.nstep)
    runs = []
    for _ in range(2):
        s = PA.MhdAmrSim.from_state(pparams(*_blob(2, 4, 6)), **state,
                                    dtype=torch.float32, device="cpu")
        _script(s, 2)
        runs.append(s)
    for l in runs[0].levels():
        assert torch.equal(runs[0].u[l], runs[1].u[l])
        assert torch.equal(runs[0].bfs[l], runs[1].bfs[l])


def test_ct_plain_at_a_complete_level_matches_pallas(jax_runs):
    """The CT step a coarse step hands the complete parent level (its
    refined mask and the coarse-fine EMF override, captured at the call)
    through K4's plain version and through the JAX package's Pallas CT
    kernel in interpret mode: one call, f64, 1e-12."""
    jsim, _ = jax_runs["b2"]
    psim = PA.MhdAmrSim.from_state(pparams(*_blob(2, 4, 6)),
                                   **mhd_amr_state_from(jsim), device="cpu")
    calls = []
    real = ct_slab.ct_step_slab_ref       # f64: outside K4's gate

    def capture(*a, **k):
        calls.append((a, k))
        return real(*a, **k)
    ct_slab.ct_step_slab_ref = capture
    try:
        psim.step_coarse(psim.coarse_dt())
    finally:
        ct_slab.ct_step_slab_ref = real
    assert len(calls) == 1                         # level 4 is complete
    (up, bfp, dt, dx, cfg), k = calls[0]
    okp, ovr = k["okp"], k["ovr"]
    assert okp is not None and bool(okp.any())
    assert ovr is not None and bool(ovr[(0, 1)][0].any())
    jun, jbfn = pallas_ct.ct_step_slab(
        jnp.asarray(up.numpy()), jnp.asarray(bfp.numpy()), float(dt), dx,
        jsim.mcfg, okp=jnp.asarray(okp.numpy()),
        ovr={p: (jnp.asarray(m.numpy()), jnp.asarray(v.numpy()))
             for p, (m, v) in ovr.items()}, interpret=True)
    inner = (slice(None), slice(2, -2), slice(2, -2))
    un, bfn = ct_slab.ct_step_slab_ref(up, bfp, dt, dx, cfg, okp=okp,
                                       ovr=ovr)
    _close(un, np.asarray(jun)[inner], rtol=1e-12)
    _close(bfn, np.asarray(jbfn)[inner], rtol=1e-12)


def test_restriction_covers_a_refined_flat_cell_0():
    """Orszag-Tang at levelmin 5, levelmax 7: level 6 is complete, its flat
    cell 0 is refined and its restriction map has pad rows.  On the inputs
    the first coarse step hands the level-6 restriction, the port writes
    every refined cell its sons' means; the JAX package's
    ``mhd_restrict_upload`` writes the pad rows' clamped copy of the old
    cell 0 last (XLA:CPU), so its cell 0 keeps the level's own update
    (ROADMAP §C)."""
    from ramses_tpu.mhd.core import MhdStatic as JMhdStatic
    sim = _make_ot(False, 5, 7)
    _script(sim, 1, end_regrid=True)
    m = sim.maps[6]
    assert sim.tree.refined_mask(6)[0] and m.nref < m.nref_pad
    calls = []
    real = PA.mhd_restrict_upload

    def capture(*a):
        calls.append(a)
        return real(*a)
    PA.mhd_restrict_upload = capture
    try:
        sim.step_coarse(sim.coarse_dt())
    finally:
        PA.mhd_restrict_upload = real
    args = next(a for a in calls if a[0].shape[0] == m.ncell_pad)
    got_u, got_b = real(*args)
    ju, jb = JA.mhd_restrict_upload(
        *[jnp.asarray(x.numpy()) for x in args[:4]],
        jnp.asarray(m.ref_cell), jnp.asarray(m.son_oct),
        JMhdStatic(**{k: getattr(args[6], k) for k in (
            "ndim", "npassive", "gamma", "smallr", "smallc", "slope_type",
            "slope_theta", "riemann", "riemann2d", "courant_factor")}))
    ju, jb = np.asarray(ju), np.asarray(jb)
    sons = args[2].numpy()[m.son_oct[0] * 4 + np.arange(4)]
    # (the staggered B centres are the restricted faces' mean instead)
    np.testing.assert_allclose(got_u.numpy()[0, :IBX],
                               sons.mean(axis=0)[:IBX], rtol=1e-14,
                               atol=1e-15)
    # everywhere else the two agree; at cell 0 JAX keeps the input row
    _close(got_u[1:], ju[1:])
    _close(got_b[1:], jb[1:])
    assert np.array_equal(ju[0], args[0].numpy()[0])
    assert np.array_equal(jb[0], args[1].numpy()[0])
    assert np.abs(ju[0] - got_u.numpy()[0]).max() > 1e-6


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_cli_runs_orszag2d_on_cpu(tmp_path):
    nml = tmp_path / "orszag2d_3.nml"
    nml.write_text(open(OT_NML).read().replace("nremap=1",
                                               "nremap=1\nnstepmax=3"))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "ramses_tpu_torch", str(nml), "--ndim", "2",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split()[1] for ln in lines[:-2]] == ["1", "2", "3"]
    assert lines[-2].startswith("totals: ") and "nstep=3" in lines[-2]
    assert lines[-1].startswith("mhd-amr t=") and "nstep=3" in lines[-1]
    assert "max|divB|/max|B|*dx=" in lines[-1]


def test_unported_features_raise_and_cuda_is_the_default():
    for key, value, name in (("cosmo", True, "cosmology"),
                             ("fault_inject", "nan@3", "fault injection")):
        p = pload(OT_NML, ndim=2)
        setattr(p.run, key, value)
        with pytest.raises(NotImplementedError, match=name):
            PA.MhdAmrSim(p, device="cpu")
    # gravity, particles (none given: the layer stays off, as on the hydro
    # hierarchy) and tracers run on the MHD hierarchy
    for key in ("poisson", "pic", "tracer"):
        p = pload(OT_NML, ndim=2)
        p.amr.levelmin, p.amr.levelmax = 4, 5
        setattr(p.run, key, True)
        sim = PA.MhdAmrSim(p, device="cpu")
        assert (sim.gravity, sim.pic, sim.tracer_x is not None) == (
            key == "poisson", False, key == "tracer")
    p = pload(OT_NML, ndim=2)
    p.amr.offload = "host"
    with pytest.raises(NotImplementedError, match="offload"):
        PA.MhdAmrSim(p, device="cpu")
    p = pload(TUBE, ndim=1)
    p.amr.levelmax = 9
    p.boundary.bound_type = [1, 1]
    with pytest.raises(NotImplementedError, match="periodic/outflow"):
        PA.MhdAmrSim(p, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PA.MhdAmrSim(pload(OT_NML, ndim=2))
