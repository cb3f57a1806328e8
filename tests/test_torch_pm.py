"""The particle-mesh layer of the port against the JAX package's, on the
CPU in f64.

* ``pm/particles``: the NGP, CIC and TSC deposits and gathers, ``kick``,
  ``drift`` in a periodic and an open box, ``particle_dt`` and
  ``freefall_dt`` on random particles (``default_rng`` seeds): each within
  ``FIELD`` (1e-12) of its scale; each deposit bitwise a sequential sum
  in the JAX package's scatter order;
* ``pm/amr_pm``: ``assign_levels`` and ``build_pm_maps`` (tensors) on
  small hand-built trees, periodic and open, for each scheme, against the
  JAX package's numpy pass: ``idx`` and ``assigned`` integer-equal, ``w``
  within 1e-15; ``deposit_flat`` (the
  segment sum in the map's order) and ``gather_flat`` within ``FIELD``,
  the deposit bitwise a sequential sum in the JAX package's order, and the
  deposit with the maps of an older tree as the JAX package's scatter
  treats them;
* ``AmrSim`` with particles (``&RUN_PARAMS pic``, self-gravity, no
  cosmology) on a 2D hierarchy, periodic and open, 3 coarse steps: rows
  within ``test_torch_amr.py``'s tolerances, particles within ``FIELD``;
* the refusals: a reflecting wall with particles, particles on the MHD
  drivers and on ``ShardedAmrSim``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.amr.tree import Octree as JOctree  # noqa: E402
from ramses_tpu.config import params_from_string as jparams  # noqa: E402
from ramses_tpu.pm import amr_pm as jpm  # noqa: E402
from ramses_tpu.pm import particles as jp  # noqa: E402

from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.amr.tree import Octree  # noqa: E402
from ramses_tpu_torch.config import params_from_string as pparams  # noqa: E402,E501
from ramses_tpu_torch.convert import particles_from  # noqa: E402
from ramses_tpu_torch.pm import amr_pm as ppm  # noqa: E402
from ramses_tpu_torch.pm import particles as pp  # noqa: E402

from test_torch_amr import ATOL, RTOL  # noqa: E402

FIELD = 1e-12     # deposits, gathers and particle states against their scale


def _close(got, want, tol=FIELD, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} of scale {scale:.3e}"


def _pair(n=300, ndim=3, seed=0, nmax=None, vmax=1.0):
    """The same random particles as a JAX ParticleSet and the port's."""
    rng = np.random.default_rng(seed)
    jset = jp.ParticleSet.make(jnp.asarray(rng.uniform(0, 1, (n, ndim))),
                               jnp.asarray(rng.uniform(-vmax, vmax,
                                                       (n, ndim))),
                               jnp.asarray(rng.uniform(0.5, 1.5, n)),
                               nmax=nmax)
    return jset, particles_from(jset)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("scheme", ["ngp", "cic", "tsc"])
def test_deposit_matches_jax(scheme, ndim):
    jset, pset = _pair(ndim=ndim, seed=1, nmax=320)
    shape = (16,) * ndim if ndim == 2 else (8, 12, 10)
    dx = 1.0 / shape[0]
    want = getattr(jp, "deposit_" + scheme)(jset, shape, dx)
    got = getattr(pp, "deposit_" + scheme)(pset, shape, dx)
    _close(got, want, what=f"deposit_{scheme}")


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("scheme", ["ngp", "cic", "tsc"])
def test_gather_matches_jax(scheme, ndim):
    jset, pset = _pair(ndim=ndim, seed=2)
    shape = (16,) * ndim
    field = np.random.default_rng(3).standard_normal((ndim,) + shape)
    want = getattr(jp, "gather_" + scheme)(jnp.asarray(field), jset.x,
                                           1.0 / 16)
    got = getattr(pp, "gather_" + scheme)(torch.tensor(field), pset.x,
                                          1.0 / 16)
    _close(got, want, what=f"gather_{scheme}")


def test_kick_and_particle_dt_match_jax():
    jset, pset = _pair(seed=4, nmax=310)
    f = np.random.default_rng(5).standard_normal((310, 3))
    jk = jp.kick(jset, jnp.asarray(f), 0.37)
    pk = pp.kick(pset, torch.tensor(f), 0.37)
    _close(pk.v, jk.v, what="kick")
    assert float(pp.particle_dt(pk, 1.0 / 32, 0.8)) == pytest.approx(
        float(jp.particle_dt(jk, 1.0 / 32, 0.8)), rel=FIELD)
    assert float(pp.freefall_dt(3.5, 0.8, 4 * np.pi)) == pytest.approx(
        float(jp.freefall_dt(3.5, 0.8, 4 * np.pi)), rel=FIELD)
    still = particles_from(jp.ParticleSet.make(
        jnp.zeros((2, 3)), jnp.zeros((2, 3)), jnp.ones(2)))
    assert float(pp.particle_dt(still, 0.1, 0.5)) == 1e30


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "open"])
def test_drift_matches_jax(periodic):
    jset, pset = _pair(seed=6, nmax=320, vmax=2.0)
    jd = jp.drift(jset, 0.21, 1.0, periodic=periodic)
    pd = pp.drift(pset, 0.21, 1.0, periodic=periodic)
    _close(pd.x, jd.x, what="x")
    assert np.array_equal(pd.active.numpy(), np.asarray(jd.active))
    if not periodic:
        # escapers deactivated and parked at the origin
        gone = ~pd.active.numpy()
        assert gone[:300].any() and not pd.x.numpy()[gone].any()


def test_particle_set_lanes_and_headroom():
    from ramses_tpu_torch.config import Params
    jset, pset = _pair(n=5, ndim=2, nmax=8)
    for f in ("x", "v", "m", "active", "idp", "family", "tp", "zp"):
        assert np.array_equal(getattr(pset, f).numpy(),
                              np.asarray(getattr(jset, f))), f
    assert pset.m.dtype == torch.float64 and pset.idp.dtype == torch.int64
    p = Params(ndim=3)
    assert pp.lane_headroom(p, False) is None
    assert pp.lane_headroom(p, True) == pp.DEFAULT_HEADROOM
    p.amr.npartmax = 77
    assert pp.lane_headroom(p, False) == 77


# ---------------------------------------------------------------------------
# the hierarchy's maps
# ---------------------------------------------------------------------------

def _trees(ndim: int):
    """A base level 3, a partial level 4 around (0.3, ...) and a partial
    level 5 inside it, the same in both packages' Octree."""
    rng = np.random.default_rng(ndim)
    lv = {3: np.indices((4,) * ndim).reshape(ndim, -1).T}
    og4 = np.indices((8,) * ndim).reshape(ndim, -1).T
    lv[4] = og4[np.linalg.norm((og4 + 0.5) / 8 - 0.3, axis=1) < 0.3]
    og5 = np.concatenate([2 * lv[4] + o for o in
                          np.indices((2,) * ndim).reshape(ndim, -1).T])
    keep = np.linalg.norm((og5 + 0.5) / 16 - 0.3, axis=1) < 0.15
    lv[5] = og5[keep & (rng.random(len(og5)) < 0.9)]
    out = []
    for cls in (JOctree, Octree):
        t = cls(ndim, 3, 5)
        for l, og in lv.items():
            t.set_level(l, og.astype(np.int64))
        out.append(t)
    return out


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("bc", ["periodic", "open"])
@pytest.mark.parametrize("scheme", ["ngp", "cic", "tsc"])
def test_build_pm_maps_match_jax(scheme, bc, ndim):
    jt, pt = _trees(ndim)
    kinds = [(0, 0) if bc == "periodic" else (2, 2)] * ndim
    x = np.random.default_rng(7).uniform(0, 1, (400, ndim))
    x[:20] = np.random.default_rng(8).uniform(0, 0.02, (20, ndim))  # edges
    ncp = {3: 8 ** ndim * 2, 4: jt.noct(4) * 2 ** ndim + 16,
           5: jt.noct(5) * 2 ** ndim + 8}
    xt = torch.tensor(x)
    assert np.array_equal(ppm.assign_levels(pt, xt, 1.0).numpy(),
                          jpm.assign_levels(jt, x, 1.0))
    want = jpm.build_pm_maps(jt, x, 1.0, kinds, ncp, scheme=scheme)
    got = ppm.build_pm_maps(pt, xt, 1.0, kinds, ncp, scheme=scheme)
    assert sorted(got) == sorted(want) == [3, 4, 5]
    for l in want:
        assert np.array_equal(got[l].idx.numpy(), want[l].idx), l
        assert np.array_equal(got[l].assigned.numpy(), want[l].assigned), l
        np.testing.assert_allclose(got[l].w.numpy(), want[l].w, rtol=0,
                                   atol=1e-15)
        # the level's deposit and gather on these maps
        m = np.random.default_rng(l).uniform(0.5, 1.5, 400)
        act = np.arange(400) % 7 != 3
        vol = (1.0 / (1 << l)) ** ndim
        jr = jpm.deposit_flat(jnp.asarray(want[l].idx),
                              jnp.asarray(want[l].w), jnp.asarray(m),
                              jnp.asarray(act), ncp[l], vol)
        dm = ppm.device_maps(got[l], ncp[l], torch.float64)
        pr = ppm.deposit_flat(dm["plan"], torch.tensor(m),
                              torch.tensor(act), vol)
        _close(pr, jr, what=f"deposit_flat {l}")
        fld = np.random.default_rng(l + 9).standard_normal((ncp[l], ndim))
        jg = jpm.gather_flat(jnp.asarray(fld), jnp.asarray(want[l].idx),
                             jnp.asarray(want[l].w),
                             jnp.asarray(want[l].assigned))
        pg = ppm.gather_flat(torch.tensor(fld), dm["idx"], dm["w"],
                             dm["mask"])
        _close(pg, jg, what=f"gather_flat {l}")


def test_build_pm_maps_refuse_reflecting_walls():
    _, pt = _trees(2)
    with pytest.raises(NotImplementedError, match="reflecting"):
        ppm.build_pm_maps(pt, torch.full((3, 2), 0.5, dtype=torch.float64),
                          1.0, [(1, 1), (0, 0)], {3: 64, 4: 512, 5: 512})


@pytest.mark.parametrize("scheme", ["ngp", "cic", "tsc"])
def test_deposit_sums_each_cell_in_scatter_order(scheme):
    """The uniform deposit equals, bitwise, adding each entry into its cell
    in the JAX package's scatter order (corner by corner, each corner's
    particles in turn), from 0; masses over 16 decades make the order
    show in the last bits."""
    rng = np.random.default_rng(12)
    n, shape = 400, (6, 5, 4)
    m = rng.uniform(0.1, 2.0, n) * 10.0 ** rng.integers(-8, 8, n)
    pset = pp.ParticleSet.make(torch.tensor(rng.uniform(0, 1, (n, 3))),
                               torch.zeros((n, 3), dtype=torch.float64),
                               torch.tensor(m), dtype=torch.float64,
                               device="cpu")
    dx = 1.0 / shape[0]
    entries = []
    real = pp._scatter

    def recorded(sh, dtype, device, ent):
        entries.extend(ent)                 # the (cells, values) in order
        return real(sh, dtype, device, entries)
    pp._scatter = recorded
    try:
        got = getattr(pp, "deposit_" + scheme)(pset, shape, dx)
    finally:
        pp._scatter = real
    want = np.zeros(shape)
    for idx, val in entries:
        cells = np.stack([i.numpy() for i in idx], axis=1)
        for c, v in zip(cells, val.numpy()):
            want[tuple(c)] += v
    vol = float(np.prod([dx] * 3))          # as the deposit forms it
    assert np.array_equal(got.numpy(), want / vol)


def test_deposit_flat_sums_each_row_in_map_order():
    """The segment sum equals, bitwise, adding each entry into its row in
    the flat order of the map (particle, then corner), as XLA:CPU's
    scatter does; entries on the dump row and past it add nothing."""
    rng = np.random.default_rng(11)
    n, nc, ncp = 500, 8, 40
    idx = rng.integers(0, ncp + 3, (n, nc)).astype(np.int64)
    w = rng.uniform(0, 1, (n, nc))
    m = rng.uniform(0.1, 2.0, n) * 10.0 ** rng.integers(-8, 8, n)
    act = rng.random(n) < 0.9
    plan = ppm.segment_plan(torch.tensor(idx), torch.tensor(w), ncp)
    got = ppm.deposit_flat(plan, torch.tensor(m), torch.tensor(act), 1.0)
    want = np.zeros(ncp)
    for p in range(n):
        for c in range(nc):
            if idx[p, c] < ncp:
                want[idx[p, c]] += (m[p] * act[p]) * w[p, c]
    assert np.array_equal(got.numpy(), want)
    # the JAX package's deposit on the same map: the same sums (an index
    # past the dump row is dropped there as here)
    jr = jpm.deposit_flat(jnp.asarray(idx, jnp.int32), jnp.asarray(w),
                          jnp.asarray(m), jnp.asarray(act), ncp, 1.0)
    _close(got, jr, what="against the JAX scatter")


# ---------------------------------------------------------------------------
# the hierarchy with particles
# ---------------------------------------------------------------------------

def _pic_text(bound: bool) -> str:
    bc = ("&BOUNDARY_PARAMS\nnboundary=4\nbound_type=2,2,2,2\n"
          "ibound_min=-1,1,0,0\nibound_max=-1,1,0,0\n"
          "jbound_min=0,0,-1,1\njbound_max=0,0,-1,1\n/\n") if bound else ""
    return ("&RUN_PARAMS\nhydro=.true.\npoisson=.true.\npic=.true.\n/\n"
            "&AMR_PARAMS\nlevelmin=3\nlevelmax=5\nboxlen=1.0\n/\n"
            "&INIT_PARAMS\nnregion=1\nregion_type(1)='square'\n"
            "d_region=1.0\np_region=1.0\n/\n"
            "&HYDRO_PARAMS\nriemann='hllc'\ncourant_factor=0.5\n/\n"
            "&REFINE_PARAMS\nx_refine=0,0,0.5,0.5\ny_refine=0,0,0.5,0.5\n"
            "r_refine=-1,-1,0.2,0.2\n/\n" + bc)


@pytest.mark.parametrize("bound", [False, True], ids=["periodic", "open"])
def test_amr_particles_match_jax(bound):
    """``tests/test_amr_pm.py``'s refined 2D hierarchy with 48 particles
    (``default_rng(3)``, the open box with particles near its edge): 3
    coarse steps of both at the JAX run's dt (particle Courant, free-fall
    and CFL caps, checked equal), the rows, phi, fg and the particles."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0.05, 0.95, (48, 2))
    if bound:
        x[:6] = rng.uniform(0.0, 0.03, (6, 2))
    v = rng.uniform(-0.3, 0.3, (48, 2))
    jset = jp.ParticleSet.make(x, v, np.full(48, 1.0 / 48))
    jsim = JAmrSim(jparams(_pic_text(bound), ndim=2), dtype=jnp.float64,
                   particles=jax.device_put(jset))
    psim = AmrSim(pparams(_pic_text(bound), ndim=2), dtype=torch.float64,
                  device="cpu", particles=particles_from(jset))
    assert psim.pic and psim.grav_periodic == (not bound)
    assert jsim.levels() == psim.levels() == [3, 4, 5]
    for _ in range(3):
        dt = jsim.coarse_dt()
        assert psim.coarse_dt() == pytest.approx(dt, rel=1e-12)
        jsim.step_coarse(dt)
        psim.step_coarse(dt)
    assert psim._rho_max == pytest.approx(jsim._rho_max, rel=1e-12)
    for l in jsim.levels():
        n = jsim.tree.noct(l) * 4
        np.testing.assert_allclose(psim.u[l].numpy()[:n],
                                   np.asarray(jsim.u[l])[:n], rtol=RTOL,
                                   atol=ATOL, err_msg=f"level {l}")
        _close(psim.phi[l][:n], np.asarray(jsim.phi[l])[:n], tol=1e-10,
               what=f"phi {l}")
        _close(psim.fg[l][:n], np.asarray(jsim.fg[l])[:n], tol=1e-10,
               what=f"fg {l}")
    assert ({l: int(v) for l, v in psim.poisson_iters.items()}
            == {l: int(v) for l, v in jsim.poisson_iters.items()})
    assert np.array_equal(psim.p.active.numpy(), np.asarray(jsim.p.active))
    _close(psim.p.x, jsim.p.x, tol=1e-10, what="x")
    _close(psim.p.v, jsim.p.v, tol=1e-10, what="v")
    if bound:
        assert not psim.p.active.numpy().all()


def test_particle_refusals():
    from ramses_tpu_torch.mhd.amr import MhdAmrSim
    from ramses_tpu_torch.mhd.driver import MhdSimulation, \
        unported_mhd_features
    from ramses_tpu_torch.parallel.amr_sharded import ShardedAmrSim
    from ramses_tpu_torch.parallel.mesh import ShardMesh
    txt = _pic_text(False) + ("&BOUNDARY_PARAMS\nnboundary=2\n"
                              "bound_type=1,1\nibound_min=-1,1\n"
                              "ibound_max=-1,1\njbound_min=0,0\n"
                              "jbound_max=0,0\n/\n")
    p = pparams(txt.replace("poisson=.true.", "poisson=.false."), ndim=2)
    _, pset = _pair(n=4, ndim=2)
    with pytest.raises(NotImplementedError, match="reflecting"):
        AmrSim(p, dtype=torch.float64, device="cpu", particles=pset)
    p = pparams(_pic_text(False), ndim=2)
    p.run.poisson = False
    with pytest.raises(NotImplementedError, match="particles on Sharded"):
        ShardedAmrSim(p, devices=ShardMesh(["cpu"] * 2))
    # particles run on the MHD hierarchy, the uniform MHD driver refuses
    # them
    assert not [n for n in unported_mhd_features(p) if "particles" in n]
    p.amr.levelmax = p.amr.levelmin
    with pytest.raises(NotImplementedError,
                       match="particles .* on the uniform MHD driver"):
        MhdSimulation(p, device="cpu")
    # the sink passes (and star formation and cooling) stay off the MHD
    # hierarchy, as the JAX package's _pm_family keeps them
    assert MhdAmrSim._pm_physics is False and AmrSim._pm_physics is True
