"""The port's RT functions (``ramses_tpu_torch.rt``) against the JAX
package's ``ramses_tpu.rt``, on the CPU in f64.

* ``eddington``, ``transport_step`` (1D/2D/3D, periodic and outflow),
  the grouped ``transport`` with sources and beams (K8's plain version),
  the block update of partial levels, ``chem_step`` and ``chem_step_3ion``
  (with and without the UV background, heating on and off): every field
  within 1e-12 × its max (the two packages' pow and exp differ in the last
  bit);
* ``blackbody_groups``, ``cross_section``: bitwise (the same host numpy);
* ``RtSim.advance`` (gray and 3-ion, sources and beams, rt_pp): after a
  few substeps N, F, x, xHe2, xHe3 and T within 1e-9 × their max;
* the JAX package's own oracles (``tests/test_rt.py``) on the port.

States are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.rt import chem as jchem  # noqa: E402
from ramses_tpu.rt import driver as jdrv  # noqa: E402
from ramses_tpu.rt import m1 as jm1  # noqa: E402
from ramses_tpu.rt import spectra as jspec  # noqa: E402
from ramses_tpu.rt.amr import _glf_block as j_glf_block  # noqa: E402

from ramses_tpu_torch.rt import chem, m1, spectra  # noqa: E402
from ramses_tpu_torch.rt import driver as drv  # noqa: E402

FN_REL = 1e-12
RUN_REL = 1e-9


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def close(got, want, rel):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_array_less(np.abs(got - want), rel * scale + 1e-300)


def _nf(shape, seed, c_red, nd=None):
    rng = np.random.default_rng(seed)
    nd = len(shape) if nd is None else nd
    N = 10.0 ** rng.uniform(-12, -5, shape)
    F = rng.standard_normal((nd,) + shape)
    F *= 1.2 * c_red * N * rng.random(shape) / np.sqrt((F ** 2).sum(axis=0))
    F[:, rng.random(shape) < 0.2] = 0.0
    return N, F


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_eddington_matches_jax(nd):
    c_red = 3e7
    N, F = _nf((5,) * nd, nd, c_red)
    N[0] = 0.0                                  # the closure of vacuum
    F[:, 0] = 0.0
    want = jm1.eddington(jnp.asarray(N), [jnp.asarray(f) for f in F], c_red,
                         nd)
    got = m1.eddington(_t(N), [_t(f) for f in F], c_red, nd)
    for i in range(nd):
        for j in range(nd):
            close(got[i][j], want[i][j], FN_REL)


@pytest.mark.parametrize("shape,periodic", [((17,), True), ((17,), False),
                                            ((9, 12), True),
                                            ((9, 12), False),
                                            ((6, 7, 5), True),
                                            ((6, 7, 5), False)])
def test_transport_step_matches_jax(shape, periodic):
    nd, c_red = len(shape), 3e7
    N, F = _nf(shape, 3 + nd, c_red)
    dt, dx = 0.8 * 3e19 / 3.0 / c_red, 3e19
    wn, wf = jm1.transport_step(jnp.asarray(N), jnp.asarray(F), dt, dx,
                                c_red, nd, periodic)
    gn, gf = m1.transport_step_ref(_t(N), _t(F), dt, dx, c_red, nd, periodic)
    close(gn, wn, FN_REL)
    close(gf, wf, FN_REL)


@pytest.mark.parametrize("shape,ng,periodic,beams", [
    ((16,), 3, False, True), ((8, 8), 1, True, True),
    ((6, 5, 7), 2, True, False)])
def test_grouped_transport_with_sources_matches_jax(shape, ng, periodic,
                                                    beams):
    # K8's plain version: N += dt·src, F += dt·src_F, then every group's
    # transport_step, as RtSim's substep body
    nd, c_red = len(shape), 3e7
    N, F = zip(*(_nf(shape, 9 + g, c_red) for g in range(ng)))
    N, F = np.stack(N), np.stack(F)
    rng = np.random.default_rng(4)
    src = np.where(rng.random(N.shape) < 0.2, 1e-16, 0.0)
    srcF = c_red * src[:, None] * rng.standard_normal(F.shape) \
        if beams else None
    dt, dx = 0.8 * 3e19 / 3.0 / c_red, 3e19
    want = []
    Nj = jnp.asarray(N) + dt * jnp.asarray(src)
    Fj = jnp.asarray(F) + (dt * jnp.asarray(srcF) if beams else 0.0)
    for g in range(ng):
        wn, wf = jm1.transport_step(Nj[g], Fj[g], dt, dx, c_red, nd,
                                    periodic)
        want.append(np.concatenate([np.asarray(wn)[None], np.asarray(wf)]))
    U = _t(np.concatenate([N[:, None], F], axis=1))
    got = m1.transport(U, dt, dx, c_red, nd, periodic, _t(src),
                       _t(srcF) if beams else None)
    close(got, np.stack(want), FN_REL)


@pytest.mark.parametrize("nd,ng", [(2, 1), (3, 2)])
def test_block_update_matches_jax(nd, ng):
    c_red, noct = 3e7, 6
    blk = np.concatenate([np.concatenate(
        [a[None] for a in (lambda nf: [nf[0]] + list(nf[1]))(
            _nf((6,) * nd + (noct,), 20 + g, c_red, nd))])
        for g in range(ng)])
    rad = np.random.default_rng(0).random((noct * 2 ** nd + 3,
                                           ng * (1 + nd)))
    dt, dx = 1e11, 3e19
    upd = jnp.concatenate([j_glf_block(jnp.asarray(blk[g * (1 + nd):
                                                       (g + 1) * (1 + nd)]),
                                       dt, dx, c_red, nd)
                           for g in range(ng)], axis=0)
    interior = (slice(None),) + tuple(slice(2, 4) for _ in range(nd))
    upd = jnp.transpose(upd[interior], (nd + 1,) + tuple(range(1, nd + 1))
                        + (0,)).reshape(noct * 2 ** nd, ng * (1 + nd))
    want = np.array(rad)
    want[:noct * 2 ** nd] = np.asarray(upd)
    got = m1.block_update(_t(rad), _t(blk), dt, dx, c_red, nd, ng)
    close(got, want, FN_REL)


def _uv():
    from ramses_tpu.hydro.cooling import uv_rates
    g, h = uv_rates(1.0, 1.0)
    return ((g["HI"], g["HeI"], g["HeII"]), (h["HI"], h["HeI"], h["HeII"]))


def _cells(n, seed, ng=1):
    rng = np.random.default_rng(seed)
    return (10.0 ** rng.uniform(-30, -5, (ng, n)),
            10.0 ** rng.uniform(-12, 0, n),
            10.0 ** rng.uniform(-12, -0.31, n),
            10.0 ** rng.uniform(-12, -0.31, n),
            10.0 ** rng.uniform(1, 6, n), 10.0 ** rng.uniform(-4, 2, n))


@pytest.mark.parametrize("uv,heating,otsa", [(False, True, True),
                                             (True, True, True),
                                             (False, False, False)])
def test_chem_step_matches_jax(uv, heating, otsa):
    N, x, _, _, T, nH = _cells(4000, 1)
    uvv = _uv() if uv else None
    want = jchem.chem_step(jnp.asarray(N[0]), jnp.asarray(x), jnp.asarray(T),
                           jnp.asarray(nH), 3e10, 3e7, jchem.GroupSpec(),
                           otsa, heating=heating, uv=uvv)
    Nv = _t(N[0])
    got = chem.chem_gray(Nv, _t(x), _t(T), _t(nH), 3e10, 3e7,
                         chem.GroupSpec(), otsa, heating=heating, uv=uvv)
    for g, w in zip((Nv,) + got, want):
        close(g, w, FN_REL)


@pytest.mark.parametrize("ng,uv,heating", [(1, False, True), (3, True, True),
                                           (2, False, False)])
def test_chem_step_3ion_matches_jax(ng, uv, heating):
    N, x, h2, h3, T, nH = _cells(3000, 2 + ng, ng)
    nHe = nH * 0.08
    bounds = list(np.geomspace(13.6, 1e3, ng + 1))
    jg = jspec.blackbody_groups(1e5, bounds)
    pg = spectra.blackbody_groups(1e5, bounds)
    uvv = _uv() if uv else None
    want = jchem.chem_step_3ion([jnp.asarray(n) for n in N],
                                tuple(jnp.asarray(a) for a in (x, h2, h3)),
                                jnp.asarray(T), jnp.asarray(nH),
                                jnp.asarray(nHe), 1e11, 3e7, jg,
                                heating=heating, uv=uvv)
    Nv = _t(N)
    got = chem.chem_3ion(Nv, _t(x), _t(h2), _t(h3), _t(T), _t(nH), _t(nHe),
                         1e11, 3e7, pg, heating=heating, uv=uvv)
    for g in range(ng):
        close(Nv[g], want[0][g], FN_REL)
    for g, w in zip(got, list(want[1]) + [want[2]]):
        close(g, w, FN_REL)


def test_chem_more_groups_than_the_kernel_runs_the_plain_version():
    assert chem.supports(chem.MAX_GROUPS) and not chem.supports(
        chem.MAX_GROUPS + 1)


@pytest.mark.parametrize("bounds", [jspec.DEFAULT_BOUNDS,
                                    (13.6, 24.59, 1e3), (13.6, 1e3)])
def test_spectra_are_bitwise_the_jax_package(bounds):
    import dataclasses
    for a, b in zip(jspec.blackbody_groups(1e5, bounds),
                    spectra.blackbody_groups(1e5, bounds)):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    E = np.geomspace(5.0, 2e3, 3001)
    for sp in range(3):
        assert np.array_equal(jspec.cross_section(E, sp),
                              spectra.cross_section(E, sp))


def _rt_sims(spec_kw, shape, dx, seed, sources):
    rng = np.random.default_rng(seed)
    nH = 10.0 ** rng.uniform(-3, -1, shape)
    T = 10.0 ** rng.uniform(2, 4, shape)
    js = jdrv.RtSim(shape, dx, jdrv.RtSpec(**spec_kw), nH, T=T)
    spec_kw = dict(spec_kw)
    if "groups3" in spec_kw:
        import dataclasses
        spec_kw["groups3"] = tuple(spectra.Group3(*dataclasses.astuple(g))
                                   for g in spec_kw["groups3"])
    ps = drv.RtSim(shape, dx, drv.RtSpec(**spec_kw), nH, T=T, device="cpu")
    for pos, ndot, direction in sources:
        js.point_source(pos, ndot, direction)
        ps.point_source(pos, ndot, direction)
    return js, ps


def _held(js, ps):
    close(ps.N, js.N, RUN_REL)
    close(ps.F, js.F, RUN_REL)
    close(ps.x, js.x, RUN_REL)
    close(ps.T, js.T, RUN_REL)
    if js.spec.full3:
        close(ps.xHe2, js.xHe2, RUN_REL)
        close(ps.xHe3, js.xHe3, RUN_REL)


G3 = jspec.blackbody_groups(1e5, jspec.DEFAULT_BOUNDS)


@pytest.mark.parametrize("spec_kw,shape,sources", [
    (dict(ndim=3, c_fraction=1e-3), (8, 8, 8),
     [((4e19, 4e19, 4e19), 5e48, None)]),
    (dict(ndim=2, c_fraction=1e-3, periodic=False, pp=True), (12, 10),
     [((1e19, 1e19), 1e50, (0.707107, 0.707107)),
      ((1e19, 5e18), 1e50, (1.0, 0.0))]),
    (dict(ndim=3, c_fraction=3e-3, groups3=G3, y_he=0.24), (8, 8, 8),
     [((4e19, 4e19, 4e19), 5e48, None)]),
    (dict(ndim=2, c_fraction=1e-3, groups3=G3[:2], periodic=False), (10, 10),
     [((5e19, 5e19), 5e48, (0.0, 1.0))]),
])
def test_rtsim_advance_matches_jax(spec_kw, shape, sources):
    dx = 1e19
    js, ps = _rt_sims(spec_kw, shape, dx, 5, sources)
    dt = 6.5 * jm1.rt_courant_dt(dx, js.spec.c_red, js.spec.courant)
    js.advance(dt)
    assert ps.advance(dt) == 7
    _held(js, ps)
    assert ps.photon_total() == pytest.approx(js.photon_total(), rel=1e-12)
    assert ps.ionized_volume() == pytest.approx(js.ionized_volume(),
                                                rel=1e-12)


def test_stromgren_radius_matches_jax():
    assert drv.stromgren_radius(5e48, 1e-2, 2e4) == pytest.approx(
        jdrv.stromgren_radius(5e48, 1e-2, 2e4), rel=1e-14)


# ---- the JAX package's oracles (tests/test_rt.py) on the port ----------

def test_free_streaming_speed_1d():
    """A photon front must advance at the reduced speed of light."""
    spec = drv.RtSpec(ndim=1, c_fraction=1e-4, heating=False)
    n = 256
    dx = 1.0e14
    sim = drv.RtSim((n,), dx, spec, nH=np.full(n, 1e-30), device="cpu")
    N0 = np.zeros(n)
    N0[:8] = 1.0
    sim.N = N0
    sim.F = N0[None, :] * spec.c_red                 # beaming right
    sim.advance(100 * dx / spec.c_red)
    N = sim.N.numpy()
    front = np.max(np.where(N > 0.5 * N.max())[0])
    assert 90 <= front <= 118
    assert np.isclose(N.sum(), N0.sum(), rtol=1e-10)


def test_m1_closure_limits():
    N = torch.tensor([1.0, 1.0], dtype=torch.float64)
    F = [torch.tensor([1.0, 0.0], dtype=torch.float64)]
    P = m1.eddington(N, F, 1.0, 1)
    assert np.isclose(float(P[0][0][0]), 1.0, atol=1e-10)     # f=1: chi=1
    assert np.isclose(float(P[0][0][1]), 1.0 / 3.0, atol=1e-10)  # f=0


def test_absorption_ionization_balance():
    """Photons removed == ionizations performed."""
    nH = torch.full((16,), 1e-3, dtype=torch.float64)
    N = torch.full((16,), 1e-6, dtype=torch.float64)
    T = torch.full((16,), 1e2, dtype=torch.float64)
    x0 = torch.full((16,), 1e-6, dtype=torch.float64)
    N1, x1, _ = chem.chem_step_ref(N, x0, T, nH, 1e8, 1e-3 * drv.C_CGS,
                                   chem.GroupSpec(), heating=False)
    absorbed = float((N - N1).sum())
    ionized = float((nH * (x1 - x0)).sum())
    assert absorbed > 0
    assert np.isclose(absorbed, ionized, rtol=0.05)


def test_stromgren_sphere_3d():
    """Ionized volume approaches the analytic Stromgren value (the JAX
    test at 16³ instead of 32³: its ~470 substeps take seconds)."""
    nH0, ndot, T0 = 1e-3, 5e48, 1e4
    rs = drv.stromgren_radius(ndot, nH0, T0)
    box = 4.0 * rs
    n = 16
    dx = box / n
    spec = drv.RtSpec(ndim=3, c_fraction=1e-3, heating=False,
                      periodic=False)
    sim = drv.RtSim((n,) * 3, dx, spec, nH=np.full((n,) * 3, nH0),
                    T=np.full((n,) * 3, T0), device="cpu")
    sim.point_source((box / 2,) * 3, ndot)
    aB = float(chem.alpha_B(torch.tensor(T0, dtype=torch.float64)))
    t_rec = 1.0 / (aB * nH0)
    v2_hist = []
    for _ in range(9):
        sim.advance(0.5 * t_rec)
        v2_hist.append(float((sim.x ** 2).sum()) * dx ** 3)
    v_s = 4.0 / 3.0 * np.pi * rs ** 3
    assert 0.88 < v2_hist[-1] / v_s < 1.05, v2_hist[-1] / v_s
    assert all(b >= a * 0.999 for a, b in zip(v2_hist, v2_hist[1:]))
    c = n // 2
    assert float(sim.x[c, c, c]) > 0.99
    assert float(sim.x[0, 0, 0]) < 0.05


def test_photoheating_raises_temperature():
    nH0, ndot, n = 1e-3, 1e49, 16
    rs = drv.stromgren_radius(ndot, nH0)
    dx = 2 * rs / n
    spec = drv.RtSpec(ndim=2, c_fraction=1e-3, heating=True, periodic=False)
    sim = drv.RtSim((n, n), dx, spec, nH=np.full((n, n), nH0),
                    T=np.full((n, n), 100.0), device="cpu")
    sim.point_source((rs, rs), ndot)
    aB = float(chem.alpha_B(torch.tensor(1e4, dtype=torch.float64)))
    sim.advance(0.3 / (aB * nH0))
    T = sim.T.numpy()
    c = n // 2
    assert T[c, c] > 5e3           # photoheated toward ~1e4 K
    assert np.all(np.isfinite(T))


def test_photon_conservation_with_source():
    """Without absorption, injected photons are exactly accounted."""
    spec = drv.RtSpec(ndim=2, c_fraction=1e-3, heating=False, periodic=True)
    n, dx, ndot = 32, 3e15, 1e50
    sim = drv.RtSim((n, n), dx, spec, nH=np.full((n, n), 1e-30),
                    device="cpu")
    sim.point_source((n * dx / 2, n * dx / 2), ndot)
    sim.advance(20 * m1.rt_courant_dt(dx, spec.c_red))
    assert np.isclose(sim.photon_total(), ndot * sim.t, rtol=1e-6)


def test_sed_tables_are_bitwise_the_jax_package(tmp_path, monkeypatch):
    import dataclasses

    from ramses_tpu.rt import sed as jsed

    from ramses_tpu_torch.rt import sed
    d = str(tmp_path / "seds")
    lib = jsed.blackbody_library(lambda age: 1e5 / (1.0 + 10.0 * age),
                                 np.array([0.0, 0.001, 0.01, 0.1, 1.0]),
                                 np.array([0.001, 0.02]))
    jsed.write_sed_dir(d, lib)
    plib = sed.blackbody_library(lambda age: 1e5 / (1.0 + 10.0 * age),
                                 np.array([0.0, 0.001, 0.01, 0.1, 1.0]),
                                 np.array([0.001, 0.02]))
    assert np.array_equal(plib.seds, lib.seds)
    # the port reads the directory from RAMSES_SED_DIR when given none
    monkeypatch.setenv("RAMSES_SED_DIR", d)
    got = sed.read_sed_dir("")
    assert np.array_equal(got.seds, lib.seds)
    want = jsed.SedTables(jsed.read_sed_dir(d), jspec.DEFAULT_BOUNDS)
    tab = sed.SedTables(got, jspec.DEFAULT_BOUNDS)
    for k in ("lphot", "egy", "csn", "cse"):
        assert np.array_equal(getattr(tab, k), getattr(want, k))
    age = np.array([0.0, 0.0005, 0.05, 2.0])
    Z = np.array([0.0001, 0.01, 0.02, 0.05])
    m = np.array([1.0, 10.0, 100.0, 1e4])
    assert np.array_equal(tab.star_rates(age, Z, m),
                          want.star_rates(age, Z, m))
    for a, b in zip(tab.population_groups(age, Z, m),
                    want.population_groups(age, Z, m)):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
