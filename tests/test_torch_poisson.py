"""The port's Poisson layer (``ramses_tpu_torch.poisson``) against the JAX
package's ``ramses_tpu.poisson``, on the CPU in f64.

The same seeded numpy inputs go through both packages:

* ``solver``: every function in 2D (32×16) and 3D (16³) within 1e-12 of
  the field's max; ``fft_solve`` within 1e-10 (``torch.fft`` and
  ``jnp.fft`` round differently);
* ``force`` and ``gravana`` (each analytic type) within 1e-12;
* ``isolated``: the multipole moments and potential within 1e-12, the
  isolated solve and its force within 1e-10;
* ``coupling.kick`` and ``amr_solve``'s operators (``laplacian``,
  ``cg_level``, ``pcg_level``, ``grad_phi``, ``grad_dense``,
  ``kick_flat``) on a small masked level within 1e-12, ``pcg_level``
  with equal iteration counts.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.hydro.core import HydroStatic as JHydroStatic  # noqa: E402
from ramses_tpu.poisson import amr_solve as jgs  # noqa: E402
from ramses_tpu.poisson import coupling as jcoup  # noqa: E402
from ramses_tpu.poisson import force as jforce  # noqa: E402
from ramses_tpu.poisson import gravana as jgrav  # noqa: E402
from ramses_tpu.poisson import isolated as jiso  # noqa: E402
from ramses_tpu.poisson import solver as jsol  # noqa: E402

from ramses_tpu_torch.hydro.core import HydroStatic  # noqa: E402
from ramses_tpu_torch.poisson import amr_solve as pgs  # noqa: E402
from ramses_tpu_torch.poisson import coupling as pcoup  # noqa: E402
from ramses_tpu_torch.poisson import force as pforce  # noqa: E402
from ramses_tpu_torch.poisson import gravana as pgrav  # noqa: E402
from ramses_tpu_torch.poisson import isolated as piso  # noqa: E402
from ramses_tpu_torch.poisson import solver as psol  # noqa: E402

SHAPES = [(32, 16), (16, 16, 16)]
IDS = ["2d", "3d"]
TIGHT = 1e-12            # same operations in the same order
FFT = 1e-10              # torch.fft against jnp.fft


def _field(shape, seed, zero_mean=True):
    a = np.random.default_rng(seed).standard_normal(shape)
    return a - a.mean() if zero_mean else a


def _rel(got, want, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"max|Δ|/max|want| = {err:.3e} > {tol:.0e}"


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_operators_match(shape):
    """laplacian, residual, the parity mask, restrict, prolong and the
    level count."""
    phi, rhs = _field(shape, 1), _field(shape, 2)
    dx = 1.0 / shape[0]
    _rel(psol.laplacian(_t(phi), dx), jsol.laplacian(jnp.asarray(phi), dx),
         TIGHT)
    _rel(psol.residual(_t(phi), _t(rhs), dx),
         jsol.residual(jnp.asarray(phi), jnp.asarray(rhs), dx), TIGHT)
    assert np.array_equal(psol._parity_mask(shape).numpy(),
                          np.asarray(jsol._parity_mask(shape)))
    _rel(psol.restrict(_t(rhs)), jsol.restrict(jnp.asarray(rhs)), TIGHT)
    coarse = _field(tuple(n // 2 for n in shape), 3)
    _rel(psol.prolong(_t(coarse), shape),
         jsol.prolong(jnp.asarray(coarse), shape), TIGHT)
    assert psol._mg_levels(shape) == jsol._mg_levels(shape)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_smoother_and_vcycle_match(shape):
    phi, rhs = _field(shape, 4), _field(shape, 5)
    dx = 1.0 / shape[0]
    _rel(psol.gauss_seidel(_t(phi), _t(rhs), dx, 3),
         jsol.gauss_seidel(jnp.asarray(phi), jnp.asarray(rhs), dx, 3), TIGHT)
    nl = psol._mg_levels(shape)
    _rel(psol.vcycle(_t(phi), _t(rhs), dx, nl),
         jsol.vcycle(jnp.asarray(phi), jnp.asarray(rhs), dx, nl), TIGHT)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_mg_and_cg_solve_match(shape):
    rhs = _field(shape, 6, zero_mean=False)
    dx = 1.0 / shape[0]
    phi0 = _field(shape, 7)
    _rel(psol.mg_solve(_t(rhs), dx, ncycle=4),
         jsol.mg_solve(jnp.asarray(rhs), dx, ncycle=4), TIGHT)
    _rel(psol.mg_solve(_t(rhs), dx, phi0=_t(phi0), ncycle=2),
         jsol.mg_solve(jnp.asarray(rhs), dx, phi0=jnp.asarray(phi0),
                       ncycle=2), TIGHT)
    # tol 1e-6 freezes the iteration part way; 0 runs to rounding level
    for tol in (1e-6, 0.0):
        _rel(psol.cg_solve(_t(rhs), dx, iters=60, tol=tol),
             jsol.cg_solve(jnp.asarray(rhs), dx, iters=60, tol=tol), 1e-10)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_fft_solve_matches_and_solves(shape):
    rhs = _field(shape, 8)
    dx = 1.0 / shape[0]
    got = psol.fft_solve(_t(rhs), dx)
    _rel(got, jsol.fft_solve(jnp.asarray(rhs), dx), FFT)
    # the same discrete equations as MG/CG
    _rel(psol.laplacian(got, dx), rhs, 1e-10)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_force_matches(shape):
    phi = _field(shape, 9)
    dx = 1.0 / shape[0]
    _rel(pforce.gradient_phi(_t(phi), dx),
         jforce.gradient_phi(jnp.asarray(phi), dx), TIGHT)
    _rel(pforce.force(_t(phi), dx), jforce.force(jnp.asarray(phi), dx),
         TIGHT)


@pytest.mark.parametrize("gtype,params", [
    (1, (0.3, -0.2, 0.1)),
    (2, (2.0, 0.05, 0.4, 0.55, 0.6)),
    (3, (1.5, 0.7, 0.1)),
], ids=["constant", "point-mass", "galactic"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_gravana_matches(shape, gtype, params):
    dx = 1.0 / shape[0]
    xp = pgrav.cell_centers(shape, dx)
    xj = jgrav.cell_centers(shape, dx)
    _rel(xp, xj, TIGHT)
    _rel(pgrav.gravana(xp, gtype, params, 1.0),
         jgrav.gravana(xj, gtype, params, 1.0), TIGHT)


def _blob(shape, seed):
    """A positive density with a lump off the centre."""
    dx = 1.0 / shape[0]
    x = np.stack(np.meshgrid(*[(np.arange(n) + 0.5) * dx for n in shape],
                             indexing="ij"))
    c = np.array([0.45, 0.55, 0.5][:len(shape)]).reshape(
        (-1,) + (1,) * len(shape))
    r2 = ((x - c) ** 2).sum(axis=0)
    noise = 0.05 * np.random.default_rng(seed).random(shape)
    return 0.1 + 5.0 * np.exp(-r2 / 0.01) + noise, dx


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_isolated_matches(shape):
    rho, dx = _blob(shape, 10)
    coeff = 4.0 * np.pi
    mp = piso.multipole_moments(_t(rho), dx)
    mj = jiso.multipole_moments(jnp.asarray(rho), dx)
    for a, b in zip(mp, mj):
        if b is not None:
            _rel(a, b, TIGHT)
    pts = np.random.default_rng(11).random((40, len(shape))) * 1.4 - 0.2
    _rel(piso.multipole_phi(_t(rho), dx, coeff, _t(pts)),
         jiso.multipole_phi(jnp.asarray(rho), dx, coeff, jnp.asarray(pts)),
         TIGHT)
    for d in range(len(shape)):
        for side in (0, 1):
            _rel(piso._face_points(shape, dx, d, side, torch.float64),
                 jiso._face_points(shape, dx, d, side, jnp.float64), TIGHT)
    _rel(piso.lap_dirichlet0(_t(rho), dx),
         jiso.lap_dirichlet0(jnp.asarray(rho), dx), TIGHT)
    phi, gh = piso.isolated_solve(_t(rho), dx, coeff, iters=80, tol=1e-8)
    jphi, jgh = jiso.isolated_solve(jnp.asarray(rho), dx, coeff, iters=80,
                                    tol=1e-8)
    _rel(phi, jphi, FFT)
    for d in range(len(shape)):
        for side in (0, 1):
            _rel(gh[d][side], jgh[d][side], TIGHT)
    _rel(piso.grad_isolated(phi, gh, dx),
         jiso.grad_isolated(jphi, jgh, dx), FFT)


@pytest.mark.parametrize("ndim", [2, 3])
def test_kick_and_pad_force_match(ndim):
    shape = (8,) * ndim
    rng = np.random.default_rng(12)
    u = np.concatenate([1.0 + rng.random((1,) + shape),
                        rng.standard_normal((ndim,) + shape),
                        2.0 + rng.random((1,) + shape),
                        rng.random((1,) + shape)])
    f = rng.standard_normal((ndim,) + shape)
    kw = dict(ndim=ndim, npassive=1)
    _rel(pcoup.kick(_t(u), _t(f), 0.013, HydroStatic(**kw)),
         jcoup.kick(jnp.asarray(u), jnp.asarray(f), 0.013,
                    JHydroStatic(**kw)), TIGHT)
    for mode in ("wrap", "edge"):
        _rel(pcoup._pad_force(_t(f), ndim, mode),
             jcoup._pad_force(jnp.asarray(f), ndim, mode), 0.0)


def _level(ndim: int, seed: int):
    """A masked level's face-neighbour maps by hand: the cells of a
    periodic 8^ndim box inside a ball are the level, the rest its ghosts
    (every ghost its own row), and the oct lattice the box's 4^ndim."""
    n, ttd = 8, 2 ** ndim
    coords = np.indices((n,) * ndim).reshape(ndim, -1).T
    octs = coords >> 1
    off = ((coords & 1) * (1 << np.arange(ndim)[::-1])).sum(axis=1)
    flat = (np.ravel_multi_index(octs.T, (n // 2,) * ndim) * ttd + off)
    r2 = (((coords + 0.5) / n - 0.5) ** 2).sum(axis=1)
    inside = np.zeros(len(coords), bool)
    inside[flat] = r2 < 0.16
    oct_in = inside.reshape(-1, ttd).any(axis=1)
    inside = np.repeat(oct_in, ttd)          # whole octs
    ncell = len(coords)
    row = np.empty(ncell, np.int64)
    row[flat] = np.arange(ncell)
    ghost_of = {}
    nb = np.zeros((ncell, ndim, 2), np.int64)
    for c, fl in zip(coords, flat):
        for d in range(ndim):
            for side, s in ((0, -1), (1, 1)):
                q = c.copy()
                q[d] = (q[d] + s) % n
                qf = flat[np.ravel_multi_index(q, (n,) * ndim)]
                if inside[qf]:
                    nb[fl, d, side] = qf
                else:
                    nb[fl, d, side] = ncell + ghost_of.setdefault(
                        qf, len(ghost_of))
    valid = inside.copy()
    nb[~valid] = ncell + len(ghost_of)            # pad rows → zero
    noct = ncell // ttd
    ocoords = np.indices((n // 2,) * ndim).reshape(ndim, -1).T
    oct_nb = np.full((noct, ndim, 2), noct, np.int64)
    for o, c in enumerate(ocoords):
        if not oct_in[o]:
            continue
        for d in range(ndim):
            for side, s in ((0, -1), (1, 1)):
                q = c.copy()
                q[d] = (q[d] + s) % (n // 2)
                qo = np.ravel_multi_index(q, (n // 2,) * ndim)
                if oct_in[qo]:
                    oct_nb[o, d, side] = qo
    rng = np.random.default_rng(seed)
    return dict(nb=nb, valid=valid, oct_nb=oct_nb, ncell=ncell,
                ghosts=rng.standard_normal(len(ghost_of)),
                rhs=np.where(valid, rng.standard_normal(ncell), 0.0),
                dx=1.0 / n)


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("ndim", [2, 3])
def test_amr_operators_match(ndim):
    lv = _level(ndim, 13)
    nb, valid, dx = lv["nb"], lv["valid"], lv["dx"]
    phi = np.random.default_rng(14).standard_normal(lv["ncell"])
    g = lv["ghosts"]
    _rel(pgs.laplacian(_t(phi), _t(g), torch.from_numpy(nb), dx,
                       torch.from_numpy(valid), ndim),
         jgs.laplacian(_j(phi), _j(g), _j(nb), dx, _j(valid), ndim), TIGHT)
    _rel(pgs.grad_phi(_t(phi), _t(g), torch.from_numpy(nb), dx,
                      torch.from_numpy(valid), ndim),
         jgs.grad_phi(_j(phi), _j(g), _j(nb), dx, _j(valid), ndim), TIGHT)
    dense = _field((8,) * ndim, 15)
    _rel(pgs.grad_dense(_t(dense), dx, ndim),
         jgs.grad_dense(_j(dense), dx, ndim), TIGHT)
    _rel(pgs.cg_level(_t(lv["rhs"]), _t(g), torch.from_numpy(nb), dx,
                      torch.from_numpy(valid), ndim, iters=30),
         jgs.cg_level(_j(lv["rhs"]), _j(g), _j(nb), dx, _j(valid), ndim,
                      iters=30), 1e-10)


@pytest.mark.parametrize("ndim", [2, 3])
def test_pcg_level_matches(ndim):
    """The two-level preconditioner (no ladder) on the hand-built level,
    cold and warm started: equal live iteration counts, phi within 1e-9."""
    lv = _level(ndim, 16)
    args_p = (_t(lv["rhs"]), _t(lv["ghosts"]), torch.from_numpy(lv["nb"]),
              torch.from_numpy(lv["oct_nb"]), lv["dx"],
              torch.from_numpy(lv["valid"]), ndim)
    args_j = (_j(lv["rhs"]), _j(lv["ghosts"]), _j(lv["nb"]),
              _j(lv["oct_nb"]), lv["dx"], _j(lv["valid"]), ndim)
    phi0 = np.where(lv["valid"], 0.01 * np.random.default_rng(17)
                    .standard_normal(lv["ncell"]), 0.0)
    for kw_p, kw_j in (({}, {}), ({"phi0": _t(phi0)},
                                  {"phi0": _j(phi0)})):
        got, nit = pgs.pcg_level(*args_p, tol=1e-8, iters=40, **kw_p)
        want, jnit = jgs.pcg_level(*args_j, tol=1e-8, iters=40, **kw_j)
        assert int(nit) == int(jnit) and 0 < int(nit) < 40, (nit, jnit)
        _rel(got, want, 1e-9)


@pytest.mark.parametrize("ndim", [2, 3])
def test_kick_flat_matches(ndim):
    rng = np.random.default_rng(18)
    n = 50
    u = np.concatenate([1.0 + rng.random((n, 1)),
                        rng.standard_normal((n, ndim)),
                        2.0 + rng.random((n, 2))], axis=1)
    f = rng.standard_normal((n, ndim))
    _rel(pgs.kick_flat(_t(u), _t(f), 0.021, ndim, 1e-10),
         jgs.kick_flat(_j(u), _j(f), 0.021, ndim, 1e-10), TIGHT)
