"""Parity of the port's AMR sweep kernels K3 and K2 with the JAX package's.

The JAX side runs ``pallas_oct.tile_sweep`` and ``pallas_oct.oct_sweep`` in
Pallas interpreter mode, as ``tests/test_oct_blocking.py`` does; the
port's side runs ``tile_sweep`` / ``oct_sweep`` on CPU tensors, which are
their plain versions ``tile_sweep_ref`` / ``oct_sweep_ref`` (K3's batch
axis just before the cell axes, ``movedim`` of the JAX package's last).  The CUDA
kernels are held against the same plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.  Tolerances are the
table of ``tests/test_pallas_kernel.py``: rtol 2e-5 / atol 2e-6 for
``du`` and for the flux planes and sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.config import Params  # noqa: E402
from ramses_tpu.hydro import pallas_oct  # noqa: E402
from ramses_tpu.hydro.core import HydroStatic as JHydroStatic  # noqa: E402

from ramses_tpu_torch.convert import hydro_static_from  # noqa: E402
from ramses_tpu_torch.hydro import oct_muscl as om  # noqa: E402

RTOL, ATOL = 2e-5, 2e-6
DX = 1.0 / 32


def _cfg(riemann, slope_type):
    p = Params(ndim=3)
    p.hydro.riemann = riemann
    p.hydro.slope_type = slope_type
    return JHydroStatic.from_params(p)


def _batch(block, n, gamma, seed, masked):
    rng = np.random.default_rng(seed)
    shape = (block,) * 3 + (n,)
    r = 1.0 + 0.3 * rng.random(shape)
    v = 0.2 * rng.standard_normal((3,) + shape)
    p = 0.5 + 0.2 * rng.random(shape)
    e = p / (gamma - 1.0) + 0.5 * r * (v ** 2).sum(axis=0)
    u = np.stack([r, r * v[0], r * v[1], r * v[2], e]).astype(np.float32)
    ok = (rng.random(shape) < (0.15 if masked else 0.0)).astype(np.float32)
    return u, ok


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _tiles(u, ok):
    """K3's tile-major layout of a batch-last batch."""
    return (torch.from_numpy(u).movedim(-1, 1),
            torch.from_numpy(ok).movedim(-1, 0))


def _batch_last(outs):
    """K3's results in the JAX package's layout, batch last."""
    return [o.movedim(2 if i == 1 else 1, -1) for i, o in enumerate(outs)]


@pytest.mark.parametrize("shift,riemann,slope_type,masked", [
    (1, "llf", 1, True),
    (1, "hllc", 8, False),
    (2, "hllc", 2, True),
    (2, "llf", 2, False),
])
def test_tile_sweep_ref_matches_pallas(shift, riemann, slope_type, masked):
    jcfg = _cfg(riemann, slope_type)
    td = (1 << (shift + 1)) + 4
    u, ok = _batch(td, 8, jcfg.gamma, 10 * shift + slope_type, masked)
    dt = 2e-3
    want = pallas_oct.tile_sweep(jnp.asarray(u), jnp.asarray(ok),
                                 jnp.float32(dt), jcfg, DX, shift,
                                 interpret=True)
    got = om.tile_sweep(*_tiles(u, ok),
                        torch.tensor(dt, dtype=torch.float32),
                        hydro_static_from(jcfg), DX, shift)
    c = 1 << (shift + 1)
    assert tuple(got[0].shape) == (5, 8, c, c, c)
    assert tuple(got[1].shape) == (5, 3, 8, c // 2 + 1, c, c)
    got = _batch_last(got)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("riemann,slope_type", [("llf", 1), ("hllc", 8)])
def test_oct_sweep_ref_matches_pallas(riemann, slope_type):
    jcfg = _cfg(riemann, slope_type)
    u, ok = _batch(6, 128, jcfg.gamma, slope_type, True)
    dt = 2e-3
    want = pallas_oct.oct_sweep(jnp.asarray(u), jnp.asarray(ok),
                                jnp.float32(dt), jcfg, DX, interpret=True)
    got = om.oct_sweep(torch.from_numpy(u), torch.from_numpy(ok),
                       torch.tensor(dt, dtype=torch.float32),
                       hydro_static_from(jcfg), DX)
    assert tuple(got[1].shape) == (5, 3, 2, 128)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("shift,riemann,masked", [
    (1, "hllc", True), (2, "llf", False)])
def test_tile_sweep_ref_want_flux_matches_pallas(shift, riemann, masked):
    """phip [3, N, c+1, c, c]: every cell-face mass-flux plane."""
    jcfg = _cfg(riemann, 2)
    td = (1 << (shift + 1)) + 4
    u, ok = _batch(td, 8, jcfg.gamma, 40 + shift, masked)
    dt = 2e-3
    want = pallas_oct.tile_sweep(jnp.asarray(u), jnp.asarray(ok),
                                 jnp.float32(dt), jcfg, DX, shift,
                                 interpret=True, want_flux=True)
    got = om.tile_sweep(*_tiles(u, ok),
                        torch.tensor(dt, dtype=torch.float32),
                        hydro_static_from(jcfg), DX, shift, want_flux=True)
    c = 1 << (shift + 1)
    assert tuple(got[2].shape) == (3, 8, c + 1, c, c)
    for g, w in zip(_batch_last(got), want):
        _close(g, w)


@pytest.mark.parametrize("riemann,masked", [("llf", True), ("hllc", False)])
def test_oct_sweep_ref_want_flux_matches_pallas(riemann, masked):
    """phi [3, 2, 2, 2, 2, N]: each interior cell's (low, high) faces."""
    jcfg = _cfg(riemann, 1)
    u, ok = _batch(6, 128, jcfg.gamma, 50, masked)
    dt = 2e-3
    want = pallas_oct.oct_sweep(jnp.asarray(u), jnp.asarray(ok),
                                jnp.float32(dt), jcfg, DX, interpret=True,
                                want_flux=True)
    got = om.oct_sweep(torch.from_numpy(u), torch.from_numpy(ok),
                       torch.tensor(dt, dtype=torch.float32),
                       hydro_static_from(jcfg), DX, want_flux=True)
    assert tuple(got[2].shape) == (3, 2, 2, 2, 2, 128)
    for g, w in zip(got, want):
        _close(g, w)


def test_plain_versions_are_no_launch_and_return_want_flux():
    """On the CPU the wrappers run the plain versions, which never count a
    launch; with ``want_flux`` they return the mass fluxes too, of the
    kernels' shapes, beside the same du and corrections."""
    cfg = hydro_static_from(_cfg("llf", 1))
    u, ok = _batch(6, 8, cfg.gamma, 0, True)
    args = (torch.from_numpy(u), torch.from_numpy(ok), torch.tensor(1e-3))
    before = dict(om.launches)
    du, corr = om.oct_sweep(*args, cfg, DX)
    assert torch.isfinite(du).all() and torch.isfinite(corr).all()
    targs = _tiles(u, ok) + args[2:]
    du_t, planes = om.tile_sweep(*targs, cfg, DX, 0)
    assert tuple(planes.shape) == (5, 3, 8, 2, 2, 2)
    du_tf, planes_f, phip = om.tile_sweep(*targs, cfg, DX, 0, want_flux=True)
    assert tuple(phip.shape) == (3, 8, 3, 2, 2)
    du_f, corr_f, phi = om.oct_sweep(*args, cfg, DX, want_flux=True)
    assert tuple(phi.shape) == (3, 2, 2, 2, 2, 8)
    assert torch.equal(du_f, du) and torch.equal(corr_f, corr)
    assert torch.equal(du_tf, du_t) and torch.equal(planes_f, planes)
    assert om.launches == before
    # shift 0: the tile's planes 0 and 2 are the oct's per-oct faces (the
    # mass column of the correction planes), and each cell's net face
    # flux is its mass update
    torch.testing.assert_close(phip[:, :, ::2], planes[0])
    net = (phi[:, 0] - phi[:, 1]).sum(dim=0)
    torch.testing.assert_close(du[0], net, rtol=1e-5, atol=1e-7)


def test_supports_is_the_physics_scope():
    base = hydro_static_from(_cfg("hllc", 2))
    assert om.supports(base, torch.float32)
    assert not om.supports(base, torch.float64)
    for kw in ({"ndim": 2}, {"npassive": 1}, {"pressure_fix": True},
               {"slope_type": 7}, {"riemann": "hll"}, {"scheme": "plmde"}):
        assert not om.supports(base.__class__(**{**base.__dict__, **kw}),
                               torch.float32), kw


def test_shift0_tile_sweep_equals_oct_sweep_on_one_oct_tiles():
    """A shift-0 tile is one oct with its 2-cell halo, i.e. the oct's
    6^3 stencil: K3's face planes then hold exactly the per-oct faces
    whose 2x2 sums K2 returns."""
    cfg = hydro_static_from(_cfg("hllc", 1))
    u, ok = _batch(6, 16, cfg.gamma, 3, True)
    args = (torch.from_numpy(u).double(), torch.from_numpy(ok).double(),
            torch.tensor(1e-3, dtype=torch.float64))
    du_t, planes = om.tile_sweep_ref(args[0].movedim(-1, 1),
                                     args[1].movedim(-1, 0), args[2], cfg,
                                     DX, 0)
    du_o, corr = om.oct_sweep_ref(*args, cfg, DX)
    torch.testing.assert_close(du_t.movedim(1, -1), du_o, rtol=0, atol=0)
    torch.testing.assert_close(planes.sum(dim=(4, 5)).movedim(2, -1), corr,
                               rtol=1e-14, atol=1e-16)
