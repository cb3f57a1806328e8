"""Parity of the port's fused MUSCL step with the JAX package's TPU kernel.

The JAX side runs ``pallas_muscl.fused_step_padded`` in Pallas interpreter
mode, as ``tests/test_pallas_kernel.py`` does; the port's side runs
``fused_step`` on CPU tensors, which is its plain version
``fused_step_ref``.  The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.  Tolerances are the table of
``tests/test_pallas_kernel.py``: rtol 2e-5 / atol 2e-6 for the state and
rel 3e-3 for the Courant dt.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.config import Params  # noqa: E402
from ramses_tpu.grid import boundary as jbmod  # noqa: E402
from ramses_tpu.hydro import pallas_muscl as pk  # noqa: E402
from ramses_tpu.hydro.core import HydroStatic as JHydroStatic  # noqa: E402

from ramses_tpu_torch.convert import hydro_static_from  # noqa: E402
from ramses_tpu_torch.grid import boundary as bmod  # noqa: E402
from ramses_tpu_torch.hydro import fused_muscl as fm  # noqa: E402

SHAPE = (16, 16, 128)

pytestmark = pytest.mark.skipif(
    pk.Element is None,
    reason="pl.Element block mode absent from this jax release")


def _cfg(riemann="llf", slope_type=1):
    p = Params(ndim=3)
    p.hydro.riemann = riemann
    p.hydro.slope_type = slope_type
    return JHydroStatic.from_params(p)


def _state(cfg, seed=0):
    rng = np.random.default_rng(seed)
    r = 1.0 + 0.3 * rng.random(SHAPE)
    v = 0.2 * rng.standard_normal((3,) + SHAPE)
    p_ = 0.5 + 0.2 * rng.random(SHAPE)
    e = p_ / (cfg.gamma - 1.0) + 0.5 * r * (v ** 2).sum(axis=0)
    return np.stack([r, r * v[0], r * v[1], r * v[2], e]).astype(np.float32)


def _port_bc(kinds):
    return bmod.BoundarySpec(faces=tuple(
        (bmod.FaceBC(kind=lo), bmod.FaceBC(kind=hi)) for lo, hi in kinds))


def _jax_bc(kinds):
    return jbmod.BoundarySpec(faces=tuple(
        (jbmod.FaceBC(kind=lo), jbmod.FaceBC(kind=hi)) for lo, hi in kinds))


def _both(cfg, u, dt, kinds, ok=None, courant=False, want_flux=False):
    dx = 1.0 / SHAPE[0]
    up, okp = pk.pad_xy(jnp.asarray(u), _jax_bc(kinds), cfg,
                        ok=None if ok is None else jnp.asarray(ok))
    want = pk.fused_step_padded(up, jnp.asarray(dt, jnp.float32), cfg, dx,
                                SHAPE, ok_pad=okp, courant=courant,
                                interpret=True, want_flux=want_flux)
    got = fm.fused_step(torch.from_numpy(u),
                        torch.tensor(dt, dtype=torch.float32),
                        hydro_static_from(cfg), dx, _port_bc(kinds),
                        ok=None if ok is None else torch.from_numpy(ok),
                        courant=courant, want_flux=want_flux)
    return want, got


PERIODIC = ((0, 0), (0, 0), (0, 0))


@pytest.mark.parametrize("slope_type", [1, 2, 8])
@pytest.mark.parametrize("riemann", ["llf", "hllc"])
def test_fused_step_ref_matches_pallas(riemann, slope_type):
    cfg = _cfg(riemann, slope_type)
    assert fm.supports(hydro_static_from(cfg), SHAPE, PERIODIC,
                       torch.float32)
    u = _state(cfg, seed=slope_type)
    (want, crt), (got, dt_next) = _both(cfg, u, 1e-3, PERIODIC,
                                        courant=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-6)
    dx = 1.0 / SHAPE[0]
    dtmax = cfg.courant_factor * dx / cfg.smallc
    assert float(dt_next) == pytest.approx(
        min(dtmax, float(crt[0, 0])), rel=3e-3)


def test_dt_next_is_scaled_then_clipped():
    """dt_next = min(dtmax, dt_scale * crt), the JAX driver's Pallas loop
    (grid/uniform.py:156), against the Pallas kernel's raw crt."""
    cfg = _cfg("hllc", 2)
    u = _state(cfg, seed=2)
    dx = 1.0 / SHAPE[0]
    up, _ = pk.pad_xy(jnp.asarray(u), _jax_bc(PERIODIC), cfg)
    _, crt = pk.fused_step_padded(up, jnp.asarray(1e-3, jnp.float32), cfg,
                                  dx, SHAPE, courant=True, interpret=True)
    dtmax = cfg.courant_factor * dx / cfg.smallc
    _, dt_next = fm.fused_step(torch.from_numpy(u),
                               torch.tensor(1e-3, dtype=torch.float32),
                               hydro_static_from(cfg), dx, _port_bc(PERIODIC),
                               courant=True, dt_scale=0.5)
    assert float(dt_next) == pytest.approx(
        min(dtmax, 0.5 * float(crt[0, 0])), rel=3e-3)


def test_fused_step_ref_reflecting_xy():
    cfg = _cfg("llf")
    kinds = ((1, 1), (1, 1), (0, 0))
    u = _state(cfg, seed=3)
    want, got = _both(cfg, u, 5e-4, kinds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-6)


def test_fused_step_ref_masked():
    cfg = _cfg("llf")
    u = _state(cfg, seed=7)
    ok = np.random.default_rng(11).random(SHAPE) < 0.1
    want, got = _both(cfg, u, 5e-4, PERIODIC, ok=ok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-6)


def test_fused_step_ref_outflow_x():
    """Outflow faces: pad_xy's edge copy on the JAX side."""
    cfg = _cfg("hllc", 2)
    kinds = ((2, 2), (0, 0), (0, 0))
    u = _state(cfg, seed=5)
    want, got = _both(cfg, u, 5e-4, kinds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("riemann,kinds,masked,courant", [
    ("llf", PERIODIC, True, True),
    ("hllc", PERIODIC, False, False),
    ("hllc", ((1, 1), (2, 2), (0, 0)), True, False),
])
def test_fused_step_ref_want_flux_matches_pallas(riemann, kinds, masked,
                                                 courant):
    """The face mass fluxes (the MC-tracer capture) beside the step, in
    the kernel's output order: un, (dt_next,) phi [3, 2, *shape]."""
    cfg = _cfg(riemann, 2)
    u = _state(cfg, seed=9)
    ok = (np.random.default_rng(12).random(SHAPE) < 0.1) if masked else None
    want, got = _both(cfg, u, 5e-4, kinds, ok=ok, courant=courant,
                      want_flux=True)
    assert len(got) == len(want) == 2 + courant
    assert tuple(got[-1].shape) == (3, 2) + SHAPE
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[-1]),
                               rtol=2e-5, atol=2e-6)
    # the same step as without the fluxes, and each cell's mass update is
    # its net face flux
    plain = fm.fused_step_ref(torch.from_numpy(u), torch.tensor(5e-4),
                              hydro_static_from(cfg), 1.0 / SHAPE[0],
                              _port_bc(kinds),
                              ok=None if ok is None else torch.from_numpy(ok))
    assert torch.equal(got[0], plain)
    net = (got[-1][:, 0] - got[-1][:, 1]).sum(dim=0)
    torch.testing.assert_close(got[0][0] - torch.from_numpy(u[0]), net,
                               rtol=1e-4, atol=2e-6)


def test_supports_scope():
    cfg = hydro_static_from(_cfg("llf"))
    assert fm.supports(cfg, (8, 12, 20), PERIODIC, torch.float32)
    assert not fm.supports(cfg, SHAPE, PERIODIC, torch.float64)
    assert not fm.supports(cfg, SHAPE, ((3, 3), (0, 0), (0, 0)),
                           torch.float32)
    import dataclasses
    assert not fm.supports(dataclasses.replace(cfg, riemann="hll"), SHAPE,
                           PERIODIC, torch.float32)
    assert not fm.supports(dataclasses.replace(cfg, npassive=1), SHAPE,
                           PERIODIC, torch.float32)
    assert not fm.supports(dataclasses.replace(cfg, ndim=2), SHAPE[:2],
                           PERIODIC[:2], torch.float32)
