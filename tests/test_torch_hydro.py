"""Parity of the port's hydro primitives with the JAX package in f64.

Same seeded numpy inputs through ``ramses_tpu`` and ``ramses_tpu_torch``
(CPU tensors) in 1D, 2D and 3D on 8–16-cell grids: the Riemann solvers,
``muscl.unsplit`` + ``apply_fluxes``, ``compute_dt`` and ``boundary.pad``
for every boundary kind.  Both sides run the same algorithm in the same
order, so the tolerance is 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.config import Params  # noqa: E402
from ramses_tpu.grid import boundary as jbmod  # noqa: E402
from ramses_tpu.hydro import muscl as jmuscl  # noqa: E402
from ramses_tpu.hydro import riemann as jriemann  # noqa: E402
from ramses_tpu.hydro import timestep as jtimestep  # noqa: E402
from ramses_tpu.hydro.core import HydroStatic as JHydroStatic  # noqa: E402

from ramses_tpu_torch.convert import hydro_static_from  # noqa: E402
from ramses_tpu_torch.grid import boundary as bmod  # noqa: E402
from ramses_tpu_torch.hydro import muscl, riemann, timestep  # noqa: E402

RTOL = 1e-12
SHAPES = {1: (16,), 2: (12, 8), 3: (8, 8, 8)}


def _cfg(ndim, **hydro):
    p = Params(ndim=ndim)
    for k, v in hydro.items():
        setattr(p.hydro, k, v)
    return JHydroStatic.from_params(p)


def _state(cfg, shape, seed=0):
    """Physically valid random conservative state [nvar, *shape]."""
    rng = np.random.default_rng(seed)
    nd = cfg.ndim
    r = 1.0 + 0.5 * rng.random(shape)
    v = 0.3 * rng.standard_normal((nd,) + shape)
    p = 0.2 + rng.random(shape)
    e = p / (cfg.gamma - 1.0) + 0.5 * r * (v ** 2).sum(axis=0)
    return np.stack([r, *(r * v), e])


def _close(got, want, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=atol)


def _iface_state(ndim, n, seed):
    """Random interface-layout primitive states (rho, u_n, P, u_t...)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((ndim + 2, n))
    q[0] = 0.5 + rng.random(n)
    q[2] = 0.1 + rng.random(n)
    return q


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("solver", ["llf", "hll", "hllc"])
def test_riemann_matches_jax(solver, ndim):
    cfg = _cfg(ndim, riemann=solver)
    ql = _iface_state(ndim, 64, seed=ndim)
    qr = _iface_state(ndim, 64, seed=10 + ndim)
    ql[:, :4] = qr[:, :4]                   # some exactly degenerate faces
    want = getattr(jriemann, f"riemann_{solver}")(jnp.asarray(ql),
                                                  jnp.asarray(qr), cfg)
    got = riemann.solve(torch.from_numpy(ql), torch.from_numpy(qr),
                        hydro_static_from(cfg))
    _close(got, want, atol=1e-14)


@pytest.mark.parametrize("solver", ["exact", "acoustic"])
def test_riemann_unported_raise(solver):
    """The two solvers the port refused until it ported them: they no
    longer raise, and match the JAX package's (also on exactly
    degenerate faces)."""
    cfg = _cfg(1, riemann=solver)
    ql = _iface_state(1, 64, seed=30)
    qr = _iface_state(1, 64, seed=31)
    ql[:, :4] = qr[:, :4]
    want = jriemann.SOLVERS[solver](jnp.asarray(ql), jnp.asarray(qr), cfg)
    got = riemann.solve(torch.from_numpy(ql), torch.from_numpy(qr),
                        hydro_static_from(cfg))
    _close(got, want, atol=1e-14)


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("riemann_name,slope_type",
                         [("llf", 1), ("hllc", 2), ("hll", 0), ("hllc", 7),
                          ("llf", 8)])
def test_unsplit_apply_fluxes_matches_jax(ndim, riemann_name, slope_type):
    cfg = _cfg(ndim, riemann=riemann_name, slope_type=slope_type)
    tcfg = hydro_static_from(cfg)
    shape = SHAPES[ndim]
    u = _state(cfg, shape, seed=ndim + slope_type)
    bc = jbmod.BoundarySpec.periodic(ndim)
    tbc = bmod.BoundarySpec.periodic(ndim)
    dt, dx = 2e-3, (1.0 / shape[0],) * ndim
    up = jbmod.pad(jnp.asarray(u), bc, cfg, jmuscl.NGHOST)
    flux, tmp = jmuscl.unsplit(up, None, jnp.asarray(dt), dx, cfg)
    want = jmuscl.apply_fluxes(up, flux, cfg)
    tup = bmod.pad(torch.from_numpy(u), tbc, tcfg, muscl.NGHOST)
    tflux, ttmp = muscl.unsplit(tup, None,
                               torch.tensor(dt, dtype=torch.float64), dx, tcfg)
    got = muscl.apply_fluxes(tup, tflux, tcfg)
    _close(tflux, flux, atol=1e-15)
    _close(ttmp, tmp, atol=1e-15)
    _close(bmod.unpad(got, ndim), jbmod.unpad(want, ndim))


def test_muscl_unported_raise():
    """The options the port refused until it ported them (positivity
    slopes, the PLMDE predictor, the dual-energy fix): they no longer
    raise, and match the JAX package's on a 2D state."""
    jc = _cfg(2, slope_type=3, pressure_fix=True)
    cfg = hydro_static_from(jc)
    u = _state(jc, SHAPES[2], seed=40)
    q, c = jmuscl.ctoprim(jnp.asarray(u), None, 0.1, jc)
    tq, tc = muscl.ctoprim(torch.from_numpy(u), None, 0.1, cfg)
    dq = jmuscl.uslope(q, jc)
    tdq = muscl.uslope(tq, cfg)
    _close(tdq, dq, atol=1e-15)
    want = jmuscl.trace_plmde(q, c, dq, 0.1, (0.1, 0.1), jc)
    got = muscl.trace_plmde(tq, tc, tdq, 0.1, (0.1, 0.1), cfg)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-15)
    tmp = np.random.default_rng(41).standard_normal((2, 2) + SHAPES[2])
    want = jmuscl.dual_energy_fix(jnp.asarray(u), jnp.asarray(u) * 1.01,
                                  jnp.asarray(tmp), 0.1, (0.1, 0.1), jc)
    got = muscl.dual_energy_fix(torch.from_numpy(u),
                                torch.from_numpy(u) * 1.01,
                                torch.from_numpy(tmp), 0.1, (0.1, 0.1), cfg)
    _close(got, want, atol=1e-14)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_compute_dt_matches_jax(ndim):
    cfg = _cfg(ndim, courant_factor=0.8)
    u = _state(cfg, SHAPES[ndim], seed=20 + ndim)
    dx = 0.5 / SHAPES[ndim][0]
    want = jtimestep.compute_dt(jnp.asarray(u), None, dx, cfg)
    got = timestep.compute_dt(torch.from_numpy(u), None, dx,
                              hydro_static_from(cfg))
    assert got.dim() == 0
    _close(got, want)
    _close(timestep.cell_dt(torch.from_numpy(u), None, dx,
                            hydro_static_from(cfg)),
           jtimestep.cell_dt(jnp.asarray(u), None, dx, cfg))


def _faces(mod, kind, ndim):
    vals = (1.3, *([0.2, -0.1, 0.05][:ndim]), 0.7) if kind == 3 else ()
    f = mod.FaceBC(kind=kind, values=vals)
    per = mod.FaceBC()
    # the kind on the low x face and the high face of the last axis
    faces = [[per, per] for _ in range(ndim)]
    faces[0][0] = f
    faces[-1][1] = f
    return mod.BoundarySpec(faces=tuple(tuple(fs) for fs in faces))


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_pad_matches_jax(kind, ndim):
    cfg = _cfg(ndim)
    u = _state(cfg, SHAPES[ndim], seed=30 + kind)
    want = jbmod.pad(jnp.asarray(u), _faces(jbmod, kind, ndim), cfg, 2)
    got = bmod.pad(torch.from_numpy(u), _faces(bmod, kind, ndim),
                   hydro_static_from(cfg), 2)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(bmod.unpad(got, ndim).numpy(), u)


def test_boundary_from_params_matches_jax():
    from ramses_tpu.config import params_from_string as jparams
    from ramses_tpu_torch.config import params_from_string
    text = """&BOUNDARY_PARAMS
nboundary=2
ibound_min=-1,+1
ibound_max=-1,+1
bound_type=1,3
d_bound=0.0,2.0
p_bound=0.0,0.5
/"""
    want = jbmod.BoundarySpec.from_params(jparams(text, ndim=2))
    got = bmod.BoundarySpec.from_params(params_from_string(text, ndim=2))
    assert got.kinds == ((1, 3), (0, 0))
    assert [[(f.kind, f.values) for f in pair] for pair in got.faces] == \
        [[(f.kind, f.values) for f in pair] for pair in want.faces]
