"""The port's slab-sharded layer (``ramses_tpu_torch.parallel``) against the
JAX package's ``ramses_tpu.parallel``, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's side on 8 shards of the CPU (``ShardMesh(["cpu"] * 8)``).  The
same inputs, made with numpy from a seed, go to both; states cross through
``ramses_tpu_torch.convert``.

* the exchange (K5's plain version on the ``dma`` backend, with
  ``FORCE_INTERPRET`` on both sides, as ``tests/test_dma_halo.py`` runs the
  Pallas kernel): bitwise equal to JAX's ``exchange_slabs``;
* ``run_steps_halo``, ``dense_sweep_slab`` and ``ShardedAmrSim``: within
  rtol 1e-10 / atol 1e-14 of the JAX functions in f64 (the roundoff of a
  different summation order; the reference's own 3D slab pins are red on
  jax 0.9.0, ROADMAP "A caveat for choosing oracles"), and bitwise equal to
  the port's own single-device formulation, in f64 and through K1's padded
  plain version in f32;
* the bitperm slab functions bitwise against JAX's;
* every refusal by name.
"""

import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr import bitperm as jbitperm  # noqa: E402
from ramses_tpu.amr import kernels as JK  # noqa: E402
from ramses_tpu.config import params_from_string as jparams  # noqa: E402
from ramses_tpu.driver import Simulation as JSimulation  # noqa: E402
from ramses_tpu.hydro.core import HydroStatic as JHydroStatic  # noqa: E402
from ramses_tpu.parallel import dense_slab as JDS  # noqa: E402
from ramses_tpu.parallel import dma_halo as jdma  # noqa: E402
from ramses_tpu.parallel.amr_sharded import \
    ShardedAmrSim as JShardedAmrSim  # noqa: E402
from ramses_tpu.parallel.halo import make_halo_mesh  # noqa: E402
from ramses_tpu.parallel.halo import run_steps_halo as jrun_steps_halo  # noqa
from ramses_tpu.parallel.mesh import OCT_AXIS, oct_mesh  # noqa: E402

from ramses_tpu_torch.amr import bitperm  # noqa: E402
from ramses_tpu_torch.amr import kernels as K  # noqa: E402
from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import params_from_string  # noqa: E402
from ramses_tpu_torch.convert import (amr_state_from, gather_shards,  # noqa
                                      shards_from_numpy)
from ramses_tpu_torch.driver import Simulation  # noqa: E402
from ramses_tpu_torch.grid import boundary as bmod  # noqa: E402
from ramses_tpu_torch.grid.uniform import run_steps  # noqa: E402
from ramses_tpu_torch.hydro.core import HydroStatic  # noqa: E402
from ramses_tpu_torch.parallel import dense_slab as DS  # noqa: E402
from ramses_tpu_torch.parallel import dma_halo  # noqa: E402
from ramses_tpu_torch.parallel.amr_sharded import ShardedAmrSim  # noqa: E402
from ramses_tpu_torch.parallel.halo import run_steps_halo  # noqa: E402
from ramses_tpu_torch.parallel.mesh import ShardMesh, factorize  # noqa: E402

RTOL, ATOL = 1e-10, 1e-14
NSHARD = 8
needs8 = pytest.mark.skipif(jax.device_count() < NSHARD,
                            reason="needs the 8-device mesh")


def _mesh(n=NSHARD):
    return ShardMesh(["cpu"] * n)


@pytest.fixture
def dma(monkeypatch):
    """The ``dma`` backend on the CPU in both packages: the Pallas kernel in
    interpret mode, K5's plain version."""
    monkeypatch.setattr(jdma, "FORCE_INTERPRET", True)
    monkeypatch.setattr(dma_halo, "FORCE_INTERPRET", True)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _equal(a, b):
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (a) the exchange
# ---------------------------------------------------------------------------

def _jax_exchange(blocks, cuts, backend):
    """JAX's ``exchange_slabs`` under ``shard_map`` over the 8 devices:
    for each ``(axis, ng, side, perm)`` of ``cuts`` every device sends the
    slab of its block."""
    mesh = oct_mesh(jax.devices())
    glob = jnp.asarray(np.concatenate(blocks))

    def body(b):
        sends = []
        for ax, ng, side, _ in cuts:
            n = b.shape[ax]
            sl = [slice(None)] * b.ndim
            sl[ax] = slice(n - ng, n) if side == "hi" else slice(0, ng)
            sends.append(b[tuple(sl)])
        return tuple(jdma.exchange_slabs(sends, [c[3] for c in cuts],
                                         OCT_AXIS, backend=backend))

    f = jdma.shard_map_compat(body, mesh, in_specs=(P(OCT_AXIS),),
                              out_specs=tuple(P(OCT_AXIS) for _ in cuts),
                              check_rep=(backend != "dma"))
    out = jax.jit(f)(glob)
    return [np.split(np.asarray(o), NSHARD) for o in out]


@needs8
@pytest.mark.parametrize("backend", ["ppermute", "dma"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_exchange_slabs_matches_jax(dma, backend, dtype):
    """Fwd and bwd rings, slabs cut along each axis of a ``[5, X, Y, Z]``
    block, both depths: the port's exchange on 8 shards bitwise equals
    JAX's on 8 devices."""
    rng = np.random.default_rng(7)
    blocks = [rng.standard_normal((5, 4, 6, 3)).astype(dtype)
              for _ in range(NSHARD)]
    fwd = [(i, (i + 1) % NSHARD) for i in range(NSHARD)]
    bwd = [(i, (i - 1) % NSHARD) for i in range(NSHARD)]
    cuts = [(1, 2, "hi", fwd), (1, 2, "lo", bwd), (2, 2, "hi", bwd),
            (2, 1, "lo", fwd), (3, 2, "lo", fwd), (3, 1, "hi", bwd)]
    want = _jax_exchange(blocks, cuts, backend)
    mesh = _mesh()
    tb = shards_from_numpy(np.concatenate(blocks), mesh, 0)
    sends = []
    for ax, ng, side, _ in cuts:
        sends.append([b.narrow(ax, b.shape[ax] - ng, ng) if side == "hi"
                      else b.narrow(ax, 0, ng) for b in tb])
    got = dma_halo.exchange_slabs(sends, [c[3] for c in cuts],
                                  dma_halo.resolve_backend(backend, "cpu"))
    for g, w in zip(got, want):
        for gs, ws in zip(g, w):
            np.testing.assert_array_equal(gs.numpy(), ws)


def test_exchange_pair_and_permute_are_ppermute():
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.standard_normal((3, 2))) for _ in range(4)]
    fwd = [(i, (i + 1) % 4) for i in range(4)]
    bwd = [(i, (i - 1) % 4) for i in range(4)]
    got = dma_halo.permute(xs, fwd)
    for s, d in fwd:
        _equal(got[d], xs[s])
    lo, hi = dma_halo.exchange_pair(xs, [x * 2 for x in xs], fwd, bwd)
    for s in range(4):
        _equal(lo[(s + 1) % 4], xs[s])
        _equal(hi[(s - 1) % 4], 2 * xs[s])


def test_exchange_into_ghost_regions():
    """K5's wrapper copies into views of larger blocks (the ghost region of
    a receiver's extended block) and writes nothing else there."""
    rng = np.random.default_rng(2)
    blocks = [torch.from_numpy(rng.standard_normal((5, 4, 3, 6)))
              for _ in range(4)]
    ext = [torch.zeros(5, 4, 3, 10, dtype=torch.float64) for _ in range(4)]
    fwd = [(i, (i + 1) % 4) for i in range(4)]
    dma_halo.halo_exchange([(blocks[s][..., -2:], ext[d][..., :2])
                            for s, d in fwd])
    for s, d in fwd:
        _equal(ext[d][..., :2], blocks[s][..., -2:])
        assert not ext[d][..., 2:].any()


def test_copy_layout_refuses_what_k5_does_not_take():
    a = torch.zeros(4, 5, 6)
    assert dma_halo.copy_layout(a[:, 3:], torch.zeros(4, 2, 6)) == \
        (4, 12, 30, 12)
    assert dma_halo.copy_layout(a, torch.zeros(4, 5, 6)) == (1, 120, 120,
                                                             120)
    with pytest.raises(ValueError, match="2-level"):
        dma_halo.copy_layout(a[:, 1:3, 2:4], torch.zeros(4, 2, 2))
    with pytest.raises(ValueError):
        dma_halo.copy_layout(a[:, :2], torch.zeros(4, 2, 6,
                                                   dtype=torch.float64))


def test_traffic_counts_every_shard():
    dma_halo.reset_traffic()
    xs = [torch.zeros(5, 2, 8) for _ in range(4)]
    dma_halo.exchange_pair(xs, xs, [(i, (i + 1) % 4) for i in range(4)],
                           [(i, (i - 1) % 4) for i in range(4)])
    snap = dma_halo.traffic_snapshot()
    assert snap["halo_bytes"] == 2 * 4 * 5 * 2 * 8 * 4
    assert snap["halo_exchanges"] == 2
    dma_halo.reset_traffic()
    assert dma_halo.traffic_snapshot()["halo_bytes"] == 0


# ---------------------------------------------------------------------------
# (b), (c) the uniform slab pipeline
# ---------------------------------------------------------------------------

# the set-up of tests/test_dma_halo.py::test_run_steps_halo_dma_bitwise
def _halo_nml(lvl):
    return "\n".join([
        "&RUN_PARAMS", "hydro=.true.", "/",
        "&AMR_PARAMS", f"levelmin={lvl}", f"levelmax={lvl}",
        "boxlen=1.0", "/",
        "&INIT_PARAMS", "nregion=2",
        "region_type(1)='square'", "region_type(2)='square'",
        "x_center=0.5,0.5", "y_center=0.5,0.5", "z_center=0.5,0.5",
        "length_x=10.0,0.12", "length_y=10.0,0.12",
        "length_z=10.0,0.12", "exp_region=10.0,2.0",
        "d_region=1.0,4.0", "p_region=1e-2,1.0", "/",
        "&HYDRO_PARAMS", "riemann='hllc'", "courant_factor=0.8", "/",
    ])


@pytest.fixture(scope="module")
def jax_halo_2d():
    """JAX's ``run_steps_halo`` on the 2D level-6 f64 set-up, 4 steps, on
    both backends (the dma one through the Pallas interpreter)."""
    sim = JSimulation(jparams(_halo_nml(6), ndim=2), dtype=jnp.float64)
    u0 = sim.state.u
    out = {}
    old = jdma.FORCE_INTERPRET
    try:
        jdma.FORCE_INTERPRET = True
        for backend in ("ppermute", "dma"):
            u, t, n = jrun_steps_halo(sim.grid, make_halo_mesh(), u0,
                                      jnp.asarray(0.0, jnp.float64),
                                      jnp.asarray(1e9, jnp.float64), 4,
                                      halo_backend=backend)
            out[backend] = (np.asarray(u), float(t), int(n))
    finally:
        jdma.FORCE_INTERPRET = old
    return np.asarray(u0), out


@needs8
@pytest.mark.parametrize("backend", ["ppermute", "dma"])
def test_run_steps_halo_matches_jax_and_run_steps(dma, jax_halo_2d,
                                                  backend):
    """2D level 6, f64, hllc, 4 steps (the ``dma`` run splits each step:
    32 of 64 planes a shard updated while the ghosts move)."""
    u0, jax_out = jax_halo_2d
    sim = Simulation.from_state(params_from_string(_halo_nml(6), ndim=2),
                                u0, 0.0, 0, device="cpu")
    ur, tr, nr = run_steps(sim.grid, sim.state.u, 0.0, 1e9, 4)
    dma_halo.reset_traffic()
    uh, th, nh = run_steps_halo(sim.grid, _mesh(), u0, 0.0, 1e9, 4,
                                halo_backend=backend)
    assert int(nh) == int(nr) == 4 and float(th) == float(tr)
    _equal(uh, ur)
    assert (dma_halo.TRAFFIC["overlap_frac"] > 0.0) == (backend == "dma")
    for be in ("ppermute", "dma"):
        ju, jt, jn = jax_out[be]
        assert jn == 4
        np.testing.assert_allclose(float(th), jt, rtol=RTOL)
        _close(uh.numpy(), ju)


@pytest.mark.parametrize("lvl,nshard,backend", [
    (4, 8, "auto"),          # 2 planes a shard: the unsplit step
    (5, 4, "dma"),           # 8 planes a shard: the overlap split
])
def test_run_steps_halo_k1_padded_is_run_steps(dma, lvl, nshard, backend):
    """3D f32 through K1's padded entry (its plain version on the CPU), the
    Courant min of each block folded into the next dt: bitwise the
    single-device ``run_steps`` through K1's unpadded entry."""
    p = params_from_string(_halo_nml(lvl), ndim=3)
    sim = Simulation(p, dtype=torch.float32, device="cpu")
    u0 = sim.state.u
    ur, tr, nr = run_steps(sim.grid, u0, 0.0, 1e9, 4)
    uh, th, nh = run_steps_halo(sim.grid, _mesh(nshard), u0, 0.0, 1e9, 4,
                                halo_backend=backend)
    assert int(nh) == int(nr) == 4 and float(th) == float(tr)
    _equal(uh, ur)


def test_run_steps_halo_stops_at_tend():
    p = params_from_string(_halo_nml(5), ndim=2)
    sim = Simulation(p, dtype=torch.float64, device="cpu")
    ur, tr, nr = run_steps(sim.grid, sim.state.u, 0.0, 2e-3, 6)
    uh, th, nh = run_steps_halo(sim.grid, _mesh(4), sim.state.u, 0.0, 2e-3,
                                6)
    assert 0 < int(nh) == int(nr) < 6 and float(th) == float(tr) == 2e-3
    _equal(uh, ur)


# ---------------------------------------------------------------------------
# (d) bitperm slab functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndim,lvl", [(2, 3), (2, 4), (3, 3), (3, 4)])
@pytest.mark.parametrize("mbits", [1, 2, 3])
def test_bitperm_slab_matches_jax(ndim, lvl, mbits):
    assert bitperm.grid_bits(lvl, ndim, mbits) == \
        jbitperm.grid_bits(lvl, ndim, mbits)
    assert bitperm.slab_shape(lvl, ndim, mbits) == \
        jbitperm.slab_shape(lvl, ndim, mbits)
    assert bitperm.chunk_coords(lvl, ndim, mbits) == \
        jbitperm.chunk_coords(lvl, ndim, mbits)
    n = (1 << (ndim * lvl)) >> mbits
    rows = np.random.default_rng(lvl).standard_normal((n, 3))
    want = np.asarray(jbitperm.flat_to_dense_slab(jnp.asarray(rows), lvl,
                                                  ndim, mbits))
    got = bitperm.flat_to_dense_slab(torch.from_numpy(rows), lvl, ndim,
                                     mbits)
    np.testing.assert_array_equal(got.numpy(), want)
    back = np.asarray(jbitperm.dense_to_flat_slab(jnp.asarray(want), lvl,
                                                  ndim, mbits))
    np.testing.assert_array_equal(
        bitperm.dense_to_flat_slab(got, lvl, ndim, mbits).numpy(), back)
    # the variables-leading form the slab sweep runs
    vf = bitperm.flat_to_dense_slab(torch.from_numpy(rows), lvl, ndim, mbits,
                                    vars_first=True)
    assert vf.is_contiguous()
    np.testing.assert_array_equal(vf.numpy(), np.moveaxis(want, -1, 0))
    np.testing.assert_array_equal(
        bitperm.dense_to_flat_slab(vf, lvl, ndim, mbits,
                                   vars_first=True).numpy(), back)


def test_bitperm_slab_refuses_a_cut_inside_octs():
    with pytest.raises(ValueError, match="inside octs"):
        bitperm.grid_bits(2, 2, 3)


# ---------------------------------------------------------------------------
# (e) the complete-level slab sweep and flags
# ---------------------------------------------------------------------------

def _sedov_like(ncell, nvar, ndim, dtype, seed=0):
    """tests/test_dma_halo.py's rows: a perturbed uniform state."""
    rng = np.random.default_rng(seed)
    u = np.ones((ncell, nvar))
    u[:, 0] = 1.0 + 0.1 * rng.random(ncell)
    u[:, 1:1 + ndim] = 0.05 * rng.standard_normal((ncell, ndim))
    u[:, nvar - 1] = 1.0 + 0.1 * rng.random(ncell)
    return u.astype(dtype)


def _oct_mask(ncell, ndim, lvl, seed=1):
    rng = np.random.default_rng(seed)
    ok_flat = np.repeat(rng.random(ncell >> ndim) < 0.3, 1 << ndim)
    ok_dense = np.asarray(bitperm.flat_to_dense(torch.from_numpy(ok_flat),
                                                lvl, ndim)).reshape(-1)
    return ok_flat, ok_dense


def _slab_spec(lvl, ndim, backend, nshard=NSHARD):
    n = 1 << lvl
    return DS.build_slab_spec(_mesh(nshard), lvl, ndim, (n,) * ndim,
                              n ** ndim, ((0, 0),) * ndim,
                              halo_backend=backend)


@needs8
@pytest.mark.parametrize("backend", ["ppermute", "dma"])
@pytest.mark.parametrize("masked,ret_flux", [
    (False, False), (False, True), (True, False), (True, True)])
def test_dense_sweep_slab_matches_jax_and_dense_sweep(dma, backend, masked,
                                                      ret_flux):
    """2D level 4 on 8 shards (loc (8, 4), both axes cut), f64: within
    rtol 1e-10 of JAX's ``dense_sweep_slab``, bitwise the port's
    single-device ``dense_sweep``."""
    ndim, lvl = 2, 4
    n = 1 << lvl
    shape = (n,) * ndim
    ncell = n ** ndim
    u = _sedov_like(ncell, ndim + 2, ndim, np.float64)
    ok_flat, ok_dense = _oct_mask(ncell, ndim, lvl) if masked else (None,
                                                                     None)
    dt, dx = 1e-3, 1.0 / n
    cfg = HydroStatic(ndim=ndim, gamma=1.4, riemann="hllc")
    spec = _slab_spec(lvl, ndim, backend)
    assert spec.backend == backend and spec.loc == (8, 4)
    tok = None if ok_flat is None else torch.from_numpy(ok_flat)
    got = DS.dense_sweep_slab(torch.from_numpy(u), tok, dt, dx, spec, cfg,
                              ret_flux=ret_flux)
    ref = K.dense_sweep(torch.from_numpy(u), None, None,
                        None if ok_dense is None
                        else torch.from_numpy(ok_dense), dt, dx, shape,
                        bmod.BoundarySpec.periodic(ndim), cfg,
                        ret_flux=ret_flux)
    jspec = JDS.build_slab_spec(oct_mesh(jax.devices()), lvl, ndim, shape,
                                ncell, ((0, 0),) * ndim,
                                halo_backend=backend)
    assert DS._split_axis(spec, 2) == JDS._split_axis(jspec, 2)
    want = jax.jit(partial(
        JDS.dense_sweep_slab, spec=jspec, dx=dx, ret_flux=ret_flux,
        cfg=JHydroStatic(ndim=ndim, gamma=1.4, riemann="hllc")))(
            jnp.asarray(u), None if ok_flat is None else jnp.asarray(ok_flat),
            jnp.float64(dt))
    got = got if ret_flux else (got,)
    ref = ref if ret_flux else (ref,)
    want = want if ret_flux else (want,)
    for g, r, w in zip(got, ref, want):
        _equal(g, r)
        _close(g.numpy(), w)


@pytest.mark.parametrize("lvl,backend,masked,ret_flux", [
    (4, "dma", True, True),           # loc (8, 8, 8): split on z
    (4, "ppermute", True, False),
    (3, "dma", False, True),          # loc (4, 4, 4): no split
])
def test_dense_sweep_slab_k1_padded_is_dense_sweep(dma, lvl, backend,
                                                   masked, ret_flux):
    """3D f32 on 8 shards through K1's padded entry (plain version):
    bitwise the single-device ``dense_sweep`` through K1's unpadded
    entry, the mask's ghosts exchanged like the state."""
    ndim = 3
    n = 1 << lvl
    ncell = n ** ndim
    u = _sedov_like(ncell, 5, ndim, np.float32, seed=lvl)
    ok_flat, ok_dense = _oct_mask(ncell, ndim, lvl) if masked else (None,
                                                                     None)
    cfg = HydroStatic(ndim=3, gamma=1.4, riemann="hllc", slope_type=2)
    spec = _slab_spec(lvl, ndim, backend)
    dt = torch.tensor(2e-3, dtype=torch.float32)
    got = DS.dense_sweep_slab(torch.from_numpy(u), None if ok_flat is None
                              else torch.from_numpy(ok_flat), dt, 1.0 / n,
                              spec, cfg, ret_flux=ret_flux)
    ref = K.dense_sweep(torch.from_numpy(u), None, None,
                        None if ok_dense is None
                        else torch.from_numpy(ok_dense), dt, 1.0 / n,
                        (n,) * 3, bmod.BoundarySpec.periodic(3), cfg,
                        ret_flux=ret_flux)
    for g, r in zip(got if ret_flux else (got,), ref if ret_flux else (ref,)):
        _equal(g, r)


@needs8
@pytest.mark.parametrize("ndim,lvl", [(2, 4), (3, 3)])
def test_dense_flags_slab_matches_jax_and_dense_flags(dma, ndim, lvl):
    n = 1 << lvl
    shape = (n,) * ndim
    ncell = n ** ndim
    u = _sedov_like(ncell, ndim + 2, ndim, np.float64, seed=2)
    eg, fls = (0.05, 0.05, -1.0), (1e-10, 1e-10, 1e-10)
    cfg = HydroStatic(ndim=ndim, gamma=1.4)
    spec = _slab_spec(lvl, ndim, "dma")
    got = DS.dense_flags_slab(torch.from_numpy(u), spec,
                              lambda up: K._grad_flags(up, eg, fls, 0, cfg),
                              2 ** ndim)
    ref = K.dense_refine_flags(torch.from_numpy(u), None, None, eg, fls,
                               shape, bmod.BoundarySpec.periodic(ndim), cfg)
    _equal(got, ref)
    jcfg = JHydroStatic(ndim=ndim, gamma=1.4)
    jspec = JDS.build_slab_spec(oct_mesh(jax.devices()), lvl, ndim, shape,
                                ncell, ((0, 0),) * ndim, halo_backend="dma")
    fn = (lambda up: JK._flags_fn(jcfg)(up, err_grad=eg, floors=fls,
                                        spatial0=0, cfg=jcfg))
    want = jax.jit(partial(JDS.dense_flags_slab, spec=jspec, flags_fn=fn,
                           twotondim=2 ** ndim))(jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_slab_spec_envelope():
    """The single-device sweep keeps what the slab cannot take."""
    periodic = ((0, 0),) * 3
    assert DS.build_slab_spec(_mesh(1), 4, 3, (16,) * 3, 4096,
                              periodic) is None          # one shard
    assert DS.build_slab_spec(_mesh(6), 4, 3, (16,) * 3, 4096,
                              periodic) is None          # not 2^k
    assert DS.build_slab_spec(_mesh(), 4, 3, (16,) * 3, 4096 + 64,
                              periodic) is None          # padded rows
    assert DS.build_slab_spec(_mesh(), 4, 3, (16,) * 3, 4096,
                              ((1, 1),) * 3) is None     # reflecting
    assert DS.build_slab_spec(_mesh(), 1, 3, (2,) * 3, 8,
                              periodic) is None          # cut inside octs
    spec = DS.build_slab_spec(_mesh(), 4, 3, (16,) * 3, 4096, periodic)
    assert spec.grid == (2, 2, 2) and spec.loc == (8, 8, 8)
    assert DS.max_slab_devices(4, 3) == 512
    assert factorize(8, 3) == (2, 2, 2)


# ---------------------------------------------------------------------------
# (f) ShardedAmrSim
# ---------------------------------------------------------------------------

# tests/test_dma_halo.py::test_hydro_sim_shard_invariance_dma's set-up (a
# complete level 3 in 3D), its uniform state perturbed below
AMR3D = "\n".join([
    "&RUN_PARAMS", "hydro=.true.", "/",
    "&AMR_PARAMS", "levelmin=3", "levelmax=3", "boxlen=1.0",
    "halo_backend='dma'", "/",
    "&INIT_PARAMS", "nregion=1", "region_type(1)='square'",
    "d_region=1.0", "p_region=1.0", "/",
    "&HYDRO_PARAMS", "riemann='hllc'", "/",
    "&OUTPUT_PARAMS", "tend=0.01", "/",
])
# __graft_entry__.py's sharded-AMR set-up: two partial levels
AMR2D = "\n".join([
    "&RUN_PARAMS", "hydro=.true.", "/",
    "&AMR_PARAMS", "levelmin=4", "levelmax=6", "boxlen=1.0",
    "halo_backend='dma'", "/",
    "&INIT_PARAMS", "nregion=2",
    "region_type(1)='square'", "region_type(2)='square'",
    "x_center=0.25,0.75", "length_x=0.5,0.5",
    "exp_region=10.0,10.0", "d_region=1.0,0.125",
    "p_region=1.0,0.1", "/",
    "&HYDRO_PARAMS", "riemann='hllc'", "/",
    "&REFINE_PARAMS", "err_grad_d=0.05", "err_grad_p=0.05", "/",
    "&OUTPUT_PARAMS", "tend=0.01", "/",
])
SETUPS = {"3d": (AMR3D, 3), "2d": (AMR2D, 2)}


def _perturb(jsim):
    """Perturb density and energy of every row, in place on the JAX sim."""
    rng = np.random.default_rng(5)
    for l in jsim.levels():
        r = np.array(jsim.u[l])
        r[:, 0] *= 1.0 + 0.2 * rng.random(len(r))
        r[:, -1] *= 1.0 + 0.2 * rng.random(len(r))
        jsim.u[l] = jsim._place(jnp.asarray(r), "cells")
    jsim._dt_cache = None


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's ShardedAmrSim on the 8 devices, f64, per set-up: its initial
    state and the dts and final rows of 2 coarse steps (the regrid and its
    flags are held to AmrSim below, and to JAX's ``dense_flags_slab``
    above)."""
    out = {}
    old = jdma.FORCE_INTERPRET
    try:
        jdma.FORCE_INTERPRET = True
        for key, (nml, nd) in SETUPS.items():
            js = JShardedAmrSim(jparams(nml, ndim=nd),
                                devices=jax.devices(), dtype=jnp.float64)
            if key == "3d":
                _perturb(js)
            state = amr_state_from(js)
            dts = []
            for _ in range(2):
                dts.append(js.coarse_dt())
                js.step_coarse(dts[-1])
            out[key] = (state, dts, {l: np.asarray(js.u[l])
                                     for l in js.levels()},
                        {l: js.tree.noct(l) for l in js.levels()})
    finally:
        jdma.FORCE_INTERPRET = old
    return out


@needs8
@pytest.mark.parametrize("setup", ["3d", "2d"])
def test_sharded_amr_matches_jax_and_amrsim(dma, jax_sharded, setup):
    """2 coarse steps in f64: the port's ShardedAmrSim on 8 shards within
    rtol 1e-10 of JAX's on 8 devices, and bitwise the port's single-device
    AmrSim."""
    nml, nd = SETUPS[setup]
    state, jdts, jrows, jocts = jax_sharded[setup]
    p = params_from_string(nml, ndim=nd)
    s8 = ShardedAmrSim.from_state(p, devices=_mesh(), **state)
    s1 = AmrSim.from_state(p, device="cpu", **state)
    spec = s8._fused_spec()
    assert spec.slab[0] is not None and spec.slab[0].backend == "dma"
    assert all(s is None for s in spec.slab[1:])
    for i in range(2):
        dt = s8.coarse_dt()
        assert dt == s1.coarse_dt()
        np.testing.assert_allclose(dt, jdts[i], rtol=RTOL)
        s8.step_coarse(dt)
        s1.step_coarse(dt)
    assert {l: s8.tree.noct(l) for l in s8.levels()} == jocts
    for l in s8.levels():
        _equal(s8.u[l], s1.u[l])
        n = s8.tree.noct(l) << nd
        got, want = s8.u[l][:n].numpy(), jrows[l][:n]
        if s8.tree.refined_mask(l)[0]:
            # ROADMAP C1: the JAX package's restrict_upload leaves a
            # refined flat cell 0 stale; the port holds its sons' mean
            got, want = got[1:], want[1:]
        _close(got, want)
        assert s8.maps[l].noct_pad % NSHARD == 0


@pytest.mark.parametrize("setup", ["3d", "2d"])
def test_sharded_amr_f32_is_amrsim(dma, jax_sharded, setup):
    """Coarse step, regrid, coarse step in f32: in 3D the complete level
    runs K1's padded entry (plain version) on each shard, bitwise the
    single-device K1; the regrid flags level 4 (2D) through
    ``dense_flags_slab``."""
    nml, nd = SETUPS[setup]
    state = dict(jax_sharded[setup][0])
    state["rows"] = {l: r.astype(np.float32)
                     for l, r in state["rows"].items()}
    p = params_from_string(nml, ndim=nd)
    s8 = ShardedAmrSim.from_state(p, devices=_mesh(), **state)
    s1 = AmrSim.from_state(p, device="cpu", **state)
    for i in range(2):
        dt = s8.coarse_dt()
        assert dt == s1.coarse_dt()
        s8.step_coarse(dt)
        s1.step_coarse(dt)
        if i == 0:
            s8.regrid()
            s1.regrid()
    for l in s8.levels():
        _equal(s8.u[l], s1.u[l])


def test_sharded_amr_ppermute_evolve_is_amrsim():
    """``evolve`` (chunked stepping between regrids) with the CPU's
    default backend on 4 shards equals AmrSim's."""
    p = params_from_string(AMR2D, ndim=2)
    p.amr.halo_backend = "auto"
    p.run.nremap = 4                   # a regrid, then chunks of 2 and 1
    s4 = ShardedAmrSim(p, devices=_mesh(4), dtype=torch.float64)
    s1 = AmrSim(p, dtype=torch.float64, device="cpu")
    assert s4._fused_spec().slab[0].backend == "ppermute"
    s4.evolve(1.0, nstepmax=3)
    s1.evolve(1.0, nstepmax=3)
    assert s4.nstep == s1.nstep == 3 and s4.t == s1.t
    for l in s1.levels():
        _equal(s4.u[l], s1.u[l])


# the set-up that found ShardedAmrSim dropping the sinks: AMR2D's two
# regions at levelmax 5, every leaf cell a sink candidate
AMR2D_SINKS = (AMR2D.replace("levelmax=6", "levelmax=5")
               .replace("halo_backend='dma'", "halo_backend='auto'")
               .replace("&OUTPUT_PARAMS", "&SINK_PARAMS\ncreate_sinks=.true."
                        "\nn_sink=1e-30\n/\n&OUTPUT_PARAMS"))


def _by_id(sinks):
    o = np.argsort(sinks.idp)
    return {k: np.asarray(getattr(sinks, k))[o] for k in ("idp", "x", "v",
                                                         "m", "tform")}


@needs8
def test_sharded_amr_runs_the_sink_passes():
    """ShardedAmrSim runs the sink passes, as the JAX package's (which
    inherits them): one coarse step of the 2D set-up in f64 on 8 shards
    from JAX's initial state makes JAX's sinks (ids equal; x, v, m within
    rtol 1e-10), and the port's single-device AmrSim's bitwise, sinks and
    rows."""
    js = JShardedAmrSim(jparams(AMR2D_SINKS, ndim=2), devices=jax.devices(),
                        dtype=jnp.float64)
    state = amr_state_from(js)
    dt = js.coarse_dt()
    js.step_coarse(dt)
    p = params_from_string(AMR2D_SINKS, ndim=2)
    s8 = ShardedAmrSim.from_state(p, devices=_mesh(), **state)
    s1 = AmrSim.from_state(p, device="cpu", **state)
    assert s8.sinks is not None and s8.sinks.n == 0
    assert s8.coarse_dt() == s1.coarse_dt() == pytest.approx(dt, rel=RTOL)
    s8.step_coarse(dt)
    s1.step_coarse(dt)
    got, one, want = _by_id(s8.sinks), _by_id(s1.sinks), _by_id(js.sinks)
    assert s8.sinks.n == js.sinks.n > 100
    np.testing.assert_array_equal(got["idp"], want["idp"])
    for k in ("x", "v", "m", "tform"):
        np.testing.assert_array_equal(got[k], one[k])
        _close(got[k], want[k])
    for l in s8.levels():
        _equal(s8.u[l], s1.u[l])
    assert "sinks=" in s8.status_note()


def test_sharded_amr_cools_as_amrsim():
    """The in-step cooling on ShardedAmrSim (4 shards, f64): 2 coarse
    steps bitwise the single-device AmrSim's."""
    p = params_from_string(AMR2D.replace(
        "&OUTPUT_PARAMS", "&COOLING_PARAMS\ncooling=.true.\n/\n"
        "&UNITS_PARAMS\nunits_density=1.66e-24\nunits_time=3.15e13\n"
        "units_length=3.08e18\n/\n&OUTPUT_PARAMS"), ndim=2)
    p.amr.halo_backend = "auto"
    s4 = ShardedAmrSim(p, devices=_mesh(4), dtype=torch.float64)
    s1 = AmrSim(p, dtype=torch.float64, device="cpu")
    assert s4.cool_tables is not None
    for _ in range(2):
        dt = s4.coarse_dt()
        assert dt == s1.coarse_dt()
        s4.step_coarse(dt)
        s1.step_coarse(dt)
    for l in s1.levels():
        _equal(s4.u[l], s1.u[l])


# ---------------------------------------------------------------------------
# (g) refusals, backend choice, conversions
# ---------------------------------------------------------------------------

def test_refusals_by_name():
    p = params_from_string(AMR2D, ndim=2)
    with pytest.raises(NotImplementedError, match="explicit_comm"):
        ShardedAmrSim(p, devices=_mesh(), explicit_comm=True)
    p.amr.load_balance = True
    with pytest.raises(NotImplementedError, match="load balance"):
        ShardedAmrSim(p, devices=_mesh())
    mhd = params_from_string(AMR2D.replace(
        "&HYDRO_PARAMS", "&INIT_PARAMS\nA_region=1.0\n/\n&HYDRO_PARAMS"),
        ndim=2)
    with pytest.raises(NotImplementedError, match="ShardedMhdAmrSim"):
        ShardedAmrSim(mhd, devices=_mesh())
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        ShardMesh(["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        dma_halo.halo_exchange([(torch.zeros(2), torch.zeros(2,
                                                             device="meta"))])
    sim = Simulation(params_from_string(_halo_nml(4), ndim=2),
                     device="cpu")
    walls = type(sim.grid)(cfg=sim.grid.cfg, shape=sim.grid.shape,
                           dx=sim.grid.dx,
                           bc=bmod.BoundarySpec(faces=(
                               (bmod.FaceBC(1), bmod.FaceBC(1)),) * 2))
    with pytest.raises(NotImplementedError, match="periodic"):
        run_steps_halo(walls, _mesh(), sim.state.u, 0.0, 1.0, 1)
    with pytest.raises(ValueError, match="divisible"):
        run_steps_halo(sim.grid, _mesh(3), sim.state.u, 0.0, 1.0, 1)


def test_default_mesh_and_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardMesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedAmrSim(params_from_string(AMR2D, ndim=2))


def test_resolve_backend(monkeypatch):
    monkeypatch.setattr(dma_halo, "FORCE_INTERPRET", False)
    monkeypatch.setattr(dma_halo, "_warned", set())
    assert dma_halo.resolve_backend("auto", "cpu") == "ppermute"
    assert dma_halo.resolve_backend(None, "cpu") == "ppermute"
    assert dma_halo.resolve_backend("auto", "cuda") == "dma"
    assert dma_halo.resolve_backend("dma", "cuda") == "dma"
    assert dma_halo.resolve_backend("ppermute", "cuda") == "ppermute"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert dma_halo.resolve_backend("dma", "cpu") == "ppermute"
        assert dma_halo.resolve_backend("dma", "cpu") == "ppermute"
    assert sum("falling back" in str(x.message) for x in w) == 1
    monkeypatch.setattr(dma_halo, "FORCE_INTERPRET", True)
    assert dma_halo.resolve_backend("dma", "cpu") == "dma"
    for bad in ("dmaa", " dma", "nccl"):
        for dev in ("cpu", "cuda"):
            with pytest.raises(ValueError, match="unknown halo_backend"):
                dma_halo.resolve_backend(bad, dev)


def test_dma_on_cpu_tensors_runs_the_plain_version(dma):
    """K5's wrapper runs its plain version for CPU tensors and counts no
    launch."""
    dma_halo.launches = 0
    xs = [torch.arange(12.0).reshape(3, 4) + s for s in range(4)]
    got = dma_halo.permute([x[:, 2:] for x in xs],
                           [(i, (i + 1) % 4) for i in range(4)], "dma")
    for s in range(4):
        _equal(got[(s + 1) % 4], xs[s][:, 2:])
    assert dma_halo.launches == 0


def test_shard_conversion_round_trip():
    u = np.random.default_rng(0).standard_normal((5, 16, 3))
    shards = shards_from_numpy(u, _mesh(), 1)
    assert len(shards) == NSHARD and shards[0].shape == (5, 2, 3)
    assert all(s.is_contiguous() for s in shards)
    np.testing.assert_array_equal(gather_shards(shards, 1), u)
    with pytest.raises(ValueError, match="divide"):
        shards_from_numpy(u, _mesh(3), 1)
