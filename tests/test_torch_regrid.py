"""The device-resident regrid migration (``amr/device_regrid``, K7's plain
version and a host build of ``csrc/regrid_maps.cu``) on the CPU.

* int64 carries the JAX package's uint64 mask ladders bit for bit within
  ``keys_fit``; ``keys_fit`` is the JAX package's under x64;
* ``_encode``, ``_decode``, ``_map_coords``, ``_bitrev_low`` and the maps
  of ``regrid_maps_ref`` equal the JAX package's ``device_regrid``
  helpers (run inside ``jax.enable_x64(True)``) on random keys, and the
  migrated rows equal its ``migrate_level``'s;
* K7's source, built with g++ against a stand-in CUDA header (the
  harness of ``tests/test_torch_muscl_host.py``), bitwise its plain
  version: 1D, 2D and 3D, periodic, reflecting and outflow faces,
  non-cubic cell counts, sentinel pads, on both sides of the keys it
  stages whole (its two branches), odd, one-key and unaligned arrays;
* the hierarchy: the device migrate bitwise the host migrate with no
  ``build_prolong_maps`` call (2D and 3D, levelmin 4 / levelmax 6, f64,
  three regrids), a steady regrid uploads nothing, the gate takes the
  host maps by configuration, and a shrunk config 2 against the JAX
  package's ``AmrSim`` with ``device_regrid`` on (f64, rtol 1e-10).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr import device_regrid as jdr  # noqa: E402
from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.config import load_params as jload  # noqa: E402
from ramses_tpu.hydro.core import HydroStatic as JHydroStatic  # noqa: E402

from ramses_tpu_torch.amr import device_regrid as dr  # noqa: E402
from ramses_tpu_torch.amr import keys as kmod  # noqa: E402
from ramses_tpu_torch.amr import maps as mapmod  # noqa: E402
from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import load_params  # noqa: E402
from ramses_tpu_torch.config import params_from_string  # noqa: E402
from ramses_tpu_torch.hydro.core import HydroStatic  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NML = os.path.join(ROOT, "namelists", "sedov3d.nml")

# the centre-blast setup of tests/test_oct_blocking.py
SEDOV = """
&RUN_PARAMS
hydro=.true.
/
&AMR_PARAMS
levelmin={lmin}
levelmax={lmax}
boxlen=1.0
oct_blocking=.true.
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

# (ndim, root, level, boundary kinds): cubic and non-cubic roots;
# periodic, reflecting, outflow and one-sided faces
CASES = [
    (1, (1,), 7, ((1, 2),)),
    (2, (1, 1), 6, ((0, 0), (0, 0))),
    (2, (2, 1), 6, ((0, 0), (1, 1))),
    (2, (1, 3), 5, ((2, 2), (0, 2))),
    (3, (1, 1, 1), 5, ((0, 0), (0, 0), (0, 0))),
    (3, (1, 1, 1), 5, ((1, 1), (2, 1), (1, 2))),
    (3, (2, 1, 1), 5, ((0, 0), (1, 1), (2, 2))),
]


def _key_set(ndim, root, lvl, seed, frac=0.3):
    """A random regrid's sorted key arrays at level ``lvl``: new octs on a
    ``frac`` of the level's slots, an old level that kept 80 % of them
    plus others, a coarser level holding every new oct's father plus
    others; sentinel-padded; and the lvl-1 cell counts."""
    rng = np.random.default_rng(seed)
    dims = tuple(r << (lvl - 1) for r in root)

    def keys_of(shape, p):
        c = np.stack(np.meshgrid(*[np.arange(n) for n in shape],
                                 indexing="ij"), -1).reshape(-1, ndim)
        return c[rng.random(len(c)) < p]
    new = keys_of(dims, frac)
    old = np.concatenate([new[rng.random(len(new)) < 0.8],
                          keys_of(dims, 0.1)])
    coarse = np.concatenate([new >> 1,
                             keys_of(tuple(n // 2 for n in dims), 0.2)])
    enc = [np.unique(kmod.encode(c, ndim)) for c in (new, old, coarse)]
    return (dr.upload_keys(enc[0], len(enc[0]) + 13, "cpu"),
            dr.upload_keys(enc[1], len(enc[1]) + 5, "cpu"),
            dr.upload_keys(enc[2], len(enc[2]) + 3, "cpu"), dims)


def _jax_maps(new, old, coarse, ndim, kinds, dims):
    """The map lines of the JAX package's ``_migrate_level_jit`` through
    its own helpers, x64."""
    with jax.enable_x64(True):
        nk, ok, ck = (jnp.asarray(t.numpy()) for t in (new, old, coarse))
        ttd = 1 << ndim
        valid = nk < jdr._sent(nk.dtype)
        pos, kept = jdr._find(ok, nk)
        kept = kept & valid
        f_pos, _ = jdr._find(ck, nk >> ndim)
        f_cell = f_pos * ttd + jdr._bitrev_low(nk, ndim)
        og = jdr._decode(nk, ndim)
        nb = []
        for d in range(ndim):
            cols = []
            for s in (-1, +1):
                ncm, nrefl = jdr._map_coords(og.at[:, d].add(s), kinds, dims,
                                             ndim)
                nkey = jdr._encode(ncm, ndim)
                n_pos, found = jdr._find(ck, nkey >> ndim)
                bad = ~found | nrefl.any(axis=1)
                cols.append(jnp.where(bad, f_cell,
                                      n_pos * ttd + jdr._bitrev_low(nkey,
                                                                    ndim)))
            nb.append(jnp.stack(cols, axis=1))
        return tuple(np.asarray(x) for x in (pos, kept, f_cell,
                                             jnp.stack(nb, axis=1)))


# ---------------------------------------------------------------------------
# the integer helpers
# ---------------------------------------------------------------------------

def test_int64_masks_stay_below_the_sign_bit():
    for pre, tab in dr._TABS.values():
        assert 0 < pre < 1 << 63
        assert all(0 < m < 1 << 63 for _, m in tab)
    rng = np.random.default_rng(0)
    for ndim, bits in ((2, 31), (3, 20)):
        c = rng.integers(0, 1 << bits, (4096, ndim), dtype=np.int64)
        c[0] = (1 << bits) - 1                       # every bit set
        k = dr._encode(torch.from_numpy(c), ndim)
        assert int(k.min()) >= 0 and int(k.max()) < 1 << (ndim * bits)
        # the same bits as the uint64 encoder of amr/keys.py
        np.testing.assert_array_equal(k.numpy(), kmod.encode_np(c, ndim))
        np.testing.assert_array_equal(dr._decode(k, ndim).numpy(), c)
        assert dr.keys_fit(ndim, bits + 1) and not dr.keys_fit(ndim,
                                                               bits + 2)
    # the sentinel decodes and re-encodes as JAX's uint64 ladders do
    s = torch.tensor([dr.SENTINEL])
    with jax.enable_x64(True):
        js = jnp.asarray([dr.SENTINEL], jnp.int64)
        for ndim in (2, 3):
            np.testing.assert_array_equal(dr._decode(s, ndim).numpy(),
                                          np.asarray(jdr._decode(js, ndim)))
            np.testing.assert_array_equal(
                dr._encode(dr._decode(s, ndim), ndim).numpy(),
                np.asarray(jdr._encode(jdr._decode(js, ndim), ndim)))


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_keys_fit_matches_jax(ndim):
    roots = [None, (1,) * ndim, (3,) + (1,) * (ndim - 1),
             (1,) * (ndim - 1) + (5,), (7,) * ndim]
    with jax.enable_x64(True):
        for lvl in range(0, 66):
            for root in roots:
                assert dr.keys_fit(ndim, lvl, root) == jdr.keys_fit(
                    ndim, lvl, root), (lvl, root)


def test_upload_keys_pads_with_the_sentinel():
    k = dr.upload_keys(np.array([3, 9, 27]), 8, "cpu")
    assert k.dtype == torch.int64 and k.tolist()[:3] == [3, 9, 27]
    assert k.tolist()[3:] == [dr.SENTINEL] * 5
    assert dr.upload_keys(np.zeros(0, np.int64), 4, "cpu").tolist() == \
        [dr.SENTINEL] * 4


@pytest.mark.parametrize("ndim,root,lvl,kinds", CASES)
def test_helpers_match_jax(ndim, root, lvl, kinds):
    rng = np.random.default_rng(lvl + ndim)
    dims = tuple(r << (lvl - 1) for r in root)
    c = np.stack([rng.integers(-2, n + 2, 3000) for n in dims], axis=1)
    inside = np.stack([rng.integers(0, n, 3000) for n in dims], axis=1)
    with jax.enable_x64(True):
        jm, jr = jdr._map_coords(jnp.asarray(c), kinds, dims, ndim)
        jk = jdr._encode(jnp.asarray(inside), ndim)
        jd = jdr._decode(jk, ndim)
        jb = jdr._bitrev_low(jk, ndim)
    pm, pr = dr._map_coords(torch.from_numpy(c), kinds, dims, ndim)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    pk = dr._encode(torch.from_numpy(inside), ndim)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(dr._decode(pk, ndim).numpy(),
                                  np.asarray(jd))
    np.testing.assert_array_equal(dr._bitrev_low(pk, ndim).numpy(),
                                  np.asarray(jb))


@pytest.mark.parametrize("ndim,root,lvl,kinds", CASES)
def test_regrid_maps_ref_matches_jax(ndim, root, lvl, kinds):
    new, old, coarse, dims = _key_set(ndim, root, lvl, 7 * lvl + ndim)
    got = dr.regrid_maps_ref(new, old, coarse, ndim, kinds, dims)
    want = _jax_maps(new, old, coarse, ndim, kinds, dims)
    assert got[1].dtype == torch.bool and got[3].shape == (len(new), ndim, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[1].any() and not got[1].all()


@pytest.mark.parametrize("ndim", [2, 3])
def test_migrate_level_matches_jax(ndim):
    """The whole level migration against the JAX package's
    ``migrate_level`` on random rows (f64, bitwise)."""
    root, lvl = (1,) * ndim, 5
    kinds = ((0, 0), (1, 1), (2, 2))[:ndim]
    new, old, coarse, dims = _key_set(ndim, root, lvl, 3 + ndim)
    ttd, nvar = 1 << ndim, ndim + 2
    rng = np.random.default_rng(ndim)
    old_u = rng.random((old.numel() * ttd, nvar)) + 0.5
    u_c = rng.random((coarse.numel() * ttd, nvar)) + 0.5
    ncell_pad = new.numel() * ttd
    for itype in (0, 1, 2):
        got = dr.migrate_level(torch.from_numpy(old_u), torch.from_numpy(u_c),
                               new, old, coarse, ncell_pad, ndim, kinds,
                               dims, HydroStatic(ndim=ndim), itype)
        with jax.enable_x64(True):
            want = jdr.migrate_level(
                jnp.asarray(old_u), jnp.asarray(u_c),
                *(jnp.asarray(t.numpy()) for t in (new, old, coarse)),
                ncell_pad, ndim, kinds, dims, JHydroStatic(ndim=ndim), itype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# K7's source built for the host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_k7(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    from tests.test_torch_muscl_host import host_library
    # the two branches' launches (keys staged whole, read through L1) and the
    # empty kernel's
    return dr.bind(host_library(tmp_path_factory.mktemp("regrid_host"),
                                "regrid_maps", 2, 1))


@pytest.mark.parametrize("ndim,root,lvl,kinds", CASES)
def test_k7_host_build_is_bitwise_its_plain_version(host_k7, ndim, root, lvl,
                                                    kinds):
    new, old, coarse, dims = _key_set(ndim, root, lvl, 11 * lvl + ndim)
    got = dr.call(host_k7, new, old, coarse, ndim, kinds, dims)
    want = dr.regrid_maps_ref(new, old, coarse, ndim, kinds, dims)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _bitwise(lib, new, old, coarse, ndim, kinds, dims):
    got = dr.call(lib, new, old, coarse, ndim, kinds, dims)
    want = dr.regrid_maps_ref(new, old, coarse, ndim, kinds, dims)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# (ndim, root, level, fraction of the level's slots): key sets of some 10^3
# octs, whose old and coarse keys K7 stages whole, and of some 10^4, which
# it reads through L1
BRANCH_SETS = {False: {1: ((1,), 12, 0.3), 2: ((1, 1), 6, 0.3),
                       3: ((1, 1, 1), 5, 0.3)},
               True: {1: ((1,), 15, 0.6), 2: ((1, 1), 8, 0.6),
                      3: ((1, 1, 1), 6, 0.3)}}
BC_KINDS = {"periodic": (0, 0), "reflecting": (1, 1), "outflow": (2, 2)}


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("bc", sorted(BC_KINDS))
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_k7_host_build_on_both_sides_of_the_staged_keys(host_k7, ndim, bc,
                                                       big):
    """Both branches of K7 (old and coarse keys staged whole in shared
    memory; read through L1), in 1D, 2D and 3D, on periodic, reflecting
    and outflow boxes, sentinel pads included: bitwise the plain
    version."""
    root, lvl, frac = BRANCH_SETS[big][ndim]
    new, old, coarse, dims = _key_set(ndim, root, lvl, 7 * lvl + ndim,
                                      frac)
    assert dr.staged(host_k7, old.numel(), coarse.numel()) != big
    _bitwise(host_k7, new, old, coarse, ndim, (BC_KINDS[bc],) * ndim, dims)


def test_k7_host_build_branch_edges(host_k7):
    """The staged branch on odd and one-key arrays and on arrays that are
    not 16-byte aligned (8-byte copies); the other branch where one array
    is large and the other holds one or two keys."""
    nd, kinds = 3, ((0, 0), (1, 1), (2, 1))
    new, old, coarse, dims = _key_set(nd, (1, 1, 1), 5, 4)
    # odd lengths; views that start 8 bytes into their storage
    for o, c in ((old[:-1], coarse), (old, coarse[:-2]),
                 (old[1:], coarse[1:]), (old[:1], coarse[:1])):
        assert dr.staged(host_k7, o.numel(), c.numel())
        _bitwise(host_k7, new, o, c, nd, kinds, dims)
    # 13,000 of level 6's 32^3 octs: alone past the staged keys
    rng = np.random.default_rng(6)
    big = dr.upload_keys(np.sort(rng.choice(32 ** 3, 13000, replace=False)),
                         13003, "cpu")
    dims6 = (32,) * 3
    one = dr.upload_keys(kmod.encode(np.array([[3, 5, 7]]), nd), 1, "cpu")
    for c in (one >> nd, dr.upload_keys((one >> nd).numpy(), 2, "cpu")):
        assert not dr.staged(host_k7, big.numel(), c.numel())
        assert not dr.staged(host_k7, c.numel(), big.numel())
        _bitwise(host_k7, one, big, c, nd, kinds, dims6)
        _bitwise(host_k7, big, c, big >> nd, nd, kinds, dims6)


@pytest.mark.parametrize("ndim,dims", [(1, (7,)), (2, (5, 7)),
                                       (3, (5, 7, 3)), (3, (4, 3, 6))])
def test_k7_host_build_on_odd_cell_counts(host_k7, ndim, dims):
    """Odd lvl-1 cell counts, where a father's oct is cut by the box's
    face and the step inside it leaves the box: every oct of the box, on
    each boundary kind, bitwise the plain version."""
    c = np.stack(np.meshgrid(*[np.arange(n) for n in dims], indexing="ij"),
                 -1).reshape(-1, ndim)
    keys = np.unique(kmod.encode(c, ndim))
    new = dr.upload_keys(keys, len(keys) + 3, "cpu")
    old = dr.upload_keys(keys[::2], len(keys) // 2 + 4, "cpu")
    coarse = dr.upload_keys(np.unique(keys >> ndim), len(keys), "cpu")
    for bc in sorted(BC_KINDS):
        _bitwise(host_k7, new, old, coarse, ndim, (BC_KINDS[bc],) * ndim,
                 dims)


def test_k7_host_build_edge_cases(host_k7):
    # no new keys: nothing is called; a level of sentinels only; one key
    nd, kinds, dims = 3, ((0, 0),) * 3, (8, 8, 8)
    coarse = dr.upload_keys(np.arange(64), 64, "cpu")
    for new in (dr.upload_keys(np.zeros(0, np.int64), 0, "cpu"),
                dr.upload_keys(np.zeros(0, np.int64), 16, "cpu"),
                dr.upload_keys(np.array([5]), 1, "cpu")):
        old = dr.upload_keys(np.zeros(0, np.int64), 8, "cpu")
        got = dr.call(host_k7, new, old, coarse, nd, kinds, dims)
        want = dr.regrid_maps_ref(new, old, coarse, nd, kinds, dims)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="at least one"):
        dr.call(host_k7, new, old[:0], coarse, nd, kinds, dims)


# ---------------------------------------------------------------------------
# the hierarchy
# ---------------------------------------------------------------------------

def _spied_run(monkeypatch, ndim, on, regrids=3, lmin=4, lmax=6):
    p = params_from_string(SEDOV.format(lmin=lmin, lmax=lmax), ndim=ndim)
    p.amr.device_regrid = on
    sim = AmrSim(p, dtype=torch.float64, device="cpu")
    n = {"host": 0, "maps": 0}
    real_host, real_maps = mapmod.build_prolong_maps, dr.regrid_maps

    def host(*a, **k):
        n["host"] += 1
        return real_host(*a, **k)

    def maps(*a, **k):
        n["maps"] += 1
        return real_maps(*a, **k)
    monkeypatch.setattr(mapmod, "build_prolong_maps", host)
    monkeypatch.setattr(dr, "regrid_maps", maps)
    for _ in range(regrids):
        for _ in range(2):
            sim.step_coarse(sim.coarse_dt())
        sim.regrid()
    monkeypatch.undo()
    return sim, n


@pytest.mark.parametrize("ndim", [2, 3])
def test_device_migrate_matches_host(monkeypatch, ndim):
    sa, na = _spied_run(monkeypatch, ndim, True)
    sb, nb = _spied_run(monkeypatch, ndim, False)
    assert nb["host"] > 0 and nb["maps"] == 0, "no changed-tree regrid"
    assert na["host"] == 0 and na["maps"] == nb["host"]
    assert sa.levels() == sb.levels() and len(sa.levels()) == 3
    for l in sa.levels():
        assert np.array_equal(sa.tree.levels[l].keys, sb.tree.levels[l].keys)
        assert torch.equal(sa.u[l], sb.u[l]), l


def test_steady_regrid_uploads_nothing(monkeypatch):
    p = params_from_string(SEDOV.format(lmin=4, lmax=5), ndim=2)
    sim = AmrSim(p, dtype=torch.float64, device="cpu")
    for _ in range(2):
        sim.step_coarse(sim.coarse_dt())
    sim.regrid()                        # absorb any pending tree change
    before = {l: sim.u[l] for l in sim.levels()}

    def boom(*a, **k):
        raise AssertionError("host table or key upload on a steady regrid")
    monkeypatch.setattr(mapmod, "build_prolong_maps", boom)
    monkeypatch.setattr(dr, "upload_keys", boom)
    sim.regrid()                        # guaranteed steady
    for l in sim.levels():
        assert sim.u[l] is before[l], l


def test_gate_takes_the_host_maps_by_configuration(monkeypatch):
    from ramses_tpu_torch.mhd.amr import MhdAmrSim
    p = params_from_string(SEDOV.format(lmin=4, lmax=5), ndim=2)
    sim = AmrSim(p, dtype=torch.float64, device="cpu")
    assert sim._device_regrid_ok()
    sim.params.amr.device_regrid = False
    assert not sim._device_regrid_ok()
    sim.params.amr.device_regrid = True
    monkeypatch.setattr(dr, "keys_fit", lambda *a: False)
    assert not sim._device_regrid_ok()
    monkeypatch.undo()
    assert MhdAmrSim._needs_mig_log
    mhd = object.__new__(MhdAmrSim)
    mhd.params = p
    assert not mhd._device_regrid_ok()
    # beyond keys_fit the hierarchy regrids through the host maps
    sb, nb = _spied_run(monkeypatch, 2, True, regrids=1, lmax=5)
    monkeypatch.setattr(dr, "keys_fit", lambda *a: False)
    sc, nc = _spied_run(monkeypatch, 2, True, regrids=1, lmax=5)
    assert nc["maps"] == 0 and nc["host"] == nb["maps"] > 0
    for l in sb.levels():
        assert torch.equal(sb.u[l], sc.u[l])


def test_shrunk_config2_matches_jax():
    """Config 2 (sedov3d.nml with bench.py's criteria) at levelmin 4 /
    levelmax 6, both packages migrating on the device, 3 coarse steps a
    regrid each, f64 within rtol 1e-10.  The blast moves from the corner
    to the box's centre: at the corner the JAX package's restrict_upload
    leaves the refined flat cell 0 stale (ROADMAP §C)."""
    def setup(load):
        p = load(NML, ndim=3)
        p.amr.levelmin, p.amr.levelmax = 4, 6
        p.refine.err_grad_d = p.refine.err_grad_p = 0.1
        p.amr.device_regrid = True
        for c in (p.init.x_center, p.init.y_center, p.init.z_center):
            c[1] = 0.5 * p.amr.boxlen
        return p
    with jax.enable_x64(True):
        jsim = JAmrSim(setup(jload), dtype=jnp.float64)
        assert jsim._device_regrid_ok()
        jsim.evolve(1.0, nstepmax=3)
        ju = {l: np.asarray(jsim.u[l]) for l in jsim.levels()}
    psim = AmrSim(setup(load_params), dtype=torch.float64, device="cpu")
    n0 = {"maps": 0}
    real = dr.regrid_maps

    def counted(*a, **k):
        n0["maps"] += 1
        return real(*a, **k)
    dr.regrid_maps = counted
    try:
        psim.evolve(1.0, nstepmax=3)
    finally:
        dr.regrid_maps = real
    assert n0["maps"] > 0
    assert psim.levels() == jsim.levels() and len(psim.levels()) == 3
    assert psim.nstep == jsim.nstep == 3
    assert psim.t == pytest.approx(jsim.t, rel=1e-12)
    for l in psim.levels():
        assert np.array_equal(psim.tree.levels[l].keys,
                              jsim.tree.levels[l].keys), l
        n = psim.tree.noct(l) * 8
        np.testing.assert_allclose(psim.u[l].numpy()[:n], ju[l][:n],
                                   rtol=1e-10, atol=1e-14, err_msg=str(l))
