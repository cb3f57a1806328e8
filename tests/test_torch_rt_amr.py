"""Radiative transfer on the port's AMR hierarchy (``ramses_tpu_torch.rt.
amr``) against the JAX package's ``rt/amr.py``, on the CPU in f64: the
cases of ``tests/test_rt_amr.py`` and ``tests/test_rt_sed.py``.

* a complete level (levelmin = levelmax), gray and the 3-group He ladder;
* a refined front (levelmin 4, levelmax 5, heating) through coarse steps
  and regrids, so that the rows migrate through the host prolongation
  maps, gray and 2-group He;
* sink HII feedback (a hand-placed sink with one stellar object);
* SED stellar injection from a star particle (2D, 3 groups) with the group
  refresh;
* the UV background (``rt_uv_hom``).

Each case is held to the JAX package's run: the trees equal, then on every
level the leaf rows of ``rad``, ``xion``, ``xhe`` and the gas ``u`` within
1e-9 × each column's max (the momenta of a gas at rest, roundoff in the
JAX package's hydro and 0 in the port's, within 1e-9 × the state's
momentum scale sqrt(max rho · max E); leaves: the JAX package's
``restrict_upload``
can leave a refined flat cell 0 stale on XLA:CPU, ROADMAP §C1; the
covered cells are the restriction of the leaves in the port), and the
photon budget within rel 1e-9.  The JAX tests' own oracles run on the port
too.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.config import params_from_dict as jdict  # noqa: E402

from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import params_from_dict as pdict  # noqa: E402
from ramses_tpu_torch.convert import rt_amr_state_from  # noqa: E402

RUN_REL = 1e-9
UNITS = {"units_density": 1.66e-24, "units_time": 3.15e13,
         "units_length": 3.08e18}
REFINE = {"r_refine": [0.15] * 8, "x_refine": [0.5] * 8,
          "y_refine": [0.5] * 8, "z_refine": [0.5] * 8}
PATCH = {"r_refine": [-1.0, -1.0, -1.0, 0.25],
         "x_refine": [0.0, 0.0, 0.0, 0.5], "y_refine": [0.0, 0.0, 0.0, 0.5],
         "z_refine": [0.0, 0.0, 0.0, 0.5]}


def _rt_groups(lmin, lmax, refine=None, tend=0.01, **rt):
    g = {
        "run_params": {"hydro": True, "rt": True},
        "amr_params": {"levelmin": lmin, "levelmax": lmax, "boxlen": 1.0},
        "init_params": {"nregion": 1, "region_type": ["square"],
                        "x_center": [0.5], "y_center": [0.5],
                        "z_center": [0.5], "length_x": [10.0],
                        "length_y": [10.0], "length_z": [10.0],
                        "exp_region": [10.0], "d_region": [1.0],
                        "p_region": [1e-4]},
        "hydro_params": {"gamma": 5.0 / 3.0, "courant_factor": 0.5},
        "rt_params": dict({"rt_ndot": 1e48, "rt_c_fraction": 1e-4,
                           "rt_src_pos": [0.5, 0.5, 0.5], "rt_otsa": True},
                          **rt),
        "units_params": dict(UNITS),
        "output_params": {"tend": tend},
    }
    if refine:
        g["refine_params"] = refine
    return g


def _pair(g, ndim=3):
    js = JAmrSim(jdict(copy.deepcopy(g), ndim=ndim), dtype=jnp.float64)
    ps = AmrSim(pdict(copy.deepcopy(g), ndim=ndim), dtype=torch.float64,
                device="cpu")
    return js, ps


def _leaf_close(a, b, leaf, floor=0.0):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    n = leaf.shape[0]
    a, b = a[:n][leaf], b[:n][leaf]
    assert a.shape == b.shape and np.isfinite(a).all()
    scale = np.abs(b).max(axis=0) if b.ndim > 1 else np.abs(b).max()
    scale = np.maximum(scale, floor)
    assert (np.abs(a - b) <= RUN_REL * scale + 1e-300).all(), \
        np.abs(a - b).max(axis=0)


def _held(js, ps):
    assert js.levels() == ps.levels() and js.nstep == ps.nstep
    jr, pr = js.rt_amr, ps.rt_amr
    for l in js.levels():
        assert np.array_equal(js.tree.levels[l].keys, ps.tree.levels[l].keys)
        leaf = ~ps.tree.refined_mask(l)
        _leaf_close(pr.rad[l], jr.rad[l], leaf)
        _leaf_close(pr.xion[l], jr.xion[l], leaf)
        if jr.full3:
            _leaf_close(pr.xhe[l], jr.xhe[l], leaf)
        # the momenta of a gas at rest are roundoff (the JAX package's hydro
        # leaves ~1e-22 where the port's keeps 0): they are held to the
        # momentum scale sqrt(max rho · max E) of the state
        u = np.asarray(js.u[l])
        floor = np.zeros(u.shape[1])
        floor[1:1 + js.cfg.ndim] = np.sqrt(np.abs(u[:, 0]).max()
                                           * np.abs(u[:, 1 + js.cfg.ndim]).max())
        _leaf_close(ps.u[l], u, leaf, floor)
    st, jst = pr.rt_stats(ps), jr.rt_stats(js)
    for k in st:
        assert st[k] == pytest.approx(jst[k], rel=RUN_REL)
    assert pr.ionized_volume(ps) == pytest.approx(jr.ionized_volume(js),
                                                  rel=RUN_REL)


@pytest.mark.parametrize("groups", [1, 3])
def test_complete_level_matches_jax(groups):
    he = {} if groups == 1 else {"rt_ngroups": 3, "rt_y_he": 0.25,
                                 "rt_t_star": 1e5}
    js, ps = _pair(_rt_groups(4, 4, tend=0.004, **he))
    assert ps.rt_amr.ng == groups and ps.rt_amr.full3 == (groups > 1)
    js.evolve(0.004, nstepmax=3)
    ps.evolve(0.004, nstepmax=3)
    _held(js, ps)
    v = ps.rt_amr.ionized_volume(ps)
    assert v > 0.05
    if groups > 1:
        # the hard photons ionize helium too (the JAX test's oracle)
        xhe = ps.rt_amr.xhe[ps.lmin].numpy()
        assert float(xhe[:, 0].max()) > 1e-3
        assert (xhe >= 0).all() and (xhe.sum(axis=1) <= 1.0 + 1e-6).all()


def _front(groups):
    g = _rt_groups(4, 5, refine=REFINE, tend=0.001, rt_ndot=1e44,
                   **({} if groups == 1 else {"rt_ngroups": 2,
                                              "rt_y_he": 0.25,
                                              "rt_t_star": 1e5}))
    g["init_params"]["d_region"] = [10.0]
    return g


@pytest.mark.parametrize("groups", [1, 2])
def test_refined_front_with_regrid_migration_matches_jax(groups):
    js, ps = _pair(_front(groups))
    assert ps.tree.noct(5) > 0 and ps._needs_mig_log
    e0 = float(ps.totals()["energy"])
    v0 = ps.rt_amr.ionized_volume(ps)
    migrated = 0
    # the refined sphere grows, then shrinks back: new octs take their rows
    # from the coarser level (minmod), dropped octs' rows go
    for r in (0.25, 0.15):
        for s in (js, ps):
            s.step_coarse(0.0004)
            s.params.refine.r_refine = [r] * 8
            s.regrid()
        migrated += len(ps._mig_log)
        _held(js, ps)
    assert migrated == 2               # rows went through apply_migration
    # the JAX tests' oracles
    assert ps.rt_amr.ionized_volume(ps) > 1.5 * v0
    assert float(ps.totals()["energy"]) > e0          # photoheated
    lmax = max(ps.levels())
    x = ps.tree_order_cells(ps.rt_amr.xion[lmax], lmax)
    xc = ps.tree.cell_centers(lmax, ps.boxlen)
    rr = np.sqrt(((xc - 0.5) ** 2).sum(axis=1))
    if groups == 1:
        assert x.max() > 0.99
        near = x[rr < 0.04].mean()
        far = x[(rr > 0.11) & (rr < 0.145)].mean()
        assert near > 0.8 and far < 0.1, (near, far)
    for l in ps.levels():
        rad = ps.rt_amr.rad[l].numpy()
        assert np.isfinite(rad).all() and (rad[:, ::4] >= 0).all()


def test_rt_rows_carry_across_from_jax():
    js, ps = _pair(_front(1))
    js.step_coarse(0.0004)
    ps.step_coarse(0.0004)
    ps.rt_amr.load_state(**rt_amr_state_from(js))
    for l in js.levels():
        assert np.array_equal(ps.rt_amr.rad[l].numpy(),
                              np.asarray(js.rt_amr.rad[l]))
    # both advance the same rows against the same gas
    for l in js.levels():
        ps.u[l] = torch.from_numpy(np.array(js.u[l]))
    js.rt_amr.advance(js, 0.0002)
    ps.rt_amr.advance(ps, 0.0002)
    _held(js, ps)


def test_photon_conservation_on_refined_front():
    g = _rt_groups(4, 5, tend=0.01, refine=PATCH)
    g["init_params"]["d_region"] = [1e-12]     # optically thin
    js, ps = _pair(g)
    assert len(ps.levels()) == 2
    for _ in range(2):
        js.rt_amr.advance(js, 2e-3)
        ps.rt_amr.advance(ps, 2e-3)
    _held(js, ps)
    st = ps.rt_amr.rt_stats(ps)
    injected = 1e48 * 2 * 2e-3 * ps.rt_amr.un.scale_t
    assert st["injected"] == pytest.approx(injected, rel=1e-12)
    assert abs(st["photons"] - injected) / injected < 0.05


def _sink_sims(dens):
    g = _rt_groups(4, 5, tend=0.01, refine=PATCH, rt_ndot=0.0)
    g["init_params"]["d_region"] = [dens]
    js, ps = _pair(g)
    from ramses_tpu.pm.sinks import SinkSet as JSinkSet
    from ramses_tpu.pm.stellar import StellarSet as JStellarSet
    from ramses_tpu.pm.stellar import StellarSpec as JStellarSpec
    from ramses_tpu_torch.pm.sinks import SinkSet
    from ramses_tpu_torch.pm.stellar import StellarSet, StellarSpec
    for s, (Sink, Stellar, Spec) in ((js, (JSinkSet, JStellarSet,
                                           JStellarSpec)),
                                     (ps, (SinkSet, StellarSet,
                                           StellarSpec))):
        s.sinks = Sink(x=np.array([[0.5, 0.5, 0.5]]), v=np.zeros((1, 3)),
                       m=np.array([1.0]), tform=np.array([0.0]),
                       idp=np.array([7], np.int64), next_id=8)
        s.stellar = Stellar(m=np.array([40.0]), tform=np.array([0.0]),
                            tlife=np.array([1e30]),
                            x=np.array([[0.5, 0.5, 0.5]]),
                            sink_idp=np.array([7], np.int64),
                            idp=np.array([1], np.int64))
        s.stellar_spec = Spec(enabled=True, hii_t_myr=1e6)
    return js, ps


@pytest.mark.parametrize("dens,nadv,dt", [(1e-12, 2, 2e-3), (1.0, 3, 1e-3)])
def test_sink_hii_feedback_matches_jax(dens, nadv, dt):
    js, ps = _sink_sims(dens)
    for _ in range(nadv):
        js.rt_amr.advance(js, dt)
        ps.rt_amr.advance(ps, dt)
    assert ps.rt_amr._sink_src
    _held(js, ps)
    rt = ps.rt_amr
    if dens < 1e-6:
        # optically thin: the leaf photons are the injected S(M)·t
        sp = ps.stellar_spec
        S = sp.stf_k * (40.0 / sp.stf_m0) ** sp.stf_a \
            / (1.0 + (40.0 / sp.stf_m0) ** sp.stf_b) ** sp.stf_c
        injected = S * nadv * dt * rt.un.scale_t
        assert abs(rt.photon_total(ps) - injected) / injected < 0.05
    else:
        lmax = max(ps.levels())
        x = ps.tree_order_cells(rt.xion[lmax], lmax)
        xc = ps.tree.cell_centers(lmax, ps.boxlen)
        rr = np.sqrt(((xc - 0.5) ** 2).sum(axis=1))
        assert x[rr < 0.05].mean() > 0.9            # HII around the sink


def test_sed_stellar_injection_matches_jax(tmp_path):
    from ramses_tpu.config import Params as JParams
    from ramses_tpu.pm.particles import FAM_STAR as JFAM_STAR
    from ramses_tpu.pm.particles import ParticleSet as JParticleSet
    from ramses_tpu.rt.sed import blackbody_library, write_sed_dir

    from ramses_tpu_torch.config import Params
    from ramses_tpu_torch.pm.particles import FAM_STAR, ParticleSet
    from ramses_tpu_torch.rt import sed as psed
    d = str(tmp_path / "seds")
    lib = blackbody_library(lambda age: 1e5 / (1.0 + 10.0 * age),
                            np.array([0.0, 0.001, 0.01, 0.1, 1.0]),
                            np.array([0.001, 0.02]))
    write_sed_dir(d, lib)
    # the port reads the same directory bit for bit
    plib = psed.read_sed_dir(d)
    assert np.array_equal(plib.seds, lib.seds)

    def params(P):
        p = P(ndim=2)
        p.run.rt = True
        p.amr.levelmin, p.amr.levelmax = 4, 4
        p.init.nregion = 1
        p.init.region_type = ["square"]
        p.init.x_center, p.init.y_center = [0.5], [0.5]
        p.init.length_x, p.init.length_y = [10.0], [10.0]
        p.init.exp_region = [10.0]
        p.init.d_region, p.init.p_region = [1.0], [1e-4]
        p.init.u_region, p.init.v_region = [0.0], [0.0]
        p.rt.rt_ngroups = 3
        p.rt.rt_y_he = 0.25
        p.rt.sed_dir = d
        p.rt.sedprops_update = 1
        return p
    jps = JParticleSet.make(jnp.asarray([[0.5, 0.5]]), jnp.zeros((1, 2)),
                            jnp.asarray([1e-3]),
                            family=np.array([JFAM_STAR]))
    jps = dataclasses.replace(jps, tp=jnp.asarray([-0.01]),
                              zp=jnp.asarray([0.02]))
    js = JAmrSim(params(JParams), particles=jps, dtype=jnp.float64)
    pps = ParticleSet.make([[0.5, 0.5]], [[0.0, 0.0]], [1e-3],
                           dtype=torch.float64, device="cpu",
                           family=[FAM_STAR])
    pps = dataclasses.replace(pps, tp=torch.tensor([-0.01],
                                                   dtype=torch.float64),
                              zp=torch.tensor([0.02], dtype=torch.float64))
    ps = AmrSim(params(Params), particles=pps, dtype=torch.float64,
                device="cpu")
    assert ps.rt_amr.sed is not None
    n0 = ps.rt_amr.rad[4][:, 0].sum()
    js.rt_amr.advance(js, 1e-10)
    ps.rt_amr.advance(ps, 1e-10)
    _held(js, ps)
    assert float(ps.rt_amr.rad[4][:, 0].sum()) > float(n0) * 1.001
    for a, b in zip(js.rt_amr.spec.groups3, ps.rt_amr.spec.groups3):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_uv_background_matches_jax():
    g = _rt_groups(4, 4, tend=0.004)
    g["rt_params"]["rt_uv_hom"] = True
    g["cooling_params"] = {"J21": 1.0, "a_spec": 1.0}
    g["init_params"]["d_region"] = [1e-4]
    js, ps = _pair(g)
    js.rt_amr.advance(js, 5e-4)
    ps.rt_amr.advance(ps, 5e-4)
    assert ps.rt_amr._uv is not None
    _held(js, ps)
    # the background ionizes the far, optically thin gas
    x = ps.tree_order_cells(ps.rt_amr.xion[4], 4)
    assert float(np.median(x)) > 1.2e-3


def test_restart_rebuilds_the_rt_rows_fresh(tmp_path):
    g = _front(1)
    ps = AmrSim(pdict(copy.deepcopy(g), ndim=3), dtype=torch.float64,
                device="cpu")
    ps.step_coarse(0.0004)
    out = ps.dump(1, str(tmp_path))
    back = AmrSim.from_checkpoint_dir(pdict(copy.deepcopy(g), ndim=3), out,
                                      dtype=torch.float64, device="cpu")
    assert back.rt_amr is not None and back._needs_mig_log
    assert back.rt_amr.rt_stats(back)["injected"] == 0.0
    for l in back.levels():
        assert torch.equal(back.rt_amr.rad[l],
                           back.rt_amr._fresh_rad(back.maps[l].ncell_pad))
