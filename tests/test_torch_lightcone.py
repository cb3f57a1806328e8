"""The port's lightcone (``ramses_tpu_torch/pm/lightcone.py`` and its emission
in ``AmrSim``'s coarse step) against the JAX package's, on the CPU in f64.

* ``shell_radii``, ``rotation_matrix``, ``_replica_shifts`` and
  ``cone_selection`` (full sky, an opening angle, a rotation, the
  rectangular cut, velocities), and ``Cosmology.aexp_of_chi`` on arrays:
  integers equal, floats within ``FIELD`` (1e-12) of their scale (the same
  numpy arithmetic, and the port's interpolation of the Friedmann tables);
* ``tests/test_cosmo_ics.py::test_lightcone_emission_during_cosmo_run``'s
  run (16³ single-mode grafic ICs, levelmin = levelmax = 4, full sky,
  ``zmax_cone = 1000``, 6 coarse steps) on both packages' ``AmrSim``, in a
  box of ``BOX`` Mpc/h instead of 100: at 100 Mpc/h a step's shell lies
  ~51 box lengths away, so that a full-sky cone is ~1 GB of compressed
  file a step and minutes of ``cone_selection`` on one CPU core, where at
  3,000 Mpc/h it lies 1.7 box lengths away (the dynamics of the EdS box
  are the same; only the comoving distance in box lengths scales).  The
  same
  ``cone_NNNNN.npz`` files, their particle arrays within ``STATE`` (1e-10)
  of their scale, the f64 hierarchy's tolerance for particle positions in
  ``tests/test_torch_cosmo.py``; the JAX test's checks on the port's cones
  (shells tile the lookback distance, nearer shells later), each ``a_emit``
  between its step's two epochs; and a restore that emits its first
  shell, equal to the JAX package's restore of the same dump.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.config import Params as JParams  # noqa: E402
from ramses_tpu.driver import load_cosmo_ics as jload_ics  # noqa: E402
from ramses_tpu.hydro.core import HydroStatic as JHydro  # noqa: E402
from ramses_tpu.pm import lightcone as jlc  # noqa: E402
from ramses_tpu.pm.cosmology import Cosmology as JCosmology  # noqa: E402

from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import Params  # noqa: E402
from ramses_tpu_torch.driver import load_cosmo_ics  # noqa: E402
from ramses_tpu_torch.hydro.core import HydroStatic  # noqa: E402
from ramses_tpu_torch.pm import cosmology as pcosmo  # noqa: E402
from ramses_tpu_torch.pm import lightcone as lc  # noqa: E402

from ramses_tpu.io import grafic as jgrafic  # noqa: E402
from ramses_tpu.pm import init_part as jinit  # noqa: E402

from test_torch_cosmo import STATE, _close, _params  # noqa: E402

FIELD = 1e-12
BOX = 3000.0       # Mpc/h: the lightcone run's box (see above)


def _cosmos():
    kw = dict(omega_m=0.3, omega_l=0.7, omega_k=0.0, aexp_ini=0.02,
              boxlen_ini=100.0)
    return pcosmo.Cosmology(**kw), JCosmology(**kw)


def test_shell_radii_and_emission_epochs_match_jax():
    pc, jc = _cosmos()
    for a1, a2 in ((0.02, 0.021), (0.3, 0.31), (0.9, 1.0)):
        got, want = lc.shell_radii(pc, a1, a2), jlc.shell_radii(jc, a1, a2)
        assert got == pytest.approx(want, rel=FIELD)
    chi = np.linspace(0.0, float(pc.chi_of_aexp(0.05)), 1001)
    _close(pc.aexp_of_chi(chi), np.asarray(jc.aexp_of_chi(chi)), FIELD,
           "aexp_of_chi")
    assert pc.aexp_of_chi(float(chi[500])) == pytest.approx(
        float(jc.aexp_of_chi(chi[500])), rel=FIELD)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("r1,r2", [(0.0, 0.4), (0.3, 0.9), (2.6, 3.1)])
def test_replica_shifts_match_jax(ndim, r1, r2):
    obs = np.full(ndim, 0.5)
    got = lc._replica_shifts(obs, r1, r2, 1.0, ndim)
    want = jlc._replica_shifts(obs, r1, r2, 1.0, ndim)
    assert np.array_equal(got, want) and len(got) > 0


def test_rotation_matrix_matches_jax():
    for ty, tz in ((0.0, 0.0), (0.3, -0.7), (0.2, 0.1), (np.pi / 2, 2.0)):
        assert np.array_equal(lc.rotation_matrix(ty, tz),
                              jlc.rotation_matrix(ty, tz))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(opening=np.radians(30.0), axis=(0, 0, 1.0)),
    dict(rotation=jlc.rotation_matrix(0.3, -0.7), opening=0.5,
         axis=(1.0, 0, 0)),
    dict(half_angles=(np.radians(12.5), np.radians(20.0)),
         rotation=jlc.rotation_matrix(0.2, 0.1)),
], ids=["full_sky", "opening", "rotated", "rectangular"])
def test_cone_selection_matches_jax(kw):
    rng = np.random.default_rng(3)
    x = rng.random((3000, 3))
    v = rng.normal(0.0, 1.0, (3000, 3))
    obs = (0.5, 0.5, 0.5)
    got = lc.cone_selection(x, obs, 0.7, 1.6, boxlen=1.0, v=v, **kw)
    want = jlc.cone_selection(x, obs, 0.7, 1.6, boxlen=1.0, v=v, **kw)
    assert np.array_equal(got[2], want[2]) and len(got[2]) > 0
    _close(got[0], want[0], FIELD, "pos")
    _close(got[1], want[1], FIELD, "r")


def _box_ics(dirname, n=16, amp=0.02):
    """``tests/test_cosmo_ics.py``'s single mode δ = amp·cos(2πx) with its
    Zel'dovich velocities (EdS, astart 0.02) in a box of ``BOX`` Mpc/h,
    written by the JAX package."""
    x = (np.arange(n) + 0.5) / n
    delta = (amp * np.cos(2 * np.pi * x))[:, None, None] * np.ones((1, n, n))
    hdr = jgrafic.GraficHeader(n, n, n, dx=BOX / n, astart=0.02,
                               omega_m=1.0, omega_v=0.0, h0=70.0)
    jgrafic.write_zeldovich_ics(dirname, delta, hdr,
                                jinit.fpeebl(0.02, 1.0, 0.0, 0.0))


def _cone_params(cls, initdir, outdir):
    p = _params(cls, 4, 4, initdir, True, omega_b=0.0)
    p.raw["cosmo_params"]["boxlen_ini"] = BOX
    p.run.lightcone = True
    p.lightcone.zmax_cone = 1000.0          # the whole run emits
    p.lightcone.thetay_cone = 90.0          # full sky
    p.lightcone.thetaz_cone = 90.0
    p.output.output_dir = str(outdir)
    return p


def _sims(d, out_p, out_j):
    sims = []
    for cls, load, hydro_cls, sim_cls, kw, out in (
            (JParams, jload_ics, JHydro, JAmrSim,
             dict(dtype=jnp.float64), out_j),
            (Params, load_cosmo_ics, HydroStatic, AmrSim,
             dict(dtype=torch.float64, device="cpu"), out_p)):
        p = _cone_params(cls, d, out)
        cosmo = (JCosmology if cls is JParams
                 else pcosmo.Cosmology).from_params(p)
        extra = (() if cls is JParams else (torch.float64, "cpu"))
        parts, dense = load(p, cosmo, hydro_cls.from_params(p), (16,) * 3,
                            *extra)
        sims.append(sim_cls(p, particles=parts, init_dense_u=dense, **kw))
    return sims


def _cones(out):
    return sorted(os.path.basename(c)
                  for c in glob.glob(os.path.join(str(out), "cone_*.npz")))


def _same_cone(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    assert np.array_equal(za["idx"], zb["idx"]) and len(za["idx"]) > 0
    assert float(za["aexp"]) == pytest.approx(float(zb["aexp"]), rel=FIELD)
    for k in ("pos", "r", "vel", "a_emit"):
        _close(za[k], zb[k], STATE, k)


@pytest.fixture(scope="module")
def cone_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cone")
    d = str(base / "ics")
    _box_ics(d)
    jsim, psim = _sims(d, base / "p", base / "j")
    tau_end = float(jsim.cosmo.tau_of_aexp(0.03))
    epochs = {"p": [psim.aexp_now()], "j": [jsim.aexp_now()]}
    for _ in range(6):
        if jsim.t >= tau_end * (1 + 1e-12):
            break
        dt = jsim.coarse_dt()
        assert psim.coarse_dt() == pytest.approx(dt, rel=1e-12)
        jsim.step_coarse(dt)
        psim.step_coarse(dt)
        epochs["j"].append(jsim.aexp_now())
        epochs["p"].append(psim.aexp_now())
    return base, jsim, psim, epochs


def test_lightcone_emission_matches_jax(cone_runs):
    base, jsim, psim, epochs = cone_runs
    names = _cones(base / "p")
    assert names == _cones(base / "j")
    # one shell a coarse step, the first one included, named by the step
    # count before the step (the source passes run before it grows)
    assert names == [f"cone_{k:05d}.npz" for k in range(psim.nstep)]
    assert len(names) >= 2
    for n in names:
        _same_cone(base / "p" / n, base / "j" / n)
    r_ranges = []
    for k, n in enumerate(names):
        z = np.load(base / "p" / n)
        assert z["pos"].shape == z["vel"].shape
        assert len(z["r"]) == len(z["a_emit"]) == len(z["pos"])
        a0, a1 = epochs["p"][k], epochs["p"][k + 1]
        assert float(z["aexp"]) == a1
        assert (z["a_emit"] >= a0 - 1e-12).all()
        assert (z["a_emit"] <= a1 + 1e-12).all()
        o = np.argsort(z["r"])
        assert z["a_emit"][o][0] >= z["a_emit"][o][-1] - 1e-12
        r_ranges.append((z["r"].min(), z["r"].max()))
    # consecutive shells tile the lookback distance (later steps emit
    # NEARER shells), with no overlap beyond roundoff
    for (lo1, hi1), (lo0, hi0) in zip(r_ranges[1:], r_ranges[:-1]):
        assert hi1 <= lo0 + 1e-8


def test_restore_emits_its_first_shell_as_jax(cone_runs, tmp_path):
    _, jsim, _psim, _ = cone_runs
    jo = jsim.dump(1, str(tmp_path / "dump"))
    out = {}
    for name, restore, kw in (
            ("j", JAmrSim.from_snapshot, dict(dtype=jnp.float64)),
            ("p", AmrSim.from_snapshot,
             dict(dtype=torch.float64, device="cpu"))):
        params = _cone_params(JParams if name == "j" else Params,
                              jsim.params.init.initfile[0], tmp_path / name)
        sim = restore(params, jo, **kw)
        assert sim._cone_aexp_prev == sim.aexp_now()
        sim.step_coarse(sim.coarse_dt())
        out[name] = _cones(tmp_path / name)
    assert out["p"] == out["j"] == [f"cone_{jsim.nstep:05d}.npz"]
    _same_cone(tmp_path / "p" / out["p"][0], tmp_path / "j" / out["j"][0])
