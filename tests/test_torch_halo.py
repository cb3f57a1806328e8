"""The port's halo chain (``ramses_tpu_torch/pm/halo.py``, ``utils/halos.py``
and ``AmrSim``'s in-run clump pass) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the JAX
package runs as its own tests run it (x64).  Tolerances: bound masks,
labels, ids and indices equal; floats within ``REL`` (1e-12) of their
scale; the files (``write_halo_table``, ``MergerTree.write``, the in-run
``clump_NNNNN.txt`` and ``mergertree_NNNNN.txt``) byte for byte.

* ``unbind_clump`` with every option (``saddle_pot``, ``nmassbins``,
  ``logbins``), ``build_catalogue``, ``link_catalogues`` and ``MergerTree``
  over three snapshots, on ``tests/test_halo.py``'s systems;
* ``utils.halos.catalogue_from_arrays``;
* ``AmrSim(..., device="cpu")`` with ``clumpfind`` on
  ``tests/test_halo.py::test_runtime_clumpfind_at_outputs``'s set-up: the
  files of two dumps, the catalogues, and a fresh sim's tree rebuilt from
  the other package's ``clump_cat_NNNNN.npz``, in both directions;
* ``python -m ramses_tpu_torch.utils.halos`` on the port's dumps against
  the JAX package's CLI on the same dumps.
"""

import os
import shutil
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.amr.hierarchy import AmrSim as JAmrSim  # noqa: E402
from ramses_tpu.config import Params as JParams  # noqa: E402
from ramses_tpu.pm import clumps as jclumps  # noqa: E402
from ramses_tpu.pm import halo as jhalo  # noqa: E402
from ramses_tpu.pm.particles import ParticleSet as JParticleSet  # noqa: E402
from ramses_tpu.utils import halos as jhalos  # noqa: E402

from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import Params  # noqa: E402
from ramses_tpu_torch.pm import clumps  # noqa: E402
from ramses_tpu_torch.pm import halo  # noqa: E402
from ramses_tpu_torch.pm.particles import ParticleSet  # noqa: E402
from ramses_tpu_torch.resilience import checkpoint as ckpt  # noqa: E402
from ramses_tpu_torch.utils import halos  # noqa: E402

REL = 1e-12


def _blob(rng, center, n, sigma_x, sigma_v, m=1.0):
    x = rng.normal(center, sigma_x, (n, 3))
    v = rng.normal(0.0, sigma_v, (n, 3))
    return x, v, np.full(n, m)


def _two_halo_system(seed):
    """``tests/test_halo.py``'s two bound blobs and diffuse background."""
    rng = np.random.default_rng(seed)
    x1, v1, m1 = _blob(rng, [0.3, 0.5, 0.5], 400, 0.02, 0.5)
    x2, v2, m2 = _blob(rng, [0.7, 0.5, 0.5], 200, 0.02, 0.35)
    xb = rng.uniform(0, 1, (100, 3))
    vb = rng.normal(0, 0.1, (100, 3))
    x = np.mod(np.concatenate([x1, x2, xb]), 1.0)
    v = np.concatenate([v1, v2, vb])
    m = np.concatenate([m1, m2, np.full(100, 1.0)])
    return x, v, m, np.arange(len(m), dtype=np.int64)


def _labels(x, m, n=32):
    """NGP deposit → watershed → per-particle labels, each package's own
    chain; the two must agree."""
    dx = 1.0 / n
    idx = tuple(np.clip((x[:, d] / dx).astype(int), 0, n - 1)
                for d in range(3))
    rho = np.zeros((n, n, n))
    np.add.at(rho, idx, m / dx ** 3)
    thr = float(rho.mean()) * 3.0
    lab, _ = clumps.find_clumps(rho, thr, relevance=1.5, dx=dx, device="cpu")
    jlab, _ = jclumps.find_clumps(rho, thr, relevance=1.5, dx=dx)
    assert np.array_equal(lab, np.asarray(jlab))
    pl = halo.particle_labels(x, lab, dx, 1.0)
    assert np.array_equal(pl, jhalo.particle_labels(x, np.asarray(jlab), dx,
                                                    1.0))
    return pl


def _close(got, want, what=""):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-300)
    assert float(np.abs(got - want).max(initial=0.0)) <= REL * scale, what


def _same_halos(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.index, a.npart) == (b.index, b.npart)
        assert np.array_equal(a.ids, b.ids) and a.ids.dtype == b.ids.dtype
        for k in ("mass", "pos", "vel", "ekin", "epot"):
            _close(getattr(a, k), getattr(b, k), f"halo {a.index} {k}")


def _unbinding_system():
    """``tests/test_halo.py::test_unbinding_option_set``'s virial blob, and
    ``test_unbind_strips_fast_interloper``'s cold blob with an escaper."""
    rng = np.random.default_rng(9)
    x = 0.5 + rng.normal(0, 0.01, (400, 3))
    v = rng.normal(0, 0.5, (400, 3))
    rng2 = np.random.default_rng(2)
    x2, v2, m2 = _blob(rng2, [0.5, 0.5, 0.5], 300, 0.02, 0.0)
    v2[0] = [1e4, 0.0, 0.0]
    return [(x, v, np.ones(400)), (x2, v2, m2)]


@pytest.mark.parametrize("saddle_pot", [False, True])
@pytest.mark.parametrize("nmassbins,logbins", [(0, True), (25, True),
                                               (25, False), (100, True)])
def test_unbind_clump_matches_jax(saddle_pot, nmassbins, logbins):
    for x, v, m in _unbinding_system():
        c = np.full(3, 0.5)
        kw = dict(G=1.0, saddle_pot=saddle_pot, nmassbins=nmassbins,
                  logbins=logbins)
        got = halo.unbind_clump(x, v, m, c, 1.0, **kw)
        want = jhalo.unbind_clump(x, v, m, c, 1.0, **kw)
        assert got.dtype == want.dtype == bool
        assert np.array_equal(got, want) and 0 < got.sum() <= len(m)
        r = np.sqrt(((x - c) ** 2).sum(1))
        _close(halo._sphere_potential(r, m, 1.0),
               jhalo._sphere_potential(r, m, 1.0), "sphere")
        if nmassbins:
            _close(halo._binned_potential(r, m, 1.0, nmassbins, logbins),
                   jhalo._binned_potential(r, m, 1.0, nmassbins, logbins),
                   "binned")


@pytest.mark.parametrize("kw", [dict(), dict(unbind=False),
                                dict(saddle_pot=True, nmassbins=100),
                                dict(nmassbins=25, logbins=False,
                                     npart_min=50)],
                         ids=["default", "no_unbind", "saddle_binned",
                              "linbins"])
def test_build_catalogue_matches_jax(tmp_path, kw):
    x, v, m, ids = _two_halo_system(3)
    pl = _labels(x, m)
    got = halo.build_catalogue(x, v, m, ids, pl, 1.0, G=1.0, **kw)
    want = jhalo.build_catalogue(x, v, m, ids, pl, 1.0, G=1.0, **kw)
    _same_halos(got, want)
    halo.write_halo_table(got, str(tmp_path / "p.txt"))
    jhalo.write_halo_table(want, str(tmp_path / "j.txt"))
    assert (tmp_path / "p.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


def _three_snapshots():
    """``tests/test_halo.py::test_merger_history_three_snapshots``: A and B
    merge, D drops out of one catalogue and comes back."""
    rng = np.random.default_rng(4)
    n = 64
    dx = 1.0 / n

    def blob(center, npart, id0, sigma=0.01):
        x = np.mod(rng.normal(center, sigma, (npart, 3)), 1.0)
        return x, id0 + np.arange(npart)

    def catalogue(blobs, mod):
        xs = np.concatenate([b[0] for b in blobs])
        ids = np.concatenate([b[1] for b in blobs])
        rho, _ = np.histogramdd(xs, bins=(n,) * 3, range=[(0.0, 1.0)] * 3)
        fc = (jclumps.find_clumps if mod is jhalo else
              lambda *a, **k: clumps.find_clumps(*a, device="cpu", **k))
        labels, _ = fc(rho, threshold=3.0, dx=dx)
        pl = mod.particle_labels(xs, np.asarray(labels), dx, 1.0)
        return mod.build_catalogue(xs, np.zeros_like(xs), np.ones(len(xs)),
                                   ids, pl, 1.0, npart_min=20)

    a1 = blob([0.3, 0.5, 0.5], 500, 0)
    b1 = blob([0.7, 0.5, 0.5], 250, 1000)
    d1 = blob([0.5, 0.15, 0.5], 80, 2000)
    ab2 = (np.mod(rng.normal([0.5, 0.5, 0.5], 0.012, (750, 3)), 1.0),
           np.concatenate([a1[1], b1[1]]))
    dgone = (np.mod(rng.normal([0.85, 0.85, 0.85], 0.15, (80, 3)), 1.0),
             d1[1])
    ab3 = (np.mod(rng.normal([0.52, 0.5, 0.5], 0.012, (750, 3)), 1.0),
           ab2[1])
    d3 = blob([0.5, 0.15, 0.5], 80, 2000)
    snaps = [[a1, b1, d1], [ab2, dgone], [ab3, d3]]
    return ([catalogue(s, halo) for s in snaps],
            [catalogue(s, jhalo) for s in snaps])


def test_link_catalogues_and_merger_tree_match_jax(tmp_path):
    cats, jcats = _three_snapshots()
    for a, b in zip(cats, jcats):
        _same_halos(a, b)
    for nmb in (0, 30):
        got = halo.link_catalogues(cats[0], cats[1], nmost_bound=nmb,
                                   snap_prog=0)
        want = jhalo.link_catalogues(jcats[0], jcats[1], nmost_bound=nmb,
                                     snap_prog=0)
        assert [(l.desc, l.prog, l.shared, l.main, l.frac, l.snap_prog)
                for l in got] == [(l.desc, l.prog, l.shared, l.main, l.frac,
                                   l.snap_prog) for l in want] != []
    for nmb, gap in ((0, 2), (40, 2), (0, 1)):
        tree = halo.MergerTree(max_gap=gap, nmost_bound=nmb)
        jtree = jhalo.MergerTree(max_gap=gap, nmost_bound=nmb)
        for k, (a, b) in enumerate(zip(cats, jcats)):
            tree.add_snapshot(float(k), a)
            jtree.add_snapshot(float(k), b)
        tree.write(str(tmp_path / "p.txt"))
        jtree.write(str(tmp_path / "j.txt"))
        assert (tmp_path / "p.txt").read_bytes() == \
            (tmp_path / "j.txt").read_bytes()
        top = cats[2][0].index
        assert tree.main_branch(2, top) == jtree.main_branch(2, top)
    # the history the JAX test checks by hand: D links across the gap
    # when max_gap reaches it (2), not at max_gap 1 (the last tree above)
    assert not any(l.snap_prog == 0
                   for l in tree.progenitors(2, cats[2][1].index))
    tree = halo.MergerTree(max_gap=2)
    for k, a in enumerate(cats):
        tree.add_snapshot(float(k), a)
    gap = [l for l in tree.progenitors(2, cats[2][1].index) if l.main][0]
    assert gap.snap_prog == 0 and gap.prog == cats[0][2].index


@pytest.mark.parametrize("kw", [dict(), dict(saddle_threshold=3.0e3,
                                             saddle_pot=True,
                                             nmassbins=100)],
                         ids=["default", "saddle"])
def test_catalogue_from_arrays_matches_jax(kw):
    x, v, m, ids = _two_halo_system(5)
    got = halos.catalogue_from_arrays(x, v, m, ids, 1.0, nx=32,
                                      threshold_over_mean=3.0,
                                      device="cpu", **kw)
    want = jhalos.catalogue_from_arrays(x, v, m, ids, 1.0, nx=32,
                                        threshold_over_mean=3.0, **kw)
    _same_halos(got, want)


# ---------------------------------------------------------------------------
# the in-run clump pass
# ---------------------------------------------------------------------------

def _clump_params(cls):
    """``tests/test_halo.py::test_runtime_clumpfind_at_outputs``'s run."""
    p = cls(ndim=3)
    p.run.hydro = True
    p.run.pic = True
    p.run.clumpfind = True
    p.clumpfind.nx_clump = 32
    p.clumpfind.npart_min = 20
    p.amr.levelmin = p.amr.levelmax = 4
    p.init.nregion = 1
    p.init.region_type = ["square"]
    p.init.x_center, p.init.y_center, p.init.z_center = [0.5], [0.5], [0.5]
    p.init.length_x = p.init.length_y = p.init.length_z = [10.0]
    p.init.exp_region = [10.0]
    p.init.d_region, p.init.p_region = [1.0], [1.0]
    p.init.u_region, p.init.v_region = [0.0], [0.0]
    p.init.w_region = [0.0]
    return p


def _clump_particles():
    rng = np.random.default_rng(6)
    x = np.concatenate([
        np.mod(rng.normal([0.3, 0.5, 0.5], 0.02, (300, 3)), 1.0),
        rng.uniform(0, 1, (60, 3))])
    v = np.random.default_rng(7).normal(0.0, 0.05, (360, 3))
    return x, v, np.full(360, 1.0 / 360)


def _port_sim(**clump):
    x, v, m = _clump_particles()
    p = _clump_params(Params)
    for k, val in clump.items():
        setattr(p.clumpfind, k, val)
    return AmrSim(p, dtype=torch.float64, device="cpu",
                  particles=ParticleSet.make(x, v, m, dtype=torch.float64,
                                             device="cpu"))


def _jax_sim(**clump):
    x, v, m = _clump_particles()
    p = _clump_params(JParams)
    for k, val in clump.items():
        setattr(p.clumpfind, k, val)
    return JAmrSim(p, dtype=jnp.float64, particles=JParticleSet.make(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(m)))


CLUMP_FILES = ("clump_00001.txt", "clump_00002.txt", "mergertree_00002.txt")


@pytest.fixture(scope="module")
def clump_runs(tmp_path_factory):
    """Both packages' sims dumped twice, each into its own directory."""
    base = tmp_path_factory.mktemp("clumpfind")
    out = {}
    for name, make in (("port", _port_sim), ("jax", _jax_sim)):
        sim = make(mass_threshold=5.0)
        for iout in (1, 2):
            sim.dump(iout, str(base / name))
        out[name] = base / name
    return out


def _file(d, iout, name):
    return d / f"output_{iout:05d}" / name


def test_runtime_clumpfind_files_match_jax(clump_runs):
    p, j = clump_runs["port"], clump_runs["jax"]
    for name in CLUMP_FILES:
        iout = int(name[-9:-4])
        assert _file(p, iout, name).read_bytes() == \
            _file(j, iout, name).read_bytes(), name
    rows = np.atleast_2d(np.loadtxt(_file(p, 1, "clump_00001.txt")))
    assert rows.shape[0] >= 1 and rows[0, 1] >= 200      # the blob
    tree = np.atleast_2d(np.loadtxt(_file(p, 2, "mergertree_00002.txt")))
    assert tree.shape[0] >= 1 and tree[0, 6] == 1          # main progenitor
    for iout in (1, 2):
        a = np.load(_file(p, iout, f"clump_cat_{iout:05d}.npz"))
        b = np.load(_file(j, iout, f"clump_cat_{iout:05d}.npz"))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            if a[k].dtype.kind == "f":
                _close(a[k], b[k], k)
            else:
                assert np.array_equal(a[k], b[k]), k
        # under the dump's manifest
        ok, why = ckpt.validate_checkpoint(str(p / f"output_{iout:05d}"))
        assert ok, why
        man = (p / f"output_{iout:05d}" / "manifest.json").read_text()
        assert f"clump_cat_{iout:05d}.npz" in man
        assert f"clump_{iout:05d}.txt" in man


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_tree_rebuilds_from_the_other_packages_catalogues(clump_runs,
                                                          tmp_path,
                                                          direction):
    """A fresh sim (a restart: no tree in memory) dumping output 3 beside
    the other package's outputs 1 and 2 rebuilds the tree from their
    ``clump_cat_*.npz`` and writes the ``mergertree_00003.txt`` that each
    package writes beside its own."""
    src, dst = (("jax", "port") if direction == "port_reads_jax"
                else ("port", "jax"))
    make = {"port": _port_sim, "jax": _jax_sim}
    want_dir = tmp_path / "own"
    shutil.copytree(clump_runs[src], want_dir)
    make[src](mass_threshold=5.0).dump(3, str(want_dir))
    got_dir = tmp_path / "cross"
    shutil.copytree(clump_runs[src], got_dir)
    make[dst](mass_threshold=5.0).dump(3, str(got_dir))
    got = _file(got_dir, 3, "mergertree_00003.txt").read_bytes()
    assert got == _file(want_dir, 3, "mergertree_00003.txt").read_bytes()
    tree = np.atleast_2d(np.loadtxt(_file(got_dir, 3,
                                          "mergertree_00003.txt")))
    assert set(tree[:, 0]) == {1, 2} and tree[-1, 6] == 1


def test_clumpfind_skips_a_malformed_catalogue_and_warns_without_particles(
        clump_runs, tmp_path):
    d = tmp_path / "runs"
    shutil.copytree(clump_runs["port"], d)
    _file(d, 1, "clump_cat_00001.npz").write_bytes(b"not a zip")
    with pytest.warns(UserWarning, match="malformed clump catalogue"):
        _port_sim(mass_threshold=5.0).dump(3, str(d))
    tree = np.atleast_2d(np.loadtxt(_file(d, 3, "mergertree_00003.txt")))
    assert set(tree[:, 0]) == {1}      # linked to output 2 alone
    p = _clump_params(Params)
    p.run.pic = False
    sim = AmrSim(p, dtype=torch.float64, device="cpu")
    with pytest.warns(UserWarning, match="needs particles"):
        sim.dump(1, str(tmp_path / "nopart"))
    assert not [f for f in os.listdir(tmp_path / "nopart" / "output_00001")
                if f.startswith(("clump", "mergertree"))]


def test_halo_cli_on_the_ports_dumps_matches_jax(clump_runs, tmp_path,
                                                 capsys):
    d = tmp_path / "runs"
    shutil.copytree(clump_runs["port"], d)
    outs = [str(d / f"output_{i:05d}") for i in (1, 2)]
    args = ["--nx", "32", "--threshold-over-mean", "3", "--saddle-pot",
            "--nmassbins", "50"]
    want = {}
    assert jhalos.main(outs + args + ["--tree", str(tmp_path / "j.txt")]) \
        == 0
    for o in outs:
        want[o] = open(os.path.join(o, "halos.txt"), "rb").read()
    assert halos.main(outs + args + ["--tree", str(tmp_path / "p.txt"),
                                     "--device", "cpu"]) == 0
    for o in outs:
        assert open(os.path.join(o, "halos.txt"), "rb").read() == want[o]
    assert (tmp_path / "p.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    rows = np.atleast_2d(np.loadtxt(os.path.join(outs[0], "halos.txt")))
    assert rows.shape[0] >= 1 and rows[0, 1] >= 200
    assert "merger tree:" in capsys.readouterr().out
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                halos.main(outs[:1])


def test_mergertree_nml_through_the_cli(tmp_path, monkeypatch):
    """``namelists/mergertree.nml`` through the port's CLI on the CPU, shrunk
    as ``tests/test_cosmo_ics.py::test_shipped_cosmo_namelists_run_through_
    cli`` shrinks it (16³ single-mode ICs, levelmin 4, levelmax 5, 2 coarse
    steps, one output at the end): the clump table and catalogue land in
    the output under its manifest, the table byte for byte the JAX CLI's;
    without ``--device cpu`` the CLI asks for the card."""
    import re

    from ramses_tpu.__main__ import main as jmain

    from ramses_tpu_torch.__main__ import main as pmain
    from test_torch_cosmo import _mode_ics

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    txt = open(os.path.join(root, "namelists", "mergertree.nml")).read()
    txt = re.sub(r"levelmin=\d+", "levelmin=4", txt)
    txt = re.sub(r"levelmax=\d+", "levelmax=5", txt)
    txt = txt.replace("&RUN_PARAMS", "&RUN_PARAMS\nnstepmax=2", 1)
    txt = re.sub(r"aout=[0-9.,]+", "aout=1.0", txt)
    txt = re.sub(r"noutput=\d+", "noutput=1", txt)
    for name in ("p", "j"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "mergertree.nml").write_text(txt)
        _mode_ics(str(tmp_path / name / "grafic_files"), n=16, amp=0.02)
    monkeypatch.chdir(tmp_path / "j")
    assert jmain(["mergertree.nml", "--ndim", "3", "--dtype", "float64"]) == 0
    monkeypatch.chdir(tmp_path / "p")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmain(["mergertree.nml", "--dtype", "float64"])
    assert pmain(["mergertree.nml", "--dtype", "float64",
                  "--device", "cpu"]) == 0
    out = tmp_path / "p" / "output_00001"
    assert ckpt.validate_checkpoint(str(out))[0]
    man = (out / "manifest.json").read_text()
    assert "clump_00001.txt" in man and "clump_cat_00001.npz" in man
    assert (out / "clump_00001.txt").read_bytes() == \
        (tmp_path / "j" / "output_00001" / "clump_00001.txt").read_bytes()
