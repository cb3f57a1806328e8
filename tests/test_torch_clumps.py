"""The port's clump finder (``ramses_tpu_torch/pm/clumps.py``) against the JAX
package's (``ramses_tpu/pm/clumps.py``), on the CPU.

The JAX package runs as its own tests run it (x64, so its ``jnp.asarray``
keeps the float64 deposit).  Tolerance: none.  The labels are integers
and the tables are text, so ``steepest_parent``, ``watershed`` (the plain
version, K10's oracle) and ``find_clumps`` with and without relevance
merging and the saddle-threshold halo pass give bitwise equal labels and
byte for byte equal ``write_clump_table`` files, on random, plateau and
smooth fields in 1D, 2D and 3D and on the blob fields of
``tests/test_clumps_tracers.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu.pm import clumps as jclumps  # noqa: E402

from ramses_tpu_torch.pm import clumps  # noqa: E402

from test_torch_clumps_host import field, thresholds  # noqa: E402


def _two_blobs(n=48, sep=0.45, amp2=0.6, sigma=0.05):
    """``tests/test_clumps_tracers.py``'s two Gaussian blobs."""
    x = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(x, x, indexing="ij")

    def blob(cx, cy, a):
        return a * np.exp(-((X - cx) ** 2 + (Y - cy) ** 2)
                          / (2 * sigma ** 2))
    return 0.01 + blob(0.3, 0.5, 1.0) + blob(0.3 + sep, 0.5, amp2)


def _blobs3d(n=24, seed=2):
    """Six 3D blobs of random heights and widths over a floor: clumps that
    touch, for the relevance and the saddle merges."""
    rng = np.random.default_rng(seed)
    x = (np.arange(n) + 0.5) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    rho = np.full((n,) * 3, 0.02)
    for _ in range(6):
        c = rng.uniform(0.2, 0.8, 3)
        rho += rng.uniform(0.5, 2.0) * np.exp(
            -((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2)
            / (2 * rng.uniform(0.04, 0.09) ** 2))
    return rho


@pytest.mark.parametrize("kind", ["random", "plateau", "smooth"])
@pytest.mark.parametrize("shape", [(64,), (24, 31), (12, 10, 14)])
def test_watershed_matches_jax(kind, shape):
    host = field(kind, shape, 11 + len(shape))
    nd = len(shape)
    parent = clumps.steepest_parent(torch.from_numpy(host), nd)
    assert np.array_equal(parent.numpy(),
                          np.asarray(jclumps.steepest_parent(host, nd)))
    for thr in thresholds(host):
        got = clumps.watershed(torch.from_numpy(host), thr, nd)
        want = np.asarray(jclumps.watershed(host, thr, nd))
        assert got.dtype == torch.int64 and want.dtype == np.int64
        assert np.array_equal(got.numpy(), want), (kind, shape, thr)


def _same_tables(tmp_path, got, want):
    pa, pb = tmp_path / "port.txt", tmp_path / "jax.txt"
    clumps.write_clump_table(got, str(pa))
    jclumps.write_clump_table(want, str(pb))
    assert pa.read_bytes() == pb.read_bytes()


@pytest.mark.parametrize("rho,kw", [
    (_two_blobs(), dict(threshold=0.05, relevance=1.5, dx=1.0 / 48,
                        merge=False)),
    (_two_blobs(sep=0.16, amp2=0.9), dict(threshold=0.05, relevance=1.2)),
    (_two_blobs(sep=0.16, amp2=0.9), dict(threshold=0.05, relevance=3.0)),
    (_blobs3d(), dict(threshold=0.1, relevance=1.5, dx=1.0 / 24)),
    (_blobs3d(), dict(threshold=0.1, relevance=1.2, dx=1.0 / 24,
                      saddle_threshold=0.3)),
    (np.floor(_blobs3d(seed=5) * 8.0) / 8.0,
     dict(threshold=0.1, relevance=1.1, saddle_threshold=0.25)),
], ids=["two_blobs", "merge_kept", "merge_joined", "blobs3d",
        "blobs3d_saddle", "blobs3d_plateaus_saddle"])
def test_find_clumps_matches_jax(tmp_path, rho, kw):
    labels, got = clumps.find_clumps(rho, device="cpu", **kw)
    jlabels, want = jclumps.find_clumps(rho, **kw)
    assert np.array_equal(labels, np.asarray(jlabels))
    assert [c.index for c in got] == [c.index for c in want]
    assert [c.parent for c in got] == [c.parent for c in want]
    _same_tables(tmp_path, got, want)


def test_find_clumps_labels_a_tensor_where_it_lies(tmp_path):
    rho = _blobs3d(n=16, seed=7)
    labels, got = clumps.find_clumps(torch.from_numpy(rho), 0.1)
    jlabels, want = jclumps.find_clumps(rho, 0.1)
    assert np.array_equal(labels, np.asarray(jlabels))
    _same_tables(tmp_path, got, want)


def test_entry_points_run_on_the_card_unless_asked():
    """A host grid goes to the CUDA device unless the caller asks for the
    CPU; on a CUDA tensor the wrapper launches K10 or raises (a CPU tensor
    handed to the launcher is refused, not labelled)."""
    rho = _two_blobs(n=16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            clumps.find_clumps(rho, 0.05)
    with pytest.raises(ValueError, match="CUDA tensor"):
        clumps._launch(torch.from_numpy(rho), 0.05, 2)
    n0 = clumps.launches
    clumps.find_clumps(rho, 0.05, device="cpu")
    assert clumps.launches == n0
