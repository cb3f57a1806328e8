"""K10, the clump finder's watershed (``ramses_tpu_torch/csrc/watershed.cu``),
built for the host CPU against its plain version.

The source is compiled with ``g++`` through the stand-in CUDA runtime of
``tests/test_torch_muscl_host.py`` (each ``<<<grid, block, smem, s>>>``
launch runs a block's threads as real threads, the blocks in order), and
called through the wrapper's own ``call``.  The labels are integers, so the
tolerance is none: bitwise equal to ``watershed_ref`` (which
``tests/test_torch_clumps.py`` holds bitwise to the JAX package's
``watershed``) on random, plateau and smooth float64 fields in 1D, 2D and
3D, at thresholds that cut off none, half and nearly all of the cells; on
grids the tiles (32 x 8 x 4, 32 x 32, 1,024 cells) do not divide, cut by
the grid's edge on every axis; on one smooth peak spanning the box and on
flat and stepped plateaus, whose chains cross many tiles; on axes of one and
two cells; and through the 64-bit instantiation (``wide``).  Skips without
``g++``.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu_torch.pm import clumps  # noqa: E402


@pytest.fixture(scope="module")
def host_k10(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    from test_torch_muscl_host import host_library
    # the parents and labels kernels' launches, and the empty kernel's
    return clumps.bind(host_library(tmp_path_factory.mktemp("watershed_host"),
                                    "watershed", 2, 1))


def field(kind: str, shape, seed: int) -> np.ndarray:
    """A test density: ``random`` uniform noise, ``plateau`` the noise
    quantised to four levels (equal-density plateaus exercise the index
    tie-break), ``smooth`` a few periodic Gaussian peaks (long uphill
    chains), ``peak`` one periodic Gaussian as wide as the box (chains
    across the whole grid), ``flat`` one density everywhere (every chain
    runs up the flat index), ``steps`` a flat floor with a raised slab
    over a third of the box."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random(shape)
    if kind == "plateau":
        return np.floor(rng.random(shape) * 4.0) / 4.0
    if kind == "flat":
        return np.full(shape, 0.5)
    if kind == "steps":
        rho = np.full(shape, 0.5)
        rho[..., : max(shape[-1] // 3, 1)] = 0.75
        return rho
    grids = np.meshgrid(*[(np.arange(n) + 0.5) / n for n in shape],
                        indexing="ij")
    rho = np.full(shape, 0.01)
    if kind == "peak":
        c = rng.random(len(shape))
        r2 = sum((np.abs(g - ci) - (np.abs(g - ci) > 0.5)) ** 2
                 for g, ci in zip(grids, c))
        return rho + np.exp(-r2 / (2 * 0.3 ** 2))
    for _ in range(4):
        c = rng.random(len(shape))
        r2 = sum((np.abs(g - ci) - (np.abs(g - ci) > 0.5)) ** 2
                 for g, ci in zip(grids, c))
        rho += rng.uniform(1.0, 5.0) * np.exp(-r2 / (2 * 0.08 ** 2))
    return rho


def thresholds(rho: np.ndarray):
    """None, half and nearly all of the cells cut off."""
    return (float(rho.min()) - 1.0, float(np.median(rho)),
            float(np.quantile(rho, 0.99)))


CASES = [(kind, shape) for kind in ("random", "plateau", "smooth")
         for shape in ((300,), (40, 27), (20, 17, 24))]


@pytest.mark.parametrize("kind,shape", CASES)
def test_k10_host_build_is_bitwise_its_plain_version(host_k10, kind, shape):
    rho = torch.from_numpy(field(kind, shape, len(shape) * 7 + len(kind)))
    for thr in thresholds(rho.numpy()):
        got = clumps.call(host_k10, rho, thr, len(shape))
        want = clumps.watershed_ref(rho, thr, len(shape))
        assert got.dtype == want.dtype == torch.int64
        assert torch.equal(got, want), (kind, shape, thr)


@pytest.mark.parametrize("shape", [(1, 5, 2), (2, 2, 2), (1,), (2, 9)])
def test_k10_host_build_on_axes_of_one_and_two_cells(host_k10, shape):
    for kind in ("random", "plateau"):
        rho = torch.from_numpy(field(kind, shape, 3))
        for thr in thresholds(rho.numpy()):
            got = clumps.call(host_k10, rho, thr, len(shape))
            assert torch.equal(got, clumps.watershed_ref(rho, thr,
                                                         len(shape)))


def _held(lib, rho: np.ndarray, wide=None):
    """K10's labels bitwise the plain version's at the three thresholds."""
    rho = torch.from_numpy(rho)
    nd = rho.dim()
    for thr in thresholds(rho.numpy()):
        got = clumps.call(lib, rho, thr, nd, wide=wide)
        want = clumps.watershed_ref(rho, thr, nd)
        assert got.dtype == torch.int64 and torch.equal(got, want), thr


# grids the tiles do not divide, cut by the grid's edge on every axis
RAGGED = [(5, 11, 37), (9, 17, 70), (4, 8, 32), (33, 65), (31, 33),
          (1025,), (3000,)]


@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("kind", ["random", "plateau", "smooth"])
def test_k10_host_build_on_ragged_tiles(host_k10, kind, shape):
    _held(host_k10, field(kind, shape, sum(shape)))


@pytest.mark.parametrize("kind", ["peak", "flat", "steps"])
@pytest.mark.parametrize("shape", [(12, 20, 70), (70, 90), (5000,)])
def test_k10_host_build_on_chains_across_tiles(host_k10, kind, shape):
    """One peak as wide as the box, a flat field and a stepped plateau:
    chains that cross many tiles before their root."""
    _held(host_k10, field(kind, shape, len(shape)))


@pytest.mark.parametrize("shape", [(1, 1, 40), (2, 33, 1), (1, 2, 70),
                                   (40, 1), (1, 70), (37, 2), (2,)])
def test_k10_host_build_on_more_thin_axes(host_k10, shape):
    """Axes of one and two cells, whose periodic neighbours wrap onto the
    cell itself or onto the tile."""
    for kind in ("random", "plateau", "peak"):
        _held(host_k10, field(kind, shape, 5))


@pytest.mark.parametrize("kind,shape", [
    ("random", (9, 17, 40)), ("plateau", (20, 17, 24)),
    ("smooth", (33, 40)), ("peak", (12, 20, 70)), ("flat", (2, 33, 1)),
    ("random", (1500,))])
def test_k10_host_build_wide_instantiation(host_k10, kind, shape):
    """The 64-bit instantiation (int64 scratch and indices, the entry the
    call takes from 2^31 cells on) at small sizes: the 32-bit one's labels
    and the plain version's."""
    rho = field(kind, shape, 11)
    _held(host_k10, rho, wide=True)
    t = torch.from_numpy(rho)
    thr = float(np.median(rho))
    assert torch.equal(clumps.call(host_k10, t, thr, len(shape), wide=True),
                       clumps.call(host_k10, t, thr, len(shape), wide=False))


@pytest.mark.parametrize("shape", [(9, 17, 40), (33, 40), (1500,)])
def test_k10_host_build_on_nan_inf_and_signed_zeros(host_k10, shape):
    """Values the plain version's comparisons treat apart: NaN (never
    taken), +-inf, and -0.0 beside 0.0 (equal, so the flat index decides),
    on a plateau field: the labels bitwise at thresholds below, at and
    above zero."""
    rng = np.random.default_rng(len(shape))
    rho = field("plateau", shape, 9) - 0.25
    pick = rng.random(shape)
    rho[pick < 0.05] = np.nan
    rho[(pick >= 0.05) & (pick < 0.08)] = np.inf
    rho[(pick >= 0.08) & (pick < 0.11)] = -np.inf
    rho[(pick >= 0.11) & (pick < 0.3)] = -0.0
    t = torch.from_numpy(rho)
    for thr in (-np.inf, -1.0, -0.0, 0.2, np.inf):
        for wide in (False, True):
            got = clumps.call(host_k10, t, thr, len(shape), wide=wide)
            assert torch.equal(got, clumps.watershed_ref(t, thr,
                                                         len(shape))), thr


def test_k10_host_build_edge_cases(host_k10):
    # thresholds on and just off a plateau's level
    rho = torch.from_numpy(field("plateau", (16, 12, 10), 5))
    for thr in (0.25, 0.5 - 1e-9, 0.3):
        assert torch.equal(clumps.call(host_k10, rho, thr, 3),
                           clumps.watershed_ref(rho, thr, 3))
    # no cells: nothing is called (a None library would raise otherwise)
    empty = torch.zeros((0, 4), dtype=torch.float64)
    assert clumps.call(None, empty, 0.0, 2).shape == (0, 4)
    with pytest.raises(ValueError, match="ndim"):
        clumps.call(host_k10, torch.zeros((2, 2), dtype=torch.float64),
                    0.0, 3)
