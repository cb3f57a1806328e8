"""K10, the clump finder's watershed (``ramses_tpu_torch/csrc/watershed.cu``),
built for the host CPU against its plain version.

The source is compiled with ``g++`` through the stand-in CUDA runtime of
``tests/test_torch_muscl_host.py`` (each ``<<<grid, block, smem, s>>>``
launch runs a block's threads as real threads, the blocks in order), and
called through the wrapper's own ``call``.  The labels are integers, so the
tolerance is none: bitwise equal to ``watershed_ref`` (which
``tests/test_torch_clumps.py`` holds bitwise to the JAX package's
``watershed``) on random, plateau and smooth float64 fields in 1D, 2D and
3D, at thresholds that cut off none, half and nearly all of the cells, and
on axes of one and two cells.  Skips without ``g++``.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu_torch import kernels  # noqa: E402
from ramses_tpu_torch.pm import clumps  # noqa: E402

# a launch of a kernel that is not a template (the shared harness's LAUNCH
# takes templated ones)
PLAIN_LAUNCH = re.compile(r"\b(\w+)<<<grid, block, (\w+), s>>>\(([^;]*)\);")


@pytest.fixture(scope="module")
def host_k10(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    from test_torch_muscl_host import LAUNCH, RUNTIME, _as_launch
    out = tmp_path_factory.mktemp("watershed_host")
    (out / "cuda_host.h").write_text(RUNTIME)
    src = (kernels.CSRC / "watershed.cu").read_text().replace(
        "#include <cuda_runtime.h>", '#include "cuda_host.h"')
    src, n = LAUNCH.subn(_as_launch, src)
    src, m = PLAIN_LAUNCH.subn(_as_launch, src)
    assert n == m == 1 and "<<<" not in src
    (out / "watershed.cpp").write_text(src)
    lib = out / "libwatershed_host.so"
    subprocess.run([shutil.which("g++"), "-std=c++20", "-O1", "-pthread",
                    "-shared", "-fPIC", "-w", "-o", str(lib),
                    str(out / "watershed.cpp")], check=True,
                   capture_output=True)
    return clumps.bind(ctypes.CDLL(str(lib)))


def field(kind: str, shape, seed: int) -> np.ndarray:
    """A test density: ``random`` uniform noise, ``plateau`` the noise
    quantised to four levels (equal-density plateaus exercise the index
    tie-break), ``smooth`` a few periodic Gaussian peaks (long uphill
    chains)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random(shape)
    if kind == "plateau":
        return np.floor(rng.random(shape) * 4.0) / 4.0
    grids = np.meshgrid(*[(np.arange(n) + 0.5) / n for n in shape],
                        indexing="ij")
    rho = np.full(shape, 0.01)
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
