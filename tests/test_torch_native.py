"""The port's native key library (``ramses_tpu_torch/native``) on the CPU.

The library is built with g++ at first use into ``ramses_tpu_torch/_build``.
Its Morton encoder and its sorted lookup are held bitwise to the port's
numpy paths (``amr/keys.encode_np``, ``amr/tree.lookup_np``) and to the JAX
package's own native library on random 2D and 3D inputs of 5,000 and
262,144 keys; ``keys.encode`` and ``Octree.lookup_keys`` switch to it at
4,096 keys, as the JAX package does; a build that fails raises with the
compiler's output.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ramses_tpu import native as jnative  # noqa: E402
from ramses_tpu.amr import keys as jkeys  # noqa: E402

from ramses_tpu_torch import native  # noqa: E402
from ramses_tpu_torch.amr import keys as kmod  # noqa: E402
from ramses_tpu_torch.amr import tree as tmod  # noqa: E402
from ramses_tpu_torch.amr.tree import Octree  # noqa: E402

# coordinate bits a dim that a key holds (int64 keys)
BITS = {2: 31, 3: 21}


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return native.build()


def _coords(ndim, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << BITS[ndim], (n, ndim), dtype=np.int64)


def test_library_builds_into_the_build_dir(built):
    assert built.exists() and built.parent == native.BUILD_DIR
    assert built == native.library_path()
    assert native.lib() is native.lib()


@pytest.mark.parametrize("n", [5000, 262144])
@pytest.mark.parametrize("ndim", [2, 3])
def test_morton_encode_is_numpys_and_jaxs(built, ndim, n):
    og = _coords(ndim, n, 10 * ndim + n % 7)
    got = native.morton_encode(og, ndim)
    assert got.dtype == np.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got, kmod.encode_np(og, ndim))
    np.testing.assert_array_equal(got, jnative.morton_encode(og, ndim))
    np.testing.assert_array_equal(kmod.decode(got, ndim), og)


@pytest.mark.parametrize("n", [5000, 262144])
@pytest.mark.parametrize("ndim", [2, 3])
def test_lookup_sorted_is_numpys_and_jaxs(built, ndim, n):
    rng = np.random.default_rng(ndim + n)
    keys = np.unique(kmod.encode_np(_coords(ndim, n, ndim), ndim))
    # half present, half random (mostly absent), with both ends
    q = np.concatenate([rng.choice(keys, n // 2),
                        rng.integers(0, int(keys[-1]) + 10, n - n // 2),
                        [keys[0], keys[-1], keys[-1] + 1, -1]])
    got = native.lookup_sorted(keys, q)
    want = tmod.lookup_np(keys, q)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.lookup_sorted(keys, q))
    hit = want >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(keys[got[hit]], q[hit])


def test_encode_and_lookup_switch_at_4096(built, monkeypatch):
    calls = {"encode": [], "lookup": []}
    enc, look = native.morton_encode, native.lookup_sorted
    monkeypatch.setattr(native, "morton_encode", lambda og, nd: (
        calls["encode"].append(len(og)), enc(og, nd))[1])
    monkeypatch.setattr(native, "lookup_sorted", lambda s, q: (
        calls["lookup"].append(len(q)), look(s, q))[1])
    assert kmod.NATIVE_MIN == 4096
    for n in (4095, 4096):
        og = _coords(3, n, n)
        np.testing.assert_array_equal(kmod.encode(og, 3),
                                      jkeys.encode(og, 3))
    assert calls["encode"] == [4096]
    t = Octree.base(3, 5, 6)                   # 4,096 octs at level 5
    ks = t.levels[5].keys
    for n in (4095, 4096):
        q = np.concatenate([ks[:n - 1], [ks[-1] + 1]])
        got = t.lookup_keys(5, q)
        np.testing.assert_array_equal(got, np.r_[np.arange(n - 1), -1])
    assert calls["lookup"] == [4096]


def test_failed_build_raises_with_the_compiler_output(built, tmp_path,
                                                      monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" void morton_encode( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken.cpp"):
        native.build()
    assert not list((tmp_path / "_build").glob("*.so"))
