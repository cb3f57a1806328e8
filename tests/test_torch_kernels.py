"""The port's kernel build (``ramses_tpu_torch.kernels``) and launch count.

A failed build raises and leaves nothing behind; a build is keyed on the
source and the flags; the plain version on a CPU tensor is no launch.
"""

import os
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ramses_tpu_torch import kernels  # noqa: E402
from ramses_tpu_torch.grid import boundary as bmod  # noqa: E402
from ramses_tpu_torch.hydro import fused_muscl as fm  # noqa: E402
from ramses_tpu_torch.hydro.core import HydroStatic  # noqa: E402


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    d = tmp_path / "_build"
    monkeypatch.setattr(kernels, "BUILD_DIR", d)
    return d


def test_failed_build_raises_and_leaves_nothing(tmp_path, build_dir,
                                                monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: bad kernel" >&2; exit 3')
    monkeypatch.setattr(kernels, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match="bad kernel"):
        kernels.build(kernels.sources())
    assert list(build_dir.iterdir()) == []


def test_build_is_keyed_on_source_and_flags(tmp_path, build_dir,
                                            monkeypatch):
    # a stand-in compiler that writes its -o target, to check the
    # build's bookkeeping without nvcc
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done; '
                                'echo built > "$2"')
    monkeypatch.setattr(kernels, "nvcc_path", lambda: nvcc)
    assert kernels.sources() == ["fused_muscl", "oct_muscl"]
    kernels.build(kernels.sources())        # both compilers run together
    targets = [kernels.library_path(n) for n in kernels.sources()]
    for target in targets:
        assert target.parent == build_dir and target.read_text() == "built\n"
    assert sorted(p.name for p in build_dir.iterdir()) == \
        sorted(t.name for t in targets)
    assert kernels.build(kernels.sources()) == {}   # already built
    target = targets[0]
    # the shared header is part of every source's key
    copy = tmp_path / "csrc"
    copy.mkdir()
    for f in kernels.CSRC.iterdir():
        (copy / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", copy)
    assert kernels.library_path("fused_muscl") == target
    header = tmp_path / "csrc" / "muscl_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert kernels.library_path("fused_muscl") != target
    monkeypatch.setattr(kernels, "NVCC_FLAGS",
                        kernels.NVCC_FLAGS + ("-lineinfo",))
    assert kernels.library_path("oct_muscl") != targets[1]


def test_no_nvcc_raises(monkeypatch):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(os.sep, "nonexistent"))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc installed under /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.nvcc_path()


def test_plain_version_on_cpu_is_no_launch():
    cfg = HydroStatic(ndim=3)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(np.stack([1.0 + rng.random((4, 4, 4))] +
                                  [0.1 * rng.standard_normal((4, 4, 4))] * 3
                                  + [2.0 + rng.random((4, 4, 4))]))
    u = u.to(torch.float32)
    before = fm.launches
    un = fm.fused_step(u, torch.tensor(1e-3), cfg, 0.25,
                       bmod.BoundarySpec.periodic(3))
    assert fm.launches == before
    assert un.shape == u.shape and torch.isfinite(un).all()
