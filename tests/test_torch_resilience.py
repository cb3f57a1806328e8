"""The port's fault-tolerant execution layer (``ramses_tpu_torch.
resilience``, ``utils/ops.OpsGuard``, ``io/async_writer``) on the CPU: the
checks of ``tests/test_resilience.py`` that need no unported layer, with a
file corrupted by hand where the JAX package injects the fault.

* atomic checkpoints: a kill before the rename leaves nothing that scans
  as a checkpoint, a stale directory is replaced (not merged), the scan
  skips a corrupt one for the next-oldest, rotation keeps the newest N,
  ``resolve_restart_dir``'s modes;
* the supervisor: bounded attempts with exponential backoff,
  ``run_complete``; a SIGTERM mid-run (sent from a hook) resumes from the
  stop checkpoint and matches the uninterrupted run within rtol 1e-9 /
  atol 1e-12 (f64), by ``supervise`` directly and through the CLI for
  every driver; ``nrestart=-1`` and ``--auto-resume`` resume the newest
  checkpoint;
* ``OpsGuard``: the NaN/dt trap, the stop file, the stop path draining an
  ``AsyncDumper`` and reporting its failures, no device→host fetch added
  when armed; every test restores the signal handlers it found.
"""

import os
import signal
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_io import MHD_BLOB, NMLS, sod_text  # noqa: E402

from ramses_tpu_torch.__main__ import run_cli  # noqa: E402
from ramses_tpu_torch.amr.hierarchy import AmrSim  # noqa: E402
from ramses_tpu_torch.config import params_from_string as pparams  # noqa: E402,E501
from ramses_tpu_torch.driver import Simulation, run_namelist  # noqa: E402
from ramses_tpu_torch.io import snapshot as snapmod  # noqa: E402
from ramses_tpu_torch.io.async_writer import AsyncDumper  # noqa: E402
from ramses_tpu_torch.resilience import checkpoint as ckpt  # noqa: E402
from ramses_tpu_torch.resilience import supervisor as rsup  # noqa: E402
from ramses_tpu_torch.resilience.stepguard import StepRetryExhausted  # noqa: E402,E501
from ramses_tpu_torch.resilience.watchdog import HangDetected  # noqa: E402
from ramses_tpu_torch.utils import ops  # noqa: E402
from ramses_tpu_torch.utils.ops import OpsGuard  # noqa: E402

RUN_TOL = dict(rtol=1e-9, atol=1e-12)
UNI_OUT = "noutput=2\ntout=0.02,0.04\ntend=0.04"
QUIET = dict(log=lambda *_: None)


@pytest.fixture(autouse=True)
def _restore_signal_handlers():
    """OpsGuard installs SIGTERM/SIGINT/SIGUSR1 handlers: put back the
    ones each test found."""
    sigs = (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1)
    prev = {s: signal.getsignal(s) for s in sigs}
    yield
    for s, h in prev.items():
        signal.signal(s, h)


def _uni_params(nstep=6, out=UNI_OUT, run=""):
    text = sod_text(lmin=4, lmax=4, run=f"nstepmax={nstep}\n{run}")
    return pparams(text.replace("noutput=1\ntout=0.1\ntend=0.1", out),
                   ndim=2)


def _uni_sim(nstep=6, out=UNI_OUT):
    return Simulation(_uni_params(nstep, out), dtype=torch.float64,
                      device="cpu")


# ---------------------------------------------------------------------------
# atomic checkpoints
# ---------------------------------------------------------------------------

def test_kill_mid_dump_never_leaves_valid_checkpoint(tmp_path, monkeypatch):
    sim = _uni_sim(nstep=2)
    base = str(tmp_path)

    def killed(src, dst):
        raise RuntimeError("simulated kill -9 before the atomic rename")

    with monkeypatch.context() as m:
        m.setattr(os, "replace", killed)
        with pytest.raises(RuntimeError, match="kill -9"):
            sim.dump(1, base)
    assert not os.path.exists(os.path.join(base, "output_00001"))
    assert os.path.isdir(os.path.join(base, "output_00001.tmp"))
    assert ckpt.latest_valid_checkpoint(base, **QUIET) is None
    # the retry cleans the stale stage and finalizes atomically
    out = sim.dump(1, base)
    ok, reason = ckpt.validate_checkpoint(out)
    assert ok, reason
    assert not os.path.exists(os.path.join(base, "output_00001.tmp"))
    assert ckpt.latest_valid_checkpoint(base, **QUIET) == out


def test_stale_output_dir_replaced_not_merged(tmp_path):
    sim = _uni_sim(nstep=2)
    stale = os.path.join(str(tmp_path), "output_00001")
    os.makedirs(stale)
    with open(os.path.join(stale, "junk_from_older_run.out"), "w") as f:
        f.write("stale")
    out = sim.dump(1, str(tmp_path))
    assert out == stale
    assert not os.path.exists(os.path.join(stale, "junk_from_older_run.out"))
    ok, reason = ckpt.validate_checkpoint(out)
    assert ok, reason


def test_scan_skips_corrupt_and_picks_next_oldest(tmp_path):
    sim = _uni_sim(nstep=2)
    base = str(tmp_path)
    d1 = sim.dump(1, base)
    sim.state.nstep, sim.state.t = 3, 0.25
    d2 = sim.dump(2, base)
    assert ckpt.latest_valid_checkpoint(base, **QUIET) == d2
    # truncate the newest's hydro file by hand: a size mismatch
    victim = os.path.join(d2, "hydro_00002.out00001")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    ok, reason = ckpt.validate_checkpoint(d2)
    assert not ok and "hydro_00002.out00001" in reason
    skips = []
    assert ckpt.latest_valid_checkpoint(
        base, log=lambda m: skips.append(str(m))) == d1
    assert any("output_00002" in s for s in skips)
    # flip one byte of the survivor's amr file: a checksum mismatch
    amr = os.path.join(d1, "amr_00001.out00001")
    with open(amr, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    ok, reason = ckpt.validate_checkpoint(d1)
    assert not ok and "checksum" in reason
    assert ckpt.validate_checkpoint(d1, verify_hash=False)[0]
    assert ckpt.latest_valid_checkpoint(base, **QUIET) is None
    # scrub renames the invalid ones aside
    moved = ckpt.scrub_checkpoints(base, **QUIET)
    assert sorted(os.path.basename(p) for p, _ in moved) == [
        "output_00001.corrupt", "output_00002.corrupt"]


def test_rotation_keeps_last_n_manifest_dirs_only(tmp_path):
    sim = Simulation(_uni_params(2, out="checkpoint_keep=2"),
                     dtype=torch.float64, device="cpu")
    base = str(tmp_path)
    legacy = os.path.join(base, "output_00077")     # no manifest: kept
    os.makedirs(legacy)
    for i in (1, 2, 3):
        sim.state.nstep = i
        sim.dump(i, base)
    assert not os.path.exists(os.path.join(base, "output_00001"))
    assert os.path.exists(os.path.join(base, "output_00002"))
    assert os.path.exists(os.path.join(base, "output_00003"))
    assert os.path.exists(legacy)


def test_resolve_restart_dir_modes(tmp_path):
    base = str(tmp_path)
    p = _uni_params()
    assert ckpt.resolve_restart_dir(p, base_dir=base, **QUIET) is None
    p.run.nrestart = 2
    with pytest.raises(FileNotFoundError):
        ckpt.resolve_restart_dir(p, base_dir=base, **QUIET)
    sim = _uni_sim(nstep=2)
    d2 = sim.dump(2, base)
    assert ckpt.resolve_restart_dir(p, base_dir=base, **QUIET) == d2
    # an explicit restart from a checkpoint that fails validation is loud
    with open(os.path.join(d2, ckpt.MANIFEST_NAME), "a") as f:
        f.write("garbage")
    with pytest.raises(RuntimeError, match="nrestart=-1"):
        ckpt.resolve_restart_dir(p, base_dir=base, **QUIET)
    # auto mode skips it and finds the next valid one
    d1 = sim.dump(1, base)
    p.run.nrestart = -1
    assert ckpt.resolve_restart_dir(p, base_dir=base, **QUIET) == d1
    p.run.nrestart, p.run.auto_resume = 0, True
    assert ckpt.resolve_restart_dir(p, base_dir=base, **QUIET) == d1


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def test_supervisor_bounded_attempts_with_backoff(tmp_path, monkeypatch):
    sleeps = []
    monkeypatch.setattr(rsup.time, "sleep", lambda s: sleeps.append(s))
    p = _uni_params(nstep=5)
    calls = {"n": 0}

    def build(restart):
        assert restart is None             # no checkpoints on disk
        return types.SimpleNamespace(nstep=0, t=0.0, telemetry=None)

    def drive(sim):
        calls["n"] += 1
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        rsup.supervise(build, drive, p, base_dir=str(tmp_path),
                       max_attempts=3, **QUIET)
    assert calls["n"] == 3
    assert sleeps == [1.0, 2.0]            # exponential, from base 1 s
    assert rsup.backoff_delay(10) == 30.0  # capped


def test_classify_and_hang_policy(tmp_path, monkeypatch):
    monkeypatch.setattr(rsup.time, "sleep", lambda s: None)
    assert rsup.classify(None) == "none"
    assert rsup.classify(HangDetected("step", 5.0)) == "hang"
    assert rsup.classify(StepRetryExhausted("x")) == "nan"
    assert rsup.classify(ValueError("x")) == "crash"
    p = _uni_params(nstep=5)
    n = {"drive": 0}

    def drive(sim):
        n["drive"] += 1
        raise HangDetected("step", 1.0, nstep=0)

    # hangs resume without using attempts, then re-raise
    with pytest.raises(HangDetected):
        rsup.supervise(lambda r: types.SimpleNamespace(nstep=0, t=0.0),
                       drive, p, base_dir=str(tmp_path), max_attempts=1,
                       hang_retries=2, **QUIET)
    assert n["drive"] == 3


def test_run_complete_semantics():
    p = _uni_params(nstep=5)
    assert rsup.run_complete(types.SimpleNamespace(nstep=5, t=0.0), p)
    assert rsup.run_complete(types.SimpleNamespace(nstep=1, t=0.04), p)
    assert not rsup.run_complete(types.SimpleNamespace(nstep=1, t=0.01), p)
    assert not rsup.run_complete(types.SimpleNamespace(nstep=1, t=0.01), p,
                                 tend=0.02)


def test_sigterm_supervised_resume_matches_uninterrupted_run(tmp_path,
                                                             monkeypatch):
    """The JAX package's test with the signal sent from the first output's
    hook: the stop dumps ``output_00900``, attempt 2 resumes from it."""
    monkeypatch.setattr(rsup.time, "sleep", lambda s: None)
    ref = _uni_sim(nstep=10 ** 6)
    ref.evolve(chunk=2)
    outdir = str(tmp_path / "run")
    os.makedirs(outdir)
    p = _uni_params(nstep=10 ** 6)

    def on_output(sim, iout):
        sim.dump(iout, outdir)
        if iout == 1 and not os.path.exists(os.path.join(outdir, "sent")):
            open(os.path.join(outdir, "sent"), "w").close()
            os.kill(os.getpid(), signal.SIGTERM)

    def build(restart):
        sim = (Simulation.from_snapshot(p, restart, dtype=torch.float64,
                                        device="cpu")
               if restart else Simulation(p, dtype=torch.float64,
                                          device="cpu"))
        sim.on_output = on_output
        return sim

    def drive(sim):
        guard = OpsGuard(sim, outdir)
        guard.run_guarded(lambda: sim.evolve(chunk=2, guard=guard))

    logs = []
    sim = rsup.supervise(build, drive, p, base_dir=outdir, max_attempts=3,
                         log=lambda m: logs.append(str(m)))
    assert any("resuming from" in m and "output_00900" in m for m in logs)
    assert sorted(n for n in os.listdir(outdir) if n.startswith("output_")) \
        == ["output_00001", "output_00002", "output_00900"]
    assert sim.nstep == ref.nstep
    np.testing.assert_allclose(sim.state.u.numpy(), ref.state.u.numpy(),
                               **RUN_TOL)
    assert abs(sim.t - ref.t) <= 1e-12 * max(abs(ref.t), 1.0)


def _driver_namelist(tmp_path, driver, run=""):
    if driver == "uniform":
        text = sod_text(lmin=4, lmax=4, run=run).replace(
            "noutput=1\ntout=0.1\ntend=0.1", UNI_OUT)
    elif driver == "amr":
        text = sod_text(run=run)
    elif driver == "mhd":
        text = open(os.path.join(NMLS, "orszag2d.nml")).read() \
            .replace("levelmin=5", "levelmin=4") \
            .replace("levelmax=7", "levelmax=4") \
            .replace("tout=0.2\ntend=0.2", "tout=2.0\ntend=2.0") \
            .replace("&RUN_PARAMS\n", f"&RUN_PARAMS\n{run}\n")
    else:
        text = MHD_BLOB.replace("&RUN_PARAMS\n", f"&RUN_PARAMS\n{run}\n") \
            + "&OUTPUT_PARAMS\ntend=1.0\n/\n"
    path = tmp_path / f"{driver}.nml"
    path.write_text(text)
    return str(path)


# steps each driver runs (the MHD uniform driver's first chunk is 16)
NSTEP = {"uniform": 10 ** 6, "amr": 4, "mhd": 40, "mhd_amr": 4}


def _rows(sim):
    if hasattr(sim, "levels"):
        ttd = 2 ** sim.tree.ndim
        return np.concatenate([sim.u[lvl][:sim.tree.noct(lvl) * ttd]
                               .numpy().ravel() for lvl in sim.levels()])
    return (sim.u if hasattr(sim, "bf") else sim.state.u).numpy().ravel()


def _cli(nml, *flags):
    """The CLI in process on the CPU in f64 (``run_cli``: the final sim)."""
    return run_cli([nml, "--ndim", "2", "--device", "cpu", "--dtype",
                    "float64", *flags])


@pytest.mark.parametrize("driver", ["uniform", "amr", "mhd", "mhd_amr"])
def test_sigterm_resume_through_the_cli(driver, tmp_path, monkeypatch,
                                        capsys):
    """The CLI with ``--max-attempts 3``: a SIGTERM sent from the guard's
    check once the run passed step 2 stops it with an emergency
    checkpoint, the supervisor resumes from it, and the run ends equal to
    the uninterrupted ``run_namelist``."""
    monkeypatch.setattr(rsup.time, "sleep", lambda s: None)
    monkeypatch.chdir(tmp_path)
    nml = _driver_namelist(tmp_path, driver, f"nstepmax={NSTEP[driver]}")
    ref = run_namelist(nml, ndim=2, dtype=torch.float64, device="cpu")
    real = OpsGuard.check
    sent = []

    def check(self):
        if self.sim.nstep >= 2 and not sent:
            sent.append(self.sim.nstep)
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self)

    monkeypatch.setattr(OpsGuard, "check", check)
    sim = _cli(nml, "--max-attempts", "3")
    out = capsys.readouterr().out
    assert sent and "ops: stop signal: snapshot -> ./output_00900" in out
    assert "resuming from ./output_00900" in out
    assert sim.nstep == ref.nstep and sim.t == pytest.approx(ref.t,
                                                             rel=1e-12)
    np.testing.assert_allclose(_rows(sim), _rows(ref), **RUN_TOL)
    ok, reason = ckpt.validate_checkpoint("output_00001")
    assert ok, reason


def test_auto_resume_picks_the_newest_checkpoint(tmp_path, monkeypatch,
                                                 capsys):
    """``nrestart=-1`` (and ``--auto-resume``): the first launch starts
    fresh (nothing on disk), the next resumes the newest valid
    checkpoint."""
    monkeypatch.setattr(rsup.time, "sleep", lambda s: None)
    monkeypatch.chdir(tmp_path)
    ref = run_namelist(_driver_namelist(tmp_path, "amr", "nstepmax=4"),
                       ndim=2, dtype=torch.float64, device="cpu")
    first = _cli(_driver_namelist(tmp_path, "amr",
                                  "nstepmax=2\nnrestart=-1"))
    assert first.nstep == 2
    assert "auto-resume" not in capsys.readouterr().out
    sim = _cli(_driver_namelist(tmp_path, "amr", "nstepmax=4"),
               "--auto-resume")
    assert "auto-resume from ./output_00001" in capsys.readouterr().out
    assert sim.nstep == 4
    np.testing.assert_allclose(_rows(sim), _rows(ref), **RUN_TOL)


# ---------------------------------------------------------------------------
# OpsGuard and the async writer
# ---------------------------------------------------------------------------

def _fake_sim(tmp_path, **kw):
    events = []
    tel = types.SimpleNamespace(
        record_event=lambda k, **f: events.append((k, f)))
    sim = types.SimpleNamespace(
        dt_old=1e-3, nstep=3, t=0.1, telemetry=tel,
        dump=lambda iout, base: str(tmp_path), **kw)
    return sim, events


def test_opsguard_traps_nonfinite_and_nonpositive_dt(tmp_path):
    sim, events = _fake_sim(tmp_path)
    sim.dt_old = float("nan")
    g = OpsGuard(sim, str(tmp_path), install_signals=False, nan_check=True)
    assert g.check() is False
    assert events[0][0] == "fault"
    assert events[0][1]["reason"] == "nonfinite_dt"

    # a restored sim (nstep 3) knows no dt until its first chunk: no fault
    # before it steps, a fault once it has stepped with dt 0
    sim2, events2 = _fake_sim(tmp_path)
    sim2.dt_old = 0.0
    g2 = OpsGuard(sim2, str(tmp_path), install_signals=False, nan_check=True)
    assert g2.check() is True and not events2
    sim2.nstep += 1
    assert g2.check() is False
    assert events2[0][1]["reason"] == "nonpositive_dt"

    # dt == 0 before the first step is normal startup, not a fault
    sim3, events3 = _fake_sim(tmp_path)
    sim3.dt_old, sim3.nstep = 0.0, 0
    g3 = OpsGuard(sim3, str(tmp_path), install_signals=False, nan_check=True)
    assert g3.check() is True
    assert not events3


def test_opsguard_totals_audit_on_a_real_sim(tmp_path):
    """The amortised audit reads the driver's dict of totals; a NaN in the
    state trips it at the audit cadence and dumps a crash snapshot."""
    sim = _uni_sim(nstep=2)
    sim.evolve()
    g = OpsGuard(sim, str(tmp_path), install_signals=False, nan_check=True)
    g.cons_every = 2
    assert g.check() is True and g.check() is True
    sim.state.u[0, 3, 3] = float("nan")
    assert g.check() is True
    assert g.check() is False
    assert os.path.isdir(tmp_path / "output_00900")
    assert np.isfinite(ops._totals_vector({"mass": 1.0, "momentum": [2.0],
                                           "energy": 3.0})).all()


def test_opsguard_stop_file_and_run_guarded(tmp_path):
    sim = _uni_sim(nstep=10 ** 6)
    g = OpsGuard(sim, str(tmp_path), install_signals=False)
    open(tmp_path / "stop_run", "w").close()
    sim.evolve(guard=g)
    assert sim.nstep == 0 and os.path.isdir(tmp_path / "output_00900")

    def nan_step():
        raise FloatingPointError("nan in the step")

    with pytest.raises(FloatingPointError):
        g.run_guarded(nan_step)
    assert os.path.isdir(tmp_path / "output_00901")
    assert ops.rss_mb() > 0.0 and ops.device_mb() >= 0.0


def test_async_dumper_drain_and_stop_path_reporting(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("disk full")

    monkeypatch.setattr(snapmod, "dump_all", boom)
    d = AsyncDumper()
    d.submit(None, 1, str(tmp_path))
    errs = d.drain()
    assert len(errs) == 1 and "disk full" in str(errs[0])
    assert d.drain() == []                 # drained errors are cleared
    # the stop path reports writer failures as io_error events instead of
    # raising past the clean shutdown
    d.submit(None, 2, str(tmp_path))
    sim, events = _fake_sim(tmp_path, dumper=d)
    g = OpsGuard(sim, str(tmp_path), install_signals=False, nan_check=False)
    g._stop_requested = True
    assert g.check() is False
    assert any(k == "io_error" and "disk full" in f["error"]
               for k, f in events)
    d.close()


def test_async_dump_writes_the_sync_bytes(tmp_path):
    """An AmrSim dump through the AsyncDumper's thread is the synchronous
    dump, file for file; the sim keeps stepping meanwhile."""
    sim = AmrSim(pparams(sod_text(), ndim=2), dtype=torch.float64,
                 device="cpu")
    sim.evolve(1.0, nstepmax=2)
    a = sim.dump(1, str(tmp_path / "sync"))
    d = AsyncDumper()
    b = sim.dump(1, str(tmp_path / "async"), dumper=d)
    sim.evolve(1.0, nstepmax=3)
    d.wait()
    assert d.pending == 0
    from test_torch_io import assert_same_files
    assert_same_files(a, b)
    d.close()


FETCHES = ("cpu", "item", "tolist", "numpy", "__float__", "__int__")


def test_zero_overhead_when_guard_armed(tmp_path, monkeypatch):
    """An armed OpsGuard (no debug_nan) adds no device→host fetch to the
    step loop: the same count of fetches with and without it."""
    counts = {"n": 0}

    def count(name):
        real = getattr(torch.Tensor, name)

        def wrapped(self, *a, **k):
            counts["n"] += 1
            return real(self, *a, **k)
        return wrapped

    def fetches(guarded):
        sim = AmrSim(pparams(sod_text(), ndim=2), device="cpu")
        sim.evolve(1.0, nstepmax=2)
        g = (OpsGuard(sim, str(tmp_path), install_signals=False)
             if guarded else None)
        counts["n"] = 0
        with monkeypatch.context() as m:
            for name in FETCHES:
                m.setattr(torch.Tensor, name, count(name))
            sim.evolve(1.0, nstepmax=6, guard=g)
        assert sim.nstep == 6
        return counts["n"]

    plain = fetches(False)
    assert plain > 0
    assert fetches(True) == plain
