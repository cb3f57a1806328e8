"""Operational hygiene: signal-triggered dumps, walltime watchdog,
clean-stop file and memory accounting.

The port's own copy of ``ramses_tpu/utils/ops.py``.  The per-``ncontrol``
screen block waits for the telemetry screen (ROADMAP A7), and the JAX
package's jit-level NaN trap (``jax_debug_nans``) has no counterpart:
``&RUN_PARAMS debug_nan`` arms the per-check dt probe and totals audit.

Reference behaviours reproduced:
  * ``amr/ramses.f90:17-48`` — trap signals, dump a valid snapshot,
    exit cleanly.
  * ``amr/adaptive_loop.f90:216-226`` — walltime watchdog: when the
    remaining allocation can't fit another coarse step, dump + stop.
  * ``amr/memory.f90`` — the memory high-water marks.
  * clean_stop: the reference stops when ``stop_run`` appears in the
    run directory (the operator's brake).
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional

import numpy as np


def rss_mb() -> float:
    """Resident set size [MiB] (the reference's getmem RSS probe)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def device_mb() -> float:
    """Peak bytes the CUDA caching allocator has handed out [MiB]; 0 on a
    host without CUDA."""
    import torch
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 2 ** 20


def _totals_vector(tot) -> np.ndarray:
    """The drivers' ``totals()`` (a dict of mass, momentum components and
    energy, or an array) as one f64 vector."""
    if isinstance(tot, dict):
        return np.asarray([float(tot["mass"])]
                          + [float(m) for m in tot["momentum"]]
                          + [float(tot["energy"])])
    return np.asarray(tot, dtype=np.float64)


class OpsGuard:
    """Attachable run guard: call :meth:`check` once per coarse step (or
    per chunk of steps on the uniform drivers).

    Returns False when the run must stop (walltime exhausted or the
    clean-stop file appeared); fires a snapshot dump first.  SIGUSR1
    requests an immediate snapshot without stopping; SIGTERM/SIGINT
    request dump-and-stop.
    """

    def __init__(self, sim, base_dir: str = ".",
                 walltime_s: Optional[float] = None,
                 stop_file: str = "stop_run",
                 install_signals: bool = True,
                 nan_check: Optional[bool] = None,
                 dumper=None):
        self.sim = sim
        self.base_dir = base_dir
        self.walltime_s = walltime_s
        self.stop_file = stop_file
        # queued async snapshots must hit disk (manifests finalized)
        # before a SIGTERM/walltime stop returns the allocation
        self.dumper = dumper if dumper is not None \
            else getattr(sim, "dumper", None)
        # NaN trap (&RUN_PARAMS debug_nan; SURVEY.md §5.2): cheap dt
        # check every step, full-state audit at the conservation cadence
        if nan_check is None:
            nan_check = bool(getattr(
                getattr(getattr(sim, "params", None), "run", None),
                "debug_nan", False))
        self.nan_check = nan_check
        self.t0 = time.perf_counter()
        self._dump_requested = False
        self._stop_requested = False
        self._iout = 900               # emergency outputs: high numbers
        self._max_rss = 0.0
        self._step_wall = self.t0
        self._ncheck = 0
        # the step count when armed: a restored sim has taken steps but
        # knows no dt_old until its first chunk after the restore
        self._nstep0 = int(getattr(sim, "nstep", 0))
        # conservation audit cadence: totals() downloads the whole
        # device state, so amortize it over screen blocks
        self.cons_every = 10
        if install_signals:
            signal.signal(signal.SIGUSR1, self._on_dump)
            signal.signal(signal.SIGTERM, self._on_stop)
            signal.signal(signal.SIGINT, self._on_stop)

    # -- signal handlers ------------------------------------------------
    def _on_dump(self, _sig, _frm):
        self._dump_requested = True

    def _on_stop(self, sig, _frm):
        if self._stop_requested and sig == signal.SIGINT:
            # second Ctrl-C: the run is stuck inside a step (compile or
            # hung device call) and will never reach the next check();
            # escalate to the default KeyboardInterrupt
            signal.signal(signal.SIGINT, signal.default_int_handler)
            raise KeyboardInterrupt
        self._stop_requested = True

    def _dump(self) -> Optional[str]:
        try:
            out = self.sim.dump(self._iout, self.base_dir)
            self._iout += 1
            return out
        except Exception as e:          # keep the run alive on IO issues
            print(f"ops: emergency dump failed: {e}")
            return None

    # -- per-step hook --------------------------------------------------
    def _nan_trapped(self) -> Optional[str]:
        """Reason string when the state went unphysical, else None:
        cheap dt probe every step (non-finite OR non-positive once the
        run is under way, i.e. has stepped since the guard was armed — a
        dt that collapsed to zero stalls the run as surely as a NaN),
        full leaf audit (a whole-device download) amortized to every
        ``cons_every``-th check."""
        dt = float(getattr(self.sim, "dt_old", 0.0))
        if not np.isfinite(dt):
            return "nonfinite_dt"
        if dt <= 0.0 and int(getattr(self.sim, "nstep", 0)) > self._nstep0:
            return "nonpositive_dt"
        self._ncheck += 1
        if self._ncheck % max(self.cons_every, 1) == 0 \
                and hasattr(self.sim, "totals"):
            if not np.isfinite(_totals_vector(self.sim.totals())).all():
                return "nonfinite_totals"
        return None

    def _record_fault(self, reason: str):
        tel = getattr(self.sim, "telemetry", None)
        if tel is not None:
            try:
                tel.record_event(
                    "fault", reason=reason,
                    nstep=int(getattr(self.sim, "nstep", 0)),
                    t=float(getattr(self.sim, "t", 0.0)),
                    dt=float(getattr(self.sim, "dt_old", 0.0)))
            except Exception:
                pass

    def _drain_dumper(self):
        """Flush queued async snapshots before a stop returns; report
        writer failures into telemetry + screen rather than raising
        past the clean-shutdown path."""
        if self.dumper is None:
            return
        for e in self.dumper.drain():
            print(f"ops: async snapshot write failed during stop: {e}")
            tel = getattr(self.sim, "telemetry", None)
            if tel is not None:
                try:
                    tel.record_event("io_error", error=repr(e))
                except Exception:
                    pass

    def check(self) -> bool:
        self._max_rss = max(self._max_rss, rss_mb())
        if self.nan_check:
            reason = self._nan_trapped()
            if reason is not None:
                self._record_fault(reason)
                out = self._dump()
                print("ops: NaN TRAP: unphysical state detected "
                      f"({reason}, step "
                      f"{getattr(self.sim, 'nstep', '?')}); crash "
                      f"snapshot -> {out}")
                self._drain_dumper()
                return False
        if self._dump_requested:
            self._dump_requested = False
            out = self._dump()
            print(f"ops: SIGUSR1 snapshot -> {out}")
        if self._stop_requested:
            out = self._dump()
            print(f"ops: stop signal: snapshot -> {out}")
            self._drain_dumper()
            return False
        if os.path.exists(os.path.join(self.base_dir, self.stop_file)):
            out = self._dump()
            print(f"ops: {self.stop_file} found: snapshot -> {out}")
            self._drain_dumper()
            return False
        if self.walltime_s is not None:
            used = time.perf_counter() - self.t0
            # leave room for one more step (reference: 2x the mean step)
            last = time.perf_counter() - self._step_wall
            if used + 2.0 * last > self.walltime_s:
                out = self._dump()
                print(f"ops: walltime watchdog: snapshot -> {out}")
                self._drain_dumper()
                return False
        self._step_wall = time.perf_counter()
        return True

    def run_guarded(self, evolve):
        """Run ``evolve()``; a ``FloatingPointError`` raised inside it (a
        NaN trap in the step) writes the promised crash snapshot and
        re-raises with its traceback intact."""
        try:
            evolve()
        except FloatingPointError:
            out = self._dump()
            print(f"ops: NaN TRAP (raised in the step): crash snapshot -> "
                  f"{out}")
            raise
