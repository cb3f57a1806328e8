"""Supervised retry-with-resume loop for namelist-driven runs.

The port's own copy of ``ramses_tpu/resilience/supervisor.py``.

``supervise(build, drive, params, ...)`` runs a bounded attempt loop:
attempt 1 resolves the restart directory from the namelist
(``nrestart``/``auto_resume``), later attempts always pick the newest
manifest-valid checkpoint — so a SIGTERM/preemption mid-run (whose
OpsGuard stop path flushes queued dumps) resumes from the last good
output instead of failing the allocation.  Backoff between attempts is
exponential and capped (:func:`backoff_delay`).

Failures are *classified*: a :class:`HangDetected` from the watchdog
(ROADMAP A7 in the port) is a hang, a :class:`StepRetryExhausted` from
the step-guard ladder is a NaN, anything else is a crash.  Hangs get a
hang-specific policy — immediate resume from the newest checkpoint
with NO backoff and NO dt-halving (the state is stale, not numerically
suspect) under a separate bounded ``hang_retries`` budget that never
consumes regular crash attempts; once that budget is spent the hang
re-raises so a process-level parent (a batch system) can apply ITS
hang policy (exit-code classification).  The telemetry
hooks read ``getattr(sim, "telemetry", None)``, which is None on the
port's drivers while telemetry is refused.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ramses_tpu_torch.resilience.checkpoint import (
    latest_valid_checkpoint, resolve_restart_dir)
from ramses_tpu_torch.resilience.stepguard import StepRetryExhausted
from ramses_tpu_torch.resilience.watchdog import HangDetected


def classify(err: Optional[BaseException]) -> str:
    """Supervisor fault taxonomy: hang vs nan vs crash (vs none)."""
    if err is None:
        return "none"
    if isinstance(err, HangDetected):
        return "hang"
    if isinstance(err, StepRetryExhausted):
        return "nan"
    return "crash"


def backoff_delay(attempt: int, base: float = 1.0,
                  cap: float = 30.0) -> float:
    """Exponential backoff (attempt 1 -> base, doubling), capped."""
    return float(min(cap, base * (2.0 ** max(0, int(attempt) - 1))))


def _sim_t(sim) -> float:
    st = getattr(sim, "state", None)
    if st is not None and hasattr(st, "t"):
        return float(st.t)
    return float(getattr(sim, "t", 0.0))


def _sim_nstep(sim) -> int:
    st = getattr(sim, "state", None)
    if st is not None and hasattr(st, "nstep"):
        return int(st.nstep)
    return int(getattr(sim, "nstep", 0))


def run_complete(sim, params, tend: Optional[float] = None) -> bool:
    """Did the run reach its configured end (tend or nstepmax)?"""
    run = getattr(params, "run", None)
    nmax = getattr(run, "nstepmax", None)
    if nmax is not None and int(nmax) > 0 \
            and _sim_nstep(sim) >= int(nmax):
        return True
    end = tend
    if end is None:
        touts = getattr(getattr(params, "output", None), "tout",
                        None) or ()
        end = max(touts) if touts else None
    if end is None:
        return True               # nothing to measure against
    # Round-off slack: the drivers stop at t >= tend - eps*tend.
    return _sim_t(sim) >= float(end) * (1.0 - 1e-12) - 1e-300


def _close_tel(tel, sim):
    """Close an attempt's telemetry so the resumed one appends
    cleanly."""
    if tel is not None:
        try:
            tel.close(sim, print_timers=False)
        except Exception:
            pass


def supervise(build: Callable, drive: Callable, params,
              base_dir: str = ".", max_attempts: int = 3,
              backoff_s: float = 1.0, tend: Optional[float] = None,
              log: Callable = print, hang_retries: int = 2):
    """Run ``drive(build(restart_dir))`` until complete or attempts
    are exhausted.

    ``build(restart_dir)`` constructs the simulation (fresh when
    restart_dir is None, else restored from that checkpoint);
    ``drive(sim)`` evolves it and returns normally on a clean stop
    (including an OpsGuard-handled SIGTERM).  Returns the final sim.

    ``hang_retries`` bounds hang-classified resumes separately from
    ``max_attempts`` (see module docstring); ``hang_retries=0`` makes
    a hang escape on first detection.
    """
    max_attempts = max(1, int(max_attempts))
    hang_retries = max(0, int(hang_retries))
    last_err = None
    sim = None
    attempt = 0
    hang_used = 0
    nbuild = 0
    while attempt < max_attempts:
        attempt += 1
        nbuild += 1
        if nbuild == 1:
            restart = resolve_restart_dir(params, base_dir=base_dir,
                                          log=log)
        else:
            restart = latest_valid_checkpoint(base_dir, log=log)
            if restart is not None:
                log(f"resilience: attempt {attempt}/{max_attempts} "
                    f"resuming from {restart}")
            else:
                log(f"resilience: attempt {attempt}/{max_attempts} "
                    "found no valid checkpoint; restarting fresh")
        sim = build(restart)
        tel = getattr(sim, "telemetry", None)
        if tel is not None and (restart is not None or nbuild > 1):
            # any rebuild appends — even a fresh restart after a failed
            # attempt must not truncate the earlier attempts' fault
            # events (hang/rollback/...) out of the JSONL log
            try:
                tel.mark_resumed(restart, attempt)
            except AttributeError:
                pass
        try:
            drive(sim)
            last_err = None
        except Exception as e:   # noqa: BLE001 — supervisor boundary
            last_err = e
            log(f"resilience: attempt {attempt} failed "
                f"(classified {classify(e)}): {e!r}")
        if last_err is None and run_complete(sim, params, tend=tend):
            return sim
        if classify(last_err) == "hang":
            # hang policy: immediate resume (no backoff, no
            # dt-halving — the ladder never saw a trip), bounded by
            # its own budget, never converted into a crash attempt
            _close_tel(tel, sim)
            if hang_used >= hang_retries:
                log(f"resilience: hang budget exhausted "
                    f"({hang_used}/{hang_retries}); re-raising for "
                    "process-level classification")
                raise last_err
            hang_used += 1
            attempt -= 1
            log(f"resilience: hang retry {hang_used}/{hang_retries}: "
                "immediate resume from newest checkpoint")
            continue
        if attempt == max_attempts:
            break
        # Interrupted (stop flag / SIGTERM / crash): close this
        # attempt's telemetry so the resumed one appends cleanly.
        _close_tel(tel, sim)
        delay = backoff_delay(attempt, base=backoff_s)
        log(f"resilience: run incomplete at nstep={_sim_nstep(sim)} "
            f"t={_sim_t(sim):.6g}; retrying in {delay:.1f}s")
        time.sleep(delay)
    if last_err is not None:
        raise last_err
    log(f"resilience: giving up after {max_attempts} attempts "
        f"(nstep={_sim_nstep(sim)} t={_sim_t(sim):.6g})")
    return sim
