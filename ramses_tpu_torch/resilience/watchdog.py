"""Hang classification types of the deadline watchdog.

Only what :func:`ramses_tpu_torch.resilience.supervisor.classify` and the
CLI's exit status need is here: :class:`HangDetected` and
:data:`HANG_EXIT_CODE`, as ``ramses_tpu/resilience/watchdog.py`` defines
them.  The watchdog itself (the monitor thread, the emergency
``hang_NNNNN/`` dump, the SIGALRM soft interrupt) is ROADMAP A7, and the
drivers refuse ``&RUN_PARAMS *_deadline_s`` by name until then.
"""

from __future__ import annotations

#: process exit status for an unrecoverable (hard) hang — distinct
#: from crash (nonzero) and clean exit so parents classify by rc.
HANG_EXIT_CODE = 87


class HangDetected(RuntimeError):
    """A guarded phase exceeded its wall-clock deadline.

    Carries the classification payload (phase, deadline, last-known
    host step/time) so supervisors can log hang-vs-crash distinctly.
    """

    def __init__(self, phase: str = "step", deadline_s: float = 0.0,
                 nstep=None, t=None):
        self.phase = phase
        self.deadline_s = float(deadline_s)
        self.nstep = nstep
        self.t = t
        at = f" at nstep={nstep}" if nstep is not None else ""
        super().__init__(f"phase {phase!r} exceeded "
                         f"{self.deadline_s:g}s deadline{at}")
