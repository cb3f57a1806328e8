"""Failure type of the numerical step guard.

Only :class:`StepRetryExhausted` is here, so that
:func:`ramses_tpu_torch.resilience.supervisor.classify` has its types, as
``ramses_tpu/resilience/stepguard.py`` defines it.  The guard itself (the
finiteness checks, rollback and the halved-dt redo-step ladder) is
ROADMAP A7, and the drivers refuse ``&RUN_PARAMS max_step_retries`` by name
until then.
"""

from __future__ import annotations


class StepRetryExhausted(RuntimeError):
    """Raised after ``max_step_retries`` rollback attempts all failed;
    the driver emergency-dumps the last clean state before raising."""
