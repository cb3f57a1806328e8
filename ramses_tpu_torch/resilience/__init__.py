"""Fault-tolerant execution layer: the port of ``ramses_tpu/resilience``'s
atomic validated checkpoints (:mod:`.checkpoint`) and supervised
retry-with-resume (:mod:`.supervisor`).  The step guard, the watchdog and
fault injection are ROADMAP A7; :mod:`.stepguard` and :mod:`.watchdog`
hold only the failure types the supervisor classifies."""
