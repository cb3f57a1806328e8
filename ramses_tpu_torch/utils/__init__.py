"""Operational helpers (the port's copies from ``ramses_tpu/utils``)."""
