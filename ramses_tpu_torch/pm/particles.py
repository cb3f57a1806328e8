"""Particle constants (port of the part of ``ramses_tpu/pm/particles.py``
the hierarchy's gas tracers use).

Only the gas-tracer id base is ported so far; particle storage and the
particle-mesh operations come with the particle slice.
"""

# base of the gas-tracer id space (``pm/particles.py:45`` of the JAX
# package): assigned once at seeding, stable across dumps, clear of the
# incremental star/DM id space
TRACER_ID0 = 1 << 30
