"""Particle constants and the free-fall time step (port of the part of
``ramses_tpu/pm/particles.py`` the gas tracers and the gravity stepper
use).

Only the gas-tracer id base and family code and :func:`freefall_dt` are
ported so far;
particle storage and the particle-mesh operations come with the particle
slice.
"""

import math

import torch

# base of the gas-tracer id space (``pm/particles.py:45`` of the JAX
# package): assigned once at seeding, stable across dumps, clear of the
# incremental star/DM id space
TRACER_ID0 = 1 << 30
# the gas tracers' particle family (``pm/pm_commons.f90:84-87``): snapshots
# write them as massless rows of this family
FAM_GAS_TRACER = 0


def freefall_dt(rho_max, courant_factor: float, fourpi: float):
    """Free-fall constraint (``pm/newdt_fine.f90:51-60``):
    dt <= cf * sqrt(3*pi^2 / (8 * fourpi * rho_max))."""
    threepi2 = 3.0 * math.pi ** 2
    tff = torch.sqrt(threepi2 / 8.0 / fourpi
                     / torch.clamp(torch.as_tensor(rho_max), min=1e-30))
    return courant_factor * tff
