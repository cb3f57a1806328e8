"""Hydro + gravity stepper on the uniform grid (PyTorch).

Port of the gravity branch of ``ramses_tpu/pm/coupling.py``, the JAX
package's one single-level stepper for every physics combination.  The
per-step operation order is ``amr/amr_step.f90``'s for the single-level
case, with the reference's split kick:

  1. ``rho_fine``: the density the solve sees (gas)       (:219-225)
  2. hydro gravity un-kick (-0.5 dt, old force)           (:246)
  3. Poisson solve -> phi -> f = -grad(phi)               (:250-266)
  4. hydro kick +0.5 dt new force; Godunov sweep with the gravity
     predictor; final hydro kick +0.5 dt                  (:279,388,427)
  5. dt for the next step: min(hydro CFL with the gravity-strength
     correction, free-fall)                               (pm/newdt_fine.f90)

The hydro sweep is the general formulation (``muscl.unsplit`` with the
force as its gravity source), as in the JAX package: K1 takes no gravity
source.  Particles (``&RUN_PARAMS pic``) and cosmology are not ported
yet: :class:`PMSpec` refuses ``pic``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ramses_tpu_torch.grid import boundary as bmod
from ramses_tpu_torch.grid.uniform import UniformGrid
from ramses_tpu_torch.hydro import muscl
from ramses_tpu_torch.hydro.timestep import compute_dt
from ramses_tpu_torch.pm import particles as pmod
from ramses_tpu_torch.poisson.coupling import (GravitySpec, _all_periodic,
                                               _pad_force, gravity_field,
                                               kick)


@dataclass(frozen=True)
class PMSpec:
    """Static particle-mesh configuration: the gas side only (the particle
    fields of the JAX package's come with the particle layer)."""
    hydro: bool = True
    courant_factor: float = 0.5

    @classmethod
    def from_params(cls, p) -> "PMSpec":
        if p.run.pic:
            raise NotImplementedError("not ported to ramses_tpu_torch yet: "
                                      "particles (&RUN_PARAMS pic)")
        return cls(hydro=bool(p.run.hydro),
                   courant_factor=float(p.hydro.courant_factor))


def total_density(spec: PMSpec, u):
    """``rho_fine``: the gas density (the particle deposit is not
    ported)."""
    return u[0] if spec.hydro else torch.zeros_like(u[0])


def pm_hydro_step(grid: UniformGrid, gspec: GravitySpec, pspec: PMSpec,
                  u, f_old, dt, rho=None):
    """One coupled step; returns (u, f_new).  ``dt`` is a 0-d tensor in
    the state dtype; ``rho`` may pass in the density already taken for the
    step's dt."""
    cfg = grid.cfg
    if rho is None:
        rho = total_density(pspec, u)
    if pspec.hydro and gspec.enabled:
        u = kick(u, f_old, -0.5 * dt, cfg)
    f = (gravity_field(gspec, rho, grid.dx) if gspec.enabled
         else torch.zeros_like(f_old))
    if pspec.hydro:
        if gspec.enabled:
            u = kick(u, f, 0.5 * dt, cfg)
        up = bmod.pad(u, grid.bc, cfg, muscl.NGHOST)
        mode = "wrap" if _all_periodic(grid.bc) else "edge"
        fp = _pad_force(f, cfg.ndim, mode)
        grav = [fp[d] for d in range(cfg.ndim)] if gspec.enabled else None
        dxs = (grid.dx,) * cfg.ndim
        flux, tmp = muscl.unsplit(up, grav, dt, dxs, cfg)
        un = muscl.apply_fluxes(up, flux, cfg)
        if cfg.pressure_fix or cfg.nener:
            un = muscl.dual_energy_fix(up, un, tmp, dt, dxs, cfg)
        u = bmod.unpad(un, cfg.ndim, muscl.NGHOST)
        if gspec.enabled:
            u = kick(u, f, 0.5 * dt, cfg)
    return u, f


def pm_compute_dt(grid: UniformGrid, gspec: GravitySpec, pspec: PMSpec,
                  u, f, rho=None):
    """min(hydro CFL, free-fall); a 0-d device tensor."""
    cfg = grid.cfg
    dts = []
    if pspec.hydro:
        grav = [f[d] for d in range(cfg.ndim)] if gspec.enabled else None
        dts.append(compute_dt(u, grav, grid.dx, cfg))
    if gspec.enabled:
        if rho is None:
            rho = total_density(pspec, u)
        dts.append(pmod.freefall_dt(torch.max(rho), pspec.courant_factor,
                                    gspec.fourpi))
    if not dts:
        # nothing constrains dt: a fixed cap, as the JAX package's
        return torch.full((), 1e30, dtype=torch.float64, device=u.device)
    dt = dts[0]
    for d in dts[1:]:
        dt = torch.minimum(dt, d)
    return dt


def run_steps_pm(grid: UniformGrid, gspec: GravitySpec, pspec: PMSpec,
                 u, f, t, tend, nsteps: int):
    """Advance up to ``nsteps`` coupled steps on the device: dt, ``t <
    tend`` masking and the step count stay device tensors (``t``, ``tend``
    0-d f64), so the loop never waits on the host.  Returns ``(u, f, t,
    n_done)``; the previous dt the JAX package also carries is the
    particle kick's, which comes with the particle layer."""
    ndone = torch.zeros((), dtype=torch.int64, device=t.device)
    for _ in range(nsteps):
        rho = total_density(pspec, u)
        dt = pm_compute_dt(grid, gspec, pspec, u, f, rho=rho)
        dt = torch.minimum(dt.to(t.dtype), torch.clamp(tend - t, min=0.0))
        active = t < tend
        dt = torch.where(active, dt, 0.0)
        un, fn = pm_hydro_step(grid, gspec, pspec, u, f, dt.to(u.dtype),
                               rho=rho)
        u = torch.where(active, un, u)
        f = torch.where(active, fn, f)
        t = t + dt
        ndone = ndone + active.to(torch.int64)
    return u, f, t, ndone
