"""Coupled particle + hydro + gravity stepper on the uniform grid (PyTorch).

Port of ``ramses_tpu/pm/coupling.py``, the JAX package's one
single-level stepper for every physics combination: gravity-only runs use
it with particles disabled, N-body-only runs with hydro disabled.  The
per-step operation order is ``amr/amr_step.f90``'s for the single-level
case, with the reference's split-kick leapfrog:

  1. ``rho_fine``: total density = gas + CIC(particles)   (:219-225)
  2. hydro gravity un-kick (-0.5 dt, old force)           (:246)
  3. Poisson solve -> phi -> f = -grad(phi)               (:250-266)
  4. ``synchro_fine``: particle kick v += f(x) 0.5*dt_old (:268-273)
     — completes the previous step's kick with the new force
  5. hydro kick +0.5 dt new force; Godunov sweep with the gravity
     predictor; final hydro kick +0.5 dt                  (:279,388,427)
  6. ``move_fine``: v += f(x) 0.5*dt_new then x += v dt   (:479-486)
  7. dt for the next step: min(hydro CFL with the gravity-strength
     correction, particle Courant, free-fall, cosmological 0.1/hexp)
                                                          (pm/newdt_fine.f90)

Cosmology: the loop runs in supercomoving conformal time; the Poisson rhs
factor becomes ``1.5*omega_m*aexp`` and aexp/hexp are table look-ups on
the device each step (``amr/update_time.f90``).

The hydro sweep is the general formulation (``muscl.unsplit`` with the
force as its gravity source), as in the JAX package: K1 takes no gravity
source.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ramses_tpu_torch.grid import boundary as bmod
from ramses_tpu_torch.grid.uniform import UniformGrid
from ramses_tpu_torch.hydro import muscl
from ramses_tpu_torch.hydro.timestep import compute_dt
from ramses_tpu_torch.pm import particles as pmod
from ramses_tpu_torch.poisson.coupling import (GravitySpec, _all_periodic,
                                               _pad_force, gravity_field,
                                               kick)


def deposit_scheme_from_params(p) -> str:
    """Validated &PM_PARAMS deposit scheme (shared by the uniform and AMR
    particle paths so both read the namelist identically)."""
    dep = str((p.raw or {}).get("pm_params", {})
              .get("deposit", "cic")).strip("'\" ").lower()
    if dep not in ("ngp", "cic", "tsc"):
        raise ValueError(
            f"&PM_PARAMS deposit={dep!r}: expected ngp|cic|tsc")
    return dep


@dataclass(frozen=True)
class PMSpec:
    """Static particle-mesh configuration."""
    enabled: bool = False
    hydro: bool = True
    deposit: str = "cic"          # cic | ngp | tsc
    courant_factor: float = 0.5
    boxlen: float = 1.0
    cosmo: bool = False

    @classmethod
    def from_params(cls, p) -> "PMSpec":
        return cls(enabled=bool(p.run.pic), hydro=bool(p.run.hydro),
                   deposit=deposit_scheme_from_params(p),
                   courant_factor=float(p.hydro.courant_factor),
                   boxlen=float(p.amr.boxlen), cosmo=bool(p.run.cosmo))


def deposit(spec: PMSpec, p: pmod.ParticleSet, shape, dx: float):
    fn = {"cic": pmod.deposit_cic, "ngp": pmod.deposit_ngp,
          "tsc": pmod.deposit_tsc}[spec.deposit]
    return fn(p, shape, dx)


def gather(spec: PMSpec, field, x, dx: float):
    """Force interpolation with the same kernel as the deposit: mismatched
    pairs produce particle self-forces (the reference ties both to
    ``interp_mode``, ``pm/move_fine.f90:255``)."""
    fn = {"cic": pmod.gather_cic, "ngp": pmod.gather_ngp,
          "tsc": pmod.gather_tsc}[spec.deposit]
    return fn(field, x, dx)


def total_density(spec: PMSpec, u, p: Optional[pmod.ParticleSet], shape,
                  dx: float):
    """``rho_fine``: gas density + particle deposition."""
    if spec.hydro:
        rho = u[0]
    else:
        src = p.x if p is not None else u
        rho = torch.zeros(tuple(shape), dtype=src.dtype, device=src.device)
    if spec.enabled and p is not None:
        rho = rho + deposit(spec, p, shape, dx)
    return rho


def pm_hydro_step(grid: UniformGrid, gspec: GravitySpec, pspec: PMSpec,
                  u, p: Optional[pmod.ParticleSet], f_old, dt, dt_old,
                  fourpi=None, rho=None):
    """One coupled step; returns ``(u, p, f_new)``.  ``dt`` is a 0-d tensor
    in the state dtype, ``dt_old`` the previous step (the particle kick's),
    ``fourpi`` the Poisson factor when it is not the static one
    (cosmology); ``rho`` may pass in the total density at x^n already
    deposited for the step's dt."""
    cfg = grid.cfg
    particles = pspec.enabled and p is not None
    # 1. total density at x^n
    if rho is None:
        rho = total_density(pspec, u, p, grid.shape, grid.dx)
    # 2-3. gravity update
    if pspec.hydro and gspec.enabled:
        u = kick(u, f_old, -0.5 * dt, cfg)
    f = (gravity_field(gspec, rho, grid.dx, fourpi) if gspec.enabled
         else torch.zeros_like(f_old))
    # 4. complete the previous particle kick with the new force at x^n
    if particles:
        f_at_p = gather(pspec, f, p.x, grid.dx)
        p = pmod.kick(p, f_at_p, 0.5 * dt_old)
    # 5. hydro with the gravity predictor
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
    # 6. particle half-kick + drift
    if particles:
        p = pmod.kick(p, f_at_p, 0.5 * dt)
        p = pmod.drift(p, dt, pspec.boxlen)
    return u, p, f


def pm_compute_dt(grid: UniformGrid, gspec: GravitySpec, pspec: PMSpec,
                  u, p, f, hexp=None, fourpi=None, rho=None):
    """min(hydro CFL, particle Courant, free-fall, cosmo 0.1/|hexp|); a
    0-d device tensor."""
    cfg = grid.cfg
    dts = []
    if pspec.hydro:
        grav = [f[d] for d in range(cfg.ndim)] if gspec.enabled else None
        dts.append(compute_dt(u, grav, grid.dx, cfg))
    if pspec.enabled and p is not None:
        dts.append(pmod.particle_dt(p, grid.dx, pspec.courant_factor))
    if gspec.enabled:
        if rho is None:
            rho = total_density(pspec, u, p, grid.shape, grid.dx)
        fp = gspec.fourpi if fourpi is None else fourpi
        dts.append(pmod.freefall_dt(torch.max(rho), pspec.courant_factor,
                                    fp))
    if not dts:
        # nothing constrains dt (e.g. a cosmo-only run): the expansion cap
        # below, else a fixed cap, as the JAX package's
        dts.append(torch.full((), 1e30, dtype=torch.float64,
                              device=u.device))
    dt = dts[0]
    for d in dts[1:]:
        dt = torch.minimum(dt, d)
    if hexp is not None:
        dt = torch.minimum(dt, 0.1 / torch.abs(hexp))
    return dt


def run_steps_pm(grid: UniformGrid, gspec: GravitySpec, pspec: PMSpec,
                 u, p, f, t, tend, dt_old, nsteps: int, cosmo=None):
    """Advance up to ``nsteps`` coupled steps on the device: dt, ``t <
    tend`` masking and the step count stay device tensors (``t``, ``tend``
    and ``dt_old`` 0-d f64), so the loop never waits on the host.  With
    ``cosmo`` (a :class:`ramses_tpu_torch.pm.cosmology.Cosmology`) ``t``
    is the supercomoving conformal time and aexp, hexp and the Poisson
    factor are table look-ups on the device each step.  Returns ``(u, p,
    f, t, dt_old, n_done)``."""
    ndone = torch.zeros((), dtype=torch.int64, device=t.device)
    sdtype = u.dtype
    for _ in range(nsteps):
        if cosmo is not None:
            aexp = cosmo.aexp_of_tau(t)
            hexp = cosmo.hexp_of_tau(t)
            fourpi = 1.5 * cosmo.omega_m * aexp
        else:
            hexp, fourpi = None, None
        rho = total_density(pspec, u, p, grid.shape, grid.dx)
        dt = pm_compute_dt(grid, gspec, pspec, u, p, f, hexp, fourpi,
                           rho=rho)
        dt = torch.minimum(dt.to(t.dtype), torch.clamp(tend - t, min=0.0))
        active = t < tend
        dt = torch.where(active, dt, 0.0)
        un, pn, fn = pm_hydro_step(grid, gspec, pspec, u, p, f,
                                   dt.to(sdtype), dt_old, fourpi, rho=rho)
        u = torch.where(active, un, u)
        if p is not None:
            p = pn.where(active, p)
        f = torch.where(active, fn, f)
        t = t + dt
        dt_old = torch.where(active, dt, dt_old)
        ndone = ndone + active.to(torch.int64)
    return u, p, f, t, dt_old, ndone
