"""Single-level (uniform Cartesian) hydro solver (PyTorch).

Port of ``ramses_tpu/grid/uniform.py``: the whole grid is one dense
device tensor and N steps run as a Python loop that keeps ``t``, ``dt``,
``active`` and the step count on the device — no host synchronisation
inside :func:`run_steps`, as in the JAX package's ``lax.scan``.

Two formulations, chosen by configuration only: the fused kernel
(:mod:`ramses_tpu_torch.hydro.fused_muscl`) for 3D f32 hydro within its
scope, where each step is one kernel launch that also yields the next
step's Courant dt; the port of ``muscl.unsplit`` for everything else
(the counterpart of the JAX package's XLA path).  :func:`run_steps_cool`
follows each step with the cooling source (K6 on the card).  The batch
variant of ``run_steps`` is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ramses_tpu_torch.grid import boundary as bmod
from ramses_tpu_torch.hydro import fused_muscl as fm
from ramses_tpu_torch.hydro import muscl
from ramses_tpu_torch.hydro.core import HydroStatic
from ramses_tpu_torch.hydro.timestep import compute_dt


@dataclass(frozen=True)
class UniformGrid:
    """Static description of a uniform-grid problem."""
    cfg: HydroStatic
    shape: Tuple[int, ...]
    dx: float
    bc: bmod.BoundarySpec

    @property
    def ncell(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def fused_ok(grid: UniformGrid, dtype) -> bool:
    """True when the fused kernel covers this grid (configuration only)."""
    return fm.supports(grid.cfg, grid.shape, grid.bc.kinds, dtype)


def step(grid: UniformGrid, u, dt):
    """One conservative MUSCL-Hancock step on the active grid."""
    cfg = grid.cfg
    # the time axis runs in f64 while the state may be f32: keep the
    # sweep in the state dtype
    dt = torch.as_tensor(dt, dtype=u.dtype, device=u.device)
    if fused_ok(grid, u.dtype):
        return fm.fused_step(u, dt, cfg, grid.dx, grid.bc)
    up = bmod.pad(u, grid.bc, cfg, muscl.NGHOST)
    flux, tmp = muscl.unsplit(up, None, dt, (grid.dx,) * cfg.ndim, cfg)
    un = muscl.apply_fluxes(up, flux, cfg)
    if cfg.pressure_fix or cfg.nener:
        un = muscl.dual_energy_fix(up, un, tmp, dt,
                                   (grid.dx,) * cfg.ndim, cfg)
    return bmod.unpad(un, cfg.ndim, muscl.NGHOST)


def step_with_flux(grid: UniformGrid, u, dt):
    """Like :func:`step`, and also the mass flux·dt/dx at the LOW face of
    every active cell, ``[ndim, *shape]`` (positive = flowing in +d): the
    quantity the Monte-Carlo tracers sample
    (``hydro/godunov_fine.f90:685-715``).  Where the fused kernel covers
    the grid this is one launch of its ``want_flux`` entry (its low-face
    slot); elsewhere the general formulation's mass flux."""
    cfg = grid.cfg
    dt = torch.as_tensor(dt, dtype=u.dtype, device=u.device)
    if fused_ok(grid, u.dtype):
        un, phi = fm.fused_step(u, dt, cfg, grid.dx, grid.bc,
                                want_flux=True)
        return un, phi[:, 0]
    up = bmod.pad(u, grid.bc, cfg, muscl.NGHOST)
    flux, tmp = muscl.unsplit(up, None, dt, (grid.dx,) * cfg.ndim, cfg)
    un = muscl.apply_fluxes(up, flux, cfg)
    if cfg.pressure_fix or cfg.nener:
        un = muscl.dual_energy_fix(up, un, tmp, dt,
                                   (grid.dx,) * cfg.ndim, cfg)
    mass_flux = torch.stack([bmod.unpad(flux[d][0], cfg.ndim, muscl.NGHOST)
                             for d in range(cfg.ndim)])
    return bmod.unpad(un, cfg.ndim, muscl.NGHOST), mass_flux


def cfl_dt(grid: UniformGrid, u):
    return compute_dt(u, None, grid.dx, grid.cfg)


def _time(x, u) -> torch.Tensor:
    """A time value as a 0-d f64 tensor on ``u``'s device."""
    return torch.as_tensor(x, dtype=torch.float64, device=u.device)


def run_steps(grid: UniformGrid, u, t, tend, nsteps: int,
              trace: bool = False, dt_scale: float = 1.0):
    """Advance up to ``nsteps`` steps on the device.

    dt is recomputed each step (``courant_fine``), clipped to land exactly
    on ``tend``; steps past ``tend`` are no-ops.  ``t``/``tend`` are
    integrated in f64 whatever the state dtype.  Returns
    ``(u, t, n_done)`` as device tensors; ``trace=True`` additionally
    returns the per-step ``(t_after, dt)`` history as two ``[nsteps]``
    tensors.  ``dt_scale < 1`` shrinks every Courant dt by that factor.
    """
    t = _time(t, u)
    tend = _time(tend, u)
    if fused_ok(grid, u.dtype):
        return _run_steps_fused(grid, u, t, tend, nsteps, trace, dt_scale)
    ndone = torch.zeros((), dtype=torch.int64, device=u.device)
    hist = []
    for _ in range(nsteps):
        dt = (cfl_dt(grid, u) * dt_scale).to(torch.float64)
        dt = torch.minimum(dt, torch.clamp(tend - t, min=0.0))
        active = t < tend
        dt_eff = torch.where(active, dt, 0.0)
        un = step(grid, u, dt_eff)
        u = torch.where(active, un, u)
        t = torch.where(active, t + dt, t)
        ndone = ndone + active.to(torch.int64)
        hist.append((t, dt_eff))
    return _finish(u, t, ndone, hist, trace)


def _run_steps_fused(grid: UniformGrid, u, t, tend, nsteps: int,
                     trace: bool, dt_scale: float):
    """:func:`run_steps` on the fused kernel: the Courant reduction of the
    updated state comes out of the step kernel itself, so each iteration
    is exactly one kernel launch plus a few scalar ops."""
    cfg = grid.cfg
    dtc = compute_dt(u, None, grid.dx, cfg) * dt_scale
    ndone = torch.zeros((), dtype=torch.int64, device=u.device)
    hist = []
    for _ in range(nsteps):
        dt = torch.minimum(dtc.to(torch.float64),
                           torch.clamp(tend - t, min=0.0))
        active = t < tend
        dt_eff = torch.where(active, dt, 0.0)
        # an inactive step runs with dt = 0 and adds exactly zero to every
        # (finite) flux, so its result is u itself: the scan body's
        # where(active, un, u) would be a full extra pass for nothing
        u, dtn = fm.fused_step(u, dt_eff.to(u.dtype), cfg, grid.dx, grid.bc,
                               courant=True, dt_scale=dt_scale)
        t = torch.where(active, t + dt, t)
        dtc = torch.where(active, dtn, dtc)
        ndone = ndone + active.to(torch.int64)
        hist.append((t, dt_eff))
    return _finish(u, t, ndone, hist, trace)


def run_steps_cool(grid: UniformGrid, u, t, tend, nsteps: int, tables,
                   cspec):
    """:func:`run_steps` with the cooling source applied after each hydro
    step (the ``cooling_fine`` call that follows ``godunov_fine`` in
    ``amr/amr_step.f90:448-474``): each step is :func:`step` (K1 where it
    covers the grid), then :func:`ramses_tpu_torch.hydro.cooling.
    cooling_step` with the step's dt (K6's fused entry on the card), both
    masked by ``active`` as in the JAX package.  The Courant dt is recomputed from the cooled state each
    step; nothing is fetched.  Returns ``(u, t, n_done)`` as device
    tensors."""
    from ramses_tpu_torch.hydro.cooling import cooling_step
    t = _time(t, u)
    tend = _time(tend, u)
    ndone = torch.zeros((), dtype=torch.int64, device=u.device)
    for _ in range(nsteps):
        dt = cfl_dt(grid, u).to(torch.float64)
        dt = torch.minimum(dt, torch.clamp(tend - t, min=0.0))
        active = t < tend
        dt_eff = torch.where(active, dt, 0.0)
        un = step(grid, u, dt_eff)
        # the step's fresh state: its E row is rewritten in place
        un = cooling_step(un, tables, cspec, dt_eff.to(u.dtype), grid.cfg,
                          inplace=True)
        u = torch.where(active, un, u)
        t = torch.where(active, t + dt, t)
        ndone = ndone + active.to(torch.int64)
    return u, t, ndone


def _finish(u, t, ndone, hist, trace: bool):
    if not trace:
        return u, t, ndone
    ts = torch.stack([h[0] for h in hist]) if hist else t.new_zeros(0)
    dts = torch.stack([h[1] for h in hist]) if hist else t.new_zeros(0)
    return u, t, ndone, (ts, dts)


def totals(u, cfg: HydroStatic, dx: float):
    """Conservation audit (mass, momentum, energy) — ``check_cons``
    (``hydro/courant_fine.f90:161``); 0-d device tensors."""
    vol = dx ** cfg.ndim
    return {
        "mass": torch.sum(u[0]) * vol,
        "momentum": [torch.sum(u[1 + d]) * vol for d in range(cfg.ndim)],
        "energy": torch.sum(u[cfg.ndim + 1]) * vol,
    }
