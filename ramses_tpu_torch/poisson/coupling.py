"""Gravity primitives shared by the coupled steppers (PyTorch).

Port of ``ramses_tpu/poisson/coupling.py``.  The per-step sequence itself
lives in :mod:`ramses_tpu_torch.pm.coupling` (``pm_hydro_step``).  This
module holds the pieces:

- :class:`GravitySpec` — static config of the solve
- :func:`solve_phi` / :func:`gravity_field` — Poisson RHS + solve + force
  (``Lap(phi) = fourpi*(rho - mean)``, ``fourpi = 4*pi`` in code units,
  ``poisson/multigrid_fine_commons.f90:1082-1112``)
- :func:`kick` — momentum kick at fixed internal energy
  (``hydro/synchro_hydro_fine.f90:56-141``)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ramses_tpu_torch.grid import boundary as bmod
from ramses_tpu_torch.hydro import muscl
from ramses_tpu_torch.hydro.core import HydroStatic
from ramses_tpu_torch.poisson import force as fmod
from ramses_tpu_torch.poisson import solver as smod
from ramses_tpu_torch.poisson.gravana import cell_centers, gravana
from ramses_tpu_torch.poisson.isolated import grad_isolated, isolated_solve


@dataclass(frozen=True)
class GravitySpec:
    """Static gravity configuration."""
    enabled: bool = False
    gravity_type: int = 0               # 0: self-gravity; >0: analytic
    gravity_params: Tuple[float, ...] = ()
    solver: str = "fft"                  # fft | mg | cg
    epsilon: float = 1e-4                # &POISSON_PARAMS epsilon
    ncycle: int = 10                     # MG V-cycle cap (MAXITER=10)
    cg_iters: int = 150
    boxlen: float = 1.0
    fourpi: float = 4.0 * 3.14159265358979323846
    # False: any non-periodic face → isolated multipole-Dirichlet solve
    # (poisson/boundary_potential.f90 path, poisson/isolated.py)
    periodic: bool = True

    @classmethod
    def from_params(cls, p) -> "GravitySpec":
        if not p.run.poisson:
            return cls(enabled=False)
        # solver selection: the reference uses MG below cg_levelmin and CG
        # at/above it (amr/amr_step.f90:250-258); the uniform-grid default
        # is the exact FFT solve, overridable via &POISSON_PARAMS solver=.
        raw = p.raw.get("poisson_params", {}) if p.raw else {}
        default = "cg" if p.poisson.cg_levelmin <= p.amr.levelmin else "fft"
        solver = str(raw.get("solver", default)).strip("'\" ").lower()
        return cls(enabled=True,
                   gravity_type=int(p.poisson.gravity_type),
                   gravity_params=tuple(float(v)
                                        for v in p.poisson.gravity_params),
                   epsilon=float(p.poisson.epsilon),
                   solver=solver,
                   boxlen=float(p.amr.boxlen),
                   periodic=_all_periodic(
                       bmod.BoundarySpec.from_params(p)))


def solve_phi(spec: GravitySpec, rho, dx: float):
    """Potential of the density contrast (zero-mean rhs, periodic)."""
    rhs = spec.fourpi * (rho - torch.mean(rho))
    if spec.solver == "fft":
        return smod.fft_solve(rhs, dx)
    if spec.solver == "mg":
        return smod.mg_solve(rhs, dx, ncycle=spec.ncycle)
    if spec.solver == "cg":
        return smod.cg_solve(rhs, dx, iters=spec.cg_iters, tol=spec.epsilon)
    raise ValueError(spec.solver)


def gravity_field(spec: GravitySpec, rho, dx: float):
    """Acceleration [ndim, *sp]: analytic model or self-gravity solve."""
    if spec.gravity_type > 0:
        x = cell_centers(tuple(rho.shape), dx, dtype=rho.dtype,
                         device=rho.device)
        return gravana(x, spec.gravity_type, spec.gravity_params,
                       spec.boxlen)
    if not spec.periodic:
        phi, gh = isolated_solve(rho, dx, spec.fourpi, iters=spec.cg_iters,
                                 tol=spec.epsilon)
        return grad_isolated(phi, gh, dx)
    return fmod.force(solve_phi(spec, rho, dx), dx)


def kick(u, f, dteff, cfg: HydroStatic):
    """Momentum kick at fixed internal energy (synchydrofine1)."""
    r = torch.clamp(u[0], min=cfg.smallr)
    ekin_old = sum(0.5 * u[1 + d] ** 2 for d in range(cfg.ndim)) / r
    mom = [u[1 + d] + r * f[d] * dteff for d in range(cfg.ndim)]
    ekin_new = sum(0.5 * m * m for m in mom) / r
    e = u[cfg.ndim + 1] - ekin_old + ekin_new
    return torch.cat([u[0:1], torch.stack(mom), e[None],
                      u[cfg.ndim + 2:]], dim=0)


def _all_periodic(bc: bmod.BoundarySpec) -> bool:
    return all(f.kind == bmod.PERIODIC for pair in bc.faces for f in pair)


def _pad_force(f, ndim: int, mode: str, ng: int = muscl.NGHOST):
    """Ghost-pad the force field's trailing ``ndim`` axes by ``ng`` cells
    (``mode`` "wrap" for periodic, "edge" otherwise)."""
    for ax in range(f.dim() - ndim, f.dim()):
        n = f.shape[ax]
        idx = torch.arange(-ng, n + ng, device=f.device)
        idx = idx % n if mode == "wrap" else idx.clamp(0, n - 1)
        f = f.index_select(ax, idx)
    return f
