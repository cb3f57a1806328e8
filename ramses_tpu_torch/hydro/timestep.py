"""CFL timestep (``cmpdt``, hydro/godunov_utils.f90:5-125), PyTorch.

Port of ``ramses_tpu/hydro/timestep.py``: the per-cell Courant-limited dt
including the reference's gravity-strength correction factor, reduced
with ``min`` on the device (no host synchronisation).
"""

from __future__ import annotations

import torch

from ramses_tpu_torch.hydro.core import HydroStatic


def cell_dt(u, grav, dx: float, cfg: HydroStatic):
    """Per-cell Courant-limited dt (shape = spatial shape of ``u``).

    ``u``: [nvar, *sp]; ``grav``: list of ndim accel arrays or None;
    ``dx``: cell size (scalar — cubic cells, as the reference assumes).
    """
    r = torch.clamp(u[0], min=cfg.smallr)
    inv_r = 1.0 / r
    vels = [u[1 + d] * inv_r for d in range(cfg.ndim)]
    eint = u[cfg.ndim + 1] - 0.5 * r * sum(v * v for v in vels)
    for n in range(cfg.nener):
        eint = eint - u[2 + cfg.ndim + n]
    p = torch.maximum((cfg.gamma - 1.0) * eint, r * cfg.smallp)
    c2 = cfg.gamma * p
    for n in range(cfg.nener):
        c2 = c2 + cfg.gamma_rad[n] * (cfg.gamma_rad[n] - 1.0) * u[2 + cfg.ndim + n]
    c = torch.sqrt(c2 * inv_r)

    # wave speed: ndim*c + sum |v| (godunov_utils.f90:88-97)
    ws = float(cfg.ndim) * c
    for v in vels:
        ws = ws + torch.abs(v)

    # gravity strength ratio (godunov_utils.f90:100-110)
    if grav is not None:
        gnorm = sum(torch.abs(g) for g in grav)
    else:
        gnorm = torch.zeros_like(ws)
    ratio = torch.clamp(gnorm * dx / ws ** 2, min=1e-4)

    cf = cfg.courant_factor
    return dx / ws * (torch.sqrt(1.0 + 2.0 * cf * ratio) - 1.0) / ratio


def compute_dt(u, grav, dx: float, cfg: HydroStatic):
    """Max allowed dt over a (sub)grid: min of :func:`cell_dt`, capped by
    the reference's ``dtmax`` guard.  A 0-d tensor on ``u``'s device."""
    dtmax = cfg.courant_factor * dx / cfg.smallc
    return torch.clamp(torch.min(cell_dt(u, grav, dx, cfg)), max=dtmax)
