"""Analytic (imposed) gravity fields — ``gravity_type > 0`` (PyTorch).

Port of ``ramses_tpu/poisson/gravana.py``, which mirrors
``poisson/gravana.f90:5-95``: when an analytic model is selected, the
Poisson solve is bypassed entirely
(``poisson/multigrid_fine_commons.f90:46-48``) and the acceleration is a
fixed function of position:
  type 1: constant vector  ``gravity_params(1:ndim)``
  type 2: softened point mass — GM=params[0], softening=params[1],
          center=params[2:5]
  type 3: vertical galactic field (Kuijken & Gilmore 1989) —
          a1, a2, z0 = params[0:3] (already in code units)
The JAX package's ``gravana`` patch hook is not ported: the port refuses
``&RUN_PARAMS patch``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def cell_centers(shape: Sequence[int], dx: float, dtype=torch.float64,
                 device="cpu"):
    """Cell-center coordinates [ndim, *spatial] in user units [0, boxlen]."""
    coords = [(np.arange(n) + 0.5) * dx for n in shape]
    mesh = np.meshgrid(*coords, indexing="ij")
    return torch.as_tensor(np.stack(mesh), dtype=dtype, device=device)


def gravana(x, gravity_type: int, gravity_params: Sequence[float],
            boxlen: float):
    """Analytic acceleration at positions x [ndim, *spatial]."""
    nd = x.shape[0]
    gp = list(gravity_params) + [0.0] * 10
    if gravity_type == 1:
        return torch.stack([torch.full(x.shape[1:], gp[d], dtype=x.dtype,
                                       device=x.device) for d in range(nd)])
    if gravity_type == 2:
        gmass, emass = gp[0], gp[1]
        center = gp[2:2 + nd]
        rvec = [x[d] - center[d] for d in range(nd)]
        rr = torch.sqrt(sum(r * r for r in rvec) + emass * emass)
        return torch.stack([-gmass * r / rr ** 3 for r in rvec])
    if gravity_type == 3:
        a1, a2, z0 = gp[0], gp[1], gp[2]
        rz = x[nd - 1] - 0.5 * boxlen
        g = [torch.zeros_like(x[0]) for _ in range(nd)]
        g[nd - 1] = -a1 * rz / torch.sqrt(rz * rz + z0 * z0) - a2 * rz
        return torch.stack(g)
    raise ValueError(f"gravity_type={gravity_type}")
