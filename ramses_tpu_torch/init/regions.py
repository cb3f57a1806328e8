"""Region-based analytic initial conditions (numpy).

The port's own copy of ``ramses_tpu/init/regions.py``: ``region_condinit``
(``hydro/init_flow_fine.f90:475-596``) and the primitive→conservative
conversion of ``condinit`` (``hydro/condinit.f90:30-75``) as vectorized
numpy over the whole grid.  The ``condinit`` patch hook is not ported yet.

Region semantics (&INIT_PARAMS):
  * ``square``: p-norm box test with exponent ``exp_region`` (>=10 → max
    norm); REPLACES primitives inside.
  * ``point``: CIC cloud of one cell around the centre; ADDS d/P scaled by
    1/cell-volume and velocities weighted by the CIC kernel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ramses_tpu_torch.config import Params
from ramses_tpu_torch.hydro.core import HydroStatic


def cell_centers(shape: Sequence[int], dx: float, ndim: int):
    """Cell-centre coordinate arrays in user units [0, boxlen]."""
    axes = [(np.arange(n) + 0.5) * dx for n in shape]
    return np.meshgrid(*axes, indexing="ij")[:ndim]


def region_condinit(x: Sequence[np.ndarray], dx: float, p: Params,
                    cfg: HydroStatic) -> np.ndarray:
    """Primitive state [nvar, *shape] from &INIT_PARAMS regions."""
    init = p.init
    shape = x[0].shape
    q = np.zeros((cfg.nvar,) + shape, dtype=np.float64)
    q[0] = cfg.smallr
    q[cfg.ndim + 1] = cfg.smallr * cfg.smallc ** 2 / cfg.gamma

    centers = [init.x_center, init.y_center, init.z_center]
    lengths = [init.length_x, init.length_y, init.length_z]
    vels = [init.u_region, init.v_region, init.w_region]

    for k in range(init.nregion):
        rtype = str(init.region_type[k]).strip()
        if rtype == "square":
            en = float(init.exp_region[k])
            if en < 10.0:
                r = sum((2.0 * np.abs(x[d] - centers[d][k]) /
                         lengths[d][k]) ** en for d in range(cfg.ndim))
                r = r ** (1.0 / en)
            else:
                r = np.maximum.reduce(
                    [2.0 * np.abs(x[d] - centers[d][k]) / lengths[d][k]
                     for d in range(cfg.ndim)])
            inside = r < 1.0
            q[0][inside] = init.d_region[k]
            for d in range(cfg.ndim):
                q[1 + d][inside] = vels[d][k]
            q[cfg.ndim + 1][inside] = init.p_region[k]
        elif rtype == "point":
            vol = dx ** cfg.ndim
            w = np.ones(shape)
            for d in range(cfg.ndim):
                w = w * np.maximum(1.0 - np.abs(x[d] - centers[d][k]) / dx,
                                   0.0)
            q[0] += init.d_region[k] * w / vol
            for d in range(cfg.ndim):
                q[1 + d] += vels[d][k] * w
            q[cfg.ndim + 1] += init.p_region[k] * w / vol
        else:
            raise ValueError(f"unknown region_type {rtype!r}")
    return q


def prim_to_cons(q: np.ndarray, cfg: HydroStatic) -> np.ndarray:
    """``condinit``'s primitive→conservative conversion."""
    u = np.empty_like(q)
    u[0] = q[0]
    eken = np.zeros_like(q[0])
    for d in range(cfg.ndim):
        u[1 + d] = q[0] * q[1 + d]
        eken += 0.5 * q[0] * q[1 + d] ** 2
    u[cfg.ndim + 1] = eken + q[cfg.ndim + 1] / (cfg.gamma - 1.0)
    for n in range(cfg.nener):
        i = cfg.ndim + 2 + n
        u[i] = q[i] / (cfg.gamma_rad[n] - 1.0)
        u[cfg.ndim + 1] += u[i]
    for s in range(cfg.npassive):
        i = cfg.ndim + 2 + cfg.nener + s
        u[i] = q[0] * q[i]
    return u


def condinit(shape: Sequence[int], dx: float, p: Params,
             cfg: HydroStatic) -> np.ndarray:
    """Conservative initial state on a uniform grid of ``shape`` cells."""
    x = cell_centers(shape, dx, cfg.ndim)
    return prim_to_cons(region_condinit(x, dx, p, cfg), cfg)
