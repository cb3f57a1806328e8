"""Physical boundary conditions as ghost-cell padding (PyTorch).

Port of ``ramses_tpu/grid/boundary.py``.  Integer codes from
&BOUNDARY_PARAMS (``amr/amr_parameters.f90:313-330``): 0 periodic,
1 reflecting, 2 outflow (zero-gradient), 3 imposed inflow.  Each
(dimension, side) gets a :class:`FaceBC`, and :func:`pad` materializes
the ghost zones by slicing/flipping/broadcasting, dim by dim so corner
ghosts compose.  The ``boundana`` patch hook is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from ramses_tpu_torch.config import Params
from ramses_tpu_torch.hydro.core import HydroStatic

PERIODIC, REFLECTING, OUTFLOW, INFLOW = 0, 1, 2, 3


@dataclass(frozen=True)
class FaceBC:
    kind: int = PERIODIC
    # imposed primitive values for INFLOW: (d, vel..., P)
    values: Tuple[float, ...] = ()


@dataclass(frozen=True)
class BoundarySpec:
    """Per-(dim, side) boundary kinds; faces[d] = (low, high)."""
    faces: Tuple[Tuple[FaceBC, FaceBC], ...]

    @classmethod
    def periodic(cls, ndim: int) -> "BoundarySpec":
        f = FaceBC()
        return cls(faces=tuple((f, f) for _ in range(ndim)))

    @classmethod
    def from_params(cls, p: Params) -> "BoundarySpec":
        b = p.boundary
        faces: List[List[FaceBC]] = [[FaceBC(), FaceBC()]
                                     for _ in range(p.ndim)]
        mins = [b.ibound_min, b.jbound_min, b.kbound_min]
        maxs = [b.ibound_max, b.jbound_max, b.kbound_max]
        for k in range(b.nboundary):
            btype = int(b.bound_type[k])
            # reference codes: 1 reflecting, 2 outflow, 3 inflow;
            # also direction-specific 1x/2x codes collapse the same way
            kind = {1: REFLECTING, 2: OUTFLOW, 3: INFLOW}.get(btype % 10,
                                                              OUTFLOW)
            vals = (float(b.d_bound[k]),
                    *[float(v) for v in
                      (b.u_bound[k], b.v_bound[k], b.w_bound[k])[:p.ndim]],
                    float(b.p_bound[k]))
            for d in range(p.ndim):
                lo, hi = int(mins[d][k]), int(maxs[d][k])
                if lo == hi == -1:
                    faces[d][0] = FaceBC(kind, vals if kind == INFLOW else ())
                elif lo == hi == +1:
                    faces[d][1] = FaceBC(kind, vals if kind == INFLOW else ())
        return cls(faces=tuple(tuple(fs) for fs in faces))

    @property
    def kinds(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((lo.kind, hi.kind) for lo, hi in self.faces)


def _inflow_state(bc: FaceBC, cfg: HydroStatic, like: torch.Tensor):
    """Imposed conservative state vector from primitive boundary values
    (computed in f64 on the host, then cast like the JAX package)."""
    vals = bc.values
    r = max(vals[0], cfg.smallr)
    vels = list(vals[1:1 + cfg.ndim])
    p = vals[1 + cfg.ndim]
    u = [r] + [r * v for v in vels]
    u.append(p / (cfg.gamma - 1.0) + 0.5 * r * sum(v * v for v in vels))
    u += [0.0] * (cfg.nener + cfg.npassive)
    return torch.tensor(u, dtype=torch.float64).to(like.device, like.dtype)


def pad(u: torch.Tensor, spec: BoundarySpec, cfg: HydroStatic,
        ng: int = 2) -> torch.Tensor:
    """Pad an active [nvar, *spatial] grid with ``ng`` ghost cells/side."""
    for d in range(cfg.ndim):
        ax = u.dim() - cfg.ndim + d
        lo_bc, hi_bc = spec.faces[d]
        n = u.shape[ax]

        def ghost(bc: FaceBC, side: int):
            if bc.kind == PERIODIC:
                return (u.narrow(ax, n - ng, ng) if side == 0
                        else u.narrow(ax, 0, ng))
            if bc.kind == REFLECTING:
                g = (u.narrow(ax, 0, ng) if side == 0
                     else u.narrow(ax, n - ng, ng))
                g = torch.flip(g, dims=(ax,))
                # negate normal momentum
                sign = torch.ones(cfg.nvar, dtype=u.dtype, device=u.device)
                sign[1 + d] = -1.0
                shape = [1] * u.dim()
                shape[0] = cfg.nvar
                return g * sign.reshape(shape)
            if bc.kind == OUTFLOW:
                edge = (u.narrow(ax, 0, 1) if side == 0
                        else u.narrow(ax, n - 1, 1))
                reps = [1] * u.dim()
                reps[ax] = ng
                return edge.repeat(reps)
            # INFLOW
            tshape = list(u.shape)
            tshape[ax] = ng
            state = _inflow_state(bc, cfg, u)
            shape = [1] * u.dim()
            shape[0] = cfg.nvar
            return state.reshape(shape).expand(tshape)

        u = torch.cat([ghost(lo_bc, 0), u, ghost(hi_bc, 1)], dim=ax)
    return u


def unpad(u: torch.Tensor, ndim: int, ng: int = 2) -> torch.Tensor:
    idx = [slice(None)] * u.dim()
    for d in range(ndim):
        idx[u.dim() - ndim + d] = slice(ng, u.shape[u.dim() - ndim + d] - ng)
    return u[tuple(idx)]
