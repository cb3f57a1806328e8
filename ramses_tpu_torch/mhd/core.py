"""MHD state layout, conversions, wave speeds (PyTorch).

Port of ``ramses_tpu/mhd/core.py`` (reference ``mhd/init_hydro.f90:29``,
``mhd/hydro_parameters.f90``).  The staggered field is stored once:
``bf[d]`` holds B_d on the LOW face of each cell along axis d (the high
face is the neighbour's low face), so the divergence stencil is exact by
construction.  Velocity and B always carry 3 components whatever the
grid's dimensionality, as in the reference.

Cell state ``u``: [ρ, ρv_x, ρv_y, ρv_z, E, Bc_x, Bc_y, Bc_z, passives…]
Primitive ``q``:  [ρ, v_x, v_y, v_z, P, Bc_x, Bc_y, Bc_z, passives…]

Every function keeps the JAX package's arithmetic order (squares as
``x * x``, sums left to right), so the two agree to rounding in f64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ramses_tpu_torch.config import Params

IRHO, IVX, IVY, IVZ, IP, IBX, IBY, IBZ = 0, 1, 2, 3, 4, 5, 6, 7
NCOMP = 3  # velocity/field components (always 3, mhd convention)


@dataclass(frozen=True)
class MhdStatic:
    """Static solver configuration (hashable)."""
    ndim: int = 3               # grid dimensionality (1/2/3)
    npassive: int = 0
    gamma: float = 1.6666667
    smallr: float = 1e-10
    smallc: float = 1e-10
    slope_type: int = 1
    slope_theta: float = 1.5
    riemann: str = "hlld"
    riemann2d: str = "average"
    courant_factor: float = 0.8
    # arrays carry a trailing batch axis (the AMR oct-stencil path); read
    # by the slope bank (hydro.muscl._axis)
    trailing_batch: bool = False

    @property
    def nvar(self) -> int:
        return 8 + self.npassive

    @classmethod
    def from_params(cls, p: Params) -> "MhdStatic":
        h = p.hydro
        riemann = str(h.riemann)
        if riemann not in ("llf", "hll", "hlld", "roe", "upwind"):
            # refuse-or-implement: no silent physics substitution
            raise NotImplementedError(
                f"mhd riemann={riemann!r}: implemented solvers are "
                "llf|hll|hlld|roe|upwind "
                "(reference bank: hydro/read_hydro_params.f90:184-204)")
        r2d = str(h.riemann2d)
        if r2d not in ("llf", "roe", "upwind", "hll", "hlla", "hlld",
                       "average"):
            raise NotImplementedError(
                f"mhd riemann2d={r2d!r}: implemented corner solvers are "
                "llf|roe|upwind|hll|hlla|hlld|average "
                "(reference bank: hydro/read_hydro_params.f90:207-221)")
        return cls(ndim=p.ndim, npassive=p.npassive, gamma=float(h.gamma),
                   smallr=float(h.smallr), smallc=float(h.smallc),
                   slope_type=int(h.slope_type),
                   slope_theta=float(h.slope_theta),
                   riemann=riemann, riemann2d=r2d,
                   courant_factor=float(h.courant_factor))


def _sum(terms):
    """Left-to-right sum, the order of Python's ``sum`` in the JAX code."""
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def cell_center_b(bf: Sequence, ndim: int) -> list:
    """Cell-centred B from staggered faces: mean of low/high faces for
    staggered dims, identity for degenerate (cell-centred) components."""
    out = []
    for c in range(NCOMP):
        b = bf[c]
        if c < ndim:
            ax = b.dim() - ndim + c
            out.append(0.5 * (b + torch.roll(b, -1, dims=ax)))
        else:
            out.append(b)
    return out


def ctoprim(u, cfg: MhdStatic):
    """Conservative → primitive (``mhd/umuscl.f90`` ctoprim)."""
    r = torch.clamp(u[IRHO], min=cfg.smallr)
    inv_r = 1.0 / r
    v = [u[1 + c] * inv_r for c in range(NCOMP)]
    b = [u[IBX + c] for c in range(NCOMP)]
    eken = 0.5 * _sum([vc * vc for vc in v])
    emag = 0.5 * _sum([bc * bc for bc in b]) * inv_r
    eint = torch.clamp(u[IP] * inv_r - eken - emag,
                       min=cfg.smallc ** 2 / cfg.gamma / (cfg.gamma - 1.0))
    p = (cfg.gamma - 1.0) * r * eint
    comps = [r] + v + [p] + b
    for s in range(cfg.npassive):
        comps.append(u[8 + s] * inv_r)
    return torch.stack(comps)


def prim_to_cons(q, cfg: MhdStatic):
    r = torch.clamp(q[IRHO], min=cfg.smallr)
    v = [q[1 + c] for c in range(NCOMP)]
    b = [q[IBX + c] for c in range(NCOMP)]
    e = (q[IP] / (cfg.gamma - 1.0)
         + 0.5 * r * _sum([vc * vc for vc in v])
         + 0.5 * _sum([bc * bc for bc in b]))
    comps = [r] + [r * vc for vc in v] + [e] + b
    for s in range(cfg.npassive):
        comps.append(r * q[8 + s])
    return torch.stack(comps)


def fast_speed(q, d: int, cfg: MhdStatic):
    """Fast magnetosonic speed along component d
    (``mhd/courant_fine.f90`` / ``godunov_utils`` cmpdt)."""
    r = torch.clamp(q[IRHO], min=cfg.smallr)
    c2 = cfg.gamma * torch.clamp(q[IP], min=cfg.smallr * cfg.smallc ** 2) / r
    b2 = _sum([q[IBX + c] * q[IBX + c] for c in range(NCOMP)]) / r
    bd2 = q[IBX + d] * q[IBX + d] / r
    s = c2 + b2
    disc = torch.sqrt(torch.clamp(s * s - 4.0 * c2 * bd2, min=0.0))
    return torch.sqrt(torch.clamp(0.5 * (s + disc), min=cfg.smallc ** 2))


def flux_along(q, d: int, cfg: MhdStatic):
    """Ideal-MHD physical flux along component d from primitives.

    F(ρ)    = ρ v_d
    F(ρv_c) = ρ v_d v_c − B_d B_c + δ_cd (P + B²/2)
    F(E)    = (E + P + B²/2) v_d − B_d (v·B)
    F(B_c)  = v_d B_c − v_c B_d   (zero for c=d)
    """
    r = torch.clamp(q[IRHO], min=cfg.smallr)
    v = [q[1 + c] for c in range(NCOMP)]
    b = [q[IBX + c] for c in range(NCOMP)]
    p = q[IP]
    b2 = _sum([bc * bc for bc in b])
    ptot = p + 0.5 * b2
    vdotb = _sum([vc * bc for vc, bc in zip(v, b)])
    e = (p / (cfg.gamma - 1.0) + 0.5 * r * _sum([vc * vc for vc in v])
         + 0.5 * b2)
    vd = v[d]
    comps = [r * vd]
    for c in range(NCOMP):
        f = r * vd * v[c] - b[d] * b[c]
        if c == d:
            f = f + ptot
        comps.append(f)
    comps.append((e + ptot) * vd - b[d] * vdotb)
    for c in range(NCOMP):
        if c == d:
            comps.append(torch.zeros_like(vd))
        else:
            comps.append(vd * b[c] - v[c] * b[d])
    for s in range(cfg.npassive):
        comps.append(comps[0] * q[8 + s])
    return torch.stack(comps)


def div_b(bf: Sequence, dx: Sequence[float], ndim: int):
    """Exact staggered divergence (machine-zero under CT)."""
    out = None
    for d in range(ndim):
        ax = bf[d].dim() - ndim + d
        t = (torch.roll(bf[d], -1, dims=ax) - bf[d]) / dx[d]
        out = t if out is None else out + t
    return out
