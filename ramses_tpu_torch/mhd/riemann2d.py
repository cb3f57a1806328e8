"""2D corner Riemann solvers for the CT edge EMF (PyTorch).

Port of ``ramses_tpu/mhd/riemann2d.py``, the counterpart of the
reference's ``cmp_mag_flx`` (``mhd/umuscl.f90:1453-2024``; namelist
``riemann2d`` = llf|roe|upwind|hll|hlla|hlld,
``hydro/read_hydro_params.f90:207-221``).  The edge EMF comes from the
FOUR states around each cell edge instead of the Gardiner-Stone
arithmetic average.

States are labelled (x, y) with x in {L,R} the side along d1 and y in
{B,T} the side along d2.  A = B_d1 on the two d1-faces (varies with y
only), B = B_d2 on the two d2-faces (varies with x only).

* ``hll`` / ``hlla`` — the four-state 2D-HLL average of Londrillo & Del
  Zanna (2004) with fast-magnetosonic / Alfven signal speeds.
* ``llf`` / ``roe`` / ``upwind`` — quarter-average of the four corner
  EMFs plus the DISSIPATIVE part of two orthogonal 1D solves on
  side-averaged states (``mhd/umuscl.f90:1978``).
* ``hlld`` — the four-state HLLD with a contact (ustar, vstar), star
  states per quadrant, and Alfven-bounded inner waves.

Everything uses the reference EMF convention eps = u*B - v*A (u = v_d1,
v = v_d2); the caller converts with ``e_edge = -sig * eps``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ramses_tpu_torch.mhd import roe as roemod
from ramses_tpu_torch.mhd.core import MhdStatic, _sum
from ramses_tpu_torch.mhd.riemann import _fast

_EPS = 1e-30

# quadrant keys
QUADS = (("L", "B"), ("R", "B"), ("L", "T"), ("R", "T"))


def _alfven(r, bn, smallc):
    return torch.sqrt(torch.clamp(bn * bn / r, min=smallc ** 2))


def corner_emf(states: Dict[Tuple[str, str], Tuple], A_T, A_B, B_R, B_L,
               cfg: MhdStatic):
    """eps at each edge from the four surrounding corner states.

    ``states[(x, y)]`` = (r, p, u, v, w, c): density, pressure, the two
    in-plane velocities (u along d1, v along d2), the orthogonal
    velocity and the orthogonal cell field at the corner.  A_T/A_B:
    staggered B_d1 on the d2-above/below faces; B_R/B_L: staggered B_d2
    on the d1-right/left faces.  Returns eps = u*B - v*A upwinded per
    ``cfg.riemann2d``; the caller applies the orientation sign.
    """
    g = cfg.gamma
    sc = cfg.smallc
    rs = {k: torch.clamp(s[0], min=cfg.smallr) for k, s in states.items()}
    ps = {k: torch.clamp(s[1], min=cfg.smallr * sc ** 2)
          for k, s in states.items()}
    us = {k: s[2] for k, s in states.items()}
    vs = {k: s[3] for k, s in states.items()}
    ws = {k: s[4] for k, s in states.items()}
    cs = {k: s[5] for k, s in states.items()}
    A_of = {"B": A_B, "T": A_T}
    B_of = {"L": B_L, "R": B_R}
    eps = {k: us[k] * B_of[k[0]] - vs[k] * A_of[k[1]] for k in QUADS}

    kind = cfg.riemann2d
    if kind in ("hll", "hlla"):
        if kind == "hll":
            cx = {k: _fast(rs[k], ps[k], A_of[k[1]], B_of[k[0]], cs[k],
                           g, sc) for k in QUADS}
            cy = {k: _fast(rs[k], ps[k], B_of[k[0]], A_of[k[1]], cs[k],
                           g, sc) for k in QUADS}
        else:
            cx = {k: _alfven(rs[k], A_of[k[1]], sc) for k in QUADS}
            cy = {k: _alfven(rs[k], B_of[k[0]], sc) for k in QUADS}

        def mm(d):
            vals = list(d.values())
            lo = vals[0]
            hi = vals[0]
            for v in vals[1:]:
                lo = torch.minimum(lo, v)
                hi = torch.maximum(hi, v)
            return lo, hi

        umin, umax = mm(us)
        vmin, vmax = mm(vs)
        _, cxmax = mm(cx)
        _, cymax = mm(cy)
        SL = torch.clamp(umin - cxmax, max=0.0)
        SR = torch.clamp(umax + cxmax, min=0.0)
        SB = torch.clamp(vmin - cymax, max=0.0)
        ST = torch.clamp(vmax + cymax, min=0.0)
        dx_ = SR - SL + _EPS
        dy_ = ST - SB + _EPS
        # Londrillo & Del Zanna (2004) four-state 2D-HLL average
        return ((SL * SB * eps[("R", "T")] - SL * ST * eps[("R", "B")]
                 - SR * SB * eps[("L", "T")] + SR * ST * eps[("L", "B")])
                / (dx_ * dy_)
                - ST * SB / dy_ * (A_T - A_B)
                + SR * SL / dx_ * (B_R - B_L))

    if kind in ("llf", "roe", "upwind"):
        ebar = 0.25 * _sum(list(eps.values()))

        def avg(d, idx, side):
            ks = [k for k in QUADS if k[idx] == side]
            return 0.5 * (d[ks[0]] + d[ks[1]])

        # x-solve: rotated layout [rho, vn=u, vt1=v, vt2=w, P, Bn, Bt1=B,
        # Bt2=C] on y-averaged side states
        def pack_x(side):
            return torch.stack([avg(rs, 0, side), avg(us, 0, side),
                                avg(vs, 0, side), avg(ws, 0, side),
                                avg(ps, 0, side), torch.zeros_like(A_T),
                                B_of[side], avg(cs, 0, side)])

        def pack_y(side):
            return torch.stack([avg(rs, 1, side), avg(vs, 1, side),
                                avg(us, 1, side), avg(ws, 1, side),
                                avg(ps, 1, side), torch.zeros_like(A_T),
                                A_of[side], avg(cs, 1, side)])

        bn_x = 0.5 * (A_T + A_B)
        bn_y = 0.5 * (B_R + B_L)
        diss = {"llf": roemod.llf_dissipation,
                "roe": roemod.roe_dissipation,
                "upwind": roemod.upwind_dissipation}[kind]
        dx5 = diss(pack_x("L"), pack_x("R"), bn_x, cfg)[5]
        dy5 = diss(pack_y("B"), pack_y("T"), bn_y, cfg)[5]
        return ebar - dx5 + dy5

    if kind == "hlld":
        return _hlld2d(rs, ps, us, vs, cs, eps, A_of, B_of, cfg)

    raise NotImplementedError(f"riemann2d={kind!r}")


def _hlld2d(rs, ps, us, vs, cs, eps, A_of, B_of, cfg: MhdStatic):
    """Four-state HLLD corner EMF (contact + Alfven-bounded fan)."""
    g = cfg.gamma
    sc = cfg.smallc
    LB, RB, LT, RT = (("L", "B"), ("R", "B"), ("L", "T"), ("R", "T"))
    quads = (LB, RB, LT, RT)

    cx = {k: _fast(rs[k], ps[k], A_of[k[1]], B_of[k[0]], cs[k], g, sc)
          for k in quads}
    cy = {k: _fast(rs[k], ps[k], B_of[k[0]], A_of[k[1]], cs[k], g, sc)
          for k in quads}

    def extr(d, f):
        vals = list(d.values())
        out = vals[0]
        for v in vals[1:]:
            out = f(out, v)
        return out

    cxm = extr(cx, torch.maximum)
    cym = extr(cy, torch.maximum)
    SL = extr(us, torch.minimum) - cxm
    SR = extr(us, torch.maximum) + cxm
    SB = extr(vs, torch.minimum) - cym
    ST = extr(vs, torch.maximum) + cym

    ptot = {k: ps[k] + 0.5 * (A_of[k[1]] * A_of[k[1]]
                              + B_of[k[0]] * B_of[k[0]] + cs[k] * cs[k])
            for k in quads}
    # mass-weighted contact speeds (the reference's ustar/vstar)
    rcx = {k: rs[k] * ((us[k] - SL) if k[0] == "L" else (SR - us[k]))
           for k in quads}
    rcy = {k: rs[k] * ((vs[k] - SB) if k[1] == "B" else (ST - vs[k]))
           for k in quads}
    ustar = ((_sum([rcx[k] * us[k] for k in quads])
              + (ptot[LB] - ptot[RB] + ptot[LT] - ptot[RT]))
             / (_sum(list(rcx.values())) + _EPS))
    vstar = ((_sum([rcy[k] * vs[k] for k in quads])
              + (ptot[LB] - ptot[LT] + ptot[RB] - ptot[RT]))
             / (_sum(list(rcy.values())) + _EPS))

    def pm_eps(cond, like):
        return torch.where(cond, torch.full_like(like, _EPS),
                           torch.full_like(like, -_EPS))

    Sx = {"L": SL, "R": SR}
    Sy = {"B": SB, "T": ST}
    rstar_x, rstar_y, rstar = {}, {}, {}
    Astar, Bstar = {}, {}
    Ex_star, Ey_star, E_star = {}, {}, {}
    for k in quads:
        fx = (Sx[k[0]] - us[k]) / (Sx[k[0]] - ustar
                                   + pm_eps(Sx[k[0]] >= ustar, ustar))
        fy = (Sy[k[1]] - vs[k]) / (Sy[k[1]] - vstar
                                   + pm_eps(Sy[k[1]] >= vstar, vstar))
        rstar_x[k] = rs[k] * fx
        rstar_y[k] = rs[k] * fy
        rstar[k] = rs[k] * fx * fy
        Bstar[k] = B_of[k[0]] * fx
        Astar[k] = A_of[k[1]] * fy
        Ex_star[k] = ustar * Bstar[k] - vs[k] * A_of[k[1]]
        Ey_star[k] = us[k] * B_of[k[0]] - vstar * Astar[k]
        E_star[k] = ustar * Bstar[k] - vstar * Astar[k]

    def ca_side(keys, field, fstar, rsx):
        out = torch.full_like(SL, sc)
        for k in keys:
            out = torch.maximum(out, torch.abs(field[k[1] if field is A_of
                                                     else k[0]])
                                / torch.sqrt(torch.clamp(rsx[k],
                                                         min=cfg.smallr)))
            out = torch.maximum(out, torch.abs(fstar[k])
                                / torch.sqrt(torch.clamp(rstar[k],
                                                         min=cfg.smallr)))
        return out

    caL = ca_side((LB, LT), A_of, Astar, rstar_x)
    caR = ca_side((RB, RT), A_of, Astar, rstar_x)
    caB = ca_side((LB, RB), B_of, Bstar, rstar_y)
    caT = ca_side((LT, RT), B_of, Bstar, rstar_y)
    SAL = torch.clamp(ustar - caL, max=0.0)
    SAR = torch.clamp(ustar + caR, min=0.0)
    SAB = torch.clamp(vstar - caB, max=0.0)
    SAT = torch.clamp(vstar + caT, min=0.0)
    dax = SAR - SAL + _EPS
    day = SAT - SAB + _EPS
    AstarT = (SAR * Astar[RT] - SAL * Astar[LT]) / dax
    AstarB = (SAR * Astar[RB] - SAL * Astar[LB]) / dax
    BstarR = (SAT * Bstar[RT] - SAB * Bstar[RB]) / day
    BstarL = (SAT * Bstar[LT] - SAB * Bstar[LB]) / day

    # supersonic rows/columns
    e_b = torch.where(SL > 0.0, eps[LB],
                      torch.where(SR < 0.0, eps[RB],
                                  (SAR * Ex_star[LB] - SAL * Ex_star[RB]
                                   + SAR * SAL * (B_of["R"] - B_of["L"]))
                                  / dax))
    e_t = torch.where(SL > 0.0, eps[LT],
                      torch.where(SR < 0.0, eps[RT],
                                  (SAR * Ex_star[LT] - SAL * Ex_star[RT]
                                   + SAR * SAL * (B_of["R"] - B_of["L"]))
                                  / dax))
    e_l = (SAT * Ey_star[LB] - SAB * Ey_star[LT]
           - SAT * SAB * (A_of["T"] - A_of["B"])) / day
    e_r = (SAT * Ey_star[RB] - SAB * Ey_star[RT]
           - SAT * SAB * (A_of["T"] - A_of["B"])) / day
    e_c = ((SAL * SAB * E_star[RT] - SAL * SAT * E_star[RB]
            - SAR * SAB * E_star[LT] + SAR * SAT * E_star[LB])
           / (dax * day)
           - SAT * SAB / day * (AstarT - AstarB)
           + SAR * SAL / dax * (BstarR - BstarL))
    return torch.where(SB > 0.0, e_b,
                       torch.where(ST < 0.0, e_t,
                                   torch.where(SL > 0.0, e_l,
                                               torch.where(SR < 0.0, e_r,
                                                           e_c))))
