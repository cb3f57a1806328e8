"""Approximate Riemann solvers (elementwise PyTorch).

Port of ``ramses_tpu/hydro/riemann.py``: ``riemann_llf``
(``hydro/godunov_utils.f90:660``), ``riemann_hll`` (``:825``) and
``riemann_hllc`` (``:988``).  Every branch is computed and selected with
``torch.where``, in the JAX package's arithmetic order.  The two-shock
``riemann_approx`` and the ``acoustic`` solver are not ported yet.

Interface component layout (axis 0), for both inputs and the flux:
    0: rho | 1: normal velocity | 2: pressure | 3..1+ndim: tangential
    velocities | then nener non-thermal pressures | then passive scalars.
Flux output has one extra trailing component: the internal-energy flux
(used by the dual-energy ``pressure_fix``, ``hydro/godunov_fine.f90`` tmp).
Flux layout: 0 mass, 1 normal momentum, 2 total energy, 3.. tangential
momenta / non-thermal energy fluxes / passive fluxes, [-1] internal energy.
"""

from __future__ import annotations

import torch

from ramses_tpu_torch.hydro.core import HydroStatic


def _prims(q, cfg: HydroStatic):
    """Floor density/pressure exactly as the reference does."""
    r = torch.clamp(q[0], min=cfg.smallr)
    u = q[1]
    p = torch.maximum(q[2], r * cfg.smallp)
    return r, u, p


def _etot(q, r, u, p, cfg: HydroStatic):
    """Total energy density from interface-layout primitives."""
    entho = 1.0 / (cfg.gamma - 1.0)
    e = p * entho + 0.5 * r * u * u
    for t in range(cfg.ndim - 1):
        e = e + 0.5 * r * q[3 + t] ** 2
    for n in range(cfg.nener):
        e = e + q[2 + cfg.ndim + n] / (cfg.gamma_rad[n] - 1.0)
    return e


def _ptot(q, p, cfg: HydroStatic):
    for n in range(cfg.nener):
        p = p + q[2 + cfg.ndim + n]
    return p


def _cspeed2(q, r, p, cfg: HydroStatic):
    """gamma*P (+ sum gamma_rad*Prad) / rho — squared signal speed."""
    c2 = cfg.gamma * p
    for n in range(cfg.nener):
        c2 = c2 + cfg.gamma_rad[n] * q[2 + cfg.ndim + n]
    return torch.clamp(c2 / r, min=cfg.smallc ** 2)


def _cons_and_flux(q, cfg: HydroStatic):
    """Conservative state + physical flux in interface layout (+eint slot).

    Mirrors riemann_llf's uleft/fleft construction
    (``hydro/godunov_utils.f90:718-810``).
    """
    entho = 1.0 / (cfg.gamma - 1.0)
    r, u, p = _prims(q, cfg)
    et = _etot(q, r, u, p, cfg)
    ucons = [r, r * u, et]
    for t in range(cfg.ndim - 1):
        ucons.append(r * q[3 + t])
    for n in range(cfg.nener):
        ucons.append(q[2 + cfg.ndim + n] / (cfg.gamma_rad[n] - 1.0))
    for s in range(cfg.npassive):
        ucons.append(r * q[2 + cfg.ndim + cfg.nener + s])
    ucons.append(p * entho)  # internal energy slot

    ptot = _ptot(q, p, cfg)
    fl = [r * u, r * u * u + ptot, u * (et + ptot)]
    for t in range(cfg.ndim - 1):
        fl.append(u * r * q[3 + t])
    for n in range(cfg.nener):
        fl.append(u * q[2 + cfg.ndim + n] / (cfg.gamma_rad[n] - 1.0))
    for s in range(cfg.npassive):
        fl.append(u * r * q[2 + cfg.ndim + cfg.nener + s])
    fl.append(u * p * entho)
    return torch.stack(ucons), torch.stack(fl)


def riemann_llf(ql, qr, cfg: HydroStatic):
    """Local Lax-Friedrichs (``riemann_llf``, godunov_utils.f90:660)."""
    rl, ul, pl = _prims(ql, cfg)
    rr, ur, pr = _prims(qr, cfg)
    cl = torch.sqrt(_cspeed2(ql, rl, pl, cfg))
    cr = torch.sqrt(_cspeed2(qr, rr, pr, cfg))
    cmax = torch.maximum(torch.abs(ul) + cl, torch.abs(ur) + cr)
    uleft, fleft = _cons_and_flux(ql, cfg)
    uright, fright = _cons_and_flux(qr, cfg)
    return 0.5 * (fleft + fright - cmax[None] * (uright - uleft))


def riemann_hll(ql, qr, cfg: HydroStatic):
    """HLL (``riemann_hll``, godunov_utils.f90:825)."""
    rl, ul, pl = _prims(ql, cfg)
    rr, ur, pr = _prims(qr, cfg)
    cl = torch.sqrt(_cspeed2(ql, rl, pl, cfg))
    cr = torch.sqrt(_cspeed2(qr, rr, pr, cfg))
    sl = torch.clamp(torch.minimum(ul, ur) - torch.maximum(cl, cr), max=0.0)
    sr = torch.clamp(torch.maximum(ul, ur) + torch.maximum(cl, cr), min=0.0)
    uleft, fleft = _cons_and_flux(ql, cfg)
    uright, fright = _cons_and_flux(qr, cfg)
    return (sr * fleft - sl * fright + sr * sl * (uright - uleft)) / (sr - sl)


def riemann_hllc(ql, qr, cfg: HydroStatic):
    """HLLC with Toro sampling (``riemann_hllc``, godunov_utils.f90:988)."""
    entho = 1.0 / (cfg.gamma - 1.0)
    rl, ul, pl = _prims(ql, cfg)
    rr, ur, pr = _prims(qr, cfg)
    el = pl * entho
    er = pr * entho
    etotl = _etot(ql, rl, ul, pl, cfg)
    etotr = _etot(qr, rr, ur, pr, cfg)
    ptotl = _ptot(ql, pl, cfg)
    ptotr = _ptot(qr, pr, cfg)
    cfastl = torch.sqrt(_cspeed2(ql, rl, pl, cfg))
    cfastr = torch.sqrt(_cspeed2(qr, rr, pr, cfg))

    SL = torch.minimum(ul, ur) - torch.maximum(cfastl, cfastr)
    SR = torch.maximum(ul, ur) + torch.maximum(cfastl, cfastr)
    rcl = rl * (ul - SL)
    rcr = rr * (SR - ur)
    ustar = (rcr * ur + rcl * ul + (ptotl - ptotr)) / (rcr + rcl)
    ptotstar = (rcr * ptotl + rcl * ptotr + rcl * rcr * (ul - ur)) / (rcr + rcl)

    # Star-state denominators, replaced by a finite dummy wherever the
    # branch is provably not consumed (an exactly degenerate wave would
    # otherwise put an inf into the untaken branch); consumed values keep
    # the original denominator bit for bit.
    dSL = SL - ustar
    dSL = torch.where(dSL < 0.0, dSL, -1.0)
    dSR = SR - ustar
    dSR = torch.where(dSR > 0.0, dSR, 1.0)
    rstarl = rl * (SL - ul) / dSL
    etotstarl = ((SL - ul) * etotl - ptotl * ul + ptotstar * ustar) / dSL
    estarl = el * (SL - ul) / dSL
    rstarr = rr * (SR - ur) / dSR
    etotstarr = ((SR - ur) * etotr - ptotr * ur + ptotstar * ustar) / dSR
    estarr = er * (SR - ur) / dSR

    # sample at x/t = 0: SL>0 → L | ustar>0 → *L | SR>0 → *R | else R
    def sel(a_l, a_sl, a_sr, a_r):
        return torch.where(SL > 0.0, a_l,
               torch.where(ustar > 0.0, a_sl,
               torch.where(SR > 0.0, a_sr, a_r)))

    ro = sel(rl, rstarl, rstarr, rr)
    uo = sel(ul, ustar, ustar, ur)
    ptoto = sel(ptotl, ptotstar, ptotstar, ptotr)
    etoto = sel(etotl, etotstarl, etotstarr, etotr)
    eo = sel(el, estarl, estarr, er)

    upwind_left = ustar > 0.0
    flux = [ro * uo, ro * uo * uo + ptoto, (etoto + ptoto) * uo]
    for t in range(cfg.ndim - 1):
        flux.append(ro * uo * torch.where(upwind_left, ql[3 + t], qr[3 + t]))
    for n in range(cfg.nener):
        eradl = ql[2 + cfg.ndim + n] / (cfg.gamma_rad[n] - 1.0)
        eradr = qr[2 + cfg.ndim + n] / (cfg.gamma_rad[n] - 1.0)
        erado = sel(eradl, eradl * (SL - ul) / dSL,
                    eradr * (SR - ur) / dSR, eradr)
        flux.append(uo * erado)
    for s in range(cfg.npassive):
        i = 2 + cfg.ndim + cfg.nener + s
        flux.append(ro * uo * torch.where(upwind_left, ql[i], qr[i]))
    flux.append(uo * eo)
    return torch.stack(flux)


def riemann_approx(ql, qr, cfg: HydroStatic):
    """Two-shock iterative solver (``riemann_approx``): not ported yet."""
    raise NotImplementedError(
        "riemann='exact' (riemann_approx) is not ported to ramses_tpu_torch")


def riemann_acoustic(ql, qr, cfg: HydroStatic):
    """Linearized solver (``riemann_acoustic``): not ported yet."""
    raise NotImplementedError(
        "riemann='acoustic' is not ported to ramses_tpu_torch")


SOLVERS = {
    "llf": riemann_llf,
    "hll": riemann_hll,
    "hllc": riemann_hllc,
    "exact": riemann_approx,
    "acoustic": riemann_acoustic,
}


def solve(ql, qr, cfg: HydroStatic):
    """Dispatch by name (``hydro/umuscl.f90:791-804``)."""
    try:
        return SOLVERS[cfg.riemann](ql, qr, cfg)
    except KeyError:
        raise ValueError(f"unknown Riemann solver {cfg.riemann!r}") from None
