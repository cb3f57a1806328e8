"""Approximate Riemann solvers (elementwise PyTorch).

Port of ``ramses_tpu/hydro/riemann.py``: ``riemann_llf``
(``hydro/godunov_utils.f90:660``), ``riemann_hll`` (``:825``),
``riemann_hllc`` (``:988``), the two-shock iterative ``riemann_approx``
(``riemann='exact'``, ``:268``) and the linearized ``riemann_acoustic``
(``:500``).  Every branch is computed and selected with ``torch.where``,
in the JAX package's arithmetic order (its guards of untaken branches
included, so no inf or NaN enters a selected value).

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
    """Two-shock iterative solver (``riemann_approx``, godunov_utils.f90:268).

    Newton-Raphson on p* for ``niter_riemann`` fixed iterations (the
    reference compresses converged lanes out; iterating them further is a
    no-op to machine precision and is branch-free here).
    """
    entho = 1.0 / (cfg.gamma - 1.0)
    gamma6 = (cfg.gamma + 1.0) / (2.0 * cfg.gamma)
    rl, ul, pl = _prims(ql, cfg)
    rr, ur, pr = _prims(qr, cfg)
    cl = cfg.gamma * pl * rl  # Lagrangian sound speed^2
    cr = cfg.gamma * pr * rr
    wl = torch.sqrt(cl)
    wr = torch.sqrt(cr)
    pstar = torch.clamp(
        ((wr * pl + wl * pr) + wl * wr * (ul - ur)) / (wl + wr), min=0.0)
    for _ in range(cfg.niter_riemann):
        wwl = torch.sqrt(cl * (1.0 + gamma6 * (pstar - pl) / pl))
        wwr = torch.sqrt(cr * (1.0 + gamma6 * (pstar - pr) / pr))
        qL = 2.0 * wwl ** 3 / (wwl ** 2 + cl)
        qR = 2.0 * wwr ** 3 / (wwr ** 2 + cr)
        usl = ul - (pstar - pl) / wwl
        usr = ur + (pstar - pr) / wwr
        delp = torch.maximum(qR * qL / (qR + qL) * (usl - usr), -pstar)
        pstar = pstar + delp

    wl = torch.sqrt(cl * (1.0 + gamma6 * (pstar - pl) / pl))
    wr = torch.sqrt(cr * (1.0 + gamma6 * (pstar - pr) / pr))
    ustar = 0.5 * (ul + (pl - pstar) / wl + ur - (pr - pstar) / wr)

    left = ustar >= 0.0   # sgnm == +1
    ro = torch.where(left, rl, rr)
    uo = torch.where(left, ul, ur)
    po = torch.where(left, pl, pr)
    wo = torch.where(left, wl, wr)
    sgnm = torch.where(left, 1.0, -1.0)
    co = torch.clamp(torch.sqrt(torch.abs(cfg.gamma * po / ro)),
                     min=cfg.smallc)

    shock = pstar >= po
    # rarefaction density: the power only where its input is positive
    ps_rare = torch.where(shock, po, pstar)
    ps_pos = ps_rare > 0.0
    ps_safe = torch.where(ps_pos, ps_rare, po)
    rstar_shock = ro / (1.0 + ro * (po - pstar) / wo ** 2)
    rstar_rare = ro * torch.where(
        ps_pos, torch.abs(ps_safe / po) ** (1.0 / cfg.gamma), 0.0)
    rstar = torch.where(shock, rstar_shock, rstar_rare)
    rstar = torch.clamp(rstar, min=cfg.smallr)
    cs2 = cfg.gamma * pstar / rstar
    cs2_pos = cs2 > 0.0
    cstar = torch.clamp(
        torch.where(cs2_pos, torch.sqrt(torch.where(cs2_pos, cs2, 1.0)),
                    0.0), min=cfg.smallc)
    wo_ro = wo / ro
    spout = torch.where(shock, wo_ro - sgnm * uo, co - sgnm * uo)
    spin = torch.where(shock, wo_ro - sgnm * uo, cstar - sgnm * ustar)
    # rarefaction fan: the fraction only inside the fan
    fan = (spout > 0.0) & (spin < 0.0)
    fan_den = torch.where(fan, spout - spin + 1e-300, 1.0)
    frac = torch.where(fan, spout / fan_den, 0.0)
    ufan = frac * ustar + (1.0 - frac) * uo
    pfan = frac * pstar + (1.0 - frac) * po

    qg_u = torch.where(spout <= 0.0, uo,
                       torch.where(spin >= 0.0, ustar, ufan))
    qg_p = torch.where(spout <= 0.0, po,
                       torch.where(spin >= 0.0, pstar, pfan))
    qg_pfan = torch.where(fan, qg_p, po)
    fan_r = ro * torch.abs(qg_pfan / po) ** (1.0 / cfg.gamma)
    qg_r = torch.where(spout <= 0.0, ro,
                       torch.where(spin >= 0.0, rstar, fan_r))

    fmass = qg_r * qg_u
    fmom = qg_p + qg_r * qg_u ** 2
    etot = qg_p * entho + 0.5 * qg_r * qg_u ** 2
    passive_vals = []
    for t in range(cfg.ndim - 1):
        v = torch.where(left, ql[3 + t], qr[3 + t])
        etot = etot + 0.5 * qg_r * v ** 2
        passive_vals.append(v)
    fener = qg_u * (etot + qg_p)
    flux = [fmass, fmom, fener]
    for v in passive_vals:
        flux.append(fmass * v)
    for n in range(cfg.nener):
        i = 2 + cfg.ndim + n
        flux.append(fmass * torch.where(left, ql[i], qr[i]))
    for s in range(cfg.npassive):
        i = 2 + cfg.ndim + cfg.nener + s
        flux.append(fmass * torch.where(left, ql[i], qr[i]))
    flux.append(fmass * (qg_p / qg_r * entho))
    return torch.stack(flux)


def riemann_acoustic(ql, qr, cfg: HydroStatic):
    """Linearized (acoustic) solver (``riemann_acoustic``,
    godunov_utils.f90:500): one-shot Lagrangian p*/u* then sampling."""
    entho = 1.0 / (cfg.gamma - 1.0)
    rl, ul, pl = _prims(ql, cfg)
    rr, ur, pr = _prims(qr, cfg)
    cl = torch.sqrt(_cspeed2(ql, rl, pl, cfg))
    cr = torch.sqrt(_cspeed2(qr, rr, pr, cfg))
    wl = cl * rl
    wr = cr * rr
    pstar = ((wr * pl + wl * pr) + wl * wr * (ul - ur)) / (wl + wr)
    ustar = ((wr * ur + wl * ul) + (pl - pr)) / (wl + wr)

    left = ustar > 0.0
    ro = torch.where(left, rl, rr)
    uo = torch.where(left, ul, ur)
    po = torch.where(left, pl, pr)
    co = torch.clamp(torch.sqrt(torch.abs(cfg.gamma * po / ro)),
                     min=cfg.smallc)
    sgnm = torch.where(left, 1.0, -1.0)
    rstar = torch.clamp(ro + (pstar - po) / co ** 2, min=cfg.smallr)
    acs2 = torch.abs(cfg.gamma * pstar / rstar)
    acs2_pos = acs2 > 0.0
    cstar = torch.clamp(torch.where(
        acs2_pos, torch.sqrt(torch.where(acs2_pos, acs2, 1.0)), 0.0),
        min=cfg.smallc)
    spout = co - sgnm * uo
    spin = cstar - sgnm * ustar
    ushock = 0.5 * (spin + spout)
    spout_ = torch.where(pstar >= po, ushock, spout)
    spin_ = torch.where(pstar >= po, ushock, spin)
    frac = torch.clamp(0.5 * (1.0 + (spout_ + spin_)
                              / torch.clamp(spout_ - spin_, min=cfg.smallc)),
                       0.0, 1.0)
    qg_r = torch.where(spout_ < 0.0, ro,
                       torch.where(spin_ > 0.0, rstar,
                                   frac * rstar + (1.0 - frac) * ro))
    qg_u = torch.where(spout_ < 0.0, uo,
                       torch.where(spin_ > 0.0, ustar,
                                   frac * ustar + (1.0 - frac) * uo))
    qg_p = torch.where(spout_ < 0.0, po,
                       torch.where(spin_ > 0.0, pstar,
                                   frac * pstar + (1.0 - frac) * po))

    fmass = qg_r * qg_u
    etot = qg_p * entho + 0.5 * qg_r * qg_u ** 2
    tang = []
    for t in range(cfg.ndim - 1):
        v = torch.where(left, ql[3 + t], qr[3 + t])
        etot = etot + 0.5 * qg_r * v ** 2
        tang.append(v)
    flux = [fmass, qg_p + qg_r * qg_u ** 2, qg_u * (etot + qg_p)]
    for v in tang:
        flux.append(fmass * v)
    for n in range(cfg.nener):
        i = 2 + cfg.ndim + n
        flux.append(fmass * torch.where(left, ql[i], qr[i]))
    for s in range(cfg.npassive):
        i = 2 + cfg.ndim + cfg.nener + s
        flux.append(fmass * torch.where(left, ql[i], qr[i]))
    flux.append(fmass * (qg_p / qg_r * entho))
    return torch.stack(flux)


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
