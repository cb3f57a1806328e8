"""Unsplit second-order MUSCL-Hancock Godunov integrator (PyTorch).

Port of ``ramses_tpu/hydro/muscl.py``: the pipeline
``ctoprim → uslope → trace → cmpflxm → riemann_*``
(``hydro/umuscl.f90:22-171,861-1480``) as plain functions on whole
(ghost-padded) grids of shape ``[nvar, *spatial]``, in the JAX package's
arithmetic order.  This is the general path of
:func:`ramses_tpu_torch.grid.uniform.step` (1D, 2D, passives, f64, ...);
3D f32 runs take the fused kernel of :mod:`ramses_tpu_torch.hydro.fused_muscl`.

Not ported yet (each raises ``NotImplementedError``): the PLMDE predictor
(``trace_plmde``), positivity slopes (slope_type 3) and the dual-energy
``pressure_fix`` (``dual_energy_fix``).

Ghost-cell contract: callers pad with ``NGHOST=2`` cells per side.
Shifted neighbours are taken with ``torch.roll``; wrap-around touches only
ghost results that the active region never consumes.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ramses_tpu_torch.hydro import riemann as rsolve
from ramses_tpu_torch.hydro.core import HydroStatic

NGHOST = 2


def _axis(cfg: HydroStatic, d: int, u) -> int:
    """Spatial axis of direction d: trailing spatial axes by default, or
    axes 1..ndim when ``cfg.trailing_batch`` ([nvar, *spatial, batch])."""
    if cfg.trailing_batch:
        return 1 + d
    return u.dim() - cfg.ndim + d


def ctoprim(u, grav, dt, cfg: HydroStatic):
    """Conservative → primitive + sound speed + gravity predictor.

    (``hydro/umuscl.f90:861-967``.)  ``grav`` may be None (no gravity).
    Returns (q, c) with q in primitive layout (core.py docstring).
    """
    r = torch.clamp(u[0], min=cfg.smallr)
    inv_r = 1.0 / r
    vels = [u[1 + d] * inv_r for d in range(cfg.ndim)]
    eken = sum(0.5 * v * v for v in vels)
    erad = torch.zeros_like(r)
    prad = []
    for n in range(cfg.nener):
        prad.append((cfg.gamma_rad[n] - 1.0) * u[2 + cfg.ndim + n])
        erad = erad + u[2 + cfg.ndim + n] * inv_r
    eint = torch.clamp(u[cfg.ndim + 1] * inv_r - eken - erad, min=cfg.smalle)
    p = (cfg.gamma - 1.0) * r * eint
    c2 = cfg.gamma * p
    for n in range(cfg.nener):
        c2 = c2 + cfg.gamma_rad[n] * prad[n]
    c = torch.sqrt(c2 * inv_r)
    if grav is not None:
        vels = [v + g * (0.5 * dt) for v, g in zip(vels, grav)]
    comps = [r] + vels + [p] + prad
    for s in range(cfg.npassive):
        comps.append(u[2 + cfg.ndim + cfg.nener + s] * inv_r)
    return torch.stack(comps), c


def uslope(q, cfg: HydroStatic, dt=None, dx=None):
    """TVD slopes per direction (``hydro/umuscl.f90:970-1393``).

    slope_type 0: zero | 1: minmod | 2: moncen | 7: van Leer |
    8: generalized minmod with ``slope_theta`` (van Leer 1979).
    Returns ``dq`` of shape ``[ndim, nvar, *spatial]``.
    """
    st = cfg.slope_type
    if st == 0:
        return torch.zeros((cfg.ndim,) + tuple(q.shape), dtype=q.dtype,
                           device=q.device)
    if st == 3 and cfg.ndim > 1:
        raise NotImplementedError(
            "slope_type=3 (positivity slopes) is not ported to "
            "ramses_tpu_torch yet")
    dq = []
    for d in range(cfg.ndim):
        ax = _axis(cfg, d, q)
        qm1 = torch.roll(q, 1, dims=ax)
        qp1 = torch.roll(q, -1, dims=ax)
        dlft = q - qm1
        drgt = qp1 - q
        if st in (1, 2, 3):
            f = float(min(st, 2))
            dcen = 0.5 * (dlft + drgt)
            slop = f * torch.minimum(torch.abs(dlft), torch.abs(drgt))
            dlim = torch.where(dlft * drgt <= 0.0, 0.0, slop)
            dq.append(torch.sign(dcen) * torch.minimum(dlim, torch.abs(dcen)))
        elif st == 7:  # van Leer harmonic
            # guarded denominator: the untaken branch stays finite
            prod = dlft * drgt
            mono = prod > 0.0
            vl_den = torch.where(mono, dlft + drgt + 1e-300, 1.0)
            vl = 2.0 * prod / vl_den
            dq.append(torch.where(mono, vl, 0.0))
        elif st == 8:  # generalized moncen/minmod (theta)
            th = cfg.slope_theta
            dcen = 0.5 * (dlft + drgt)
            slop = th * torch.minimum(torch.abs(dlft), torch.abs(drgt))
            dlim = torch.where(dlft * drgt <= 0.0, 0.0, slop)
            dq.append(torch.sign(dcen) * torch.minimum(dlim, torch.abs(dcen)))
        else:
            raise NotImplementedError(f"slope_type={st}")
    return torch.stack(dq)


def trace(q, dq, dt, dx: Sequence[float], cfg: HydroStatic):
    """MUSCL-Hancock half-dt predictor (``hydro/umuscl.f90:176-714``,
    trace1d/2d/3d unified over ndim).

    Returns (qm, qp): per-direction left/right interface states, each of
    shape ``[ndim, nvar, *spatial]``.  ``qm[d]`` is the state at the cell's
    high-side (right) face, ``qp[d]`` at its low-side (left) face.
    """
    nd = cfg.ndim
    ip = nd + 1  # pressure index
    r = q[0]
    p = q[ip]
    vels = [q[1 + d] for d in range(nd)]
    dr = [dq[d][0] for d in range(nd)]
    dp = [dq[d][ip] for d in range(nd)]
    dv = [[dq[d][1 + j] for j in range(nd)] for d in range(nd)]  # dv[dir][comp]

    divv = sum(dv[d][d] for d in range(nd))
    sr0 = -sum(vels[d] * dr[d] for d in range(nd)) - divv * r
    sp0 = -sum(vels[d] * dp[d] for d in range(nd)) - divv * cfg.gamma * p
    sv0 = []
    for j in range(nd):
        s = -sum(vels[d] * dv[d][j] for d in range(nd)) - dp[j] / r
        for n in range(cfg.nener):
            s = s - dq[j][ip + 1 + n] / r
        sv0.append(s)
    se0 = []
    for n in range(cfg.nener):
        e = q[ip + 1 + n]
        se0.append(-sum(vels[d] * dq[d][ip + 1 + n] for d in range(nd))
                   - divv * cfg.gamma_rad[n] * e)
    sa0 = []
    for s in range(cfg.npassive):
        i = ip + 1 + cfg.nener + s
        sa0.append(-sum(vels[d] * dq[d][i] for d in range(nd)))

    qm, qp = [], []
    for d in range(nd):
        dtdx2 = 0.5 * dt / dx[d]
        half_d = 0.5 * dq[d]

        def build(sgn):
            comps = [None] * q.shape[0]
            rho = r + sgn * half_d[0] + sr0 * dtdx2
            comps[0] = torch.where(rho < cfg.smallr, r, rho)
            for j in range(nd):
                comps[1 + j] = vels[j] + sgn * half_d[1 + j] + sv0[j] * dtdx2
            comps[ip] = p + sgn * half_d[ip] + sp0 * dtdx2
            for n in range(cfg.nener):
                comps[ip + 1 + n] = (q[ip + 1 + n] + sgn * half_d[ip + 1 + n]
                                     + se0[n] * dtdx2)
            for s in range(cfg.npassive):
                i = ip + 1 + cfg.nener + s
                comps[i] = q[i] + sgn * half_d[i] + sa0[s] * dtdx2
            return torch.stack(comps)

        qm.append(build(+1.0))   # high-side face state
        qp.append(build(-1.0))   # low-side face state
    return torch.stack(qm), torch.stack(qp)


def trace_plmde(q, c, dq, dt, dx: Sequence[float], cfg: HydroStatic):
    """PLMDE predictor (``hydro/uplmde.f90``): not ported yet."""
    raise NotImplementedError(
        "scheme='plmde' (trace_plmde) is not ported to ramses_tpu_torch yet")


def _iface_perm(cfg: HydroStatic, d: int) -> List[int]:
    """State-layout → interface-layout component permutation for dir d.

    Interface layout (riemann.py): rho, v_norm, P, v_tang..., nener, passive.
    Matches cmpflxm's (ln,lt1,lt2) gather (``hydro/umuscl.f90:96-105``).
    """
    tang = [j for j in range(cfg.ndim) if j != d]
    perm = [0, 1 + d, cfg.ndim + 1] + [1 + t for t in tang]
    perm += list(range(cfg.ndim + 2, cfg.nvar))
    return perm


def face_fluxes(qm, qp, cfg: HydroStatic):
    """Godunov fluxes on all faces of every direction (``cmpflxm``).

    ``flux[d]`` is defined at the LOW face of each cell: interface between
    cell (i-1, i) along axis d, stored at index i.  Returns
    (flux [ndim, nvar, *sp], tmp [ndim, 2, *sp]) where tmp[:,0] is the face
    normal velocity (for div.u) and tmp[:,1] the internal-energy flux.
    """
    fluxes, tmps = [], []
    for d in range(cfg.ndim):
        ax = _axis(cfg, d, qm[d])
        perm = _iface_perm(cfg, d)
        ql = torch.roll(qm[d], 1, dims=ax)[perm]
        qr = qp[d][perm]
        fg = rsolve.solve(ql, qr, cfg)
        # scatter flux back to state layout: fg = [mass, mom_n, E, tang...,
        # nener..., passives..., eint]
        out = [None] * cfg.nvar
        out[0] = fg[0]
        out[1 + d] = fg[1]
        out[cfg.ndim + 1] = fg[2]
        tang = [j for j in range(cfg.ndim) if j != d]
        for k, t in enumerate(tang):
            out[1 + t] = fg[3 + k]
        for k in range(cfg.nener + cfg.npassive):
            out[cfg.ndim + 2 + k] = fg[2 + cfg.ndim + k]
        fluxes.append(torch.stack(out))
        tmps.append(torch.stack([0.5 * (ql[1] + qr[1]), fg[cfg.nvar]]))
    return torch.stack(fluxes), torch.stack(tmps)


def unsplit(u, grav, dt, dx: Sequence[float], cfg: HydroStatic):
    """One unsplit MUSCL-Hancock step on a ghost-padded grid.

    Equivalent of ``unsplit`` (``hydro/umuscl.f90:22-171``): returns
    per-direction face fluxes already scaled by dt/dx, plus the tmp array.
    The conservative update itself is :func:`apply_fluxes`.  ``dt`` is a
    0-d tensor in the state dtype (or a Python float).
    """
    q, c = ctoprim(u, grav, dt, cfg)
    dq = uslope(q, cfg)
    if cfg.scheme == "muscl":
        qm, qp = trace(q, dq, dt, dx, cfg)
    elif cfg.scheme == "plmde":
        qm, qp = trace_plmde(q, c, dq, dt, dx, cfg)
    else:
        raise NotImplementedError(f"scheme={cfg.scheme}")
    flux, tmp = face_fluxes(qm, qp, cfg)
    scale = torch.stack([torch.as_tensor(dt / dx[d], dtype=u.dtype,
                                         device=u.device)
                         for d in range(cfg.ndim)])
    bshape = (cfg.ndim,) + (1,) * (flux.dim() - 1)
    return flux * scale.reshape(bshape), tmp * scale.reshape(bshape)


def dual_energy_fix(up, un, tmp, dt, dx: Sequence[float],
                    cfg: HydroStatic, hexp: float = 0.0):
    """Dual-energy pressure fix + non-thermal pdV sources
    (``hydro/godunov_fine.f90``): not ported yet."""
    raise NotImplementedError(
        "pressure_fix / non-thermal energies (dual_energy_fix) are not "
        "ported to ramses_tpu_torch yet")


def apply_fluxes(u, flux, cfg: HydroStatic):
    """Conservative update ``u += F_low - F_high`` per direction
    (``hydro/godunov_fine.f90:749-792``).  Valid on the active interior;
    the outermost ghost layers hold wrapped garbage."""
    unew = u
    for d in range(cfg.ndim):
        ax = _axis(cfg, d, u)
        unew = unew + (flux[d] - torch.roll(flux[d], -1, dims=ax))
    return unew
