"""Unsplit second-order MUSCL-Hancock Godunov integrator (PyTorch).

Port of ``ramses_tpu/hydro/muscl.py``: the pipeline
``ctoprim → uslope → trace → cmpflxm → riemann_*``
(``hydro/umuscl.f90:22-171,861-1480``) as plain functions on whole
(ghost-padded) grids of shape ``[nvar, *spatial]``, in the JAX package's
arithmetic order, with the PLMDE predictor (``trace_plmde``), the
positivity slopes (slope_type 3) and the dual-energy ``pressure_fix`` and
non-thermal pdV sources (``dual_energy_fix``).  This is the general path
of :func:`ramses_tpu_torch.grid.uniform.step` (1D, 2D, passives, f64,
the options above, ...); 3D f32 runs inside its gate take the fused kernel
of :mod:`ramses_tpu_torch.hydro.fused_muscl`.

Ghost-cell contract: callers pad with ``NGHOST=2`` cells per side.
Shifted neighbours are taken with ``torch.roll``; wrap-around touches only
ghost results that the active region never consumes.
"""

from __future__ import annotations

import itertools
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
        return _uslope_positivity(q, cfg)
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


def _uslope_positivity(q, cfg: HydroStatic):
    """slope_type=3 positivity-preserving unsplit slopes for 2D/3D
    (``hydro/umuscl.f90`` 'positivity preserving {2d,3d} unsplit slope'):
    centred differences per direction, all scaled by one common limiter
    ``min(1, min(|vmin|, |vmax|)/dff)``, vmin/vmax over the 3^ndim
    neighbourhood differences and ``dff = 0.5 * sum_d |dcen_d|``."""
    nd = cfg.ndim
    axes = [_axis(cfg, d, q) for d in range(nd)]
    vmin = torch.full_like(q, torch.inf)
    vmax = torch.full_like(q, -torch.inf)
    for offs in itertools.product((-1, 0, 1), repeat=nd):
        qs = q
        for d, o in enumerate(offs):
            if o:
                qs = torch.roll(qs, -o, dims=axes[d])
        df = qs - q
        vmin = torch.minimum(vmin, df)
        vmax = torch.maximum(vmax, df)
    dcen = [0.5 * (torch.roll(q, -1, dims=axes[d])
                   - torch.roll(q, 1, dims=axes[d])) for d in range(nd)]
    dff = 0.5 * sum(torch.abs(dc) for dc in dcen)
    slop = torch.where(dff > 0.0,
                       torch.clamp(torch.minimum(torch.abs(vmin),
                                                 torch.abs(vmax))
                                   / torch.where(dff > 0.0, dff, 1.0),
                                   max=1.0),
                       1.0)
    return torch.stack([slop * dc for dc in dcen])


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
    """PLMDE predictor: per-direction characteristic projection
    (``hydro/uplmde.f90`` tracex/tracexy/tracexyz unified over ndim).

    Each direction's face states project the (ρ, v_n, P) slopes onto the
    acoustic characteristics and keep only the waves that reach the face;
    tangential velocities, non-thermal energies and passives ride the
    entropy wave.  Returns (qm, qp) in the :func:`trace` convention.
    """
    nd = cfg.ndim
    ip = nd + 1
    r = q[0]
    p = q[ip]
    csq = cfg.gamma * p / torch.clamp(r, min=cfg.smallr)
    qm, qp = [], []
    for d in range(nd):
        dtdx = dt / dx[d]
        u = q[1 + d]
        dr = dq[d][0]
        du = dq[d][1 + d]
        dp = dq[d][ip]
        # supersonic fix: strong velocity gradients drop the acoustic
        # spread (uplmde.f90 'Supersonic fix')
        ccc = torch.where(torch.abs(du) > 3.0 * c, 0.0, c)
        alpham = 0.5 * (dp / csq - du * r / c)
        alphap = 0.5 * (dp / csq + du * r / c)
        alpha0 = dr - dp / csq

        def face(sgn):
            # sgn=-1: right state at the LOW face (left-moving waves);
            # sgn=+1: left state at the HIGH face (right-moving waves)
            if sgn < 0:
                spp = torch.where(u + ccc > 0.0, -1.0, (u + ccc) * dtdx)
                spm = torch.where(u - ccc > 0.0, -1.0, (u - ccc) * dtdx)
                spz = torch.where(u > 0.0, -1.0, u * dtdx)
                wp = 0.5 * (-1.0 - spp)
                wm = 0.5 * (-1.0 - spm)
                wz = 0.5 * (-1.0 - spz)
            else:
                spp = torch.where(u + ccc <= 0.0, 1.0, (u + ccc) * dtdx)
                spm = torch.where(u - ccc <= 0.0, 1.0, (u - ccc) * dtdx)
                spz = torch.where(u <= 0.0, 1.0, u * dtdx)
                wp = 0.5 * (1.0 - spp)
                wm = 0.5 * (1.0 - spm)
                wz = 0.5 * (1.0 - spz)
            ap = wp * alphap
            am = wm * alpham
            az = wz * alpha0
            comps = [None] * q.shape[0]
            comps[0] = torch.clamp(r + (ap + am + az), min=cfg.smallr)
            comps[1 + d] = u + (ap - am) * c / r
            comps[ip] = p + (ap + am) * csq
            for j in range(q.shape[0]):
                if comps[j] is None:     # entropy-wave riders
                    comps[j] = q[j] + wz * dq[d][j]
            return torch.stack(comps)

        qm.append(face(+1.0))
        qp.append(face(-1.0))
    return torch.stack(qm), torch.stack(qp)


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


def eint_of(u, cfg: HydroStatic):
    """Thermal internal energy density from a conservative state."""
    r = torch.clamp(u[0], min=cfg.smallr)
    e = u[cfg.ndim + 1] - sum(0.5 * u[1 + d] ** 2
                              for d in range(cfg.ndim)) / r
    for n in range(cfg.nener):
        e = e - u[cfg.ndim + 2 + n]
    return e


def dual_energy_fix(up, un, tmp, dt, dx: Sequence[float],
                    cfg: HydroStatic, hexp: float = 0.0):
    """Dual-energy pressure fix + non-thermal pdV sources on a padded
    block (``pressure_fix`` machinery of ``hydro/godunov_fine.f90``:
    divu/enew accumulation :735-790, ``add_pdv_source_terms`` :294-430,
    the set_uold correction :203-226).

    ``up``: padded OLD state; ``un``: padded UPDATED state (same layout);
    ``tmp``: per-direction [2, ...] (face normal velocity, internal-energy
    flux), both ×dt/dx as returned by :func:`unsplit`.  Valid on the
    active interior (ghost results are wrapped garbage, as in
    :func:`apply_fluxes`).  Returns ``un`` with the corrected total energy
    and pdV-updated non-thermal energies (a new tensor; ``un`` is not
    modified).
    """
    nd = cfg.ndim
    ie = nd + 1
    dt = torch.as_tensor(dt, dtype=up.dtype, device=up.device)
    r_old = torch.clamp(up[0], min=cfg.smallr)
    eint_old = eint_of(up, cfg)

    # field arrays ([*sp] / [*sp, batch]) drop the leading nvar axis of
    # the state layout _axis describes
    def axf(d):
        return _axis(cfg, d, up) - 1

    # face-flux accumulation: enew advection + divu (= -div·u·dt)
    enew = eint_old
    divu_acc = torch.zeros_like(eint_old)
    for d in range(nd):
        ax = axf(d)
        enew = enew + (tmp[d][1] - torch.roll(tmp[d][1], -1, dims=ax))
        divu_acc = divu_acc + (tmp[d][0]
                               - torch.roll(tmp[d][0], -1, dims=ax))

    # centred -pdV source from the OLD velocity field
    # (add_pdv_source_terms' Trace G over 2dx)
    divu_c = torch.zeros_like(eint_old)
    for d in range(nd):
        ax = axf(d)
        v = up[1 + d] / r_old
        divu_c = divu_c + (torch.roll(v, -1, dims=ax)
                           - torch.roll(v, 1, dims=ax)) / (2.0 * dx[d])
    enew = enew - (cfg.gamma - 1.0) * eint_old * divu_c * dt
    rows = list(un.unbind(0))
    for n in range(cfg.nener):
        i = nd + 2 + n
        rows[i] = rows[i] + (-(cfg.gamma_rad[n] - 1.0) * up[i]
                             * divu_c * dt)

    if cfg.pressure_fix:
        # truncation test on the UPDATED state
        r_new = torch.clamp(rows[0], min=cfg.smallr)
        ekin_new = sum(0.5 * rows[1 + d] ** 2 for d in range(nd)) / r_new
        for n in range(cfg.nener):
            ekin_new = ekin_new + rows[nd + 2 + n]
        e_cons = rows[ie] - ekin_new
        div = torch.abs(divu_acc) * dx[0] / torch.clamp(dt, min=1e-300)
        e_trunc = cfg.beta_fix * r_new * torch.clamp(
            div, min=3.0 * hexp * dx[0]) ** 2
        rows[ie] = torch.where(e_cons < e_trunc, enew + ekin_new, rows[ie])
    return torch.stack(rows)


def apply_fluxes(u, flux, cfg: HydroStatic):
    """Conservative update ``u += F_low - F_high`` per direction
    (``hydro/godunov_fine.f90:749-792``).  Valid on the active interior;
    the outermost ghost layers hold wrapped garbage."""
    unew = u
    for d in range(cfg.ndim):
        ax = _axis(cfg, d, u)
        unew = unew + (flux[d] - torch.roll(flux[d], -1, dims=ax))
    return unew
