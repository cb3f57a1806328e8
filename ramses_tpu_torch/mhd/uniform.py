"""Uniform-grid constrained-transport MHD stepper (PyTorch).

Port of ``ramses_tpu/mhd/uniform.py``: the ``mag_unsplit`` pipeline
(``mhd/umuscl.f90``) on whole ghost-padded grids,

  ctoprim → TVD slopes → conservative Hancock half-step predictor →
  per-direction HLLD/HLL/LLF/Roe face fluxes → Gardiner-Stone or 2D
  Riemann corner EMF → induction update of the staggered field
  (``mhd/godunov_fine.f90:960-973``) → conservative update,

in the JAX package's arithmetic order.  div(B) stays zero to rounding by
construction (staggered curl).

:func:`step` runs each step through the hand-written CUDA kernel
(:mod:`ramses_tpu_torch.mhd.ct_slab`, the counterpart of the TPU kernel
``mhd/pallas_ct.py``) where its ``supports()`` covers the configuration,
and :func:`step_padded`, this module's formulation, everywhere else (f64,
more passives than the kernel takes): a choice made by configuration
only.  The ensemble variant ``run_steps_batch`` is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dreplace
from typing import Sequence, Tuple

import torch

from ramses_tpu_torch.grid import boundary as bmod
from ramses_tpu_torch.hydro import muscl as hmuscl
from ramses_tpu_torch.mhd import core, riemann as rsolve
from ramses_tpu_torch.mhd.core import IBX, IP, MhdStatic, NCOMP

NGHOST = 2


@dataclass(frozen=True)
class MhdGrid:
    cfg: MhdStatic
    shape: Tuple[int, ...]
    dx: float
    bc_kinds: Tuple[Tuple[int, int], ...]   # per-dim (low, high) kinds

    @property
    def ncell(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _pad(a, ndim: int, bc_kinds, ng: int = NGHOST):
    """Ghost-pad the trailing ndim axes: periodic wrap or outflow edge
    replication (the two kinds the MHD path supports)."""
    for d in range(ndim):
        ax = a.dim() - ndim + d
        lo, hi = bc_kinds[d]
        n = a.shape[ax]

        def ghost(kind, side):
            if kind == bmod.PERIODIC:
                return a.narrow(ax, n - ng, ng) if side == 0 \
                    else a.narrow(ax, 0, ng)
            # outflow: replicate the edge
            edge = a.narrow(ax, 0, 1) if side == 0 else a.narrow(ax, n - 1, 1)
            reps = [1] * a.dim()
            reps[ax] = ng
            return edge.repeat(reps)

        a = torch.cat([ghost(lo, 0), a, ghost(hi, 1)], dim=ax)
    return a


def _unpad(a, ndim: int, ng: int = NGHOST):
    idx = [slice(None)] * a.dim()
    for d in range(ndim):
        ax = a.dim() - ndim + d
        idx[ax] = slice(ng, a.shape[ax] - ng)
    return a[tuple(idx)]


def _slopes(q, cfg: MhdStatic):
    """The hydro TVD limiter bank on the MHD primitive stack: ``uslope``
    reads only ndim/slope_type/slope_theta/trailing_batch, which
    MhdStatic provides with the same meaning."""
    return list(hmuscl.uslope(q, cfg))


def _rot_perm(cfg: MhdStatic, d: int):
    t1, t2 = (d + 1) % 3, (d + 2) % 3
    perm = [0, 1 + d, 1 + t1, 1 + t2, IP, IBX + d, IBX + t1, IBX + t2]
    perm += list(range(8, cfg.nvar))
    return perm


def _set_rows(a, start: int, rows):
    """``a`` with rows ``start:start+len(rows)`` replaced (a new tensor)."""
    return torch.cat([a[:start], torch.stack(list(rows)),
                      a[start + len(rows):]])


def ct_core(up, bfp, dt, dx: Sequence[float], cfg: MhdStatic,
            bax: int = 0, bn_faces=None, flux_mask=None,
            emf_override=None):
    """The CT MUSCL-Hancock pipeline on already-assembled arrays.

    ``up`` [nvar, *sp(, batch…)] cell conservative with B slots ALREADY
    cell-centred; ``bfp`` list of NCOMP low-face arrays (same spatial
    shape).  ``bax`` = number of trailing batch axes (0 for the uniform
    grid, 1 for the AMR per-oct stencil batch).  ``bn_faces``: optional
    override of the low-face normal fields fed to the Riemann solver and
    used as the induction base.  ``flux_mask``: optional per-dim keep
    factors (0 at refined faces, ``godunov_fine.f90:718``) applied to the
    CELL update and the returned fluxes but NOT to the EMF corner
    average.  ``emf_override``: dict (d1,d2) → (mask, values) replacing
    the edge EMF where the mask is set.  Spatial shifts are
    ``torch.roll``: callers keep enough ghost margin that wrapped entries
    never reach the region they keep.

    Returns (un, bfn_list, fluxes, e_edges), ``e_edges[(d1,d2)]`` the
    final corner EMF of that staggered pair.
    """
    nd = cfg.ndim

    def ax_(d, a):
        return a.dim() - nd - bax + d

    q = core.ctoprim(up, cfg)
    # the slope bank infers spatial axes from cfg: flag the batch axis
    scfg = dreplace(cfg, trailing_batch=True) if bax else cfg
    dq = _slopes(q, scfg)

    # conservative Hancock half-step: the cell's own reconstructed faces
    du_half = torch.zeros_like(up)
    face_q = []
    for d in range(nd):
        q_hi = q + 0.5 * dq[d]
        q_lo = q - 0.5 * dq[d]
        f_hi = core.flux_along(q_hi, d, cfg)
        f_lo = core.flux_along(q_lo, d, cfg)
        du_half = du_half - (0.5 * dt / dx[d]) * (f_hi - f_lo)
        face_q.append((q_lo, q_hi))

    # half-dt prediction of the staggered field (edge-averaged cell EMFs),
    # so the Riemann normal field is time-centred like its other inputs
    base_faces = bn_faces if bn_faces is not None else bfp
    bf_half = [base_faces[c] for c in range(NCOMP)]
    for d1 in range(nd):
        for d2 in range(d1 + 1, nd):
            ax1 = ax_(d1, bfp[d1])
            ax2 = ax_(d2, bfp[d1])
            sig = 1.0 if (d1, d2) in ((0, 1), (1, 2), (2, 0)) else -1.0
            v1, v2 = q[1 + d1], q[1 + d2]
            b1, b2 = q[IBX + d1], q[IBX + d2]
            e_c0 = sig * (v2 * b1 - v1 * b2)
            e_edge0 = 0.25 * (e_c0 + torch.roll(e_c0, 1, dims=ax1)
                              + torch.roll(e_c0, 1, dims=ax2)
                              + torch.roll(e_c0, (1, 1), dims=(ax1, ax2)))
            bf_half[d1] = bf_half[d1] - sig * (0.5 * dt / dx[d2]) * (
                torch.roll(e_edge0, -1, dims=ax2) - e_edge0)
            bf_half[d2] = bf_half[d2] + sig * (0.5 * dt / dx[d1]) * (
                torch.roll(e_edge0, -1, dims=ax1) - e_edge0)

    fluxes = []
    for d in range(nd):
        ax = ax_(d, q)
        q_lo, q_hi = face_q[d]
        ul_c = core.prim_to_cons(q_hi, cfg) + du_half    # this cell's hi face
        ur_c = core.prim_to_cons(q_lo, cfg) + du_half    # this cell's lo face
        ql = core.ctoprim(torch.roll(ul_c, 1, dims=ax), cfg)
        qr = core.ctoprim(ur_c, cfg)
        # rows by a Python list of views: indexing with the list itself
        # would copy it to the device and wait for the copy
        perm = _rot_perm(cfg, d)
        ql_r = torch.stack([ql[i] for i in perm])
        qr_r = torch.stack([qr[i] for i in perm])
        bn = bf_half[d]                # staggered, half-dt predicted
        fg = rsolve.solve(ql_r, qr_r, bn, cfg)
        # scatter to state layout
        out = [None] * cfg.nvar
        t1, t2 = (d + 1) % 3, (d + 2) % 3
        out[0] = fg[0]
        out[1 + d], out[1 + t1], out[1 + t2] = fg[1], fg[2], fg[3]
        out[IP] = fg[4]
        out[IBX + d], out[IBX + t1], out[IBX + t2] = fg[5], fg[6], fg[7]
        for s in range(cfg.npassive):
            out[8 + s] = fg[8 + s]
        fluxes.append(torch.stack(out))

    # conservative update of cell state (staggered B rows excluded)
    if flux_mask is not None:
        fl_cell = [fluxes[d] * flux_mask[d][None] for d in range(nd)]
    else:
        fl_cell = fluxes
    un = up
    for d in range(nd):
        ax = ax_(d, up)
        un = un + (dt / dx[d]) * (fl_cell[d]
                                  - torch.roll(fl_cell[d], -1, dims=ax))
    # half-step primitives for the cell-centred EMF reference
    q_half = core.ctoprim(up + du_half, cfg)

    # CT induction on the staggered components, from the same face values
    # the Riemann solver saw (bn_faces)
    bfn = [base_faces[c] for c in range(NCOMP)]
    e_edges = {}
    use2d = cfg.riemann2d != "average" and nd >= 2
    for d1 in range(nd):
        for d2 in range(d1 + 1, nd):
            # axes on the scalar (no component dim) EMF arrays
            ax1 = ax_(d1, bfp[d1])
            ax2 = ax_(d2, bfp[d1])
            sig = 1.0 if (d1, d2) in ((0, 1), (1, 2), (2, 0)) else -1.0
            if use2d:
                # 2D corner Riemann upwinding (cmp_mag_flx,
                # mhd/umuscl.f90:1453): half-dt corner states of the four
                # cells around each edge, reconstructed in PRIMITIVE space
                from ramses_tpu_torch.mhd import riemann2d as r2d
                pfloor = cfg.smallr * cfg.smallc ** 2
                qcorner = {}
                for s1 in (-1.0, 1.0):
                    for s2 in (-1.0, 1.0):
                        qc = q_half + 0.5 * (s1 * dq[d1] + s2 * dq[d2])
                        qc = _set_rows(qc, 0, [torch.clamp(qc[0],
                                                           min=cfg.smallr)])
                        qc = _set_rows(qc, IP, [torch.clamp(qc[IP],
                                                            min=pfloor)])
                        qcorner[(s1, s2)] = qc
                dorth = 3 - d1 - d2

                def comp(qc, *rolls):
                    for ax in rolls:
                        qc = torch.roll(qc, 1, dims=ax)
                    return (qc[0], qc[IP], qc[1 + d1], qc[1 + d2],
                            qc[1 + dorth], qc[IBX + dorth])

                qax1, qax2 = ax_(d1, q), ax_(d2, q)
                states = {
                    ("R", "T"): comp(qcorner[(-1.0, -1.0)]),
                    ("L", "T"): comp(qcorner[(1.0, -1.0)], qax1),
                    ("R", "B"): comp(qcorner[(-1.0, 1.0)], qax2),
                    ("L", "B"): comp(qcorner[(1.0, 1.0)], qax1, qax2),
                }
                A_T = bf_half[d1]
                A_B = torch.roll(bf_half[d1], 1, dims=ax2)
                B_R = bf_half[d2]
                B_L = torch.roll(bf_half[d2], 1, dims=ax1)
                eps = r2d.corner_emf(states, A_T, A_B, B_R, B_L, cfg)
                e_edge = -sig * eps
            else:
                # F_d1(B_d2) = -sig*E_e ; F_d2(B_d1) = +sig*E_e
                e_f1 = -sig * fluxes[d1][IBX + d2]       # (lo d1, ctr d2)
                e_f2 = sig * fluxes[d2][IBX + d1]        # (ctr d1, lo d2)
                # cell-centred reference EMF from the half-step state
                v1, v2 = q_half[1 + d1], q_half[1 + d2]
                b1, b2 = q_half[IBX + d1], q_half[IBX + d2]
                e_c = sig * (v2 * b1 - v1 * b2)          # E_e = -(v×B)_e
                # Gardiner & Stone (2005) arithmetic corner average
                e_edge = (0.5 * (e_f1 + torch.roll(e_f1, 1, dims=ax2)
                                 + e_f2 + torch.roll(e_f2, 1, dims=ax1))
                          - 0.25 * (e_c + torch.roll(e_c, 1, dims=ax1)
                                    + torch.roll(e_c, 1, dims=ax2)
                                    + torch.roll(e_c, (1, 1),
                                                 dims=(ax1, ax2))))
            if emf_override is not None and (d1, d2) in emf_override:
                # coarse-fine EMF matching (godunov_fine.f90:826-973)
                msk, vals = emf_override[(d1, d2)]
                e_edge = torch.where(msk, vals.to(e_edge.dtype), e_edge)
            e_edges[(d1, d2)] = e_edge
            # dB_d1/dt = -sig * dE_e/d_d2 ; dB_d2/dt = +sig * dE_e/d_d1
            bfn[d1] = bfn[d1] - sig * (dt / dx[d2]) * (
                torch.roll(e_edge, -1, dims=ax2) - e_edge)
            bfn[d2] = bfn[d2] + sig * (dt / dx[d1]) * (
                torch.roll(e_edge, -1, dims=ax1) - e_edge)

    # degenerate (cell-centred) components advance with the conservative
    # flux update; without this they would be frozen at their ICs
    for c in range(nd, NCOMP):
        bfn[c] = un[IBX + c]
    # refresh the cell-centred staggered B components from the new faces
    bc_new = []
    for c in range(min(nd, NCOMP)):
        b = bfn[c]
        bc_new.append(0.5 * (b + torch.roll(b, -1, dims=ax_(c, b))))
    un = _set_rows(un, IBX, bc_new)
    return un, bfn, fl_cell, e_edges


def step_padded(cfg: MhdStatic, dx: Sequence[float], up, bfp_ext, dt,
                okp=None, ovr=None):
    """The CT step on ALREADY ghost-assembled arrays: the single pipeline
    behind :func:`step` and the plain version of the CT kernel
    (:func:`ramses_tpu_torch.mhd.ct_slab.ct_step_slab_ref`).

    ``up`` [nvar, \\*sp+2·ng] padded cell conservative with the RAW
    (uncentred) B slots — the face-average centring happens here;
    ``bfp_ext`` [NCOMP, \\*sp+2·(ng+1)] low faces padded one layer deeper
    (the centred average must be valid in every padded cell); ``okp``
    optional padded bool refined mask [\\*sp+2·ng]; ``ovr`` optional dict
    (d1,d2) → (padded mask, padded values) on the padded corner lattice.
    Returns the PADDED (un, bfn_list) — callers unpad."""
    nd = cfg.ndim
    trim = tuple([slice(None)] + [slice(1, -1)] * nd)
    bfp = bfp_ext[trim]
    bc = []
    for c in range(NCOMP):
        b = bfp_ext[c]
        lo = b[tuple(slice(1, -1) for _ in range(nd))]
        if c < nd:
            hi_idx = [slice(1, -1)] * nd
            hi_idx[c] = slice(2, None)      # neighbour's low face = high face
            bc.append(0.5 * (lo + b[tuple(hi_idx)]))
        else:
            bc.append(lo)
    up = _set_rows(up, IBX, bc)

    flux_mask = None
    if okp is not None:
        okp = okp.to(torch.bool)
        flux_mask = []
        for d in range(nd):
            ax = okp.dim() - nd + d
            keep = ~(okp | torch.roll(okp, 1, dims=ax))
            flux_mask.append(keep.to(up.dtype))
    un, bfn, _fluxes, _e = ct_core(up, [bfp[c] for c in range(NCOMP)],
                                   dt, dx, cfg, flux_mask=flux_mask,
                                   emf_override=ovr)
    return un, bfn


def step(grid: MhdGrid, u, bf, dt, ok=None, emf_override=None):
    """One CT MUSCL-Hancock step.  ``u`` [nvar, *sp] cell conservative
    (B slots cell-centred, derived), ``bf`` [3, *sp] staggered low-face
    field, ``dt`` a 0-d tensor or a float.  ``ok``: optional refined-cell
    mask — faces touching a refined cell get zero cell-state flux.
    ``emf_override``: dict (d1,d2) → (mask, values) on the ACTIVE grid's
    cell-corner lattice.  Returns (u', bf')."""
    from ramses_tpu_torch.mhd import ct_slab
    cfg = grid.cfg
    nd = cfg.ndim
    dx = (grid.dx,) * nd
    # the time axis may run in f64 while the state is f32: the step runs
    # in the state dtype
    dt = torch.as_tensor(dt, dtype=u.dtype, device=u.device)

    up = _pad(u, nd, grid.bc_kinds)
    # faces get one extra ghost layer so the cell-centred average is valid
    # in EVERY padded cell
    bfp_ext = _pad(bf, nd, grid.bc_kinds, NGHOST + 1)
    okp = None
    if ok is not None:
        okp = _pad(ok[None], nd, grid.bc_kinds)[0]
    ovr = None
    if emf_override is not None:
        ovr = {pair: (_pad(msk[None], nd, grid.bc_kinds)[0],
                      _pad(vals[None], nd, grid.bc_kinds)[0])
               for pair, (msk, vals) in emf_override.items()}
    if ct_slab.supports(cfg, grid.shape, u.dtype):
        return ct_slab.ct_step_slab(up, bfp_ext, dt, dx, cfg, okp=okp,
                                    ovr=ovr)
    return ct_slab.ct_step_slab_ref(up, bfp_ext, dt, dx, cfg, okp=okp,
                                    ovr=ovr)


def cfl_dt(grid: MhdGrid, u, bf):
    """The Courant dt of the state, a 0-d tensor on its device."""
    cfg = grid.cfg
    nd = cfg.ndim
    bc = core.cell_center_b([bf[c] for c in range(NCOMP)], nd)
    uu = _set_rows(u, IBX, bc)
    q = core.ctoprim(uu, cfg)
    rate = None
    for d in range(nd):
        cf = core.fast_speed(q, d, cfg)
        r = (torch.abs(q[1 + d]) + cf) / grid.dx
        rate = r if rate is None else rate + r
    return cfg.courant_factor / torch.max(rate)


def run_steps(grid: MhdGrid, u, bf, t, tend, nsteps: int,
              dt_scale: float = 1.0):
    """Advance up to ``nsteps`` steps on the device with no host
    synchronisation: dt is recomputed each step, clipped to land on
    ``tend``, and steps past ``tend`` leave the state as it is.  ``t`` and
    ``tend`` run in f64 whatever the state dtype; ``dt_scale < 1`` shrinks
    every Courant dt (the redo-step retry).  Returns ``(u, bf, t, ndone)``
    as device tensors."""
    t = torch.as_tensor(t, dtype=torch.float64, device=u.device)
    tend = torch.as_tensor(tend, dtype=torch.float64, device=u.device)
    ndone = torch.zeros((), dtype=torch.int64, device=u.device)
    for _ in range(nsteps):
        dt = (cfl_dt(grid, u, bf) * dt_scale).to(torch.float64)
        dt = torch.minimum(dt, torch.clamp(tend - t, min=0.0))
        active = t < tend
        un, bfn = step(grid, u, bf, torch.where(active, dt, 0.0))
        u = torch.where(active, un, u)
        bf = torch.where(active, bfn, bf)
        t = torch.where(active, t + dt, t)
        ndone = ndone + active.to(torch.int64)
    return u, bf, t, ndone


def totals(u, cfg: MhdStatic, dx: float):
    """Conservation audit; 0-d device tensors."""
    vol = dx ** cfg.ndim
    return {"mass": torch.sum(u[0]) * vol,
            "energy": torch.sum(u[IP]) * vol,
            "momentum": [torch.sum(u[1 + c]) * vol for c in range(NCOMP)]}
