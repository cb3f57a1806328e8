"""MHD on the AMR hierarchy (PyTorch): constrained transport on per-level oct
batches with divergence-free prolongation and restriction.

Port of the single-device ``MhdAmrSim`` of ``ramses_tpu/mhd/amr.py``
(reference ``mhd/godunov_fine.f90``, ``mhd/interpol_hydro.f90``), with its
design:

* **Face storage is duplicated per cell**: ``bfs[l]`` holds
  ``[ncell_pad, 3, 2]`` = (low, high) face field per dim per cell.  Both
  copies of a shared face are updated from the same edge EMFs, so they stay
  bitwise equal and div B per cell is an exact telescoping sum.
* **Prolongation** is the Balsara reconstruction (outer child faces inject
  or copy a fine neighbour's stored face, the mid faces solve the
  children's div B = 0 system); **restriction** is the area mean of the son
  faces.
* A **complete level** steps as one dense box through
  :func:`ramses_tpu_torch.mhd.uniform.step` with its refined-cell mask and
  the coarse-fine EMF override (the time-averaged fine EMFs on the
  parent's corner lattice, ``mhd/godunov_fine.f90:826-973``): the
  hand-written CT kernel (``csrc/mhd_ct.cu``, K4) wherever its
  ``supports()`` covers the configuration.
* A **partial level** runs ``ct_core`` on the per-oct 6^d stencil batch or
  the compact Morton-tile batch with a trailing batch axis, which K4's gate
  refuses by configuration; in the JAX package too no Pallas kernel serves
  them (``ramses_tpu/mhd/amr.py:311-313``).

The scatters the JAX package runs with ``mode="drop"`` take only their
valid targets here, filtered on the host where the maps are built; the
coarse-fine EMF override keeps one canonical writer per shared corner, so
every scatter writes distinct rows and its result is the same on every run.
Restriction takes the valid prefix of its map, as
:func:`ramses_tpu_torch.amr.kernels.restrict_upload` does (ROADMAP §C).

``dump`` writes the reference MHD column set (density, velocity, the
B_left/B_right faces, pressure) and ``from_snapshot`` restores it through
the hydro hierarchy's restart scaffold: the face fields come back verbatim
from the left and right columns, the centred B as their mean.

Gravity, particles, tracers, patch hooks, offload and the multi-device
slab and explicit-comm paths are not ported: a namelist that turns one on
raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ramses_tpu_torch.amr import kernels as K
from ramses_tpu_torch.amr.hierarchy import AmrSim, FusedSpec
from ramses_tpu_torch.amr.tree import map_coords
from ramses_tpu_torch.config import Params
from ramses_tpu_torch.grid import boundary as bmod
from ramses_tpu_torch.mhd import core, uniform as mu
from ramses_tpu_torch.mhd.core import IBX, IP, MhdStatic, NCOMP


def _pairs(nd: int):
    return [(d1, d2) for d1 in range(nd) for d2 in range(d1 + 1, nd)]


# ---------------------------------------------------------------------------
# div-free face prolongation (interpol_mag, mhd/interpol_hydro.f90)
# ---------------------------------------------------------------------------

def _balsara_system(nd: int):
    """Minimal-norm solve for the interior fine faces of a refined cell:
    the children's div B = 0 conditions are A·m = c, m the mid-face
    corrections to the two-point means; A is a fixed ±1 pattern whose
    pseudoinverse is precomputed on the host."""
    children = np.indices((2,) * nd).reshape(nd, -1).T   # x slowest
    nsub = 2 ** (nd - 1)
    A = np.zeros((2 ** nd, nd * nsub))
    submap = np.zeros((2 ** nd, nd), dtype=np.int64)
    for ci, ch in enumerate(children):
        for d in range(nd):
            sub = 0
            for dd in range(nd):
                if dd != d:
                    sub = sub * 2 + ch[dd]
            submap[ci, d] = sub
            A[ci, d * nsub + sub] = 1.0 - 2.0 * ch[d]    # +1 low child
    return np.linalg.pinv(A), submap, children


_BALSARA = {nd: _balsara_system(nd) for nd in (1, 2, 3)}


def matched_child_faces(father_bf, outer, nd: int):
    """Child faces of newly refined cells, matched to their fine
    neighbours' stored sub-faces.

    ``father_bf`` [n, 3, 2] (degenerate components); ``outer`` [n, nd, 2,
    nsub]: the cell's outer fine sub-face values, a donor neighbour's
    stored face where one exists and the injected coarse face otherwise.
    The interior faces solve the children's div B = 0 system (minimal-norm
    correction to the two-point means, the pseudoinverse applied as a
    fixed-order sum).  Returns [n·2^nd, 3, 2] rows in flat-cell order."""
    pinv, submap, children = _BALSARA[nd]
    nsub = 2 ** (nd - 1)
    n = father_bf.shape[0]
    D = outer[:, :, 1, :] - outer[:, :, 0, :]            # [n, nd, nsub]
    mean = 0.5 * (outer[:, :, 0, :] + outer[:, :, 1, :])
    # c_child = -(1/2) sum_d D[d, sub_d(child)]
    cs = []
    for ci in range(2 ** nd):
        acc = D[:, 0, submap[ci, 0]]
        for d in range(1, nd):
            acc = acc + D[:, d, submap[ci, d]]
        cs.append(-0.5 * acc)
    m = []
    for j in range(nd * nsub):
        acc = cs[0] * float(pinv[j, 0])
        for ci in range(1, 2 ** nd):
            acc = acc + cs[ci] * float(pinv[j, ci])
        m.append(acc)
    mid = mean + torch.stack(m, dim=-1).reshape(n, nd, nsub)

    rows = []
    for ci, ch in enumerate(children):
        comps = []
        for comp in range(NCOMP):
            if comp < nd:
                sub = submap[ci, comp]
                lo_out = outer[:, comp, 0, sub]
                hi_out = outer[:, comp, 1, sub]
                mid_c = mid[:, comp, sub]
                lo, hi = (lo_out, mid_c) if ch[comp] == 0 else (mid_c, hi_out)
            else:
                lo = hi = 0.5 * (father_bf[:, comp, 0] + father_bf[:, comp, 1])
            comps.append(torch.stack([lo, hi], dim=-1))
        rows.append(torch.stack(comps, dim=1))           # [n, 3, 2]
    return torch.stack(rows, dim=1).reshape(n * 2 ** nd, NCOMP, 2)


def balsara_child_faces(bff, sgn, nd: int):
    """Child (lo, hi) faces from the father's: the outer face injects, the
    mid face is (lo+hi)/2.  ``bff`` [n, 3, 2]; ``sgn`` [n, nd] ±1 child
    offsets.  Child div B == father div B exactly."""
    out = []
    for c in range(NCOMP):
        lo, hi = bff[:, c, 0], bff[:, c, 1]
        if c < nd:
            mid = 0.5 * (lo + hi)
            low_child = sgn[:, c] < 0
            clo = torch.where(low_child, lo, mid)
            chi = torch.where(low_child, mid, hi)
        else:
            clo = chi = 0.5 * (lo + hi)
        out.append(torch.stack([clo, chi], dim=-1))
    return torch.stack(out, dim=1)                       # [n, 3, 2]


def _gather_faces(bf_flat, interp_faces, src_idx, nd: int, side: int):
    """``[3, 2, side…, nblock]`` face batch from flat rows + interps + one
    zero trash row; ``src_idx`` ``[nblock, side^d]`` (the per-oct stencil,
    side 6, or the blocked tile, side td: cf. ``K._gather``)."""
    trash = bf_flat.new_zeros((1, NCOMP, 2))
    src = torch.cat([bf_flat, interp_faces.to(bf_flat.dtype), trash])
    g = src.permute(1, 2, 0)[:, :, src_idx.t()]         # [3, 2, side^d, nb]
    return g.reshape((NCOMP, 2) + (side,) * nd + (src_idx.shape[0],))


# ---------------------------------------------------------------------------
# per-level sweeps (partial levels)
# ---------------------------------------------------------------------------

def _ct_batch(ub, floc, real, okl, dt, dx: float, cfg: MhdStatic):
    """The CT pipeline on a gathered batch ``ub [nvar, side…, nb]``,
    ``floc [3, 2, side…, nb]``: cell-centred B from the duplicated faces,
    stored normal faces preferred next to a real cell (a ghost's injected
    coarse value must not override the fine stored field on a shared
    coarse-fine face), zero cell-state flux at refined faces.  Returns
    ``ct_core``'s (un, bfn, fl_cell, e_edges) and the batch it stepped."""
    nd = cfg.ndim
    centers = 0.5 * (floc[:, 0] + floc[:, 1])
    ub = torch.cat([ub[:IBX], centers, ub[IBX + NCOMP:]])
    bn_faces = []
    for c in range(NCOMP):
        lo_c = floc[c, 0]
        if c < nd:
            hi_m1 = torch.roll(floc[c, 1], 1, dims=c)
            real_m1 = torch.roll(real, 1, dims=c)
            bn_faces.append(torch.where(real, lo_c,
                                        torch.where(real_m1, hi_m1, lo_c)))
        else:
            bn_faces.append(lo_c)
    flux_mask = [(~(okl | torch.roll(okl, 1, dims=d))).to(ub.dtype)
                 for d in range(nd)]
    out = mu.ct_core(ub, [floc[c, 0] for c in range(NCOMP)], dt, (dx,) * nd,
                     cfg, bax=1, bn_faces=bn_faces, flux_mask=flux_mask)
    return out, ub


def mhd_level_sweep(u_flat, interp_u, bf_flat, interp_bf, stencil_src,
                    ok_ref, dt, dx: float, cfg: MhdStatic):
    """CT MUSCL-Hancock for one partial level on per-oct 6^d stencils.

    Returns (du_flat [ncell, nvar], bf_new [ncell, 3, 2], corr [noct, nd,
    2, nvar], emf [noct, npairs, 2, 2] | None) over the interior (2:4)
    cells of every oct, in flat-cell order; ``corr`` is the coarse
    flux-correction payload (already × dt/dx), ``emf`` the oct's
    father-cell edge EMFs (per staggered pair, corner low/high × low/high,
    averaged along the edge): the payload of the coarse-fine EMF
    matching."""
    nd = cfg.ndim
    uloc = K._gather_uloc(u_flat, interp_u, stencil_src, None, cfg)
    floc = _gather_faces(bf_flat, interp_bf, stencil_src, nd, 6)
    noct = uloc.shape[-1]
    # real-cell mask: rows below ncell_pad are this level's own cells
    real = K._block_mask(stencil_src < u_flat.shape[0], 6, nd)
    okl = K._block_mask(ok_ref, 6, nd)
    (un, bfn, fl_cell, e_edges), uloc = _ct_batch(uloc, floc, real, okl,
                                                  dt, dx, cfg)

    interior = tuple(slice(2, 4) for _ in range(nd))
    du = (un - uloc)[(slice(None),) + interior]        # [nvar, 2…, noct]
    du_flat = du.permute((nd + 1,) + tuple(range(1, nd + 1)) + (0,)) \
        .reshape(noct * 2 ** nd, cfg.nvar)

    corr = []
    for d in range(nd):
        f = fl_cell[d] * (dt / dx)
        sides = []
        for pos in (2, 4):
            ix = (slice(None),) + tuple(pos if d2 == d else slice(2, 4)
                                        for d2 in range(nd))
            red = tuple(range(1, nd))
            sides.append(f[ix].sum(dim=red) if nd > 1 else f[ix])
        corr.append(torch.stack(sides, dim=-1))        # [nvar, noct, 2]
    corr = torch.movedim(torch.stack(corr, dim=-2), 0, -1)

    def _cells(a):
        """[2…, noct] → flat [noct·2^nd]."""
        return a.permute((nd,) + tuple(range(nd))).reshape(-1)

    comps = []
    for c in range(NCOMP):
        if c < nd:
            hi_sl = tuple(slice(3, 5) if d == c else slice(2, 4)
                          for d in range(nd))
            lo, hi = _cells(bfn[c][interior]), _cells(bfn[c][hi_sl])
        else:
            lo = hi = _cells(un[IBX + c][interior])
        comps.append(torch.stack([lo, hi], dim=-1))
    bf_new = torch.stack(comps, dim=1)                 # [ncell, 3, 2]

    # father-cell edge EMFs: fine corner EMFs at the oct surface corners
    # (positions {2, 4} in the pair plane), edge-averaged over the
    # remaining interior positions (2:4)
    emf = None
    if nd > 1:
        outp = []
        for (d1, d2) in _pairs(nd):
            e = e_edges[(d1, d2)]                      # [6…, noct]
            corners = []
            for o1 in (2, 4):
                row = []
                for o2 in (2, 4):
                    s = [slice(2, 4)] * nd + [slice(None)]
                    s[d1], s[d2] = o1, o2
                    v = e[tuple(s)]                    # [(2,)*rest, noct]
                    red = tuple(range(v.dim() - 1))
                    row.append(v.mean(dim=red) if red else v)
                corners.append(torch.stack(row, dim=-1))
            outp.append(torch.stack(corners, dim=-2))  # [noct, 2, 2]
        emf = torch.stack(outp, dim=1)                 # [noct, np, 2, 2]
    return du_flat, bf_new, corr, emf


def mhd_tile_sweep(u_flat, interp_u, bf_flat, interp_bf, tile_src, tile_ok,
                   cell_tile, cell_slot, oct_tile, oct_slot, dt, dx: float,
                   cfg: MhdStatic, shift: int):
    """CT MUSCL-Hancock on the compact blocked tile batch: the same
    returns as :func:`mhd_level_sweep` (rows over the padded level, pad
    rows exactly 0), without the 6^d-duplicated stencil gather of cells and
    staggered faces.  Every interior cell, face and corner sees the same
    radius-2 neighbourhood as in the stencil batch and ``ct_core`` is
    shift-invariant, so the rows equal :func:`mhd_level_sweep`'s."""
    nd = cfg.ndim
    c = 1 << (shift + 1)
    td = c + 2 * K._NG
    ut = K._gather_utile(u_flat, interp_u, tile_src, None, cfg, td)
    floc = _gather_faces(bf_flat, interp_bf, tile_src, nd, td)
    ntile = ut.shape[-1]
    real = K._block_mask(tile_src < u_flat.shape[0], td, nd)
    okl = K._block_mask(tile_ok, td, nd)
    (un, bfn, fl_cell, e_edges), ut = _ct_batch(ut, floc, real, okl, dt, dx,
                                                cfg)

    # interior update → flat rows; pad cell rows index the appended zero
    # column, so they come out exactly 0
    interior = tuple(slice(K._NG, K._NG + c) for _ in range(nd))
    du = (un - ut)[(slice(None),) + interior]          # [nvar, c…, ntile]
    flat_idx = cell_slot.to(torch.int64) * ntile + cell_tile
    du_flat = torch.cat([du.reshape(cfg.nvar, c ** nd * ntile),
                         du.new_zeros(cfg.nvar, 1)], dim=1)[:, flat_idx].t()

    corr = []
    for d in range(nd):
        planes = K._face_planes(fl_cell[d] * (dt / dx), d, nd, c)
        lo, hi = K._corr_from_planes(planes.movedim(-1, 1), d, nd, c)
        corr.append(torch.stack([lo[:, oct_tile, oct_slot],
                                 hi[:, oct_tile, oct_slot]], dim=-1))
    corr = torch.movedim(torch.stack(corr, dim=-2), 0, -1)

    def _flat_cells(a):
        """[c…, ntile] → flat cell rows [ncell_pad] (pad rows 0)."""
        return torch.cat([a.reshape(c ** nd * ntile),
                          a.new_zeros(1)])[flat_idx]

    comps = []
    for comp in range(NCOMP):
        if comp < nd:
            hi_sl = tuple(slice(K._NG + 1, K._NG + c + 1) if dd == comp
                          else slice(K._NG, K._NG + c) for dd in range(nd))
            lo = _flat_cells(bfn[comp][interior])
            hi = _flat_cells(bfn[comp][hi_sl])
        else:
            lo = hi = _flat_cells(un[IBX + comp][interior])
        comps.append(torch.stack([lo, hi], dim=-1))
    bf_new = torch.stack(comps, dim=1)                 # [ncell, 3, 2]

    # father-cell edge EMFs: corner-lattice planes at even cell offsets
    # (the stencil path's positions {2, 4} for every oct of the tile),
    # edge-averaged over the remaining interior positions
    emf = None
    if nd > 1:
        o = c // 2
        outp = []
        for (d1, d2) in _pairs(nd):
            idx = tuple(slice(K._NG, K._NG + c + 1, 2) if dd in (d1, d2)
                        else slice(K._NG, K._NG + c) for dd in range(nd))
            g = e_edges[(d1, d2)][idx]
            # each non-pair dim c → (o, 2), then average the 2-subaxis
            shp, red, ax = [], [], 0
            for dd in range(nd):
                if dd in (d1, d2):
                    shp.append(o + 1)
                    ax += 1
                else:
                    shp += [o, 2]
                    red.append(ax + 1)
                    ax += 2
            g = g.reshape(shp + [ntile])
            if red:
                g = g.mean(dim=tuple(red))
            corners = []
            for i1 in (0, 1):
                row = []
                for i2 in (0, 1):
                    sl = [slice(None)] * (nd + 1)
                    sl[d1] = slice(i1, i1 + o)
                    sl[d2] = slice(i2, i2 + o)
                    row.append(g[tuple(sl)].reshape(o ** nd, ntile))
                corners.append(torch.stack(row, dim=-1))
            pv = torch.stack(corners, dim=-2)          # [o^nd, ntile, 2, 2]
            outp.append(pv[oct_slot, oct_tile])        # [noct, 2, 2]
        emf = torch.stack(outp, dim=1)                 # [noct, np, 2, 2]
    return du_flat, bf_new, corr, emf


# ---------------------------------------------------------------------------
# Courant, restriction, refinement criteria
# ---------------------------------------------------------------------------

def mhd_level_courant(u_flat, bf_flat, valid_cell, dx: float,
                      cfg: MhdStatic):
    """Fast-magnetosonic CFL dt over the level's valid cells (mhd
    ``courant_fine``), a 0-d device tensor."""
    ctr = 0.5 * (bf_flat[:, :, 0] + bf_flat[:, :, 1])  # [ncell, 3]
    u = torch.cat([u_flat[:, :IBX], ctr, u_flat[:, IBX + NCOMP:]], dim=1).t()
    q = core.ctoprim(u, cfg)
    ws = None
    for d in range(cfg.ndim):
        w = torch.abs(q[1 + d]) + core.fast_speed(q, d, cfg)
        ws = w if ws is None else ws + w
    ws = torch.clamp(ws, min=cfg.smallc)
    dtc = torch.where(valid_cell, dx / ws, torch.inf)
    return cfg.courant_factor * torch.min(dtc)


def mhd_restrict_upload(u_level, bf_level, u_fine, bf_fine, ref_cell,
                        son_oct, cfg: MhdStatic):
    """upload_fine for MHD: refined cells take their sons' means, their
    faces the area mean of the son faces on each side (staggered dims) —
    the div-free restriction.  ``ref_cell``/``son_oct``: the valid prefix
    of the level's restriction map (distinct cells, so the scatter is
    deterministic)."""
    if ref_cell.numel() == 0:
        return u_level, bf_level
    nd = cfg.ndim
    ttd = 2 ** nd
    rows = (son_oct.to(torch.int64)[:, None] * ttd
            + torch.arange(ttd, device=son_oct.device)[None, :])
    umean = u_fine[rows].mean(dim=1)                   # [nref, nvar]
    bsub = bf_fine[rows]                               # [nref, 2^d, 3, 2]
    offs = np.indices((2,) * nd).reshape(nd, -1).T     # x slowest
    comps = []
    for c in range(NCOMP):
        if c < nd:
            # the son faces on each side, summed in child order (no host
            # array goes to the device: the step never waits on a copy)
            sides = []
            for s in (0, 1):
                kids = [k for k in range(ttd) if offs[k, c] == s]
                acc = bsub[:, kids[0], c, s]
                for k in kids[1:]:
                    acc = acc + bsub[:, k, c, s]
                sides.append(acc / len(kids))
            lo, hi = sides
        else:
            lo = hi = bsub[:, :, c, 0].mean(dim=1)
        comps.append(torch.stack([lo, hi], dim=-1))
    bmean = torch.stack(comps, dim=1)                  # [nref, 3, 2]
    # the refined cells' centred B from the restricted faces
    ctr = 0.5 * (bmean[:, :nd, 0] + bmean[:, :nd, 1])
    umean = torch.cat([umean[:, :IBX], ctr, umean[:, IBX + nd:]], dim=1)
    cells = ref_cell.to(torch.int64)
    return (u_level.index_copy(0, cells, umean.to(u_level.dtype)),
            bf_level.index_copy(0, cells, bmean.to(bf_level.dtype)))


def _mhd_grad_flags(uloc, eg, fls, spatial0: int, cfg: MhdStatic):
    """MHD ``hydro_refine``: err_grad_d/p/b on density, pressure and |B|."""
    nd = cfg.ndim
    r = torch.clamp(uloc[0], min=cfg.smallr)
    inv_r = 1.0 / r
    v2 = core._sum([(uloc[1 + c] * inv_r) ** 2 for c in range(NCOMP)])
    b = [uloc[IBX + c] for c in range(NCOMP)]
    b2 = core._sum([bc * bc for bc in b])
    p = torch.clamp((cfg.gamma - 1.0) * (uloc[IP] - 0.5 * r * v2 - 0.5 * b2),
                    min=cfg.smallr * cfg.smallc ** 2)
    bmag = torch.sqrt(b2)
    ok = torch.zeros_like(r, dtype=torch.bool)
    for f, e, fl in ((r, eg[0], fls[0]), (p, eg[1], fls[1]),
                     (bmag, eg[2], fls[2])):
        if e >= 0.0:
            ok = ok | (K.two_sided_rel_err(f, fl, nd, spatial0) > e)
    return ok


def _mhd_fused_flags(u, dev, spec: FusedSpec, eg, fls):
    """Every level's MHD gradient criteria as flat-cell rows ``[noct_pad,
    2^d]`` (complete levels ``[ncell / 2^d, 2^d]``): the dense grid ghost-
    padded by the physical boundaries, the blocked tile batch, or the
    per-oct stencils."""
    cfg = spec.cfg
    nd = cfg.ndim
    out = []
    for i, l in enumerate(spec.levels):
        d = dev[l]
        if spec.complete[i]:
            shape = (1 << l,) * nd
            ud = K._rows_to_vars(u[l], None, shape)
            # ghost-pad per the physical BCs: a raw roll would wrap the two
            # domain edges together and flag phantom gradients there
            ok = _mhd_grad_flags(mu._pad(ud, nd, spec.bspec.kinds, 1), eg,
                                 fls, 0, cfg)
            ok = ok[tuple(slice(1, -1) for _ in range(nd))]
            out.append(K.dense_to_rows(ok, None, shape).reshape(
                -1, 2 ** nd))
            continue
        pre = "b_" if spec.blocked and spec.blocked[i] else ""
        interp = K.interp_cells(u[l - 1], d[pre + "interp_cell"],
                                d[pre + "interp_nb"], d[pre + "interp_sgn"],
                                cfg, itype=spec.itype)
        if pre:
            c = 1 << (spec.block_shift + 1)
            ut = K._gather_utile(u[l], interp, d["tile_src"], None, cfg,
                                 c + 2 * K._NG)
            ntile = ut.shape[-1]
            ok = _mhd_grad_flags(ut, eg, fls, 0, cfg)
            oki = ok[tuple(slice(K._NG, K._NG + c) for _ in range(nd))]
            okc = torch.cat([oki.reshape(c ** nd * ntile), ok.new_zeros(1)])
            rows = okc[d["cell_slot"].to(torch.int64) * ntile
                       + d["cell_tile"]]
            out.append(rows.reshape(-1, 2 ** nd))
        else:
            uloc = K._gather_uloc(u[l], interp, d["stencil_src"], None, cfg)
            ok = _mhd_grad_flags(uloc, eg, fls, 0, cfg)
            okc = torch.movedim(ok[tuple(slice(2, 4) for _ in range(nd))],
                                -1, 0)
            out.append(okc.reshape(okc.shape[0], 2 ** nd))
    return out


# ---------------------------------------------------------------------------
# the coarse step
# ---------------------------------------------------------------------------

def _dense_hi(lo_dense, d: int, periodic: bool):
    """High faces from a dense low-face field: the next cell's low face;
    a non-periodic top plane keeps its own low value (zero gradient)."""
    hi = torch.roll(lo_dense, -1, dims=d)
    if not periodic:
        n = lo_dense.shape[d]
        hi = torch.cat([hi.narrow(d, 0, n - 1), lo_dense.narrow(d, n - 1, 1)],
                       dim=d)
    return hi


def _emf_override(child_emf, plan, ncell: int, shape):
    """The parent's coarse-fine EMF override ``{pair: (mask, values)}`` on
    its dense corner lattice from the fine level's time-averaged edge EMFs
    ``child_emf [noct_pad, npairs, 2, 2]``: ``plan`` holds, per pair, the
    dense targets, the source rows (valid corners only, one canonical
    writer per corner, built on the host) and the dense mask."""
    override = {}
    for pi, (tgt, sel, msk) in enumerate(plan):
        src = child_emf[:, pi].reshape(-1).index_select(0, sel)
        vals = child_emf.new_zeros(ncell).index_copy(0, tgt, src)
        override[_pairs(len(shape))[pi]] = (msk, vals.reshape(shape))
    return override


def _complete_level_step(u_l, bf_l, d, dt, dx: float, l: int,
                         spec: FusedSpec, override):
    """One CT step of a complete level as a dense box (K4 within its gate):
    ``rows_to_dense`` → ``mu.step`` with the refined mask and the EMF
    override → ``dense_to_rows``.  Returns (du rows, new face rows)."""
    cfg = spec.cfg
    nd = cfg.ndim
    shape = (1 << l,) * nd
    ncell = shape[0] ** nd
    bc_kinds = spec.bspec.kinds
    grid = mu.MhdGrid(cfg=cfg, shape=shape, dx=dx, bc_kinds=bc_kinds)
    ud = K._rows_to_vars(u_l, None, shape)                 # [nvar, *shape]
    bfd = K._rows_to_vars(bf_l[:, :, 0], None, shape)      # [3, *shape]
    ok_d = (d["ok_dense"].reshape(shape) if d["ok_dense"] is not None
            else None)
    un_d, bfn_d = mu.step(grid, ud, bfd, dt, ok=ok_d, emf_override=override)
    du = K._vars_to_rows(un_d - ud, None, shape, u_l.shape[0])
    faces = []
    for c in range(NCOMP):
        lo = bfn_d[c]
        hi = (_dense_hi(lo, c, bc_kinds[c][0] == bmod.PERIODIC) if c < nd
              else lo)
        faces += [lo, hi]
    b_rows = K._vars_to_rows(torch.stack(faces), None, shape, ncell) \
        .reshape(ncell, NCOMP, 2).to(bf_l.dtype)
    if bf_l.shape[0] > ncell:
        b_rows = torch.cat([b_rows, bf_l[ncell:]])
    return du, b_rows


def _advance(u, bf, dev, dt, spec: FusedSpec):
    """One recursive subcycled MHD coarse step as device work only (cf.
    :func:`ramses_tpu_torch.amr.hierarchy._advance`).

    Cell-state conservation at coarse-fine interfaces follows the hydro
    scheme: refined-face fluxes are zeroed in the coarse sweep and the fine
    level scatters its summed boundary fluxes into the unrefined coarse
    neighbours, B-centre rows excluded (they remain the face mean; the
    face-field interface accounting is the EMF matching).  Returns the new
    (u, bf) dicts; the inputs are not modified."""
    cfg = spec.cfg
    nd = cfg.ndim
    u, bf = dict(u), dict(bf)
    unew = dict(u)
    levels = spec.levels

    def advance(i, dtl):
        l = levels[i]
        d = dev[l]
        dxl = spec.boxlen / (1 << l)
        unew[l] = u[l]
        child_emf = None
        if i + 1 < len(levels):
            e1 = advance(i + 1, 0.5 * dtl)
            e2 = advance(i + 1, 0.5 * dtl)
            if e1 is not None:
                child_emf = 0.5 * (e1 + e2)    # time-averaged fine EMFs
        my_emf = None
        if spec.complete[i]:
            override = None
            plan = dev[levels[i + 1]].get("emf_plan") \
                if child_emf is not None else None
            if plan is not None:
                override = _emf_override(child_emf, plan, 1 << (l * nd),
                                         (1 << l,) * nd)
            du, bf[l] = _complete_level_step(u[l], bf[l], d, dtl, dxl, l,
                                             spec, override)
            unew[l] = unew[l] + du
        else:
            # the blocked tile batch, or the per-oct stencils
            blocked = bool(spec.blocked and spec.blocked[i])
            pre = "b_" if blocked else ""
            icell = d[pre + "interp_cell"]
            interp_u = K.interp_cells(u[l - 1], icell, d[pre + "interp_nb"],
                                      d[pre + "interp_sgn"], cfg,
                                      itype=spec.itype)
            interp_bf = balsara_child_faces(bf[l - 1][icell],
                                            d[pre + "interp_sgn"], nd)
            if blocked:
                du, bfn, corr, my_emf = mhd_tile_sweep(
                    u[l], interp_u, bf[l], interp_bf, d["tile_src"],
                    d["tile_ok"], d["cell_tile"], d["cell_slot"],
                    d["oct_tile"], d["oct_slot"], dtl, dxl, cfg,
                    spec.block_shift)
            else:
                du, bfn, corr, my_emf = mhd_level_sweep(
                    u[l], interp_u, bf[l], interp_bf, d["stencil_src"],
                    d["ok_ref"], dtl, dxl, cfg)
            unew[l] = unew[l] + du
            # staggered B centres are face means, not flux-updated cell
            # variables: excluded; degenerate components (c >= ndim) are
            # conserved and keep theirs
            corr = torch.cat([corr[..., :IBX], torch.zeros_like(
                corr[..., IBX:IBX + nd]), corr[..., IBX + nd:]], dim=-1)
            unew[l - 1] = K.scatter_corrections(unew[l - 1], corr,
                                                d["corr_plan"], cfg)
            bf[l] = bfn
        u[l] = unew[l]
        if i + 1 < len(levels):
            u[l], bf[l] = mhd_restrict_upload(
                u[l], bf[l], u[levels[i + 1]], bf[levels[i + 1]],
                d["ref_cell"], d["son_oct"], cfg)
            unew[l] = u[l]
        return my_emf

    advance(0, dt)
    # degenerate (cell-centred) components ARE the cell value: re-sync
    # their face slots after the corrections and restriction so the next
    # sweep's face-derived centres see the corrected state
    if nd < NCOMP:
        for l in levels:
            ctr = u[l][:, IBX + nd:IBX + NCOMP]
            bf[l] = torch.cat([bf[l][:, :nd],
                               torch.stack([ctr, ctr], dim=-1)], dim=1)
    return u, bf


def _courant(u, bf, dev, spec: FusedSpec):
    """All levels' CFL dts as coarse-step equivalents ``[nlevel]``."""
    return torch.stack([
        mhd_level_courant(u[l], bf[l], dev[l]["valid_cell"],
                          spec.boxlen / (1 << l), spec.cfg)
        * (2.0 ** (l - spec.lmin)) for l in spec.levels])


def _coarse_step(u, bf, dev, dt, spec: FusedSpec):
    """One coarse step and the next step's Courant dt (0-d device
    tensor)."""
    u, bf = _advance(u, bf, dev, dt, spec)
    return u, bf, torch.min(_courant(u, bf, dev, spec))


def _multi_step(u, bf, dev, t, tend, dt0, spec: FusedSpec, nsteps: int):
    """``nsteps`` coarse steps with the time bookkeeping on the device (f64
    ``t``, ``tend``, ``dt0``; the state in its own dtype); steps past
    ``tend`` are no-ops.  Returns ``(u, bf, t, dt_next, n_done)``."""
    dtc = dt0
    ndone = torch.zeros((), dtype=torch.int64, device=t.device)
    sdtype = u[spec.lmin].dtype
    for _ in range(nsteps):
        dt = torch.minimum(dtc, torch.clamp(tend - t, min=0.0))
        active = t < tend
        un, bfn, dtn = _coarse_step(
            u, bf, dev, torch.where(active, dt, 0.0).to(sdtype), spec)
        u = {l: torch.where(active, un[l], u[l]) for l in u}
        bf = {l: torch.where(active, bfn[l], bf[l]) for l in bf}
        t = torch.where(active, t + dt, t)
        dtc = torch.where(active, dtn.to(dtc.dtype), dtc)
        ndone = ndone + active.to(torch.int64)
    return u, bf, t, dtc, ndone


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

class MhdAmrSim(AmrSim):
    """Adaptive MHD simulation (CT and div-free AMR transfer operators).

    Reuses the hydro hierarchy's octree, index maps, regrid and evolve
    loop; adds the staggered face state ``self.bfs`` and overrides the
    step, the CFL, the refinement criteria, and the migration and
    restriction to carry it.  Runs on CUDA unless ``device="cpu"`` is
    given."""

    _needs_mig_log = True
    _pm_physics = False

    @classmethod
    def _unported(cls, params: Params) -> list:
        from ramses_tpu_torch.mhd.driver import unported_mhd_features
        return unported_mhd_features(params)

    def __init__(self, params: Params, dtype=torch.float32, device=None,
                 **kw):
        self.mcfg = MhdStatic.from_params(params)
        for lo, hi in bmod.BoundarySpec.from_params(params).kinds:
            for k in (lo, hi):
                if k not in (bmod.PERIODIC, bmod.OUTFLOW):
                    raise NotImplementedError(
                        "MHD-AMR boundaries: periodic/outflow only")
        self._regridding = False
        super().__init__(params, dtype=dtype, device=device, **kw)

    @classmethod
    def from_state(cls, params: Params, tree_og: Dict[int, np.ndarray],
                   rows: Dict[int, np.ndarray], bfs: Dict[int, np.ndarray],
                   **kw) -> "MhdAmrSim":
        """:meth:`AmrSim.from_state` with the face rows ``bfs`` (per level
        ``[>= ncell, 3, 2]``, e.g. from
        :func:`ramses_tpu_torch.convert.mhd_amr_state_from`)."""
        sim = super().from_state(params, tree_og, rows, **kw)
        for l in sim.levels():
            sim.bfs[l] = sim._rows_from(sim.bfs[l], bfs[l], l)
        return sim

    # ---- state allocation -------------------------------------------
    def _mhd_region_state(self, lvl: int):
        """(u rows, bf rows) from &INIT_PARAMS regions (the uniform driver's
        ``mhd_condinit`` semantics on an arbitrary cell list)."""
        from ramses_tpu_torch.mhd.driver import _region_mask
        init = self.params.init
        cfg = self.mcfg
        m = self.maps[lvl]
        centers = self.tree.cell_centers(lvl, self.boxlen)
        x = [centers[:, d] for d in range(cfg.ndim)]
        n = len(centers)
        q = np.zeros((cfg.nvar, n))
        q[0] = cfg.smallr
        q[IP] = cfg.smallr * cfg.smallc ** 2 / cfg.gamma
        bf = np.zeros((n, NCOMP, 2))
        vels = [init.u_region, init.v_region, init.w_region]
        bvals = [init.A_region, init.B_region, init.C_region]
        for k in range(init.nregion):
            if str(init.region_type[k]).strip() != "square":
                raise NotImplementedError("mhd ICs: square regions only")
            msk = _region_mask(x, k, init, cfg.ndim)
            q[0][msk] = init.d_region[k]
            for c in range(NCOMP):
                q[1 + c][msk] = vels[c][k]
                bf[msk, c, 0] = bvals[c][k]
                bf[msk, c, 1] = bvals[c][k]
            q[IP][msk] = init.p_region[k]
        for c in range(NCOMP):
            q[IBX + c] = 0.5 * (bf[:, c, 0] + bf[:, c, 1])
        u = core.prim_to_cons(torch.from_numpy(q), cfg).numpy().T
        u_pad = np.zeros((m.ncell_pad, cfg.nvar))
        u_pad[:n] = u
        u_pad[n:, 0] = cfg.smallr
        u_pad[n:, IP] = cfg.smallr * cfg.smallc ** 2 / cfg.gamma
        bf_pad = np.zeros((m.ncell_pad, NCOMP, 2))
        bf_pad[:n] = bf
        return self._dev(u_pad, self.dtype), self._dev(bf_pad, self.dtype)

    def _alloc_from_ics(self):
        self.u, self.bfs = {}, {}
        for l in self.levels():
            self.u[l], self.bfs[l] = self._mhd_region_state(l)
        self._restrict_all()
        self._dt_cache = None

    # ---- maps ----------------------------------------------------------
    def _donor_maps(self, l: int, new_octs) -> np.ndarray:
        """Per new oct: flat cell index of the existing (OLD) fine
        neighbour owning each outer sub-face, -1 where none —
        ``[nnew, nd, 2, nsub]``.  The donor's stored face on the shared side
        is copied verbatim (``interpol_mag``'s use of fine neighbour faces),
        so duplicated faces stay single-valued."""
        nd = self.tree_ndim
        tree = self.tree
        og = tree.levels[l].og[new_octs]                # [nnew, nd]
        nnew = len(og)
        nsub = 2 ** (nd - 1)
        is_new = np.zeros(tree.noct(l), dtype=bool)
        is_new[new_octs] = True
        offs = np.indices((2,) * nd).reshape(nd, -1).T
        out = np.full((nnew, nd, 2, nsub), -1, dtype=np.int64)
        nmax = 1 << l
        for d in range(nd):
            for s in (0, 1):
                for k, off in enumerate(offs[offs[:, d] == s]):
                    nq = 2 * og + off                   # fine cell coords
                    nq[:, d] += 2 * s - 1
                    nqm, _ = map_coords(nq, l, self.bc_kinds, nd)
                    valid = np.ones(nnew, dtype=bool)
                    for dd in range(nd):
                        if self.bc_kinds[dd] != (0, 0):
                            valid &= (nq[:, dd] >= 0) & (nq[:, dd] < nmax)
                    doct = tree.lookup(l, nqm >> 1)
                    ok = (doct >= 0) & valid
                    ok &= ~is_new[np.clip(doct, 0, None)]
                    doff = np.zeros(nnew, dtype=np.int64)
                    for dd in range(nd):
                        doff = doff * 2 + (nqm[:, dd] & 1)
                    out[:, d, s, k] = np.where(ok, doct * 2 ** nd + doff, -1)
        return out

    def _rebuild_maps(self, *a, **k):
        super()._rebuild_maps(*a, **k)
        self._build_emf_maps()

    def emf_dense_idx(self, l: int) -> Optional[np.ndarray]:
        """Scatter targets of the coarse-fine EMF matching for a PARTIAL
        level ``l`` whose parent level is complete: ``[noct_pad, npairs, 2,
        2]``, each fine oct's father-cell edge corners as C-order indices of
        the parent's dense corner lattice (corner of cell (i, j, …) ↔
        position (i, j, …)); ``ncell(l-1)`` marks a corner outside the
        domain (non-periodic walls), a pad oct, or a shared corner's
        duplicate writer (only the first oct in enumeration order writes).
        None where the level has no such map."""
        nd = self.tree_ndim
        pairs = _pairs(nd)
        if (not pairs or l == self.lmin or self.maps[l].complete
                or not self.maps[l - 1].complete):
            return None
        og = self.tree.levels[l].og                     # father cells, l-1
        noct = len(og)
        n1 = 1 << (l - 1)
        ncell1 = n1 ** nd
        idx = np.full((self.maps[l].noct_pad, len(pairs), 2, 2), ncell1,
                      dtype=np.int64)
        for pi, (d1, d2) in enumerate(pairs):
            for o1 in (0, 1):
                for o2 in (0, 1):
                    cc = og.copy()
                    cc[:, d1] += o1
                    cc[:, d2] += o2
                    oob = np.zeros(noct, dtype=bool)
                    for dd in range(nd):
                        if self.bc_kinds[dd] == (0, 0):
                            cc[:, dd] %= n1
                        else:
                            oob |= (cc[:, dd] < 0) | (cc[:, dd] >= n1)
                            cc[:, dd] = np.clip(cc[:, dd], 0, n1 - 1)
                    flat = np.ravel_multi_index(
                        tuple(cc[:, dd] for dd in range(nd)), (n1,) * nd)
                    idx[:noct, pi, o1, o2] = np.where(oob, ncell1, flat)
            # shared corners are written by up to 2^(nd-1) fine octs whose
            # values agree only to roundoff: keep ONE canonical writer
            # (first in oct enumeration) so the scatter is order-free
            v = idx[:noct, pi].reshape(-1).copy()
            _, first = np.unique(v, return_index=True)
            dup = np.ones(v.size, dtype=bool)
            dup[first] = False
            oi, a1, a2 = np.unravel_index(np.flatnonzero(dup), (noct, 2, 2))
            idx[oi, pi, a1, a2] = ncell1
        return idx

    def _build_emf_maps(self):
        """Per partial level with a complete parent, the device plan of its
        EMF override (:func:`_emf_override`): per pair the valid dense
        targets, their source rows in ``child_emf[:, pair].reshape(-1)``,
        and the dense mask — the JAX package's ``mode="drop"`` scatter with
        the dropped targets filtered out here."""
        for l in self.levels():
            d = self.dev[l]
            idx = self.emf_dense_idx(l)
            if idx is None:
                d.pop("emf_plan", None)
                continue
            ncell1 = 1 << ((l - 1) * self.tree_ndim)
            shape = (1 << (l - 1),) * self.tree_ndim
            plan = []
            for pi in range(idx.shape[1]):
                v = idx[:, pi].reshape(-1)
                sel = np.flatnonzero(v < ncell1)
                msk = np.zeros(ncell1, dtype=bool)
                msk[v[sel]] = True
                plan.append((self._dev(v[sel]), self._dev(sel),
                             self._dev(msk.reshape(shape))))
            d["emf_plan"] = tuple(plan)

    # ---- transfer operators ------------------------------------------
    def _restrict_all(self):
        # during the base class's regrid u is migrated before bf: skip its
        # restriction and run it after the bf migration
        if not hasattr(self, "bfs") or self._regridding:
            return
        for l in sorted(self.levels(), reverse=True):
            if self.tree.has(l + 1):
                d = self.dev[l]
                self.u[l], self.bfs[l] = mhd_restrict_upload(
                    self.u[l], self.bfs[l], self.u[l + 1], self.bfs[l + 1],
                    d["ref_cell"], d["son_oct"], self.mcfg)

    def regrid(self):
        """The base class's regrid (flag, new tree, u migration), then the
        face migration replayed from its log: surviving octs copy their
        faces, new octs take the Balsara faces matched to their OLD fine
        neighbours; then the centred B from the migrated faces, then the
        restriction."""
        old_bf = dict(self.bfs)
        oldtree = self.tree
        self._regridding = True
        try:
            super().regrid()
        finally:
            self._regridding = False
        if self.tree is oldtree and not self._mig_log:
            return                                     # unchanged
        nd = self.mcfg.ndim
        ttd = 2 ** nd
        new_bf: Dict[int, torch.Tensor] = {}
        for l in self.levels():
            info = self._mig_log.get(l)
            if info is None:
                new_bf[l] = old_bf[l]
                continue
            copy_dst, copy_src, new_octs, f_cell, ncell_pad = info
            oct_ar = np.arange(ttd)
            buf = torch.zeros((ncell_pad, NCOMP, 2), dtype=self.dtype,
                              device=self.device)
            if len(copy_dst):
                rows_d = (copy_dst.astype(np.int64)[:, None] * ttd
                          + oct_ar).reshape(-1)
                rows_s = (copy_src.astype(np.int64)[:, None] * ttd
                          + oct_ar).reshape(-1)
                buf.index_copy_(0, self._dev(rows_d),
                                old_bf[l].index_select(0, self._dev(rows_s)))
            if len(new_octs):
                donor = self._donor_maps(l, new_octs)  # [nnew, nd, 2, nsub]
                father = new_bf[l - 1].index_select(
                    0, self._dev(f_cell.astype(np.int64)))
                outer = []
                for d in range(nd):
                    per_s = []
                    for s in (0, 1):
                        di = self._dev(donor[:, d, s])          # [nnew, nsub]
                        val = buf[torch.clamp(di, min=0), d, 1 - s]
                        inj = father[:, d, s][:, None]
                        per_s.append(torch.where(di >= 0, val, inj))
                    outer.append(torch.stack(per_s, dim=1))
                vals = matched_child_faces(father, torch.stack(outer, dim=1),
                                           nd)
                rows_new = (new_octs.astype(np.int64)[:, None] * ttd
                            + oct_ar).reshape(-1)
                buf.index_copy_(0, self._dev(rows_new), vals.to(self.dtype))
            new_bf[l] = buf
            # the stored centred B from the div-free migrated faces: the
            # conservative interpolation of u's B slots is not the face mean
            ctr = 0.5 * (buf[:, :, 0] + buf[:, :, 1])
            self.u[l] = torch.cat([self.u[l][:, :IBX], ctr.to(self.dtype),
                                   self.u[l][:, IBX + NCOMP:]], dim=1)
        self.bfs = new_bf
        self._restrict_all()
        self._dt_cache = None

    # ---- refinement criteria -----------------------------------------
    def _criteria_flags(self, spec: FusedSpec):
        r = self.params.refine
        eg = (float(r.err_grad_d), float(r.err_grad_p), float(r.err_grad_b))
        fls = (float(r.floor_d), float(r.floor_p), float(r.floor_b))
        return _mhd_fused_flags(self.u, self.dev, spec, eg, fls)

    # ---- stepping ------------------------------------------------------
    def _fused_spec(self) -> FusedSpec:
        if self._spec is None:
            self._spec = super()._fused_spec()._replace(cfg=self.mcfg)
        return self._spec

    def coarse_dt(self) -> float:
        if self._dt_cache is not None:
            return float(self._dt_cache)
        return float(torch.min(_courant(self.u, self.bfs, self.dev,
                                        self._fused_spec())))

    def step_coarse(self, dt: float):
        self.u, self.bfs, self._dt_cache = _coarse_step(
            self.u, self.bfs, self.dev,
            torch.tensor(float(dt), dtype=self.dtype, device=self.device),
            self._fused_spec())
        self.t += float(dt)
        self.dt_old = float(dt)
        self.nstep += 1

    def step_chunk(self, nsteps: int, tend: float) -> int:
        spec = self._fused_spec()
        f64 = dict(dtype=torch.float64, device=self.device)
        dt0 = (self._dt_cache if self._dt_cache is not None
               else torch.min(_courant(self.u, self.bfs, self.dev, spec))
               ).to(**f64)
        u, bf, t, dtn, ndone = _multi_step(
            self.u, self.bfs, self.dev, torch.tensor(self.t, **f64),
            torch.tensor(float(tend), **f64), dt0, spec, nsteps)
        self.u, self.bfs, self._dt_cache = u, bf, dtn
        t_host, dt_host, n = torch.stack([t, dtn, ndone.to(t.dtype)]) \
            .cpu().tolist()
        self.t, self.dt_old = t_host, dt_host
        self.nstep += int(n)
        return int(n)

    # ---- diagnostics ---------------------------------------------------
    def totals(self) -> dict:
        """Conservation audit over leaf cells in f64 on the host: mass,
        the three momentum components, total energy."""
        tot = np.zeros(self.mcfg.nvar)
        for l in self.levels():
            u = self.tree_order_cells(self.u[l], l)
            leaf = ~self.tree.refined_mask(l)
            tot += u[leaf].sum(axis=0) * self.dx(l) ** self.tree_ndim
        return {"mass": tot[0], "momentum": list(tot[1:1 + NCOMP]),
                "energy": tot[IP]}

    def divb_levels(self) -> Dict[int, float]:
        """Per level, max |div B| over its leaf cells over ``max|B| / dx``
        (the duplicated-face staggered divergence; 0.0 for a level without
        leaves)."""
        out = {}
        for l in self.levels():
            dxl = self.dx(l)
            bf = self.tree_order_cells(self.bfs[l], l)
            leaf = ~self.tree.refined_mask(l)
            div = sum((bf[:, d, 1] - bf[:, d, 0]) / dxl
                      for d in range(self.tree_ndim))
            bscale = np.abs(bf).max() / dxl + 1e-300
            out[l] = (float(np.abs(div[leaf]).max()) / bscale if leaf.any()
                      else 0.0)
        return out

    def max_divb(self) -> float:
        """Max of :meth:`divb_levels`.  Zero to roundoff under CT and the
        div-free transfer on complete levels and on a partial level whose
        parent is complete and which has no finer level.  A partial level
        with finer levels keeps its own EMFs (no coarse-fine matching: the
        JAX package's first-order coupling), so the restricted faces its
        leaves step from next to refined cells drift from its own, and
        faces migrated below it inherit the mismatch (ROADMAP §C3)."""
        return max(self.divb_levels().values())

    # ---- snapshot / restart --------------------------------------------
    def dump(self, iout: int = 1, base_dir: str = ".", namelist_path=None,
             ncpu: int = 1) -> str:
        """Reference-format snapshot with the MHD column set (density,
        velocity, B_left/right faces, pressure —
        ``mhd/output_hydro.f90:82-150``); the duplicated staggered faces
        round-trip exactly."""
        from ramses_tpu_torch.io import snapshot as snapmod
        snap = snapmod.snapshot_from_mhd_amr(self, iout)
        return snapmod.dump_all(snap, iout, base_dir,
                                namelist_path=namelist_path, ncpu=ncpu)

    @classmethod
    def from_snapshot(cls, params: Params, outdir: str, dtype=torch.float32,
                      device=None, **kw) -> "MhdAmrSim":
        """Resume from an MHD snapshot (``mhd/init_hydro.f90`` restart
        read: the face fields come back verbatim, the cell-centred B is
        their mean)."""
        from ramses_tpu_torch.amr.hierarchy import restore_amr_scaffold
        from ramses_tpu_torch.io.snapshot import mhd_out_to_state
        mcfg = MhdStatic.from_params(params)
        ttd = 2 ** params.ndim

        def place(sim, l, q, og, order):
            u_rows, bf_rows = mhd_out_to_state(q, mcfg)
            n = len(og) * ttd
            u_out, bf_out = sim.u[l].clone(), sim.bfs[l].clone()
            u_out[:n] = torch.as_tensor(
                u_rows.reshape(len(og), ttd, mcfg.nvar)[order]
                .reshape(-1, mcfg.nvar), dtype=sim.dtype, device=sim.device)
            bf_out[:n] = torch.as_tensor(
                bf_rows.reshape(len(og), ttd, 3, 2)[order]
                .reshape(-1, 3, 2), dtype=sim.dtype, device=sim.device)
            sim.u[l], sim.bfs[l] = u_out, bf_out

        return restore_amr_scaffold(cls, params, outdir, dtype,
                                    to_cons=lambda q: q, place_level=place,
                                    device=device, **kw)

    def max_face_gap(self) -> float:
        """Largest |difference| between the two stored copies of a face
        shared by two leaf cells of the same level (0 when the duplicated
        faces are single-valued, the invariant div B rests on)."""
        nd = self.tree_ndim
        ttd = 2 ** nd
        worst = 0.0
        for l in self.levels():
            bf = self.tree_order_cells(self.bfs[l], l)
            leaf = ~self.tree.refined_mask(l)
            cc = self.tree.cell_coords(l)
            for d in range(nd):
                nb = cc.copy()
                nb[:, d] += 1
                nbm, _ = map_coords(nb, l, self.bc_kinds, nd)
                inside = (nb[:, d] < 1 << l) | (self.bc_kinds[d] == (0, 0))
                noct = self.tree.lookup(l, nbm >> 1)
                off = np.zeros(len(cc), dtype=np.int64)
                for dd in range(nd):
                    off = off * 2 + (nbm[:, dd] & 1)
                j = noct * ttd + off
                pair = inside & (noct >= 0) & leaf
                pair[pair] &= leaf[j[pair]]
                if pair.any():
                    gap = np.abs(bf[pair, d, 1] - bf[j[pair], d, 0]).max()
                    worst = max(worst, float(gap))
        return worst
