"""Device sweeps of the AMR hydro step (PyTorch).

Port of ``ramses_tpu/amr/kernels.py`` for pure hydro.  One level-step is
interp (buffer prolongation) → gather → unsplit MUSCL-Hancock →
refined-face flux zeroing → conservative update + coarse flux-correction
scatter: the whole of ``godfine1`` (``hydro/godunov_fine.f90:486-910``)
over the level's batch of octs.

Each sweep dispatches by configuration only, as the JAX package does:
where a kernel's ``supports()`` covers it (3D f32 hydro), complete levels
go through K1 (:func:`ramses_tpu_torch.hydro.fused_muscl.fused_step`),
blocked partial levels through K3 and stencil partial levels through K2
(:mod:`ramses_tpu_torch.hydro.oct_muscl`); everything else runs the port
of the general formulation (``hydro/muscl.unsplit``), the counterpart of
the JAX package's XLA path.  Nothing here synchronises with the host.

Two differences from the JAX functions, both about scatters:

* :func:`restrict_upload` takes the valid prefix of the restriction map
  only.  The JAX function clamps its pad rows (``ref_cell = -1``) to
  cell 0 and writes back the old ``u[0]``, which on XLA:CPU's
  last-write-wins scatter overwrites cell 0's restriction whenever that
  cell is refined (ROADMAP §C).
* :func:`scatter_corrections` and :func:`scatter_corr_flux` add each
  coarse target's values in ascending update order through host-built
  tables of the valid targets only (:func:`corr_plan`), the order of
  XLA:CPU's sequential scatter-add, instead of atomics whose order
  changes from run to run.

With ``ret_flux`` every sweep also returns the MC gas tracers' capture
``phi [ncell_pad, ndim, 2]``: the dt/dx-scaled mass flux through each
cell's (low, high) face, refined faces zeroed, pad rows exactly 0 (the
kernels' ``want_flux`` output where they run).  The SRHD dispatch is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace as dreplace
from typing import Tuple

import numpy as np
import torch

from ramses_tpu_torch.amr import bitperm
from ramses_tpu_torch.grid import boundary as bmod
from ramses_tpu_torch.hydro import fused_muscl as fm
from ramses_tpu_torch.hydro import muscl
from ramses_tpu_torch.hydro import oct_muscl as om
from ramses_tpu_torch.hydro.core import HydroStatic
from ramses_tpu_torch.hydro.timestep import cell_dt

_NG = 2                                   # tile halo width (MUSCL stencil)


def pow2_cube(shape) -> bool:
    """True when every dim equals the same power of two: the complete
    cubic level whose flat↔dense map is :mod:`bitperm`'s."""
    s0 = shape[0]
    return (s0 & (s0 - 1)) == 0 and all(s == s0 for s in shape)


def _dense_rows_index(inv_perm, shape, device):
    """Flat row of each dense cell (C order): bitperm's on cubic
    power-of-two levels, ``inv_perm`` otherwise."""
    if pow2_cube(shape):
        return bitperm.indices(shape[0].bit_length() - 1, len(shape),
                               device)[0]
    if inv_perm is None:
        raise ValueError(f"non-cubic complete level {shape} needs an "
                         "inv_perm index map")
    return inv_perm


def _flat_dense_index(perm, shape, device):
    """Dense index of each flat row (inverse of :func:`_dense_rows_index`)."""
    if pow2_cube(shape):
        return bitperm.indices(shape[0].bit_length() - 1, len(shape),
                               device)[1]
    if perm is None:
        raise ValueError(f"non-cubic complete level {shape} needs a "
                         "perm index map")
    return perm


def rows_to_dense(rows, inv_perm, shape):
    """Flat-order rows ``[ncell(+pad), *trailing]`` → dense
    ``[*shape, *trailing]``: :mod:`bitperm` on cubic power-of-two levels,
    a gather through ``inv_perm`` otherwise."""
    if pow2_cube(shape):
        return bitperm.flat_to_dense(rows, shape[0].bit_length() - 1,
                                     len(shape))
    return rows.index_select(0, inv_perm).reshape(tuple(shape)
                                                  + rows.shape[1:])


def dense_to_rows(dense, perm, shape):
    """Dense ``[*shape, *trailing]`` → flat-order rows (inverse of
    :func:`rows_to_dense`)."""
    nd = len(shape)
    if pow2_cube(shape):
        return bitperm.dense_to_flat(dense, shape[0].bit_length() - 1, nd)
    ncell = int(np.prod(shape))
    return dense.reshape((ncell,) + dense.shape[nd:]).index_select(0, perm)


def _rows_to_vars(u_flat, inv_perm, shape):
    """Flat rows ``[ncell(+pad), nvar]`` → contiguous dense
    ``[nvar, *shape]`` in one gather."""
    idx = _dense_rows_index(inv_perm, shape, u_flat.device)
    return u_flat.t().index_select(1, idx).reshape(
        (u_flat.shape[1],) + tuple(shape))


def _vars_to_rows(dense, perm, shape, nrows: int):
    """Dense ``[nvar, *shape]`` → flat rows ``[nrows, nvar]``, pad rows
    zero."""
    idx = _flat_dense_index(perm, shape, dense.device)
    nvar = dense.shape[0]
    rows = dense.reshape(nvar, -1).index_select(1, idx).t()
    if nrows > rows.shape[0]:
        rows = torch.cat([rows, rows.new_zeros(nrows - rows.shape[0], nvar)])
    return rows


def interp_cells(u_coarse, cell_idx, nb_idx, sgn, cfg: HydroStatic,
                 itype: int = 1):
    """Prolongation values for requested fine cells (``interpol_hydro``
    with interpol_var=0, ``hydro/interpol_hydro.f90:268-391``): fine =
    a0 + Σ_d w_d·(±0.5), w from the limiter on the father's face-neighbour
    differences.

    u_coarse: [ncell, nvar]; cell_idx: [ni]; nb_idx: [ni, ndim, 2];
    sgn: [ni, ndim] ±1.  Returns [ni, nvar].
    """
    a0 = u_coarse[cell_idx]
    out = a0
    if itype == 0:
        return out
    for d in range(cfg.ndim):
        al = u_coarse[nb_idx[:, d, 0]]
        ar = u_coarse[nb_idx[:, d, 1]]
        dl = 0.5 * (a0 - al)
        dr = 0.5 * (ar - a0)
        if itype == 1:
            w = torch.where(dl * dr <= 0.0, 0.0,
                            torch.sign(dr) * torch.minimum(torch.abs(dl),
                                                           torch.abs(dr)))
        elif itype == 3:
            w = 0.25 * (ar - al)
        else:  # itype 2: per-dim monotonized central
            dc = 0.25 * (ar - al)
            lim = torch.minimum(2.0 * torch.abs(dl), 2.0 * torch.abs(dr))
            w = torch.where(dl * dr <= 0.0, 0.0,
                            torch.sign(dc) * torch.minimum(torch.abs(dc),
                                                           lim))
        out = out + w * (0.5 * sgn[:, d:d + 1])
    return out


def _gather(u_flat, interp_vals, src_idx, vsgn, cfg: HydroStatic, side: int,
            batch_first: bool = False):
    """``[nvar, side^d..., nblock]`` batch from flat cells + interps + one
    zero trash row, or with ``batch_first`` ``[nvar, nblock, side^d...]``
    (K3's tile-major layout), each written in that order by one gather;
    ``src_idx``/``vsgn``: ``[nblock, side^d]``."""
    trash = u_flat.new_zeros((1, cfg.nvar))
    src = torch.cat([u_flat, interp_vals.to(u_flat.dtype), trash])
    idx = src_idx if batch_first else src_idx.t()
    ul = src.t().index_select(1, idx.reshape(-1)).reshape(
        (cfg.nvar,) + tuple(idx.shape))
    if vsgn is not None:
        # reflecting boundaries: flip mirrored velocity components
        vt = (vsgn if batch_first else vsgn.t()).to(torch.int64)
        for d in range(cfg.ndim):
            flip = ((vt >> d) & 1).to(u_flat.dtype)
            ul[1 + d] = ul[1 + d] * (1.0 - 2.0 * flip)
    nb, cells = src_idx.shape[0], (side,) * cfg.ndim
    return ul.reshape((cfg.nvar,) + ((nb,) + cells if batch_first
                                     else cells + (nb,)))


def _gather_uloc(u_flat, interp_vals, stencil_src, vsgn, cfg: HydroStatic):
    """The per-oct 6^d stencil batch ``[nvar, 6..., noct]``."""
    return _gather(u_flat, interp_vals, stencil_src, vsgn, cfg, 6)


def _gather_utile(u_flat, interp_vals, tile_src, tile_vsgn,
                  cfg: HydroStatic, td: int):
    """The compact blocked tile batch ``[nvar, td..., ntile]``."""
    return _gather(u_flat, interp_vals, tile_src, tile_vsgn, cfg, td)


def _gather_tiles(u_flat, interp_vals, tile_src, tile_vsgn,
                  cfg: HydroStatic, td: int):
    """K3's tile batch ``[nvar, ntile, td...]``: :func:`_gather_utile`'s
    values with the batch axis just before the cell axes."""
    return _gather(u_flat, interp_vals, tile_src, tile_vsgn, cfg, td,
                   batch_first=True)


def _flat_cells(blk, ndim: int):
    """``[2..., noct]`` per-cell block → flat ``[noct·2^d]`` row order."""
    noct = blk.shape[-1]
    return blk.permute((ndim,) + tuple(range(ndim))).reshape(
        noct * 2 ** ndim)


def _block_mask(ok_rows, side: int, ndim: int):
    """``[nblock, side^d]`` bool rows → ``[side..., nblock]``."""
    return ok_rows.t().reshape((side,) * ndim + (ok_rows.shape[0],))


def _general_update(ub, okl, dt, dx: float, cfg: HydroStatic, core: int):
    """The general formulation on a gathered batch: masked fluxes
    (``[ndim, nvar, ...]``, ×dt/dx) and the interior update of the
    ``core^d`` cells starting at index 2."""
    nd = cfg.ndim
    bcfg = dreplace(cfg, trailing_batch=True)
    flux, tmp = muscl.unsplit(ub, None, dt, (dx,) * nd, bcfg)
    fluxes, tmps = [], []
    for d in range(nd):
        keep = (~(okl | torch.roll(okl, 1, dims=d)))[None].to(flux.dtype)
        fluxes.append(flux[d] * keep)
        tmps.append(tmp[d] * keep)
    fluxes = torch.stack(fluxes)
    un = muscl.apply_fluxes(ub, fluxes, bcfg)
    if cfg.pressure_fix or cfg.nener:
        un = muscl.dual_energy_fix(ub, un, torch.stack(tmps), dt,
                                   (dx,) * nd, bcfg)
    interior = (slice(None),) + (slice(2, 2 + core),) * nd
    return fluxes, un[interior] - ub[interior]


def level_sweep(u_flat, interp_vals, stencil_src, vsgn, ok_ref, dt,
                dx: float, cfg: HydroStatic, ret_flux: bool = False):
    """Full godfine1 for one partial level on per-oct stencils.

    Returns ``(du_flat [ncell, nvar], corr [noct, ndim, 2, nvar])``;
    ``corr[:, d, side]`` is the summed boundary flux (already ×dt/dx) to
    be scattered ∓/2^ndim into unrefined coarse neighbours.  ``ret_flux``
    appends the per-cell face mass fluxes ``phi [ncell, ndim, 2]``.  K2
    where it covers the configuration.
    """
    nd, nvar = cfg.ndim, cfg.nvar
    uloc = _gather_uloc(u_flat, interp_vals, stencil_src, vsgn, cfg)
    noct = uloc.shape[-1]
    okl = _block_mask(ok_ref, 6, nd)
    cells = (nd + 1,) + tuple(range(1, nd + 1)) + (0,)
    if om.supports(cfg, u_flat.dtype):
        out = om.oct_sweep(uloc, okl.to(uloc.dtype),
                           torch.as_tensor(dt, dtype=uloc.dtype,
                                           device=uloc.device),
                           cfg, dx, want_flux=ret_flux)
        du_flat = out[0].permute(cells).reshape(noct * 2 ** nd, nvar)
        corr = out[1].permute(3, 1, 2, 0)
        if not ret_flux:
            return du_flat, corr
        # phi [3, 2, 2, 2, 2, N] (d, side, cell) → flat [ncell, 3, 2]
        return du_flat, corr, out[2].permute(5, 2, 3, 4, 0, 1).reshape(
            noct * 2 ** nd, nd, 2)
    fluxes, du = _general_update(uloc, okl, dt, dx, cfg, 2)
    du_flat = du.permute(cells).reshape(noct * 2 ** nd, nvar)
    corr = []
    for d in range(nd):
        f = fluxes[d]
        sides = []
        for pos in (2, 4):
            ix = (slice(None),) + tuple(pos if d2 == d else slice(2, 4)
                                        for d2 in range(nd))
            red = tuple(range(1, nd))
            sides.append(f[ix].sum(dim=red) if nd > 1 else f[ix])
        corr.append(torch.stack(sides, dim=-1))        # [nvar, noct, 2]
    corr = torch.stack(corr, dim=-2)                   # [nvar, noct, nd, 2]
    corr = torch.movedim(corr, 0, -1)
    if not ret_flux:
        return du_flat, corr
    # a cell at stencil position i along d has its low face flux at
    # index i, its high face at i + 1
    phis = []
    for d in range(nd):
        f0 = fluxes[d][0]
        lo_ix = (slice(2, 4),) * nd
        hi_ix = tuple(slice(3, 5) if dd == d else slice(2, 4)
                      for dd in range(nd))
        phis.append(torch.stack([_flat_cells(f0[lo_ix], nd),
                                 _flat_cells(f0[hi_ix], nd)], dim=-1))
    return du_flat, corr, torch.stack(phis, dim=-2)


# ---------------------------------------------------------------------------
# Blocked Morton tile sweep
# ---------------------------------------------------------------------------

def _face_planes(fl, d, ndim: int, c: int):
    """Per-oct-face flux planes of masked flux ``fl [nvar, td..., ntile]``
    along d: ``[nvar, c//2+1, c...(transverse), ntile]``."""
    idx = [slice(None)]
    for dd in range(ndim):
        idx.append(slice(_NG, _NG + c + 1, 2) if dd == d
                   else slice(_NG, _NG + c))
    return torch.movedim(fl[tuple(idx)], 1 + d, 1)


def _mass_planes(f0, d, ndim: int, c: int):
    """All ``c+1`` cell-face planes of the mass flux ``f0 [td...,
    ntile]`` along d: ``[c+1, c...(transverse), ntile]``."""
    idx = tuple(slice(_NG, _NG + c + 1) if dd == d else slice(_NG, _NG + c)
                for dd in range(ndim))
    return torch.movedim(f0[idx], d, 0)


def _corr_from_planes(planes, d, ndim: int, c: int):
    """Per-oct boundary-flux sums from tile-major face planes ``[nvar,
    ntile, c//2+1, c...(transverse)]``: (lo, hi), each ``[nvar, ntile,
    (c//2)^ndim]`` in global dim order."""
    o = c // 2
    nvar, ntile = planes.shape[:2]
    g = planes.reshape([nvar, ntile, o + 1] + [o, 2] * (ndim - 1))
    g = torch.movedim(g, [4 + 2 * i for i in range(ndim - 1)],
                      list(range(2, ndim + 1)))
    s = g.sum(dim=tuple(range(2, ndim + 1))) if ndim > 1 else g

    def oct_rows(x):
        return torch.movedim(x, 2, 2 + d).reshape(nvar, ntile, o ** ndim)
    return oct_rows(s[:, :, :o]), oct_rows(s[:, :, 1:])


def tile_sweep(u_flat, interp_vals, tile_src, tile_vsgn, tile_ok,
               cell_tile, cell_slot, oct_tile, oct_slot, dt, dx: float,
               cfg: HydroStatic, shift: int, ret_flux: bool = False):
    """Full godfine1 for one blocked partial level (same returns as
    :func:`level_sweep`, ``ret_flux`` included): K3 on the tile-major batch
    ``[nvar, ntile, td...]`` where it covers the configuration, the general
    formulation on the batch-last ``[nvar, td..., ntile]`` otherwise.
    du/corr/phi come back to flat rows by small gathers; pad cell rows
    index an appended zero column, so they are exactly 0."""
    nd, nvar = cfg.ndim, cfg.nvar
    c = 1 << (shift + 1)
    td = c + 2 * _NG
    ntile = tile_src.shape[0]
    if om.supports(cfg, u_flat.dtype) and shift in om.SHIFTS:
        ut = _gather_tiles(u_flat, interp_vals, tile_src, tile_vsgn, cfg, td)
        out = om.tile_sweep(
            ut, tile_ok.reshape((ntile,) + (td,) * nd).to(ut.dtype),
            torch.as_tensor(dt, dtype=ut.dtype, device=ut.device), cfg, dx,
            shift, want_flux=ret_flux)
        du_t = out[0]                                  # [nvar, ntile, c...]
        planes = [out[1][:, d] for d in range(nd)]
        mass = [out[2][d] for d in range(nd)] if ret_flux else None
    else:
        ut = _gather_utile(u_flat, interp_vals, tile_src, tile_vsgn, cfg, td)
        okl = _block_mask(tile_ok, td, nd)
        fluxes, du_t = _general_update(ut, okl, dt, dx, cfg, c)
        du_t = du_t.movedim(-1, 1)
        planes = [_face_planes(fluxes[d], d, nd, c).movedim(-1, 1)
                  for d in range(nd)]
        mass = ([_mass_planes(fluxes[d][0], d, nd, c).movedim(-1, 0)
                 for d in range(nd)] if ret_flux else None)
    # pad rows (slot c^nd) index the appended zero column
    flat_idx = torch.where(cell_slot == c ** nd, ntile * c ** nd,
                           cell_tile.to(torch.int64) * c ** nd + cell_slot)
    du_src = torch.cat([du_t.reshape(nvar, ntile * c ** nd),
                        du_t.new_zeros(nvar, 1)], dim=1)
    du_flat = du_src[:, flat_idx].t()                  # [ncell_pad, nvar]
    corr = []
    for d in range(nd):
        lo, hi = _corr_from_planes(planes[d], d, nd, c)
        corr.append(torch.stack([lo[:, oct_tile, oct_slot],
                                 hi[:, oct_tile, oct_slot]], dim=-1))
    corr = torch.stack(corr, dim=-2)                   # [nvar, noct, nd, 2]
    corr = torch.movedim(corr, 0, -1)
    if not ret_flux:
        return du_flat, corr

    def cell_rows(x, d):                       # [ntile, c (along d), ...]
        x = torch.movedim(x, 1, 1 + d).reshape(ntile * c ** nd)
        return torch.cat([x, x.new_zeros(1)])[flat_idx]
    phi = torch.stack([torch.stack([cell_rows(mass[d][:, :c], d),
                                    cell_rows(mass[d][:, 1:], d)], dim=-1)
                       for d in range(nd)], dim=-2)    # [ncell, nd, 2]
    return du_flat, corr, phi


def tile_refine_flags(u_flat, interp_vals, tile_src, tile_vsgn, cell_tile,
                      cell_slot, err_grad: Tuple[float, float, float],
                      floors: Tuple[float, float, float], cfg: HydroStatic,
                      shift: int):
    """:func:`refine_flags` on the blocked tile batch, reordered to flat
    cell rows ``[noct_pad, 2^d]``."""
    nd = cfg.ndim
    c = 1 << (shift + 1)
    td = c + 2 * _NG
    ut = _gather_utile(u_flat, interp_vals, tile_src, tile_vsgn, cfg, td)
    ntile = ut.shape[-1]
    ok = _grad_flags(ut, err_grad, floors, 0, cfg)
    interior = (slice(_NG, _NG + c),) * nd
    okc = torch.cat([ok[interior].reshape(c ** nd * ntile),
                     ok.new_zeros(1)])
    rows = okc[cell_slot.to(torch.int64) * ntile + cell_tile]
    return rows.reshape(len(cell_slot) // 2 ** nd, 2 ** nd)


# ---------------------------------------------------------------------------
# Complete levels (dense)
# ---------------------------------------------------------------------------

def dense_interior_update(up, okp, dt, dx: float, shape: Tuple[int, ...],
                          cfg: HydroStatic, ret_flux: bool = False):
    """Interior update of a ghost-padded dense level ``up [nvar, *(shape +
    2*NGHOST)]`` in the general formulation; ``okp``: optional refined
    mask over the same padded box in the state dtype.  Returns
    ``du [nvar, *shape]`` (and with ``ret_flux`` ``phi [*shape, ndim,
    2]``, each cell's (low, high) face mass flux ×dt/dx)."""
    nd = cfg.ndim
    flux, tmp = muscl.unsplit(up, None, dt, (dx,) * nd, cfg)
    if okp is not None:
        keep = [((1.0 - okp) * (1.0 - torch.roll(okp, 1, dims=d)))[None]
                for d in range(nd)]
        flux = torch.stack([flux[d] * keep[d] for d in range(nd)])
        tmp = torch.stack([tmp[d] * keep[d] for d in range(nd)])
    un = muscl.apply_fluxes(up, flux, cfg)
    if cfg.pressure_fix or cfg.nener:
        un = muscl.dual_energy_fix(up, un, tmp, dt, (dx,) * nd, cfg)
    du = (bmod.unpad(un, nd, muscl.NGHOST)
          - bmod.unpad(up, nd, muscl.NGHOST))
    if not ret_flux:
        return du
    g = muscl.NGHOST
    phis = []
    for d in range(nd):
        f0 = flux[d][0]
        lo_ix = tuple(slice(g, g + shape[dd]) for dd in range(nd))
        hi_ix = tuple(slice(g + 1, g + 1 + shape[dd]) if dd == d
                      else slice(g, g + shape[dd]) for dd in range(nd))
        phis.append(torch.stack([f0[lo_ix], f0[hi_ix]], dim=-1))
    return du, torch.stack(phis, dim=-2)


def pad_ok_dense(ok_dense, shape: Tuple[int, ...], bc, dtype, ng: int):
    """Dense-ravel refined mask → ghost-padded mask in the state dtype:
    wrapped on a periodic axis, edge-repeated otherwise (the ghosts that
    touch an interior face agree with K1's own mapping for every kind)."""
    okp = ok_dense.to(dtype).reshape(shape)
    for d in range(len(shape)):
        n = shape[d]
        if bc.faces[d][0].kind == bmod.PERIODIC:
            lo, hi = okp.narrow(d, n - ng, ng), okp.narrow(d, 0, ng)
        else:
            reps = [1] * len(shape)
            reps[d] = ng
            lo = okp.narrow(d, 0, 1).repeat(reps)
            hi = okp.narrow(d, n - 1, 1).repeat(reps)
        okp = torch.cat([lo, okp, hi], dim=d)
    return okp


def dense_sweep(u_flat, inv_perm, perm, ok_dense, dt, dx: float,
                shape: Tuple[int, ...], bc, cfg: HydroStatic,
                ret_flux: bool = False):
    """Sweep of a COMPLETE level (covering the whole box) as a dense grid:
    no ghost interpolation and no coarse corrections; faces next to a
    refined cell get no flux.  K1 where it covers the configuration.
    Returns du over the flat level rows, and with ``ret_flux`` also
    ``phi [nrows, ndim, 2]``, each cell's (low, high) face mass flux
    ×dt/dx (pad rows 0)."""
    nd = cfg.ndim
    nrows = u_flat.shape[0]
    ud = _rows_to_vars(u_flat, inv_perm, shape)        # [nvar, *shape]
    phid = None
    if fm.supports(cfg, shape, bc.kinds, ud.dtype):
        ok = ok_dense.reshape(shape) if ok_dense is not None else None
        out = fm.fused_step(ud, torch.as_tensor(dt, dtype=ud.dtype,
                                                device=ud.device),
                            cfg, dx, bc, ok=ok, want_flux=ret_flux)
        un, phid = out if ret_flux else (out, None)
        du = un - ud
        if ret_flux:                                   # [3, 2, *shape]
            phid = phid.reshape((2 * nd,) + tuple(shape))
    else:
        up = bmod.pad(ud, bc, cfg, muscl.NGHOST)
        okp = (pad_ok_dense(ok_dense, shape, bc, up.dtype, muscl.NGHOST)
               if ok_dense is not None else None)
        out = dense_interior_update(up, okp, dt, dx, shape, cfg,
                                    ret_flux=ret_flux)
        du = out[0] if ret_flux else out
        if ret_flux:                                   # [*shape, nd, 2]
            phid = out[1].reshape(tuple(shape) + (2 * nd,)).movedim(-1, 0)
    du_rows = _vars_to_rows(du, perm, shape, nrows)
    if not ret_flux:
        return du_rows
    return du_rows, _vars_to_rows(phid, perm, shape, nrows).reshape(
        nrows, nd, 2)


def dense_refine_flags(u_flat, inv_perm, perm,
                       err_grad: Tuple[float, float, float],
                       floors: Tuple[float, float, float],
                       shape: Tuple[int, ...], bc, cfg: HydroStatic):
    """Gradient refinement criteria of a complete level on the dense grid,
    as flat-cell rows ``[ncell / 2^d, 2^d]``."""
    nd = cfg.ndim
    ncell = int(np.prod(shape))
    up = bmod.pad(_rows_to_vars(u_flat, inv_perm, shape), bc, cfg, 1)
    ok = _grad_flags(up, err_grad, floors, 0, cfg)
    ok = ok[tuple(slice(1, -1) for _ in range(nd))]
    return dense_to_rows(ok, perm, shape).reshape(ncell // 2 ** nd, 2 ** nd)


# ---------------------------------------------------------------------------
# Coarse corrections, restriction, Courant
# ---------------------------------------------------------------------------

@dataclass
class CorrPlan:
    """Fixed-order reduction of one level's coarse flux corrections.

    ``target``: the distinct coarse rows that receive a correction,
    ascending; ``table [ntarget, kmax]``: for each, the indices of its
    updates in ``corr.reshape(-1, nvar)`` row order, ascending, padded
    with ``nupd`` (an appended zero row); ``sign [nupd]``: −1 for a fine
    oct's low face, +1 for its high face."""
    target: torch.Tensor
    table: torch.Tensor
    sign: torch.Tensor
    nupd: int


def corr_plan(corr_idx: np.ndarray, device) -> CorrPlan:
    """Build a :class:`CorrPlan` on the host from ``corr_idx [noct, ndim,
    2]`` (-1: no correction), once per map build."""
    idx = np.asarray(corr_idx).reshape(-1).astype(np.int64)
    upd = np.nonzero(idx >= 0)[0]
    tgt = idx[upd]
    order = np.argsort(tgt, kind="stable")            # by target, then upd
    tgt, upd = tgt[order], upd[order]
    target, start, count = np.unique(tgt, return_index=True,
                                     return_counts=True)
    table = np.full((len(target), int(count.max()) if len(count) else 0),
                    len(idx), dtype=np.int64)
    if len(tgt):
        table[np.repeat(np.arange(len(target)), count),
              np.arange(len(tgt)) - np.repeat(start, count)] = upd
    sign = np.tile([-1.0, 1.0], len(idx) // 2)
    return CorrPlan(torch.from_numpy(target).to(device),
                    torch.from_numpy(table).to(device),
                    torch.from_numpy(sign).to(device), len(idx))


def flux_plan(corr_idx: np.ndarray, device) -> CorrPlan:
    """The :class:`CorrPlan` of :func:`scatter_corr_flux`, built on the
    host from ``corr_idx [noct, ndim, 2]`` once per map build: targets are
    slots of the coarse capture ``phi.reshape(-1)`` (a fine oct's low face,
    side 0, is the coarse neighbour's HIGH face slot, and vice versa),
    updates index ``corr[..., 0].reshape(-1)``; ``sign`` is not read."""
    idx = np.asarray(corr_idx).astype(np.int64)
    nd = idx.shape[1]
    d = np.arange(nd)[None, :, None]
    slot = np.array([1, 0])[None, None, :]
    return corr_plan(np.where(idx >= 0, (idx * nd + d) * 2 + slot, -1),
                     device)


def scatter_corrections(unew_coarse, corr, plan: CorrPlan,
                        cfg: HydroStatic):
    """Add ∓flux/2^ndim into the unrefined coarse neighbour cells
    (``hydro/godunov_fine.f90:795-910``): side 0 (the fine oct's low face,
    the coarse cell's high face) −F, side 1 +F.  Each target's updates are
    added one after another in ascending update order, so the result is
    the same on every run and equals a sequential scatter-add."""
    if plan.target.numel() == 0:
        return unew_coarse
    w = 1.0 / (2 ** cfg.ndim)
    sign = plan.sign.to(unew_coarse.dtype)
    vals = (corr.reshape(-1, cfg.nvar) * (w * sign)[:, None]).to(
        unew_coarse.dtype)
    vals = torch.cat([vals, vals.new_zeros(1, cfg.nvar)])
    acc = unew_coarse.index_select(0, plan.target)
    for k in range(plan.table.shape[1]):
        acc = acc + vals.index_select(0, plan.table[:, k])
    return unew_coarse.index_copy(0, plan.target, acc)


def scatter_corr_flux(phi_coarse, corr, plan: CorrPlan, cfg: HydroStatic):
    """Fold the fine level's boundary mass fluxes into the coarse
    neighbours' face slots of the MC-tracer capture ``phi [ncell, ndim,
    2]`` (``plan`` from :func:`flux_plan`).  A fine oct's faces coincide
    with its parent cell's, so its low-side correction IS the mass flux
    through the unrefined coarse neighbour's high face (and vice versa),
    scaled 1/2^ndim into coarse Δρ units as in
    :func:`scatter_corrections`.  The coarse sweep zeroed those faces
    (refined-adjacent), so this is their only writer."""
    if plan.target.numel() == 0:
        return phi_coarse
    w = 1.0 / (2 ** cfg.ndim)
    vals = (corr[..., 0].reshape(-1) * w).to(phi_coarse.dtype)
    vals = torch.cat([vals, vals.new_zeros(1)])
    flat = phi_coarse.reshape(-1)
    acc = flat.index_select(0, plan.target)
    for k in range(plan.table.shape[1]):
        acc = acc + vals.index_select(0, plan.table[:, k])
    return flat.index_copy(0, plan.target, acc).reshape(phi_coarse.shape)


def restrict_upload(u_level, u_fine, ref_cell, son_oct, cfg: HydroStatic):
    """upload_fine: overwrite refined cells with the mean of their son
    oct's cells (``hydro/interpol_hydro.f90:5-100``).  ``ref_cell`` /
    ``son_oct``: the valid prefix of the level's restriction map
    (``LevelMaps.ref_cell[:nref]``): distinct cells, so the scatter is
    deterministic."""
    if ref_cell.numel() == 0:
        return u_level
    ttd = 2 ** cfg.ndim
    rows = (son_oct.to(torch.int64)[:, None] * ttd
            + torch.arange(ttd, device=son_oct.device)[None, :])
    mean = u_fine[rows].mean(dim=1)
    return u_level.index_copy(0, ref_cell.to(torch.int64),
                              mean.to(u_level.dtype))


def level_courant(u_flat, valid_cell, dx: float, cfg: HydroStatic,
                  fg=None):
    """Min CFL dt over the level's valid cells — ``courant_fine`` (0-d
    device tensor, capped by ``dtmax``).  ``fg [ncell, ndim]``, the
    gravitational acceleration, enables the gravity-strength correction of
    ``cmpdt`` (``hydro/godunov_utils.f90:100-110``)."""
    grav = [fg[:, d] for d in range(cfg.ndim)] if fg is not None else None
    dtc = cell_dt(u_flat.t(), grav, dx, cfg)
    dtc = torch.where(valid_cell, dtc, torch.inf)
    return torch.clamp(torch.min(dtc),
                       max=cfg.courant_factor * dx / cfg.smallc)


# ---------------------------------------------------------------------------
# Refinement criteria
# ---------------------------------------------------------------------------

def refine_flags(u_flat, interp_vals, stencil_src, vsgn,
                 err_grad: Tuple[float, float, float],
                 floors: Tuple[float, float, float], cfg: HydroStatic):
    """Per-cell gradient refinement criteria — ``hydro_refine``
    (``hydro/godunov_utils.f90:125-260``) on the per-oct stencils.
    Returns bool flags ``[noct, 2^d]`` in flat-cell order."""
    uloc = _gather_uloc(u_flat, interp_vals, stencil_src, vsgn, cfg)
    nd = cfg.ndim
    ok = _grad_flags(uloc, err_grad, floors, 0, cfg)
    okc = torch.movedim(ok[tuple(slice(2, 4) for _ in range(nd))], -1, 0)
    return okc.reshape(okc.shape[0], 2 ** nd)


def two_sided_rel_err(f, floor, nd: int, spatial0: int):
    """Max-over-directions relative two-sided difference, the error metric
    of ``hydro_refine`` (``hydro/godunov_utils.f90:152-210``)."""
    err = torch.zeros_like(f)
    for d in range(nd):
        ax = spatial0 + d
        fl = torch.roll(f, 1, dims=ax)
        fr = torch.roll(f, -1, dims=ax)
        e1 = torch.abs(fr - f) / (torch.abs(fr) + torch.abs(f) + floor)
        e2 = torch.abs(f - fl) / (torch.abs(f) + torch.abs(fl) + floor)
        err = torch.maximum(err, 2.0 * torch.maximum(e1, e2))
    return err


def _grad_flags(uloc, err_grad, floors, spatial0: int, cfg: HydroStatic):
    """Gradient criteria on ``uloc [nvar, ...]`` whose spatial axes start
    at ``spatial0`` of each field."""
    nd = cfg.ndim
    r = torch.clamp(uloc[0], min=cfg.smallr)
    vels = [uloc[1 + d] / r for d in range(nd)]
    ek = sum(0.5 * r * v * v for v in vels)
    p = (cfg.gamma - 1.0) * (uloc[nd + 1] - ek)
    ok = torch.zeros_like(r, dtype=torch.bool)
    egd, egu, egp = err_grad
    fld, flu, flp = floors
    if egd >= 0.0:
        ok = ok | (two_sided_rel_err(r, fld, nd, spatial0) > egd)
    if egp >= 0.0:
        ok = ok | (two_sided_rel_err(p, flp, nd, spatial0) > egp)
    if egu >= 0.0:
        c = torch.sqrt(torch.clamp(cfg.gamma * p / r, min=flu ** 2))
        for d in range(nd):
            v = vels[d]
            err = torch.zeros_like(v)
            for dd in range(nd):
                ax = spatial0 + dd
                vl, vr = torch.roll(v, 1, dims=ax), torch.roll(v, -1, dims=ax)
                cl, cr = torch.roll(c, 1, dims=ax), torch.roll(c, -1, dims=ax)
                e1 = torch.abs(vr - v) / (cr + c + torch.abs(vr)
                                          + torch.abs(v) + flu)
                e2 = torch.abs(v - vl) / (c + cl + torch.abs(v)
                                          + torch.abs(vl) + flu)
                err = torch.maximum(err, 2.0 * torch.maximum(e1, e2))
            ok = ok | (err > egu)
    return ok

