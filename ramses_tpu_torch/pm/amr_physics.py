"""Monte-Carlo gas tracers on the AMR hierarchy (host numpy).

Port of the tracer part of ``ramses_tpu/pm/amr_physics.py``:
:func:`ngp_rows` (the cell containing each position at one level) and
:func:`mc_tracer_amr`, the flux-probability jumps of ``pm/move_tracer.f90``
(the Cadiou et al. scheme).  Tracer positions and ids live on the host, as
in the JAX package: the coarse step captures each level's face mass fluxes
on the device (``want_flux`` of the hydro kernels, :mod:`ramses_tpu_torch.
amr.kernels`), and the jumps run once per coarse step on the host with the
simulation's own numpy generator, so the same captures and generator state
give the same tracers as the JAX package.  Star formation, sinks and the
velocity tracers of the MHD hierarchy are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ramses_tpu_torch.amr.tree import Octree, map_coords


def ngp_rows(tree: Octree, x: np.ndarray, lvl: int, boxlen: float,
             bc_kinds) -> np.ndarray:
    """Flat cell row of the cell CONTAINING each position at ``lvl`` (-1
    where the level does not cover it)."""
    ndim = tree.ndim
    ttd = 1 << ndim
    dx = boxlen / (1 << lvl)
    cc = np.floor(x / dx).astype(np.int64)
    cc, _ = map_coords(cc, lvl, bc_kinds, ndim)
    og = cc >> 1
    oi = tree.lookup(lvl, og)
    off = np.zeros(len(x), dtype=np.int64)
    for d in range(ndim):
        off = (off << 1) | (cc[:, d] & 1)
    return np.where(oi >= 0, oi * ttd + off, -1)


def _fetch(phi_dev, rho0_dev):
    """Every level's capture and pre-step density in ONE device→host copy,
    as f64 numpy dicts keyed by level."""
    levels = list(phi_dev)
    parts = [phi_dev[l].reshape(-1) for l in levels] + \
        [rho0_dev[l].reshape(-1) for l in levels]
    host = torch.cat(parts).cpu().numpy().astype(np.float64)
    out, off = [], 0
    for t in parts:
        out.append(host[off:off + t.numel()])
        off += t.numel()
    n = len(levels)
    return ({l: out[i].reshape(tuple(phi_dev[l].shape))
             for i, l in enumerate(levels)},
            {l: out[n + i] for i, l in enumerate(levels)})


def mc_tracer_amr(sim):
    """Flux-probability Monte-Carlo tracer jumps on the hierarchy
    (``pm/move_tracer.f90``): a tracer in leaf cell i jumps across face f
    with probability (outgoing mass through f) / (cell gas mass before the
    step), so the tracers follow the gas mass in expectation, across
    refinement boundaries too, where the coarse face slots carry the
    flux-correction values (``scatter_corr_flux``).

    The coarse step captured each level's TOTAL face fluxes over its
    2^(l-lmin) substeps (``sim._tracer_phi``), so the move runs ``R =
    2^(lmax-lmin)`` rounds in which a level-l tracer moves at its own
    substep cadence with flux/2^(l-lmin) each (per-move probability at
    most the CFL number).  Each round divides by the density before the
    coarse step (``sim._tracer_rho0``), as the JAX package does.  Reads
    the captures once (one device→host copy per coarse step) and draws
    from ``sim._tracer_rng``; updates ``sim.tracer_x`` (and, with outflow
    or reflecting walls, drops escaped tracers from ``sim.tracer_id``)."""
    x = sim.tracer_x
    phi_dev = sim._tracer_phi
    sim._tracer_phi = None
    if x is None or len(x) == 0 or phi_dev is None:
        return
    nd = sim.cfg.ndim
    levels = sim.levels()
    phi, rho0 = _fetch(phi_dev, sim._tracer_rho0)
    rng = sim._tracer_rng
    x = np.asarray(x, dtype=np.float64).copy()
    periodic = all(k == 0 for pair in sim.bc_kinds for k in pair)
    rounds = 1 << (max(levels) - sim.lmin)
    lev = np.full(len(x), -2, dtype=np.int64)
    row = np.full(len(x), -1, dtype=np.int64)
    stale = np.ones(len(x), dtype=bool)        # needs (re)location
    for r in range(rounds):
        # level-l tracers move in rounds r ≡ 0 (mod R/2^(l-lmin))
        active = [l for l in levels
                  if r % (rounds >> (l - sim.lmin)) == 0]
        if stale.any():
            ii0 = np.nonzero(stale)[0]
            xs = x[ii0]
            inbox = ((xs >= 0.0) & (xs < sim.boxlen)).all(axis=1)
            lev[ii0] = -1
            row[ii0] = -1
            for l in levels:
                rr = ngp_rows(sim.tree, xs[inbox], l, sim.boxlen,
                              sim.bc_kinds)
                upd = rr >= 0
                ii = ii0[np.nonzero(inbox)[0][upd]]
                lev[ii] = l        # ascending: finest covering wins
                row[ii] = rr[upd]
            stale[:] = False
        for l in active:
            sel = lev == l
            if not sel.any():
                continue
            nsub = 1 << (l - sim.lmin)
            rows = row[sel]
            mcell = np.maximum(rho0[l][rows], 1e-300)
            ph = phi[l][rows]                      # [n, ndim, 2] signed
            p = np.empty((int(sel.sum()), 2 * nd))
            for d in range(nd):
                p[:, 2 * d] = np.maximum(-ph[:, d, 0], 0.0)     # leave -d
                p[:, 2 * d + 1] = np.maximum(ph[:, d, 1], 0.0)  # leave +d
            p /= (mcell[:, None] * nsub)
            np.clip(p, 0.0, 1.0, out=p)
            c = np.cumsum(p, axis=1)
            uu = rng.random(int(sel.sum()))
            k = (uu[:, None] < c).argmax(axis=1)
            hit = uu < c[:, -1]                    # else: stay
            dxl = sim.dx(l)
            step = np.zeros((int(sel.sum()), nd))
            step[np.arange(len(k)), k // 2] = np.where(k % 2 == 1,
                                                       dxl, -dxl)
            step[~hit] = 0.0
            x[sel] += step
            moved = np.zeros(len(x), dtype=bool)
            moved[np.nonzero(sel)[0][hit]] = True
            stale |= moved
        if periodic:
            x = np.mod(x, sim.boxlen)
    if not periodic:
        keep = ((x >= 0.0) & (x < sim.boxlen)).all(axis=1)
        x = x[keep]
        if getattr(sim, "tracer_id", None) is not None:
            sim.tracer_id = sim.tracer_id[keep]
    sim.tracer_x = x
