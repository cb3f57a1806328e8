"""Source passes on the AMR hierarchy: Monte-Carlo and velocity gas
tracers, and sink particles (host numpy).

Port of the tracer and sink parts of ``ramses_tpu/pm/amr_physics.py``:
:func:`ngp_rows` (the cell containing each position at one level),
:func:`mc_tracer_amr`, the flux-probability jumps of ``pm/move_tracer.f90``
(the Cadiou et al. scheme), :func:`tracer_drift_amr`, the CIC velocity
tracers of the paths that capture no face fluxes (the MHD hierarchy), and
:func:`sink_passes_amr`, the sink creation, accretion, merging and motion
of ``pm/sink_particle.f90``.  They run at coarse-step cadence after the
step, as in the JAX package.  Tracer positions and ids, and the sinks, live
on the host: the coarse step captures each level's face mass fluxes on the
device (``want_flux`` of the hydro kernels, :mod:`ramses_tpu_torch.
amr.kernels`), and the jumps run once per coarse step on the host with the
simulation's own numpy generator, so the same captures and generator state
give the same tracers as the JAX package.  The sink pass fetches what the
JAX package fetches: each level's density column first, the whole level
only where a candidate cell exists, the levels the sinks' clouds touch,
and the force rows at the sinks; a level it changed goes back to the
device in the state's dtype.

:func:`star_formation_amr`, :func:`thermal_feedback_amr` and
:func:`kinetic_feedback_amr` are the Schmidt-law star formation and the
delayed SN feedback of ``pm/star_formation.f90`` and ``pm/feedback.f90``
on the hierarchy: SF samples the leaf cells of every level with the
hierarchy's numpy generator, feedback lands in each star's finest covering
cell (the kinetic bubble on that level).  They keep the JAX package's
fetch discipline: each level's density column first, the whole level only
where a cell is eligible or a star explodes.  The sink passes feed the
stellar objects' accreted-mass accumulators (:mod:`ramses_tpu_torch.pm.
stellar`) where the hierarchy runs them.
"""

from __future__ import annotations

import numpy as np
import torch

from ramses_tpu_torch.amr.tree import Octree, map_coords
from ramses_tpu_torch.pm import amr_pm
from ramses_tpu_torch.units import factG_in_cgs


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


def tracer_drift_amr(sim, dt: float):
    """Advect the tracers with the CIC-gathered gas velocity at each
    tracer's finest covering level (the velocity-tracer scheme,
    ``pm/move_tracer.f90``'s pre-MC path): the maps are built on the device
    from a float64 copy of the positions, each level's velocity is gathered
    in float64, and the velocities come back in one fetch.  An open box
    drops the tracers that leave it (and their ids)."""
    x = sim.tracer_x
    if x is None or len(x) == 0:
        return
    x_host = np.asarray(x, dtype=np.float64)
    ncp = {l: sim.maps[l].ncell_pad for l in sim.levels()}
    maps = amr_pm.build_pm_maps(
        sim.tree, torch.as_tensor(x_host, device=sim.device), sim.boxlen,
        sim.bc_kinds, ncp)
    nd = sim.cfg.ndim
    v = torch.zeros((len(x_host), nd), dtype=torch.float64,
                    device=sim.device)
    for l, mp in maps.items():
        u = sim.u[l].to(torch.float64)
        vel = u[:, 1:1 + nd] / torch.clamp(u[:, :1], min=1e-300)
        vals = torch.cat([vel, vel.new_zeros((1, nd))])[mp.idx]
        gathered = (vals * mp.w[..., None]).sum(dim=1)
        v = torch.where(mp.assigned[:, None], gathered, v)
    x = x_host + v.cpu().numpy() * dt
    if sim.grav_periodic:
        sim.tracer_x = np.mod(x, sim.boxlen)
    else:
        # open box: tracers leave the domain and are dropped
        keep = ((x >= 0.0) & (x < sim.boxlen)).all(axis=1)
        sim.tracer_x = x[keep]
        if getattr(sim, "tracer_id", None) is not None:
            sim.tracer_id = sim.tracer_id[keep]


def _host(t) -> np.ndarray:
    """A device tensor as a new float64 numpy array (one fetch)."""
    return t.to(torch.float64).cpu().numpy()


def _put(sim, l: int, u: np.ndarray):
    """A level's host rows back on the device in the state's dtype."""
    sim.u[l] = torch.as_tensor(u, dtype=sim.dtype, device=sim.device)


def _levels_of(sim, x: np.ndarray) -> np.ndarray:
    """Each position's finest covering level (``assign_levels``), host."""
    return amr_pm.assign_levels(
        sim.tree, torch.as_tensor(np.asarray(x, dtype=np.float64)),
        sim.boxlen).numpy()


def create_sinks_amr(sim, sinks, spec, units):
    """Threshold creation on leaf cells above ``n_sink``, outside the
    exclusion radius of every existing and newly accepted sink; the
    gas above the threshold becomes the new sinks' mass.  Returns the
    grown :class:`SinkSet`."""
    from ramses_tpu_torch.pm.sinks import SinkSet

    nd = sim.cfg.ndim
    ttd = 2 ** nd
    d_thr = spec.n_sink / units.scale_nH
    for l in sim.levels():
        if sinks.n >= spec.nsinkmax:
            break
        ncell = sim.maps[l].noct * ttd
        dx = sim.dx(l)
        vol = dx ** nd
        # density column first: quiet levels skip the full host copy
        rho = _host(sim.u[l][:ncell, 0])
        leaf = ~sim.tree.refined_mask(l)
        cand = leaf & (rho * units.scale_nH > spec.n_sink)
        rows = np.nonzero(cand)[0]
        if len(rows) == 0:
            continue
        u = _host(sim.u[l])
        xnew = sim.tree.cell_centers(l, sim.boxlen)[rows]
        # greedy density-ordered exclusion: the densest candidate wins its
        # merge-radius neighbourhood (the flat-batch stand-in for
        # create_sink's local-maximum test: a resolved clump spawns ONE
        # sink), also enforced against the existing sinks
        order = np.argsort(-rho[rows])
        r2 = (spec.merging_cells * dx) ** 2
        accepted = []
        acc_x = [] if sinks.n == 0 else [sinks.x]
        room = spec.nsinkmax - sinks.n
        for k in order:
            if len(accepted) >= room:
                break
            xs = np.concatenate(acc_x) if acc_x else np.zeros((0, nd))
            if len(xs) and (((xs - xnew[k]) ** 2).sum(-1) < r2).any():
                continue
            accepted.append(k)
            acc_x.append(xnew[k:k + 1])
        if not accepted:
            continue
        accepted = np.asarray(accepted)
        rows, xnew = rows[accepted], xnew[accepted]
        dm_rho = np.maximum(rho[rows] - d_thr, 0.0)
        mnew = dm_rho * vol
        vel = u[rows, 1:1 + nd] / np.maximum(rho[rows, None], 1e-300)
        u[rows] *= (1.0 - dm_rho / rho[rows])[:, None]
        _put(sim, l, u)
        new_idp = sinks.next_id + np.arange(len(rows), dtype=np.int64)
        stellar = getattr(sim, "stellar", None)
        if stellar is not None:
            for sid, mass in zip(new_idp, mnew):
                stellar.add_accreted(sid, float(mass))
        sinks = SinkSet(
            x=np.concatenate([sinks.x, xnew]),
            v=np.concatenate([sinks.v, vel]),
            m=np.concatenate([sinks.m, mnew]),
            tform=np.concatenate([sinks.tform, np.full(len(rows), sim.t)]),
            idp=np.concatenate([sinks.idp, new_idp]),
            next_id=sinks.next_id + len(rows))
    return sinks


def sink_passes_amr(sim, dt: float):
    """Sink creation, accretion, merging and motion on the hierarchy
    (``pm/sink_particle.f90`` create_sink:6, grow_sink:575,
    accrete_sink:722): threshold creation on leaf cells with an exclusion
    radius, Bondi or threshold accretion over each sink's cloud from the
    finest covering cells, pairwise merging, and the leapfrog drift in the
    AMR gravity field (NGP at the covering level), with the direct
    sink-sink force under ``direct_force``."""
    from ramses_tpu_torch.pm.sinks import (SinkSet, agn_energy,
                                           cloud_offsets, direct_force_kick,
                                           merge_sinks)

    spec = sim.sink_spec
    units = sim.units
    sinks: SinkSet = sim.sinks
    nd = sim.cfg.ndim
    gamma = float(sim.cfg.gamma)
    d_thr = spec.n_sink / units.scale_nH

    sinks = create_sinks_amr(sim, sinks, spec, units)

    # ---- accretion over the sink CLOUD (``create_cloud_from_sink``,
    # pm/sink_particle.f90:131): equal-weight points within
    # 0.5*ir_cloud*dx_min sample the gas state, and the draw distributes
    # over every covered leaf cell with per-cell 90% caps shared between
    # overlapping clouds
    if sinks.n and spec.accretion_scheme != "none":
        dxm = sim.dx(max(sim.levels()))
        offs = cloud_offsets(nd, spec.ir_cloud, dxm)
        ncl = len(offs)
        ns = sinks.n
        pts = (sinks.x[:, None, :] + offs[None]).reshape(-1, nd)
        # wrap/clip per dimension: periodic dims wrap, walled dims clamp
        for d in range(nd):
            if tuple(sim.bc_kinds[d]) == (0, 0):
                pts[:, d] = np.mod(pts[:, d], sim.boxlen)
            else:
                pts[:, d] = np.clip(pts[:, d], 0.0,
                                    np.nextafter(sim.boxlen, 0))
        lvp = _levels_of(sim, pts)
        plvl = np.full(len(pts), -1, dtype=np.int64)
        prow = np.full(len(pts), -1, dtype=np.int64)
        ulv = {}
        vol_l = {l: sim.dx(l) ** nd for l in sim.levels()}
        for l in sim.levels():
            selp = np.nonzero(lvp == l)[0]
            if len(selp) == 0:
                continue
            r = ngp_rows(sim.tree, pts[selp], l, sim.boxlen, sim.bc_kinds)
            ok = r >= 0
            plvl[selp[ok]] = l
            prow[selp[ok]] = r[ok]
            ulv[l] = _host(sim.u[l])
        valid = plvl >= 0
        npts = len(pts)
        rho_p = np.full(npts, 1e-300)
        mom_p = np.zeros((npts, nd))
        e_p = np.zeros(npts)
        vol_p = np.zeros(npts)
        for l, u in ulv.items():
            m = plvl == l
            rows = prow[m]
            rho_p[m] = np.maximum(u[rows, 0], 1e-300)
            mom_p[m] = u[rows, 1:1 + nd]
            e_p[m] = u[rows, 1 + nd]
            vol_p[m] = vol_l[l]
        # per-sink cloud-averaged state (equal-weight cloud points)
        w2 = valid.reshape(ns, ncl).astype(np.float64)
        wsum = np.maximum(w2.sum(1), 1e-300)
        rho2 = rho_p.reshape(ns, ncl)
        mom2 = mom_p.reshape(ns, ncl, nd)
        # floor-density cells can carry stray momenta whose v = mom/rho
        # overflows f64: suppress and zero those contributions
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            rho_bar = (rho2 * w2).sum(1) / wsum
            mw = np.maximum((rho2 * w2).sum(1), 1e-300)
            vgas_bar = np.nan_to_num(
                (mom2 * w2[:, :, None]).sum(1) / mw[:, None],
                posinf=0.0, neginf=0.0)
            ek2 = np.nan_to_num(0.5 * (mom2 ** 2).sum(2) / rho2,
                                posinf=0.0, neginf=0.0)
            press2 = (gamma - 1.0) * (e_p.reshape(ns, ncl) - ek2)
            cs2 = gamma * np.maximum((press2 * w2).sum(1) / wsum, 1e-300) \
                / np.maximum(rho_bar, 1e-300)
        if spec.accretion_scheme == "bondi":
            g_code = factG_in_cgs * units.scale_d * units.scale_t ** 2
            vrel2 = ((sinks.v - vgas_bar) ** 2).sum(1)
            mdot = (4 * np.pi * g_code ** 2 * sinks.m ** 2 * rho_bar
                    / np.maximum(cs2 + vrel2, 1e-300) ** 1.5)
            # equal split over the sink's valid cloud points
            dm_p = np.where(valid, np.repeat(mdot * dt / wsum, ncl), 0.0)
        else:   # threshold: per-point excess, deduped per (sink, cell)
            key_sc = (np.repeat(np.arange(ns), ncl) * (1 << 40)
                      + plvl * (1 << 32) + prow)
            _, first = np.unique(np.where(valid, key_sc, -1),
                                 return_index=True)
            once = np.zeros(npts, dtype=bool)
            once[first] = True
            once &= valid
            dm_p = np.where(once, spec.c_acc
                            * np.maximum(rho_p - d_thr, 0.0) * vol_p, 0.0)
        # group per unique CELL: cap the combined draw at 90% of its gas
        key = plvl * (1 << 48) + prow
        uniq, inv = np.unique(np.where(valid, key, -1), return_inverse=True)
        inv = inv.reshape(-1)
        tot_req = np.bincount(inv, weights=dm_p, minlength=len(uniq))
        # gas available per unique cell (first point of each group)
        firsts = np.zeros(len(uniq), dtype=np.int64)
        firsts[inv[::-1]] = np.arange(npts)[::-1]
        cell_gas = rho_p[firsts] * vol_p[firsts]
        allowed = np.minimum(tot_req, 0.9 * cell_gas)
        scale = allowed / np.maximum(tot_req, 1e-300)
        dm_p = dm_p * scale[inv] * valid
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            vpt = np.nan_to_num(mom_p / rho_p[:, None],
                                posinf=0.0, neginf=0.0)
        for l, u in ulv.items():
            m = (plvl == l) & (dm_p > 0.0)
            if not m.any():
                continue
            rows = prow[m]
            # additive removal against the PRE-draw state: duplicates (two
            # cloud points in one cell) sum to exactly the combined
            # fraction of the old state
            np.add.at(u, rows,
                      -u[rows] * (dm_p[m] / (rho_p[m] * vol_l[l]))[:, None])
            _put(sim, l, u)
        dm = dm_p.reshape(ns, ncl).sum(1)
        p_acc = (vpt * dm_p[:, None]).reshape(ns, ncl, nd).sum(1)
        m_gain = dm
        if spec.agn:
            e_agn, m_gain = agn_energy(dm, spec, units)
            # dump into the sink's own covering cell (the cloud centre)
            lv0 = _levels_of(sim, sinks.x)
            for l in ulv:
                m = lv0 == l
                if not m.any():
                    continue
                rows = ngp_rows(sim.tree, sinks.x[m], l, sim.boxlen,
                                sim.bc_kinds)
                ok = rows >= 0
                u = _host(sim.u[l])
                np.add.at(u[:, 1 + nd], rows[ok], e_agn[m][ok] / vol_l[l])
                _put(sim, l, u)
        stellar = getattr(sim, "stellar", None)
        if stellar is not None:
            for sid, dmi in zip(sinks.idp, dm):
                if dmi > 0.0:
                    stellar.add_accreted(sid, float(dmi))
        newm = sinks.m + m_gain
        sinks.v = (sinks.v * sinks.m[:, None] + p_acc) \
            / np.maximum(newm, 1e-300)[:, None]
        sinks.m = newm

    sinks = merge_sinks(sinks, spec, sim.dx(sim.lmax))

    # ---- leapfrog motion in the AMR gravity field
    if sinks.n:
        if sim.gravity and sim.fg:
            lv = _levels_of(sim, sinks.x)
            acc = np.zeros_like(sinks.v)
            for l in sim.levels():
                sel = np.nonzero(lv == l)[0]
                if len(sel) == 0 or l not in sim.fg:
                    continue
                rows = ngp_rows(sim.tree, sinks.x[sel], l, sim.boxlen,
                                sim.bc_kinds)
                ok = rows >= 0
                fg = _host(sim.fg[l])
                acc[sel[ok]] = fg[rows[ok]]
            sinks.v = sinks.v + acc * dt
        if spec.direct_force:
            sinks = direct_force_kick(
                sinks, units, sim.dx(max(sim.levels())), dt,
                sim.boxlen if sim.grav_periodic else None)
        x = sinks.x + sinks.v * dt
        if sim.grav_periodic:
            sinks.x = np.mod(x, sim.boxlen)
        else:
            # open box: sinks leaving the domain are removed (the escaping
            # particles' policy)
            keep = ((x >= 0.0) & (x < sim.boxlen)).all(axis=1)
            sinks = SinkSet(x=x[keep], v=sinks.v[keep], m=sinks.m[keep],
                            tform=sinks.tform[keep], idp=sinks.idp[keep],
                            next_id=sinks.next_id)
    sim.sinks = sinks


# ---------------------------------------------------------------------------
# star formation and SN feedback on the hierarchy
# ---------------------------------------------------------------------------

def star_formation_amr(sim, dt: float):
    """Schmidt-law SF over every level's leaf cells (coarse cadence): the
    uniform pass (:mod:`ramses_tpu_torch.pm.star_formation`) on flat
    batches.  Poisson-samples N ~ P(mgas/mstar · dt/t_star(ρ)) per
    eligible leaf cell, caps at 90 % of the cell gas, removes the mass at
    the cell velocity, appends FAM_STAR particles to ``sim.p``."""
    from ramses_tpu_torch.pm.star_formation import (append_stars,
                                                    mstar_quantum,
                                                    sf_timescale_code)
    spec = sim.sf_spec
    units = sim.units
    nd = sim.cfg.ndim
    ttd = 2 ** nd
    mstar = mstar_quantum(spec, units, sim.dx(sim.lmax), nd)
    rng = sim._sf_rng
    for l in sim.levels():
        ncell = sim.maps[l].noct * ttd
        dx = sim.dx(l)
        vol = dx ** nd
        # the density column only: most levels of a quiet hierarchy have
        # no eligible cell, and the whole level's fetch would dominate
        rho = _host(sim.u[l][:ncell, 0])
        nH = rho * units.scale_nH
        leaf = ~sim.tree.refined_mask(l)
        eligible = leaf & (nH > spec.n_star)
        if not eligible.any():
            continue
        tstar_code = sf_timescale_code(rho, nH, spec, units)
        lam = np.where(eligible, rho * vol / mstar * dt / tstar_code, 0.0)
        cap = np.maximum((0.9 * rho * vol / mstar).astype(np.int64), 0)
        # the draw is capped at 90% of the cell gas anyway; clamping λ
        # there also keeps it inside the Poisson sampler's range
        lam = np.minimum(np.where(np.isfinite(lam), lam, 0.0), cap)
        big = lam > 1e6             # Poisson(λ)≈λ: deterministic draw
        nnew = np.where(big, lam.astype(np.int64),
                        rng.poisson(np.where(big, 0.0, lam)))
        nnew = np.minimum(nnew, cap)
        rows = np.nonzero(nnew > 0)[0]
        if len(rows) == 0:
            continue
        counts = nnew[rows]
        u = _host(sim.u[l])
        centers = sim.tree.cell_centers(l, sim.boxlen)[rows]
        vel = u[rows, 1:1 + nd] / np.maximum(u[rows, :1], 1e-300)
        sim.p, sim._next_star_id, kept = append_stars(
            sim.p, centers, vel, counts, mstar, sim.t, sim._next_star_id)
        if kept.sum() == 0:
            continue
        dm = kept * mstar / vol
        frac = 1.0 - dm / rho[rows]
        u[rows] *= frac[:, None]
        _put(sim, l, u)


def _due_stars(sim):
    """(host fields of ``sim.p``, the due mask, the due stars' positions,
    velocities and ejecta masses, their finest covering levels), or None
    when no SN is due."""
    from ramses_tpu_torch.pm.star_formation import (host_particles,
                                                    sn_due_mask)
    spec = sim.sf_spec
    if spec.eta_sn <= 0:
        return None
    f = host_particles(sim.p)
    due = sn_due_mask(f, spec, sim.units, sim.t)
    if not due.any():
        return None
    x = f["x"][due].astype(np.float64)
    mej = spec.eta_sn * f["m"][due]
    return f, due, x, f["v"][due], mej, _levels_of(sim, x)


def thermal_feedback_amr(sim):
    """Delayed thermal SN dumps into each star's finest covering cell
    (``pm/feedback.f90:6-231,351``): stars older than t_sne return eta_sn
    of their mass + 1e51 erg / 10 Msun specific energy, once."""
    from ramses_tpu_torch.pm.star_formation import M_SUN, mark_sn_done
    got = _due_stars(sim)
    if got is None:
        return
    f, due, x, vstar, mej, lv = got
    nd = sim.cfg.ndim
    esn_code = (1e51 / (10.0 * M_SUN)) / sim.units.scale_v ** 2
    for l in sim.levels():
        sel = lv == l
        if not sel.any():
            continue
        rows = ngp_rows(sim.tree, x[sel], l, sim.boxlen, sim.bc_kinds)
        ok = rows >= 0
        if not ok.any():
            continue
        r = rows[ok]
        vol = sim.dx(l) ** nd
        u = _host(sim.u[l])
        me = mej[sel][ok]
        vs = vstar[sel][ok]
        np.add.at(u[:, 0], r, me / vol)
        for d in range(nd):
            np.add.at(u[:, 1 + d], r, me * vs[:, d] / vol)
        ek = 0.5 * me * (vs ** 2).sum(axis=1)
        np.add.at(u[:, 1 + nd], r, (ek + me * esn_code) / vol)
        _put(sim, l, u)
    sim.p = mark_sn_done(sim.p, f, due, mej)


def kinetic_feedback_amr(sim):
    """Delayed KINETIC SN winds on the hierarchy (the ``f_w`` mass-loaded
    momentum scheme of ``pm/feedback.f90``; see
    :func:`ramses_tpu_torch.pm.star_formation.kinetic_feedback` for the
    bubble and the energy split): the 3^ndim bubble lives on each star's
    finest covering level; bubble cells the level does not cover, or that
    are refined there, fall back to the host cell."""
    from ramses_tpu_torch.pm.star_formation import (M_SUN, mark_sn_done,
                                                    wind_shell)
    got = _due_stars(sim)
    if got is None:
        return
    f, due, x, vstar, mej, lv = got
    spec = sim.sf_spec
    nd = sim.cfg.ndim
    esn_code = (1e51 / (10.0 * M_SUN)) / sim.units.scale_v ** 2
    offs, rhat = wind_shell(nd)
    nc = len(offs)
    for l in sim.levels():
        sel = lv == l
        if not sel.any():
            continue
        dxl = sim.dx(l)
        vol = dxl ** nd
        rows0 = ngp_rows(sim.tree, x[sel], l, sim.boxlen, sim.bc_kinds)
        ok = rows0 >= 0
        if not ok.any():
            continue
        u = _host(sim.u[l])
        r0 = rows0[ok]
        me = mej[sel][ok]
        vs = vstar[sel][ok]
        xs = x[sel][ok]
        # sweep from the host cell (capped at 25% of its gas); SNe sharing
        # a host cell debit it ONCE for their combined draw
        uniq, inv = np.unique(r0, return_inverse=True)
        mcell_u = u[uniq, 0] * vol
        tot_req = np.bincount(inv, weights=spec.f_w * me)
        tot_allow = np.minimum(tot_req, 0.25 * mcell_u)
        msw = spec.f_w * me * (tot_allow
                               / np.maximum(tot_req, 1e-300))[inv]
        mcell = mcell_u[inv]
        vcell = u[uniq][inv][:, 1:1 + nd] \
            / np.maximum(u[uniq][inv][:, :1], 1e-300)
        e_removed = (msw / np.maximum(mcell, 1e-300)
                     * u[uniq, 1 + nd][inv] * vol)
        u[uniq] *= (1.0 - tot_allow
                    / np.maximum(mcell_u, 1e-300))[:, None]
        mload = me + msw
        vw = np.sqrt(2.0 * esn_code * me / np.maximum(mload, 1e-300))
        vbulk = (me[:, None] * vs + msw[:, None] * vcell) \
            / np.maximum(mload[:, None], 1e-300)
        e_inj = np.zeros(len(me))
        # bubble targets refined at this level are covered by a finer oct
        # whose restriction would overwrite the deposit: host-cell fallback
        ref_mask = np.asarray(sim.tree.refined_mask(l))
        for k in range(nc):
            xt = xs + offs[k] * dxl
            rt = ngp_rows(sim.tree, xt, l, sim.boxlen, sim.bc_kinds)
            bad = (rt < 0) | ref_mask[np.maximum(rt, 0)]
            r = np.where(~bad, rt, r0)
            central = np.logical_or(bool((offs[k] == 0).all()), bad)
            mshare = mload / nc
            vk = np.where(central[:, None], vbulk,
                          vbulk + vw[:, None] * rhat[k])
            np.add.at(u[:, 0], r, mshare / vol)
            for d in range(nd):
                np.add.at(u[:, 1 + d], r, mshare * vk[:, d] / vol)
            ek = 0.5 * mshare * (vk ** 2).sum(axis=1)
            np.add.at(u[:, 1 + nd], r, ek / vol)
            e_inj += ek
        # exact budget: the remainder (with the fallback shares'
        # suppressed kicks) lands as heat in the host cell
        e_target = (e_removed + me * esn_code
                    + 0.5 * me * (vs ** 2).sum(axis=1))
        np.add.at(u[:, 1 + nd], r0, (e_target - e_inj) / vol)
        _put(sim, l, u)
    sim.p = mark_sn_done(sim.p, f, due, mej)
