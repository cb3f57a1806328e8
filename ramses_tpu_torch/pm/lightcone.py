"""Cosmological lightcone particle selection.

The port's copy of ``ramses_tpu/pm/lightcone.py``, host numpy as there.
The geometry core of ``amr/light_cone.f90`` (``perform_my_selection:424``):
between two coarse steps the lightcone shell [r1, r2] (comoving distance
travelled by light) sweeps through periodic replicas of the box; particles
inside the shell are emitted once with their replica-shifted coordinates.
Comoving distances come from the Friedmann tables of
:class:`ramses_tpu_torch.pm.cosmology.Cosmology` (``chi_of_aexp``,
``aexp_of_chi``).  :func:`emit_coarse_step` fetches the particles from the
device once a coarse step.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def shell_radii(cosmo, aexp1: float, aexp2: float) -> Tuple[float, float]:
    """Comoving radii [box-length units] of the lightcone shell between
    two expansion factors (observer at aexp=1): the PROPER comoving
    distance chi(a) = ∫ c·da'/(a'²H) from the Friedmann tables —
    the ``coord_distance`` integral of ``amr/light_cone.f90:795-804``
    (NOT the super-conformal Δτ, whose dτ = dt/a² lacks the c/a
    weighting)."""
    return (float(cosmo.chi_of_aexp(aexp2)),
            float(cosmo.chi_of_aexp(aexp1)))


def rotation_matrix(thetay: float = 0.0, thetaz: float = 0.0) -> np.ndarray:
    """Observer orientation (``light_cone.f90`` compute_rotation_matrix
    ``:580-640``: a y-rotation by ``thetay`` then a z-rotation by
    ``thetaz`` pointing the cone axis)."""
    cy, sy = np.cos(thetay), np.sin(thetay)
    cz, sz = np.cos(thetaz), np.sin(thetaz)
    ry = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    rz = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    return rz @ ry


def _replica_shifts(obs: np.ndarray, r1: float, r2: float,
                    boxlen: float, ndim: int) -> np.ndarray:
    """Periodic replica shifts whose box can intersect the shell
    [r1, r2), built axis by axis with incremental pruning.

    A proper comoving r2 can span hundreds of box lengths (deep
    cones), so materializing the full (2·nrep+1)^ndim shift cube —
    O(r2^ndim) memory — is not an option; pruning each axis on the
    partial minimum distance keeps intermediates at the shell's
    surface size O(r2^(ndim-1)) (``compute_replica``'s bounds,
    ``amr/light_cone.f90``)."""
    nrep = int(np.ceil(r2 / boxlen)) + 1
    k = np.arange(-nrep, nrep + 1) * boxlen
    los = [np.maximum(np.abs(k - obs[d]) - boxlen, 0.0) ** 2
           for d in range(ndim)]
    his = [(np.abs(k - obs[d]) + boxlen) ** 2 for d in range(ndim)]
    # largest possible contribution of the axes NOT yet expanded: rows
    # whose partial dmax2 + rem_max still misses r1 are ball interior
    # and can be dropped mid-build — without this, the dmin2 prune
    # alone keeps the whole O(r2^ndim) interior
    rem_max = [sum(h.max() for h in his[d + 1:]) for d in range(ndim)]
    shifts = np.zeros((1, 0))
    dmin2 = np.zeros(1)
    dmax2 = np.zeros(1)
    for d in range(ndim):
        # expand in k-chunks: pruning per chunk caps the transient at
        # O(|survivors| · chunk) — the unchunked last-axis expansion
        # would materialize the O(r2^ndim) interior before its prune
        parts = []
        for c0 in range(0, len(k), 16):
            kc, loc, hic = (a[c0:c0 + 16] for a in (k, los[d], his[d]))
            s = np.concatenate(
                [np.repeat(shifts, len(kc), axis=0),
                 np.tile(kc, len(shifts))[:, None]], axis=1)
            mn = (dmin2[:, None] + loc[None, :]).ravel()
            mx = (dmax2[:, None] + hic[None, :]).ravel()
            # later axes only grow both bounds, so both prunes are safe
            keep = (mn < r2 * r2) & (mx + rem_max[d] >= r1 * r1)
            parts.append((s[keep], mn[keep], mx[keep]))
        shifts = np.concatenate([p[0] for p in parts])
        dmin2 = np.concatenate([p[1] for p in parts])
        dmax2 = np.concatenate([p[2] for p in parts])
    return shifts


def cone_selection(x: np.ndarray, obs: Sequence[float], r1: float,
                   r2: float, boxlen: float = 1.0,
                   opening: Optional[float] = None,
                   axis: Sequence[float] = (0, 0, 1.0),
                   rotation: Optional[np.ndarray] = None,
                   half_angles: Optional[Tuple[float, float]] = None,
                   v: Optional[np.ndarray] = None):
    """Select particles in the shell r1 <= |x_rep − obs| < r2 over all
    periodic replicas intersecting the shell.

    Returns (positions [m, ndim] in observer coordinates, radii [m],
    source indices [m]) — a particle can appear in several replicas
    (``light_cone.f90`` replica loops).  ``rotation``: optional
    [ndim, ndim] observer orientation (see :func:`rotation_matrix`)
    applied to the emitted coordinates — the narrow-cone frame of
    ``perform_my_selection_narrow``; the opening-angle cut then acts
    along ``axis`` IN THE ROTATED FRAME.  ``half_angles`` =
    (thetay, thetaz) [radians]: the reference's RECTANGULAR cut
    (|x| ≤ z·tan(thetay), |y| ≤ z·tan(thetaz), z > 0 in the rotated
    frame).  ``v``: optional velocities, emitted alongside positions
    (the reference writes xp AND vp per cone particle).
    """
    x = np.asarray(x)
    ndim = x.shape[1]
    obs = np.asarray(obs, dtype=np.float64)
    shifts = _replica_shifts(obs, r1, r2, boxlen, ndim)

    out_x, out_r, out_i = [], [], []
    ax = np.asarray(axis, dtype=np.float64)[:ndim]
    ax = ax / np.linalg.norm(ax)
    cos_open = np.cos(opening) if opening is not None else None
    tan_yz = (tuple(np.tan(a) for a in half_angles)
              if half_angles is not None else None)
    for s in shifts:
        pos = x + s[None, :] - obs[None, :]
        if rotation is not None:
            pos = pos @ np.asarray(rotation).T[:ndim, :ndim]
        r = np.sqrt((pos ** 2).sum(1))
        m = (r >= r1) & (r < r2)
        if cos_open is not None:
            mu = (pos @ ax) / np.maximum(r, 1e-300)
            m &= mu >= cos_open
        if tan_yz is not None and ndim == 3:
            z = pos[:, 2]
            m &= ((z > 0.0)
                  & (np.abs(pos[:, 0]) <= z * tan_yz[0])
                  & (np.abs(pos[:, 1]) <= z * tan_yz[1]))
        if m.any():
            out_x.append(pos[m])
            out_r.append(r[m])
            out_i.append(np.where(m)[0])
    if not out_x:
        return (np.zeros((0, ndim)), np.zeros(0),
                np.zeros(0, dtype=np.int64))
    return (np.concatenate(out_x), np.concatenate(out_r),
            np.concatenate(out_i))


def write_cone(path: str, pos: np.ndarray, r: np.ndarray,
               idx: np.ndarray, aexp: float, vel=None,
               a_emit=None) -> None:
    """Cone dump (``output_cone`` reduced to an npz payload: positions,
    radii, source indices, velocities, per-particle emission aexp)."""
    payload = dict(pos=pos, r=r, idx=idx, aexp=aexp)
    if vel is not None:
        payload["vel"] = vel
    if a_emit is not None:
        payload["a_emit"] = a_emit
    np.savez_compressed(path, **payload)


def emit_coarse_step(sim, outdir: str = ".") -> Optional[str]:
    """Per-coarse-step lightcone emission (``amr_step.f90:177-178``
    ``output_cone``): the shell swept since the previous coarse step,
    observer at the box centre, narrow cone per &LIGHTCONE_PARAMS
    (full sky when the half-angles reach 90°).  Each particle carries
    its emission expansion factor interpolated at its comoving radius.
    Returns the written path (None when nothing was emitted)."""
    import os

    cosmo = sim.cosmo
    lc = sim.params.lightcone
    a_now = sim.aexp_now()
    a_prev = getattr(sim, "_cone_aexp_prev", None)
    sim._cone_aexp_prev = a_now
    if a_prev is None or sim.p is None or a_now <= a_prev:
        return None
    if a_now < 1.0 / (1.0 + float(lc.zmax_cone)):
        return None                    # beyond the cone's zmax
    r2, r1 = shell_radii(cosmo, a_prev, a_now)
    r1, r2 = r1 * sim.boxlen, r2 * sim.boxlen   # box → code units
    if r1 > r2:
        r1, r2 = r2, r1
    if r2 <= r1:
        return None
    act = sim.p.active.cpu().numpy()
    x = sim.p.x.cpu().numpy()[act]
    vpart = sim.p.v.cpu().numpy()[act]
    obs = np.full(sim.cfg.ndim, 0.5 * sim.boxlen)
    ty = np.radians(float(lc.thetay_cone))
    tz = np.radians(float(lc.thetaz_cone))
    half = ((ty, tz) if (ty < np.pi / 2 and tz < np.pi / 2
                         and sim.cfg.ndim == 3) else None)
    pos, r, idx = cone_selection(x, obs, r1, r2, boxlen=sim.boxlen,
                                 half_angles=half)
    if len(r) == 0:
        return None
    # emission epoch per particle: a at comoving distance r
    a_emit = np.asarray(cosmo.aexp_of_chi(r / sim.boxlen))
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"cone_{sim.nstep:05d}.npz")
    write_cone(path, pos, r, idx, a_now, vel=vpart[idx],
               a_emit=a_emit)
    return path
