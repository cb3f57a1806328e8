"""Star formation (Schmidt law) and supernova feedback, host numpy.

Port of ``ramses_tpu/pm/star_formation.py`` (reference:
``pm/star_formation.f90`` threshold and Poisson sampling ``:536-574``,
``pm/feedback.f90`` ``thermal_feedback:6`` with the SN specific energy
1e51 erg / 10 Msun, ``:231``, and the ``f_w`` kinetic winds).

These passes run at coarse-step cadence on the host, as in the JAX
package: particle creation is a data-dependent append, and the draws come
from the simulation's numpy generator, so the same state and generator
state give the same stars, ids and masses in both packages.  The gas
state arrives as numpy and leaves as numpy; the particles are the port's
:class:`ramses_tpu_torch.pm.particles.ParticleSet`, fetched once a pass
and put back on their device in their own dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ramses_tpu_torch.pm.particles import FAM_STAR, ParticleSet
from ramses_tpu_torch.units import Units, factG_in_cgs, yr2sec

M_SUN = 1.9891e33
FLAG_SN_DONE = 1


@dataclass(frozen=True)
class SfSpec:
    """&SF_PARAMS + &FEEDBACK_PARAMS subset (amr/amr_parameters.f90:141-164)."""
    enabled: bool = False
    n_star: float = 0.1          # SF density threshold [H/cc]
    t_star: float = 0.0          # SF timescale at threshold [Gyr]
    eps_star: float = 0.0        # efficiency per free-fall when t_star=0
    m_star: float = -1.0         # particle mass in units of the quantum
    T2_star: float = 0.0         # ISM polytrope normalization [K]
    g_star: float = 1.0          # ISM polytrope index
    # feedback
    eta_sn: float = 0.0          # ejecta mass fraction
    yield_metal: float = 0.1
    t_sne: float = 10.0          # delay [Myr]
    f_w: float = 0.0             # wind mass loading; >0 => kinetic mode

    @classmethod
    def from_params(cls, p) -> "SfSpec":
        raw_sf = p.raw.get("sf_params", {}) if p.raw else {}
        raw_fb = p.raw.get("feedback_params", {}) if p.raw else {}

        def g(d, k, dflt):
            v = d.get(k, dflt)
            return v[0] if isinstance(v, list) else v

        return cls(
            enabled=bool(raw_sf),
            n_star=float(g(raw_sf, "n_star", 0.1)),
            t_star=float(g(raw_sf, "t_star", 0.0)),
            eps_star=float(g(raw_sf, "eps_star", 0.0)),
            m_star=float(g(raw_sf, "m_star", -1.0)),
            T2_star=float(g(raw_sf, "t2_star", 0.0)),
            g_star=float(g(raw_sf, "g_star", 1.0)),
            eta_sn=float(g(raw_fb, "eta_sn", 0.0)),
            yield_metal=float(g(raw_fb, "yield", 0.1)),
            t_sne=float(g(raw_fb, "t_sne", 10.0)),
            f_w=float(g(raw_fb, "f_w", 0.0)))


def mstar_quantum(spec: SfSpec, units: Units, dx_min: float,
                  ndim: int) -> float:
    """Star particle mass [code]: n_star·vol_min by default, or
    m_star·mass_sph (``star_formation.f90:154-158``)."""
    vol_min = dx_min ** ndim
    base = spec.n_star / units.scale_nH * vol_min
    return base if spec.m_star <= 0 else spec.m_star * base


def sf_timescale_code(rho, nH, spec: SfSpec, units: Units):
    """SF timescale in code units: t_star·(nH/n_star)^-1/2, or
    t_ff/eps_star (``star_formation.f90:536-560``)."""
    if spec.t_star > 0:
        tstar_s = (spec.t_star * 1e9 * yr2sec
                   * np.sqrt(spec.n_star / np.maximum(nH, 1e-30)))
    else:
        rho_cgs = rho * units.scale_d
        t_ff = np.sqrt(3 * np.pi / (32 * factG_in_cgs
                                    * np.maximum(rho_cgs, 1e-300)))
        tstar_s = t_ff / max(spec.eps_star, 1e-10)
    return tstar_s / units.scale_t


def host_particles(p: ParticleSet) -> dict:
    """Every field of ``p`` as a new numpy array (one fetch a field, a
    copy even for CPU tensors): the host view the passes read and
    write."""
    return {k: np.array(v) for k, v in p.to_host().items()}


def particles_like(p: ParticleSet, f: dict) -> ParticleSet:
    """``p`` with the fields of the host dict ``f`` put back on its device
    in its own dtypes."""
    return ParticleSet(**{
        k: torch.as_tensor(np.asarray(f[k]), dtype=getattr(p, k).dtype,
                           device=getattr(p, k).device)
        for k in ParticleSet.__dataclass_fields__})


def append_stars(p: ParticleSet, xnew: np.ndarray, vnew: np.ndarray,
                 counts: np.ndarray, mstar: float, t: float,
                 next_id: int):
    """Append ``counts[i]`` FAM_STAR particles at ``xnew[i]``/``vnew[i]``
    into free lanes of ``p`` (truncating at capacity, keeping the earliest
    cells: the reference's ``nstar_tot`` overflow policy).  Returns (p',
    next_id', kept_counts): ``kept_counts`` mirrors ``counts`` after the
    truncation, so callers remove exactly the gas that became stars."""
    f = host_particles(p)
    active = f["active"].astype(bool)
    free = np.where(~active)[0]
    ntot = int(counts.sum())
    kept = counts.copy()
    if len(free) < ntot:
        keep = np.cumsum(counts) <= len(free)
        kept = np.where(keep, counts, 0)
        ntot = int(kept.sum())
    if ntot == 0:
        return p, next_id, kept
    slots = free[:ntot]
    sel = kept > 0
    rep = np.repeat(np.arange(len(counts))[sel], kept[sel])
    f["x"][slots] = xnew[rep]
    f["v"][slots] = vnew[rep]
    f["m"][slots] = mstar
    f["active"] = active.copy()
    f["active"][slots] = True
    f["family"][slots] = FAM_STAR
    f["tp"][slots] = t
    f["idp"][slots] = next_id + np.arange(ntot)
    f["flags"][slots] = 0
    return particles_like(p, f), next_id + ntot, kept


def star_formation(u, p: ParticleSet, rng: np.random.Generator,
                   spec: SfSpec, units: Units, dx: float, t: float,
                   dt: float, next_id: int):
    """One SF pass over a dense host state ``u [nvar, *sp]``: returns (u',
    particles', next_id').  Poisson-samples N ~ P(mgas/mstar ·
    dt/t_star(ρ)) per eligible cell (``star_formation.f90:561-574``), caps
    at 90 % of the cell gas, removes the mass at the cell's velocity,
    appends FAM_STAR particles."""
    u = np.array(u)
    ndim = u.ndim - 1
    vol = dx ** ndim
    rho = u[0]
    nH = rho * units.scale_nH
    eligible = nH > spec.n_star
    if not eligible.any():
        return u, p, next_id

    mstar = mstar_quantum(spec, units, dx, ndim)
    tstar_code = sf_timescale_code(rho, nH, spec, units)

    lam = np.where(eligible, rho * vol / mstar * dt / tstar_code, 0.0)
    nnew = rng.poisson(lam)
    # cap: at most 90% of the cell's gas (``:569``)
    cap = (0.9 * rho * vol / mstar).astype(np.int64)
    nnew = np.minimum(nnew, np.maximum(cap, 0))
    idx = np.argwhere(nnew > 0)
    if len(idx) == 0:
        return u, p, next_id

    counts = nnew[tuple(idx.T)]
    cells = tuple(idx.T)
    xnew = (idx + 0.5) * dx
    vel = np.stack([u[1 + d][cells] / np.maximum(u[0][cells], 1e-300)
                    for d in range(ndim)], axis=1)
    p2, next_id, kept = append_stars(p, xnew, vel, counts, mstar, t,
                                     next_id)
    if kept.sum() == 0:
        return u, p, next_id

    # remove exactly the gas that became stars, at the cell velocity
    # (momentum/energy scale proportionally)
    dm = kept * mstar / vol
    frac = 1.0 - dm / rho[cells]
    for iv in range(u.shape[0]):
        u[iv][cells] = u[iv][cells] * frac
    return u, p2, next_id


def sn_due_mask(f, spec: SfSpec, units: Units, t: float):
    """Active stars past the SN delay whose event hasn't fired; ``f`` a
    :class:`ParticleSet` or its host fields (:func:`host_particles`)."""
    if isinstance(f, ParticleSet):
        f = host_particles(f)
    age_code = t - f["tp"]
    t_sne_code = spec.t_sne * 1e6 * yr2sec / units.scale_t
    return (f["active"].astype(bool)
            & (f["family"] == FAM_STAR)
            & (f["flags"] & FLAG_SN_DONE == 0)
            & (age_code > t_sne_code))


def mark_sn_done(p: ParticleSet, f: dict, due, mej) -> ParticleSet:
    """``p`` with the ejecta ``mej`` taken from the due stars' masses and
    their SN flag set (``f`` its host fields, changed in place)."""
    f["m"][due] = f["m"][due] - mej
    f["flags"][due] |= FLAG_SN_DONE
    return particles_like(p, f)


def thermal_feedback(u, p: ParticleSet, spec: SfSpec, units: Units,
                     dx: float, t: float):
    """Delayed thermal SN dumps (``pm/feedback.f90:6-231,351``): stars
    older than t_sne return eta_sn of their mass and inject
    1e51 erg / 10 Msun of specific ejecta energy into their cell, once."""
    if spec.eta_sn <= 0:
        return u, p
    u = np.array(u)
    ndim = u.ndim - 1
    vol = dx ** ndim
    f = host_particles(p)
    due = sn_due_mask(f, spec, units, t)
    if not due.any():
        return u, p

    esn_code = (1e51 / (10.0 * M_SUN)) / units.scale_v ** 2
    xdue = f["x"][due]
    mdue = f["m"][due]
    mej = spec.eta_sn * mdue
    cells = tuple(np.clip((xdue[:, d] / dx).astype(np.int64), 0,
                          u.shape[1 + d] - 1) for d in range(ndim))
    np.add.at(u[0], cells, mej / vol)
    vstar = f["v"][due]
    for d in range(ndim):
        np.add.at(u[1 + d], cells, mej * vstar[:, d] / vol)
    # kinetic energy of the returned mass + SN thermal energy
    ek = 0.5 * mej * (vstar ** 2).sum(axis=1)
    np.add.at(u[1 + ndim], cells, (ek + mej * esn_code) / vol)
    return u, mark_sn_done(p, f, due, mej)


def wind_shell(ndim: int):
    """(offsets [nc, ndim], rhat [nc, ndim]) of the 3^ndim SN bubble — the
    one-cell ``rbubble`` of the kinetic scheme; the central cell's unit
    vector is zero (its share of the wind energy goes thermal)."""
    offs = (np.indices((3,) * ndim).reshape(ndim, -1).T - 1)
    rr = np.sqrt((offs ** 2).sum(axis=1))
    rhat = np.where(rr[:, None] > 0, offs / np.maximum(rr[:, None], 1.0),
                    0.0)
    return offs, rhat


def kinetic_feedback(u, p: ParticleSet, spec: SfSpec, units: Units,
                     dx: float, t: float, bc=None):
    """Delayed KINETIC SN winds, the mass-loaded momentum scheme (Dubois &
    Teyssier; ``pm/feedback.f90`` f_w path): each event sweeps ``f_w`` x
    the ejecta mass from the host cell and launches ``(1+f_w)·m_ej``
    through the 3^ndim bubble with the wind speed ``v_w = sqrt(2 E_SN /
    m_load)`` radially outward; the central share of the wind energy is
    deposited thermally.  Bubble cells across a non-periodic wall of
    ``bc`` (a :class:`ramses_tpu_torch.grid.boundary.BoundarySpec`) fold
    into the host cell."""
    if spec.eta_sn <= 0:
        return u, p
    u = np.array(u)
    ndim = u.ndim - 1
    vol = dx ** ndim
    f = host_particles(p)
    due = sn_due_mask(f, spec, units, t)
    if not due.any():
        return u, p

    esn_code = (1e51 / (10.0 * M_SUN)) / units.scale_v ** 2
    xdue = f["x"][due]
    mej = spec.eta_sn * f["m"][due]
    vstar = f["v"][due]
    cells = np.stack([np.clip((xdue[:, d] / dx).astype(np.int64), 0,
                              u.shape[1 + d] - 1)
                      for d in range(ndim)], axis=1)      # [nsn, ndim]

    # sweep up f_w*mej from the host cell, capped at 25% of its gas; SNe
    # sharing a host cell debit it ONCE for their combined draw (group per
    # unique cell, cap the total, hand each SN its proportional share)
    host = tuple(cells.T)
    lin = np.ravel_multi_index(host, u.shape[1:])
    uniq, inv = np.unique(lin, return_inverse=True)
    flat = u.reshape(u.shape[0], -1)
    mcell_u = flat[0][uniq] * vol
    tot_req = np.bincount(inv, weights=spec.f_w * mej)
    tot_allow = np.minimum(tot_req, 0.25 * mcell_u)
    msw = spec.f_w * mej * (tot_allow
                            / np.maximum(tot_req, 1e-300))[inv]
    mcell = mcell_u[inv]
    vcell = np.stack([flat[1 + d][uniq][inv]
                      / np.maximum(flat[0][uniq][inv], 1e-300)
                      for d in range(ndim)], axis=1)
    e_removed = (msw / np.maximum(mcell, 1e-300)
                 * flat[1 + ndim][uniq][inv] * vol)
    frac_u = 1.0 - tot_allow / np.maximum(mcell_u, 1e-300)
    flat[:, uniq] *= frac_u

    # launch the loaded shell: the bulk velocity carries the combined
    # momentum of ejecta + swept gas, the radial kick the SN energy
    mload = mej + msw
    vw = np.sqrt(2.0 * esn_code * mej / np.maximum(mload, 1e-300))
    offs, rhat = wind_shell(ndim)
    nc = len(offs)
    vbulk = (mej[:, None] * vstar + msw[:, None] * vcell) \
        / np.maximum(mload[:, None], 1e-300)
    e_inj = np.zeros(len(mej))

    def wall(d, side):
        return bc is not None and bc.faces[d][side].kind != 0

    for k in range(nc):
        raw = cells + offs[k]
        oob = np.zeros(len(mej), dtype=bool)
        for d in range(ndim):
            n = u.shape[1 + d]
            if wall(d, 0):
                oob |= raw[:, d] < 0
            if wall(d, 1):
                oob |= raw[:, d] >= n
        tgt = tuple(np.where(oob, cells[:, d],
                             raw[:, d] % u.shape[1 + d])
                    for d in range(ndim))
        central = np.logical_or(bool((offs[k] == 0).all()), oob)
        mshare = mload / nc
        vk = np.where(central[:, None], vbulk,
                      vbulk + vw[:, None] * rhat[k])
        np.add.at(u[0], tgt, mshare / vol)
        for d in range(ndim):
            np.add.at(u[1 + d], tgt, mshare * vk[:, d] / vol)
        ek = 0.5 * mshare * (vk ** 2).sum(axis=1)
        np.add.at(u[1 + ndim], tgt, ek / vol)
        e_inj += ek
    # exact energy budget: removed host energy + SN energy + ejecta bulk
    # KE, minus what the shell kicks already carry, lands as heat in the
    # host cell (the shock-heated mixing term)
    e_target = (e_removed + mej * esn_code
                + 0.5 * mej * (vstar ** 2).sum(axis=1))
    np.add.at(u[1 + ndim], host, (e_target - e_inj) / vol)
    return u, mark_sn_done(p, f, due, mej)
