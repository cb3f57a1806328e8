"""Sink particles: creation, accretion, merging, motion (host numpy).

The port's own copy of ``ramses_tpu/pm/sinks.py``, the capability core of
``pm/sink_particle.f90``: density-threshold creation at local maxima,
Bondi and threshold accretion (``grow_sink:575``, ``accrete_sink:722``),
the AGN thermal dump, pairwise merging, and leapfrog motion in the gas
gravity field with the optional direct sink-sink force.  Sinks are few
(thousands at most), so, as in the JAX package, their bookkeeping is host
numpy in float64; the drivers fetch the gas state they touch and put the
changed rows back on the device (:func:`ramses_tpu_torch.pm.amr_physics.
sink_passes_amr` on the hierarchy, ``Simulation._source_passes`` on the
uniform grid).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ramses_tpu_torch.units import C_CGS, Units, factG_in_cgs


@dataclass(frozen=True)
class SinkSpec:
    """&SINK_PARAMS subset (pm/read_sink_feedback_params.f90)."""
    enabled: bool = False
    n_sink: float = 1e10           # creation threshold [H/cc]
    accretion_scheme: str = "bondi"   # bondi | threshold | none
    c_acc: float = 0.75            # threshold-accretion fraction
    r_acc_cells: float = 2.0       # accretion radius in cells
    merging_cells: float = 2.0     # merge radius in cells
    nsinkmax: int = 1000
    # AGN thermal feedback (``pm/sink_particle.f90`` agn branch /
    # Teyssier+11): E = eps_c * eps_r * dM c^2 dumped into the host
    # cell; the radiated eps_r share never reaches the sink mass
    agn: bool = False
    eps_r: float = 0.1             # radiative efficiency
    eps_c: float = 0.15            # coupling efficiency
    # direct sink-sink N^2 gravity during the drift (the reference's
    # ``direct_force_sink`` smbh option)
    direct_force: bool = False
    # cloud sampling: accretion samples a lattice of cloud points
    # within radius 0.5*ir_cloud*dx_min (``create_cloud_from_sink``,
    # pm/sink_particle.f90:131); 1 = host cell only
    ir_cloud: int = 4

    @classmethod
    def from_params(cls, p) -> "SinkSpec":
        raw = p.raw.get("sink_params", {}) if p.raw else {}

        def g(k, dflt):
            v = raw.get(k, dflt)
            return v[0] if isinstance(v, list) else v

        return cls(enabled=bool(g("create_sinks", False)),
                   n_sink=float(g("n_sink", 1e10)),
                   accretion_scheme=str(g("accretion_scheme", "bondi")),
                   c_acc=float(g("c_acc", 0.75)),
                   r_acc_cells=float(g("r_acc_cells", 2.0)),
                   merging_cells=float(g("merging_cells", 2.0)),
                   nsinkmax=int(g("nsinkmax", 1000)),
                   agn=bool(g("agn", False)),
                   eps_r=float(g("eps_r", 0.1)),
                   eps_c=float(g("eps_c", 0.15)),
                   direct_force=bool(g("direct_force", False)),
                   ir_cloud=int(g("ir_cloud", 4)))


def cloud_offsets(ndim: int, ir_cloud: int, dx: float) -> np.ndarray:
    """Cloud-point offsets: a dx/2-spaced lattice inside radius
    ``0.5*ir_cloud*dx`` (the reference's sink cloud particles,
    ``create_cloud_from_sink`` — equal-weight points that let the
    accretion kernel resolve the Bondi radius instead of sampling one
    host cell).  Always includes the centre point."""
    if ir_cloud <= 1:
        return np.zeros((1, ndim))
    half = 0.5 * dx
    r = 0.5 * ir_cloud * dx
    k = int(np.floor(r / half))
    ax = np.arange(-k, k + 1) * half
    grids = np.meshgrid(*([ax] * ndim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    return pts[(pts ** 2).sum(axis=1) <= r * r + 1e-12]


@dataclass
class SinkSet:
    """SoA sink arrays (host)."""
    x: np.ndarray          # [n, ndim]
    v: np.ndarray          # [n, ndim]
    m: np.ndarray          # [n]
    tform: np.ndarray      # [n]
    idp: np.ndarray        # [n]
    next_id: int = 1

    @classmethod
    def empty(cls, ndim: int) -> "SinkSet":
        return cls(x=np.zeros((0, ndim)), v=np.zeros((0, ndim)),
                   m=np.zeros(0), tform=np.zeros(0),
                   idp=np.zeros(0, dtype=np.int64))

    @property
    def n(self) -> int:
        return len(self.m)


def create_sinks(u, sinks: SinkSet, spec: SinkSpec, units: Units,
                 dx: float, t: float, gamma: float):
    """Threshold creation (``create_sink:6``): cells above n_sink that are
    local density maxima and farther than the merge radius from existing
    sinks convert their excess gas into a new sink."""
    u = np.array(u)
    ndim = u.ndim - 1
    vol = dx ** ndim
    rho = u[0]
    nH = rho * units.scale_nH
    d_thr = spec.n_sink / units.scale_nH
    cand = nH > spec.n_sink
    if not cand.any() or sinks.n >= spec.nsinkmax:
        return u, sinks

    # local maximum over the 3^ndim neighbourhood (periodic)
    is_max = np.ones_like(cand)
    for d in range(ndim):
        for s in (-1, 1):
            is_max &= rho >= np.roll(rho, s, axis=d)
    cand &= is_max
    idx = np.argwhere(cand)
    if len(idx) == 0:
        return u, sinks

    xnew = (idx + 0.5) * dx
    # respect exclusion radius around existing sinks
    if sinks.n:
        d2 = ((xnew[:, None, :] - sinks.x[None, :, :]) ** 2).sum(-1)
        ok = (d2 > (spec.merging_cells * dx) ** 2).all(axis=1)
        idx, xnew = idx[ok], xnew[ok]
    room = spec.nsinkmax - sinks.n
    idx, xnew = idx[:room], xnew[:room]
    if len(idx) == 0:
        return u, sinks

    cells = tuple(idx.T)
    dm_rho = np.maximum(rho[cells] - d_thr, 0.0)
    mnew = dm_rho * vol
    vel = np.stack([u[1 + d][cells] / rho[cells] for d in range(ndim)],
                   axis=1)
    frac = 1.0 - dm_rho / rho[cells]
    for iv in range(u.shape[0]):
        u[iv][cells] = u[iv][cells] * frac

    sinks = SinkSet(
        x=np.concatenate([sinks.x, xnew]),
        v=np.concatenate([sinks.v, vel]),
        m=np.concatenate([sinks.m, mnew]),
        tform=np.concatenate([sinks.tform, np.full(len(idx), t)]),
        idp=np.concatenate([sinks.idp, sinks.next_id
                            + np.arange(len(idx), dtype=np.int64)]),
        next_id=sinks.next_id + len(idx))
    return u, sinks


def accrete(u, sinks: SinkSet, spec: SinkSpec, units: Units, dx: float,
            dt: float, gamma: float):
    """Accretion onto sinks (``grow_sink:575``, ``accrete_sink:722``).

    bondi:     mdot = 4π G² M² ρ / (c_s² + v_rel²)^{3/2}
    threshold: remove c_acc of the gas above n_sink in the host cell
    Both capped at 90% of the host cell's gas.
    """
    if sinks.n == 0 or spec.accretion_scheme == "none":
        return u, sinks
    u = np.array(u)
    ndim = u.ndim - 1
    vol = dx ** ndim
    shape = u.shape[1:]
    cells = tuple(np.clip((sinks.x[:, d] / dx).astype(np.int64), 0,
                          shape[d] - 1) for d in range(ndim))
    rho = u[0][cells]
    vgas = np.stack([u[1 + d][cells] / np.maximum(rho, 1e-300)
                     for d in range(ndim)], axis=1)
    ek = 0.5 * (np.stack([u[1 + d][cells] for d in range(ndim)], axis=1)
                ** 2).sum(1) / np.maximum(rho, 1e-300)
    press = (gamma - 1.0) * (u[1 + ndim][cells] - ek)
    cs2 = gamma * np.maximum(press, 1e-300) / np.maximum(rho, 1e-300)

    if spec.accretion_scheme == "bondi":
        # G in code units: G_code = G_cgs * scale_d * scale_t^2
        g_code = factG_in_cgs * units.scale_d * units.scale_t ** 2
        vrel2 = ((sinks.v - vgas) ** 2).sum(1)
        mdot = (4 * np.pi * g_code ** 2 * sinks.m ** 2 * rho
                / np.maximum(cs2 + vrel2, 1e-300) ** 1.5)
        dm = np.minimum(mdot * dt, 0.9 * rho * vol)
    else:  # threshold
        d_thr = spec.n_sink / units.scale_nH
        dm = np.minimum(spec.c_acc * np.maximum(rho - d_thr, 0.0) * vol,
                        0.9 * rho * vol)

    dm_rho = dm / vol
    frac = 1.0 - dm_rho / np.maximum(rho, 1e-300)
    # conservative momentum transfer: sink absorbs gas momentum
    mom_g = np.stack([u[1 + d][cells] for d in range(ndim)], axis=1)
    p_acc = mom_g * (dm_rho / np.maximum(rho, 1e-300))[:, None] * vol
    for iv in range(u.shape[0]):
        np.multiply.at(u[iv], cells, frac)
    m_gain = dm
    if spec.agn:
        # AGN thermal dump: eps_r of the accreted rest mass radiates,
        # eps_c of that couples to the host cell's gas energy
        e_agn, m_gain = agn_energy(dm, spec, units)
        np.add.at(u[1 + ndim], cells, e_agn / vol)
    newm = sinks.m + m_gain
    sinks.v = (sinks.v * sinks.m[:, None] + p_acc) \
        / np.maximum(newm, 1e-300)[:, None]
    sinks.m = newm
    return u, sinks


def agn_energy(dm: np.ndarray, spec: SinkSpec, units: Units):
    """(coupled AGN energy [code], sink mass gain) for accreted gas
    ``dm`` — the Teyssier+11 thermal quasar mode: L = eps_r dM c²,
    a fraction eps_c heats the host cell, the radiated share never
    reaches the sink (``pm/sink_particle.f90`` AGN branch)."""
    c_code = C_CGS / units.scale_v
    e_agn = spec.eps_c * spec.eps_r * dm * c_code ** 2
    return e_agn, (1.0 - spec.eps_r) * dm


def sink_sink_accel(sinks: SinkSet, g_code: float, soft: float,
                    boxlen: Optional[float] = None) -> np.ndarray:
    """Direct N² sink-sink gravitational acceleration with Plummer
    softening (``direct_force_sink``; N is tiny, so the all-pairs
    host loop is free).  ``boxlen`` applies the minimum-image
    convention — positions are stored wrapped, so a pair straddling a
    periodic face must attract ACROSS it."""
    x = sinks.x
    dxij = x[None, :, :] - x[:, None, :]          # [i, j, ndim]
    if boxlen is not None:
        dxij = dxij - boxlen * np.round(dxij / boxlen)
    r2 = (dxij ** 2).sum(-1) + soft ** 2
    np.fill_diagonal(r2, 1.0)
    w = g_code * sinks.m[None, :] / r2 ** 1.5
    np.fill_diagonal(w, 0.0)
    return (w[:, :, None] * dxij).sum(axis=1)


def direct_force_kick(sinks: SinkSet, units: Units, dx: float,
                      dt: float, boxlen: Optional[float]) -> SinkSet:
    """Apply the sink-sink N² kick (shared by the uniform and AMR
    drift paths; softening = dx/2 at the force resolution)."""
    if sinks.n < 2:
        return sinks
    g_code = factG_in_cgs * units.scale_d * units.scale_t ** 2
    sinks.v = sinks.v + sink_sink_accel(sinks, g_code, 0.5 * dx,
                                        boxlen=boxlen) * dt
    return sinks


def merge_sinks(sinks: SinkSet, spec: SinkSpec, dx: float) -> SinkSet:
    """Pairwise merge within the merge radius, conserving mass/momentum."""
    n = sinks.n
    if n < 2:
        return sinks
    alive = np.ones(n, dtype=bool)
    r2 = (spec.merging_cells * dx) ** 2
    order = np.argsort(-sinks.m)            # heaviest survives
    for a in order:
        if not alive[a]:
            continue
        d2 = ((sinks.x - sinks.x[a]) ** 2).sum(1)
        near = alive & (d2 < r2)
        near[a] = False
        if near.any():
            mt = sinks.m[a] + sinks.m[near].sum()
            sinks.x[a] = (sinks.x[a] * sinks.m[a]
                          + (sinks.x[near] * sinks.m[near, None]).sum(0)) / mt
            sinks.v[a] = (sinks.v[a] * sinks.m[a]
                          + (sinks.v[near] * sinks.m[near, None]).sum(0)) / mt
            sinks.m[a] = mt
            alive[near] = False
    return SinkSet(x=sinks.x[alive], v=sinks.v[alive], m=sinks.m[alive],
                   tform=sinks.tform[alive], idp=sinks.idp[alive],
                   next_id=sinks.next_id)


def drift_kick(sinks: SinkSet, f_field, dx: float, dt: float,
               boxlen: float, spec: Optional[SinkSpec] = None,
               units: Optional[Units] = None) -> SinkSet:
    """Leapfrog sink motion in the gas gravity field (NGP gather),
    plus the optional direct sink-sink N² force."""
    if sinks.n == 0:
        return sinks
    if f_field is not None:
        f = np.asarray(f_field)
        ndim = sinks.x.shape[1]
        shape = f.shape[1:]
        cells = tuple(np.clip((sinks.x[:, d] / dx).astype(np.int64), 0,
                              shape[d] - 1) for d in range(ndim))
        acc = np.stack([f[d][cells] for d in range(ndim)], axis=1)
        sinks.v = sinks.v + acc * dt
    if spec is not None and spec.direct_force and units is not None:
        sinks = direct_force_kick(sinks, units, dx, dt, boxlen)
    sinks.x = np.mod(sinks.x + sinks.v * dt, boxlen)
    return sinks
