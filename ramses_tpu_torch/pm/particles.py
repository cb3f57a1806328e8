"""Particle storage and particle-mesh operations on the uniform grid
(PyTorch).

Port of ``ramses_tpu/pm/particles.py``.  Reference equivalents:
  storage        ``pm/pm_commons.f90:46-96`` (SoA xp/vp/mp/tp/zp/idp/typep)
  deposition     ``pm/rho_fine.f90`` (``cic_amr:343``, ``tsc_amr:1148``)
  force gather   ``pm/move_fine.f90:255-510`` (inverse-CIC interpolation)
  kick           ``pm/synchro_fine.f90:513-538`` (v += f * 0.5*dt)
  drift          ``pm/move_fine.f90:540-550``  (x += v * dt)
  timestep       ``pm/newdt_fine.f90:186-233`` (Courant on particle v)

Particles live in fixed-size tensors (``npartmax``, the reference's hard
memory ceiling, ``amr/amr_parameters.f90:84``) with an ``active`` mask:
inactive lanes have mass 0.  The float dtype is the caller's (the driver's
dtype on the card, f64 in the tests); ids are int64.  A deposit sums
each cell's entries in a fixed order, the JAX package's scatter order
(corner by corner, each corner's particles in turn): the entries sorted
stably by cell and each cell's run summed by ``segment_reduce``, with no
atomic adds on the card, as the hierarchy's deposits
(:mod:`ramses_tpu_torch.pm.amr_pm`) do; so two runs of one state deposit
bitwise the same density.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from dataclasses import replace as dreplace
from typing import Optional, Tuple

import numpy as np
import torch

# default lane budget for runs that keep creating particles (the
# reference's npartmax static ceiling, amr/amr_parameters.f90:84, when
# the namelist leaves it unset)
DEFAULT_HEADROOM = 100000


def lane_headroom(params, grows: bool):
    """Particle lane budget: ``npartmax`` when set, else the default
    headroom for particle-creating runs (SF/sinks), else None (exact
    fit)."""
    if params.amr.npartmax:
        return int(params.amr.npartmax)
    return DEFAULT_HEADROOM if grows else None


# particle families (pm/pm_commons.f90:72-96)
FAM_GAS_TRACER = 0
# base of the gas-tracer id space: assigned once at seeding, stable
# across dumps, clear of the incremental star/DM id space
TRACER_ID0 = 1 << 30
FAM_DM = 1
FAM_STAR = 2
FAM_CLOUD = 3
FAM_DEBRIS = 4
FAM_UNDEF = 127


@dataclass
class ParticleSet:
    """SoA particle tensors; inactive lanes have mass 0 and active=False."""
    x: torch.Tensor          # [n, ndim] positions, user units [0, boxlen)
    v: torch.Tensor          # [n, ndim] velocities
    m: torch.Tensor          # [n] masses
    active: torch.Tensor     # [n] bool
    idp: torch.Tensor        # [n] int64 ids
    family: torch.Tensor     # [n] int8 family codes
    tp: torch.Tensor         # [n] birth time (stars)
    zp: torch.Tensor         # [n] metallicity (stars)
    flags: torch.Tensor      # [n] int8 event bookkeeping (e.g. SN done)

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def ndim(self) -> int:
        return self.x.shape[1]

    @classmethod
    def make(cls, x, v, m, *, dtype, device, idp=None, family=None,
             nmax: Optional[int] = None) -> "ParticleSet":
        """Lanes ``0..n-1`` from host arrays (or tensors) ``x``, ``v``
        ``[n, ndim]`` and ``m [n]`` in ``dtype`` on ``device``; ``nmax``
        lanes in all, the rest inactive (ids ``1..nmax`` unless given,
        family DM unless given)."""
        def t(a, dt):
            if not torch.is_tensor(a):
                a = np.array(a)
            return torch.as_tensor(a, dtype=dt, device=device)

        x, v, m = t(x, dtype), t(v, dtype), t(m, dtype)
        n = x.shape[0]
        nmax = nmax or n
        pad = nmax - n
        if pad:
            x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
            v = torch.cat([v, v.new_zeros((pad, v.shape[1]))])
            m = torch.cat([m, m.new_zeros(pad)])
        active = torch.arange(nmax, device=device) < n
        if idp is not None:
            idp = torch.cat([t(idp, torch.int64),
                             torch.zeros(pad, dtype=torch.int64,
                                         device=device)])
        else:
            idp = torch.arange(1, nmax + 1, dtype=torch.int64, device=device)
        if family is not None:
            family = torch.cat([t(family, torch.int8),
                                torch.zeros(pad, dtype=torch.int8,
                                            device=device)])
        else:
            family = torch.full((nmax,), FAM_DM, dtype=torch.int8,
                                device=device)
        zero = torch.zeros(nmax, dtype=dtype, device=device)
        return cls(x=x, v=v, m=m, active=active, idp=idp, family=family,
                   tp=zero, zp=zero.clone(),
                   flags=torch.zeros(nmax, dtype=torch.int8, device=device))

    def where(self, keep, other: "ParticleSet") -> "ParticleSet":
        """Each field from ``self`` where the 0-d bool ``keep`` holds, else
        from ``other`` (the masked step of a device loop)."""
        return ParticleSet(**{
            f: torch.where(keep, getattr(self, f), getattr(other, f))
            for f in self.__dataclass_fields__})

    def count(self, family: int) -> int:
        """Active particles of ``family`` (one fetch)."""
        return int(torch.sum(self.active & (self.family == family)))

    def to_host(self) -> dict:
        """Every field as a numpy array (one fetch a field)."""
        return {f: getattr(self, f).cpu().numpy()
                for f in self.__dataclass_fields__}


def _linear(idx, shape):
    """Row-major flat index of per-dim index tensors ``idx``."""
    lin = idx[0]
    for d in range(1, len(shape)):
        lin = lin * shape[d] + idx[d]
    return lin


def _cic_corners(x, shape: Tuple[int, ...], dx: float):
    """CIC cell indices + weights: returns [(idx per dim, w)] per corner."""
    ndim = x.shape[1]
    s = x / dx - 0.5                      # position in cell-center coords
    i0 = torch.floor(s)
    frac = s - i0                          # weight of the +1 corner
    i0 = i0.to(torch.int64)
    corners = []
    for bits in range(2 ** ndim):
        idx, w = [], None
        for d in range(ndim):
            b = (bits >> d) & 1
            idx.append((i0[:, d] + b) % shape[d])
            wd = frac[:, d] if b else (1.0 - frac[:, d])
            w = wd if w is None else w * wd
        corners.append((idx, w))
    return corners


def _scatter(shape, dtype, device, entries):
    """Dense ``[*shape]`` sum of ``(idx per dim, value)`` entries: each
    cell's values added in the entries' order (entry by entry, each
    entry's particles in turn), from 0.  Every index lies on the grid (a
    periodic wrap), so the cells' runs of the stably sorted keys are found
    by ``searchsorted``, with no fetch to the host."""
    keys, vals = zip(*((_linear(idx, shape), val) for idx, val in entries))
    key = torch.cat(keys)
    order = torch.argsort(key, stable=True)
    key = key[order]
    ncell = math.prod(shape)
    offsets = torch.searchsorted(
        key, torch.arange(ncell + 1, dtype=key.dtype, device=device))
    rho = torch.segment_reduce(torch.cat(vals).to(dtype)[order], "sum",
                               offsets=offsets, unsafe=True)
    return rho.reshape(shape)


def deposit_cic(p: ParticleSet, shape: Tuple[int, ...], dx: float):
    """CIC mass deposition → density grid [*shape] (``cic_amr``,
    ``pm/rho_fine.f90:343``)."""
    w0 = p.m * p.active
    vol = float(np.prod([dx] * p.ndim))
    rho = _scatter(shape, p.x.dtype, p.x.device,
                   ((idx, w0 * w) for idx, w in _cic_corners(p.x, shape,
                                                              dx)))
    return rho / vol


def deposit_ngp(p: ParticleSet, shape: Tuple[int, ...], dx: float):
    """Nearest-grid-point deposition (``interp_mode`` NGP path)."""
    w0 = p.m * p.active
    i = torch.floor(p.x / dx).to(torch.int64)
    idx = [i[:, d] % shape[d] for d in range(p.ndim)]
    vol = float(np.prod([dx] * p.ndim))
    return _scatter(shape, p.x.dtype, p.x.device, [(idx, w0)]) / vol


def _tsc_w(t):
    """TSC kernel weights for offsets (-1, 0, +1); t = frac offset."""
    return (0.5 * (0.5 - t) ** 2, 0.75 - t * t, 0.5 * (0.5 + t) ** 2)


def _tsc_stencil(x, dx: float):
    s = x / dx - 0.5
    ic = torch.round(s)                          # nearest cell center
    t = s - ic                                   # in [-0.5, 0.5]
    ic = ic.to(torch.int64)
    return ic, [_tsc_w(t[:, d]) for d in range(x.shape[1])]


def deposit_tsc(p: ParticleSet, shape: Tuple[int, ...], dx: float):
    """Triangular-shaped-cloud deposition (``tsc_amr``,
    ``pm/rho_fine.f90:1148``)."""
    w0 = p.m * p.active
    ic, wd = _tsc_stencil(p.x, dx)
    vol = float(np.prod([dx] * p.ndim))

    def entries():
        for offs in itertools.product((-1, 0, 1), repeat=p.ndim):
            idx, w = [], w0
            for d, o in enumerate(offs):
                idx.append((ic[:, d] + o) % shape[d])
                w = w * wd[d][o + 1]
            yield idx, w

    return _scatter(shape, p.x.dtype, p.x.device, entries()) / vol


def _sample(field, idx, shape):
    """``field[:, idx...]`` → ``[ncomp, n]``."""
    return field.reshape(field.shape[0], -1)[:, _linear(idx, shape)]


def gather_cic(field, x, dx: float):
    """Inverse CIC: interpolate a [ncomp, *shape] field at positions x.

    Returns [n, ncomp] (``move_fine`` force interpolation,
    ``pm/move_fine.f90:255-510``)."""
    shape = tuple(field.shape[1:])
    out = field.new_zeros((x.shape[0], field.shape[0]))
    for idx, w in _cic_corners(x, shape, dx):
        out = out + (_sample(field, idx, shape) * w).T
    return out


def gather_ngp(field, x, dx: float):
    """NGP field sampling, the pair of :func:`deposit_ngp`."""
    shape = tuple(field.shape[1:])
    i = torch.floor(x / dx).to(torch.int64)
    idx = [i[:, d] % shape[d] for d in range(x.shape[1])]
    return _sample(field, idx, shape).T


def gather_tsc(field, x, dx: float):
    """TSC field sampling, the pair of :func:`deposit_tsc`."""
    shape = tuple(field.shape[1:])
    ic, wd = _tsc_stencil(x, dx)
    out = field.new_zeros((x.shape[0], field.shape[0]))
    for offs in itertools.product((-1, 0, 1), repeat=x.shape[1]):
        idx, w = [], None
        for d, o in enumerate(offs):
            idx.append((ic[:, d] + o) % shape[d])
            w = wd[d][o + 1] if w is None else w * wd[d][o + 1]
        out = out + (_sample(field, idx, shape) * w).T
    return out


def kick(p: ParticleSet, f_at_p, dteff) -> ParticleSet:
    """v += f * dteff (``synchro_fine``; dteff is usually 0.5*dt)."""
    return dreplace(p, v=p.v + f_at_p * dteff * p.active[:, None])


def drift(p: ParticleSet, dt, boxlen: float,
          periodic: bool = True) -> ParticleSet:
    """x += v*dt with periodic wrap (``move_fine:540-550``).

    ``periodic=False``: open box — positions do not wrap; particles that
    leave [0, boxlen) are deactivated (the reference removes escapers from
    non-periodic domains in ``kill_tree_fine``) and parked at the origin so
    that stale coordinates cannot alias the maps."""
    x = p.x + p.v * dt * p.active[:, None]
    if periodic:
        return dreplace(p, x=x % boxlen)
    inside = torch.all((x >= 0.0) & (x < boxlen), dim=1)
    act = p.active & inside
    return dreplace(p, x=torch.where(act[:, None], x, 0.0), active=act)


def particle_dt(p: ParticleSet, dx: float, courant_factor: float):
    """Courant-type dt on particle velocities (``newdt2``,
    ``pm/newdt_fine.f90:186-233``): dt = cf*dx/max_component(|v|), a 0-d
    tensor (1e30 without a moving particle)."""
    v2 = torch.max(p.v * p.v, dim=1).values          # max component^2
    v2 = torch.where(p.active, v2, 0.0)
    vmax = torch.sqrt(torch.max(v2)) if v2.numel() else v2.new_zeros(())
    return torch.where(vmax > 0.0,
                       courant_factor * dx / torch.clamp(vmax, min=1e-30),
                       torch.full((), 1e30, dtype=p.v.dtype,
                                  device=p.v.device))


def freefall_dt(rho_max, courant_factor: float, fourpi):
    """Free-fall constraint (``pm/newdt_fine.f90:51-60``):
    dt <= cf * sqrt(3*pi^2 / (8 * fourpi * rho_max)); a host ``rho_max``
    is taken in f64."""
    threepi2 = 3.0 * math.pi ** 2
    if not torch.is_tensor(rho_max):
        rho_max = torch.tensor(rho_max, dtype=torch.float64)
    tff = torch.sqrt(threepi2 / 8.0 / fourpi
                     / torch.clamp(rho_max, min=1e-30))
    return courant_factor * tff
