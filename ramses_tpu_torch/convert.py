"""Carry a JAX run's configuration and state across to the port.

These models have no weights: what the two packages share is the solver
configuration and the state.  The functions here take plain attributes
and numpy arrays, so they need nothing of the JAX package itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ramses_tpu_torch.amr.maps import GravityMaps
from ramses_tpu_torch.hydro.core import HydroStatic
from ramses_tpu_torch.mhd.core import MhdStatic


def _static_from(cls, obj):
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        kw[f.name] = tuple(v) if isinstance(v, (list, tuple)) else v
    return cls(**kw)


def hydro_static_from(obj) -> HydroStatic:
    """The port's :class:`HydroStatic` built field by field from any
    object with the same attributes (such as the JAX package's)."""
    return _static_from(HydroStatic, obj)


def mhd_static_from(obj) -> MhdStatic:
    """The port's :class:`MhdStatic` built field by field from any object
    with the same attributes (such as the JAX package's)."""
    return _static_from(MhdStatic, obj)


def state_from_numpy(u: np.ndarray, device, dtype=torch.float32
                     ) -> torch.Tensor:
    """A ``[nvar, *sp]`` numpy array (e.g. ``np.asarray(state.u)``) as a
    contiguous tensor of ``dtype`` on ``device`` (always a copy)."""
    return torch.tensor(np.asarray(u), dtype=dtype, device=device)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def mhd_state_from(sim) -> dict:
    """The state of a uniform MHD simulation of either package (a JAX
    ``MhdSimulation`` or the port's) as numpy arrays: the keyword
    arguments of :meth:`ramses_tpu_torch.mhd.driver.MhdSimulation.
    from_state` (``u [nvar, *sp]``, ``bf [3, *sp]``, time and step
    count)."""
    return dict(u=_host(sim.u), bf=_host(sim.bf), t=float(sim.t),
                nstep=int(sim.nstep))


def amr_state_from(sim) -> dict:
    """The hierarchy of an AMR simulation of either package (a JAX
    ``AmrSim`` or the port's) as numpy arrays: the keyword arguments of
    :meth:`ramses_tpu_torch.amr.hierarchy.AmrSim.from_state` (per-level
    oct coordinates, state rows and padded oct counts, time and step
    count, the last coarse step ``dt_old``; with MC tracers also their
    positions, ids and the state of the jump generator, so both packages
    draw the same numbers next; with gravity the last solve's ``phi``,
    ``fg`` and ``poisson_iters`` per level; with star formation or stellar
    objects the SF generator's state and the next star id
    (:func:`sf_state_from`), and the stellar objects).  The cached Courant
    dt of the next coarse step is not carried: the new sim computes its
    own."""
    levels = sim.levels()
    out = dict(tree_og={l: _host(sim.tree.levels[l].og) for l in levels},
               rows={l: _host(sim.u[l]) for l in levels},
               noct_pad={l: int(sim.maps[l].noct_pad) for l in levels},
               t=float(sim.t), nstep=int(sim.nstep),
               dt_old=float(sim.dt_old))
    if getattr(sim, "tracer_x", None) is not None:
        out.update(tracer_x=np.array(sim.tracer_x, dtype=np.float64),
                   tracer_id=np.array(sim.tracer_id, dtype=np.int64),
                   tracer_rng=sim._tracer_rng.bit_generator.state)
    sf = getattr(sim, "sf_spec", None)
    if (sf is not None and sf.enabled) or \
            getattr(sim, "stellar", None) is not None:
        out.update(sf_state_from(sim))
        if sim.stellar is not None:
            out.update(stellar=stellar_from(sim.stellar))
    if getattr(sim, "gravity", False) and sim.phi:
        out.update(phi={l: _host(v) for l, v in sim.phi.items()},
                   fg={l: _host(v) for l, v in sim.fg.items()},
                   poisson_iters={l: int(v)
                                  for l, v in sim.poisson_iters.items()})
    return out


def particles_from(p, dtype=torch.float64, device="cpu"):
    """A particle set of either package (a JAX ``ParticleSet`` or the
    port's) as the port's :class:`ramses_tpu_torch.pm.particles.
    ParticleSet` in ``dtype`` on ``device``: every lane, the inactive ones
    included, each field a copy."""
    from ramses_tpu_torch.pm.particles import ParticleSet
    f = {k: _host(getattr(p, k)) for k in ParticleSet.__dataclass_fields__}
    out = ParticleSet.make(f["x"], f["v"], f["m"], dtype=dtype,
                           device=device, idp=f["idp"], family=f["family"])
    out.active = torch.tensor(f["active"].astype(bool), device=device)
    out.tp = torch.tensor(f["tp"], dtype=dtype, device=device)
    out.zp = torch.tensor(f["zp"], dtype=dtype, device=device)
    out.flags = torch.tensor(f["flags"].astype(np.int8), device=device)
    return out


def gravity_maps_from(obj) -> GravityMaps:
    """The port's :class:`GravityMaps` built field by field from any object
    with the same attributes (such as the JAX package's host-built maps)."""
    return _static_from(GravityMaps, obj)


def mhd_amr_state_from(sim) -> dict:
    """The hierarchy of an MHD AMR simulation of either package (a JAX
    ``MhdAmrSim`` or the port's) as numpy arrays: the keyword arguments of
    :meth:`ramses_tpu_torch.mhd.amr.MhdAmrSim.from_state` (per-level oct
    coordinates, cell rows, face rows ``[ncell_pad, 3, 2]`` and padded oct
    counts, time and step count, and what :func:`amr_state_from` carries
    beside them: the last solve's ``phi``, ``fg`` and ``poisson_iters``
    with gravity, the tracers, ``dt_old``).  The particles go across
    through :func:`particles_from` (``from_state(..., particles=...)``)."""
    return dict(amr_state_from(sim),
                bfs={l: _host(sim.bfs[l]) for l in sim.levels()})


def sinks_from(sinks):
    """A sink set of either package as the port's
    :class:`ramses_tpu_torch.pm.sinks.SinkSet` (host numpy copies, the
    next id kept)."""
    from ramses_tpu_torch.pm.sinks import SinkSet
    return SinkSet(x=np.array(sinks.x, dtype=np.float64),
                   v=np.array(sinks.v, dtype=np.float64),
                   m=np.array(sinks.m, dtype=np.float64),
                   tform=np.array(sinks.tform, dtype=np.float64),
                   idp=np.array(sinks.idp, dtype=np.int64),
                   next_id=int(sinks.next_id))


def turb_from(turb, spec, device="cpu"):
    """A turbulence forcing of either package as the port's
    :class:`ramses_tpu_torch.turb.forcing.TurbForcing` on ``device`` with
    the same OU field (the port's ``spec``; its generator is seeded from
    ``turb_seed``, as a JAX package's key cannot be continued)."""
    from ramses_tpu_torch.turb.forcing import TurbForcing
    out = TurbForcing(turb.shape, spec, device=device)
    out.fhat = torch.tensor(np.asarray(_host(turb.fhat),
                                       dtype=np.complex128), device=device)
    return out


def shards_from_numpy(u, mesh, axis: int, dtype=None) -> list:
    """A global state as numpy (e.g. ``np.asarray`` of a JAX array sharded
    over a mesh) as the port's per-shard tensors on ``mesh`` (a
    :class:`ramses_tpu_torch.parallel.mesh.ShardMesh`): equal contiguous
    pieces along ``axis``, shard ``s`` the ``s``-th, each a copy."""
    return mesh.shard(np.asarray(u), axis, dtype=dtype)


def gather_shards(shards, axis: int) -> np.ndarray:
    """The port's per-shard tensors back as one numpy array, concatenated
    along ``axis`` (the JAX package's global view)."""
    return np.concatenate([_host(s) for s in shards], axis=axis)


def sf_state_from(sim) -> dict:
    """The star-formation bookkeeping of a simulation of either package:
    the bit-generator state of its SF generator (``_sf_rng``, which the
    stellar objects also draw from) and the next star id, as the keyword
    arguments ``sf_rng`` and ``next_star_id`` of the port's ``from_state``
    (so both packages draw the same numbers next)."""
    return dict(sf_rng=sim._sf_rng.bit_generator.state,
                next_star_id=int(sim._next_star_id))


def stellar_from(stellar):
    """A stellar-object set of either package as the port's
    :class:`ramses_tpu_torch.pm.stellar.StellarSet` (host numpy copies,
    the next id and the per-sink accumulators kept)."""
    from ramses_tpu_torch.pm.stellar import StellarSet
    return StellarSet(m=np.array(stellar.m, dtype=np.float64),
                      tform=np.array(stellar.tform, dtype=np.float64),
                      tlife=np.array(stellar.tlife, dtype=np.float64),
                      x=np.array(stellar.x, dtype=np.float64),
                      sink_idp=np.array(stellar.sink_idp, dtype=np.int64),
                      idp=np.array(stellar.idp, dtype=np.int64),
                      next_id=int(stellar.next_id),
                      dmf={int(k): float(v) for k, v in stellar.dmf.items()})


def cooling_tables_from(tables, device="cpu"):
    """Cooling tables of either package (a JAX ``CoolingTables`` or the
    port's) as the port's :class:`ramses_tpu_torch.hydro.cooling.
    CoolingTables` on ``device``, every table a float64 copy."""
    from ramses_tpu_torch.hydro.cooling import TABLE_NAMES, CoolingTables
    names = ("log_nH", "log_T2") + TABLE_NAMES + ("mu",)
    host = {n: np.array(_host(getattr(tables, n)), dtype=np.float64)
            for n in names}
    dev = torch.device(device)
    return CoolingTables(**{n: torch.tensor(host[n], device=dev)
                            for n in names}, host=host)


def rt_state_from(rt) -> dict:
    """The radiation state of a uniform RT run of either package (an
    ``RtSim``, or an ``RtCoupled`` and its injected-photon count) as numpy
    arrays in the JAX package's shapes: the keyword arguments of
    :meth:`ramses_tpu_torch.rt.coupling.RtCoupled.load_state` (N, F, x, T,
    nH, the sources src and src_F, xHe2/xHe3 with the 3-ion system, the
    time)."""
    sim = getattr(rt, "sim", rt)
    out = dict(N=_host(sim.N), F=_host(sim.F), x=_host(sim.x),
               T=_host(sim.T), nH=_host(sim.nH), src=_host(sim.src),
               src_F=None if sim.src_F is None else _host(sim.src_F),
               t=float(sim.t))
    if sim.spec.full3:
        out.update(xHe2=_host(sim.xHe2), xHe3=_host(sim.xHe3))
    if sim is not rt:
        out["injected"] = float(rt._injected)
    return out


def rt_amr_state_from(sim) -> dict:
    """The radiation rows of an AMR simulation of either package (its
    ``rt_amr``) as numpy arrays per level: the keyword arguments of
    :meth:`ramses_tpu_torch.rt.amr.RtAmrCoupled.load_state` (``rad``,
    ``xion``, ``xhe`` and the injected-photon count)."""
    rt = sim.rt_amr
    return dict(rad={l: _host(a) for l, a in rt.rad.items()},
                xion={l: _host(a) for l, a in rt.xion.items()},
                xhe={l: _host(a) for l, a in rt.xhe.items()},
                injected=float(rt._injected))
