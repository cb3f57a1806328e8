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
    ``fg`` and ``poisson_iters`` per level).  The cached Courant dt of the
    next coarse step is not carried: the new sim computes its own."""
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
    counts, time and step count)."""
    return dict(amr_state_from(sim),
                bfs={l: _host(sim.bfs[l]) for l in sim.levels()})


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
