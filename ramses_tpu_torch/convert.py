"""Carry a JAX run's configuration and state across to the port.

These models have no weights: what the two packages share is the solver
configuration and the state.  The functions here take plain attributes
and numpy arrays, so they need nothing of the JAX package itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ramses_tpu_torch.hydro.core import HydroStatic


def hydro_static_from(obj) -> HydroStatic:
    """The port's :class:`HydroStatic` built field by field from any
    object with the same attributes (such as the JAX package's)."""
    kw = {}
    for f in dataclasses.fields(HydroStatic):
        v = getattr(obj, f.name)
        kw[f.name] = tuple(v) if isinstance(v, (list, tuple)) else v
    return HydroStatic(**kw)


def state_from_numpy(u: np.ndarray, device, dtype=torch.float32
                     ) -> torch.Tensor:
    """A ``[nvar, *sp]`` numpy array (e.g. ``np.asarray(state.u)``) as a
    contiguous tensor of ``dtype`` on ``device`` (always a copy)."""
    return torch.tensor(np.asarray(u), dtype=dtype, device=device)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def amr_state_from(sim) -> dict:
    """The hierarchy of an AMR simulation of either package (a JAX
    ``AmrSim`` or the port's) as numpy arrays: the keyword arguments of
    :meth:`ramses_tpu_torch.amr.hierarchy.AmrSim.from_state` (per-level
    oct coordinates, state rows and padded oct counts, time and step
    count)."""
    levels = sim.levels()
    return dict(tree_og={l: _host(sim.tree.levels[l].og) for l in levels},
                rows={l: _host(sim.u[l]) for l in levels},
                noct_pad={l: int(sim.maps[l].noct_pad) for l in levels},
                t=float(sim.t), nstep=int(sim.nstep))
