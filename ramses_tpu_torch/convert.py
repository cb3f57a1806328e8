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
