"""Static hydro solver configuration.

The port's own copy of ``ramses_tpu/hydro/core.py``.  The reference bakes
these into the binary via cpp defines and module parameters
(``bin/Makefile:7-45``, ``hydro/hydro_parameters.f90:75-90``); here they
are a frozen, hashable dataclass that every solver function takes as its
static configuration.

State vector layout (channel-first, conservative):
    ``u[0]`` = density rho
    ``u[1 : 1+ndim]`` = momentum rho*v
    ``u[1+ndim]`` = total energy E
    ``u[2+ndim : 2+ndim+nener]`` = non-thermal energies
    ``u[2+ndim+nener : nvar]`` = passive scalars (rho*X)
Primitive layout is identical with velocity/pressure/specific scalars.
The innermost spatial axis is the contiguous one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ramses_tpu_torch.config import Params


@dataclass(frozen=True)
class HydroStatic:
    ndim: int = 3
    nener: int = 0
    npassive: int = 0
    gamma: float = 1.4
    gamma_rad: Tuple[float, ...] = ()
    smallr: float = 1e-10
    smallc: float = 1e-10
    slope_type: int = 1
    slope_theta: float = 1.5
    scheme: str = "muscl"
    riemann: str = "llf"
    niter_riemann: int = 10
    courant_factor: float = 0.5
    difmag: float = 0.0
    pressure_fix: bool = False
    beta_fix: float = 0.0       # truncation-error threshold coefficient
    # [nvar, *spatial, batch] layout switch of the JAX package's AMR oct
    # batches; kept so that a JAX HydroStatic converts field by field
    trailing_batch: bool = False

    @property
    def nvar(self) -> int:
        return self.ndim + 2 + self.nener + self.npassive

    @property
    def ienergy(self) -> int:
        """Index of total energy / pressure in the state vector."""
        return self.ndim + 1

    @property
    def smallp(self) -> float:
        return self.smallc ** 2 / self.gamma

    @property
    def smalle(self) -> float:
        return self.smallc ** 2 / self.gamma / (self.gamma - 1.0)

    @classmethod
    def from_params(cls, p: Params) -> "HydroStatic":
        h = p.hydro
        # gamma_rad: namelist values (hydro/read_hydro_params.f90:46),
        # padded with the reference default 4/3 per non-thermal group.
        grad = [float(g) for g in (h.gamma_rad or [])][:p.nener]
        grad += [4.0 / 3.0] * (p.nener - len(grad))
        return cls(ndim=p.ndim, nener=p.nener, npassive=p.npassive,
                   gamma=float(h.gamma),
                   gamma_rad=tuple(grad),
                   smallr=float(h.smallr), smallc=float(h.smallc),
                   slope_type=int(h.slope_type),
                   slope_theta=float(h.slope_theta),
                   scheme=str(h.scheme), riemann=str(h.riemann),
                   niter_riemann=int(h.niter_riemann),
                   courant_factor=float(h.courant_factor),
                   difmag=float(h.difmag),
                   pressure_fix=bool(h.pressure_fix),
                   beta_fix=float(getattr(h, "beta_fix", 0.0)))
