"""RT simulation driver: sources, subcycled transport + chemistry loop
(PyTorch).

Port of ``ramses_tpu/rt/driver.py``, the reference's subcycled ``rt_step``
(``amr/amr_step.f90:594-672``) on the dense uniform grid: the fields stay on
the device, and :meth:`RtSim.advance` computes the substep count on the
host from the Python ``dt`` and then runs that many substeps of K8 (the
transport of every group, sources and beams included) and K9 (the
photochemistry; skipped under ``rt_pp``/``rt_freeflow``) with no host
synchronisation inside the loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ramses_tpu_torch.device import resolve_device
from ramses_tpu_torch.rt import chem as chem_mod
from ramses_tpu_torch.rt import m1
from ramses_tpu_torch.rt.chem import GroupSpec
from ramses_tpu_torch.units import C_CGS

F64 = torch.float64


@dataclass(frozen=True)
class RtSpec:
    """Static RT configuration (&RT_PARAMS, ``rt/rt_init.f90:151-152``)."""
    ndim: int = 3
    c_fraction: float = 0.01          # rt_c_fraction
    courant: float = 0.8              # rt_courant_factor
    otsa: bool = True
    heating: bool = True
    periodic: bool = True
    group: GroupSpec = field(default_factory=GroupSpec)
    # multigroup + helium surface (rt_parameters.f90 nGroups/X,Y):
    # SED-averaged Group3 tuple; empty → legacy single gray group
    groups3: tuple = ()
    y_he: float = 0.0
    # pure photon propagation (rt_pp / rt_freeflow): transport only,
    # no thermochemistry
    pp: bool = False

    @property
    def c_red(self) -> float:
        return self.c_fraction * C_CGS

    @property
    def full3(self) -> bool:
        """True when the multigroup/3-ion system is active."""
        return len(self.groups3) > 1 or self.y_he > 0.0

    @classmethod
    def from_params(cls, p, ndim: Optional[int] = None) -> "RtSpec":
        """The spec of &RT_PARAMS.  The gray group stays the default
        :class:`GroupSpec` whatever ``rt_t_star`` says, as in the JAX
        package: only the hierarchy's SED refresh sets it."""
        from ramses_tpu_torch.rt import spectra
        r = p.rt
        bounds = list(r.rt_egy_bounds)
        if bounds and len(bounds) != int(r.rt_ngroups) + 1:
            # user-supplied but fencepost-wrong: ngroups groups need
            # ngroups+1 bin edges — error out loudly instead of
            # silently substituting the defaults
            raise ValueError(
                f"rt_egy_bounds has {len(bounds)} values; "
                f"rt_ngroups={int(r.rt_ngroups)} needs "
                f"{int(r.rt_ngroups) + 1} bin edges "
                f"(rt/rt_parameters.f90 group bounds)")
        if not bounds:
            bounds = list(spectra.DEFAULT_BOUNDS[:int(r.rt_ngroups)]) \
                + [spectra.DEFAULT_BOUNDS[-1]]
        groups3 = spectra.blackbody_groups(float(r.rt_t_star), bounds)
        return cls(ndim=ndim or p.ndim,
                   c_fraction=float(r.rt_c_fraction),
                   courant=float(r.rt_courant_factor),
                   otsa=bool(r.rt_otsa),
                   periodic=not bool(r.rt_is_outflow_bound),
                   groups3=groups3,
                   y_he=float(r.rt_y_he),
                   pp=bool(r.rt_pp) or bool(r.rt_freeflow))


class RtSim:
    """Standalone RT problem on a uniform grid (cgs units), on ``device``
    (CUDA unless the caller asks for the CPU).

    The radiation lives in one f64 tensor ``U [ng, 1+ndim, *shape]``
    (group-major N, F_x..F_z: K8's layout); ``N`` and ``F`` are views of it
    in the JAX package's shapes.  Legacy mode (default spec): single gray
    group, H-only chemistry, ``N [*shape]``, ``F [ndim, *shape]``.  With
    ``spec.full3`` (multigroup and/or helium): ``N [ng, *shape]``, ``F [ng,
    ndim, *shape]``, and the chemistry runs the 3-ion ladder (``xHe2``/
    ``xHe3`` join ``x``)."""

    def __init__(self, shape: Sequence[int], dx: float, spec: RtSpec,
                 nH, T=None, xHII=None, device=None):
        self.shape = tuple(int(s) for s in shape)
        self.dx = float(dx)
        self.spec = spec
        ndim = spec.ndim
        assert len(self.shape) == ndim
        self.device = resolve_device(device)
        f64 = dict(dtype=F64, device=self.device)
        self.nH = torch.as_tensor(nH, **f64)
        self.T = (torch.as_tensor(T, **f64) if T is not None
                  else torch.full(self.shape, 100.0, **f64))
        self.x = (torch.as_tensor(xHII, **f64) if xHII is not None
                  else torch.full(self.shape, 1.2e-3, **f64))
        self.ng = len(spec.groups3) if spec.full3 else 1
        self.U = torch.zeros((self.ng, 1 + ndim) + self.shape, **f64)
        self.U[:, 0] = m1.SMALL_NP
        if spec.full3:
            self.xHe2 = torch.full(self.shape, 1e-6, **f64)
            self.xHe3 = torch.full(self.shape, 1e-8, **f64)
        self._src = torch.zeros((self.ng,) + self.shape, **f64)
        # flux (beam) source field: allocated on the first DIRECTED
        # point_source, so beam-free runs neither carry nor read it
        self._src_F = None
        self.t = 0.0
        # substeps run since construction (each one K8 launch, and one K9
        # launch unless rt_pp)
        self.substeps = 0

    # the JAX package's shapes, as views of the grouped tensors ----------
    def _view(self, a):
        return a if self.spec.full3 else a[0]

    @property
    def N(self):
        return self._view(self.U[:, 0])

    @N.setter
    def N(self, v):
        self.N.copy_(torch.as_tensor(v, dtype=F64))

    @property
    def F(self):
        return self._view(self.U[:, 1:])

    @F.setter
    def F(self, v):
        self.F.copy_(torch.as_tensor(v, dtype=F64))

    @property
    def src(self):
        return self._view(self._src)

    @src.setter
    def src(self, v):
        self._src.copy_(torch.as_tensor(v, dtype=F64).reshape(
            self._src.shape))

    @property
    def src_F(self):
        return None if self._src_F is None else self._view(self._src_F)

    @src_F.setter
    def src_F(self, v):
        if v is None:
            self._src_F = None
            return
        self._src_F = torch.as_tensor(v, dtype=F64, device=self.device) \
            .reshape((self.ng, self.spec.ndim) + self.shape).clone()

    @property
    def nHe(self):
        """Helium number density from the mass fractions (X = 1 - Y)."""
        y = self.spec.y_he
        return self.nH * (y / (4.0 * max(1.0 - y, 1e-10)))

    def point_source(self, pos: Sequence[float], ndot: float,
                     direction: Optional[Sequence[float]] = None):
        """Add a point source of ``ndot`` photons/s (one-cell injection,
        the reference's cloud-smoothed stellar injection reduced);
        multigroup sources split by the SED's photon-count shares.
        ``direction``: optional unit vector making the source a BEAM —
        photons inject with streaming flux F = c_red·N·n̂ (the
        rt_u/v/w_source directed sources of rad_beams.nml).  Each value is
        one add on the device, the JAX package's number."""
        idx = tuple(int(p / self.dx) for p in pos)
        vol = self.dx ** self.spec.ndim
        nd = self.spec.ndim
        if direction is not None and self._src_F is None:
            self._src_F = torch.zeros((self.ng, nd) + self.shape, dtype=F64,
                                      device=self.device)
        if self.spec.full3:
            for g, grp in enumerate(self.spec.groups3):
                self._src[(g,) + idx] += grp.frac * ndot / vol
                if direction is not None:
                    for d in range(nd):
                        self._src_F[(g, d) + idx] += (
                            self.spec.c_red * grp.frac * ndot / vol
                            * float(direction[d]))
        else:
            self._src[(0,) + idx] += ndot / vol
            if direction is not None:
                for d in range(nd):
                    self._src_F[(0, d) + idx] += (self.spec.c_red * ndot / vol
                                                  * float(direction[d]))

    def nsub(self, dt: float) -> int:
        """RT-Courant substeps of an advance by ``dt`` (host arithmetic)."""
        dt_c = m1.rt_courant_dt(self.dx, self.spec.c_red, self.spec.courant)
        return max(1, int(math.ceil(dt / dt_c)))

    def advance(self, dt: float):
        """Advance physical time ``dt`` with RT-Courant substeps: each
        substep K8 then, unless ``rt_pp``, K9; nothing is fetched."""
        spec = self.spec
        nsub = self.nsub(dt)
        dt_sub = dt / nsub
        n = int(np.prod(self.shape))
        for _ in range(nsub):
            self.U = m1.transport(self.U, dt_sub, self.dx, spec.c_red,
                                  spec.ndim, spec.periodic, self._src,
                                  self._src_F)
            if spec.pp:                     # rt_pp: free-flowing photons
                continue
            Nv = self.U.reshape(self.ng, 1 + spec.ndim, n)[:, 0]
            if spec.full3:
                x, h2, h3, T = chem_mod.chem_3ion(
                    Nv, self.x.reshape(-1), self.xHe2.reshape(-1),
                    self.xHe3.reshape(-1), self.T.reshape(-1),
                    self.nH.reshape(-1), self.nHe.reshape(-1), dt_sub,
                    spec.c_red, spec.groups3, spec.otsa,
                    heating=spec.heating)
                self.xHe2 = h2.reshape(self.shape)
                self.xHe3 = h3.reshape(self.shape)
            else:
                x, T = chem_mod.chem_gray(
                    Nv[0], self.x.reshape(-1), self.T.reshape(-1),
                    self.nH.reshape(-1), dt_sub, spec.c_red, spec.group,
                    spec.otsa, heating=spec.heating)
            self.x = x.reshape(self.shape)
            self.T = T.reshape(self.shape)
        self.t += dt
        self.substeps += nsub
        return nsub

    def load_state(self, N, F, x, T, nH=None, src=None, src_F=None,
                   xHe2=None, xHe3=None, t=None):
        """Set the state from arrays in the JAX package's shapes (numpy or
        tensors, e.g. :func:`ramses_tpu_torch.convert.rt_state_from`)."""
        def dev(a):
            return torch.as_tensor(np.array(a), dtype=F64,
                                   device=self.device)
        self.N, self.F = dev(N), dev(F)
        self.x, self.T = dev(x), dev(T)
        if nH is not None:
            self.nH = dev(nH)
        if src is not None:
            self.src = dev(src)
        self.src_F = None if src_F is None else dev(src_F)
        if self.spec.full3:
            self.xHe2, self.xHe3 = dev(xHe2), dev(xHe3)
        if t is not None:
            self.t = float(t)

    # diagnostics ------------------------------------------------------
    def ionized_volume(self) -> float:
        """V_ion = Σ x dV — the Stromgren-sphere measure."""
        return float(torch.sum(self.x) * self.dx ** self.spec.ndim)

    def photon_total(self) -> float:
        return float(torch.sum(self.N) * self.dx ** self.spec.ndim)


def stromgren_radius(ndot: float, nH: float, T: float = 1e4) -> float:
    """Classical Stromgren radius [cm] for a pure-H medium."""
    aB = float(chem_mod.alpha_B(torch.tensor(T, dtype=F64)))
    return (3.0 * ndot / (4.0 * np.pi * aB * nH ** 2)) ** (1.0 / 3.0)
