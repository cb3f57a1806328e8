"""Cosmology: Friedmann tables and supercomoving-unit scaffolding.

The port's own copy of ``ramses_tpu/pm/cosmology.py``.  Reference:
``amr/init_time.f90`` — ``init_cosmo`` (``:414``) and ``friedman``
(``:756-855``).  The reference integrates the Friedmann equation backwards
from a=1 and stores look-up tables ``axp_frw/hexp_frw/tau_frw/t_frw``; time
stepping then advances the conformal time ``tau`` (code time) and
interpolates ``aexp``.

Conventions (comment block ``init_time.f90:764-773``):
  - a = 1 today; tau (conformal) and t (proper look-back) are 0 today,
    both in units of 1/H0, negative in the past
  - da/dtau = sqrt(a^3 (Om + Ol a^3 + Ok a))       (``dadtau:857-866``)
  - da/dt   = sqrt((Om + Ol a^3 + Ok a) / a)
  - hexp = (1/a) da/dtau

The tables are built by direct quadrature on a fine log-spaced grid, as
the JAX package builds them.  Each interpolator takes a host number (numpy
arithmetic, a float back) or a tensor (the same arithmetic on its device,
so that a step loop looks aexp and hexp up without a host fetch); both
follow ``jnp.interp``'s formula and its clamping at the table's ends (the
tables go to a device once and stay there).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def dadtau(a, om, ov, ok):
    return np.sqrt(a ** 3 * (om + ov * a ** 3 + ok * a))


def dadt(a, om, ov, ok):
    return np.sqrt((om + ov * a ** 3 + ok * a) / a)


def friedman(om: float, ov: float, ok: float, aexp_min: float,
             ntable: int = 1000):
    """Look-up tables (a, hexp, tau, t, chi) from a=aexp_min/1.2 to 1.

    Quadrature replacement of ``friedman`` (``amr/init_time.f90:756``):
    tau(a) = -int_a^1 da'/dadtau, t(a) = -int_a^1 da'/dadt, plus the
    proper comoving distance chi(a) = int_a^1 c·da'/(a'^2 H(a')) in c/H0
    units (``amr/light_cone.f90:795-804``).
    """
    if abs(om + ov + ok - 1.0) > 1e-9:
        raise ValueError(f"Omegas must sum to 1: {om}+{ov}+{ok}")
    nfine = max(20 * ntable, 20000)
    a_fine = np.exp(np.linspace(np.log(aexp_min / 1.2), 0.0, nfine))
    inv_dtau = 1.0 / dadtau(a_fine, om, ov, ok)
    inv_dt = 1.0 / dadt(a_fine, om, ov, ok)
    inv_chi = a_fine * inv_dtau            # 1/(a^2 E(a)) in 1/H0 units
    # cumulative trapezoid from a=1 downward (negative times in the past)
    da = np.diff(a_fine)

    def cum(f):
        return np.concatenate([[0.0],
                               np.cumsum(0.5 * da * (f[1:] + f[:-1]))])

    tau_f = cum(inv_dtau)
    t_f = cum(inv_dt)
    chi_f = cum(inv_chi)
    tau_f = tau_f - tau_f[-1]   # tau(1) = 0, negative in the past
    t_f = t_f - t_f[-1]
    chi_f = chi_f[-1] - chi_f   # chi(1) = 0, positive in the past
    # subsample to ntable+1 entries (the reference keeps 0:ntable)
    idx = np.linspace(0, nfine - 1, ntable + 1).round().astype(int)
    a_t = a_fine[idx]
    return (a_t, dadtau(a_t, om, ov, ok) / a_t, tau_f[idx], t_f[idx],
            chi_f[idx])


def interp_tensor(x, xt, ft):
    """``jnp.interp(x, xt, fp)`` on tensors (``xt`` ascending, the tables
    on ``x``'s device): ``torch.searchsorted`` and a linear blend, clamped
    to ``ft``'s end values outside ``xt``.  ``torch.take`` reads the knots:
    indexing by a 0-d tensor would fetch it to the host."""
    i = torch.clamp(torch.searchsorted(xt, x.contiguous(), right=True), 1,
                    len(xt) - 1)
    x0, x1 = torch.take(xt, i - 1), torch.take(xt, i)
    f0, f1 = torch.take(ft, i - 1), torch.take(ft, i)
    dx = x1 - x0
    f = torch.where(dx == 0, f1,
                    f0 + ((x - x0) / torch.where(dx == 0, 1.0, dx))
                    * (f1 - f0))
    f = torch.where(x < xt[0], ft[0], f)
    return torch.where(x > xt[-1], ft[-1], f)


def interp(x, xp, fp) -> float:
    """``jnp.interp(x, xp, fp)`` of a host number, ``xp`` ascending."""
    xp = np.asarray(xp, dtype=np.float64)
    fp = np.asarray(fp, dtype=np.float64)
    xs = np.float64(x)
    i = int(np.clip(np.searchsorted(xp, xs, side="right"), 1, len(xp) - 1))
    dx = xp[i] - xp[i - 1]
    f = (fp[i] if dx == 0
         else fp[i - 1] + ((xs - xp[i - 1]) / dx) * (fp[i] - fp[i - 1]))
    if xs < xp[0]:
        f = fp[0]
    if xs > xp[-1]:
        f = fp[-1]
    return float(f)


def interp_array(x, xp, fp) -> np.ndarray:
    """``jnp.interp(x, xp, fp)`` of a host array, ``xp`` ascending: its
    formula, with its guard of knots closer than the spacing of eps."""
    xp = np.asarray(xp, dtype=np.float64)
    fp = np.asarray(fp, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    i = np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = np.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    f = np.where(dx0, fp[i - 1],
                 fp[i - 1] + (delta / np.where(dx0, 1.0, dx)) * df)
    f = np.where(x < xp[0], fp[0], f)
    return np.where(x > xp[-1], fp[-1], f)


@dataclass(frozen=True)
class Cosmology:
    """Flat(ish) FRW background + supercomoving unit scales.

    Code units follow the reference (``amr/units.f90`` with cosmo):
    scale_d = Om*rhocrit(h)*h^2/a^3, scale_t = a^2/H0,
    scale_l = a * boxlen_ini Mpc / h.
    """
    omega_m: float = 1.0
    omega_l: float = 0.0
    omega_k: float = 0.0
    omega_b: float = 0.045
    h0: float = 70.0               # km/s/Mpc
    aexp_ini: float = 1e-2
    boxlen_ini: float = 1.0        # comoving Mpc/h
    ntable: int = 1000
    # tables (tuples for hashability; filled in __post_init__)
    axp_frw: Tuple[float, ...] = ()
    hexp_frw: Tuple[float, ...] = ()
    tau_frw: Tuple[float, ...] = ()
    t_frw: Tuple[float, ...] = ()
    chi_frw: Tuple[float, ...] = ()    # comoving distance to a=1, c/H0

    def __post_init__(self):
        if not self.axp_frw:
            a, h, tau, t, chi = friedman(self.omega_m, self.omega_l,
                                         self.omega_k, self.aexp_ini,
                                         self.ntable)
            object.__setattr__(self, "axp_frw", tuple(a))
            object.__setattr__(self, "hexp_frw", tuple(h))
            object.__setattr__(self, "tau_frw", tuple(tau))
            object.__setattr__(self, "t_frw", tuple(t))
            object.__setattr__(self, "chi_frw", tuple(chi))
        # the tables on a device, by (name, device, dtype): built once, so
        # that a step's look-up copies nothing from the host
        object.__setattr__(self, "_dev", {})

    @classmethod
    def from_params(cls, p) -> "Cosmology":
        raw = (p.raw or {}).get("cosmo_params", {})
        return cls(omega_m=float(raw.get("omega_m", 1.0)),
                   omega_l=float(raw.get("omega_l", 0.0)),
                   omega_k=float(raw.get("omega_k", 0.0)),
                   omega_b=float(raw.get("omega_b", 0.045)),
                   h0=float(raw.get("h0", 70.0)),
                   aexp_ini=float(raw.get(
                       "aexp", raw.get("aexp_ini", p.init.aexp_ini
                                       if p.init.aexp_ini < 1.0
                                       else 1e-2))),
                   boxlen_ini=float(raw.get("boxlen_ini", p.amr.boxlen)))

    # --- interpolators (a host number or a device tensor) -------------
    def _table(self, name: str, like: torch.Tensor) -> torch.Tensor:
        key = (name, like.device, like.dtype)
        if key not in self._dev:
            self._dev[key] = torch.tensor(getattr(self, name),
                                          dtype=like.dtype,
                                          device=like.device)
        return self._dev[key]

    def _interp(self, x, xname: str, fname: str):
        if torch.is_tensor(x):
            return interp_tensor(x, self._table(xname, x),
                                 self._table(fname, x))
        return interp(x, getattr(self, xname), getattr(self, fname))

    def aexp_of_tau(self, tau):
        return self._interp(tau, "tau_frw", "axp_frw")

    def hexp_of_tau(self, tau):
        return self._interp(tau, "tau_frw", "hexp_frw")

    def t_of_tau(self, tau):
        return self._interp(tau, "tau_frw", "t_frw")

    def tau_of_aexp(self, aexp):
        return self._interp(aexp, "axp_frw", "tau_frw")

    # --- lightcone comoving distances (box-length units) --------------
    @property
    def _chi_to_box(self) -> float:
        """c/H0 in box lengths: coverH0/Lbox with coverH0 =
        299792.458/(100·h) Mpc and Lbox = boxlen_ini/h Mpc
        (``light_cone.f90:57,791``) — h cancels."""
        return 2997.92458 / self.boxlen_ini

    def chi_of_aexp(self, aexp):
        """Proper comoving distance from aexp to today, box units."""
        return self._interp(aexp, "axp_frw", "chi_frw") * self._chi_to_box

    def aexp_of_chi(self, chi):
        """Emission epoch at comoving distance ``chi`` [box units]: a host
        number, or an array of them (the lightcone's radii)."""
        c = np.asarray(self.chi_frw[::-1]) * self._chi_to_box
        if np.ndim(chi):
            return interp_array(chi, c, self.axp_frw[::-1])
        return interp(chi, c, self.axp_frw[::-1])

    @property
    def tau_ini(self) -> float:
        return float(self.tau_of_aexp(self.aexp_ini))

    def age_of_universe(self) -> float:
        """In 1/H0 units (the reference's debug print, init_time.f90:811)."""
        return -float(self.t_frw[0])
