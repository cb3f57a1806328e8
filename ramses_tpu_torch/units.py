"""Physical constants and user→cgs unit conversion.

The port's own copy of ``ramses_tpu/units.py`` (pure Python).

The reference keeps constants in ``amr/constants.f90`` and derives the five
conversion scales in ``amr/units.f90`` (gravity runs assume G=1 in user
units; cosmology runs supercomoving units).  Values are copied verbatim
from the published CODATA/NIST constants the reference cites.
"""

from __future__ import annotations

from dataclasses import dataclass

# amr/constants.f90:5-34
twopi = 6.2831853
pi = twopi / 2.0
kB = 1.3806490e-16        # Boltzmann [erg/K]
mH = 1.6605390e-24        # atomic mass unit [g]
factG_in_cgs = 6.6740800e-08  # G [cm^3 g^-1 s^-2]
C_CGS = 2.99792458e10         # speed of light [cm/s]
rhoc = 1.8800000e-29      # critical density [g/cc]
Mpc2cm = 3.0856776e+24
X_frac = 0.76             # hydrogen mass fraction (cooling_module X)
yr2sec = 3.15576e7
kpc2cm = Mpc2cm / 1e3


@dataclass(frozen=True)
class Units:
    """scale_* convert user units into cgs (``amr/units.f90``)."""
    scale_l: float
    scale_t: float
    scale_d: float

    @property
    def scale_v(self) -> float:
        return self.scale_l / self.scale_t

    @property
    def scale_T2(self) -> float:
        """(P/rho) in user units → (T/mu) in Kelvin."""
        return mH / kB * self.scale_v ** 2

    @property
    def scale_nH(self) -> float:
        """rho in user units → nH in H/cc."""
        return X_frac / mH * self.scale_d

    @property
    def scale_m(self) -> float:
        return self.scale_d * self.scale_l ** 3


def units(params, cosmo=None, aexp: float = 1.0) -> Units:
    """Conversion factors for a run (``amr/units.f90:14-35``).

    Cosmology runs use supercomoving units tied to (omega_m, h0, aexp);
    otherwise the &UNITS_PARAMS values are used as-is.
    """
    if params.run.cosmo and cosmo is not None:
        h0 = cosmo.h0
        omega_m = cosmo.omega_m
        scale_d = omega_m * rhoc * (h0 / 100.0) ** 2 / aexp ** 3
        scale_t = aexp ** 2 / (h0 * 1e5 / Mpc2cm)
        scale_l = aexp * cosmo.boxlen_ini * Mpc2cm / (h0 / 100.0)
    else:
        p = params.units
        scale_d = p.units_density
        scale_t = p.units_time
        scale_l = p.units_length
    return Units(scale_l=scale_l, scale_t=scale_t, scale_d=scale_d)
