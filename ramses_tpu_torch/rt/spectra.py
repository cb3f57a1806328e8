"""SED-integrated photon-group properties (host numpy).

The port's own copy of ``ramses_tpu/rt/spectra.py``, bit for bit the same
arithmetic (numpy's ``trapezoid`` in the same order).

The ``rt/rt_spectra.f90`` role (1,795 LoC there: SED table reading +
group integration): given a source SED (blackbody T_eff here — the
reference's default when no SED file is configured) and group energy
bounds, compute each group's mean photon energy and the
photoionization cross-sections of HI / HeI / HeII averaged over the
group in photon-number weighting (``sigmaN``) and energy weighting
(``sigmaE``) — the quantities the chemistry consumes.

Cross-sections: Verner et al. (1996) analytic fits (the same source
the reference's ``rt_cross_sections`` uses).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from ramses_tpu_torch.rt.chem import EV, ION_EV   # shared thresholds
from ramses_tpu_torch.units import kB as KB

H_PLANCK = 6.62607e-27


def _verner(E_eV, E0, s0, ya, P, yw, y0, y1):
    x = E_eV / E0 - y0
    y = np.sqrt(x * x + y1 * y1)
    F = ((x - 1.0) ** 2 + yw * yw) * y ** (0.5 * P - 5.5) \
        * (1.0 + np.sqrt(y / ya)) ** (-P)
    return s0 * 1e-18 * F


def cross_section(E_eV: np.ndarray, species: int) -> np.ndarray:
    """σ(E) [cm²] for species 0=HI, 1=HeI, 2=HeII (Verner+96 Table 1)."""
    E = np.asarray(E_eV, dtype=np.float64)
    if species == 0:
        s = _verner(E, 0.4298, 5.475e4, 32.88, 2.963, 0.0, 0.0, 0.0)
    elif species == 1:
        s = _verner(E, 13.61, 9.492e2, 1.469, 3.188, 2.039, 0.4434, 2.136)
    else:
        s = _verner(E, 1.720, 1.369e4, 32.88, 2.963, 0.0, 0.0, 0.0)
    return np.where(E >= ION_EV[species], s, 0.0)


@dataclass(frozen=True)
class Group3:
    """One photon group's SED-averaged properties (3 species)."""
    e_lo: float                       # eV
    e_hi: float
    e_photon: float                   # mean photon energy, erg
    sigmaN: Tuple[float, float, float]  # cm², number-weighted
    sigmaE: Tuple[float, float, float]  # cm², energy-weighted
    frac: float = 1.0                 # share of the source photon rate


def blackbody_groups(T_eff: float,
                     bounds_eV: Sequence[float]) -> Tuple[Group3, ...]:
    """Integrate a blackbody SED over the group bounds
    (``rt_spectra.f90`` getGroupProps for SED='bb')."""
    raw = []
    for e_lo, e_hi in zip(bounds_eV[:-1], bounds_eV[1:]):
        E = np.linspace(e_lo, min(e_hi, 20.0 * KB * T_eff / EV + e_lo),
                        4096)
        nu = E * EV / H_PLANCK
        x = H_PLANCK * nu / (KB * T_eff)
        bnu = nu ** 3 / np.expm1(np.clip(x, 1e-8, 600.0))
        nphot = bnu / (H_PLANCK * nu)                 # photon-number SED
        wN = np.trapezoid(nphot, nu)
        wE = np.trapezoid(bnu, nu)
        e_mean = wE / max(wN, 1e-300)
        sN, sE = [], []
        for sp in range(3):
            sig = cross_section(E, sp)
            sN.append(np.trapezoid(sig * nphot, nu) / max(wN, 1e-300))
            sE.append(np.trapezoid(sig * bnu, nu) / max(wE, 1e-300))
        raw.append((e_lo, e_hi, float(e_mean),
                    tuple(float(v) for v in sN),
                    tuple(float(v) for v in sE), float(wN)))
    wtot = sum(r[5] for r in raw) or 1.0
    return tuple(Group3(*r[:5], frac=r[5] / wtot) for r in raw)


# the reference's standard 3-group HII/HeII/HeIII setup
DEFAULT_BOUNDS = (13.60, 24.59, 54.42, 1e3)
