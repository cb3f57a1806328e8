"""Age/metallicity-binned stellar SED tables for the RT module (host
numpy).

The port's own copy of ``ramses_tpu/rt/sed.py``, the same arithmetic.

The ``rt/rt_spectra.f90`` machinery (1,795 LoC there): read a SED
library from a directory in the reference's on-disk format —
``metallicity_bins.dat`` / ``age_bins.dat`` (formatted counts + one
value per line) and ``all_seds.dat`` (Fortran unformatted: one record
``(nLambda, dum)``, one wavelength record [Å], then one luminosity
record per (metallicity, age) pair in L⊙/Å/M⊙) — and integrate each
photon group's properties per (age, Z) bin:

  * ``lphot``  photons/s/M⊙ emitted into the group,
  * ``egy``    mean photon energy [erg],
  * ``csn``    photon-number-weighted HI/HeI/HeII cross sections [cm²],
  * ``cse``    energy-weighted cross sections [cm²].

Star particles then drive injection (rate = m★ · lphot(age, Z)) and
the photon-rate-weighted population average refreshes the chemistry's
group properties every ``sedprops_update`` coarse steps
(``rt_spectra.f90`` update_SED_group_props role).  A directory written
by :func:`write_sed_dir` round-trips bit-exactly, and real
bc03-format libraries read unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from ramses_tpu_torch.io import fortran as frt
from ramses_tpu_torch.rt.chem import EV
from ramses_tpu_torch.rt.spectra import Group3, cross_section

H_PLANCK = 6.62607e-27              # erg s
C_CGS = 2.99792458e10               # cm/s
ANG = 1e-8                          # cm
L_SUN = 3.826e33                    # erg/s (the reference's L_sun)
HC_EV_ANG = H_PLANCK * C_CGS / (EV * ANG)   # E[eV] = HC_EV_ANG / λ[Å]


@dataclass(frozen=True)
class SedLibrary:
    """Raw SED library: λ grid [Å], age bins [Gyr], metallicity bins
    (mass fraction), seds[nLambda, nAge, nZ] in L⊙/Å/M⊙."""
    lam_A: np.ndarray
    ages_gyr: np.ndarray
    zs: np.ndarray
    seds: np.ndarray


def _read_bins(path: str) -> np.ndarray:
    with open(path) as f:
        n = int(f.readline())
        return np.array([float(f.readline()) for _ in range(n)])


def read_sed_dir(sed_dir: str) -> SedLibrary:
    """Read a reference-format SED directory (``rt_spectra.f90:286-356``,
    falling back to the ``RAMSES_SED_DIR`` environment variable like the
    reference when ``sed_dir`` is empty)."""
    sed_dir = sed_dir or os.environ.get("RAMSES_SED_DIR", "")
    for fn in ("metallicity_bins.dat", "age_bins.dat", "all_seds.dat"):
        if not os.path.exists(os.path.join(sed_dir, fn)):
            raise FileNotFoundError(
                f"SED directory {sed_dir!r} must contain "
                "metallicity_bins.dat, age_bins.dat, all_seds.dat "
                "(rt/rt_spectra.f90 format)")
    zs = _read_bins(os.path.join(sed_dir, "metallicity_bins.dat"))
    ages = _read_bins(os.path.join(sed_dir, "age_bins.dat")) * 1e-9  # Gyr
    if ages[0] != 0.0:
        ages[0] = 0.0               # reference zeroes the first bin
    with open(os.path.join(sed_dir, "all_seds.dat"), "rb") as f:
        nls = int(frt.read_ints(f)[0])
        lam = frt.read_reals(f)
        seds = np.empty((nls, len(ages), len(zs)))
        for iz in range(len(zs)):
            for ia in range(len(ages)):
                seds[:, ia, iz] = frt.read_reals(f)
    return SedLibrary(lam_A=lam, ages_gyr=ages, zs=zs, seds=seds)


def write_sed_dir(path: str, lib: SedLibrary) -> None:
    """Write a library in the reference's on-disk format."""
    os.makedirs(path, exist_ok=True)
    for fn, vals in (("metallicity_bins.dat", lib.zs),
                     ("age_bins.dat", lib.ages_gyr * 1e9)):
        with open(os.path.join(path, fn), "w") as f:
            f.write(f"{len(vals):8d}\n")
            for v in vals:
                f.write(f"{v:14.6e}\n")
    with open(os.path.join(path, "all_seds.dat"), "wb") as f:
        frt.write_ints(f, len(lib.lam_A), 0)
        frt.write_record(f, np.asarray(lib.lam_A, dtype=np.float64))
        for iz in range(len(lib.zs)):
            for ia in range(len(lib.ages_gyr)):
                frt.write_record(
                    f, np.asarray(lib.seds[:, ia, iz], dtype=np.float64))


class SedTables:
    """Per-(age, Z) group properties integrated from a SED library."""

    def __init__(self, lib: SedLibrary, bounds_eV: Sequence[float]):
        self.lib = lib
        self.bounds = tuple(float(b) for b in bounds_eV)
        ng = len(self.bounds) - 1
        na, nz = len(lib.ages_gyr), len(lib.zs)
        self.lphot = np.zeros((ng, na, nz))     # photons/s/Msun
        self.egy = np.zeros((ng, na, nz))       # erg
        self.csn = np.zeros((ng, 3, na, nz))    # cm^2
        self.cse = np.zeros((ng, 3, na, nz))
        lam = lib.lam_A
        E_eV = HC_EV_ANG / np.maximum(lam, 1e-30)
        sig = np.stack([cross_section(E_eV, sp) for sp in range(3)])
        for g in range(ng):
            lo, hi = self.bounds[g], self.bounds[g + 1]
            sel = (E_eV >= lo) & (E_eV < hi)
            if sel.sum() < 2:
                continue
            lmg = lam[sel]
            o = np.argsort(lmg)
            lmg = lmg[o]
            sg = sig[:, sel][:, o]
            for ia in range(na):
                for iz in range(nz):
                    J = lib.seds[sel, ia, iz][o] * L_SUN    # erg/s/Å/Msun
                    nph = J * (lmg * ANG) / (H_PLANCK * C_CGS)  # /s/Å
                    lp = np.trapezoid(nph, lmg)
                    le = np.trapezoid(J, lmg)
                    self.lphot[g, ia, iz] = lp
                    self.egy[g, ia, iz] = le / max(lp, 1e-300)
                    for sp in range(3):
                        self.csn[g, sp, ia, iz] = \
                            np.trapezoid(sg[sp] * nph, lmg) / max(lp, 1e-300)
                        self.cse[g, sp, ia, iz] = \
                            np.trapezoid(sg[sp] * J, lmg) / max(le, 1e-300)

    # ------------------------------------------------------------------
    def _weights(self, age_gyr, Z):
        """Bilinear interpolation weights in (log age, log Z), clamped
        to the table edges (``rt_spectra.f90`` inp_SED_table role)."""
        ages = np.maximum(self.lib.ages_gyr, 1e-6)
        zs = np.maximum(self.lib.zs, 1e-10)
        la = np.log10(np.clip(age_gyr, ages[0], ages[-1]))
        lz = np.log10(np.clip(Z, zs[0], zs[-1]))
        ia = np.clip(np.searchsorted(np.log10(ages), la) - 1,
                     0, len(ages) - 2)
        iz = np.clip(np.searchsorted(np.log10(zs), lz) - 1,
                     0, max(len(zs) - 2, 0))
        da = np.log10(ages)
        wa = np.clip((la - da[ia]) / np.maximum(da[ia + 1] - da[ia],
                                                1e-30), 0.0, 1.0)
        if len(zs) > 1:
            dz = np.log10(zs)
            wz = np.clip((lz - dz[iz]) / np.maximum(dz[iz + 1] - dz[iz],
                                                    1e-30), 0.0, 1.0)
        else:
            wz = np.zeros_like(lz)
            iz = np.zeros_like(ia)
        return ia, iz, wa, wz

    def _interp(self, tbl, ia, iz, wa, wz):
        """tbl[..., nA, nZ] bilinear at per-star (ia, iz, wa, wz)."""
        iz1 = np.minimum(iz + 1, tbl.shape[-1] - 1)
        t00 = tbl[..., ia, iz]
        t10 = tbl[..., ia + 1, iz]
        t01 = tbl[..., ia, iz1]
        t11 = tbl[..., ia + 1, iz1]
        return ((1 - wa) * (1 - wz) * t00 + wa * (1 - wz) * t10
                + (1 - wa) * wz * t01 + wa * wz * t11)

    def star_rates(self, age_gyr, Z, m_sun) -> np.ndarray:
        """Per-star per-group photon emission rates [nstar, ng]
        (photons/s): m★ · lphot(age, Z)."""
        ia, iz, wa, wz = self._weights(np.asarray(age_gyr),
                                       np.asarray(Z))
        lp = self._interp(self.lphot, ia, iz, wa, wz)    # [ng, nstar]
        return (lp * np.asarray(m_sun)[None, :]).T

    def population_groups(self, age_gyr, Z, m_sun) -> Tuple[Group3, ...]:
        """Photon-rate-weighted group properties of a star population —
        the quantities the chemistry consumes, refreshed at the
        ``sedprops_update`` cadence (``update_SED_group_props``)."""
        ia, iz, wa, wz = self._weights(np.asarray(age_gyr),
                                       np.asarray(Z))
        m = np.asarray(m_sun)
        lp = self._interp(self.lphot, ia, iz, wa, wz) * m    # [ng, ns]
        w = lp / np.maximum(lp.sum(axis=1, keepdims=True), 1e-300)
        egy = (self._interp(self.egy, ia, iz, wa, wz) * w).sum(axis=1)
        csn = (self._interp(self.csn, ia, iz, wa, wz)
               * w[:, None, :]).sum(axis=2)                  # [ng, 3]
        cse = (self._interp(self.cse, ia, iz, wa, wz)
               * w[:, None, :]).sum(axis=2)
        tot = lp.sum(axis=1)
        frac = tot / max(tot.sum(), 1e-300)
        return tuple(
            Group3(e_lo=self.bounds[g], e_hi=self.bounds[g + 1],
                   e_photon=float(egy[g]),
                   sigmaN=tuple(float(v) for v in csn[g]),
                   sigmaE=tuple(float(v) for v in cse[g]),
                   frac=float(frac[g]))
            for g in range(len(self.bounds) - 1))


def blackbody_library(t_of_age, ages_gyr, zs,
                      lam_A=None) -> SedLibrary:
    """Synthetic library helper: a blackbody whose temperature follows
    ``t_of_age(age_gyr)`` (tests; also a usable stand-in when no
    tabulated library ships with a run)."""
    if lam_A is None:
        lam_A = np.geomspace(100.0, 3000.0, 400)
    seds = np.zeros((len(lam_A), len(ages_gyr), len(zs)))
    lam_cm = lam_A * ANG
    for ia, age in enumerate(ages_gyr):
        T = float(t_of_age(age))
        from ramses_tpu_torch.units import kB as KB
        x = np.clip(H_PLANCK * C_CGS / (lam_cm * KB * T), 1e-8, 600.0)
        blam = 1.0 / (lam_cm ** 5 * np.expm1(x))
        blam = blam / max(blam.max(), 1e-300)
        for iz in range(len(zs)):
            seds[:, ia, iz] = blam * (1.0 + 0.1 * iz)
    return SedLibrary(lam_A=np.asarray(lam_A),
                      ages_gyr=np.asarray(ages_gyr),
                      zs=np.asarray(zs), seds=seds)
