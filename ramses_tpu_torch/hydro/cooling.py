"""Tabulated atomic cooling and heating (``cooling_module``), PyTorch, and
the per-cell cooling solve K6.

Port of ``ramses_tpu/hydro/cooling.py``: equilibrium H/He thermochemistry
tabulated on a (log nH, log T2) grid, UV-background photoheating, Compton
cooling and heating against the CMB, metal cooling scaled by metallicity,
the self-shielding boost, and the semi-implicit stiff integrator of
``solve_cooling`` (``hydro/cooling_module.f90:478-664``).  The rate fits,
the UV quadrature, the ionisation equilibrium and :func:`build_tables`
are the JAX package's host numpy as it is; the tables then move to the
run's device once per build (:class:`CoolingTables`).

``solve_cooling`` marches each cell in its own pseudo-time for up to 500
iterations; the JAX package runs it as a ``lax.while_loop`` whose
condition, ``any(active)``, it evaluates on the device.  Once a cell is
done its state is frozen, so one thread per cell looping until its own
cell is done gives the same result cell by cell in one launch: that is
K6, ``csrc/cooling.cu`` (it ports no Pallas kernel; it is the CUDA form of
the device-side loop).  :func:`solve_cooling` launches it for CUDA
tensors, or raises, and runs its plain version, :func:`solve_cooling_ref`
(a torch ``while`` loop on ``active.any()``, a host fetch an iteration),
for CPU tensors.

The ISM module (``cooling_ism``, Audit & Hennebelle 2005) runs its fixed
``nsub`` substeps as a torch formulation on either device: a loop of known
length needs no fetch.  :func:`cooling_step` is the vectorised
``cooling_fine`` pass on a dense state ``[nvar, *sp]``; its unit scales may
be a device tensor, so that a cosmological epoch change fetches nothing.
On a CUDA state it is one launch of K6's fused entry (the conversions
around the solve, the solve and the new E row; ``step_launches`` counts
it) for what :func:`fused_supports` takes, everything but the ISM module;
its plain version is :func:`cooling_step_ref`.  K6 reads the tables interleaved
(:meth:`CoolingTables.interleaved`).

Conventions: ``T2`` is T/mu in Kelvin; ``nH`` in H/cc; rates in
erg cm^3 / s so that dT2/dt = -(2X/3kB) * nH * Lambda_net.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ramses_tpu_torch.units import X_frac, kB

# table geometry (cooling_module.f90:40-45)
NBIN_T = 101
NBIN_N = 161
NH_MIN, NH_MAX = 1e-10, 1e6
T2_MIN, T2_MAX = 1e-2, 1e9
Y_frac = 1.0 - X_frac
VARMAX = 4.0        # per-substep relative change bound (solve_cooling)
T_CMB0 = 2.726
MAX_ITER = 500      # solve_cooling's iteration cap

# K6 launches since the counts were last reset (the main path's proof that
# it ran through the kernel): the march entry (solve_cooling) and the fused
# entry (cooling_step); the plain versions do not count.
launches = 0
step_launches = 0


# ----------------------------------------------------------------------
# rate fits (Cen 1992 / KWH 1996), T in Kelvin — host numpy
# ----------------------------------------------------------------------

def _T5(T):
    return np.sqrt(T / 1e5)


def rate_ci_HI(T):
    """Collisional ionization rate coefficient e + HI [cm^3/s]."""
    return 5.85e-11 * np.sqrt(T) * np.exp(-157809.1 / T) / (1 + _T5(T))


def rate_ci_HeI(T):
    return 2.38e-11 * np.sqrt(T) * np.exp(-285335.4 / T) / (1 + _T5(T))


def rate_ci_HeII(T):
    return 5.68e-12 * np.sqrt(T) * np.exp(-631515.0 / T) / (1 + _T5(T))


def rate_rec_HII(T):
    """Case-A recombination HII + e [cm^3/s]."""
    return (8.4e-11 / np.sqrt(T) * (T / 1e3) ** -0.2
            / (1 + (T / 1e6) ** 0.7))


def rate_rec_HeII(T):
    return 1.5e-10 * T ** -0.6353


def rate_rec_dielec(T):
    return (1.9e-3 * T ** -1.5 * np.exp(-470000.0 / T)
            * (1 + 0.3 * np.exp(-94000.0 / T)))


def rate_rec_HeIII(T):
    return (3.36e-10 / np.sqrt(T) * (T / 1e3) ** -0.2
            / (1 + (T / 1e6) ** 0.7))


# cooling functions [erg cm^3/s], to be multiplied by n_e * n_ion
def cool_ci_HI(T):
    return 1.27e-21 * np.sqrt(T) * np.exp(-157809.1 / T) / (1 + _T5(T))


def cool_ci_HeI(T):
    return 9.38e-22 * np.sqrt(T) * np.exp(-285335.4 / T) / (1 + _T5(T))


def cool_ci_HeII(T):
    return 4.95e-22 * np.sqrt(T) * np.exp(-631515.0 / T) / (1 + _T5(T))


def cool_ce_HI(T):
    """Collisional excitation (line) cooling."""
    return 7.50e-19 * np.exp(-118348.0 / T) / (1 + _T5(T))


def cool_ce_HeII(T):
    return 5.54e-17 * T ** -0.397 * np.exp(-473638.0 / T) / (1 + _T5(T))


def cool_rec_HII(T):
    return (8.70e-27 * np.sqrt(T) * (T / 1e3) ** -0.2
            / (1 + (T / 1e6) ** 0.7))


def cool_rec_HeII(T):
    return 1.55e-26 * T ** 0.3647


def cool_rec_dielec(T):
    return (1.24e-13 * T ** -1.5 * np.exp(-470000.0 / T)
            * (1 + 0.3 * np.exp(-94000.0 / T)))


def cool_rec_HeIII(T):
    return (3.48e-26 * np.sqrt(T) * (T / 1e3) ** -0.2
            / (1 + (T / 1e6) ** 0.7))


def cool_brems(T, nHII, nHeII, nHeIII, ne):
    gff = 1.1 + 0.34 * np.exp(-((5.5 - np.log10(T)) ** 2) / 3.0)
    return 1.42e-27 * gff * np.sqrt(T) * (nHII + nHeII + 4.0 * nHeIII) * ne


def metal_cooling_solar(T):
    """Solar-metallicity metal-line cooling [erg cm^3/s], SD93-shaped
    piecewise approximation: off below 1e4 K, peaked near 1e5.2 K, shallow
    high-T tail."""
    logT = np.log10(np.maximum(T, 1.0))
    lam = np.full_like(logT, -60.0)
    m1 = (logT >= 4.0) & (logT < 5.2)
    lam = np.where(m1, -21.7 + 1.2 * (logT - 5.2), lam)
    m2 = (logT >= 5.2) & (logT < 6.0)
    lam = np.where(m2, -21.7 - 0.4 * (logT - 5.2), lam)
    m3 = (logT >= 6.0) & (logT < 7.5)
    lam = np.where(m3, -22.02 - 0.6 * (logT - 6.0), lam)
    m4 = logT >= 7.5
    lam = np.where(m4, -22.92, lam)
    return 10.0 ** lam


# ----------------------------------------------------------------------
# UV background: power-law spectrum J(nu) = J0 (nu/nu_HI)^-alpha
# ----------------------------------------------------------------------

_NU_THRESH = dict(HI=3.2880e15, HeI=5.9484e15, HeII=1.3158e16)  # Hz
_H_PLANCK = 6.6262e-27


def _sigma_HI(nu):
    x = nu / _NU_THRESH["HI"]
    return np.where(x >= 1.0, 6.30e-18 * x ** -3.0, 0.0)


def _sigma_HeI(nu):
    x = nu / _NU_THRESH["HeI"]
    return np.where(x >= 1.0,
                    7.42e-18 * (1.66 * x ** -2.05 - 0.66 * x ** -3.05), 0.0)


def _sigma_HeII(nu):
    x = nu / _NU_THRESH["HeII"]
    return np.where(x >= 1.0, 1.58e-18 * x ** -3.0, 0.0)


def uv_amplitude(aexp: float, J21: float, z_reion: float = 8.5,
                 haardt_madau: bool = False) -> float:
    """Effective J21 amplitude at this epoch: zero before reionization,
    then flat, or the HM-style (1+z)^0.73·exp decline toward z=0."""
    z = 1.0 / max(aexp, 1e-10) - 1.0
    if z >= z_reion:
        return 0.0
    return J21 * ((1 + z) ** 0.73 * np.exp(-((1 + z) / 9.0) ** 2)
                  if haardt_madau else 1.0)


def uv_rates(J21: float, alpha: float):
    """(photoionization [1/s], photoheating [erg/s]) per species for the
    power-law background; numerical quadrature over the spectrum."""
    out_gamma, out_heat = {}, {}
    for sp, sigma in (("HI", _sigma_HI), ("HeI", _sigma_HeI),
                      ("HeII", _sigma_HeII)):
        nu0 = _NU_THRESH[sp]
        nu = nu0 * np.logspace(0, 2.5, 400)
        Jnu = J21 * 1e-21 * (nu / _NU_THRESH["HI"]) ** (-alpha)
        integ_i = 4 * np.pi * Jnu / (_H_PLANCK * nu) * sigma(nu)
        integ_h = integ_i * _H_PLANCK * (nu - nu0)
        out_gamma[sp] = np.trapezoid(integ_i, nu)
        out_heat[sp] = np.trapezoid(integ_h, nu)
    return out_gamma, out_heat


# ----------------------------------------------------------------------
# ionization equilibrium + table build (set_table equivalent)
# ----------------------------------------------------------------------

def _equilibrium(nH, T, gamma_uv):
    """H/He ionization equilibrium (KWH96 §3): species densities (nHI,
    nHII, nHeI, nHeII, nHeIII, ne); fixed-point iteration on ne."""
    nHe = 0.25 * Y_frac / X_frac * nH
    ge_HI, ge_HeI, ge_HeII = (rate_ci_HI(T), rate_ci_HeI(T),
                              rate_ci_HeII(T))
    a_HII = rate_rec_HII(T)
    a_HeII = rate_rec_HeII(T) + rate_rec_dielec(T)
    a_HeIII = rate_rec_HeIII(T)
    gg_HI = gamma_uv.get("HI", 0.0)
    gg_HeI = gamma_uv.get("HeI", 0.0)
    gg_HeII = gamma_uv.get("HeII", 0.0)

    ne = nH * 1.0
    for _ in range(100):
        ne_safe = np.maximum(ne, 1e-30 * nH)
        denom = a_HII + ge_HI + gg_HI / ne_safe
        nHI = nH * a_HII / np.maximum(denom, 1e-300)
        nHII = nH - nHI
        r1 = (ge_HeI + gg_HeI / ne_safe) / a_HeII
        r2 = (ge_HeII + gg_HeII / ne_safe) / a_HeIII
        nHeI = nHe / (1.0 + r1 + r1 * r2)
        nHeII = nHeI * r1
        nHeIII = nHeII * r2
        ne_new = nHII + nHeII + 2.0 * nHeIII
        ne = 0.5 * ne + 0.5 * ne_new
    return nHI, nHII, nHeI, nHeII, nHeIII, ne


# the ten tables in the order K6 reads them (values, then d/dlogT2)
TABLE_NAMES = ("cool", "heat", "cool_com", "heat_com", "metal",
               "cool_p", "heat_p", "cool_com_p", "heat_com_p", "metal_p")


@dataclass
class CoolingTables:
    """log10 tables over (log nH, log T2) and their T-derivatives for the
    cubic-Hermite interpolation of ``solve_cooling``, as float64 tensors
    on the run's device (``host`` keeps the numpy originals).  The packed
    copies the solve reads (:meth:`packed`) are made once per dtype."""
    log_nH: torch.Tensor          # [NBIN_N]
    log_T2: torch.Tensor          # [NBIN_T]
    cool: torch.Tensor            # [NBIN_N, NBIN_T] log10 Lambda
    heat: torch.Tensor
    cool_com: torch.Tensor
    heat_com: torch.Tensor
    metal: torch.Tensor
    cool_p: torch.Tensor          # d log10 Lambda / d log10 T2
    heat_p: torch.Tensor
    cool_com_p: torch.Tensor
    heat_com_p: torch.Tensor
    metal_p: torch.Tensor
    mu: torch.Tensor              # mean molecular weight
    host: dict = field(default_factory=dict, repr=False)
    _packs: dict = field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.cool.device

    def packed(self, dtype) -> tuple:
        """``(tabs [10, NBIN_N, NBIN_T], log_nH, log_T2)`` in ``dtype``,
        contiguous on the tables' device (cast once and kept)."""
        out = self._packs.get(dtype)
        if out is None:
            tabs = torch.stack([getattr(self, n) for n in TABLE_NAMES])
            out = (tabs.to(dtype).contiguous(),
                   self.log_nH.to(dtype).contiguous(),
                   self.log_T2.to(dtype).contiguous())
            self._packs[dtype] = out
        return out

    def interleaved(self, dtype) -> torch.Tensor:
        """The five table pairs interleaved for K6, ``[NBIN_N, NBIN_T - 1,
        20]`` in ``dtype`` (cast once and kept): entry ``[i_nH, i_T2]``
        holds, table by table (``TABLE_NAMES[:5]``), ``tab[i_nH, i_T2]``,
        ``tab[i_nH, i_T2 + 1]``, ``tab_p[i_nH, i_T2]``, ``tab_p[i_nH, i_T2
        + 1]``: the values one row of a cubic Hermite reads, 80 B in f32
        (160 B in f64) in one run."""
        out = self._packs.get((dtype, "inter"))
        if out is None:
            tabs = self.packed(dtype)[0]
            val, der = tabs[:5], tabs[5:]
            out = torch.stack([val[..., :-1], val[..., 1:], der[..., :-1],
                               der[..., 1:]], dim=-1)     # [5, N, T-1, 4]
            out = out.permute(1, 2, 0, 3).reshape(
                NBIN_N, NBIN_T - 1, 20).contiguous()
            self._packs[(dtype, "inter")] = out
        return out

    def divisors(self, dtype) -> tuple:
        """``(h, h2, h3)`` as 0-d tensors in ``dtype`` on the tables'
        device, made once by a fill (no copy from the host).  The plain
        solve divides by these: on CUDA, PyTorch turns a division by a
        Python number into a multiplication by its reciprocal, which
        rounds otherwise than K6's (and the JAX package's) division."""
        out = self._packs.get((dtype, "h"))
        if out is None:
            c = self.consts()
            out = tuple(torch.full((), c[k], dtype=dtype, device=self.device)
                        for k in ("h", "h2", "h3"))
            self._packs[(dtype, "h")] = out
        return out

    def consts(self) -> dict:
        """The solve's table constants, computed on the host in float64
        from the numpy originals, as ``solve_cooling`` derives them."""
        lnh, lt2 = self.host["log_nH"], self.host["log_T2"]
        dlog_nH = (NBIN_N - 1) / (lnh[-1] - lnh[0])
        dlog_T2 = (NBIN_T - 1) / (lt2[-1] - lt2[0])
        h = 1.0 / dlog_T2
        return dict(log_nH0=float(lnh[0]), log_nH1=float(lnh[-1]),
                    dlog_nH=float(dlog_nH), log_T20=float(lt2[0]),
                    dlog_T2=float(dlog_T2), h=float(h), h2=float(h * h),
                    h3=float(h * h * h),
                    precoeff=2.0 * X_frac / (3.0 * kB),
                    log_T2max=float(np.log10(T2_MAX)))


def _prime(tab, dlogT):
    return np.gradient(tab, dlogT, axis=1)


def build_tables(aexp: float = 1.0, J21: float = 0.0,
                 a_spec: float = 1.0, z_reion: float = 8.5,
                 haardt_madau: bool = False, device="cpu") -> CoolingTables:
    """``set_table(aexp)``: tabulate net cooling and heating at this
    epoch on the host (the JAX package's numpy as it is), then move the
    tables to ``device`` once."""
    z = 1.0 / aexp - 1.0
    log_nH = np.linspace(np.log10(NH_MIN), np.log10(NH_MAX), NBIN_N)
    log_T2 = np.linspace(np.log10(T2_MIN), np.log10(T2_MAX), NBIN_T)
    nH = 10.0 ** log_nH[:, None]                     # [N, 1]
    T2 = 10.0 ** log_T2[None, :]                     # [1, T]

    J_eff = uv_amplitude(aexp, J21, z_reion, haardt_madau)
    gamma_uv, heat_uv = uv_rates(J_eff, a_spec) if J_eff > 0 else ({}, {})

    # solve T = T2 * mu self-consistently (mu depends on ionization)
    mu = np.full(nH.shape[:1] + T2.shape[1:], 1.22)
    mu = np.broadcast_to(mu, (NBIN_N, NBIN_T)).copy()
    for _ in range(10):
        T = T2 * mu
        nHI, nHII, nHeI, nHeII, nHeIII, ne = _equilibrium(nH, T, gamma_uv)
        ntot = nHI + nHII + nHeI + nHeII + nHeIII + ne
        mu_new = nH / X_frac / np.maximum(ntot, 1e-300)
        mu = 0.5 * mu + 0.5 * mu_new
    T = T2 * mu

    lam = (cool_ci_HI(T) * ne * nHI
           + cool_ci_HeI(T) * ne * nHeI
           + cool_ci_HeII(T) * ne * nHeII
           + cool_ce_HI(T) * ne * nHI
           + cool_ce_HeII(T) * ne * nHeII
           + cool_rec_HII(T) * ne * nHII
           + cool_rec_HeII(T) * ne * nHeII
           + cool_rec_dielec(T) * ne * nHeII
           + cool_rec_HeIII(T) * ne * nHeIII
           + cool_brems(T, nHII, nHeII, nHeIII, ne)) / nH ** 2

    heat = (heat_uv.get("HI", 0.0) * nHI
            + heat_uv.get("HeI", 0.0) * nHeI
            + heat_uv.get("HeII", 0.0) * nHeII) / nH ** 2
    heat = np.broadcast_to(heat, lam.shape)

    # Compton vs CMB: tabulated per (ne/nH) so the extra /nH applied in
    # the lambda sum yields rate = tab/nH * nH^2 = 5.4e-36 (1+z)^4 ne ΔT
    t_cmb = T_CMB0 * (1 + z)
    comp = 5.406e-36 * (1 + z) ** 4 * ne / nH
    cool_com = comp * np.maximum(T - t_cmb, 0.0)
    heat_com = comp * np.maximum(t_cmb - T, 0.0)

    metal = metal_cooling_solar(T) * (ne * nH / nH ** 2)

    floor = 1e-100
    dlogT = log_T2[1] - log_T2[0]

    def logt(tab):
        return np.log10(np.maximum(tab, floor))

    tabs = {"log_nH": log_nH, "log_T2": log_T2}
    for name, tab in (("cool", lam), ("heat", heat),
                      ("cool_com", cool_com), ("heat_com", heat_com),
                      ("metal", metal)):
        lt = logt(tab)
        tabs[name] = lt
        tabs[name + "_p"] = _prime(lt, dlogT)
    tabs["mu"] = mu
    dev = torch.device(device)
    return CoolingTables(
        **{k: torch.tensor(np.asarray(v, dtype=np.float64), device=dev)
           for k, v in tabs.items()},
        host=tabs)


# ----------------------------------------------------------------------
# the stiff integrator (solve_cooling, cooling_module.f90:478-664)
# ----------------------------------------------------------------------

def _flat_like(v, nH):
    """A per-cell operand (scalar or array) as a flat tensor like nH."""
    v = torch.as_tensor(v, dtype=nH.dtype, device=nH.device)
    return v.reshape(-1) if v.dim() > 0 else v.expand(nH.shape)


def _interp_T(tab, tab_p, k00, k10, w1, w2, yy, hs):
    """Cubic Hermite in log T2 at fixed (interpolated) nH — the fa/fb/
    fprimea/fprimeb evaluation of the reference; ``k00``/``k10`` the flat
    indices of (i_nH, i_T2) and (i_nH+1, i_T2), ``hs`` the tables'
    ``divisors``."""
    h, h2, h3 = hs
    fa = torch.take(tab, k00) * w1 + torch.take(tab, k10) * w2
    fb = torch.take(tab, k00 + 1) * w1 + torch.take(tab, k10 + 1) * w2
    fpa = torch.take(tab_p, k00) * w1 + torch.take(tab_p, k10) * w2
    fpb = torch.take(tab_p, k00 + 1) * w1 + torch.take(tab_p, k10 + 1) * w2
    alpha = fpa
    beta = 3.0 * (fb - fa) / h2 - (2.0 * fpa + fpb) / h
    gamma = (fpa + fpb) / h2 - 2.0 * (fb - fa) / h3
    y2 = yy * yy
    val = torch.pow(10.0, fa + alpha * yy + beta * y2 + gamma * (y2 * yy))
    dlog = alpha + 2.0 * beta * yy + 3.0 * gamma * y2
    return val, dlog


def solve_cooling_ref(tables: CoolingTables, nH, T2, zsolar, boost, dt_s,
                      want_iters: bool = False):
    """Plain version of K6: ``solve_cooling`` as a torch ``while`` loop on
    ``active.any()`` and the iteration cap, every cell advancing its own
    pseudo-time in lockstep (finished cells masked), the JAX package's
    arithmetic.  Fetches ``active.any()`` each iteration: the CPU's
    formulation, and the card's yardstick.  ``want_iters`` also returns
    each cell's iteration count (int32, like K6's)."""
    shape = nH.shape
    nH = nH.reshape(-1)
    T2 = T2.reshape(-1)
    zsolar = _flat_like(zsolar, nH)
    boost = _flat_like(boost, nH)
    dt_s = torch.as_tensor(dt_s, dtype=nH.dtype, device=nH.device)
    c = tables.consts()
    tabs, log_nH, log_T2 = tables.packed(nH.dtype)
    tab = dict(zip(TABLE_NAMES, tabs))
    hs = tables.divisors(nH.dtype)

    facH = torch.clamp(torch.log10(nH / boost), c["log_nH0"], c["log_nH1"])
    i_nH = torch.clamp(((facH - c["log_nH0"]) * c["dlog_nH"])
                       .to(torch.int32), 0, NBIN_N - 2).to(torch.int64)
    w1 = (torch.take(log_nH, i_nH + 1) - facH) * c["dlog_nH"]
    w2 = (facH - torch.take(log_nH, i_nH)) * c["dlog_nH"]
    time_max = dt_s * c["precoeff"] * nH
    wmax = 1.0 / time_max

    def rate(tau):
        facT = torch.log10(tau)
        in_table = facT <= c["log_T2max"]
        i_T2 = torch.clamp(((facT - c["log_T20"]) * c["dlog_T2"])
                           .to(torch.int32), 0, NBIN_T - 2).to(torch.int64)
        yy = facT - torch.take(log_T2, i_T2)
        k00 = i_nH * NBIN_T + i_T2
        k10 = k00 + NBIN_T
        out = [_interp_T(tab[n], tab[n + "_p"], k00, k10, w1, w2, yy, hs)
               for n in TABLE_NAMES[:5]]
        (cool, cool_d), (heat, heat_d), (ccom, ccom_d), (hcom, hcom_d), \
            (met, met_d) = out
        lam = cool + zsolar * met - heat + (ccom - hcom) / nH
        lam_p = (cool * cool_d + zsolar * met * met_d - heat * heat_d
                 + (ccom * ccom_d - hcom * hcom_d) / nH) / tau
        # free-free tail above the table (reference's else branch)
        lam_hi = 1.42e-27 * torch.sqrt(tau) * 1.1
        lam = torch.where(in_table, lam, lam_hi)
        lam_p = torch.where(in_table, lam_p, lam_hi / (2.0 * tau))
        return lam, lam_p

    tau = T2.clone()
    tau_old = T2.clone()
    time = torch.zeros_like(T2)
    time_old = torch.zeros_like(T2)
    active = torch.ones_like(T2, dtype=torch.bool)
    iters = torch.zeros(T2.shape, dtype=torch.int32, device=T2.device)
    it = 0
    while it < MAX_ITER and bool(active.any()):
        lam, lam_p = rate(tau)
        wcool = torch.maximum(torch.maximum(torch.abs(lam) / tau * VARMAX,
                                            wmax), -lam_p * VARMAX)
        tau_new = tau * (1.0 + lam_p / wcool - lam / tau / wcool) \
            / (1.0 + lam_p / wcool)
        tau_old = torch.where(active, tau, tau_old)
        tau = torch.where(active, tau_new, tau)
        time_old = torch.where(active, time, time_old)
        time = torch.where(active, time + 1.0 / wcool, time)
        iters = iters + active.to(torch.int32)
        active = torch.logical_and(active, time < time_max)
        it += 1

    # interpolate onto the exact end time (reference ':622-625')
    denom = torch.where(time == time_old, torch.ones_like(time),
                        time - time_old)
    frac = torch.clamp((time_max - time_old) / denom, 0.0, 1.0)
    out = (tau * frac + tau_old * (1.0 - frac)).reshape(shape)
    return (out, iters.reshape(shape)) if want_iters else out


def solve_cooling(tables: CoolingTables, nH, T2, zsolar, boost, dt_s,
                  want_iters: bool = False):
    """Advance T2 over ``dt_s`` seconds at fixed nH (the reference's
    scheme verbatim, ``:478-664``: per-cell pseudo-time marching with
    semi-implicit updates limited to VARMAX relative change, then linear
    interpolation onto the exact end time).  Returns the new T2 (and, with
    ``want_iters``, each cell's iteration count).

    ``zsolar`` and ``boost`` are per-cell tensors or scalars; ``dt_s`` a
    scalar or a 0-d tensor on the cells' device.  A CPU tensor runs
    :func:`solve_cooling_ref`; a CUDA tensor launches K6 (counted in
    ``launches``) or raises."""
    if nH.device.type == "cpu":
        return solve_cooling_ref(tables, nH, T2, zsolar, boost, dt_s,
                                 want_iters)
    return _launch(tables, nH, T2, zsolar, boost, dt_s, want_iters)


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
             + [ctypes.c_double] * 10 + [ctypes.c_void_p])
_STEP_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 4
                  + [ctypes.c_int] * 4 + [ctypes.c_double] * 19
                  + [ctypes.c_void_p])
_ENTRY = {torch.float32: "ramses_cooling_f32",
          torch.float64: "ramses_cooling_f64"}
_STEP_ENTRY = {torch.float32: "ramses_cooling_step_f32",
               torch.float64: "ramses_cooling_step_f64"}


def _consts(tables) -> tuple:
    """The table constants in the order K6's entries take them."""
    c = tables.consts()
    return tuple(c[k] for k in ("log_nH0", "log_nH1", "dlog_nH", "log_T20",
                                "dlog_T2", "h", "h2", "h3", "precoeff",
                                "log_T2max"))


def _library():
    from ramses_tpu_torch import kernels
    return bind(kernels.load("cooling"))


def bind(lib):
    """Declare the C entry points' signatures on a loaded build of
    ``csrc/cooling.cu``."""
    for entries, args in ((_ENTRY, _ARGTYPES), (_STEP_ENTRY, _STEP_ARGTYPES)):
        for name in entries.values():
            fn = getattr(lib, name)
            if fn.argtypes is None:
                fn.argtypes = args
                fn.restype = ctypes.c_int
    return lib


def _operand(v, nH, name: str):
    """(tensor, stride) of a per-cell operand for K6: a flat contiguous
    tensor of nH's length (stride 1) or a one-element tensor (stride 0).
    A Python number becomes a one-element fill on the card, not a copy
    from the host, so that the step loop waits on nothing."""
    if not torch.is_tensor(v):
        return torch.full((1,), float(v), dtype=nH.dtype,
                          device=nH.device), 0
    v = v.to(dtype=nH.dtype, device=nH.device)
    if v.numel() == 1:
        return v.reshape(1).contiguous(), 0
    if v.numel() != nH.numel():
        raise ValueError(f"solve_cooling: {name} has {v.numel()} values for "
                         f"{nH.numel()} cells")
    return v.reshape(-1).contiguous(), 1


def _check_args(tables, nH, T2):
    """Raise unless nH and T2 share an f32 or f64 dtype and a shape, and
    lie with the tables on one CUDA device."""
    if nH.dtype not in _ENTRY or T2.dtype != nH.dtype:
        raise ValueError(f"solve_cooling: nH and T2 must share an f32 or f64 "
                         f"dtype, got {nH.dtype} and {T2.dtype}")
    if nH.device.type != "cuda" or T2.device != nH.device \
            or tables.device != nH.device or nH.shape != T2.shape:
        raise ValueError("solve_cooling: nH, T2 and the tables must lie on "
                         "one CUDA device, nH and T2 of one shape")


def _launch(tables, nH, T2, zsolar, boost, dt_s, want_iters):
    """One K6 launch of the march entry, counted in ``launches``; raises on
    bad arguments and when the build or the launch fails.  No cells:
    nothing is launched or counted."""
    global launches
    _check_args(tables, nH, T2)
    shape = nH.shape
    if not nH.numel():
        out = torch.empty_like(nH)
        iters = torch.empty(shape, dtype=torch.int32, device=nH.device)
        return (out, iters) if want_iters else out
    with torch.cuda.device(nH.device):
        out, iters = call(_library(), tables, nH, T2, zsolar, boost, dt_s,
                          want_iters,
                          torch.cuda.current_stream(nH.device).cuda_stream)
    launches += 1
    out = out.reshape(shape)
    return (out, iters.reshape(shape)) if want_iters else out


def call(lib, tables, nH, T2, zsolar, boost, dt_s, want_iters=False,
         stream=None):
    """One call of the march entry (``ramses_cooling_f32``/``_f64``) in
    the loaded build ``lib`` (the card's build on CUDA tensors, or a host
    build of the source on CPU ones); returns the flat ``(T2 out, iters or
    None)``; raises on the error it returns."""
    dtype = nH.dtype
    nh = nH.reshape(-1).contiguous()
    t2 = T2.reshape(-1).contiguous()
    n = nh.numel()
    zs, zs_stride = _operand(zsolar, nh, "zsolar")
    bs, bs_stride = _operand(boost, nh, "boost")
    dts, _ = _operand(dt_s, nh[:1], "dt_s")
    _, log_nH, log_T2 = tables.packed(dtype)
    inter = tables.interleaved(dtype)
    out = torch.empty_like(nh)
    iters = (torch.empty(n, dtype=torch.int32, device=nh.device)
             if want_iters else None)
    err = getattr(lib, _ENTRY[dtype])(
        nh.data_ptr(), t2.data_ptr(), zs.data_ptr(), zs_stride,
        bs.data_ptr(), bs_stride, dts.data_ptr(), inter.data_ptr(),
        log_nH.data_ptr(), log_T2.data_ptr(), out.data_ptr(),
        iters.data_ptr() if iters is not None else None, n,
        *_consts(tables), stream)
    if err:
        raise RuntimeError(f"cooling kernel launch failed (cudaError "
                           f"{err})")
    return out, iters


# ----------------------------------------------------------------------
# ISM cooling (Audit & Hennebelle 2005 — hydro/cooling_module_ism.f90)
# ----------------------------------------------------------------------

def _ism_rate(T, n):
    """Net heating-cooling rate [erg/s/cm^3] of the ISM module:
    fine-structure CII/OI + H Lyα + metastable lines + grain
    photoelectric heating + grain recombination below 10^4 K
    (``cooling_low``), Dopita & Sutherland piecewise fit above
    (``cooling_high``), blended at the module's 10035 K switch."""
    T = torch.clamp(T, min=1.0)
    n = torch.clamp(n, min=1e-10)
    kB_ism = 1.38e-16

    ne = 2.4e-3 * (T / 100.0) ** 0.25 / 0.5      # Wolfire+03 C15
    x = torch.clamp(ne / n, 3.5e-4 * 0.4, 0.1)
    cold_cII = (92.0 * kB_ism * 2.0
                * (2.8e-7 * (T / 100.0) ** -0.5 * x
                   + 8e-10 * (T / 100.0) ** 0.07)
                * 3.5e-4 * 0.4 * torch.exp(-92.0 / T))
    cold_o = (1e-26 * torch.sqrt(T)
              * (24.0 * torch.exp(-228.0 / T)
                 + 7.0 * torch.exp(-326.0 / T))) * 4.5e-4
    cold_h = 7.3e-19 * x * torch.exp(-118400.0 / T)
    cold_cII_m = (6.2e4 * kB_ism
                  * (2.3e-8 * (T / 1e4) ** -0.5 * x + 1e-12)
                  * torch.exp(-6.2e4 / T) * 3.5e-4 * 0.4)
    lowT = T <= 1e4

    def pw(a, b):
        return torch.where(lowT, torch.full_like(T, a), torch.full_like(T, b))
    o1 = (2.3e4 * kB_ism / 3.0
          * (5.1e-9 * (T / 1e4) ** pw(0.57, 0.17) * x + 1e-12)
          * torch.exp(-2.3e4 / T))
    o2 = (4.9e4 * kB_ism / 3.0
          * (2.5e-9 * (T / 1e4) ** pw(0.57, 0.13) * x + 1e-12)
          * torch.exp(-4.9e4 / T))
    o3 = (2.6e4 * kB_ism
          * (5.2e-9 * (T / 1e4) ** pw(0.57, 0.15) * x + 1e-12)
          * torch.exp(-2.6e4 / T))
    cold_o_m = (o1 + o2 + o3) * 4.5e-4
    cold_lo = cold_cII + cold_h + cold_o + cold_o_m + cold_cII_m
    G0 = 1.0 / 1.7
    param = G0 * torch.sqrt(T) / (n * x)
    eps_pe = (4.9e-2 / (1.0 + (param / 1925.0) ** 0.73)
              + 3.7e-2 * (T / 1e4) ** 0.7 / (1.0 + param / 5e3))
    hot = 1e-24 * eps_pe * G0
    bet = 0.74 / T ** 0.068
    cold_rec = 4.65e-30 * T ** 0.94 * param ** bet * x
    rate_lo = hot * n - n * n * (cold_lo + cold_rec)

    logT = torch.log10(T)
    c = torch.where(
        logT < 4.0,
        0.1343 * logT ** 3 - 1.3906 * logT ** 2 + 5.1554 * logT - 31.967,
        torch.where(
            logT < 4.25, 12.64 * logT - 75.56,
            torch.where(
                logT < 4.35, -0.3 * logT - 20.565,
                torch.where(
                    logT < 4.9, 1.745 * logT - 29.463,
                    torch.where(
                        logT < 5.4, torch.full_like(logT, -20.9125),
                        torch.where(
                            logT < 5.9, -1.795 * logT - 11.219,
                            torch.where(
                                logT < 6.2, torch.full_like(logT, -21.8095),
                                torch.where(
                                    logT < 6.7, -1.261 * logT - 13.991,
                                    torch.full_like(logT, -22.44)))))))))
    rate_hi = -(n * n) * torch.pow(10.0, c)
    return torch.where(T < 10035.0, rate_lo, rate_hi)


def solve_cooling_ism(nH, T2, dt_s, gamma: float = 5.0 / 3.0,
                      nsub: int = 200):
    """ISM thermal update (``solve_cooling_ism`` / ``calc_temp``): T2'
    such that the net Audit & Hennebelle rate integrates over ``dt_s``
    seconds, as ``nsub`` fixed semi-implicit substeps (each ΔT =
    R/(α/δt − min(dR/dT, 0)) with a 20 % clamp), the JAX package's
    schedule.  A torch formulation on either device: its loop has a known
    length, so it fetches nothing.  ``T2`` is T/µ; the rate takes the
    physical T ≈ T2·µ with the module's fixed µ = 1.4."""
    kB_ism = 1.38e-16
    mu = 1.4
    alpha = nH * kB_ism / (gamma - 1.0)          # per physical T
    dts = dt_s / nsub
    T = torch.clamp(T2 * mu, min=3.0)
    for _ in range(nsub):
        eps = 1e-5
        r0 = _ism_rate(T, nH)
        r1 = _ism_rate(T * (1.0 + eps), nH)
        drdT = (r1 - r0) / (T * eps)
        denom = alpha / dts + torch.clamp(-drdT, min=0.0)
        dT = r0 / denom
        dT = torch.minimum(torch.maximum(dT, -0.2 * T), 0.2 * T)
        T = torch.clamp(T + dT, min=3.0)
    return T / mu


@dataclass(frozen=True)
class CoolingSpec:
    """Static cooling configuration (from &COOLING_PARAMS)."""
    enabled: bool = False
    ism: bool = False            # Audit & Hennebelle module (cooling_ism)
    ism_nsub: int = 200          # ISM integrator substeps (ism_nsub)
    metal: bool = False
    z_ave: float = 0.0           # mean metallicity when no metal tracer
    self_shielding: bool = False
    T2max: float = 1e50
    scale_T2: float = 1.0        # code (P/rho) → K
    scale_nH: float = 1.0        # code rho → H/cc
    scale_t: float = 1.0         # code time → s
    # polytrope temperature floor (barotropic_eos_* of &COOLING_PARAMS)
    floor_form: str = ""         # "" → no floor
    T2_eos: float = 10.0
    polytrope_rho_cu: float = 1.0  # break density [H/cc]
    polytrope_index: float = 1.0

    @classmethod
    def from_params(cls, p, units) -> "CoolingSpec":
        c = p.cooling
        raw_cool = (p.raw.get("cooling_params", {}) if p.raw else {})
        return cls(enabled=bool(c.cooling),
                   ism=bool(getattr(c, "cooling_ism", False)),
                   ism_nsub=int(raw_cool.get("ism_nsub", 200)),
                   metal=bool(c.metal),
                   z_ave=float(c.z_ave),
                   self_shielding=bool(c.self_shielding),
                   T2max=float(c.T2max),
                   scale_T2=units.scale_T2, scale_nH=units.scale_nH,
                   scale_t=units.scale_t,
                   floor_form=(str(c.barotropic_eos_form)
                               if c.barotropic_eos else ""),
                   T2_eos=float(c.T_eos),
                   polytrope_rho_cu=float(c.polytrope_rho)
                   / max(units.scale_d, 1e-300) * units.scale_nH
                   if c.polytrope_rho else 1.0,
                   polytrope_index=float(c.polytrope_index))


def tables_from_params(params, aexp: float, device) -> CoolingTables:
    """:func:`build_tables` at ``aexp`` from &COOLING_PARAMS."""
    c = params.cooling
    return build_tables(aexp=aexp, J21=float(c.J21), a_spec=float(c.a_spec),
                        z_reion=float(c.z_reion),
                        haardt_madau=bool(c.haardt_madau), device=device)


def _clip_max(x, hi: float):
    """``min(x, hi)``; a bound past the dtype's range (T2max's default
    1e50 in f32) is the infinite one, as in the JAX package."""
    if hi >= torch.finfo(x.dtype).max:
        return x
    return torch.clamp(x, max=hi)


def _floor_of(nH, spec: CoolingSpec):
    """The polytrope temperature floor (K) of ``spec.floor_form`` at
    ``nH``; None without one."""
    if not spec.floor_form:
        return None
    from ramses_tpu_torch.hydro.eos import barotropic_eos_temperature
    return barotropic_eos_temperature(nH, spec.floor_form, spec.T2_eos,
                                      spec.polytrope_rho_cu,
                                      spec.polytrope_index)


def cooling_inputs(u, spec: CoolingSpec, dt, cfg, t2_floor=None,
                   scales=None) -> dict:
    """The torch passes of :func:`cooling_step` before the solve, on a
    dense conservative state ``u [nvar, *sp]``: ``rho`` (the smallr
    clamp), ``ekin``, ``eother``, ``nH``, ``T2`` (the floor subtracted,
    clipped to T2_MIN and T2max), the floor ``t2_floor``, ``boost``,
    ``zsolar`` and ``dt_s``, the solve's inputs."""
    ndim = cfg.ndim
    if scales is None:
        s_T2, s_nH, s_t = spec.scale_T2, spec.scale_nH, spec.scale_t
    else:
        s_T2, s_nH, s_t = scales[0], scales[1], scales[2]
    rho = torch.clamp(u[0], min=cfg.smallr)
    ekin = sum(0.5 * u[1 + d] ** 2 for d in range(ndim)) / rho
    eother = torch.zeros_like(rho)
    for n in range(cfg.nener):
        eother = eother + u[ndim + 2 + n]
    eint = u[ndim + 1] - ekin - eother
    T2_code = (cfg.gamma - 1.0) * eint / rho
    T2 = T2_code * s_T2
    nH = rho * s_nH

    if t2_floor is None:
        t2_floor = _floor_of(nH, spec)
        if t2_floor is None:
            t2_floor = torch.zeros_like(T2)
    T2_excess = _clip_max(torch.clamp(T2 - t2_floor, min=T2_MIN),
                          spec.T2max)

    # per cell only with self-shielding; K6 reads a number at stride 0
    boost = (torch.clamp(torch.exp(-nH / 0.01), min=1e-20)
             if spec.self_shielding else 1.0)
    # as the JAX package: the mean metallicity, also with metal=.true.
    return dict(rho=rho, ekin=ekin, eother=eother, nH=nH, T2=T2_excess,
                t2_floor=t2_floor, boost=boost, zsolar=spec.z_ave,
                dt_s=dt * s_t)


def cooling_energy(T2_new, parts: dict, spec: CoolingSpec, cfg,
                   scales=None):
    """The thermal energy after the solve: the floor added back, the
    T2max clip, back to code units (``cooling_step`` after the solve)."""
    s_T2 = spec.scale_T2 if scales is None else scales[0]
    T2_out = _clip_max(T2_new + parts["t2_floor"], spec.T2max)
    return T2_out / s_T2 * parts["rho"] / (cfg.gamma - 1.0)


def cooling_step_ref(u, tables: CoolingTables, spec: CoolingSpec, dt, cfg,
                     t2_floor=None, scales=None, inplace: bool = False):
    """Plain version of K6's fused entry: :func:`cooling_step`'s torch
    passes around :func:`solve_cooling_ref` (or the ISM module), on either
    device; the CPU's formulation and the card's yardstick."""
    p = cooling_inputs(u, spec, dt, cfg, t2_floor, scales)
    if spec.ism:
        T2_new = solve_cooling_ism(p["nH"], p["T2"], p["dt_s"], cfg.gamma,
                                   nsub=spec.ism_nsub)
    else:
        T2_new = solve_cooling_ref(tables, p["nH"], p["T2"], p["zsolar"],
                                   p["boost"], p["dt_s"])
    eint_new = cooling_energy(T2_new, p, spec, cfg, scales)
    out = u if inplace else u.clone()
    out[cfg.ndim + 1] = eint_new + p["ekin"] + p["eother"]
    return out


def fused_supports(spec: CoolingSpec) -> bool:
    """Whether K6's fused entry takes this cooling pass (by configuration
    only): everything but the ISM module (``spec.ism``), whose solve has
    no kernel."""
    return not spec.ism


def cooling_step(u, tables: CoolingTables, spec: CoolingSpec, dt, cfg,
                 t2_floor=None, scales=None, inplace: bool = False):
    """Apply cooling over dt (code units) to a dense conservative state
    ``u [nvar, *sp]`` — the vectorized ``cooling_fine`` pass: separate
    thermal from kinetic energy, convert to (nH, T2) in cgs, integrate,
    convert back; returns the new state (``u`` itself, its E row
    rewritten, with ``inplace``; else a copy).  ``t2_floor`` (like rho, K)
    is the polytrope temperature subtracted before and re-added after
    (``:329-355``); without it, ``spec.floor_form``'s.  ``dt`` a scalar or
    a 0-d tensor on u's device.

    ``scales``: an optional tensor ``[scale_T2, scale_nH, scale_t]`` on
    u's device overriding the spec's values: a cosmological run passes
    the current epoch's supercomoving conversions with no host fetch.

    A CUDA state that :func:`fused_supports` takes is one launch of K6's
    fused entry (counted in ``step_launches``), or raises; a CPU state,
    and the ISM module on either device, run :func:`cooling_step_ref`."""
    if u.device.type != "cpu" and fused_supports(spec):
        return _fused_step(u, tables, spec, dt, cfg, t2_floor, scales,
                           inplace)
    return cooling_step_ref(u, tables, spec, dt, cfg, t2_floor, scales,
                            inplace)


def _fused_step(u, tables, spec, dt, cfg, t2_floor, scales, inplace):
    """One launch of K6's fused entry, counted in ``step_launches``;
    raises on arguments it does not take and when the build or the launch
    fails.  No cells: nothing is launched or counted."""
    global step_launches
    if u.device.type != "cuda" or tables.device != u.device:
        raise ValueError("cooling_step: the state and the tables must lie "
                         "on one CUDA device")
    out = u if inplace else u.clone()
    if u[0].numel():
        with torch.cuda.device(u.device):
            call_step(_library(), u, out, tables, spec, dt, cfg, scales,
                      torch.cuda.current_stream(u.device).cuda_stream,
                      t2_floor)
        step_launches += 1
    return out


def call_step(lib, u, out, tables, spec, dt, cfg, scales=None,
              stream=None, t2_floor=None):
    """One call of the fused entry (``ramses_cooling_step_f32``/``_f64``)
    in the loaded build ``lib`` (the card's build on CUDA tensors, or a
    host build of the source on CPU ones): reads the state ``u`` and
    writes the new E row into ``out`` (``u`` itself, or a tensor of its
    shape).  ``u`` is f32 or f64, a 2-D view (a level's ``u[l].T``) or a
    contiguous tensor; ``dt`` a number or a one-element tensor,
    ``scales`` a tensor of three values and ``t2_floor`` one of a value a
    cell (or one for all), each in u's dtype on its device.  Without
    ``t2_floor``, ``spec.floor_form``'s floor is computed here in torch,
    as :func:`cooling_inputs` computes it.  Raises ValueError on anything
    else and RuntimeError on the error the entry returns."""
    nvar = u.shape[0]
    ndim = cfg.ndim
    if nvar < ndim + 2 + cfg.nener or out.shape != u.shape:
        raise ValueError(f"cooling_step: state {tuple(u.shape)} (out "
                         f"{tuple(out.shape)}) for ndim={ndim}, "
                         f"nener={cfg.nener}")
    if u.dtype not in _STEP_ENTRY or not (u.dim() == 2
                                          or u.is_contiguous()):
        raise ValueError(f"cooling_step: K6 takes an f32 or f64 state, a "
                         f"2-D view or a contiguous one, not {u.dtype} of "
                         f"strides {u.stride()}")
    if scales is not None and not torch.is_tensor(scales):
        raise ValueError("cooling_step: scales must be a tensor")
    for name, t, n in (("dt", dt, (1,)), ("scales", scales, (3,)),
                       ("t2_floor", t2_floor, (1, u[0].numel()))):
        if torch.is_tensor(t) and (t.dtype != u.dtype or t.device != u.device
                                   or t.numel() not in n):
            raise ValueError(f"cooling_step: {name} must hold "
                             f"{' or '.join(map(str, n))} values in the "
                             f"state's dtype on its device, not "
                             f"{t.numel()} {t.dtype} on {t.device}")
    if t2_floor is None and spec.floor_form:
        s_nH = spec.scale_nH if scales is None else scales[1]
        t2_floor = _floor_of(torch.clamp(u[0], min=cfg.smallr) * s_nH, spec)
    fl = (None if t2_floor is None else torch.broadcast_to(
        t2_floor, u.shape[1:]).reshape(-1).contiguous())
    flat = u if u.dim() == 2 else u.reshape(nvar, -1)
    erow = (out if out.dim() == 2 else out.reshape(nvar, -1))[ndim + 1]
    dtype = u.dtype
    _, log_nH, log_T2 = tables.packed(dtype)
    inter = tables.interleaved(dtype)
    sc = None if scales is None else scales.reshape(3).contiguous()
    dtp = dt.reshape(1) if torch.is_tensor(dt) else None
    has_max = spec.T2max < torch.finfo(dtype).max
    err = getattr(lib, _STEP_ENTRY[dtype])(
        flat.data_ptr(), erow.data_ptr(),
        fl.data_ptr() if fl is not None else None,
        sc.data_ptr() if sc is not None else None,
        dtp.data_ptr() if dtp is not None else None, inter.data_ptr(),
        log_nH.data_ptr(), log_T2.data_ptr(), flat.shape[1], flat.stride(0),
        flat.stride(1), erow.stride(0), ndim, cfg.nener, int(has_max),
        int(bool(spec.self_shielding)), float(cfg.smallr),
        float(cfg.gamma - 1.0), float(spec.scale_T2), float(spec.scale_nH),
        float(spec.scale_t), 0.0 if dtp is not None else float(dt),
        float(spec.z_ave), float(T2_MIN), float(spec.T2max),
        *_consts(tables), stream)
    if err:
        raise RuntimeError(f"cooling step kernel launch failed (cudaError "
                           f"{err})")
