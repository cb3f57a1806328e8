"""Non-equilibrium hydrogen (and H/He) photochemistry + photoheating
(PyTorch), and the wrappers of K9.

Port of ``ramses_tpu/rt/chem.py``, the ``rt/rt_cooling_module.f90``
capability: per cell and substep, implicitly coupled updates of the photon
densities (absorption), the ionized fractions (photo- and collisional
ionization against case-B recombination, on the spot) and the temperature
(photoheating, recombination cooling).  Rates are the standard published
fits (Cen 1992; Hui & Gnedin 1997), cgs throughout.

:func:`chem_step_ref` (the gray single-group H system) and
:func:`chem_step_3ion_ref` (the multigroup HII/HeII/HeIII ladder) are the
JAX package's functions as torch, in its order of operations: 5
fixed-point iterations from the fixed ``x0``, the clips at 1e-10 and
1 − 1e-10, the HeII+HeIII renormalisation, the optional homogeneous UV
background ``uv``.  They are K9's plain versions.  On the card one
chemistry substep of a level is one launch of K9 (``csrc/rt_chem.cu``):
:func:`chem_gray` and :func:`chem_3ion` take the photon densities as a
strided view (the uniform fields, or a column of the AMR rows) and update
them in place.  On CPU tensors they run the plain versions; on CUDA
tensors they launch K9 (counted in :data:`launches`) or raise.  More
groups than :data:`MAX_GROUPS` run the plain version on either device, by
configuration (:func:`supports`).

Where the JAX package divides by a Python number the plain versions divide
by a 0-d tensor (ROADMAP §C12: PyTorch on CUDA multiplies by the
reciprocal of a Python-number divisor, which rounds otherwise than K9 and
the JAX package's division).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ramses_tpu_torch.units import kB

EV = 1.602177e-12
# canonical ionization thresholds [eV] — shared with rt.spectra
ION_EV = (13.5984, 24.5874, 54.4178)     # HI, HeI, HeII
E_ION_HI = ION_EV[0] * EV
E_ION = tuple(e * EV for e in ION_EV)

# K9's fixed group table: sigmaN[3] and the photon energy of each group
MAX_GROUPS = 8

# K9 launches since the count was last reset (the main path's proof that
# the chemistry went through the kernel)
launches = 0


@dataclass(frozen=True)
class GroupSpec:
    """Gray photon group (the reference's per-group SED-averaged
    cross-sections/energies, ``rt/rt_spectra.f90``)."""
    sigma: float = 3.0e-18       # cm^2, HI-ionization-weighted
    e_photon: float = 18.85 * EV  # mean photon energy (1e5 K blackbody)


def divisor(v: float, like):
    """``v`` as a 0-d tensor of ``like``'s dtype and device: what the plain
    versions divide by, or divide, where the JAX package divides by a
    Python number or divides one (ROADMAP §C12)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def alpha_B(T):
    """Case-B recombination [cm^3/s] (Hui & Gnedin 1997 fit)."""
    lam = divisor(2.0 * 157807.0, T) / torch.clamp(T, min=1.0)
    return 2.753e-14 * lam ** 1.5 / (1.0 + (lam / divisor(2.74, T)) ** 0.407) \
        ** 2.242


def alpha_A(T):
    lam = divisor(2.0 * 157807.0, T) / torch.clamp(T, min=1.0)
    return 1.269e-13 * lam ** 1.503 / (1.0 + (lam / divisor(0.522, T)) ** 0.47) \
        ** 1.923


def beta_ci(T):
    """Collisional ionization [cm^3/s] (Cen 1992)."""
    T = torch.clamp(T, min=1.0)
    return (5.85e-11 * torch.sqrt(T) * torch.exp(divisor(-157809.1, T) / T)
            / (1.0 + torch.sqrt(T / divisor(1e5, T))))


def cool_rec_B(T):
    """Case-B recombination cooling [erg cm^3/s]."""
    lam = divisor(2.0 * 157807.0, T) / torch.clamp(T, min=1.0)
    return (3.435e-30 * T * lam ** 1.97
            / (1.0 + (lam / divisor(2.25, T)) ** 0.376) ** 3.72)


def alpha_B_HeII(T):
    """Case-B He+ recombination [cm^3/s] (Hui & Gnedin 1997)."""
    lam = divisor(2.0 * 285335.0, T) / torch.clamp(T, min=1.0)
    return 1.26e-14 * lam ** 0.75


def alpha_B_HeIII(T):
    """Case-B He++ recombination: hydrogenic Z=2 scaling of HG97."""
    lam = divisor(2.0 * 631515.0, T) / torch.clamp(T, min=1.0)
    return 2.0 * 2.753e-14 * lam ** 1.5 \
        / (1.0 + (lam / divisor(2.74, T)) ** 0.407) ** 2.242


def beta_ci_HeI(T):
    T = torch.clamp(T, min=1.0)
    return (2.38e-11 * torch.sqrt(T) * torch.exp(divisor(-285335.4, T) / T)
            / (1.0 + torch.sqrt(T / divisor(1e5, T))))


def beta_ci_HeII(T):
    T = torch.clamp(T, min=1.0)
    return (5.68e-12 * torch.sqrt(T) * torch.exp(divisor(-631515.0, T) / T)
            / (1.0 + torch.sqrt(T / divisor(1e5, T))))


def chem_step_3ion_ref(Ns, xs, T, nH, nHe, dt, c_red, groups,
                       otsa: bool = True, niter: int = 5,
                       heating: bool = True, uv=None):
    """Multigroup, 3-ion (HII, HeII, HeIII) implicit chemistry substep —
    the ``rt_cooling_module.f90`` system with helium (the JAX package's
    ``chem_step_3ion``).

    ``Ns``: list of per-group photon densities; ``xs`` = (xHII, xHeII,
    xHeIII) fractional abundances (of H and He respectively); ``groups``:
    :class:`ramses_tpu_torch.rt.spectra.Group3` tuple.  ``uv``: optional
    homogeneous UV background (``rt_UV_hom``) as (gamma[3] 1/s,
    heat[3] erg/s) per HI/HeI/HeII atom.  Returns (Ns', xs', T').
    """
    dt_t = divisor(float(dt), T)
    xH0, xHe20, xHe30 = [torch.clamp(x, 1e-10, 1.0 - 1e-10) for x in xs]
    xH, xHe2, xHe3 = xH0, xHe20, xHe30
    aH = alpha_B(T) if otsa else alpha_A(T)
    aHe2 = alpha_B_HeII(T)
    aHe3 = alpha_B_HeIII(T)

    def densities(xH, xHe2, xHe3):
        nHI = nH * (1.0 - xH)
        nHeI = nHe * torch.clamp(1.0 - xHe2 - xHe3, 1e-10, 1.0)
        nHeII = nHe * xHe2
        ne = nH * xH + nHe * (xHe2 + 2.0 * xHe3)
        return nHI, nHeI, nHeII, ne

    for _ in range(niter):
        nHI, nHeI, nHeII, ne = densities(xH, xHe2, xHe3)
        # implicit absorption per group at fixed ion densities
        Gam = [torch.zeros_like(T) for _ in range(3)]
        for g, N in zip(groups, Ns):
            tau = (g.sigmaN[0] * nHI + g.sigmaN[1] * nHeI
                   + g.sigmaN[2] * nHeII)
            Np = N / (1.0 + dt * c_red * tau)
            for sp in range(3):
                Gam[sp] = Gam[sp] + c_red * g.sigmaN[sp] * Np
        if uv is not None:
            for sp in range(3):
                Gam[sp] = Gam[sp] + uv[0][sp]
        # H: (Γ + β ne)(1-x) = α ne x — implicit from the FIXED initial
        # state, rates refined at the current guess (see chem_step_ref)
        creH = Gam[0] + beta_ci(T) * ne
        xH = torch.clamp((xH0 + dt * creH) / (1.0 + dt * (creH + aH * ne)),
                         1e-10, 1.0 - 1e-10)
        # He ladder: HeI→HeII (Γ1+β ne), HeII→HeIII (Γ2+β ne),
        # HeIII→HeII (α3 ne), HeII→HeI (α2 ne); linearized implicit
        cre1 = Gam[1] + beta_ci_HeI(T) * ne
        cre2 = Gam[2] + beta_ci_HeII(T) * ne
        xHeI = torch.clamp(1.0 - xHe2 - xHe3, 1e-10, 1.0)
        xHe2 = torch.clamp(
            (xHe20 + dt * (cre1 * xHeI + aHe3 * ne * xHe3))
            / (1.0 + dt * (cre2 + aHe2 * ne)), 1e-10, 1.0)
        xHe3 = torch.clamp((xHe30 + dt * cre2 * xHe2)
                           / (1.0 + dt * aHe3 * ne), 1e-10, 1.0)
        s = xHe2 + xHe3
        over = s > 1.0 - 1e-10
        xHe2 = torch.where(over, xHe2 / s * (1.0 - 1e-10), xHe2)
        xHe3 = torch.where(over, xHe3 / s * (1.0 - 1e-10), xHe3)

    nHI, nHeI, nHeII, ne = densities(xH, xHe2, xHe3)
    N_out = []
    heat = torch.zeros_like(T)
    for g, N in zip(groups, Ns):
        tau_sp = [g.sigmaN[0] * nHI, g.sigmaN[1] * nHeI,
                  g.sigmaN[2] * nHeII]
        tau = tau_sp[0] + tau_sp[1] + tau_sp[2]
        Np = N / (1.0 + dt * c_red * tau)
        N_out.append(Np)
        if heating:
            absorbed = torch.clamp(N - Np, min=0.0) / dt_t
            frac = [t / torch.clamp(tau, min=1e-300) for t in tau_sp]
            for sp in range(3):
                heat = heat + absorbed * frac[sp] * max(
                    g.e_photon - E_ION[sp], 0.0)
    if heating:
        if uv is not None:
            heat = heat + (uv[1][0] * nHI + uv[1][1] * nHeI
                           + uv[1][2] * nHeII)
        cool = (cool_rec_B(T) * ne * nH * xH
                + 1.55e-26 * T ** 0.3647 * ne * nHeII)   # He+ rec (Cen92)
        ntot = nH * (1.0 + xH) + nHe * (1.0 + xHe2 + 2.0 * xHe3)
        dT = dt * (heat - cool) / (1.5 * kB * torch.clamp(ntot, min=1e-30))
        T = torch.clamp(T + dT, min=1.0)
    return N_out, (xH, xHe2, xHe3), T


def chem_step_ref(N, xHII, T, nH, dt, c_red, group: GroupSpec,
                  otsa: bool = True, niter: int = 5, heating: bool = True,
                  uv=None):
    """One implicitly-coupled chemistry substep (the JAX package's
    ``chem_step``).  Returns (N', x', T').

    Sequential implicit sweep (the reference's cell-wise iteration,
    ``rt_cooling_module`` order absorption → ionization → thermal),
    fixed-point iterated ``niter`` times for the x↔ne coupling.
    """
    x0 = torch.clamp(xHII, 1e-10, 1.0 - 1e-10)
    x = x0
    alpha = alpha_B(T) if otsa else alpha_A(T)

    # fixed-point refinement of the IMPLICIT update: rates evaluate at
    # the current guess, but the step always starts from x0 (iterating
    # the update itself would compound niter timesteps of ionization)
    for _ in range(niter):
        nHI = nH * (1.0 - x)
        # implicit absorption at fixed nHI
        N_new = N / (1.0 + dt * c_red * group.sigma * nHI)
        gamma = c_red * group.sigma * N_new         # photoionizations/s/atom
        if uv is not None:
            gamma = gamma + uv[0][0]
        ne = nH * x
        cre = gamma + beta_ci(T) * ne
        dst = alpha * ne
        x = torch.clamp((x0 + dt * cre) / (1.0 + dt * (cre + dst)),
                        1e-10, 1.0 - 1e-10)

    nHI = nH * (1.0 - x)
    N_out = N / (1.0 + dt * c_red * group.sigma * nHI)
    # photons actually absorbed per volume
    absorbed = torch.clamp(N - N_out, min=0.0)

    if heating:
        ne = nH * x
        heat = absorbed / divisor(float(dt), T) * (group.e_photon - E_ION_HI)
        if uv is not None:
            heat = heat + uv[1][0] * nHI
        cool = cool_rec_B(T) * ne * nH * x
        ntot = nH * (1.0 + x)                        # H + electrons
        dT = dt * (heat - cool) / (1.5 * kB * torch.clamp(ntot, min=1e-30))
        T = torch.clamp(T + dT, min=1.0)
    return N_out, x, T


# ----------------------------------------------------------------------
# K9
# ----------------------------------------------------------------------

def supports(ng: int) -> bool:
    """True when K9's fixed group table holds ``ng`` groups."""
    return 1 <= ng <= MAX_GROUPS


def chem_gray(Nv, x, T, nH, dt: float, c_red: float, group: GroupSpec,
              otsa: bool = True, heating: bool = True, uv=None):
    """The gray chemistry substep of every cell: ``Nv`` a 1-D (strided)
    view of the photon densities, updated in place; returns (x', T').  A
    CPU tensor runs :func:`chem_step_ref`, a CUDA tensor one K9 launch."""
    if Nv.device.type == "cpu":
        N, x, T = chem_step_ref(Nv, x, T, nH, dt, c_red, group, otsa,
                                heating=heating, uv=uv)
        Nv.copy_(N)
        return x, T
    global launches
    n = Nv.shape[0]
    _check_cells(Nv, n, x=x, T=T, nH=nH)
    x_out, T_out = torch.empty_like(x), torch.empty_like(T)
    if n:
        with torch.cuda.device(Nv.device):
            call_gray(_library(), Nv, x, T, nH, x_out, T_out, dt, c_red,
                      group, otsa, heating, uv,
                      torch.cuda.current_stream(Nv.device).cuda_stream)
        launches += 1
    return x_out, T_out


def chem_3ion(Nv, x, xhe2, xhe3, T, nH, nHe, dt: float, c_red: float,
              groups, otsa: bool = True, heating: bool = True, uv=None):
    """The 3-ion chemistry substep of every cell: ``Nv [ng, ncell]`` a
    (strided) view of every group's photon densities, updated in place;
    ``xhe2``/``xhe3`` may share a stride (the columns of the AMR ``xhe``
    rows).  Returns (x', xHe2', xHe3', T').  A CPU tensor, or more groups
    than K9 holds, runs :func:`chem_step_3ion_ref`; a CUDA tensor one K9
    launch."""
    ng = Nv.shape[0]
    if Nv.device.type == "cpu" or not supports(ng):
        Ns, (x, xhe2, xhe3), T = chem_step_3ion_ref(
            list(Nv), (x, xhe2, xhe3), T, nH, nHe, dt, c_red, groups, otsa,
            heating=heating, uv=uv)
        Nv.copy_(torch.stack(Ns))
        return x, xhe2, xhe3, T
    global launches
    n = Nv.shape[1]
    _check_cells(Nv, n, x=x, T=T, nH=nH, nHe=nHe)
    if xhe2.stride() != xhe3.stride() or xhe2.shape != (n,) \
            or xhe3.shape != (n,) or xhe2.dtype != torch.float64 \
            or xhe3.dtype != torch.float64 or xhe2.device != Nv.device \
            or xhe3.device != Nv.device:
        raise ValueError("rt_chem: xhe2 and xhe3 must be f64 [ncell] on the "
                         "CUDA device, with one stride")
    outs = [torch.empty_like(T) for _ in range(4)]
    if n:
        with torch.cuda.device(Nv.device):
            call_3ion(_library(), Nv, x, xhe2, xhe3, T, nH, nHe, *outs, dt,
                      c_red, groups, otsa, heating, uv,
                      torch.cuda.current_stream(Nv.device).cuda_stream)
        launches += 1
    return tuple(outs)


def _check_cells(Nv, n, **cells):
    if Nv.dtype != torch.float64 or Nv.device.type != "cuda":
        raise ValueError(f"rt_chem: N must be float64 on the CUDA device, "
                         f"got {Nv.dtype} on {Nv.device}")
    for name, t in cells.items():
        if (t.dtype != torch.float64 or t.device != Nv.device
                or tuple(t.shape) != (n,) or not t.is_contiguous()):
            raise ValueError(f"rt_chem: {name} must be a contiguous float64 "
                             f"[{n}] tensor on N's device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


_GRAY_ARGS = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
              + [ctypes.c_longlong] + [ctypes.c_double] * 5
              + [ctypes.c_int] * 4 + [ctypes.c_double] * 2
              + [ctypes.c_void_p])
_3ION_ARGS = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_int]
              + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
              + [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
              + [ctypes.c_double] * 3 + [ctypes.c_void_p]
              + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _library():
    from ramses_tpu_torch import kernels
    return bind(kernels.load("rt_chem"))


def bind(lib):
    """Declare the C entry points' signatures on a loaded build of
    ``csrc/rt_chem.cu``."""
    for name, args in (("ramses_rt_chem_gray", _GRAY_ARGS),
                       ("ramses_rt_chem_3ion", _3ION_ARGS)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _uv(uv):
    return ((0.0,) * 3, (0.0,) * 3) if uv is None else uv


def call_gray(lib, Nv, x, T, nH, x_out, T_out, dt, c_red, group, otsa,
              heating, uv, stream=None):
    """One call of ``ramses_rt_chem_gray`` in the loaded build ``lib`` (the
    card's build on CUDA tensors, or a host build of the source on CPU
    ones); the constants are the Python floats the plain version
    multiplies by.  Raises on the error the call returns."""
    dt, c_red = float(dt), float(c_red)
    g, h = _uv(uv)
    err = lib.ramses_rt_chem_gray(
        Nv.data_ptr(), Nv.stride(0), x.data_ptr(), T.data_ptr(),
        nH.data_ptr(), x_out.data_ptr(), T_out.data_ptr(), Nv.shape[0], dt,
        dt * c_red * group.sigma, c_red * group.sigma,
        group.e_photon - E_ION_HI, 1.5 * kB, int(bool(otsa)), 5,
        int(bool(heating)), int(uv is not None), float(g[0]), float(h[0]),
        stream)
    if err:
        raise RuntimeError(f"rt_chem gray kernel launch failed (cudaError "
                           f"{err})")


def group_table(groups, c_red: float, uv=None):
    """K9's by-value table: each group's sigmaN[3], c_red·sigmaN[3] and
    max(e_photon − E_ION, 0)[3], then the UV rates gamma[3] and heat[3]."""
    tab = []
    for g in groups:
        tab += [float(s) for s in g.sigmaN]
        tab += [c_red * float(s) for s in g.sigmaN]
        tab += [max(g.e_photon - E_ION[sp], 0.0) for sp in range(3)]
    g, h = _uv(uv)
    tab += [float(v) for v in g] + [float(v) for v in h]
    return (ctypes.c_double * len(tab))(*tab)


def call_3ion(lib, Nv, x, xhe2, xhe3, T, nH, nHe, x_out, xhe2_out,
              xhe3_out, T_out, dt, c_red, groups, otsa, heating, uv,
              stream=None):
    """One call of ``ramses_rt_chem_3ion`` in the loaded build ``lib``;
    raises on the error the call returns."""
    dt, c_red = float(dt), float(c_red)
    tab = group_table(groups, c_red, uv)
    err = lib.ramses_rt_chem_3ion(
        Nv.data_ptr(), Nv.stride(1), Nv.stride(0), Nv.shape[0],
        x.data_ptr(), xhe2.data_ptr(), xhe3.data_ptr(), xhe2.stride(0),
        T.data_ptr(), nH.data_ptr(), nHe.data_ptr(), x_out.data_ptr(),
        xhe2_out.data_ptr(), xhe3_out.data_ptr(), T_out.data_ptr(),
        Nv.shape[1], dt, dt * c_red, 1.5 * kB, ctypes.cast(tab,
                                                          ctypes.c_void_p),
        int(bool(otsa)), 5, int(bool(heating)), int(uv is not None), stream)
    if err:
        raise RuntimeError(f"rt_chem 3-ion kernel launch failed (cudaError "
                           f"{err})")
