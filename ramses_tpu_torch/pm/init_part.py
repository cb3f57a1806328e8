"""Particle + baryon initial conditions from cosmological IC files.

The port's own copy of ``ramses_tpu/pm/init_part.py`` (host numpy, float64
arrays out).

Reference: ``pm/init_part.f90`` (grafic displacement initialization,
Gadget import) and ``hydro/init_flow_fine.f90`` (baryon fields from
``ic_deltab``/``ic_velb*``).

Conventions bridged here (code units: box = 1, conformal time τ in
1/H0, supercomoving velocities v_code = dx/dτ):

* grafic velocities are PROPER PECULIAR km/s at ``astart``:
      v_code = v_kms · a / (H0 · L_box[Mpc])
* the Zel'dovich growing mode gives the comoving displacement
      ψ_box = v_code / (f(Ω) · hexp)          (hexp = a²H/H0)
  so particles start at x = q + ψ with velocity v_code — exactly the
  ``init_part.f90`` displacement construction in our unit system.
* Gadget positions are kpc/h comoving, velocities km/s·√a (internal).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ramses_tpu_torch.io import gadget as gadget_io
from ramses_tpu_torch.io import grafic as grafic_io
from ramses_tpu_torch.pm.cosmology import Cosmology, dadt


def fpeebl(a: float, om: float, ov: float, ok: float) -> float:
    """Linear growth rate f = dlnD/dlna (``init_time.f90`` fpeebl):
    the Ωm(a)^(5/9) fit, exact for EdS."""
    h2 = om / a ** 3 + ov + ok / a ** 2
    om_a = (om / a ** 3) / h2
    return om_a ** (5.0 / 9.0)


def particles_from_grafic(dirname: str, cosmo: Cosmology,
                          omega_b: Optional[float] = None):
    """(x [n,3], v [n,3], m [n]) in code units from a grafic level
    directory — the DM side of ``init_part.f90``.

    Masses sum to (1 − Ωb/Ωm): matter mean density is 1 in
    supercomoving units and baryons carry their share in the gas.
    """
    hdr, fields = grafic_io.read_grafic_dir(dirname)
    a = hdr.astart
    om, ov = hdr.omega_m, hdr.omega_v
    ok = 1.0 - om - ov
    n1, n2, n3 = hdr.np1, hdr.np2, hdr.np3
    L = hdr.boxlen_mpc
    h0 = hdr.h0
    # v_kms → code velocity (dx/dτ, box units, τ in 1/H0)
    v_scale = a / (h0 * L)
    f_om = fpeebl(a, om, ov, ok)
    hexp = a * dadt(a, om, ov, ok)                   # a²H/H0
    q = np.stack(np.meshgrid(
        (np.arange(n1) + 0.5) / n1, (np.arange(n2) + 0.5) / n2,
        (np.arange(n3) + 0.5) / n3, indexing="ij"), axis=-1)
    v = np.stack([fields[f].astype(np.float64) * v_scale
                  for f in grafic_io.FIELDS_DM], axis=-1)
    psi = v / (f_om * hexp)                          # comoving, box units
    x = np.mod(q + psi, 1.0).reshape(-1, 3)
    v = v.reshape(-1, 3)
    fb = (omega_b if omega_b is not None else 0.0) / om
    mass = np.full(len(x), (1.0 - fb) / len(x))
    return x, v, mass, hdr


def baryons_from_grafic(dirname: str, cosmo: Cosmology, gamma: float,
                        omega_b: float, t2_start: float = 1e-8):
    """Conservative gas state [nvar=5, n,n,n] in supercomoving units
    from ``ic_deltab``/``ic_velb*`` (``init_flow_fine.f90`` cosmo
    branch): ρ = (Ωb/Ωm)(1+δ), momentum from the baryon velocities,
    a small uniform initial temperature."""
    hdr, fields = grafic_io.read_grafic_dir(dirname)
    if "ic_deltab" not in fields:
        raise FileNotFoundError(f"{dirname}: no ic_deltab (baryons)")
    a = hdr.astart
    v_scale = a / (hdr.h0 * hdr.boxlen_mpc)
    fb = omega_b / hdr.omega_m
    rho = fb * (1.0 + fields["ic_deltab"].astype(np.float64))
    vel = [fields[f].astype(np.float64) * v_scale
           for f in ("ic_velbx", "ic_velby", "ic_velbz")]
    p = t2_start * rho                                # cold start
    e = p / (gamma - 1.0) + 0.5 * rho * sum(vc * vc for vc in vel)
    return np.stack([rho] + [rho * vc for vc in vel] + [e]), hdr


def particles_from_gadget(path: str, cosmo: Cosmology):
    """(x [n,3], v [n,3], m [n]) in code units from a Gadget-1 file
    (``pm/init_part.f90`` 'gadget' branch)."""
    hdr, pos, vel, _ids = gadget_io.read_gadget(path)
    if hdr.boxsize <= 0:
        raise ValueError("gadget: BoxSize missing")
    a = hdr.time
    x = np.mod(pos / hdr.boxsize, 1.0)
    # internal velocity u = v_pec/sqrt(a) → v_pec = u·sqrt(a) km/s;
    # box length kpc/h → Mpc: L = boxsize/1000/h
    L_mpc = hdr.boxsize / 1000.0 / hdr.hubble
    h0 = 100.0 * hdr.hubble
    v = vel * np.sqrt(a) * a / (h0 * L_mpc)
    # equal masses normalized to total matter = 1 (DM-only import)
    m = np.full(len(x), 1.0 / len(x))
    return x, v, m, hdr
