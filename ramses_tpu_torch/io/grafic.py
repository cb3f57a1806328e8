"""grafic cosmological initial-condition files.

The port's own copy of ``ramses_tpu/io/grafic.py`` (host numpy), writer
included, so that a run can make its own ICs.

Reference readers: ``amr/init_time.f90:303-414`` (init_file — scans
``initfile(ilevel)`` directories for ``ic_deltab``/``ic_velc*``/
``ic_velb*`` planes), ``hydro/init_flow_fine.f90`` (baryon fields) and
``pm/init_part.f90`` (dark-matter displacements).  Format (grafic1/2,
Fortran unformatted):

  record 1: np1, np2, np3 (int32), dx (float32, comoving Mpc),
            x1o, x2o, x3o (float32 offsets, Mpc),
            astart, omega_m, omega_v, h0 (float32)
  then np3 records, each one (np1, np2) float32 plane.

Velocities are proper peculiar velocities in km/s at ``astart``;
``ic_deltab`` is the density contrast δ.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ramses_tpu_torch.io.fortran import read_record as _read_record
from ramses_tpu_torch.io.fortran import write_record as _write_record


@dataclass
class GraficHeader:
    np1: int
    np2: int
    np3: int
    dx: float          # comoving Mpc
    x1o: float = 0.0
    x2o: float = 0.0
    x3o: float = 0.0
    astart: float = 0.01
    omega_m: float = 1.0
    omega_v: float = 0.0
    h0: float = 70.0   # km/s/Mpc

    @property
    def boxlen_mpc(self) -> float:
        return self.np1 * self.dx


def read_grafic(path: str) -> Tuple[GraficHeader, np.ndarray]:
    """One grafic plane file → (header, field [np1, np2, np3])."""
    with open(path, "rb") as f:
        hdr_raw = _read_record(f)
        np1, np2, np3 = struct.unpack("<iii", hdr_raw[:12])
        floats = np.frombuffer(hdr_raw[12:12 + 8 * 4], dtype="<f4")
        hdr = GraficHeader(np1, np2, np3, float(floats[0]),
                           float(floats[1]), float(floats[2]),
                           float(floats[3]), float(floats[4]),
                           float(floats[5]), float(floats[6]),
                           float(floats[7]))
        out = np.empty((np1, np2, np3), dtype=np.float32)
        for k in range(np3):
            plane = np.frombuffer(_read_record(f), dtype="<f4")
            # planes are (np2, np1) row-major in the file (x fastest)
            out[:, :, k] = plane.reshape(np2, np1).T
    return hdr, out


def write_grafic(path: str, hdr: GraficHeader, field: np.ndarray):
    """Write one plane file (inverse of :func:`read_grafic`)."""
    assert field.shape == (hdr.np1, hdr.np2, hdr.np3)
    with open(path, "wb") as f:
        payload = struct.pack("<iii", hdr.np1, hdr.np2, hdr.np3)
        payload += np.asarray(
            [hdr.dx, hdr.x1o, hdr.x2o, hdr.x3o, hdr.astart,
             hdr.omega_m, hdr.omega_v, hdr.h0], dtype="<f4").tobytes()
        _write_record(f, payload)
        for k in range(hdr.np3):
            _write_record(f, np.ascontiguousarray(
                field[:, :, k].T, dtype="<f4").tobytes())


FIELDS_DM = ("ic_velcx", "ic_velcy", "ic_velcz")
FIELDS_BARYON = ("ic_deltab", "ic_velbx", "ic_velby", "ic_velbz")


def read_grafic_dir(dirname: str) -> Tuple[GraficHeader,
                                           Dict[str, np.ndarray]]:
    """Load every present IC field of one level directory
    (``init_time.f90:330-378`` scans the same names)."""
    fields: Dict[str, np.ndarray] = {}
    hdr: Optional[GraficHeader] = None
    for name in FIELDS_DM + FIELDS_BARYON:
        p = os.path.join(dirname, name)
        if not os.path.exists(p):
            continue
        h, arr = read_grafic(p)
        if hdr is None:
            hdr = h
        elif (h.np1, h.np2, h.np3) != (hdr.np1, hdr.np2, hdr.np3):
            raise IOError(f"grafic: inconsistent dimensions in {name}")
        fields[name] = arr
    if hdr is None:
        raise FileNotFoundError(f"no grafic files in {dirname}")
    return hdr, fields


def write_zeldovich_ics(dirname: str, delta: np.ndarray, hdr: GraficHeader,
                        fpeebl: float, baryons: bool = True):
    """Generate a self-consistent grafic set from a density contrast
    field δ at ``astart``: Zel'dovich displacement ψ = ∇∇⁻²δ and proper
    peculiar velocities v = f·H(a)·a·ψ (km/s) — the standard growing
    mode (test/IC-generation utility; the inverse of what
    :func:`ramses_tpu_torch.pm.init_part.particles_from_grafic` applies)."""
    os.makedirs(dirname, exist_ok=True)
    n = delta.shape[0]
    kf = np.fft.fftfreq(n, d=1.0 / n)
    kx, ky, kz = np.meshgrid(kf, kf, kf, indexing="ij")
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    k2[0, 0, 0] = 1.0
    dhat = np.fft.fftn(delta)
    # δ = -∇·ψ  →  ψ_hat = +i k/|k|² δ_hat with k_phys = 2π m / L
    # (m integer modes): ψ[Mpc] = ifft(+i m/|m|² δ_hat) · L/2π
    a = hdr.astart
    om, ov = hdr.omega_m, hdr.omega_v
    ok = 1.0 - om - ov
    h_a = hdr.h0 * np.sqrt(om / a ** 3 + ov + ok / a ** 2)  # km/s/Mpc
    vfac = fpeebl * h_a * a                         # km/s per Mpc of ψ
    vels = []
    for kc in (kx, ky, kz):
        psi = np.real(np.fft.ifftn(1j * kc / k2 * dhat)) \
            * (hdr.boxlen_mpc / (2.0 * np.pi))      # comoving Mpc
        vels.append((psi * vfac).astype(np.float32))
    write_grafic(os.path.join(dirname, "ic_deltab"), hdr,
                 delta.astype(np.float32))
    for nm, v in zip(("ic_velcx", "ic_velcy", "ic_velcz"), vels):
        write_grafic(os.path.join(dirname, nm), hdr, v)
    if baryons:
        for nm, v in zip(("ic_velbx", "ic_velby", "ic_velbz"), vels):
            write_grafic(os.path.join(dirname, nm), hdr, v)
