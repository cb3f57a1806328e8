"""Gadget-1 snapshot reader/writer (dark-matter initial conditions).

The port's own copy of ``ramses_tpu/io/gadget.py`` (host numpy); the
particle writer fetches a :class:`ramses_tpu_torch.pm.particles.
ParticleSet`'s tensors once.

Reference: ``pm/gadgetreadfile.f90`` (gadgetreadheader/gadgetreadfile,
``:301``) used by ``pm/init_part.f90`` when ``filetype='gadget'``.
Layout (SnapFormat=1, little-endian Fortran records):

  HEAD  : 256 bytes — npart[6] int32, mass[6] float64, time, redshift,
          flags…, npartTotal[6], …, BoxSize, Omega0, OmegaLambda,
          HubbleParam (float64)
  POS   : 3·N float32 (kpc/h comoving, Gadget convention)
  VEL   : 3·N float32 (km/s · sqrt(a): Gadget internal)
  ID    : N int32/uint32
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ramses_tpu_torch.io.fortran import read_record as _rec
from ramses_tpu_torch.io.fortran import write_record as _wrec


@dataclass
class GadgetHeader:
    npart: Tuple[int, ...] = (0, 0, 0, 0, 0, 0)
    mass: Tuple[float, ...] = (0.0,) * 6   # 1e10 Msun/h per particle
    time: float = 1.0                      # scale factor for cosmo ICs
    redshift: float = 0.0
    boxsize: float = 0.0                   # kpc/h comoving
    omega0: float = 1.0
    omega_l: float = 0.0
    hubble: float = 0.7                    # h


def read_gadget(path: str):
    """(header, pos [N,3] float64 kpc/h, vel [N,3] float64 km/s·√a,
    ids [N]) — all particle types concatenated (DM ICs carry type 1)."""
    with open(path, "rb") as f:
        raw = _rec(f)
        if len(raw) != 256:
            raise IOError(f"gadget: header record is {len(raw)} bytes")
        npart = struct.unpack("<6i", raw[0:24])
        mass = struct.unpack("<6d", raw[24:72])
        time, redshift = struct.unpack("<2d", raw[72:88])
        # flag_sfr, flag_feedback (2i, 88:96), npartTotal (6i, 96:120),
        # flag_cooling, num_files (2i, 120:128)
        boxsize, omega0, omega_l, hubble = struct.unpack(
            "<4d", raw[128:160])
        n = sum(npart)
        pos = np.frombuffer(_rec(f), dtype="<f4").reshape(n, 3)
        vel = np.frombuffer(_rec(f), dtype="<f4").reshape(n, 3)
        ids = np.frombuffer(_rec(f), dtype="<u4")
    hdr = GadgetHeader(npart, mass, time, redshift, boxsize, omega0,
                       omega_l, hubble)
    return hdr, pos.astype(np.float64), vel.astype(np.float64), ids


def dump_gadget_particles(path: str, p, boxlen: float = 1.0,
                          time: float = 0.0) -> str:
    """Write a sim ParticleSet's *active* lanes as a SnapFormat=1 file
    (the reference's ``savegadget`` flag: each particle output also
    lands as a Gadget snapshot for external tooling).  Positions/
    velocities stay in code units; ndim<3 pads zero columns; the
    header carries one shared mass (type-1 slot, mean of the active
    masses — the format's per-particle MASS block is not written)."""
    act = p.active.cpu().numpy().astype(bool)
    x = p.x.cpu().numpy().astype(np.float64)[act]
    v = p.v.cpu().numpy().astype(np.float64)[act]
    ids = p.idp.cpu().numpy()[act].astype(np.uint32)
    m = p.m.cpu().numpy().astype(np.float64)[act]
    n = int(act.sum())
    if x.ndim == 1:
        x = x[:, None]
        v = v[:, None]
    if x.shape[1] < 3:
        pad = np.zeros((n, 3 - x.shape[1]))
        x = np.concatenate([x, pad], axis=1)
        v = np.concatenate([v, pad], axis=1)
    hdr = GadgetHeader(
        npart=(0, n, 0, 0, 0, 0),
        mass=(0.0, float(m.mean()) if n else 0.0, 0.0, 0.0, 0.0, 0.0),
        time=float(time), boxsize=float(boxlen))
    write_gadget(path, hdr, x, v, ids)
    return path


def write_gadget(path: str, hdr: GadgetHeader, pos: np.ndarray,
                 vel: np.ndarray, ids: np.ndarray):
    """SnapFormat=1 writer (tests + IC tooling)."""
    with open(path, "wb") as f:
        raw = struct.pack("<6i", *hdr.npart)
        raw += struct.pack("<6d", *hdr.mass)
        raw += struct.pack("<2d", hdr.time, hdr.redshift)
        raw += struct.pack("<2i", 0, 0)
        raw += struct.pack("<6i", *hdr.npart)      # npartTotal
        raw += struct.pack("<2i", 0, 1)            # flag_cooling, numfiles
        raw += struct.pack("<4d", hdr.boxsize, hdr.omega0, hdr.omega_l,
                           hdr.hubble)
        raw += b"\x00" * (256 - len(raw))
        _wrec(f, raw)
        _wrec(f, np.ascontiguousarray(pos, dtype="<f4").tobytes())
        _wrec(f, np.ascontiguousarray(vel, dtype="<f4").tobytes())
        _wrec(f, np.ascontiguousarray(ids, dtype="<u4").tobytes())
